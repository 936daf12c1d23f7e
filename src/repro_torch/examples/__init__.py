"""The JAX package's ``examples/`` over the port: seven scenarios, each
runnable as ``python -m repro_torch.examples.<name>``.

quickstart               attested migration with a bit-exact continuation
resilient_failover       multi-tier replication with quality degradation
speculative_serving      token- and request-level speculative execution
speculative_fleet        a draft tier on the edge verified on the cloud
validated_medical_agent  the privacy-aware daemon and in-stream validation
fleet_serving            the fleet's five acts
train_100m               training with a checkpoint and a restart

Each module keeps the JAX example's flags and adds ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain versions; without a card a cuda
run stops with ``device.resolve``'s error, never falling back) and
``--seed`` (the port's ``init_params`` from a ``torch.Generator``).  The
six serving examples also take ``--full``: llama-1.5b at full width and
depth, bf16, in place of the example's tiny config.  Each scenario is a
``run(cfg, params, *, device, ...)`` over weights its caller made, which
prints the JAX example's lines and returns the printed figures; the
example's constants are its keyword defaults.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get
from repro_torch.configs.tiny import make_tiny
from repro_torch.device import resolve
from repro_torch.models.init import init_params


def check(ok: bool, message: str):
    """The JAX example's ``assert``, kept under ``python -O`` too."""
    if not ok:
        raise AssertionError(message)


def parser(name: str, doc: str, *, full_help: str | None = None
           ) -> argparse.ArgumentParser:
    """The flags every example shares: ``--device``, ``--seed`` and, for
    the serving examples (``full_help`` given), ``--full``."""
    ap = argparse.ArgumentParser(prog=f"repro_torch.examples.{name}",
                                 description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs "
                         "the kernels' plain versions)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the port's init_params")
    if full_help is not None:
        ap.add_argument("--full", action="store_true", help=full_help)
    return ap


FULL_HELP = ("llama-1.5b at full width and depth (bf16) in place of the "
             "tiny config")


def weights(cfg, device, seed: int) -> dict:
    """``cfg``'s parameter tree on ``device`` from ``seed``."""
    return init_params(cfg, torch.Generator(device).manual_seed(seed),
                       device=device)


def llama(args, **tiny) -> tuple:
    """(cfg, params, device) of a serving example: llama-1.5b under
    ``--full``, else ``make_tiny(get("llama-1.5b"), **tiny)``."""
    device = resolve(args.device)
    cfg = get("llama-1.5b")
    if not args.full:
        cfg = make_tiny(cfg, **tiny)
    return cfg, weights(cfg, device, args.seed), device
