"""What both CLIs share: the port's architectures, the device, the
weights."""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get, names
from repro_torch.configs.tiny import make_tiny
from repro_torch.device import resolve
from repro_torch.models.init import init_params
from repro_torch.serving.engine import takes_front_end


def serveable() -> list[str]:
    """The registered configs an engine can serve: token-only models."""
    return [n for n in names() if takes_front_end(get(n)) is None]


def add_common(ap: argparse.ArgumentParser, *, default_arch="llama-1.5b"):
    ap.add_argument("--arch", default=default_arch,
                    help=f"model config: {', '.join(serveable())}")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs "
                         "the kernels' plain versions)")


def setup(ap: argparse.ArgumentParser, args):
    """(cfg, device) from ``--arch``, ``--tiny`` and ``--device``.  An
    architecture the engines cannot serve (unknown, or one whose model
    takes encoder frames or patch embeddings) is a usage error (exit 2);
    a missing card ends the run with ``device.resolve``'s message (exit
    1) -- it never falls back to the CPU."""
    served = serveable()
    if args.arch not in served:
        ap.error(f"--arch {args.arch!r}: the engines serve token-only "
                 f"models {served}; whisper-base and internvl2-26b also "
                 "take frames or patch embeddings and run through "
                 "models.model.forward")
    try:
        dev = resolve(args.device)
    except RuntimeError as e:
        raise SystemExit(f"{ap.prog}: {e}") from None
    cfg = get(args.arch)
    if args.tiny:
        cfg = make_tiny(cfg)
    return cfg, dev


def weights(cfg, seed: int, dev: torch.device) -> dict:
    """``init_params`` from a seeded generator on ``dev``: the port's
    random weights (not the JAX package's: its tokens differ)."""
    return init_params(cfg, torch.Generator(dev).manual_seed(seed),
                       device=dev)
