"""The canonical step of each shape kind: the port's counterpart of the
JAX package's ``launch/steps.py``.

One builder per kind, each returning ``(fn, args)``:

  train   : ``training.train.train_step`` (AdamW, ``microbatches``
            gradient-accumulation steps, remat): (params', opt', loss)
  prefill : ``models.model.forward`` in prefill mode into the cell's
            caches: (last-position logits (B, V_pad), caches)
  decode  : one token a row at the batch's positions: (logits (B, V_pad),
            caches)

``concrete=False`` gives ``meta`` arguments (the abstract inputs, the
parameter tree from ``models.init.abstract_params`` and AdamW state on
it): the dry run runs ``fn(*args)`` on them and nothing is allocated.
``concrete=True`` gives real ones: ``configs.inputs.input_specs(...,
concrete=True)``, the parameters from ``init_params`` with a generator
seeded by ``seed``, zero AdamW moments, on ``device`` (the card unless
the caller asks for the CPU).

The port's ``forward`` writes its caches in place where the JAX one
returns new ones, so the prefill and decode steps return the argument
caches, written.  There are no shardings: one card has no mesh, and a
mesh is refused by ``launch/mesh.production_device``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.configs.inputs import input_specs, make_caches
from repro_torch.device import resolve
from repro_torch.models.init import abstract_params, init_params
from repro_torch.models.model import forward
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.training.train import TrainConfig, train_step


def _params(cfg: ModelConfig, concrete: bool, device, seed: int) -> dict:
    if not concrete:
        return abstract_params(cfg)
    dev = resolve(device)
    return init_params(cfg, torch.Generator(dev).manual_seed(seed),
                       device=dev)


def build_train(cfg: ModelConfig, shape: ShapeSpec, *, concrete=False,
                device="cuda", microbatches: int = 4, seed: int = 0):
    tcfg = TrainConfig(optimizer=AdamWConfig(), microbatches=microbatches,
                       remat=True)

    def step(params, opt_state, batch):
        p, o, m = train_step(params, opt_state, batch, cfg=cfg, tcfg=tcfg)
        return p, o, m["loss"]

    params = _params(cfg, concrete, device, seed)
    batch = input_specs(cfg, shape, concrete=concrete, seed=seed,
                        device=device)
    return step, (params, init_opt_state(params), batch)


def _serve_args(cfg, shape, concrete, device, seed):
    params = _params(cfg, concrete, device, seed)
    d = input_specs(cfg, shape, concrete=concrete, seed=seed, device=device)
    caches = d.pop("caches", None)
    if caches is None:
        caches = make_caches(cfg, shape, concrete=concrete, device=device)
    return params, d, caches


def build_prefill(cfg: ModelConfig, shape: ShapeSpec, *, concrete=False,
                  device="cuda", seed: int = 0):
    @torch.no_grad()
    def step(params, batch, caches):
        logits = forward(params, batch, cfg=cfg, mode="prefill",
                         caches=caches)
        # a copy: a view would keep the (B, S, V_pad) logits alive
        return logits[:, -1].clone(), caches

    return step, _serve_args(cfg, shape, concrete, device, seed)


def build_decode(cfg: ModelConfig, shape: ShapeSpec, *, concrete=False,
                 device="cuda", seed: int = 0):
    @torch.no_grad()
    def step(params, batch, caches):
        logits = forward(params, {"tokens": batch["tokens"]}, cfg=cfg,
                         mode="decode", caches=caches,
                         positions=batch["positions"])
        return logits[:, 0], caches

    return step, _serve_args(cfg, shape, concrete, device, seed)


def build(cfg: ModelConfig, shape: ShapeSpec, *, concrete=False,
          device="cuda", microbatches: int = 4, seed: int = 0):
    """``(fn, args)`` for the shape's kind; ``microbatches`` is the train
    step's."""
    kw = dict(concrete=concrete, device=device, seed=seed)
    if shape.kind == "train":
        return build_train(cfg, shape, microbatches=microbatches, **kw)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, **kw)
    return build_decode(cfg, shape, **kw)
