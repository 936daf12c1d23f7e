"""AdamW with a cosine schedule: the JAX package's ``optim/adamw.py`` on
torch tensors.

The arithmetic is f32 and in the JAX order: the global norm over every
gradient leaf (in tree order), the clip scale, the bias corrections, then
per leaf ``mu``, ``nu``, ``u = (mu / bc1) / (sqrt(nu / bc2) + eps)``,
``u + wd * p`` and the step, cast back to the parameter's dtype.  ``mu``
and ``nu`` are f32 trees shaped like the parameters, ``step`` an int32
scalar.  On one card there is no sharding to inherit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.tree import leaves, tree_map, unflatten_like


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


def init_opt_state(params) -> dict:
    def zeros(p):
        return tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                              device=a.device), p)
    device = leaves(params)[0].device
    return {"mu": zeros(params), "nu": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an int32 tensor): linear warm-up,
    then a cosine from ``lr`` down to ``0.1 lr``, in f32."""
    if not torch.is_tensor(step):
        step = torch.tensor(step, dtype=torch.int32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree):
    total = 0
    for a in leaves(tree):
        total = total + torch.sum(torch.square(a.float()))
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads, opt_state, cfg: AdamWConfig):
    """Returns (params', opt_state', metrics)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, g, mu, nu):
        g = g.float() * scale
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        u = u + cfg.weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype), mu, nu

    out = [upd(p, g, m, n) for p, g, m, n in zip(
        leaves(params), leaves(grads), leaves(opt_state["mu"]),
        leaves(opt_state["nu"]))]
    new_params, mu, nu = (unflatten_like(params, [o[i] for o in out])
                          for i in range(3))
    return new_params, {"mu": mu, "nu": nu, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
