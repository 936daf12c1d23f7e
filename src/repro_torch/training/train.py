"""Training substrate: the mixed-precision train step with microbatch
gradient accumulation, remat and optional error-feedback gradient
compression, on one card (the JAX package's ``training/train.py``).

The loss is the JAX package's: next-token cross-entropy on the logits
after the patch prefix (``cfg.num_patches``), a z-loss, and the MoE
load-balancing loss times ``aux_loss_weight``, in f32.  Gradients come
from autograd through ``models.model.train_forward``: on the card its
attention is the flash kernel with its hand-written backward
(``kernels.flash_attention.FlashAttention``), an rwkv layer's scan the
rwkv6_scan kernel with its hand-written backward
(``kernels.rwkv6_scan.RWKV6Scan``, at chunk 8 in train, as the reference
chooses), and a mamba layer's token loop plain torch that autograd
differentiates, as JAX differentiates its ``lax.scan``; a kernel without
a backward raises rather than cut its output off from the graph.  Microbatches are
a Python loop summing f32 gradients, then ``/ m``, where JAX scans.

On one card there is no mesh: ``mesh`` and ``rules`` are accepted and
must be None (the logical-axis rules are a no-op on one card; a mesh
goes with ``sharding.py``, ROADMAP Queue 1).  ``compress_pod_grads``
takes effect only with a ``group`` (a ``torch.distributed`` process
group), as the JAX step's needs a mesh with a "pod" axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import leaves, tree_map, unflatten_like
from repro_torch.models.model import train_forward
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compression import compressed_psum


@dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    microbatches: int = 1            # gradient-accumulation steps
    z_loss: float = 1e-4
    aux_loss_weight: float = 0.01
    remat: bool = True
    compress_pod_grads: bool = False  # int8 error feedback over a group


def check_trainable(cfg: ModelConfig, mesh=None, rules=None):
    """Raise ``NotImplementedError`` for what one card cannot train on: a
    mesh or logical-axis rules."""
    if mesh is not None or rules is not None:
        raise NotImplementedError(
            "a mesh or logical-axis rules: one card has neither (ROADMAP "
            "Queue 1, sharding.py)")


def loss_fn(params, batch, cfg: ModelConfig, tcfg: TrainConfig,
            mesh=None, rules=None):
    """Next-token CE (+z-loss, +MoE aux).  Returns (loss, metrics)."""
    check_trainable(cfg, mesh, rules)
    logits, aux = train_forward(params, batch, cfg=cfg, remat=tcfg.remat)
    tokens = batch["tokens"]
    # align: logits predicting tokens[t+1]; VLM prepends patches
    off = cfg.num_patches if cfg.num_patches else 0
    lg = logits[:, off:off + tokens.shape[1] - 1].float()
    tgt = tokens[:, 1:].long()
    lse = torch.logsumexp(lg, -1)
    true_logit = torch.gather(lg, -1, tgt[..., None])[..., 0]
    ce = (lse - true_logit).mean()
    zl = tcfg.z_loss * torch.square(lse).mean()
    loss = ce + zl + tcfg.aux_loss_weight * aux
    return loss, {"ce": ce.detach(), "z_loss": zl.detach(),
                  "aux": aux.detach()}


def _value_and_grad(params, batch, cfg, tcfg):
    """(loss, metrics, grads): autograd of ``loss_fn`` with respect to
    every parameter leaf (zeros for a leaf the loss does not reach, as
    JAX gives)."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    tracked = unflatten_like(params, flat)
    with torch.enable_grad():
        loss, metrics = loss_fn(tracked, batch, cfg, tcfg)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), metrics, unflatten_like(params, grads)


def grads_fn(params, batch, cfg, tcfg, mesh=None, rules=None):
    """Microbatched grad accumulation: f32 sums over the microbatch
    splits, then ``/ m``.  Returns (grads, loss, metrics)."""
    check_trainable(cfg, mesh, rules)
    if tcfg.microbatches == 1:
        loss, metrics, grads = _value_and_grad(params, batch, cfg, tcfg)
        return grads, loss, metrics

    m = tcfg.microbatches
    split = {k: v.reshape((m, v.shape[0] // m) + tuple(v.shape[1:]))
             for k, v in batch.items()}
    g_acc = tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                           device=a.device), params)
    l_acc = 0.0
    for i in range(m):
        loss, _, g = _value_and_grad(
            params, {k: v[i] for k, v in split.items()}, cfg, tcfg)
        g_acc = unflatten_like(params, [a + b for a, b in zip(
            leaves(g_acc), leaves(g))])
        l_acc = l_acc + loss
    grads = tree_map(lambda g: g / m, g_acc)
    return grads, l_acc / m, {"ce": l_acc / m}


def train_step(params, opt_state, batch, *, cfg: ModelConfig,
               tcfg: TrainConfig, mesh=None, rules=None, residuals=None,
               group=None):
    """Returns (params', opt_state', metrics[, residuals'])."""
    check_trainable(cfg, mesh, rules)
    grads, loss, metrics = grads_fn(params, batch, cfg, tcfg)

    if tcfg.compress_pod_grads and group is not None \
            and residuals is not None:
        grads, residuals = compressed_psum(grads, residuals, group)

    params, opt_state, opt_metrics = adamw.apply_updates(
        params, grads, opt_state, tcfg.optimizer)
    metrics = {**metrics, **opt_metrics, "loss": loss}
    if residuals is not None:
        return params, opt_state, metrics, residuals
    return params, opt_state, metrics


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                    rules=None):
    """The step as a closure over the configs (the JAX package jits it
    with donated state; here the old state is freed once the caller
    drops it)."""
    check_trainable(cfg, mesh, rules)
    return partial(train_step, cfg=cfg, tcfg=tcfg)
