"""Gradient compression and the int8 quantizer: the JAX package's
``optim/compression.py`` on torch tensors.

Symmetric per-tensor int8 quantization follows the JAX functions step
for step, in the input's dtype: ``amax = max|x| + 1e-12`` and ``scale =
amax / 127`` (bf16 for a bf16 tensor), ``q = clip(round(x / scale),
-127, 127)`` as int8 (round half to even in both frameworks), and the way
back ``q * scale`` in f32.  So a bf16 tensor's round trip is bit-equal to
the JAX package's; an int8 quality tier's weights are a round trip of the
full tier's (``int8_round_trip``).

The gradient half: ``init_residuals``, ``topk_sparsify`` and the
error-feedback ``compressed_psum`` (quantize grad + residual to int8,
reduce the int8 payloads, keep the quantization error as the next
residual).  The JAX function reduces over a mesh axis inside a
``shard_map``; on one card there is no mesh, so the port's takes an
optional ``torch.distributed`` group and runs for a group of one: the
mean is the member's own dequantized payload and the residual is
carried.  A larger group is refused (ROADMAP Queue 1, ``sharding.py``).
"""

from __future__ import annotations

import torch

from repro_torch.core.tree import leaves, tree_map, unflatten_like


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8.  Returns (q, scale)."""
    amax = x.abs().max() + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale.to(torch.float32)


def int8_round_trip(params):
    """Every floating leaf of a parameter tree through
    ``quantize_int8`` / ``dequantize_int8``, back in its own dtype: the
    int8 tier's weights."""
    def one(w):
        if not w.is_floating_point():
            return w
        q, s = quantize_int8(w)
        return dequantize_int8(q, s).to(w.dtype)
    return tree_map(one, params)


def init_residuals(grads):
    """Zero f32 residuals shaped like ``grads``."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compressed_psum(grads, residuals, group=None):
    """Error-feedback int8 mean over ``group`` (a ``torch.distributed``
    process group; None is this process alone).  Returns (mean_grads,
    new_residuals), f32.  Only a group of one is ported: the mean is the
    dequantized payload itself, as the JAX ``all_gather`` + sum over one
    member gives it."""
    n = 1
    if group is not None:
        import torch.distributed as dist
        n = dist.get_world_size(group)
    if n != 1:
        raise NotImplementedError(
            f"compressed_psum over a group of {n}: only a group of one is "
            "ported; the multi-member reduction goes with sharding.py "
            "(ROADMAP Queue 1)")

    def one(g, r):
        v = g.float() + r
        deq = dequantize_int8(*quantize_int8(v))
        return deq / n, v - deq      # the mean of one member; the residual

    out = [one(g, r) for g, r in zip(leaves(grads), leaves(residuals))]
    return (unflatten_like(grads, [o[0] for o in out]),
            unflatten_like(grads, [o[1] for o in out]))


def topk_sparsify(g, frac=0.01):
    """Magnitude top-k sparsification: (the dense masked tensor, the
    kept fraction).  Ties at the threshold are all kept, as in JAX."""
    flat = g.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    mask = flat.abs() >= thresh
    return (flat * mask).reshape(g.shape), mask.float().mean()
