"""Symmetric per-tensor int8 quantization (the half of the JAX package's
``optim.compression`` that serving uses: an int8 quality tier's weights
are a round trip of the full tier's through it).

The arithmetic follows the JAX functions step for step, in the input's
dtype: ``amax = max|x| + 1e-12`` and ``scale = amax / 127`` (bf16 for a
bf16 tensor), ``q = clip(round(x / scale), -127, 127)`` as int8 (round
half to even in both frameworks), and the way back ``q * scale`` in f32.
So a bf16 tensor's round trip is bit-equal to the JAX package's.  The
error-feedback ``compressed_psum`` and ``topk_sparsify`` wait for the
training slice (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import torch


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
    from repro_torch.core.tree import tree_map

    def one(w):
        if not w.is_floating_point():
            return w
        q, s = quantize_int8(w)
        return dequantize_int8(q, s).to(w.dtype)
    return tree_map(one, params)
