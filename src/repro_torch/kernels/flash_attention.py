"""Flash attention for prefill: the CUDA kernel's wrapper and its plain
version.

``flash_attention`` launches ``csrc/flash_attention.cu`` (the Hopper
counterpart of the Pallas ``repro/kernels/flash_attention.py``) on CUDA
tensors and refuses anything else; ``plain`` is the same function in
plain PyTorch, which the CPU path and the on-card comparison use.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import reference_attention

NAME = "flash_attention"
HEAD_DIMS = (64, 128, 160, 256)


_fn = None


def _bind():
    global _fn
    if _fn is None:
        fn = build.load(NAME).flash_attention_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, P, I, I,
                       ctypes.c_float, ctypes.c_float, P]
        fn.restype = I
        _fn = fn
    return _fn


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention kernel needs CUDA tensors; "
                             f"{name} is on {t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention kernel takes bfloat16; "
                             f"{name} is {t.dtype}")
        if t.ndim != 4:
            raise ValueError(f"{name} must be (B, S, heads, D), got "
                             f"{tuple(t.shape)}")
        # rows are copied by TMA: unit inner stride, 16-byte multiples
        # for the outer strides and a 16-byte aligned base
        if (t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{name} needs a contiguous, 16-byte aligned "
                             f"head dim; strides {t.stride()}")
    B, Sq, H, D = q.shape
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != D
            or H % k.shape[2]):
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k, v on different devices")


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q: (B, Sq, H, D); k/v: (B, Skv, KV, D), bf16 on the card.
    Returns (B, Sq, H, D).  Same signature as the Pallas kernel."""
    _check(q, k, v)
    fn = _bind()
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    with build.on_device(q):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, Sq, Skv, H, KV, D, ctypes.cast(strides, ctypes.c_void_p),
                 int(bool(causal)), int(window), float(softcap),
                 float(D ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}"
                           + (" (tensor map refused)" if err == -2 else ""))
    build.count_launch(flash_attention)
    return o


flash_attention.launches = 0


def plain(q, k, v, *, causal=True, window=0, softcap=0.0):
    """The plain PyTorch version of ``flash_attention``."""
    return reference_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)
