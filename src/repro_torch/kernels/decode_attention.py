"""Paged flash-decode: the CUDA kernel's wrapper and its plain version.

``paged_decode_attention`` launches ``csrc/paged_decode_attention.cu``
(the Hopper counterpart of the Pallas
``repro/kernels/decode_attention.py::paged_decode_attention``) on CUDA
tensors and refuses anything else; ``plain`` is the same function in
plain PyTorch, which the CPU path and the on-card comparison use.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import paged_decode_attend

NAME = "paged_decode_attention"
HEAD_DIMS = (64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 8          # query heads per kv head the kernel takes
MAX_PAGE_SIZE = 32


def _bind():
    lib = build.load(NAME)
    fn = lib.paged_decode_attention_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                       ctypes.c_float, ctypes.c_float, P]
        fn.restype = I
    return fn


def _check(q, k_pool, v_pool, page_table, positions):
    tensors = (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
               ("page_table", page_table), ("positions", positions))
    for name, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"paged_decode_attention kernel needs CUDA "
                             f"tensors; {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len({t.device for _, t in tensors}) != 1:
        raise ValueError("inputs on different devices")
    if q.dtype not in DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(f"dtypes q {q.dtype} k {k_pool.dtype} v "
                         f"{v_pool.dtype}: need one of {list(DTYPES)}")
    if page_table.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("page_table and positions must be int32")
    B, S, H, D = q.shape
    P, ps, KV, Dk = k_pool.shape
    if (S != 1 or v_pool.shape != k_pool.shape or Dk != D or H % KV
            or page_table.ndim != 2 or page_table.shape[0] != B
            or positions.shape != (B,)):
        raise ValueError(
            f"shapes q {tuple(q.shape)} pools {tuple(k_pool.shape)} "
            f"page_table {tuple(page_table.shape)} positions "
            f"{tuple(positions.shape)}")
    if D not in HEAD_DIMS or H // KV > MAX_GROUP or ps > MAX_PAGE_SIZE:
        raise ValueError(f"head dim {D} (takes {HEAD_DIMS}), group "
                         f"{H // KV} (max {MAX_GROUP}), page size {ps} "
                         f"(max {MAX_PAGE_SIZE})")


def paged_decode_attention(q, k_pool, v_pool, page_table, positions, *,
                           window=0, softcap=0.0):
    """q: (B,1,H,D); pools: (P, page_size, KV, D) read in place;
    page_table: (B, NP) int32 (-1 = unmapped); positions: (B,) int32.
    Returns (B,1,H,D); a row with no live page is exactly 0."""
    _check(q, k_pool, v_pool, page_table, positions)
    fn = _bind()
    B, _, H, D = q.shape
    ps, KV = k_pool.shape[1], k_pool.shape[2]
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 page_table.data_ptr(), positions.data_ptr(), o.data_ptr(),
                 B, page_table.shape[1], ps, KV, H // KV, D,
                 DTYPES[q.dtype], int(window), float(softcap),
                 float(D ** -0.5), stream)
    if err != 0:
        raise RuntimeError(
            f"paged_decode_attention launch failed: cudaError {err}")
    paged_decode_attention.launches += 1
    return o


paged_decode_attention.launches = 0


def plain(q, k_pool, v_pool, page_table, positions, *, window=0,
          softcap=0.0):
    """The plain PyTorch version of ``paged_decode_attention``."""
    return paged_decode_attend(q, k_pool, v_pool, page_table, positions,
                               page_size=k_pool.shape[1], window=window,
                               softcap=softcap)
