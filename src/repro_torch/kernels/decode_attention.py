"""Flash-decode, dense and paged: the CUDA kernels' wrappers and their
plain versions.

``decode_attention`` launches ``csrc/decode_attention.cu`` (the Hopper
counterpart of the Pallas ``repro/kernels/decode_attention.py::
decode_attention``) over each row's own dense cache;
``paged_decode_attention`` launches ``csrc/paged_decode_attention.cu``
(the counterpart of ``paged_decode_attention`` there) over shared page
pools.  Both take CUDA tensors and refuse anything else; ``plain`` and
``paged_plain`` are the same functions in plain PyTorch, which the CPU
path and the on-card comparison use.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import decode_attend, paged_decode_attend

NAME = "decode_attention"
PAGED_NAME = "paged_decode_attention"
HEAD_DIMS = (64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 8          # query heads per kv head the kernels take
MAX_PAGE_SIZE = 32


def _bind(name: str, symbol: str, n_ints: int):
    """The launcher ``symbol``: six pointers, ``n_ints`` ints, softcap,
    scale, stream."""
    lib = build.load(name)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 6 + [I] * n_ints + [ctypes.c_float,
                                                ctypes.c_float, P]
        fn.restype = I
    return fn


def _check_tensors(kernel: str, tensors, ints):
    for name, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{kernel} kernel needs CUDA tensors; {name} is "
                             f"on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len({t.device for _, t in tensors}) != 1:
        raise ValueError("inputs on different devices")
    q, k, v = (t for _, t in tensors[:3])
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes q {q.dtype} k {k.dtype} v {v.dtype}: "
                         f"need one of {list(DTYPES)}")
    if any(t.dtype != torch.int32 for _, t in ints):
        raise ValueError(f"{' and '.join(n for n, _ in ints)} must be int32")


def _check_heads(D: int, H: int, KV: int):
    if D not in HEAD_DIMS or H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"head dim {D} (takes {HEAD_DIMS}), heads {H} over "
                         f"{KV} kv heads (group max {MAX_GROUP})")


def _check(q, k_cache, v_cache, abs_pos, positions):
    tensors = (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
               ("abs_pos", abs_pos), ("positions", positions))
    _check_tensors("decode_attention", tensors, tensors[3:])
    B, S, H, D = q.shape
    if (S != 1 or k_cache.ndim != 4 or v_cache.shape != k_cache.shape
            or k_cache.shape[0] != B or k_cache.shape[3] != D
            or abs_pos.shape != k_cache.shape[:2]
            or positions.shape != (B,)):
        raise ValueError(
            f"shapes q {tuple(q.shape)} caches {tuple(k_cache.shape)} "
            f"abs_pos {tuple(abs_pos.shape)} positions "
            f"{tuple(positions.shape)}")
    _check_heads(D, H, k_cache.shape[2])


def decode_attention(q, k_cache, v_cache, abs_pos, positions, *, window=0,
                     softcap=0.0):
    """q: (B,1,H,D); caches: (B, Sc, KV, D) read in place; abs_pos:
    (B, Sc) int32 absolute position of each slot (-1 = empty); positions:
    (B,) int32.  Returns (B,1,H,D); a row with no valid slot is exactly 0.
    Same signature as the Pallas kernel."""
    _check(q, k_cache, v_cache, abs_pos, positions)
    fn = _bind(NAME, "decode_attention_launch", 7)
    B, _, H, D = q.shape
    Sc, KV = k_cache.shape[1], k_cache.shape[2]
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 abs_pos.data_ptr(), positions.data_ptr(), o.data_ptr(),
                 B, Sc, KV, H // KV, D, DTYPES[q.dtype], int(window),
                 float(softcap), float(D ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: cudaError {err}")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0


def plain(q, k_cache, v_cache, abs_pos, positions, *, window=0,
          softcap=0.0):
    """The plain PyTorch version of ``decode_attention``."""
    return decode_attend(q, k_cache, v_cache, abs_pos, positions,
                         window=window, softcap=softcap)


def _check_paged(q, k_pool, v_pool, page_table, positions):
    tensors = (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
               ("page_table", page_table), ("positions", positions))
    _check_tensors("paged_decode_attention", tensors, tensors[3:])
    B, S, H, D = q.shape
    P, ps, KV, Dk = k_pool.shape
    if (S != 1 or v_pool.shape != k_pool.shape or Dk != D
            or page_table.ndim != 2 or page_table.shape[0] != B
            or positions.shape != (B,)):
        raise ValueError(
            f"shapes q {tuple(q.shape)} pools {tuple(k_pool.shape)} "
            f"page_table {tuple(page_table.shape)} positions "
            f"{tuple(positions.shape)}")
    _check_heads(D, H, KV)
    if ps > MAX_PAGE_SIZE:
        raise ValueError(f"page size {ps} (max {MAX_PAGE_SIZE})")


def paged_decode_attention(q, k_pool, v_pool, page_table, positions, *,
                           window=0, softcap=0.0):
    """q: (B,1,H,D); pools: (P, page_size, KV, D) read in place;
    page_table: (B, NP) int32 (-1 = unmapped); positions: (B,) int32.
    Returns (B,1,H,D); a row with no live page is exactly 0."""
    _check_paged(q, k_pool, v_pool, page_table, positions)
    fn = _bind(PAGED_NAME, "paged_decode_attention_launch", 8)
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


def paged_plain(q, k_pool, v_pool, page_table, positions, *, window=0,
                softcap=0.0):
    """The plain PyTorch version of ``paged_decode_attention``."""
    return paged_decode_attend(q, k_pool, v_pool, page_table, positions,
                               page_size=k_pool.shape[1], window=window,
                               softcap=softcap)
