"""Flash-decode, dense and paged: the CUDA kernels' wrappers and their
plain versions.

``decode_attention`` launches ``csrc/decode_attention.cu`` (the Hopper
counterpart of the Pallas ``repro/kernels/decode_attention.py::
decode_attention``) over each row's own dense cache;
``paged_decode_attention`` launches ``csrc/paged_decode_attention.cu``
(the counterpart of ``paged_decode_attention`` there) over shared page
pools.  Both take CUDA tensors and refuse anything else; ``plain`` and
``paged_plain`` are the same functions in plain PyTorch, which the CPU
path and the on-card comparison use; ``split_plain`` and
``paged_split_plain`` are the kernels' split arithmetic in plain PyTorch,
for the tests.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import NEG_INF, decode_attend, paged_decode_attend

NAME = "decode_attention"
PAGED_NAME = "paged_decode_attention"
HEAD_DIMS = (64, 128, 160, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 8          # query heads per kv head the kernels take
MAX_PAGE_SIZE = 32
CHUNK = 128            # slots per CTA of the dense split (csrc CHUNK)
PAGE_SLOTS = 128       # slots per CTA of the paged split at most (csrc SLOTS)
_fns: dict = {}       # launcher symbol -> bound ctypes function


def _bind(name: str, symbol: str, n_ptrs: int, n_ints: int):
    """The launcher ``symbol``: ``n_ptrs`` pointers, ``n_ints`` ints,
    softcap, scale, stream; bound once."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(build.load(name), symbol)
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * n_ptrs + [I] * n_ints + [ctypes.c_float,
                                                     ctypes.c_float, P]
        fn.restype = I
        _fns[symbol] = fn
    return fn


def _scratch_floats(B: int, Sc: int, KV: int, G: int, D: int) -> int:
    fn = _fns.get("decode_attention_scratch")
    if fn is None:
        fn = build.load(NAME).decode_attention_scratch
        fn.argtypes = [ctypes.c_int] * 5
        fn.restype = ctypes.c_longlong
        _fns["decode_attention_scratch"] = fn
    return fn(B, Sc, KV, G, D)


def _check_tensors(kernel: str, tensors, ints):
    for name, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{kernel} kernel needs CUDA tensors; {name} is "
                             f"on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:       # rows are read as 16-byte vectors
            raise ValueError(f"{name} must be 16-byte aligned")
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
    Same signature as the Pallas kernel.  One call launches the split's
    three kernels (scores, P V, combine); it counts once."""
    build.refuse_grad(NAME, q, k_cache, v_cache)
    _check(q, k_cache, v_cache, abs_pos, positions)
    fn = _bind(NAME, "decode_attention_launch", 7, 7)
    B, _, H, D = q.shape
    Sc, KV = k_cache.shape[1], k_cache.shape[2]
    o = torch.empty_like(q)
    part = torch.empty(_scratch_floats(B, Sc, KV, H // KV, D),
                       dtype=torch.float32, device=q.device)
    with build.on_device(q):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 abs_pos.data_ptr(), positions.data_ptr(), o.data_ptr(),
                 part.data_ptr(), B, Sc, KV, H // KV, D, DTYPES[q.dtype],
                 int(window), float(softcap), float(D ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: cudaError {err}")
    build.count_launch(decode_attention)
    return o


decode_attention.launches = 0


def plain(q, k_cache, v_cache, abs_pos, positions, *, window=0,
          softcap=0.0):
    """The plain PyTorch version of ``decode_attention``."""
    return decode_attend(q, k_cache, v_cache, abs_pos, positions,
                         window=window, softcap=softcap)


def split_plain(q, k_cache, v_cache, abs_pos, positions, *, window=0,
                softcap=0.0, chunk=CHUNK):
    """The split kernel's arithmetic in plain PyTorch, for the tests only:
    the slots cut into chunks of ``chunk`` (the walk stops at pos with no
    window); each chunk's max m and l = sum of exp(s - m) over its valid
    slots; the chunks' (m, l) merged into the row's M and
    L = sum of l e^(m - M) (chunks with l = 0 skipped); each chunk's
    acc = sum of (exp(s - M) / L rounded to v.dtype) V; and the output,
    the sum of the chunks' acc in chunk order.  A row with no valid slot
    is exactly 0.  Same signature as ``decode_attention``."""
    B, _, H, D = q.shape
    Sc, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, D).float()
    pos = positions.long()[:, None]
    ap = abs_pos.long()
    valid = (ap >= 0) & (ap <= pos)
    if window:
        valid &= ap > pos - window
    else:
        valid &= torch.arange(Sc, device=q.device)[None] <= pos
    chunks = []
    for c0 in range(0, Sc, chunk):
        sl = slice(c0, min(Sc, c0 + chunk))
        s = torch.einsum("bhgd,bshd->bhgs", qg,
                         k_cache[:, sl].float()) * D ** -0.5
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        ok = valid[:, None, None, sl]
        s = torch.where(ok, s, NEG_INF)
        m = s.amax(-1)
        l = torch.where(ok, torch.exp(s - m[..., None]), 0.0).sum(-1)
        chunks.append((sl, s, ok, m, l))
    M = torch.full((B, KV, G), NEG_INF, device=q.device)
    for *_, m, l in chunks:
        M = torch.where(l > 0, torch.maximum(M, m), M)
    L = torch.zeros_like(M)
    for *_, m, l in chunks:
        L = L + torch.where(l > 0, l * torch.exp(m - M), 0.0)
    o = torch.zeros((B, KV, G, D), device=q.device)
    for sl, s, ok, m, l in chunks:
        p = torch.where(ok, torch.exp(s - M[..., None])
                        / L.clamp(min=1e-30)[..., None], 0.0)
        acc = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(),
                           v_cache[:, sl].float())
        o = o + torch.where((l > 0)[..., None], acc, 0.0)
    return o.reshape(B, 1, H, D).to(q.dtype)


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


def paged_split(NP: int, ps: int,
                slots: int = PAGE_SLOTS) -> tuple[int, int]:
    """The paged kernel's split of a row's NP logical pages of ``ps``
    slots: (pages per CTA, CTAs per (row, kv head)).  A CTA takes a run of
    max(1, slots // ps) pages, at most ``slots`` slots; the rule reads
    only the table's shape, never the positions."""
    pages = max(1, slots // ps)
    return pages, -(-NP // pages)


def paged_decode_attention(q, k_pool, v_pool, page_table, positions, *,
                           window=0, softcap=0.0):
    """q: (B,1,H,D); pools: (P, page_size, KV, D) read in place;
    page_table: (B, NP) int32 (-1 = unmapped); positions: (B,) int32.
    Returns (B,1,H,D); a row with no live page is exactly 0.  One call
    launches the split over pages and its combine; it counts once."""
    build.refuse_grad(PAGED_NAME, q, k_pool, v_pool)
    _check_paged(q, k_pool, v_pool, page_table, positions)
    fn = _bind(PAGED_NAME, "paged_decode_attention_launch", 7, 9)
    B, _, H, D = q.shape
    ps, KV = k_pool.shape[1], k_pool.shape[2]
    NP, G = page_table.shape[1], H // KV
    pages, splits = paged_split(NP, ps)
    o = torch.empty_like(q)
    part = torch.empty(B * KV * splits * G * (2 + D), dtype=torch.float32,
                       device=q.device)
    with build.on_device(q):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 page_table.data_ptr(), positions.data_ptr(), o.data_ptr(),
                 part.data_ptr(), B, NP, ps, pages, KV, G, D,
                 DTYPES[q.dtype], int(window), float(softcap),
                 float(D ** -0.5), stream)
    if err != 0:
        raise RuntimeError(
            f"paged_decode_attention launch failed: cudaError {err}")
    build.count_launch(paged_decode_attention)
    return o


paged_decode_attention.launches = 0


def paged_plain(q, k_pool, v_pool, page_table, positions, *, window=0,
                softcap=0.0):
    """The plain PyTorch version of ``paged_decode_attention``."""
    return paged_decode_attend(q, k_pool, v_pool, page_table, positions,
                               page_size=k_pool.shape[1], window=window,
                               softcap=softcap)


def paged_split_plain(q, k_pool, v_pool, page_table, positions, *, window=0,
                      softcap=0.0, slots=PAGE_SLOTS):
    """The paged kernel's arithmetic in plain PyTorch, for the tests only:
    the pages cut into runs by ``paged_split``; each run's max m over its
    valid slots, p = exp(s - m), l = sum of p and acc = sum of (p rounded
    to v.dtype) V; the runs merged in run order into M = the max m,
    L = sum of l e^(m - M) and A = sum of acc e^(m - M) (runs with l = 0
    skipped); the output A / L.  A row with no live page, including one
    whose window holds no mapped page, is exactly 0.  Same signature as
    ``paged_decode_attention``."""
    B, _, H, D = q.shape
    ps, KV = k_pool.shape[1], k_pool.shape[2]
    NP, G = page_table.shape[1], H // KV
    pages, splits = paged_split(NP, ps, slots)
    qg = q.reshape(B, KV, G, D).float()
    pos = positions.long()[:, None]
    runs = []
    for r in range(splits):
        js = torch.arange(r * pages, min(NP, (r + 1) * pages),
                          device=q.device)
        ids = page_table[:, js].long()                       # (B, n)
        ap = (js[:, None] * ps + torch.arange(ps, device=q.device)
              ).reshape(-1)[None]                            # (1, n ps)
        ok = (ids >= 0).repeat_interleave(ps, dim=1) & (ap <= pos)
        if window:
            ok &= ap > pos - window
        safe = ids.clamp(min=0)
        k = k_pool[safe].reshape(B, -1, KV, D)
        v = v_pool[safe].reshape(B, -1, KV, D)
        s = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * D ** -0.5
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        ok = ok[:, None, None]
        s = torch.where(ok, s, NEG_INF)
        m = s.amax(-1)
        p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
        acc = torch.einsum("bhgs,bshd->bhgd", p.to(v_pool.dtype).float(),
                           v.float())
        runs.append((m, p.sum(-1), acc))
    M = torch.full((B, KV, G), NEG_INF, device=q.device)
    for m, l, _ in runs:
        M = torch.where(l > 0, torch.maximum(M, m), M)
    L = torch.zeros_like(M)
    A = torch.zeros((B, KV, G, D), device=q.device)
    for m, l, acc in runs:
        c = torch.where(l > 0, torch.exp(m - M), 0.0)
        L = L + torch.where(l > 0, l * c, 0.0)
        A = A + torch.where((l > 0)[..., None], acc * c[..., None], 0.0)
    o = A / L.clamp(min=1e-30)[..., None]
    return o.reshape(B, 1, H, D).to(q.dtype)
