"""Chunked RWKV6 linear attention: the CUDA kernel's wrapper and its plain
version.

``rwkv6_scan`` launches ``csrc/rwkv6_scan.cu`` (the Hopper counterpart of
the Pallas ``repro/kernels/rwkv6_scan.py``) on CUDA tensors and refuses
anything else; ``plain`` is the same function in plain PyTorch: a loop
over chunks with the formulas of the chunk body of
``repro/models/rwkv6.py::timemix_parallel``, which the CPU path and the
on-card comparison use.

The kernel splits each head over blocks of DV value columns, one CTA a
(batch, head, block); ``split`` picks DV by a pure rule of the shape,
never from a failed build or launch.  ``aligned`` picks how the
kernel loads: by TMA where every row of r, k, v and w starts on a
16-byte boundary, else by 4-byte copies, with the same result.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "rwkv6_scan"
HEAD_DIMS = (16, 32, 64)
MAX_CHUNK = 64
# value columns a CTA owns (the kernel's DV), by head dim: at D = 64, 32
# (B = 1, H = 64: 128 CTAs of 16 warps, one an SM); below it, 16
SPLIT = {16: 16, 32: 16, 64: 32}


def split(B: int, H: int, D: int) -> int:
    """DV, the value columns one CTA owns, for (B, H, D): one per head
    dim, ``SPLIT[D]``; the kernel source has an instance for each."""
    if D not in SPLIT or B < 1 or H < 1:
        raise ValueError(f"no split for B={B} H={H} D={D}")
    return SPLIT[D]


def aligned(r, k, v, w) -> bool:
    """Whether the kernel may load r, k, v, w by TMA: every pointer
    16-byte aligned and every (batch, time, head) stride a multiple of 4
    elements (a size-1 dim's stride is never stepped)."""
    for t in (r, k, v, w):
        if t.data_ptr() % 16:
            return False
        if any(t.stride(i) % 4 for i in range(3) if t.shape[i] > 1):
            return False
    return True


def _bind():
    lib = build.load(NAME)
    fn = lib.rwkv6_scan_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, P, P]
        fn.restype = I
    return fn


def _chunk(T: int, chunk: int) -> int:
    chunk = min(chunk, T)
    if chunk < 1 or T % chunk:
        raise ValueError(f"T={T} is not a multiple of chunk={chunk}: split "
                         "off the ragged tail first (as timemix_parallel "
                         "does)")
    return chunk


def _check(r, k, v, w, u, state0, chunk):
    tensors = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
               ("state0", state0))
    for name, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"rwkv6_scan kernel needs CUDA tensors; {name} "
                             f"is on {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"rwkv6_scan kernel takes float32; {name} is "
                             f"{t.dtype}")
    if len({t.device for _, t in tensors}) != 1:
        raise ValueError("inputs on different devices")
    if r.ndim != 4:
        raise ValueError(f"r must be (B, T, H, D), got {tuple(r.shape)}")
    B, T, H, D = r.shape
    for name, t in tensors[1:4]:
        if t.shape != r.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != r {tuple(r.shape)}")
    if u.shape != (H, D) or state0.shape != (B, H, D, D):
        raise ValueError(f"u {tuple(u.shape)} / state0 "
                         f"{tuple(state0.shape)}: need ({H}, {D}) / "
                         f"({B}, {H}, {D}, {D})")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk} > {MAX_CHUNK}")
    # r/k/v/w are read in place through their (B, T, H) strides
    for name, t in tensors[:4]:
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a unit-stride head dim; strides "
                             f"{t.stride()}")
    for name, t in tensors[4:]:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def rwkv6_scan(r, k, v, w, u, state0, *, chunk=64):
    """r,k,v,w: (B,T,H,D) fp32 on the card (w = per-step decay in (0,1));
    u: (H,D); state0: (B,H,D,D) fp32.  Returns (out (B,T,H,D) fp32,
    final state (B,H,D,D)).  Same signature as the Pallas kernel; T must
    be a multiple of ``min(chunk, T)``."""
    build.refuse_grad(NAME, r, k, v, w, u, state0)
    chunk = _chunk(r.shape[1], chunk)
    _check(r, k, v, w, u, state0, chunk)
    fn = _bind()
    B, T, H, D = r.shape
    dv = split(B, H, D)
    out = torch.empty((B, T, H, D), dtype=torch.float32, device=r.device)
    stateT = torch.empty_like(state0)
    strides = (ctypes.c_longlong * 12)(*r.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *w.stride()[:3])
    with build.on_device(r):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), state0.data_ptr(), out.data_ptr(),
                 stateT.data_ptr(), B, T, H, D, chunk, dv,
                 int(aligned(r, k, v, w)),
                 ctypes.cast(strides, ctypes.c_void_p), stream)
    if err != 0:
        what = {-1: "shape refused", -2: "tensor map not encoded"}.get(
            err, f"cudaError {err}")
        raise RuntimeError(f"rwkv6_scan launch failed (split {dv}): {what}")
    build.count_launch(rwkv6_scan)
    return out, stateT


rwkv6_scan.launches = 0


def plain(r, k, v, w, u, state0, *, chunk=64):
    """The plain PyTorch version of ``rwkv6_scan``: per chunk, the
    cumulative per-channel decay, the strictly lower intra-chunk
    attention, the bonus term and the state update, in fp32."""
    B, T, H, D = r.shape
    chunk = _chunk(T, chunk)
    r, k, v, w = (a.float() for a in (r, k, v, w))
    u = u.float()
    S = state0.float()
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=r.device), -1)
    ys = []
    for c0 in range(0, T, chunk):
        rb, kb, vb, wb = (a[:, c0:c0 + chunk] for a in (r, k, v, w))
        logw = torch.log(wb)
        cum = torch.cumsum(logw, dim=1)
        A_excl = torch.exp(cum - logw)           # prod_{s<=t-1}
        A_incl = torch.exp(cum)                  # prod_{s<=t}
        A_end = A_incl[:, -1]                    # (B,H,D)
        rA = rb * A_excl
        y = torch.einsum("bthk,bhkv->bthv", rA, S)
        kA = kb / torch.clamp(A_incl, min=1e-24)
        att = torch.einsum("bthk,bshk->bhts", rA, kA)
        att = torch.where(causal[None, None], att, torch.zeros_like(att))
        y = y + torch.einsum("bhts,bshv->bthv", att, vb)
        y = y + torch.einsum("bthk,bthk->bth", rb, u * kb)[..., None] * vb
        S = A_end[..., None] * S + torch.einsum(
            "bshk,bshv->bhkv", kA * A_end[:, None], vb)
        ys.append(y)
    return torch.cat(ys, 1), S
