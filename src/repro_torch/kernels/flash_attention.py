"""Flash attention for prefill and training: the CUDA kernels' wrappers
and their plain versions.

``flash_attention`` launches ``csrc/flash_attention.cu`` (the Hopper
counterpart of the Pallas ``repro/kernels/flash_attention.py``) on CUDA
tensors and refuses anything else.  Where autograd needs its gradient
(grad mode on and an input that requires it) the call goes through
``FlashAttention``: its forward launches the same kernel with the rows'
log-sum-exp as a second output, and its backward launches
``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd``), a kernel of the
port's own, since the Pallas package differentiates a jnp attention and has
no backward kernel.  ``plain`` is the forward in plain PyTorch, which the
CPU path and the on-card comparison use; ``plain_backward`` is the backward
in plain PyTorch, written out as its formulas in fp32, against which the
tests and ``chip_smoke.py`` hold the backward kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, units
from repro_torch.kernels.ref import NEG_INF, reference_attention

NAME = "flash_attention"
BWD_NAME = "flash_attention_bwd"
HEAD_DIMS = (64, 128, 160, 256)


_fns: dict = {}


def _bind():
    fn = _fns.get(NAME)
    if fn is None:
        fn = build.load(NAME).flash_attention_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, P, I, I,
                       ctypes.c_float, ctypes.c_float, P, P]
        fn.restype = I
        _fns[NAME] = fn
    return fn


def _bind_bwd():
    fn = _fns.get(BWD_NAME)
    if fn is None:
        fn = build.load(BWD_NAME).flash_attention_bwd_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 10 + [I] * 8 + [ctypes.c_float, ctypes.c_float,
                                             P]
        fn.restype = I
        _fns[BWD_NAME] = fn
    return fn


def _check(q, k, v, kernel=NAME):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{kernel} kernel needs CUDA tensors; "
                             f"{name} is on {t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{kernel} kernel takes bfloat16; "
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


def _launch(q, k, v, causal, window, softcap, with_lse):
    """One launch of the forward kernel: O, and with ``with_lse`` also
    the rows' LSE (B, H, Sq) fp32."""
    _check(q, k, v)
    fn = _bind()
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    with build.on_device(q):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, Sq, Skv, H, KV, D, ctypes.cast(strides, ctypes.c_void_p),
                 int(bool(causal)), int(window), float(softcap),
                 float(D ** -0.5), stream,
                 lse.data_ptr() if with_lse else None)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}"
                           + (" (tensor map refused)" if err == -2 else ""))
    build.count_launch(flash_attention)
    return o, lse


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q: (B, Sq, H, D); k/v: (B, Skv, KV, D), bf16 on the card.
    Returns (B, Sq, H, D).  Same signature as the Pallas kernel.  Where
    autograd needs the gradient, through ``FlashAttention``."""
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, softcap)
    return _launch(q, k, v, causal, window, softcap, False)[0]


flash_attention.launches = 0


def forward_with_lse(q, k, v, *, causal=True, window=0, softcap=0.0):
    """The forward kernel with its second output: (O, LSE (B, H, Sq)
    fp32).  O is the same bits as ``flash_attention``'s."""
    return _launch(q, k, v, causal, window, softcap, True)


def flash_attention_bwd(q, k, v, o, do, lse, *, causal=True, window=0,
                        softcap=0.0):
    """dQ, dK, dV of ``flash_attention`` (bf16, q's and k's shapes) from
    the forward's inputs, its output ``o``, its LSE and the output's
    gradient ``do``.  One call launches the backward's three kernels
    (delta, dK/dV, dQ; ``bwd_design`` names them); it counts once."""
    _check(q, k, v, BWD_NAME)
    # the kernel reads packed rows; a non-contiguous input is packed here
    # first, then held to it (never a fall back)
    q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    lse = lse.contiguous()
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != torch.bfloat16 \
                or t.device != q.device:
            raise ValueError(f"{BWD_NAME}: {name} must be bf16 "
                             f"{tuple(q.shape)} on {q.device}; got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"{BWD_NAME}: lse must be fp32 {(B, H, Sq)}; got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    for name, t in (("o", o), ("do", do)):
        if t.data_ptr() % 16:
            raise ValueError(f"{BWD_NAME}: {name} is not 16-byte aligned")
    fn = _bind_bwd()
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    # the kernels' workspace: each row's LSE in the log2 domain and its
    # delta = rowsum(dO o O), padded to whole 128-row tiles
    ws = torch.empty((2, B, H, bwd_rows(Sq)), dtype=torch.float32,
                     device=q.device)
    with build.on_device(q):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), ws.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 B, Sq, Skv, H, KV, D, int(bool(causal)), int(window),
                 float(softcap), float(D ** -0.5), stream)
    if err != 0:
        why = _BWD_REFUSALS.get(err)
        raise RuntimeError(f"{BWD_NAME} launch failed: cudaError {err}"
                           + (f" ({why})" if why else ""))
    build.count_launch(flash_attention_bwd)
    return dq, dk, dv


flash_attention_bwd.launches = 0
# what ``FlashAttention.backward`` calls, looked up at each call:
# ``chip_smoke.py`` wraps it to hold every backward call of a train step
# to ``plain_backward`` on its own inputs
backward_kernel = flash_attention_bwd


# the backward library's own codes past the cudaError_t values
_BWD_REFUSALS = {-2: "tensor map refused",
                 -3: "the card's SM count could not be read"}


def _bwd_export(symbol: str, nargs: int):
    """One of the backward library's int-valued exports (``symbol``,
    ``nargs`` int arguments); it needs the built library, so the card."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(build.load(BWD_NAME), symbol)
        fn.argtypes = [ctypes.c_int] * nargs
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def bwd_design(B: int, Skv: int, KV: int, D: int) -> str:
    """The design ``flash_attention_bwd`` runs at this shape, by the
    source's own rule: wgmma products fed by a TMA ring at D 64 and 128,
    the dK/dV kernel on CTAs of 128 keys or, where those would leave the
    card's SMs short of two CTAs each, of 64 (unless ``set_bwd_keys``
    chose one); the mma.sync kernels at D 160 and 256, where a
    warpgroup's dK and dV accumulators would not fit the registers."""
    keys = _bwd_export("flash_attention_bwd_design", 4)(B, Skv, KV, D)
    if keys == -1:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if keys < 0:
        raise RuntimeError(f"{BWD_NAME}: {_BWD_REFUSALS[keys]}")
    return f"wgmma, {keys}-key dK/dV CTAs" if keys else "mma.sync"


def set_bwd_keys(keys: int) -> None:
    """Make every later backward call at D 64 / 128 run its dK/dV kernel
    on CTAs of ``keys`` keys (64 or 128), or by the grid rule again (0):
    for timing the two designs at one shape."""
    if _bwd_export("flash_attention_bwd_set_keys", 1)(keys) != 0:
        raise ValueError(f"dK/dV keys a CTA: 0, 64 or 128, not {keys}")


def bwd_rows(Sq: int) -> int:
    """The rows of the backward's workspace a (batch, head), as the source
    pads them (Sq rounded up to a whole 128-row tile)."""
    return _bwd_export("flash_attention_bwd_workspace_rows", 1)(Sq)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its gradient: the forward kernel with the
    LSE, the backward kernel (``backward_kernel``) for dQ, dK, dV."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        o, lse = _launch(q, k, v, causal, window, softcap, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap)
        # an op analysis running now costs the backward as one unit
        ctx.analysis = units.ANALYSIS.get()
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        shape = dict(B=q.shape[0], Sq=q.shape[1], Skv=k.shape[1],
                     H=q.shape[2], KV=k.shape[2], D=q.shape[3],
                     causal=ctx.kw["causal"], window=ctx.kw["window"])
        dq, dk, dv = units.run_in(ctx.analysis, BWD_NAME, shape,
                                  backward_kernel, q, k, v, o,
                                  do.contiguous(), lse, **ctx.kw)
        return dq, dk, dv, None, None, None


def plain(q, k, v, *, causal=True, window=0, softcap=0.0):
    """The plain PyTorch version of ``flash_attention``."""
    return reference_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)


def plain_backward(q, k, v, o, do, *, causal=True, window=0, softcap=0.0,
                   terms=False):
    """The plain PyTorch version of ``flash_attention_bwd``: dQ, dK, dV
    of ``plain`` from its inputs, its output ``o`` and the output's
    gradient ``do``, written out in fp32, or in float64 for float64
    inputs (no autograd):

        x = s * scale (or c tanh(s scale / c)),  p = softmax(x) under the
        mask,  dV = P^T dO,  dP = dO V^T,  delta = rowsum(dO o O),
        dS = P (dP - delta) * scale (* (1 - tanh^2)),  dQ = dS K,
        dK = dS^T Q,

    GQA's query heads summed into their kv head.  Returned in the
    inputs' dtypes; with ``terms`` also, in the working type, the
    magnitude of the
    terms each element sums: M |K|, M^T |Q| and P^T |dO|, where M = P
    (|dP| + |delta|) * scale (* (1 - tanh^2)) is dS's with the terms of
    dP - delta kept apart.  They bound the rounding of a kernel that
    sums them: a row whose terms cancel (a causal row 0, whose dS is 0 in
    exact arithmetic, a rounding residue in any kernel) has no magnitude
    of its own to be held to.  Then the same carried from the terms of
    the two dot products that enter dS, dP = dO V^T and delta =
    rowsum(dO o O): N |K|, N^T |Q| and 0 for dV, where
    N = P (|dO| |V|^T + rowsum(|dO| o |O|)) * scale (* (1 - tanh^2)).
    Their fp32 sums round relative to these, not to |dP| and |delta|:
    where dO is orthogonal to O and to V's rows (one-hot rows of a
    trained model's attention) the two cancel to nothing and carry only
    that rounding, in any fp32 implementation, this function's too."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G, scale = H // KV, D ** -0.5
    wt = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf = q.to(wt).reshape(B, Sq, KV, G, D)
    kf, vf = k.to(wt), v.to(wt)
    dof = do.to(wt).reshape(B, Sq, KV, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    t = None
    if softcap:
        t = torch.tanh(s / softcap)
        s = t * softcap
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    delta = (dof * o.to(wt).reshape(B, Sq, KV, G, D)).sum(-1)   # (B,Sq,KV,G)
    delta = delta.permute(0, 2, 3, 1)[..., None]
    ds = p * (dp - delta) * scale
    if t is not None:
        ds = ds * (1 - t * t)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(B, Sq, H, D)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    out = dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    if not terms:
        return out
    ds = p * (dp.abs() + delta.abs()) * scale
    if t is not None:
        ds = ds * (1 - t * t)
    mags = (torch.einsum("bhgqk,bkhd->bqhgd", ds, kf.abs())
            .reshape(B, Sq, H, D),
            torch.einsum("bhgqk,bqhgd->bkhd", ds, qf.abs()),
            torch.einsum("bhgqk,bqhgd->bkhd", p, dof.abs()))
    dn = ((dof.abs() * o.to(wt).abs().reshape(B, Sq, KV, G, D)).sum(-1)
          .permute(0, 2, 3, 1)[..., None])
    dn = p * (torch.einsum("bqhgd,bkhd->bhgqk", dof.abs(), vf.abs()) + dn) \
        * scale
    if t is not None:
        dn = dn * (1 - t * t)
    return out + (mags, (torch.einsum("bhgqk,bkhd->bqhgd", dn, kf.abs())
                         .reshape(B, Sq, H, D),
                         torch.einsum("bhgqk,bqhgd->bkhd", dn, qf.abs()),
                         torch.zeros_like(mags[2])))
