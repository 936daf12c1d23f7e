"""Kernel dispatch: the one place that chooses kernel or plain version.

  * a CUDA tensor        -> the hand-written CUDA kernel (it launches or
                            raises; there is no fallback)
  * a CPU tensor         -> the kernel's plain PyTorch version
  * ``set_backend("ref")`` -> the plain version on any device, so
                            ``chip_smoke.py`` can run the same step both
                            ways on the card and compare

``spec_accept`` / ``spec_verify`` dispatch on the device of
``target_probs``, ``rwkv6_scan`` on ``r``'s, ``int8_matmul`` on ``x``'s.

Under autograd (grad mode on and an input that requires grad) the three
attention ops that reach flash go through ``FlashAttention`` (the
forward kernel with its LSE, the hand-written backward kernel) and
``rwkv6_scan`` through ``RWKV6Scan`` (the forward kernel with its
chunk-start states, the hand-written backward kernel); every other
kernel wrapper raises ``ValueError`` naming itself and ROADMAP Queue 1
(``build.refuse_grad``): a kernel's output is never cut off from the
graph, and a card never falls back to a plain version.  On the CPU the
plain versions are differentiated as any torch code.

Prefill attention keeps the reference's prompt-length domain: the JAX
blockwise path and the Pallas kernel both require every sequence length
S to satisfy ``S % min(512, S) == 0`` (``models/attention.py:108-109``,
``kernels/flash_attention.py:95-97``), so a 700-token prompt is refused
by both packages.  The CUDA kernel itself masks ragged tile edges.  A
model with mamba layers adds the scan's chunk rule, ``S % min(64, S) ==
0`` (``models/mamba.py:73``), which every mamba layer asserts before any
attention layer runs: a 100-token jamba prompt is refused, a 100-token
llama prompt is not.  ``check_domain(..., cfg=cfg)`` is the one rule for
a model's prefill.

Every call goes through ``units.run``: with no op analysis running
(``launch/op_analysis.py``) that is the call alone; under one, the call
is one unit costed by its kernel's formula from the shapes here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import int8_matmul as im
from repro_torch.kernels import rwkv6_scan as rs
from repro_torch.kernels import spec_verify as sv
from repro_torch.kernels import units

_BACKENDS = (None, "ref")
_backend: str | None = None


def set_backend(name: str | None):
    """``None``: choose by the tensors' device.  ``"ref"``: force the
    plain versions.  Process-wide, like the JAX package's switch."""
    global _backend
    if name not in _BACKENDS:
        raise ValueError(f"backend {name!r} not in {_BACKENDS}")
    _backend = name


def _use_kernel(t) -> bool:
    return t.is_cuda and _backend != "ref"


MAMBA_CHUNK = 64           # the mamba scan's chunk (``models/mamba.py``)


def check_chunks(T: int):
    """The mamba scan's domain: T a multiple of ``min(MAMBA_CHUNK, T)``
    (the reference asserts it)."""
    if T < 1 or T % min(MAMBA_CHUNK, T):
        raise ValueError(
            f"sequence length {T} outside the mamba scan's domain: a "
            f"length over {MAMBA_CHUNK} must be a multiple of "
            f"{MAMBA_CHUNK}")


def check_domain(*lengths: int, cfg=None):
    """Raise ``ValueError`` for a length outside the prefill domain: the
    attention rule alone without ``cfg``; with ``cfg``, the rule of each
    mixer kind the model has (attention's, the mamba scan's; rwkv takes
    any length)."""
    kinds = ({"attn"} if cfg is None else
             {ls.mixer for b in cfg.blocks for ls in b.layers})
    for S in lengths:
        if kinds & {"attn", "local"} and S % min(512, S):
            raise ValueError(
                f"sequence length {S} outside the reference's domain: a "
                "length over 512 must be a multiple of 512")
        if "mamba" in kinds:
            check_chunks(S)


def _like_q(q, *_, **__):
    """The decode kernels' output: ``empty_like(q)``."""
    return torch.empty_like(q)


def _like_flash(q, *_, **__):
    """Flash's output: q's shape and dtype, packed."""
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def _flash(q, k, v, *, causal, window=0, softcap=0.0):
    """Flash on the card, its plain version elsewhere; one unit
    ``flash_attention`` of an op analysis (``units``), its gradient one
    ``flash_attention_bwd``."""
    shape = dict(B=q.shape[0], Sq=q.shape[1], Skv=k.shape[1], H=q.shape[2],
                 KV=k.shape[2], D=q.shape[3], causal=causal, window=window)
    kw = dict(causal=causal, window=window, softcap=softcap)
    if _use_kernel(q):
        return units.run(fa.NAME, shape, fa.flash_attention, q, k, v, **kw)
    return units.run(fa.NAME, shape, fa.plain, q, k, v, like=_like_flash,
                     backward=(fa.BWD_NAME, shape), **kw)


def attention_causal(q, k, v, *, softcap=0.0):
    check_domain(q.shape[1], k.shape[1])
    return _flash(q, k, v, causal=True, softcap=softcap)


def attention_windowed(q, k, v, *, window, softcap=0.0):
    check_domain(q.shape[1], k.shape[1])
    return _flash(q, k, v, causal=True, window=window, softcap=softcap)


def attention_full(q, k, v, *, softcap=0.0):
    """Full (non-causal) attention: an encoder's self-attention and
    cross-attention, where Sq (decoder tokens) may differ from Skv
    (frames).  Both lengths keep the prefill domain, as the reference's
    ``flash_full`` asserts for each.  The reference's ``kv_len`` is
    dropped by its Pallas branch and passed by no caller, so the port
    takes none (ROADMAP Queue 3)."""
    check_domain(q.shape[1], k.shape[1])
    return _flash(q, k, v, causal=False, softcap=softcap)


def paged_decode_attention(q, k_pool, v_pool, page_table, positions, *,
                           page_size, window=0, softcap=0.0):
    """One-token attention over a paged KV pool.

    q: (B,1,H,D); pools: (P, page_size, KV, D); page_table: (B, NP)
    int32, -1 = unmapped; positions: (B,) int32.  An op analysis costs it
    by shapes alone: every table entry mapped and every slot live.
    """
    if k_pool.shape[1] != page_size:
        raise ValueError(f"pool page size {k_pool.shape[1]} != {page_size}")
    B, _, H, D = q.shape
    table = page_table.numel()
    shape = dict(B=B, H=H, KV=k_pool.shape[2], D=D,
                 slots=table * page_size, valid=table * page_size,
                 table=table)
    fn = da.paged_decode_attention if _use_kernel(q) else da.paged_plain
    return units.run(da.PAGED_NAME, shape, fn, q, k_pool, v_pool,
                     page_table, positions, like=_like_q, window=window,
                     softcap=softcap)


def decode_attention(q, k_cache, v_cache, abs_pos, positions, *, window=0,
                     softcap=0.0):
    """One-token attention over each row's own dense cache.

    q: (B,1,H,D); caches: (B, Sc, KV, D); abs_pos: (B, Sc) int32, -1 =
    empty; positions: (B,) int32.  An op analysis costs it by shapes
    alone: every slot valid.
    """
    B, _, H, D = q.shape
    shape = dict(B=B, H=H, KV=k_cache.shape[2], D=D,
                 valid=B * k_cache.shape[1])
    fn = da.decode_attention if _use_kernel(q) else da.plain
    return units.run(da.NAME, shape, fn, q, k_cache, v_cache, abs_pos,
                     positions, like=_like_q, window=window,
                     softcap=softcap)


# ---------------------------------------------------------------------------
# speculative verification (dispatch on the device of ``target_probs``)
# ---------------------------------------------------------------------------

def spec_accept(draft_tokens, draft_probs, target_probs, u):
    """The acceptance rule with the uniforms given: (n (), dist (V,))."""
    V = target_probs.shape[-1]
    shape = dict(g=draft_tokens.shape[0], V=V)
    fn = sv.spec_accept if _use_kernel(target_probs) else sv.plain

    def like(d, *_):
        return (torch.empty((), dtype=torch.int32, device=d.device),
                torch.empty((V,), dtype=torch.float32, device=d.device))
    return units.run("spec_accept", shape, fn, draft_tokens, draft_probs,
                     target_probs, u, like=like)


def spec_verify(draft_tokens, draft_probs, target_probs, generator):
    """Token-level acceptance with its draws from ``generator`` (a CPU
    ``torch.Generator``): (n_accepted (), next_token ()), int32."""
    return sv.verify(spec_accept, draft_tokens, draft_probs, target_probs,
                     generator)


# ---------------------------------------------------------------------------
# recurrent mixers and quantised weights
# ---------------------------------------------------------------------------

def rwkv6_scan(r, k, v, w, u, state0, *, chunk=64):
    """Chunked RWKV6 linear attention: (out (B,T,H,D), final state
    (B,H,D,D)), fp32.  T must be a multiple of ``min(chunk, T)``.  Under
    autograd on the card, through ``RWKV6Scan`` (its backward kernel)."""
    B, T, H, D = r.shape
    bwd = dict(B=B, T=T, H=H, D=D, chunk=min(chunk, T))
    # under autograd the forward also writes the chunk-start states
    shape = dict(bwd, states=units.needs_grad((r, k, v, w, u, state0)))
    if _use_kernel(r):
        return units.run(rs.NAME, shape, rs.rwkv6_scan, r, k, v, w, u,
                         state0, chunk=chunk)

    def like(r, *_, **__):
        f32 = dict(dtype=torch.float32, device=r.device)
        return torch.empty(r.shape, **f32), torch.empty((B, H, D, D), **f32)
    return units.run(rs.NAME, shape, rs.plain, r, k, v, w, u, state0,
                     like=like, backward=(rs.BWD_NAME, bwd), chunk=chunk)


def int8_matmul(x, w_q, w_scale):
    """x (..., K) times int8 w_q (K, N) with per-channel fp32 scales,
    in x's dtype (W8A16: x rounded to bf16, fp32 accumulation)."""
    K, N = w_q.shape
    shape = dict(M=x.numel() // K, K=K, N=N, x_bytes=x.element_size())
    fn = im.int8_matmul if _use_kernel(x) else im.plain

    def like(x, *_):
        return torch.empty((*x.shape[:-1], N), dtype=x.dtype,
                           device=x.device)
    return units.run(im.NAME, shape, fn, x, w_q, w_scale, like=like)
