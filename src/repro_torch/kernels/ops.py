"""Kernel dispatch: the one place that chooses kernel or plain version.

  * a CUDA tensor        -> the hand-written CUDA kernel (it launches or
                            raises; there is no fallback)
  * a CPU tensor         -> the kernel's plain PyTorch version
  * ``set_backend("ref")`` -> the plain version on any device, so
                            ``chip_smoke.py`` can run the same step both
                            ways on the card and compare

``spec_accept`` / ``spec_verify`` dispatch on the device of
``target_probs``, ``rwkv6_scan`` on ``r``'s, ``int8_matmul`` on ``x``'s.

Prefill attention keeps the reference's prompt-length domain: the JAX
blockwise path and the Pallas kernel both require every sequence length
S to satisfy ``S % min(512, S) == 0`` (``models/attention.py:108-109``,
``kernels/flash_attention.py:95-97``), so a 700-token prompt is refused
by both packages.  The CUDA kernel itself masks ragged tile edges.
"""

from __future__ import annotations

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import int8_matmul as im
from repro_torch.kernels import rwkv6_scan as rs
from repro_torch.kernels import spec_verify as sv

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


def check_domain(*lengths: int):
    """Raise ``ValueError`` for a length outside the prefill domain."""
    for S in lengths:
        if S % min(512, S):
            raise ValueError(
                f"sequence length {S} outside the reference's domain: a "
                "length over 512 must be a multiple of 512")


def attention_causal(q, k, v, *, softcap=0.0):
    check_domain(q.shape[1], k.shape[1])
    if _use_kernel(q):
        return fa.flash_attention(q, k, v, causal=True, softcap=softcap)
    return fa.plain(q, k, v, causal=True, softcap=softcap)


def attention_windowed(q, k, v, *, window, softcap=0.0):
    check_domain(q.shape[1], k.shape[1])
    if _use_kernel(q):
        return fa.flash_attention(q, k, v, causal=True, window=window,
                                  softcap=softcap)
    return fa.plain(q, k, v, causal=True, window=window, softcap=softcap)


def paged_decode_attention(q, k_pool, v_pool, page_table, positions, *,
                           page_size, window=0, softcap=0.0):
    """One-token attention over a paged KV pool.

    q: (B,1,H,D); pools: (P, page_size, KV, D); page_table: (B, NP)
    int32, -1 = unmapped; positions: (B,) int32.
    """
    if k_pool.shape[1] != page_size:
        raise ValueError(f"pool page size {k_pool.shape[1]} != {page_size}")
    if _use_kernel(q):
        return da.paged_decode_attention(q, k_pool, v_pool, page_table,
                                         positions, window=window,
                                         softcap=softcap)
    return da.paged_plain(q, k_pool, v_pool, page_table, positions,
                          window=window, softcap=softcap)


def decode_attention(q, k_cache, v_cache, abs_pos, positions, *, window=0,
                     softcap=0.0):
    """One-token attention over each row's own dense cache.

    q: (B,1,H,D); caches: (B, Sc, KV, D); abs_pos: (B, Sc) int32, -1 =
    empty; positions: (B,) int32.
    """
    if _use_kernel(q):
        return da.decode_attention(q, k_cache, v_cache, abs_pos, positions,
                                   window=window, softcap=softcap)
    return da.plain(q, k_cache, v_cache, abs_pos, positions, window=window,
                    softcap=softcap)


# ---------------------------------------------------------------------------
# speculative verification (dispatch on the device of ``target_probs``)
# ---------------------------------------------------------------------------

def spec_accept(draft_tokens, draft_probs, target_probs, u):
    """The acceptance rule with the uniforms given: (n (), dist (V,))."""
    if _use_kernel(target_probs):
        return sv.spec_accept(draft_tokens, draft_probs, target_probs, u)
    return sv.plain(draft_tokens, draft_probs, target_probs, u)


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
    (B,H,D,D)), fp32.  T must be a multiple of ``min(chunk, T)``."""
    if _use_kernel(r):
        return rs.rwkv6_scan(r, k, v, w, u, state0, chunk=chunk)
    return rs.plain(r, k, v, w, u, state0, chunk=chunk)


def int8_matmul(x, w_q, w_scale):
    """x (..., K) times int8 w_q (K, N) with per-channel fp32 scales,
    in x's dtype (W8A16: x rounded to bf16, fp32 accumulation)."""
    if _use_kernel(x):
        return im.int8_matmul(x, w_q, w_scale)
    return im.plain(x, w_q, w_scale)
