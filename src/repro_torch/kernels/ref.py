"""Plain PyTorch versions of what the kernels compute.

Torch counterparts of ``repro/models/attention.py``'s oracles
(``reference_attention``, ``decode_attend``, ``paged_decode_attend``)
and of ``repro/kernels/ref.py``'s acceptance rule (``spec_accept``),
int8 matmul (``int8_matmul_ref``) and sequential RWKV6 recurrence
(``rwkv6_ref``).  The attention oracles keep the same numerics:
scores in fp32 from the inputs' products, softmax in fp32, probabilities
rounded to ``v.dtype`` before the P V product, fp32 accumulation, output
in ``q.dtype``.  The CPU tests hold them against the JAX package, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap else x


def _gqa_scores(q, k, softcap, scale):
    """q: (B, Sq, KV, G, D), k: (B, Skv, KV, D) -> (B, KV, G, Sq, Skv)."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    return _softcap(s, softcap)


def _gqa_out(p, v):
    """p: (B, KV, G, Sq, Skv) fp32, v: (B, Skv, KV, D) -> (B,Sq,KV,G,D)."""
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(),
                        v.float())


def reference_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                        q_offset=0, kv_len=None):
    """O(S^2)-memory attention.

    q: (B, Sq, H, D); k, v: (B, Skv, KV, D).  ``q_offset`` is the absolute
    position of q[0]; ``kv_len`` (B,) is each row's valid prefix of kv.
    """
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    s = _gqa_scores(q.reshape(B, Sq, KV, G, D), k, softcap, D ** -0.5)
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    if kv_len is not None:
        mask = mask[None] & (kpos[None] < kv_len[:, None, None])
        mask = mask[:, None, None]
    else:
        mask = mask[None, None, None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _gqa_out(p, v).reshape(B, Sq, H, D).to(q.dtype)


def decode_attend(q, k_cache, v_cache, abs_pos, positions, *, window=0,
                  softcap=0.0):
    """Cached attention for decode-style queries.

    q: (B, Sq, H, D); caches: (B, Sc, KV, D); abs_pos: (B, Sc) absolute
    position held by each slot (-1 = empty); positions: (B,) or (B, Sq).
    """
    B, Sq, H, D = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    s = _gqa_scores(q.reshape(B, Sq, KV, G, D), k_cache, softcap,
                    D ** -0.5)
    if positions.ndim == 1:
        positions = positions[:, None]
    qpos = positions[:, :, None]                      # (B, Sq, 1)
    ap = abs_pos[:, None, :]
    valid = (ap >= 0) & (ap <= qpos)
    if window:
        valid &= ap > (qpos - window)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _gqa_out(p, v_cache).reshape(B, Sq, H, D).to(q.dtype)


def paged_decode_attend(q, k_pool, v_pool, page_table, positions, *,
                        page_size, window=0, softcap=0.0):
    """Cached attention over a paged KV pool.

    q: (B, 1, H, D); pools: (P, page_size, KV, D); page_table: (B, NP)
    int32, -1 = unmapped; positions: (B,).  Gathers the row's pages into
    a dense cache and delegates to ``decode_attend``.  A row with no
    mapped page at or before its position outputs exactly 0.
    """
    B = q.shape[0]
    NP = page_table.shape[1]
    ps = page_size
    safe = page_table.clamp(min=0).long()
    k_cache = k_pool[safe].reshape(B, NP * ps, *k_pool.shape[2:])
    v_cache = v_pool[safe].reshape(B, NP * ps, *v_pool.shape[2:])
    idx = torch.arange(NP * ps, dtype=torch.int32, device=q.device)[None]
    mapped = (page_table >= 0).repeat_interleave(ps, dim=1)
    abs_pos = torch.where(mapped, idx, -1)
    o = decode_attend(q, k_cache, v_cache, abs_pos, positions,
                      window=window, softcap=softcap)
    first = torch.arange(NP, device=q.device)[None] * ps
    live = ((page_table >= 0) & (first <= positions[:, None])).any(dim=1)
    return torch.where(live[:, None, None, None], o, torch.zeros_like(o))


def spec_accept(draft_tokens, draft_probs, target_probs, u):
    """Speculative-decoding acceptance (Leviathan et al.) with the
    uniforms passed in: the rule of ``spec_verify_ref``.

    draft_tokens: (g,) int proposed tokens; draft_probs: (g, V) draft
    distributions; target_probs: (g+1, V) target distributions at those
    positions and the bonus one; u: (g,) uniforms in [0, 1).  Returns
    (n (), int32: the accepted prefix length, dist (V,) float32: the
    distribution the next token is drawn from).  Everything stays on the
    inputs' device (no host sync).  A draft id outside [0, V) counts as
    p = q = 0 there, a rejection, as the Pallas kernel's one-hot
    reduction finds no column for it."""
    g = draft_tokens.shape[0]
    dp, tp = draft_probs.float(), target_probs.float()
    idx = torch.arange(g, device=dp.device)
    tok = draft_tokens.long()
    ok = (tok >= 0) & (tok < dp.shape[-1])
    tok = torch.where(ok, tok, 0)
    zero = torch.zeros((), dtype=dp.dtype, device=dp.device)
    ratio = (torch.where(ok, tp[idx, tok], zero)
             / torch.where(ok, dp[idx, tok], zero).clamp(min=1e-30))
    acc = (u.float() < ratio.clamp(max=1.0)).to(torch.int32)
    n = torch.cumprod(acc, 0).sum().to(torch.int32)
    p_n = tp[n]
    q_n = torch.where(n < g, dp[n.clamp(max=g - 1)], torch.zeros_like(p_n))
    resid = (p_n - q_n).clamp(min=0.0)
    rs = resid.sum()
    dist = torch.where(rs > 1e-9, resid / rs.clamp(min=1e-30), p_n)
    return n, dist


def int8_matmul_ref(x, w_q, w_scale):
    """x: (..., K); w_q: (K, N) int8; w_scale: (N,) fp32.  The product in
    fp32 of x as given (no bf16 rounding) and the dequantised weights,
    cast back to ``x.dtype``."""
    y = torch.einsum("...k,kn->...n", x.float(), w_q.float())
    return (y * w_scale).to(x.dtype)


def rwkv6_ref(r, k, v, w, u, state):
    """Sequential RWKV6 recurrence oracle.

    r,k,v,w: (B,T,H,D) fp32 (w = per-step decay in (0,1)); u: (H,D);
    state: (B,H,D,D).  Returns (out (B,T,H,D), final state)."""
    ys = []
    S = state
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        kv = torch.einsum("bhk,bhv->bhkv", kt, vt)
        ys.append(torch.einsum("bhk,bhkv->bhv", rt,
                               S + u[None, :, :, None] * kv))
        S = wt[..., None] * S + kv
    return torch.stack(ys, 1), S
