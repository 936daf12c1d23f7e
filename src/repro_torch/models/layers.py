"""Per-layer building blocks: norms, RoPE, the gated MLP, the attention
module over shared KV page pools, and the layer dispatcher.

Paged cache convention (one dict per attention layer):
  k_pool, v_pool : (P, page_size, KV, Dh) pools shared by every batch row
  page_table     : (B, NP) int32 page ids, -1 = unmapped, woven in by the
                   engine before each forward
Logical position i of row b lives at offset ``i % page_size`` of page
``page_table[b, i // page_size]``.  RoPE is applied before caching.

Unlike the JAX package, which returns new pools from ``.at[].set``, the
port writes K/V into the pools in place (the pools are the engine's
largest tensors; copying them per layer per step would dominate decode).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.init import torch_dtype


def rmsnorm(x, scale, eps=1e-6):
    x32 = x.float()
    n = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (n * scale.float()).to(x.dtype)


def rope(x, positions, theta=10000.0):
    """x: (B, S, H, D), positions: (B, S) absolute.  Half-split layout:
    the first and second halves of D form the rotated pairs."""
    D = x.shape[-1]
    half = D // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq              # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


def mlp_apply(p, x, cfg: ModelConfig):
    g = torch.einsum("btd,df->btf", x, p["w_gate"])
    u = torch.einsum("btd,df->btf", x, p["w_up"])
    # jax.nn.gelu defaults to the tanh approximation; torch's to erf
    act = F.gelu(g, approximate="tanh") if cfg.act == "gelu" else F.silu(g)
    return torch.einsum("btf,fd->btd", act * u, p["w_down"])


# ---------------------------------------------------------------------------
# attention module
# ---------------------------------------------------------------------------

def make_paged_attn_cache(cfg: ModelConfig, pages: int, page_size: int,
                          dtype=None, device="cuda") -> dict:
    """Shared KV page pools for one attention layer (no batch axis)."""
    dtype = dtype or torch_dtype(cfg.dtype)
    shape = (pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    return {"k_pool": torch.zeros(shape, dtype=dtype, device=device),
            "v_pool": torch.zeros(shape, dtype=dtype, device=device)}


def _write_pages(cache, k, v, positions):
    """Scatter k/v (B,S,KV,Dh) at absolute ``positions`` (B,S) into the
    shared page pools through ``cache["page_table"]`` (B,NP), in place.

    A write through a -1 page entry (a dead or inactive row), or at a
    position past the table, is dropped, as the JAX package's
    out-of-bounds ``mode="drop"`` scatter drops it: torch indexing would
    raise (or wrap a negative index), so those rows are filtered out.
    """
    k_pool, v_pool = cache["k_pool"], cache["v_pool"]
    ps = k_pool.shape[1]
    pt = cache["page_table"]
    blk = torch.div(positions, ps, rounding_mode="floor").long()
    inside = blk < pt.shape[1]
    page = torch.gather(pt, 1, blk.clamp(max=pt.shape[1] - 1))
    keep = (inside & (page >= 0)).reshape(-1)
    page = page.reshape(-1)[keep].long()
    off = (positions % ps).reshape(-1)[keep].long()
    k_pool[page, off] = k.reshape((-1,) + k.shape[2:])[keep]
    v_pool[page, off] = v.reshape((-1,) + v.shape[2:])[keep]


def attention_apply(p, x, *, cfg: ModelConfig, lspec: LayerSpec, mode: str,
                    positions, cache=None):
    """Returns out (B,S,d); K/V go into ``cache``'s pools in place.

    mode: "train" | "prefill" | "decode".  Prefill and train attend only
    over the fed tokens (prefill never reads the pools), then prefill
    scatters them into the row's pages; decode writes one token per row
    and attends over the pools through the page table.
    """
    window = lspec.window if lspec.mixer == "local" else 0
    if cache is not None and "k_pool" not in cache:
        raise NotImplementedError(
            "dense per-row KV caches belong to the dense Engine slice "
            "(ROADMAP Queue 1); this port has the paged pools only")

    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    k = torch.einsum("btd,dhk->bthk", x, p["wk"])
    v = torch.einsum("btd,dhk->bthk", x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if mode == "decode":
        _write_pages(cache, k, v, positions)
        o = kops.paged_decode_attention(
            q, cache["k_pool"], cache["v_pool"], cache["page_table"],
            positions[:, 0].to(torch.int32),
            page_size=cache["k_pool"].shape[1], window=window,
            softcap=cfg.attn_softcap)
    else:
        if window:
            o = kops.attention_windowed(q, k, v, window=window,
                                        softcap=cfg.attn_softcap)
        else:
            o = kops.attention_causal(q, k, v, softcap=cfg.attn_softcap)
        if mode == "prefill" and cache is not None:
            _write_pages(cache, k, v, positions)
    return torch.einsum("bthk,hkd->btd", o, p["wo"])


# ---------------------------------------------------------------------------
# layer dispatch (pre-norm residual transformer convention)
# ---------------------------------------------------------------------------

def layer_apply(p, x, *, cfg: ModelConfig, lspec: LayerSpec, mode: str,
                positions, cache=None):
    """One layer: attention mixer + dense gated MLP.  Returns x."""
    if lspec.mixer not in ("attn", "local") or lspec.ffn not in (
            "dense", "none"):
        raise NotImplementedError(
            f"layer {lspec} is not ported yet (ROADMAP Queue 1, other "
            "model families)")
    h = rmsnorm(x, p["attn"]["ln"]["scale"], cfg.norm_eps)
    x = x + attention_apply(p["attn"], h, cfg=cfg, lspec=lspec, mode=mode,
                            positions=positions,
                            cache=(cache or {}).get("attn"))
    if lspec.ffn == "dense":
        h = rmsnorm(x, p["mlp"]["ln"]["scale"], cfg.norm_eps)
        x = x + mlp_apply(p["mlp"], h, cfg)
    return x
