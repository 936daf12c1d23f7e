"""Per-layer building blocks: norms, RoPE, the gated MLP, the attention
module over dense per-row KV caches or shared KV page pools, the RWKV6
and mamba recurrent caches, and the layer dispatcher (an attention or
mamba mixer with the dense MLP or the MoE FFN of ``models/moe.py``, or
rwkv).

Dense cache convention (one dict per attention layer):
  k, v     : (B, S_c, KV, Dh)   S_c = window for "local", seq budget else
  abs_pos  : (B, S_c) int32     absolute position held by each slot (-1 empty)
  write    : (B,) bool, optional, woven in by the engine before a forward:
             rows where it is False keep their cache untouched
Local layers ring-buffer by ``abs_pos % window``; global layers index by
absolute position.  An encoder-decoder's layer also holds a ``cross``
cache of the same form: the encoder frames' K/V at ``abs_pos``
0..S_f-1, written once at prefill.

Paged cache convention (one dict per attention layer):
  k_pool, v_pool : (P, page_size, KV, Dh) pools shared by every batch row
  page_table     : (B, NP) int32 page ids, -1 = unmapped, woven in by the
                   engine before each forward
Logical position i of row b lives at offset ``i % page_size`` of page
``page_table[b, i // page_size]``.  RoPE is applied before caching.

RWKV6 cache (one dict per rwkv layer):
  state      : (B, H, Dh, Dh) fp32 matrix state
  x_tm, x_cm : (B, d) the last token's input to the time / channel mix
  write      : (B,) bool, optional, as for the dense attention cache

Mamba cache (one dict per mamba layer):
  ssm        : (B, d_inner, d_state) fp32 SSM state
  conv       : (B, d_conv - 1, d_inner) the causal conv's input tail
  write      : (B,) bool, optional, as for the dense attention cache

Unlike the JAX package, which returns new caches from ``.at[].set``, the
port writes K/V into the caches and pools, and the recurrent state into
its cache, in place (they are the engine's largest tensors; copying them
per layer per step would dominate decode).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import decode_attend
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv_mod
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

def make_attn_cache(cfg: ModelConfig, lspec: LayerSpec, batch: int,
                    max_len: int, dtype=None, device="cuda") -> dict:
    """Dense per-row KV cache for one attention layer."""
    dtype = dtype or torch_dtype(cfg.dtype)
    S_c = min(lspec.window, max_len) if lspec.mixer == "local" else max_len
    shape = (batch, S_c, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "abs_pos": torch.full((batch, S_c), -1, dtype=torch.int32,
                                  device=device)}


def _cache_slots(lspec: LayerSpec, S_c: int, positions):
    """Map absolute positions (B,S) -> cache slot indices."""
    if lspec.mixer == "local":
        return positions % S_c
    return positions.clamp(max=S_c - 1)


def _write_cache(cache, lspec, k, v, positions):
    """Scatter k/v (B,S,KV,Dh) at ``positions`` (B,S) into the dense
    cache, in place.

    Rows whose ``cache["write"]`` is False write back what their slots
    already hold, so an inactive row's k, v and abs_pos stay untouched:
    the JAX engine writes every row and then masks the inactive rows'
    caches back to the old ones.  A ``torch.where`` per written slot,
    not a boolean filter, so no layer waits on the host.

    A prefill longer than a local layer's ring buffer writes only its
    last ``S_c`` tokens: the earlier ones share their slots with later
    ones, which the JAX scatter lets win on the CPU, while a CUDA
    ``index_put_`` with repeated indices keeps any one of them.
    """
    kc, vc, ap = cache["k"], cache["v"], cache["abs_pos"]
    if lspec.mixer == "local" and positions.shape[1] > kc.shape[1]:
        S_c = kc.shape[1]
        k, v, positions = k[:, -S_c:], v[:, -S_c:], positions[:, -S_c:]
    slots = _cache_slots(lspec, kc.shape[1], positions).long()
    rows = torch.arange(kc.shape[0], device=kc.device)[:, None].expand_as(
        slots)
    positions = positions.to(torch.int32)
    write = cache.get("write")
    if write is not None:
        w = write[:, None]
        k = torch.where(w[..., None, None], k, kc[rows, slots])
        v = torch.where(w[..., None, None], v, vc[rows, slots])
        positions = torch.where(w, positions, ap[rows, slots])
    kc[rows, slots] = k
    vc[rows, slots] = v
    ap[rows, slots] = positions


def make_rwkv_cache(cfg: ModelConfig, batch: int, device="cuda") -> dict:
    """The zero recurrent state of one rwkv layer."""
    H, Dh = cfg.rwkv_heads, cfg.rwkv_head_dim
    dt = torch_dtype(cfg.dtype)
    return {"state": torch.zeros((batch, H, Dh, Dh), dtype=torch.float32,
                                 device=device),
            "x_tm": torch.zeros((batch, cfg.d_model), dtype=dt,
                                device=device),
            "x_cm": torch.zeros((batch, cfg.d_model), dtype=dt,
                                device=device)}


def make_mamba_cache(cfg: ModelConfig, batch: int, device="cuda") -> dict:
    """The zero recurrent state of one mamba layer."""
    return {"ssm": torch.zeros((batch, cfg.d_inner, cfg.mamba_d_state),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, cfg.d_inner),
                                dtype=torch_dtype(cfg.dtype), device=device)}


def make_layer_cache(cfg: ModelConfig, lspec: LayerSpec, batch: int,
                     max_len: int, cross: bool = False, cross_len: int = 0,
                     device="cuda") -> dict:
    """One layer's dense cache: attention, rwkv or mamba mixers, and with
    ``cross`` a cross-attention cache of ``cross_len`` slots (the
    encoder frames' K/V, written once at prefill)."""
    c: dict = {}
    if lspec.mixer in ("attn", "local"):
        c["attn"] = make_attn_cache(cfg, lspec, batch, max_len,
                                    device=device)
    elif lspec.mixer == "rwkv":
        c["rwkv"] = make_rwkv_cache(cfg, batch, device=device)
    elif lspec.mixer == "mamba":
        c["mamba"] = make_mamba_cache(cfg, batch, device=device)
    if cross:
        c["cross"] = make_attn_cache(cfg, LayerSpec("attn", "none"), batch,
                                     cross_len, device=device)
    return c


def _write_state(cache, **new):
    """Store a layer's new recurrent state (rwkv or mamba leaves, by
    name) in place; rows whose ``cache["write"]`` is False keep theirs
    (the JAX engine masks them back with ``jnp.where`` after the
    step)."""
    write = cache.get("write")
    for key, new in new.items():
        old = cache[key]
        new = new.to(old.dtype)
        if write is not None:
            new = torch.where(write.reshape((-1,) + (1,) * (old.ndim - 1)),
                              new, old)
        old.copy_(new)


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


def _decode_attend(q, cache, positions, window, softcap):
    """Dense decode attention over ``cache``: one token per row (S = 1)
    goes to the ``decode_attention`` kernel, a wider window to the plain
    ``decode_attend``.  ``positions``: (B, S)."""
    if q.shape[1] == 1:
        return kops.decode_attention(
            q, cache["k"], cache["v"], cache["abs_pos"],
            positions[:, 0].to(torch.int32), window=window, softcap=softcap)
    return decode_attend(q, cache["k"], cache["v"], cache["abs_pos"],
                         positions, window=window, softcap=softcap)


def attention_apply(p, x, *, cfg: ModelConfig, lspec: LayerSpec, mode: str,
                    positions, cache=None, kv_x=None, causal=True,
                    cross=False):
    """Returns out (B,S,d); K/V go into ``cache`` in place.

    mode: "train" | "prefill" | "decode".  Prefill and train attend only
    over the fed tokens (prefill never reads the cache), then prefill
    writes them into the cache.  Decode on a paged cache writes one token
    per row and attends over the pools through the page table.  Decode on
    a dense cache writes every fed token first; one token per row (S = 1)
    goes to the ``decode_attention`` kernel, and a speculative verify
    window (S > 1, each query at its own position) to the plain
    ``decode_attend``, as the JAX package leaves that window to XLA.

    ``causal=False`` is an encoder's self-attention (full mode).
    ``cross=True`` (or a ``kv_x``) is cross-attention: K/V come from
    ``kv_x`` (the encoder's output) with no RoPE on q or k, attend in
    full mode, and prefill writes them into the cross cache at
    ``abs_pos`` 0..S_f-1; decode attends over that cache with every
    row's position at 2^30 (every written slot valid), through the
    ``decode_attention`` kernel where the reference runs the plain
    ``decode_attend``.
    """
    window = lspec.window if lspec.mixer == "local" else 0
    cross = cross or kv_x is not None

    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    if mode == "decode" and cross:
        far = torch.full((q.shape[0], q.shape[1]), 1 << 30,
                         dtype=torch.int32, device=q.device)
        o = _decode_attend(q, cache, far, 0, cfg.attn_softcap)
        return torch.einsum("bthk,hkd->btd", o, p["wo"])

    src = kv_x if cross else x
    k = torch.einsum("btd,dhk->bthk", src, p["wk"])
    v = torch.einsum("btd,dhk->bthk", src, p["wv"])
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if not cross:      # cross-attention keys are position-free
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    if mode == "decode" and "k_pool" in cache:
        _write_pages(cache, k, v, positions)
        o = kops.paged_decode_attention(
            q, cache["k_pool"], cache["v_pool"], cache["page_table"],
            positions[:, 0].to(torch.int32),
            page_size=cache["k_pool"].shape[1], window=window,
            softcap=cfg.attn_softcap)
    elif mode == "decode":
        _write_cache(cache, lspec, k, v, positions)
        o = _decode_attend(q, cache, positions, window, cfg.attn_softcap)
    else:
        if cross or not causal:
            o = kops.attention_full(q, k, v, softcap=cfg.attn_softcap)
        elif window:
            o = kops.attention_windowed(q, k, v, window=window,
                                        softcap=cfg.attn_softcap)
        else:
            o = kops.attention_causal(q, k, v, softcap=cfg.attn_softcap)
        if mode == "prefill" and cache is not None:
            if cross:      # the forward checked that the frames fit
                S_f = k.shape[1]
                pos = torch.arange(S_f, device=k.device)[None].expand(
                    k.shape[0], S_f)
                _write_cache(cache, LayerSpec("attn", "none"), k, v, pos)
            elif "k_pool" in cache:
                _write_pages(cache, k, v, positions)
            else:
                _write_cache(cache, lspec, k, v, positions)
    return torch.einsum("bthk,hkd->btd", o, p["wo"])


# ---------------------------------------------------------------------------
# layer dispatch (pre-norm residual transformer convention)
# ---------------------------------------------------------------------------

def layer_apply(p, x, *, cfg: ModelConfig, lspec: LayerSpec, mode: str,
                positions, cache=None, enc_out=None, causal=True):
    """One layer: an attention or mamba mixer (self-attention in full
    mode with ``causal=False``), then a decoder's cross-attention block
    where it has one (with ``enc_out``, or in decode over its cross
    cache), then the dense gated MLP or the MoE FFN; or the rwkv time
    mix + the rwkv channel mix.  Returns (x, aux): ``aux`` is the MoE
    FFN's load-balancing loss (f32 scalar), None for a layer without
    one; caches are written in place."""
    if lspec.mixer not in ("attn", "local", "rwkv", "mamba") \
            or lspec.ffn not in ("dense", "moe", "none"):
        raise NotImplementedError(
            f"layer {lspec} is not ported yet (ROADMAP Queue 1, other "
            "model families)")
    if lspec.mixer == "rwkv":
        return _rwkv_layer(p, x, cfg=cfg, lspec=lspec, mode=mode,
                           cache=(cache or {}).get("rwkv")), None
    if lspec.mixer == "mamba":
        x = _mamba_mixer(p, x, cfg=cfg, mode=mode,
                         cache=(cache or {}).get("mamba"))
    else:
        h = rmsnorm(x, p["attn"]["ln"]["scale"], cfg.norm_eps)
        x = x + attention_apply(p["attn"], h, cfg=cfg, lspec=lspec,
                                mode=mode, positions=positions,
                                cache=(cache or {}).get("attn"),
                                causal=causal)
    if "cross" in p and (enc_out is not None or mode == "decode"):
        h = rmsnorm(x, p["cross"]["ln"]["scale"], cfg.norm_eps)
        x = x + attention_apply(p["cross"], h, cfg=cfg,
                                lspec=LayerSpec("attn", "none"), mode=mode,
                                positions=positions,
                                cache=(cache or {}).get("cross"),
                                kv_x=enc_out, cross=True)
    aux = None
    if lspec.ffn == "dense":
        h = rmsnorm(x, p["mlp"]["ln"]["scale"], cfg.norm_eps)
        x = x + mlp_apply(p["mlp"], h, cfg)
    elif lspec.ffn == "moe":
        h = rmsnorm(x, p["moe"]["ln"]["scale"], cfg.norm_eps)
        out, aux = moe_mod.moe_apply(p["moe"], h, cfg)
        x = x + out
    return x, aux


def _rwkv_layer(p, x, *, cfg: ModelConfig, lspec: LayerSpec, mode: str,
                cache):
    """RWKV6 layer: time mix, then (ffn "dense") the channel mix.  Decode
    steps the recurrence one token; train and prefill run the chunked
    form (chunk 8 in train, for the backward's decay division, 64 in the
    forward-only modes, as the reference chooses).  Outside train the
    new state goes into ``cache`` in place."""
    h = rmsnorm(x, p["rwkv"]["ln"]["scale"], cfg.norm_eps)
    if mode == "decode":
        h, st, xl = rwkv_mod.timemix_step(
            p["rwkv"], h, cfg, state=cache["state"],
            x_last=cache["x_tm"].to(h.dtype))
    else:
        h, st, xl = rwkv_mod.timemix_parallel(
            p["rwkv"], h, cfg,
            state=cache["state"] if cache else None,
            x_last=cache["x_tm"].to(h.dtype) if cache else None,
            chunk=8 if mode == "train" else 64)
    x = x + h
    x_cm = cache["x_cm"] if cache else None
    if lspec.ffn == "dense":
        h = rmsnorm(x, p["mlp"]["ln"]["scale"], cfg.norm_eps)
        h, x_cm = rwkv_mod.channelmix(
            p["mlp"], h,
            x_last=x_cm.to(h.dtype) if x_cm is not None else None)
        x = x + h
    if mode != "train" and cache:
        _write_state(cache, state=st, x_tm=xl, x_cm=x_cm)
    return x


def _mamba_mixer(p, x, *, cfg: ModelConfig, mode: str, cache):
    """The mamba mixer and its residual: decode steps the recurrence one
    token; train and prefill run the chunked scan from the state the
    cache holds (zeros without a cache).  Outside train the new state
    goes into ``cache`` in place."""
    h = rmsnorm(x, p["mamba"]["ln"]["scale"], cfg.norm_eps)
    if mode == "decode":
        h, st, tail = mamba_mod.mamba_step(p["mamba"], h, cfg,
                                           state=cache["ssm"],
                                           conv_tail=cache["conv"])
    else:
        h, st, tail = mamba_mod.mamba_parallel(
            p["mamba"], h, cfg, state=cache["ssm"] if cache else None,
            conv_tail=cache["conv"] if cache else None)
    if mode != "train" and cache:
        _write_state(cache, ssm=st, conv=tail)
    return x + h
