"""RWKV-6 "Finch" time-mix (data-dependent decay) + channel-mix.

State per layer is O(1) in sequence length: a (H, Dk, Dv) fp32 matrix
state plus the previous token's activations for the token-shift lerps.

Two execution forms of the time mix, as in the JAX package:
  * ``timemix_parallel``  -- chunked linear-attention form for train /
    prefill; its chunk loop is ``ops.rwkv6_scan`` (the hand-written CUDA
    kernel on the card, the plain loop on the CPU).
  * ``timemix_step``      -- the O(1) recurrence for decode, plain torch
    (the JAX package computes it in jnp, outside any Pallas kernel).
The dtype casts follow the reference line by line: the ``mix_*`` fp32
parameters are cast to the activations' dtype, the decay is computed in
fp32, and the recurrence runs in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops


def _shift(x, x_last):
    """x shifted right by one token: x_last (B, d) or zeros first."""
    first = torch.zeros_like(x[:, :1]) if x_last is None else x_last[:, None]
    return torch.cat([first, x[:, :-1]], dim=1)


def _ddlerp(p, x, x_prev):
    """Data-dependent lerp producing the 5 mixed inputs (w,k,v,r,g).

    x: (B,T,d); x_prev: (B,T,d) = x shifted right by one token.
    Returns (5, B, T, d)."""
    sx = x_prev - x
    xxx = x + sx * p["mix_first"].to(x.dtype)
    # low-rank data-dependent offsets: (B,T,5*L) -> (5,B,T,d)
    a = torch.tanh(torch.einsum("btd,dl->btl", xxx, p["mix_lora_A"]))
    L = p["mix_lora_B"].shape[1]
    a = a.reshape(*a.shape[:-1], 5, L)
    off = torch.einsum("btml,mld->mbtd", a, p["mix_lora_B"])
    mix = p["mix_base"].to(x.dtype)[:, None, None] + off
    return x[None] + sx[None] * mix


def _projections(p, x, x_prev):
    """Per-token r,k,v,g and the decay w, each (B,T,H,Dh); w in fp32.

    w = exp(-exp(base + lora(xw))), the exponent clipped to [-20, 1.5]
    (a per-step decay of at least exp(-e^1.5) ~ 0.011), as in the
    reference."""
    xw, xk, xv, xr, xg = _ddlerp(p, x, x_prev)
    r = torch.einsum("btd,dhk->bthk", xr, p["wr"])
    k = torch.einsum("btd,dhk->bthk", xk, p["wk"])
    v = torch.einsum("btd,dhk->bthk", xv, p["wv"])
    g = torch.einsum("btd,dhk->bthk", xg, p["wg"])
    dw = torch.einsum("btd,dl->btl", xw, p["decay_lora_A"])
    dw = torch.einsum("btl,lhk->bthk", torch.tanh(dw), p["decay_lora_B"])
    ww = p["decay_base"].float() + dw.float()
    w = torch.exp(-torch.exp(torch.clamp(ww, -20.0, 1.5)))  # in (0,1)
    return r, k, v, g, w


def _groupnorm_heads(y, scale, eps=64e-5):
    """Per-head layernorm of (B,T,H,Dh) (the ln_x of RWKV), with the
    population variance (``jnp.var``), in fp32."""
    y = y.float()
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    return (y - mu) * torch.rsqrt(var + eps) * scale


def _output(p, y, g, x):
    y = _groupnorm_heads(y, p["ln_x"]) * F.silu(g.float())
    return torch.einsum("bthk,hkd->btd", y.to(x.dtype), p["wo"])


def timemix_parallel(p, x, cfg: ModelConfig, *, state=None, x_last=None,
                     chunk=8):
    """Chunked-parallel RWKV6 time mix.

    state: (B,H,Dk,Dv) fp32 carried matrix state (None = zeros);
    x_last: (B,d) final token of the previous segment (token shift).
    A T that is not a multiple of ``chunk`` is scanned as the whole
    chunks in one ``rwkv6_scan`` call, then the tail as one chunk of its
    own length, as the reference splits it.  Returns (out (B,T,d),
    new_state, new_x_last).
    """
    B, T, _ = x.shape
    H, Dh = cfg.rwkv_heads, cfg.rwkv_head_dim
    r, k, v, g, w = _projections(p, x, _shift(x, x_last))
    r, k, v = (a.float() for a in (r, k, v))
    u = p["bonus"].float()
    if state is None:
        state = torch.zeros((B, H, Dh, Dh), dtype=torch.float32,
                            device=x.device)
    chunk = min(chunk, T)
    cut = T // chunk * chunk
    y, state = kops.rwkv6_scan(r[:, :cut], k[:, :cut], v[:, :cut],
                               w[:, :cut], u, state, chunk=chunk)
    if cut < T:
        y2, state = kops.rwkv6_scan(r[:, cut:], k[:, cut:], v[:, cut:],
                                    w[:, cut:], u, state, chunk=T - cut)
        y = torch.cat([y, y2], dim=1)
    return _output(p, y, g, x), state, x[:, -1]


def timemix_step(p, x, cfg: ModelConfig, *, state, x_last):
    """O(1) decode step.  x: (B,1,d).  Returns (out (B,1,d), new_state,
    new_x_last)."""
    r, k, v, g, w = _projections(p, x, x_last[:, None])
    r, k, v, w = (a[:, 0].float() for a in (r, k, v, w))
    u = p["bonus"].float()
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    y = torch.einsum("bhk,bhkv->bhv", r, state + u[..., None] * kv)
    state = w[..., None] * state + kv
    return _output(p, y[:, None], g, x), state, x[:, 0]


def channelmix(p, x, *, x_last=None):
    """RWKV6 channel mix.  Returns (out, new_x_last)."""
    sx = _shift(x, x_last) - x
    xk = x + sx * p["mix_k"].to(x.dtype)
    xr = x + sx * p["mix_r"].to(x.dtype)
    kk = torch.square(torch.relu(xk @ p["wk"]))
    out = torch.sigmoid(xr @ p["wr"]) * (kk @ p["wv"])
    return out, x[:, -1]
