"""Mamba-1 selective-SSM block (the Jamba mixer).

Recurrent state is O(1): a (B, d_inner, d_state) fp32 SSM state plus a
(B, d_conv-1, d_inner) causal-conv tail, so a hybrid Jamba workspace is
small and cheap to migrate for most layers.

Two forms, as in the JAX package:
  * ``mamba_parallel`` -- train / prefill: chunks of 64 tokens scanned in
    order, carrying (h, conv tail); within a chunk the recurrence
    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t runs token by token, in
    the reference's order (its sequential ``lax.scan``, not a log-space
    solve).
  * ``mamba_step``     -- the O(1) decode recurrence.

The scan is plain PyTorch, as the JAX package computes it in jnp: there
is no Pallas kernel for it to port.  The dtypes follow the reference
line by line: the projections in the activations' dtype, ``dt`` cast to
fp32 before ``softplus(dt + dt_bias)``, ``B`` and ``C`` in fp32, the
conv summed tap by tap in the activations' dtype, the recurrence in
fp32, and ``(y + D x) * silu(z)`` cast back before ``out_proj``.

A chunk's terms that do not depend on h -- ``exp(dt A)`` and ``(dt x)
B`` -- are computed for the whole chunk by the same elementwise ops
before its token loop, so the loop is the recurrence alone, one
``addcmul`` a token, and the ``C`` contraction runs once a chunk over
the states it kept, stacked.  The loop writes no tensor in place and
uses no ``out=``, so autograd differentiates it (the train step).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import MAMBA_CHUNK, check_chunks


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _ssm_inputs(p, x, cfg: ModelConfig):
    """x: (B,T,d_inner) post-conv post-silu.  Returns dt, B_, C fp32."""
    st = cfg.mamba_d_state
    dt_rank = p["dt_proj"].shape[0]
    xdbc = torch.einsum("bti,ir->btr", x, p["x_proj"])
    dt, B_, C = torch.split(xdbc, [dt_rank, st, xdbc.shape[-1] - dt_rank
                                   - st], dim=-1)
    dt = torch.einsum("btr,ri->bti", dt, p["dt_proj"]).float()
    dt = _softplus(dt + p["dt_bias"].float())
    return dt, B_.float(), C.float()


def _conv_causal(p, x, tail):
    """Depthwise causal conv1d.  x: (B,T,di), tail: (B,dc-1,di).  The
    taps are summed in order in x's dtype, as the reference's
    ``sum(...)`` adds them.  Returns (out, new tail)."""
    dc = p["conv_w"].shape[0]
    T = x.shape[1]
    xt = torch.cat([tail.to(x.dtype), x], dim=1)
    out = xt[:, 0:T] * p["conv_w"][0]
    for i in range(1, dc):
        out = out + xt[:, i:i + T] * p["conv_w"][i]
    out = out + p["conv_b"]
    return out, xt[:, -(dc - 1):]


def _in_conv(p, x, tail):
    """in_proj, the causal conv and silu: (xi, z, new tail)."""
    xz = torch.einsum("btd,dki->btki", x, p["in_proj"])
    xi, z = xz[:, :, 0], xz[:, :, 1]
    xi, tail = _conv_causal(p, xi, tail)
    return F.silu(xi), z, tail


def _out(p, y, xf, z, dtype):
    y = y + p["D"].float() * xf
    y = y * F.silu(z.float())
    return torch.einsum("bti,id->btd", y.to(dtype), p["out_proj"])


def mamba_parallel(p, x, cfg: ModelConfig, *, state=None, conv_tail=None):
    """x: (B,T,d).  Returns (out (B,T,d), ssm_state, conv_tail).  T
    outside the scan's domain (``ops.check_chunks``: over ``MAMBA_CHUNK``,
    a multiple of it) raises ``ValueError`` where the reference asserts."""
    B, T, _ = x.shape
    di, st, dc = cfg.d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    check_chunks(T)
    chunk = min(MAMBA_CHUNK, T)
    if conv_tail is None:
        conv_tail = torch.zeros((B, dc - 1, di), dtype=x.dtype,
                                device=x.device)
    xi, z, conv_tail = _in_conv(p, x, conv_tail)
    dt, B_, C = _ssm_inputs(p, xi, cfg)
    A = -torch.exp(p["A_log"].float())                       # (di, st)
    h = (torch.zeros((B, di, st), dtype=torch.float32, device=x.device)
         if state is None else state.float())
    xf = xi.float()
    ys = []
    for c0 in range(0, T, chunk):
        sl = slice(c0, c0 + chunk)
        # token-major rows (B, di, st), unbound once: the loop itself is
        # then one launch a token (h = b_t + a_t h) and no indexing
        a = torch.exp(dt[:, sl, :, None] * A).unbind(1)
        b = ((dt[:, sl] * xf[:, sl])[..., None]
             * B_[:, sl, None, :]).unbind(1)
        hs = []
        for a_t, b_t in zip(a, b):
            h = torch.addcmul(b_t, a_t, h)
            hs.append(h)
        ys.append(torch.einsum("tbis,bts->bti", torch.stack(hs), C[:, sl]))
    y = torch.cat(ys, dim=1)
    return _out(p, y, xf, z, x.dtype), h, conv_tail


def mamba_step(p, x, cfg: ModelConfig, *, state, conv_tail):
    """O(1) decode.  x: (B,1,d).  Returns (out (B,1,d), state,
    conv_tail)."""
    xi, z, conv_tail = _in_conv(p, x, conv_tail)
    dt, B_, C = _ssm_inputs(p, xi, cfg)
    A = -torch.exp(p["A_log"].float())
    xf = xi.float()
    a = torch.exp(dt[:, 0, :, None] * A)
    state = a * state + (dt[:, 0] * xf[:, 0])[..., None] * B_[:, 0, None, :]
    y = torch.einsum("bis,bs->bi", state, C[:, 0])[:, None]
    return _out(p, y, xf, z, x.dtype), state, conv_tail
