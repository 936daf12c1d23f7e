"""Mixture-of-Experts FFN on one card: the router, the experts, the
load-balancing loss and the dense combine.

The counterpart of the one-device half of ``repro/models/moe.py``:
``moe_dense`` runs every token through every expert and combines the
outputs with the routing weights (zero for the experts a token was not
routed to), as the JAX package does when there is no mesh.  The expert
products are plain matrix products, which the JAX package leaves to XLA
outside any Pallas kernel, so here they are ``torch.einsum``.  The
expert-parallel half (``moe_ep``: capacity-bounded packing and an
all-to-all over a mesh) has no counterpart on one card (ROADMAP Queue 1,
beside ``sharding.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoESpec


def _router(p, x, moe: MoESpec):
    """x: (T, d) -> (weights (T,k), ids (T,k), probs (T,E)), in f32.

    ``lax.top_k`` takes the lower expert id first among equal
    probabilities; ``torch.topk`` promises no order on ties, so the ids
    come from a stable descending sort instead."""
    logits = torch.einsum("td,de->te", x.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :moe.top_k], ids[:, :moe.top_k]
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)  # renormalise
    return w, ids, probs


def _expert_ffn(wg, wu, wd, h):
    """h: (..., T, d); expert weights (..., d, dx) / (..., dx, d)."""
    g = torch.einsum("...td,...df->...tf", h, wg)
    u = torch.einsum("...td,...df->...tf", h, wu)
    return torch.einsum("...tf,...fd->...td", F.silu(g) * u, wd)


def _aux_loss(probs, ids, moe: MoESpec):
    """Switch-style load-balancing loss."""
    E = moe.num_experts
    assign = F.one_hot(ids, E).float().sum(1)                  # (T, E)
    return E * torch.sum(assign.mean(0) * probs.mean(0))


def shared_expert_ffn(p, x):
    """The shared experts: one dense gated MLP of width num_shared * dx."""
    g = torch.einsum("btd,df->btf", x, p["w_gate"])
    u = torch.einsum("btd,df->btf", x, p["w_up"])
    return torch.einsum("btf,fd->btd", F.silu(g) * u, p["w_down"])


def moe_dense(p, x, cfg: ModelConfig):
    """All experts on all tokens, combined by the routing weights.

    x: (B, S, d).  Returns (out (B, S, d), aux_loss ())."""
    moe = cfg.moe
    B, S, d = x.shape
    T, E = B * S, moe.num_experts
    xt = x.reshape(T, d)
    w, ids, probs = _router(p, xt, moe)
    gates = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    gates.scatter_(1, ids, w)
    h = _expert_ffn(p["w_gate"], p["w_up"], p["w_down"],
                    xt[None].expand(E, T, d))                  # (E, T, d)
    out = torch.einsum("te,etd->td", gates.to(x.dtype), h)
    if moe.num_shared:
        out = out + shared_expert_ffn(p["shared"], x).reshape(T, d)
    return out.reshape(B, S, d), _aux_loss(probs, ids, moe)


def moe_apply(p, x, cfg: ModelConfig):
    """The MoE FFN on one card: ``moe_dense``, as the JAX package's
    ``moe_apply`` runs it with no mesh.  Returns (out, aux_loss)."""
    return moe_dense(p, x, cfg)
