"""Sampling: greedy / temperature / top-k with per-row RNG state.

JAX keys cannot be reproduced in torch, so the port carries its own
counter-based state: ``rng`` is a (B, 2) int64 CPU tensor of
``(seed, counter)`` pairs, one per row.  A sampled row draws its Gumbel
noise from a ``torch.Generator`` seeded with a mix of the pair and then
advances its counter; a greedy row (temperature 0) draws nothing and
keeps its pair, so a migrated row resumes with the same future draws.
The noise is drawn on the CPU and moved to the logits' device, so the
same state gives the same tokens on either device.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import vocab_mask_logits

_MIX = 0x9E3779B97F4A7C15        # golden-ratio multiplier (splitmix64)
_MASK64 = (1 << 64) - 1


def rng_state(seeds) -> torch.Tensor:
    """Fresh per-row state: (B, 2) int64 ``(seed, counter=0)``."""
    seeds = torch.as_tensor(seeds, dtype=torch.int64)
    return torch.stack([seeds, torch.zeros_like(seeds)], dim=1)


def _gumbel(seed: int, counter: int, n: int, device) -> torch.Tensor:
    gen = torch.Generator()
    gen.manual_seed((seed * _MIX + counter) & _MASK64)
    u = torch.rand(n, generator=gen, dtype=torch.float32)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(device)


def _per_row(x, B: int, dtype, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device).expand(B)


def _topk_scaled(lg, temp, karr):
    """Temperature scaling, then per-row top-k masking (k = 0: no mask;
    ties with the k-th value are kept, as in the reference)."""
    l = lg / temp.clamp(min=1e-6)[:, None]
    ordered = torch.sort(l, dim=-1, descending=True).values
    idx = (karr - 1).clamp(0, l.shape[-1] - 1).long()[:, None]
    kth = torch.gather(ordered, 1, idx)
    drop = (karr[:, None] > 0) & (l < kth)
    return torch.where(drop, torch.full_like(l, -1e30), l)


def sample(logits, rng, cfg: ModelConfig, *, temperature=0.0, top_k=0):
    """logits: (B, V_pad); rng: (B, 2) int64.  Returns (tokens (B,) int32
    on the logits' device, rng').

    ``temperature`` / ``top_k`` may be python scalars (one policy for the
    batch) or (B,) tensors (per-row policies)."""
    lg = vocab_mask_logits(logits, cfg).float()
    greedy = torch.argmax(lg, -1).to(torch.int32)
    scalar = isinstance(temperature, (int, float)) \
        and isinstance(top_k, (int, float))
    if scalar and temperature == 0.0:
        return greedy, rng
    B, V = lg.shape
    temp = _per_row(temperature, B, torch.float32, lg.device)
    karr = _per_row(top_k, B, torch.int32, lg.device)
    l = _topk_scaled(lg, temp, karr)
    hot = [b for b, t in enumerate(temp.tolist()) if t > 0.0]
    if not hot:
        return greedy, rng
    noise = torch.stack([_gumbel(int(rng[b, 0]), int(rng[b, 1]), V,
                                 lg.device) for b in hot])
    rows = torch.tensor(hot, device=lg.device)
    toks = greedy.clone()
    toks[rows] = torch.argmax(l[rows] + noise, -1).to(torch.int32)
    rng = rng.clone()
    rng[hot, 1] += 1             # greedy rows keep their state
    return toks, rng


def policy_probs(logits, cfg: ModelConfig, *, temperature, top_k):
    """The full distribution ``sample`` draws from, per row: (B, V_pad)
    float32.  Greedy rows get a one-hot at the argmax."""
    lg = vocab_mask_logits(logits, cfg).float()
    B, V = lg.shape
    temp = _per_row(temperature, B, torch.float32, lg.device)
    karr = _per_row(top_k, B, torch.int32, lg.device)
    greedy = torch.nn.functional.one_hot(torch.argmax(lg, -1), V).float()
    p = torch.softmax(_topk_scaled(lg, temp, karr), -1)
    return torch.where(temp[:, None] > 0.0, p, greedy)
