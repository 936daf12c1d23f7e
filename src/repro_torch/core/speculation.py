"""Speculative execution (paper §3.5, §9.7) at two granularities.

Token level -- speculative decoding: the *fast path* (draft model) emits
gamma tokens autoregressively; the *slow path* (target model) scores all
gamma+1 positions in ONE forward pass.  Acceptance uses the standard
rejection rule (Leviathan et al.), implemented in the ``spec_verify``
CUDA kernel with a plain PyTorch version: the output distribution equals
the target model's.

Request level -- the paper's Table-2 mechanism: the fast path serves a
preliminary answer from a cheap tier immediately; the slow path computes
the full answer; the merger commits the fast answer when it agrees with
the emerging slow result (prefix agreement / validator approval) and
revises otherwise.

Randomness comes from one CPU ``torch.Generator`` seeded with ``seed``
(JAX keys cannot be reproduced in torch): a sampled draft token is a
Gumbel-max draw over ``log(p + 1e-30)``, and ``spec_verify`` draws its
uniforms and its resample from the same generator.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.model import forward, vocab_mask_logits


# ---------------------------------------------------------------------------
# token-level speculative decoding
# ---------------------------------------------------------------------------

@dataclass
class SpecStats:
    proposed: int = 0
    accepted: int = 0
    target_steps: int = 0
    draft_steps: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.proposed, 1)

    @property
    def tokens_per_target_step(self) -> float:
        return (self.accepted + self.target_steps) / max(self.target_steps, 1)


def _probs(logits, cfg, temperature):
    logits = vocab_mask_logits(logits, cfg).float()
    if temperature == 0.0:
        # greedy == temperature->0 limit: one-hot on argmax
        return torch.nn.functional.one_hot(
            torch.argmax(logits, -1), logits.shape[-1]).float()
    return torch.softmax(logits / temperature, -1)


def _draw(p, temperature, gen: torch.Generator) -> int:
    """Greedy argmax, or a Gumbel-max draw from ``p`` (noise from the CPU
    generator, so one seed gives one stream on either device)."""
    if temperature == 0.0:
        return int(torch.argmax(p))
    e = torch.rand(p.shape[-1], generator=gen, dtype=torch.float32)
    e = e.clamp(min=torch.finfo(torch.float32).tiny)
    noise = (-torch.log(-torch.log(e))).to(p.device)
    return int(torch.argmax(torch.log(p + 1e-30) + noise))


def _tokens(toks, params) -> torch.Tensor:
    return torch.tensor([toks], dtype=torch.int64,
                        device=params["embed"].device)


@torch.no_grad()
def speculative_generate(draft_params, draft_cfg: ModelConfig,
                         target_params, target_cfg: ModelConfig,
                         prompt: np.ndarray, *, gamma: int = 4,
                         max_new: int = 32, temperature: float = 0.0,
                         seed: int = 0) -> tuple[list[int], SpecStats]:
    """Draft/target speculative decoding (single sequence, B=1).

    Both models must share the tokenizer (vocab) and a device.  Returns
    tokens + acceptance statistics.  Every forward is a ``mode="train"``
    pass over the growing sequence, so its length keeps the prefill
    domain (``ops.check_domain``: above 512, a multiple of 512)."""
    stats = SpecStats()
    gen = torch.Generator().manual_seed(seed)
    toks = [int(t) for t in np.asarray(prompt, np.int32)]

    def target_scores(all_toks):
        return forward(target_params, {"tokens": _tokens(all_toks,
                                                         target_params)},
                       cfg=target_cfg, mode="train")[0]

    def draft_next(all_toks):
        return forward(draft_params, {"tokens": _tokens(all_toks,
                                                        draft_params)},
                       cfg=draft_cfg, mode="train")[0, -1]

    while len(toks) - len(prompt) < max_new:
        # fast path: gamma draft proposals
        draft_probs = []
        proposal = []
        for _ in range(gamma):
            lg = draft_next(toks + proposal)
            p = _probs(lg[None], draft_cfg, temperature)[0]
            proposal.append(_draw(p, temperature, gen))
            draft_probs.append(p)
            stats.draft_steps += 1
        # slow path: one wide target pass over prompt+proposal
        lg_all = target_scores(toks + proposal)
        stats.target_steps += 1
        base = len(toks) - 1
        tprob = _probs(lg_all[base:base + gamma + 1], target_cfg,
                       temperature)
        accepted, extra = kops.spec_verify(
            torch.tensor(proposal, dtype=torch.int32, device=tprob.device),
            torch.stack(draft_probs), tprob, gen)
        n_acc = int(accepted)
        stats.proposed += gamma
        stats.accepted += n_acc
        toks.extend(proposal[:n_acc])
        toks.append(int(extra))       # bonus/resample token
        if len(toks) - len(prompt) >= max_new:
            toks = toks[:len(prompt) + max_new]
    return toks[len(prompt):], stats


@torch.no_grad()
def autoregressive_generate(params, cfg: ModelConfig, prompt, *,
                            max_new=32, temperature=0.0, seed=0):
    """Reference: target-only generation (the 'Traditional' column)."""
    gen = torch.Generator().manual_seed(seed)
    toks = [int(t) for t in np.asarray(prompt, np.int32)]
    steps = 0
    for _ in range(max_new):
        lg = forward(params, {"tokens": _tokens(toks, params)}, cfg=cfg,
                     mode="train")
        p = _probs(lg[0, -1:], cfg, temperature)[0]
        toks.append(_draw(p, temperature, gen))
        steps += 1
    return toks[len(np.asarray(prompt)):], steps


# ---------------------------------------------------------------------------
# request-level speculation (fast/slow path with merge)
# ---------------------------------------------------------------------------

@dataclass
class PathResult:
    tokens: list[int]
    latency_s: float
    path: str


@dataclass
class SpeculationOutcome:
    committed: PathResult
    fast: PathResult
    slow: PathResult
    agreed: bool
    perceived_latency_s: float
    speedup: float
    corrected: bool


class SpeculativeExecutor:
    """Parallel fast/slow path with intelligent merging (paper Fig 7).

    Latency model: paths run concurrently; the user perceives the fast
    path's latency when the merger commits it (agreement with the
    emerging slow-path prefix), else the slow path's.  ``agree_prefix``
    is the fraction of the slow result that must match; each validator
    is a callable ``v(tokens) -> (ok, ...)``."""

    def __init__(self, *, agree_prefix: float = 0.5,
                 validators=None):
        self.agree_prefix = agree_prefix
        self.validators = validators or []

    def run(self, fast_fn, slow_fn) -> SpeculationOutcome:
        t0 = time.perf_counter()
        fast_tokens = fast_fn()
        fast = PathResult(fast_tokens, time.perf_counter() - t0, "fast")
        t1 = time.perf_counter()
        slow_tokens = slow_fn()
        slow = PathResult(slow_tokens, time.perf_counter() - t1, "slow")

        k = max(1, int(len(slow.tokens) * self.agree_prefix))
        agreed = fast.tokens[:k] == slow.tokens[:k]
        valid = all(v(fast.tokens)[0] for v in self.validators) \
            if self.validators else True
        committed = fast if (agreed and valid) else slow
        # concurrent execution: slow path overlaps the fast path
        total = fast.latency_s if (agreed and valid) else \
            max(fast.latency_s, slow.latency_s)
        baseline = fast.latency_s + slow.latency_s  # sequential system
        return SpeculationOutcome(
            committed=committed, fast=fast, slow=slow, agreed=agreed,
            perceived_latency_s=total,
            speedup=baseline / max(total, 1e-9),
            corrected=not (agreed and valid))
