"""Scenario 2 (the trader): speculative execution at both granularities.

  * token-level: a small draft model proposes, the target verifies in
    one wide pass -- output provably equals target-only decoding;
  * request-level: fast path commits immediately when the slow path's
    emerging prefix agrees (paper Table 2).

    PYTHONPATH=src python -m repro_torch.examples.speculative_serving \
        [--device cpu] [--full]

The tiny target is ``make_tiny(llama-1.5b, d_model=64)`` and the draft
``d_model=32, repeats_cap=1``, as in the JAX example.  Under ``--full``
the target is llama-1.5b and the draft the same width at one block
repeat (one layer), from ``--seed`` + 1.

Greedy equality with target-only decoding is asserted exactly at the
tiny size.  Under ``--full`` it is a near-tie rule: both generators
recompute the whole sequence at a new length each call, so the matmul
shapes differ between them, and on the card so can the bits.  The run
then reports the agreement rate and, at the first divergence, the gap
between the target's logits of the two tokens, and fails when that gap
exceeds ``LOGIT_REL_TOL`` (0.1) x the largest |logit| there.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.configs.tiny import make_tiny
from repro_torch.core.speculation import (SpeculativeExecutor,
                                          autoregressive_generate,
                                          speculative_generate)
from repro_torch.device import resolve
from repro_torch.examples import check, parser, weights
from repro_torch.models.model import forward

# the near-tie limit on the target's logit gap at the first divergence,
# relative to the largest |logit| there (chip_smoke.py's rule for greedy
# tokens across shapes)
LOGIT_REL_TOL = 0.1


def draft_config(cfg):
    """``--full``'s draft: the target's width at one block repeat."""
    block = cfg.blocks[0]
    return cfg.replace(name=cfg.name + "-draft", blocks=(
        dataclasses.replace(block, repeats=1),))


def near_tie(cfg, params, prompt, out, ref) -> dict:
    """The agreement of ``out`` with ``ref`` and, at their first
    divergence, the target's logit gap between the two tokens over its
    largest |logit|; raises when the gap exceeds ``LOGIT_REL_TOL``."""
    n = len(ref)
    agree = sum(a == b for a, b in zip(out, ref)) / n
    first = next((i for i, (a, b) in enumerate(zip(out, ref)) if a != b),
                 None)
    got = dict(agreement=agree, first_divergence=first, gap=0.0, scale=0.0)
    if first is not None:
        toks = [int(t) for t in prompt] + list(ref[:first])
        with torch.no_grad():
            lg = forward(params, {"tokens": torch.tensor(
                [toks], dtype=torch.int64, device=params["embed"].device)},
                cfg=cfg, mode="train")[0, -1].float()
        gap = float(lg[ref[first]] - lg[out[first]])
        scale = float(lg.abs().max())
        got.update(gap=gap, scale=scale)
        check(abs(gap) <= LOGIT_REL_TOL * scale,
              f"speculative output left target-only decoding at token "
              f"{first} by a logit gap {gap:.4f} > {LOGIT_REL_TOL} x "
              f"{scale:.4f}")
    return got


def run(cfg, params, draft_cfg, draft_params, *, device, prompt_len=8,
        gamma=4, max_new=24, exact=True, agree_prefix=0.5, fast_s=0.02,
        slow_s=0.15) -> dict:
    prompt = np.arange(prompt_len)
    got = {}

    print("== token-level speculative decoding ==")
    out, stats = speculative_generate(draft_params, draft_cfg, params, cfg,
                                      prompt, gamma=gamma, max_new=max_new)
    ref, ar_steps = autoregressive_generate(params, cfg, prompt,
                                            max_new=max_new)
    got.update(out=out, ref=ref)
    if exact:
        check(out == ref, "speculative output != target-only output")
        print("output == target-only output: True")
    else:
        tie = near_tie(cfg, params, prompt, out, ref)
        got.update(tie)
        where = "no divergence" if tie["first_divergence"] is None else (
            f"first divergence at token {tie['first_divergence']}, logit "
            f"gap {tie['gap']:.4f} against {LOGIT_REL_TOL} x max |logit| "
            f"{tie['scale']:.4f}")
        print(f"output == target-only output: {out == ref} (agreement "
              f"{tie['agreement']:.4f}, {where})")
    got.update(target_steps=stats.target_steps, ar_steps=ar_steps,
               per_step=stats.tokens_per_target_step,
               acceptance=stats.acceptance_rate)
    print(f"target forward passes: {stats.target_steps} vs {ar_steps} "
          f"autoregressive ({stats.tokens_per_target_step:.2f} tokens "
          f"per target step, acceptance {stats.acceptance_rate:.0%})")

    # upper bound with a perfectly-aligned draft
    _, s2 = speculative_generate(params, cfg, params, cfg, prompt,
                                 gamma=gamma, max_new=max_new)
    got["perfect_per_step"] = s2.tokens_per_target_step
    print(f"perfect-draft bound: {s2.tokens_per_target_step:.2f} "
          "tokens per target step")

    print("\n== request-level fast/slow speculation (trading) ==")
    ex = SpeculativeExecutor(agree_prefix=agree_prefix)

    def fast_path():          # streamlined model, first signals only
        time.sleep(fast_s)
        return [10, 20, 30, 40]

    def slow_path_agrees():   # full market depth, same conclusion
        time.sleep(slow_s)
        return [10, 20, 30, 41]

    res = ex.run(fast_path, slow_path_agrees)
    got.update(agree_path=res.committed.path,
               agree_latency_s=res.perceived_latency_s,
               agree_speedup=res.speedup)
    print(f"agree case: committed={res.committed.path} "
          f"latency={res.perceived_latency_s*1000:.0f}ms "
          f"speedup={res.speedup:.1f}x")

    def slow_path_diverges():
        time.sleep(slow_s)
        return [99, 98, 97, 96]

    res = ex.run(fast_path, slow_path_diverges)
    got.update(diverge_path=res.committed.path, corrected=res.corrected)
    print(f"diverge case: committed={res.committed.path} (trade revised "
          f"before exposure), corrected={res.corrected}")
    return got


def main(argv=None) -> int:
    args = parser("speculative_serving", __doc__,
                  full_help="llama-1.5b at full width and depth (bf16) as "
                            "the target, its width at one layer as the "
                            "draft").parse_args(argv)
    device = resolve(args.device)
    if args.full:
        cfg = get("llama-1.5b")
        draft = draft_config(cfg)
    else:
        cfg = make_tiny(get("llama-1.5b"), d_model=64)
        draft = make_tiny(get("llama-1.5b"), d_model=32, repeats_cap=1)
    run(cfg, weights(cfg, device, args.seed), draft,
        weights(draft, device, args.seed + 1), device=device,
        exact=not args.full)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
