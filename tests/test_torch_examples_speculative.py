"""``repro_torch.examples.speculative_serving`` against the JAX package's
``examples/speculative_serving.py``.  The JAX example recompiles a
full-sequence forward at every length (minutes on the CPU), so its body
runs here with its own arguments but 8 new tokens in place of 24: the
JAX ``speculative_generate`` / ``autoregressive_generate`` on its target
(``make_tiny(d_model=64)``, ``jax.random.key(0)``) and draft
(``d_model=32, repeats_cap=1``, ``key(1)``), its lines printed by the
example's own format strings, against the port's ``run(max_new=8)`` on
the same weights bridged; line for line after the mask list.  Greedy
tokens and every step count are compared exactly; so is the near-tie
rule that ``--full`` uses in place of exact equality."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch.examples import speculative_serving  # noqa: E402
from tests.torch_helpers import (assert_same_lines, captured,  # noqa: E402
                                 to_numpy)

MAX_NEW = 8

SPEC_MASKS = [
    (r"latency=\d+ms speedup=[\d.]+x", "latency=<clock>ms speedup=<clock>x",
     "the host clock (each path is a sleep)"),
]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for this module, as in
    ``tests/test_torch_train_parity.py``: the tiny models' ops are too
    small to split, and under the suite's six workers on a shared CPU
    the split costs many times the module's time alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_scenario(pd, draft, pt, target, max_new):
    """The JAX example's ``main`` body at ``max_new`` new tokens, on the
    given weights, printing its lines."""
    from repro.core.speculation import (SpeculativeExecutor,
                                        autoregressive_generate,
                                        speculative_generate)
    prompt = np.arange(8)
    print("== token-level speculative decoding ==")
    out, stats = speculative_generate(pd, draft, pt, target, prompt,
                                      gamma=4, max_new=max_new)
    ref, ar_steps = autoregressive_generate(pt, target, prompt,
                                            max_new=max_new)
    assert out == ref
    print("output == target-only output: True")
    print(f"target forward passes: {stats.target_steps} vs {ar_steps} "
          f"autoregressive ({stats.tokens_per_target_step:.2f} tokens "
          f"per target step, acceptance {stats.acceptance_rate:.0%})")
    _, s2 = speculative_generate(pt, target, pt, target, prompt, gamma=4,
                                 max_new=max_new)
    print(f"perfect-draft bound: {s2.tokens_per_target_step:.2f} "
          "tokens per target step")
    print("\n== request-level fast/slow speculation (trading) ==")
    ex = SpeculativeExecutor(agree_prefix=0.5)

    def fast_path():
        time.sleep(0.02)
        return [10, 20, 30, 40]

    def slow_path_agrees():
        time.sleep(0.15)
        return [10, 20, 30, 41]

    res = ex.run(fast_path, slow_path_agrees)
    print(f"agree case: committed={res.committed.path} "
          f"latency={res.perceived_latency_s*1000:.0f}ms "
          f"speedup={res.speedup:.1f}x")

    def slow_path_diverges():
        time.sleep(0.15)
        return [99, 98, 97, 96]

    res = ex.run(fast_path, slow_path_diverges)
    print(f"diverge case: committed={res.committed.path} (trade revised "
          f"before exposure), corrected={res.corrected}")
    return out, ref


@pytest.fixture(scope="module")
def runs():
    from repro.configs import get as jget
    from repro.configs.tiny import make_tiny as jtiny
    from repro.models.init import init_params
    from repro_torch.configs import get
    from repro_torch.configs.tiny import make_tiny
    from repro_torch.models.init import params_from_numpy
    jt = jtiny(jget("llama-1.5b"), d_model=64)
    jd = jtiny(jget("llama-1.5b"), d_model=32, repeats_cap=1)
    jpt, jpd = init_params(jt, jax.random.key(0)), init_params(
        jd, jax.random.key(1))
    (jout, jref), jax_lines = captured(jax_scenario, jpd, jd, jpt, jt,
                                       MAX_NEW)
    tt = make_tiny(get("llama-1.5b"), d_model=64)
    td = make_tiny(get("llama-1.5b"), d_model=32, repeats_cap=1)
    tpt = params_from_numpy(to_numpy(jpt), device="cpu")
    tpd = params_from_numpy(to_numpy(jpd), device="cpu")
    out, lines = captured(speculative_serving.run, tt, tpt, td, tpd,
                          device="cpu", max_new=MAX_NEW)
    return dict(jax_lines=jax_lines, lines=lines, out=out, jout=jout,
                jref=jref, weights=(tt, tpt, td, tpd))


def test_speculative_serving_prints_the_jax_examples_lines(runs):
    assert_same_lines(runs["jax_lines"], runs["lines"], SPEC_MASKS)


def test_speculative_serving_tokens_equal_jax(runs):
    """Greedy tokens: the port's speculative and target-only outputs
    equal JAX's, and each other (the JAX example's assert)."""
    out = runs["out"]
    assert out["out"] == out["ref"] == runs["jout"] == runs["jref"]
    assert len(out["out"]) == MAX_NEW
    assert out["agree_path"] == "fast" and out["diverge_path"] == "slow"
    assert out["corrected"] is True


def test_near_tie_rule(runs):
    """``--full``'s rule: equal outputs pass with agreement 1; a swap to
    the runner-up at the output's closest call (the smallest top-2 gap,
    0.025 x max |logit| on these weights) passes and reports where and by
    how much; a swap to the last-ranked token fails."""
    from repro_torch.models.model import forward
    tt, tpt, _, _ = runs["weights"]
    prompt = np.arange(8)
    ref = runs["out"]["ref"]
    tie = speculative_serving.near_tie(tt, tpt, prompt, ref, ref)
    assert tie["agreement"] == 1.0 and tie["first_divergence"] is None

    def logits(i):
        toks = [int(t) for t in prompt] + ref[:i]
        return forward(tpt, {"tokens": torch.tensor([toks])}, cfg=tt,
                       mode="train")[0, -1].float()

    def gap(i):
        top = logits(i).topk(2).values
        return float(top[0] - top[1]) / float(logits(i).abs().max())

    at = min(range(MAX_NEW), key=gap)
    lg = logits(at)
    order = lg.argsort(descending=True).tolist()
    assert order[0] == ref[at] and gap(at) <= 0.1
    close = ref[:at] + [order[1]] + ref[at + 1:]
    tie = speculative_serving.near_tie(tt, tpt, prompt, close, ref)
    assert tie["first_divergence"] == at
    assert tie["gap"] == pytest.approx(float(lg[order[0]] - lg[order[1]]))
    assert tie["agreement"] == (MAX_NEW - 1) / MAX_NEW
    far = ref[:at] + [order[-1]] + ref[at + 1:]
    with pytest.raises(AssertionError, match="logit gap"):
        speculative_serving.near_tie(tt, tpt, prompt, far, ref)


def test_exact_check_fires(runs):
    """At the tiny size the equality is exact: a draft that changes the
    committed tokens (a speculative_generate whose output is shifted)
    makes the run raise."""
    tt, tpt, td, tpd = runs["weights"]
    real = speculative_serving.speculative_generate

    def shifted(*a, **kw):
        out, st = real(*a, **kw)
        return [(t + 1) % tt.vocab_size for t in out], st

    speculative_serving.speculative_generate = shifted
    try:
        with pytest.raises(AssertionError, match="target-only"):
            captured(speculative_serving.run, tt, tpt, td, tpd,
                     device="cpu", max_new=2)
    finally:
        speculative_serving.speculative_generate = real
