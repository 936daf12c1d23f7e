"""The port's speculative execution (``repro_torch.core.speculation``) and
its validators (``repro_torch.core.validation``) on the CPU, against the
JAX package on the same (bridged) weights, plus the Leviathan guarantee of
``spec_verify``: the first committed token is distributed as the
target's first distribution, whatever the drafter proposed."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.configs.tiny import make_tiny as jtiny  # noqa: E402
from repro.core import speculation as jspec  # noqa: E402
from repro.core import validation as jval  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.configs.tiny import make_tiny as ttiny  # noqa: E402
from repro_torch.core import speculation as tspec  # noqa: E402
from repro_torch.core import validation as tval  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.init import init_params, params_to_numpy  # noqa: E402


def _models(d_model, repeats_cap, seed):
    """One f32 tiny llama in both packages on the same weights: the
    port's init carried into JAX through the numpy bridge (cheaper than
    the JAX init; the weights are what matters, not who drew them)."""
    kw = dict(d_model=d_model, repeats_cap=repeats_cap)
    jcfg = jtiny(jget("llama-1.5b"), **kw).replace(dtype="float32")
    tcfg = ttiny(tget("llama-1.5b"), **kw).replace(dtype="float32")
    tp = init_params(tcfg, torch.Generator().manual_seed(seed), device="cpu")
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp))
    return jcfg, jp, tcfg, tp


def test_speculative_generate_greedy_matches_jax_and_target():
    """A narrower draft (d_model 32, one repeat) under the tiny target:
    greedy speculative output equals the port's target-only output and
    the JAX package's speculative output, round for round (this draft's
    proposals are rejected, so every round takes the correction path)."""
    jt, jtp, tt, ttp = _models(64, 2, 0)
    jd, jdp, td, tdp = _models(32, 1, 1)
    prompt = np.arange(6)
    out, st = tspec.speculative_generate(tdp, td, ttp, tt, prompt, gamma=2,
                                         max_new=4)
    ref, steps = tspec.autoregressive_generate(ttp, tt, prompt, max_new=4)
    jout, jst = jspec.speculative_generate(jdp, jd, jtp, jt, prompt,
                                           gamma=2, max_new=4)
    assert out == ref and steps == 4
    assert out == [int(t) for t in jout]
    assert (st.proposed, st.accepted, st.target_steps, st.draft_steps) == \
        (jst.proposed, jst.accepted, jst.target_steps, jst.draft_steps)
    assert st.proposed > st.accepted        # corrections were taken


def test_self_draft_acceptance_is_total():
    """Draft == target: every proposal accepted."""
    _, _, cfg, p = _models(64, 2, 0)
    out, st = tspec.speculative_generate(p, cfg, p, cfg, np.arange(6),
                                         gamma=4, max_new=16)
    assert st.acceptance_rate == 1.0
    assert st.tokens_per_target_step >= 4.0
    assert len(out) == 16


def test_sampled_speculative_generate_is_a_function_of_the_seed():
    cfg = ttiny(tget("llama-1.5b"))
    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    d = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    runs = [tspec.speculative_generate(d, cfg, p, cfg, np.arange(6),
                                       gamma=3, max_new=10, temperature=0.9,
                                       seed=s)[0] for s in (4, 4, 5)]
    assert runs[0] == runs[1] != runs[2]
    assert all(len(r) == 10 and all(0 <= t < cfg.vocab_size for t in r)
               for r in runs)
    with pytest.raises(ValueError, match="domain"):
        tspec.autoregressive_generate(p, cfg, np.arange(600) % 500,
                                      max_new=1)


def test_speculative_executor_matches_jax():
    """Same fast/slow paths and validators: same verdicts, same commit."""
    def validator(toks):
        return (jval.HARMFUL.start not in toks, "harmful")

    slow = lambda: [1, 2, 3, 9]                   # noqa: E731
    for fast_toks, validators, agree in (
            ([1, 2, 3, 4], None, 0.5),
            ([7, 7, 7, 7], None, 0.5),
            ([1, 2, 3, 4], None, 1.0),
            ([1, 2, jval.HARMFUL.start, 4], [validator], 0.5)):
        outs = []
        for mod in (jspec, tspec):
            ex = mod.SpeculativeExecutor(agree_prefix=agree,
                                         validators=validators)
            outs.append(ex.run(lambda: list(fast_toks), slow))
        j, t = outs
        assert (t.agreed, t.corrected, t.committed.path,
                t.committed.tokens) == (j.agreed, j.corrected,
                                        j.committed.path, j.committed.tokens)
    ex = tspec.SpeculativeExecutor(agree_prefix=0.5)

    def slow_sleep():
        time.sleep(0.02)
        return [1, 2, 3, 9]
    out = ex.run(lambda: [1, 2, 3, 4], slow_sleep)
    assert out.committed.path == "fast" and out.speedup > 1.0


def test_validation_copy_matches_jax():
    """The port's numpy-only validator framework gives the JAX package's
    verdicts on the same streams and seeds."""
    streams = [[100, 101, jval.HARMFUL.start, 103, 104, 105],
               [100 + i for i in range(8)],
               [100, 101, jval.PII.start + 2, 103]]
    for toks in streams:
        res = []
        for mod in (jval, tval):
            it = iter(toks + [None])
            out, rep = mod.ValidationFramework(stride=2).validate_stream(
                lambda: next(it))
            post = mod.ValidationFramework().validate_post_hoc(toks)
            res.append((out, rep.intervened, rep.halt_position,
                        [(v.ok, v.kind) for v in rep.verdicts],
                        post.intervened, post.halt_position))
        assert res[0] == res[1]
    lp = [-1.0, -6.0, -7.0, -8.0, -6.5, -1.0]
    assert tval.HallucinationValidator(miss_rate=0.0).check(
        [1] * 6, lp).ok is False
    assert [v.name for v in tval.default_zoo()] == \
        [v.name for v in jval.default_zoo()]


def test_leviathan_first_token_follows_the_target():
    """At V=8, 5000 verify draws with drafts sampled from q: the first
    committed token's frequencies are within total variation 0.03 of the
    target's p[0] (the draft's q[0] is far from it)."""
    rng = np.random.default_rng(0)
    V, g, n = 8, 3, 5000
    q = rng.dirichlet(np.ones(V) * 0.7, size=g).astype(np.float32)
    p = rng.dirichlet(np.ones(V) * 0.7, size=g + 1).astype(np.float32)
    qt, pt = torch.from_numpy(q), torch.from_numpy(p)
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(V)
    for _ in range(n):
        d = np.asarray([rng.choice(V, p=row / row.sum()) for row in q],
                       np.int32)
        acc, nxt = ops.spec_verify(torch.from_numpy(d), qt, pt, gen)
        counts[d[0] if int(acc) >= 1 else int(nxt)] += 1
    tv = 0.5 * np.abs(counts / n - p[0]).sum()
    assert tv < 0.03, tv
    assert 0.5 * np.abs(q[0] - p[0]).sum() > 0.2      # the test can fail
