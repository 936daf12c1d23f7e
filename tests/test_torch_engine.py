"""The port's dense serving engine (``repro_torch.serving.engine``) on the
CPU: the dense cache and its write mask, the capacity API and refusals,
and the JAX ``Engine`` on the same (bridged) weights -- greedy decode,
``step_probs``, the three verify modes, ``rollback_slot`` and
``add_request(committed=...)``.  The one-program contract holds within
the port."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import LayerSpec  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import forward as jforward  # noqa: E402
from repro.models.model import make_cache as jmake_cache  # noqa: E402
from repro.models.model import vocab_mask_logits  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.model import make_cache  # noqa: E402
from repro_torch.serving import program_cache  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from tests.torch_helpers import bridged_params, configs  # noqa: E402

# greedy tokens across frameworks: f32 logits agree to ~1e-5, so a
# divergence is only legitimate where the JAX top-2 logit gap is below this
GAP_TOL = 1e-4
PROBS_TOL = 1e-5

_SHARED = {}


def _pair():
    """One f32 tiny llama in both packages on bridged weights, shared by
    the module so each engine geometry compiles its JAX programs once."""
    if not _SHARED:
        jcfg, tcfg = configs("float32")
        jp, tp = bridged_params(jcfg, seed=5)
        _SHARED.update(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp)
    return _SHARED


def engines(slots=3, max_len=64, seed=0):
    s = _pair()
    return (JEngine(s["jcfg"], s["jp"], slots=slots, max_len=max_len,
                    seed=seed),
            Engine(s["tcfg"], s["tp"], slots=slots, max_len=max_len,
                   seed=seed, device="cpu"))


def reqs(prompts, max_new=10, **kw):
    return ([JRequest(f"r{i}", np.asarray(p), max_new_tokens=max_new, **kw)
             for i, p in enumerate(prompts)],
            [Request(f"r{i}", np.asarray(p), max_new_tokens=max_new, **kw)
             for i, p in enumerate(prompts)])


PROMPTS = [np.arange(2, 9), np.arange(40, 57), np.arange(100, 103) * 3]


def same_state(jeng, teng, slots):
    for f in ("positions", "last_token", "tokens", "active"):
        a = np.asarray(getattr(jeng.state, f))[slots]
        b = getattr(teng.state, f).numpy()[slots]
        assert np.array_equal(a, b), (f, a, b)


def own_tokens(n, prompts, slots=3):
    """The port's own greedy continuation of each prompt (pure run)."""
    _, teng = engines(slots=slots)
    _, tr = reqs(prompts, max_new=n)
    for r in tr:
        assert teng.add_request(r)
    for _ in range(n):
        teng.step(auto_retire=False)
    return [list(r.output) for r in tr]


# -- the dense cache --------------------------------------------------------

def test_dense_cache_layout_and_masked_writes_match_jax():
    s = _pair()
    jc = jmake_cache(s["jcfg"], 3, 48)
    tc = make_cache(s["tcfg"], 3, 48, device="cpu")
    jleaf, tleaf = jc[0][0]["attn"], tc[0][0]["attn"]
    for k in ("k", "v", "abs_pos"):
        assert tuple(jleaf[k].shape) == tuple(tleaf[k].shape)
        assert str(jleaf[k].dtype) == str(tleaf[k].dtype).split(".")[-1]
    assert int(tleaf["abs_pos"].min()) == -1
    rng = np.random.default_rng(0)
    for lspec in (LayerSpec("attn", "dense"),
                  LayerSpec("local", "dense", window=16)):
        cache = tlayers.make_attn_cache(s["tcfg"], lspec, 3, 48,
                                        device="cpu")
        jcache = jlayers.make_attn_cache(s["jcfg"], lspec, 3, 48)
        old = {k: v.clone() for k, v in cache.items()}
        k = rng.standard_normal((3, 5, 2, 16)).astype(np.float32)
        v = rng.standard_normal((3, 5, 2, 16)).astype(np.float32)
        pos = (np.asarray([[0], [20], [40]]) + np.arange(5)).astype(np.int32)
        cache["write"] = torch.tensor([True, False, True])
        tlayers._write_cache(cache, lspec, torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(pos))
        new = jlayers._write_cache(jcache, lspec, jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(pos))
        for key in ("k", "v", "abs_pos"):
            for row in (0, 2):
                assert np.array_equal(np.asarray(new[key][row]),
                                      cache[key][row].numpy()), key
            assert torch.equal(cache[key][1], old[key][1])   # masked row


def test_capacity_api_refusals_and_program_sharing():
    _, teng = engines(slots=2, max_len=64)
    assert teng.free_token_budget == 128
    assert teng.can_admit(64) and not teng.can_admit(65)
    assert teng.admissible(64) and not teng.admissible(65)
    assert teng.add_request(Request("a", np.arange(2, 8), max_new_tokens=8))
    assert teng.free_slots == [1] and teng.free_token_budget == 64
    with pytest.raises(ValueError, match="max_len"):
        teng.add_request(Request("big", np.arange(60), max_new_tokens=8))
    assert teng.free_slots == [1]            # refused before the slot moved
    assert teng.add_request(Request("b", np.arange(3, 9), max_new_tokens=8))
    assert not teng.add_request(Request("c", np.arange(4), max_new_tokens=2))
    assert not teng.can_admit(8) and teng.free_token_budget == 0
    snap = teng.extract_slot(0, keep=True)      # the migration surface
    with pytest.raises(ValueError, match="no free slot"):
        teng.inject_slot(snap)
    assert teng.slot_like().tokens.shape == (64,)
    with pytest.raises(AssertionError, match="overruns"):
        teng.verify_slots({0: [1, 2]}, width=60)
    assert teng.supports_wide_verify and not teng.paged
    big = Engine(_pair()["tcfg"], _pair()["tp"], slots=1, max_len=1024,
                 device="cpu")
    with pytest.raises(ValueError, match="domain"):
        big.add_request(Request("long", np.arange(700) % 500,
                                max_new_tokens=8))
    assert big.free_slots == [0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Engine(_pair()["tcfg"], _pair()["tp"])  # default device: cuda
    program_cache.clear()
    a, b = engines(slots=2)[1], engines(slots=2)[1]
    c = engines(slots=3)[1]
    assert not a.program_cache_hit and b.program_cache_hit
    assert a._programs is b._programs and c._programs is not a._programs
    assert a._programs.key[0] == "dense"


# -- against the JAX Engine --------------------------------------------------

def test_greedy_decode_agrees_with_jax_engine():
    """Both engines serve the same greedy requests in lockstep, with a
    fourth admitted into a slot a finished request left (its stale rows
    must stay invisible).  At a divergence the JAX top-2 logit gap must
    be a knife edge."""
    jeng, teng = engines(slots=3)
    prompts = PROMPTS + [np.arange(7, 19)]
    jr, tr = reqs(prompts, max_new=12)
    for r in (jr, tr):
        r[0].max_new_tokens = 5                 # frees slot 0 early
    for a, b in zip(jr[:3], tr[:3]):
        assert jeng.add_request(a) and teng.add_request(b)
    s = _pair()
    matched, diverged = 0, {}
    while jeng.requests or jr[3].slot < 0:
        if len(jeng.requests) < 3 and jr[3].slot < 0:
            assert jeng.add_request(jr[3]) and teng.add_request(tr[3])
            assert jr[3].slot == tr[3].slot == 0
        before = jeng.state
        je, te = jeng.step(), teng.step()
        assert set(je) == set(te)
        for rid, tok in je.items():
            if rid in diverged:
                continue
            if te[rid] == tok:
                matched += 1
                continue
            row = [r for r in jr if r.rid == rid][0].slot
            lg, _, _ = jforward(s["jp"], {"tokens": before.last_token[:, None]},
                                cfg=s["jcfg"], mode="decode",
                                caches=before.caches,
                                positions=before.positions[:, None])
            top2 = jax.lax.top_k(vocab_mask_logits(lg[row, 0], s["jcfg"]),
                                 2)[0]
            diverged[rid] = float(top2[0] - top2[1])
    total = sum(r.max_new_tokens for r in tr)
    assert all(len(r.output) == r.max_new_tokens for r in tr)
    # measured on this seed: 1.0 (no divergence)
    assert all(gap < GAP_TOL for gap in diverged.values()), diverged
    assert matched == total or diverged


def test_step_probs_match_jax_engine():
    """Greedy and sampled rows side by side: every row's distribution on
    the first step, and the greedy rows' on every step, within 1e-5."""
    jeng, teng = engines(slots=3)
    jr, tr = reqs(PROMPTS, max_new=6)
    for rs in (jr, tr):
        rs[1].temperature, rs[1].top_k = 0.8, 5
        rs[2].temperature = 1.3
    for a, b in zip(jr, tr):
        assert jeng.add_request(a) and teng.add_request(b)
    for step in range(4):
        je, jp = jeng.step_probs()
        te, tp = teng.step_probs()
        assert tp.shape == jp.shape and tp.dtype == np.float32
        rows = [0, 1, 2] if step == 0 else [0]
        assert np.abs(jp[rows] - tp[rows]).max() < PROBS_TOL, step
        assert je["r0"] == te["r0"]
        assert np.isclose(tp.sum(-1), 1.0, atol=1e-5).all()
    assert set(np.flatnonzero(tp[0])) == {te["r0"]}      # greedy: one-hot


@pytest.mark.parametrize("mode", ["wide", "stepwise"])
def test_token_verify_matches_jax_engine(mode):
    """Tails that are the engine's own greedy continuation (accepted in
    full) and tails with a wrong token (cut there, corrected): same
    verdicts and the same committed state in both packages; decode then
    continues identically."""
    own = own_tokens(6, PROMPTS)
    jeng, teng = engines(slots=3)
    jr, tr = reqs(PROMPTS, max_new=20)
    for a, b in zip(jr, tr):
        assert jeng.add_request(a) and teng.add_request(b)
    drafts = {0: own[0][:4], 1: own[1][:3], 2: list(own[2][:4])}
    drafts[1][1] = (drafts[1][1] + 7) % 500       # rejected at 1
    drafts[2][3] = (drafts[2][3] + 1) % 500       # rejected at 3
    if mode == "wide":
        jres = jeng.verify_slots(drafts, width=4)
        tres = teng.verify_slots(drafts, width=4)
    else:
        jres = jeng.verify_slots_stepwise(drafts)
        tres = teng.verify_slots_stepwise(drafts)
    assert tres == jres
    assert tres[0] == (4, None) and tres[1] == (1, own[1][1]) \
        and tres[2] == (3, own[2][3])
    pos = teng.state.positions.numpy()
    for slot in range(3):
        rows = slice(0, int(pos[slot]))
        assert np.array_equal(np.asarray(jeng.state.tokens)[slot, rows],
                              teng.state.tokens.numpy()[slot, rows])
    same_state(jeng, teng, [0, 1, 2])
    assert jeng.step() == teng.step()


def test_distribution_verify_greedy_matches_jax_engine():
    """One-hot drafter and target distributions make the Leviathan rule
    free of randomness: same verdicts and state as the JAX engine."""
    own = own_tokens(5, PROMPTS)
    jeng, teng = engines(slots=3)
    jr, tr = reqs(PROMPTS, max_new=20)
    for a, b in zip(jr, tr):
        assert jeng.add_request(a) and teng.add_request(b)
    V = _pair()["tcfg"].padded_vocab
    drafts = {0: own[0][:4], 2: list(own[2][:3])}
    drafts[2][1] = (drafts[2][1] + 3) % 500
    q = {s: np.eye(V, dtype=np.float32)[d] for s, d in drafts.items()}
    jres = jeng.verify_slots_distribution(drafts, q, rng=jax.random.key(3))
    tres = teng.verify_slots_distribution(
        drafts, q, rng=torch.Generator().manual_seed(3))
    assert tres == jres == {0: (4, None), 2: (1, own[2][1])}
    pos = teng.state.positions.numpy()
    assert np.array_equal(np.asarray(jeng.state.positions), pos)
    assert pos.tolist() == [len(PROMPTS[0]) + 4, len(PROMPTS[1]),
                            len(PROMPTS[2]) + 2]
    for slot in range(3):
        rows = slice(0, int(pos[slot]))
        assert np.array_equal(np.asarray(jeng.state.tokens)[slot, rows],
                              teng.state.tokens.numpy()[slot, rows])
    assert np.array_equal(np.asarray(jeng.state.last_token),
                          teng.state.last_token.numpy())
    assert teng.state.active.tolist() == [True] * 3
    assert jeng.step() == teng.step()


def test_rollback_slot_matches_jax_engine():
    jeng, teng = engines(slots=3)
    jr, tr = reqs(PROMPTS, max_new=20)
    for a, b in zip(jr, tr):
        assert jeng.add_request(a) and teng.add_request(b)
    for _ in range(5):
        assert jeng.step(auto_retire=False) == teng.step(auto_retire=False)
    for eng in (jeng, teng):
        eng.rollback_slot(0, 3, 1, 77)           # keep 1, splice 77
        eng.rollback_slot(1, 2, 0, None)         # drop the tail
        eng.rollback_slot(2, 4, 4, 5)            # keep all, splice 5
    same_state(jeng, teng, [0, 1, 2])
    assert teng.state.positions.tolist() == [
        len(PROMPTS[0]) + 4, len(PROMPTS[1]) + 3, len(PROMPTS[2]) + 6]
    assert teng.state.last_token.tolist()[0::2] == [77, 5]
    for _ in range(3):
        assert jeng.step(auto_retire=False) == teng.step(auto_retire=False)


def test_add_request_committed_matches_jax_engine():
    """The lossy cross-tier restore: re-prefill prompt + committed tokens,
    the committed tokens become the output prefix, decode continues.
    Three slots, not two: with as many slots as the tiny model has
    repeats, the JAX engine's mask-back drops the second layer's decode
    writes (ROADMAP, reference behaviours)."""
    jeng, teng = engines(slots=3)
    committed = [11, 12, 13, 14, 15]
    jr, tr = reqs(PROMPTS[:1], max_new=12)
    assert jeng.add_request(jr[0], committed=committed)
    assert teng.add_request(tr[0], committed=committed)
    assert tr[0].output == committed == jr[0].output
    same_state(jeng, teng, [0])
    while jeng.requests:
        assert jeng.step() == teng.step()
    assert tr[0].output == jr[0].output and len(tr[0].output) == 12


def test_inactive_rows_stay_untouched_and_stepwise_is_bit_exact():
    """A retired slot's cache rows survive decode steps and verify bursts
    of the other slots bit for bit; on ``Engine(slots=1)`` the stepwise
    verify accepts the geometry's own greedy tokens, all of them."""
    _, teng = engines(slots=2)
    _, tr = reqs(PROMPTS[:2], max_new=30)
    for r in tr:
        assert teng.add_request(r)
    teng.step(auto_retire=False)
    teng.retire(1)
    snap = [{k: a[:, 1].clone() for k, a in layer["attn"].items()}
            for grp in teng.state.caches for layer in grp]
    for _ in range(3):
        teng.step(auto_retire=False)
    teng.verify_slots({0: [1, 2, 3]})
    teng.verify_slots_stepwise({0: [4, 5]})
    now = [{k: a[:, 1] for k, a in layer["attn"].items()}
           for grp in teng.state.caches for layer in grp]
    for a, b in zip(snap, now):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    own = own_tokens(12, PROMPTS[2:], slots=1)[0]
    _, one = engines(slots=1)
    assert one.add_request(Request("x", PROMPTS[2], max_new_tokens=12))
    assert one.verify_slots_stepwise({0: own}) == {0: (12, None)}
