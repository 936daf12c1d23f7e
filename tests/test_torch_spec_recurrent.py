"""Speculative verify and rollback on the port's recurrent models: tiny
f32 rwkv6-7b and jamba-v0.1-52b on weights bridged from the JAX
``init_params`` (the pairs of ``tests/test_torch_rwkv6.py`` and
``tests/test_torch_jamba.py``).

Against the JAX engine: stepwise verdicts and committed tokens, and the
first distribution verdict with greedy one-hot q.  Within the port: a
rolled-back slot's recurrent leaves and next ``step_probs`` row equal a
pure run's at the same position bit for bit, after each form of
``rollback_slot`` and after ``verify_slots_distribution``; a rollback
past the kept history is refused; a slot's blob is the same with and
without a history; a ``SpeculativeTierController`` pair in both modes
commits the verify engine's pure stream, its draft exact after every
rollback.  The two JAX departures (ROADMAP Queue 3): its
``rollback_slot`` keeps the rejected drafts in the recurrent state, and
its wide verify scores a window as its first token.  Engines compared
with JAX use one slot (never 2, the tiny repeat count: the JAX
``_bcast`` mask-back)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.models.model import forward as jforward  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.core.attestation import TrustAuthority  # noqa: E402
from repro_torch.core.daemon import CLOUD, EDGE  # noqa: E402
from repro_torch.core.migration import pack_slot  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.configs.tiny import make_tiny  # noqa: E402
from repro_torch.core.channel import Fabric  # noqa: E402
from repro_torch.fleet import (EngineHandle, FleetController,  # noqa: E402
                               SpeculativeTierController)
from repro_torch.launch import fleet as fleet_cli  # noqa: E402
from repro_torch.launch.common import weights  # noqa: E402
from repro_torch.models.model import forward as tforward  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from tests.test_torch_jamba import pair as jamba_pair  # noqa: E402
from tests.test_torch_rwkv6 import pair as rwkv_pair  # noqa: E402
from tests.torch_helpers import as_f32  # noqa: E402

MODELS = {"rwkv6-7b": lambda: rwkv_pair(seed=6),
          "jamba-v0.1-52b": jamba_pair}
PROMPT = np.arange(40, 57)       # 17 tokens: one chunk on both models
PLEN = len(PROMPT)
MAX_LEN, GAMMA, NEW = 64, 4, 8

_PURE = {}


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


def port_engine(name, slots=1, seed=0, cls=Engine):
    _, tcfg, _, tp = MODELS[name]()
    return cls(tcfg, tp, slots=slots, max_len=MAX_LEN, seed=seed,
               device="cpu")


def jax_engine(name):
    jcfg, _, jp, _ = MODELS[name]()
    eng = JEngine(jcfg, jp, slots=1, max_len=MAX_LEN, seed=0)
    assert eng.add_request(JRequest("r", PROMPT, max_new_tokens=NEW))
    return eng


def started(name, **kw) -> Engine:
    eng = port_engine(name, **kw)
    assert eng.add_request(Request("r", PROMPT, max_new_tokens=NEW))
    return eng


def leaves(eng, slot=0) -> list:
    """Copies of ``slot``'s recurrent leaves, layer by layer."""
    return [a[:, slot].clone() for grp in eng.state.caches for layer in grp
            for kind in ("rwkv", "mamba")
            for a in layer.get(kind, {}).values()]


def jax_leaves(eng, slot=0) -> list:
    return [np.asarray(a[:, slot]) for grp in eng.state.caches
            for layer in grp for kind in ("rwkv", "mamba")
            for a in layer.get(kind, {}).values()]


def pure(name):
    """A pure greedy run of the prompt on the port (``step_probs``):
    its tokens, and by position the recurrent leaves before the decode
    step there and the probs row that step gave."""
    if name not in _PURE:
        eng = started(name)
        state, rows = {}, {}
        for _ in range(NEW):
            pos = int(eng.state.positions[0])
            state[pos] = leaves(eng)
            rows[pos] = eng.step_probs(auto_retire=False)[1][0]
        state[int(eng.state.positions[0])] = leaves(eng)
        _PURE[name] = (eng.requests[0].output, state, rows)
    return _PURE[name]


def bump(name, t: int) -> int:
    return (t + 1) % MODELS[name]()[1].vocab_size


def one_hot(name, toks) -> np.ndarray:
    q = np.zeros((len(toks), MODELS[name]()[1].padded_vocab), np.float32)
    q[np.arange(len(toks)), toks] = 1.0
    return q


def assert_pure_at(name, eng, pos):
    """``eng``'s slot 0 stands at ``pos`` with the pure run's leaves
    there, and its next ``step_probs`` row and token are the pure run's,
    bit for bit."""
    toks, state, rows = pure(name)
    assert int(eng.state.positions[0]) == pos
    assert all(torch.equal(a, b) for a, b in zip(leaves(eng), state[pos]))
    out, probs = eng.step_probs(auto_retire=False)
    assert np.array_equal(probs[0], rows[pos])
    assert out["r"] == toks[pos - PLEN]


# -- against the JAX engine --------------------------------------------------

@pytest.mark.parametrize("cut", [None, 0, 2], ids=["whole", "cut0", "cut2"])
@pytest.mark.parametrize("name", list(MODELS))
def test_stepwise_verdicts_and_tokens_match_jax(name, cut):
    """A draft tail of the engine's own greedy continuation, whole or
    perturbed at one index: the stepwise verdict, the committed tokens
    and the two tokens decoded after them equal the JAX engine's."""
    toks = pure(name)[0]
    drafts = list(toks[:GAMMA])
    if cut is not None:
        drafts[cut] = bump(name, drafts[cut])
    jeng, teng = jax_engine(name), started(name)
    want = {0: (GAMMA, None) if cut is None else (cut, toks[cut])}
    assert teng.verify_slots_stepwise({0: drafts}) == want
    assert jeng.verify_slots_stepwise({0: drafts}) == want
    n = GAMMA if cut is None else cut + 1
    for i in range(n, n + 2):
        assert jeng.step()["r"] == teng.step()["r"] == toks[i]


@pytest.mark.parametrize("name", list(MODELS))
def test_first_distribution_verdict_matches_jax(name):
    toks = pure(name)[0]
    drafts = list(toks[:GAMMA])
    drafts[1] = bump(name, drafts[1])
    q = {0: one_hot(name, drafts)}
    got = started(name).verify_slots_distribution(
        {0: drafts}, q, rng=torch.Generator().manual_seed(0))
    assert got == jax_engine(name).verify_slots_distribution(
        {0: drafts}, q, rng=jax.random.key(0)) == {0: (1, toks[1])}


# -- within the port: the restored state -------------------------------------

def draft(name, eng, n: int, bad: int | None):
    """``n`` greedy decode steps on slot 0, the token at index ``bad``
    replaced by its successor (as a perturbed draft tier proposes)."""
    for i in range(n):
        out = eng.step(auto_retire=False)
        if i == bad:
            eng._force_slot_token(0, bump(name, out["r"]))


@pytest.mark.parametrize("form", [(4, 1, True), (4, 3, True), (3, 0, False)],
                         ids=["correction", "correction-at-the-tip", "drop"])
@pytest.mark.parametrize("name", list(MODELS))
def test_rollback_restores_a_pure_runs_state(name, form):
    """``rollback_slot`` after a perturbed tail: with a correction behind
    the tip (the state put back), with the correction at the tip (the
    state already right) and dropping the tail (back to its start)."""
    drafted, accepted, commit = form
    toks = pure(name)[0]
    eng = started(name)
    eng.arm_rollback(0, GAMMA)
    draft(name, eng, drafted, bad=accepted)
    if commit:
        eng.rollback_slot(0, drafted, accepted, toks[accepted])
        assert_pure_at(name, eng, PLEN + accepted + 1)
    else:
        eng.rollback_slot(0, drafted, 0, None)
        assert_pure_at(name, eng, PLEN)


@pytest.mark.parametrize("cut", [1, None], ids=["cut1", "whole"])
@pytest.mark.parametrize("name", list(MODELS))
def test_distribution_verify_ends_at_a_pure_runs_state(name, cut):
    toks = pure(name)[0]
    drafts = list(toks[:GAMMA])
    if cut is not None:
        drafts[cut] = bump(name, drafts[cut])
    eng = started(name)
    got = eng.verify_slots_distribution(
        {0: drafts}, {0: one_hot(name, drafts)},
        rng=torch.Generator().manual_seed(0))
    n = GAMMA if cut is None else cut + 1
    assert got == {0: (GAMMA, None) if cut is None else (cut, toks[cut])}
    assert eng.history_bytes() == 0         # the burst's own history went
    assert_pure_at(name, eng, PLEN + n)


_JAX_DECODE = {}


def next_logits(eng, side, name):
    """Slot 0's next decode logits from a copy of ``eng``'s caches (on
    the JAX side through one compiled decode forward a model)."""
    jcfg, tcfg, jp, tp = MODELS[name]()
    s = eng.state
    if side == "jax":
        if name not in _JAX_DECODE:
            _JAX_DECODE[name] = jax.jit(functools.partial(
                jforward, cfg=jcfg, mode="decode"))
        lg, _, _ = _JAX_DECODE[name](jp, {"tokens": s.last_token[:, None]},
                                     caches=s.caches,
                                     positions=s.positions[:, None])
    else:
        caches = [[{k: {n: a.clone() for n, a in c.items()}
                    for k, c in layer.items()} for layer in grp]
                  for grp in s.caches]
        with torch.no_grad():
            lg = tforward(tp, {"tokens": s.last_token[:, None]}, cfg=tcfg,
                          mode="decode", caches=caches,
                          positions=s.positions[:, None])
    return as_f32(lg[0, 0])


@pytest.mark.parametrize("name", list(MODELS))
def test_jax_rollback_keeps_the_rejected_drafts_in_the_recurrent_state_and_the_port_does_not(name):  # noqa: E501
    """One distribution round, draft 1 perturbed: both packages commit
    (1, the pure token).  The JAX engine's recurrent leaves and next
    greedy logits then differ from its own pure run at the same position
    (its ``rollback_slot`` rewinds tokens only); the port's equal its
    pure run's bit for bit."""
    toks = pure(name)[0]
    drafts = list(toks[:GAMMA])
    drafts[1] = bump(name, drafts[1])
    q = {0: one_hot(name, drafts)}
    jeng, jpure = jax_engine(name), jax_engine(name)
    assert jeng.verify_slots_distribution(
        {0: drafts}, q, rng=jax.random.key(0)) == {0: (1, toks[1])}
    for _ in range(2):
        jpure.step_probs(auto_retire=False)
    assert int(jeng.state.positions[0]) == int(jpure.state.positions[0])
    worst = max(float(np.abs(a - b).max())
                for a, b in zip(jax_leaves(jeng), jax_leaves(jpure)))
    assert worst > 0.0
    after, want = next_logits(jeng, "jax", name), next_logits(jpure, "jax",
                                                               name)
    assert float(np.abs(after - want).max()) > 1e-3 * np.abs(want).max()

    teng, tpure = started(name), started(name)
    assert teng.verify_slots_distribution(
        {0: drafts}, q, rng=torch.Generator().manual_seed(0)) \
        == {0: (1, toks[1])}
    for _ in range(2):
        tpure.step_probs(auto_retire=False)
    assert all(torch.equal(a, b) for a, b in zip(leaves(teng), leaves(tpure)))
    assert np.array_equal(next_logits(teng, "torch", name),
                          next_logits(tpure, "torch", name))


@pytest.mark.parametrize("name", list(MODELS))
def test_jax_wide_verify_scores_the_window_as_its_first_token(name):
    """The engine's own 4-token greedy continuation: JAX stepwise accepts
    all 4, JAX wide accepts 1 (every query of the window reads the
    window's first token); the port refuses the wide mode."""
    toks = pure(name)[0]
    tail = list(toks[:GAMMA])
    assert jax_engine(name).verify_slots_stepwise({0: tail}) \
        == {0: (GAMMA, None)}
    assert jax_engine(name).verify_slots({0: tail}, width=GAMMA)[0][0] == 1
    teng = started(name)
    with pytest.raises(ValueError, match="one token at a time"):
        teng.verify_slots({0: tail}, width=GAMMA)
    assert int(teng.state.positions[0]) == PLEN


@pytest.mark.parametrize("name,want", [
    ("rwkv6-7b", {"rwkv"}), ("jamba-v0.1-52b", {"mamba"}),
    ("llama-1.5b", set())])
def test_recurrent_mixers_name_what_refuses_the_wide_mode(name, want):
    """The one rule the engine and the fleet CLI read, at full size and
    tiny."""
    assert get(name).recurrent_mixers == want
    assert make_tiny(get(name)).recurrent_mixers == want


@pytest.mark.parametrize("name", list(MODELS))
def test_rollback_past_the_kept_history_is_refused(name):
    toks = pure(name)[0]
    eng = started(name)
    with pytest.raises(ValueError, match="keeps its recurrent state back"):
        eng.rollback_slot(0, 1, 0, None)           # nothing kept yet
    eng.arm_rollback(0, 2)
    draft(name, eng, 4, bad=None)
    before = leaves(eng)
    with pytest.raises(ValueError, match=r"back to position 19 \(2 "):
        eng.rollback_slot(0, 3, 0, None)
    with pytest.raises(ValueError, match="no step has fed"):
        eng.rollback_slot(0, 1, 1, toks[4])
    assert int(eng.state.positions[0]) == PLEN + 4
    assert all(torch.equal(a, b) for a, b in zip(leaves(eng), before))
    eng.rollback_slot(0, 2, 0, None)
    assert_pure_at(name, eng, PLEN + 2)


@pytest.mark.parametrize("name", list(MODELS))
def test_packed_slot_carries_no_history(name):
    """A slot packed mid-history gives the blob of the same slot without
    one; the slot it lands in keeps none, nor does a slot reused by
    ``add_request``."""
    armed, plain = started(name), started(name)
    armed.arm_rollback(0, GAMMA)
    draft(name, armed, 3, bad=None)
    draft(name, plain, 3, bad=None)
    per_slot = sum(a.nbytes for a in leaves(armed))
    assert armed.history_bytes() == 3 * per_slot and plain.history_bytes() == 0
    blob = pack_slot(armed.extract_slot(0, keep=True))
    assert blob == pack_slot(plain.extract_slot(0, keep=True))
    dst = port_engine(name, slots=3)
    dst.inject_slot(armed.extract_slot(0), slot=2)
    assert armed.history_bytes() == 0 and dst.history_bytes() == 0
    with pytest.raises(ValueError, match="keeps its recurrent state back"):
        dst.rollback_slot(2, 1, 0, None)
    armed.add_request(Request("again", PROMPT, max_new_tokens=NEW))
    draft(name, armed, 1, bad=None)
    assert armed.history_bytes() == 0


# -- the tier pair and the CLI ------------------------------------------------

class PerturbedDraft(Engine):
    """A draft engine whose proposals at the output indices in
    ``marks[rid]`` are the greedy token's successor (its q row one-hot
    at it), so every rejection comes from a mark, and a draft whose
    rollback left a wrong state would propose a wrong token elsewhere."""
    marks: dict = {}

    def _perturb(self, out, probs=None):
        for slot, req in self.requests.items():
            if req.rid in out and len(req.output) - 1 in \
                    self.marks.get(req.rid, ()):
                t = (req.output[-1] + 1) % self.cfg.vocab_size
                req.output[-1] = out[req.rid] = t
                self._force_slot_token(slot, t)
                if probs is not None:
                    probs[slot] = 0.0
                    probs[slot, t] = 1.0
        return out

    def step(self, **kw):
        return self._perturb(super().step(**kw))

    def step_probs(self, **kw):
        out, probs = super().step_probs(**kw)
        return self._perturb(out, probs), probs


def solo(name, prompt, probs: bool) -> list[int]:
    """``prompt`` alone on an engine of the verify tier's geometry."""
    eng = port_engine(name, slots=3, seed=7)
    req = Request("solo", prompt, max_new_tokens=10)
    assert eng.add_request(req)
    while not req.done:
        eng.step_probs() if probs else eng.step()
    return req.output


@pytest.mark.parametrize("mode", ["stepwise", "distribution"])
@pytest.mark.parametrize("name", list(MODELS))
def test_tier_pair_commits_the_verify_engines_pure_stream(name, mode):
    """Two greedy requests through a draft -> verify pair on the same
    weights, the draft perturbed at seeded output indices: each committed
    stream equals the request alone on the verify engine, and the pair
    corrects exactly once a mark (a draft state left wrong by a rollback
    would cost more corrections)."""
    prompts = [PROMPT, np.arange(3, 10)]
    rng = np.random.default_rng(3)
    draft_eng = port_engine(name, slots=3, seed=1, cls=PerturbedDraft)
    draft_eng.marks = {f"r{i}": set(rng.choice(10, 3, replace=False).tolist())
                       for i in range(2)}
    fleet = FleetController(
        [EngineHandle("edge", draft_eng, EDGE),
         EngineHandle("cloud", port_engine(name, slots=3, seed=2), CLOUD)],
        authority=TrustAuthority(), spec_tiers={"edge": "cloud"},
        spec_options={"gamma": GAMMA, "verify_mode": mode})
    reqs = [Request(f"r{i}", p, max_new_tokens=10)
            for i, p in enumerate(prompts)]
    outs = fleet.run(reqs)
    st = fleet.spec_controllers["edge"].stats
    assert st.handoffs == 2 and st.local_fallbacks == 0
    assert st.corrections == 6 and st.accepted == 2 * 10 - 6
    for r in reqs:
        assert outs[r.rid] == solo(name, r.prompt, mode == "distribution")
    assert draft_eng.history_bytes() == 0


@pytest.mark.parametrize("how", ["park", "dissolve"])
@pytest.mark.parametrize("name", list(MODELS))
def test_park_and_dissolve_restore_the_draft_state(name, how):
    """``release_for_park`` (the preemptor's) and ``dissolve`` (a drained
    pair's) drop a recurrent draft's uncommitted tail mid-round: its
    leaves are a pure run's at the committed position, its history is
    gone, and the request decodes on plainly to the pure stream."""
    pure_eng = port_engine(name, slots=3)
    ref = Request("r", PROMPT, max_new_tokens=10)
    assert pure_eng.add_request(ref)
    states = {}
    while not ref.done:
        states[int(pure_eng.state.positions[0])] = leaves(pure_eng)
        pure_eng.step()
    draft = port_engine(name, slots=3, seed=1, cls=PerturbedDraft)
    draft.marks = {"r": {1}}
    verify = port_engine(name, slots=3, seed=2)
    ctl = SpeculativeTierController(
        EngineHandle("d", draft, EDGE), EngineHandle("v", verify, CLOUD),
        fabric=Fabric(), whitelist=set(), measurement="m", gamma=GAMMA)
    req = Request("r", PROMPT, max_new_tokens=10)
    assert draft.add_request(req) and ctl.attach(req) == "spec"
    while ctl.stats.rounds < 2 or len(req.output) == ctl._spec["r"].committed:
        ctl.step()
    committed = ctl._spec["r"].committed
    if how == "park":
        assert ctl.release_for_park("r")
    else:
        ctl.dissolve()
    assert draft.history_bytes() == 0 and not verify.requests
    assert len(req.output) == committed and ctl.stats.corrections == 1
    assert all(torch.equal(a, b) for a, b in
               zip(leaves(draft), states[PLEN + committed]))
    while draft.requests:
        ctl.step()
    assert req.output == ref.output


@pytest.mark.parametrize("mode", ["stepwise", "distribution", "wide"])
def test_fleet_cli_speculates_on_rwkv(mode, capsys):
    """``launch.fleet --arch rwkv6-7b --tiny --spec-tiers`` with a hot
    drafter: each greedy request (the even ones) goes through the pair
    and prints the tokens it gives alone on the verify engine;
    ``--verify-mode wide`` is a usage error naming the reason."""
    argv = ["--arch", "rwkv6-7b", "--tiny", "--device", "cpu", "--requests",
            "4", "--max-new", "8", "--slots", "3", "--engines",
            "edge:edge:64,cloud:cloud:96", "--spec-tiers", "edge:cloud",
            "--drafter-temperature", "0.8", "--verify-mode", mode]
    if mode == "wide":
        with pytest.raises(SystemExit) as e:
            fleet_cli.main(argv)
        assert e.value.code == 2
        assert "rwkv mixers step one token at a time" in \
            capsys.readouterr().err
        return
    assert fleet_cli.main(argv) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if " via edge->cloud: " in ln and ln[:2] in ("r0", "r2")]
    cfg = make_tiny(get("rwkv6-7b"))
    params = weights(cfg, 0, torch.device("cpu"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(5, cfg.vocab_size, 8) for _ in range(4)]
    assert [ln.split("[")[0] for ln in lines] == ["r0", "r2"]
    for ln in lines:
        eng = Engine(cfg, params, slots=3, max_len=96, device="cpu")
        req = Request("solo", prompts[int(ln[1])], max_new_tokens=8)
        assert eng.add_request(req)
        while not req.done:
            eng.step_probs() if mode == "distribution" else eng.step()
        assert ln.split(": ", 1)[1] == str(req.output)
