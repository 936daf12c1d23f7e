"""The port's speculative tier on the CPU: counterparts of the tests of
``tests/test_fleet_speculation.py`` (acceptance equivalence at one and
at two max_lens, the rejection bounce-back, sensitivity and non-greedy
fallbacks, foreign failover slots on a draft engine, pair dissolution on
drain and failure, the wide and stepwise verify mechanics, rollback,
``repack_slot``, the heterogeneous drain) on tiny llama-1.5b with the
JAX package's seed-0 weights bridged.
``test_validator_halts_speculative_request_mid_stream`` fails on the
JAX package itself and has no counterpart.  The parity test drives one
speculative stream through both packages' tier controllers."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get  # noqa: E402
from repro_torch.configs.tiny import make_tiny  # noqa: E402
from repro_torch.core.attestation import TrustAuthority  # noqa: E402
from repro_torch.core.daemon import CLOUD, EDGE, DeviceProfile  # noqa: E402
from repro_torch.core.migration import pack_slot, repack_slot  # noqa: E402
from repro_torch.core.tree import leaves_with_path  # noqa: E402
from repro_torch.fleet import (EngineHandle, FleetController,  # noqa: E402
                               RequestSpec, percentile)
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from tests import helpers  # noqa: E402
from tests.torch_helpers import (assert_conserved, fleet_record,  # noqa: E402
                                 fleet_side, fleet_weights)

CFG = make_tiny(get("llama-1.5b"))
SLOTS = 3
EDGE_LEN, CLOUD_LEN = 64, 160


def _params():
    return fleet_weights()["torch"]["full"][1]


def mk_engine(seed=0, max_len=EDGE_LEN, slots=SLOTS):
    return Engine(CFG, _params(), slots=slots, max_len=max_len, seed=seed,
                  device="cpu")


def mk_spec_fleet(edge_len=EDGE_LEN, cloud_len=CLOUD_LEN,
                  cloud_profile=CLOUD, **spec_options):
    handles = [
        EngineHandle("edge", mk_engine(seed=0, max_len=edge_len), EDGE),
        EngineHandle("cloud", mk_engine(seed=1, max_len=cloud_len),
                     cloud_profile),
    ]
    return FleetController(handles, authority=TrustAuthority(),
                           spec_tiers={"edge": "cloud"},
                           spec_options=spec_options)


def reference_output(prompt, max_new, *, max_len, seed=1234):
    """The request served alone on an engine with the *same geometry*
    (slots, max_len) as the tier under test."""
    eng = mk_engine(seed=seed, max_len=max_len)
    req = Request("ref", np.asarray(prompt), max_new_tokens=max_new)
    eng.add_request(req)
    while not req.done:
        eng.step()
    return req.output


def mk_requests(n, max_new=10, **kw):
    rng = np.random.default_rng(7)
    return [Request(f"r{i}", rng.integers(5, CFG.vocab_size, 6),
                    max_new_tokens=max_new, **kw) for i in range(n)]


# -- acceptance equivalence (the tentpole contract) ---------------------------

def test_spec_output_equals_verify_engine_solo_same_max_len():
    """Greedy speculative-tier output is token-identical to running the
    request entirely on the verify engine (equal context budgets)."""
    fleet = mk_spec_fleet(cloud_len=EDGE_LEN, gamma=4)
    reqs = mk_requests(3)
    outs = fleet.run(reqs)
    st = fleet.spec_controllers["edge"].stats
    assert st.handoffs == 3 and st.local_fallbacks == 0
    for r in reqs:
        assert outs[r.rid] == reference_output(r.prompt, 10,
                                               max_len=EDGE_LEN), r.rid
        assert fleet.placements[r.rid] == ["edge", "cloud"]
    # greedy drafter against the same weights: nothing to reject
    assert st.acceptance_rate == 1.0 and st.corrections == 0


def test_spec_output_equals_verify_engine_solo_heterogeneous_max_len():
    """The lifted PR-1 limitation: a short-context edge engine hands off
    to a long-context cloud engine (repack_slot re-layout) and committed
    output still equals the cloud engine running alone."""
    fleet = mk_spec_fleet(gamma=4)
    assert fleet.handles["edge"].engine.max_len != \
        fleet.handles["cloud"].engine.max_len
    reqs = mk_requests(3)
    outs = fleet.run(reqs)
    assert fleet.spec_controllers["edge"].stats.handoffs == 3
    for r in reqs:
        assert outs[r.rid] == reference_output(r.prompt, 10,
                                               max_len=CLOUD_LEN), r.rid


def test_rejection_bounce_back_hot_drafter():
    """A hot drafter proposes junk: the verifier cuts the tails, bounces
    the rejected suffixes back (draft slots rewind), and the committed
    stream STILL equals the verify engine's own greedy output."""
    fleet = mk_spec_fleet(gamma=4, drafter_temperature=1.2,
                          drafter_top_k=8)
    reqs = mk_requests(3)
    outs = fleet.run(reqs)
    st = fleet.spec_controllers["edge"].stats
    assert st.corrections > 0, "hot drafter must be rejected sometimes"
    assert st.acceptance_rate < 1.0
    assert st.proposed > st.accepted
    for r in reqs:
        assert outs[r.rid] == reference_output(r.prompt, 10,
                                               max_len=CLOUD_LEN), r.rid


def test_sensitivity_blocked_falls_back_to_local_drafting():
    """Confidential work may not land on an unattested verify tier: the
    request never hands off, decodes to completion on the draft engine
    alone, and is still greedy-exact for the draft geometry."""
    unattested = DeviceProfile("cloudX", peak_flops=197e12, hbm_bw=819e9,
                               chips=8, attested=False)
    fleet = mk_spec_fleet(cloud_profile=unattested)
    conf = Request("conf", np.arange(5), max_new_tokens=8,
                   sensitivity="confidential")
    pub = Request("pub", np.arange(2, 7), max_new_tokens=8)
    outs = fleet.run([conf, pub])
    st = fleet.spec_controllers["edge"].stats
    assert st.local_fallbacks >= 1
    assert fleet.placements["conf"] == ["edge"]     # never left the edge
    assert outs["conf"] == reference_output(np.arange(5), 8,
                                            max_len=EDGE_LEN)
    # public traffic still speculates on the (unattested) verify tier
    assert fleet.placements["pub"] == ["edge", "cloud"]
    assert outs["pub"] == reference_output(np.arange(2, 7), 8,
                                           max_len=CLOUD_LEN)


def test_non_greedy_requests_stay_local():
    fleet = mk_spec_fleet()
    hot = Request("hot", np.arange(5), max_new_tokens=8, temperature=0.9,
                  top_k=8)
    outs = fleet.run([hot])
    assert fleet.spec_controllers["edge"].stats.local_fallbacks == 1
    assert fleet.placements["hot"] == ["edge"]
    assert len(outs["hot"]) == 8


def test_foreign_failover_slot_onto_draft_engine_completes():
    """A normal engine's failover slots may land on a *draft* engine
    (never on the reserved verify engine): the tier controller plain-
    decodes requests it never attached, so nothing is silently lost."""
    from repro_torch.core.daemon import MCU
    handles = [
        EngineHandle("edge", mk_engine(seed=0), EDGE),
        EngineHandle("cloud", mk_engine(seed=1, max_len=CLOUD_LEN),
                     CLOUD),
        EngineHandle("mcu", mk_engine(seed=2), MCU),
    ]
    fleet = FleetController(handles, authority=TrustAuthority(),
                            spec_tiers={"edge": "cloud"})
    reqs = mk_requests(5, max_new=10)           # public: mcu-eligible
    for r in reqs:
        assert fleet.submit(r)
    for _ in range(4):
        fleet.step()
    moved = [rid for rid, (_, h, _) in fleet.inflight.items()
             if h == "mcu"]
    assert moved, "mcu must hold in-flight work to fail over"
    fleet.fail("mcu")
    outs = fleet.run()
    assert len(outs) == 5
    for rid in moved:
        assert fleet.placements[rid][-1] != "cloud"   # never the verify
        assert outs[rid] == reference_output(
            fleet.done[rid].prompt, 10, max_len=EDGE_LEN), rid


def test_drain_verify_engine_dissolves_pair_to_local_drafting():
    """Draining the verify tier is a planned dissolution, not a refusal:
    speculative requests drop their uncommitted tails and finish
    local-only on the draft engine (drained early enough that nothing
    was committed, the output is pure draft-engine greedy)."""
    fleet = mk_spec_fleet(gamma=4)
    reqs = mk_requests(2, max_new=12)
    for r in reqs:
        assert fleet.submit(r)
    for _ in range(3):
        fleet.step()                  # mid-draft, nothing committed yet
    fleet.drain("cloud")
    assert not fleet.spec_controllers           # pair dissolved
    assert fleet.handles["edge"].spec_role is None
    assert fleet.handles["cloud"].spec_role is None
    assert not fleet.handles["cloud"].healthy   # drained away
    outs = fleet.run()
    for r in reqs:
        assert outs[r.rid] == reference_output(r.prompt, 12,
                                               max_len=EDGE_LEN), r.rid
        assert fleet.tickets[r.rid].state.value == "done"


def test_drain_draft_engine_dissolves_pair_and_migrates_slots():
    """The ROADMAP 'drain/rebalance of tier-paired engines' item:
    draining the *draft* engine dissolves the pair (uncommitted tails
    dropped), releases the reserved verify engine back into the fleet,
    and live-migrates the now-plain slots off the drained engine --
    where they resume bit-identically (edge-computed prefix, verify-
    geometry continuation, exactly the hand-off numerics contract)."""
    fleet = mk_spec_fleet(gamma=4)
    reqs = mk_requests(2, max_new=12)
    for r in reqs:
        assert fleet.submit(r)
    for _ in range(3):
        fleet.step()                  # mid-draft, nothing committed yet
    moved = fleet.drain("edge")
    assert moved == 2                 # both slots left the draft engine
    assert not fleet.spec_controllers
    assert not fleet.handles["edge"].healthy
    assert all(m.reason == "drain" and m.src == "edge" and
               m.dst == "cloud" for m in
               fleet.telemetry.migrations if m.reason == "drain")
    outs = fleet.run()
    for r in reqs:
        assert fleet.placements[r.rid][-1] == "cloud"
        assert outs[r.rid] == reference_output(r.prompt, 12,
                                               max_len=CLOUD_LEN), r.rid


def test_wide_mode_refused_for_unsupported_mixers(monkeypatch):
    """verify_mode='wide' must fail loudly when the verify engine's
    mixers cannot score multi-query windows (recurrent mixers step one
    token at a time), instead of silently mis-verifying."""
    from repro_torch.core.channel import Fabric
    from repro_torch.fleet import SpeculativeTierController
    verify = EngineHandle("v", mk_engine(seed=1), CLOUD)
    draft = EngineHandle("d", mk_engine(seed=0), EDGE)
    monkeypatch.setattr(Engine, "supports_wide_verify",
                        property(lambda self: False))
    with pytest.raises(ValueError, match="wide"):
        SpeculativeTierController(
            draft, verify, fabric=Fabric(), whitelist=set(),
            measurement="m", verify_mode="wide")
    # stepwise is always legal
    SpeculativeTierController(draft, verify, fabric=Fabric(),
                              whitelist=set(), measurement="m")


def test_draft_engine_failure_resumes_from_committed_prefix():
    """The shadow-checkpoint satellite: the controller snapshots each
    speculative slot's committed prefix after every verify round, so a
    draft-engine crash no longer restarts covered requests from their
    prompts -- failover resumes them from the last committed token on a
    survivor, exactly like a dense shadow failover."""
    fleet = mk_spec_fleet(gamma=4)
    rng = np.random.default_rng(7)
    tickets = [fleet.submit(RequestSpec(
        rid=f"r{i}", prompt=rng.integers(5, CFG.vocab_size, 6),
        max_new_tokens=12)) for i in range(3)]
    ctl = fleet.spec_controllers["edge"]
    for _ in range(60):
        fleet.step()
        if ctl._spec and all(st.committed >= 4
                             for st in ctl._spec.values()):
            break
    committed = {rid: list(st.req.output[:st.committed])
                 for rid, st in ctl._spec.items()}
    assert len(committed) == 3
    assert all(len(c) >= 4 for c in committed.values())
    assert set(ctl._shadow) == set(committed)   # every round checkpointed

    fleet.fail("edge")
    while not all(t.done for t in tickets):
        fleet.step()
    for t in tickets:
        out = t.output
        assert len(out) == 12
        # progress survived: the committed prefix is the resume point
        assert out[:len(committed[t.rid])] == committed[t.rid], t.rid
    # covered failovers are exact (v1 inject) resumes, not re-prefills
    recs = [m for m in fleet.telemetry.migrations
            if m.reason == "failover"]
    assert {m.rid for m in recs} == set(committed)
    assert all(not m.lossy for m in recs)


def test_verify_engine_failure_degrades_to_local():
    """Losing the verify tier mid-flight drops uncommitted drafts and
    finishes the requests local-only -- still greedy-exact."""
    fleet = mk_spec_fleet(gamma=4)
    reqs = mk_requests(2, max_new=12)
    for r in reqs:
        assert fleet.submit(r)
    for _ in range(3):
        fleet.step()
    fleet.fail("cloud")
    assert not fleet.spec_controllers      # pair dissolved
    assert fleet.handles["edge"].spec_role is None
    outs = fleet.run()
    for r in reqs:
        assert outs[r.rid] == reference_output(r.prompt, 12,
                                               max_len=EDGE_LEN), r.rid


def test_wide_verify_mode_mechanics():
    """The one-wide-pass verify path: same protocol mechanics (full
    completion, rejections on a hot drafter).  Bit-equality with a pure
    decode run is NOT asserted -- the wide program's numerics may differ
    on knife-edge logits (see fleet.speculative docstring)."""
    fleet = mk_spec_fleet(gamma=4, verify_mode="wide",
                          drafter_temperature=1.2, drafter_top_k=8)
    reqs = mk_requests(2, max_new=8)
    outs = fleet.run(reqs)
    st = fleet.spec_controllers["edge"].stats
    assert all(len(outs[r.rid]) == 8 for r in reqs)
    assert st.corrections > 0
    assert st.rounds > 0 and st.proposed >= st.accepted


# -- engine-level verify/rollback units --------------------------------------

def test_verify_slots_stepwise_teacher_forcing_roundtrip():
    """Engine-level: stepwise verification accepts exactly the pure-run
    prefix and splices the pure-run correction."""
    cloud = mk_engine(seed=3, max_len=EDGE_LEN)
    req = Request("r", np.arange(6), max_new_tokens=12)
    cloud.add_request(req)
    ref = reference_output(np.arange(6), 12, max_len=EDGE_LEN)
    # propose the true continuation with one token vandalised
    tail = list(ref[:4])
    tail[2] = (tail[2] + 1) % CFG.vocab_size
    n, tok = cloud.verify_slots_stepwise({req.slot: tail})[req.slot]
    assert n == 2
    assert tok == ref[2]                  # the correction is the truth
    # the slot continues bit-exactly after the bounce
    req.output[:] = ref[:3]
    while not req.done:
        cloud.step()
    assert req.output == ref


def test_rollback_slot_rewinds_draft_tail():
    edge = mk_engine(seed=5)
    twin = mk_engine(seed=5)
    req = Request("r", np.arange(4), max_new_tokens=10)
    twin_req = Request("r", np.arange(4), max_new_tokens=10)
    edge.add_request(req)
    twin.add_request(twin_req)
    for _ in range(2):
        edge.step(auto_retire=False)
        twin.step(auto_retire=False)
    # edge drafts 3 junk-policy tokens, then rewinds keeping none and
    # splicing the twin's (true greedy) next token
    edge.state.temperature[req.slot] = 1.5     # the state is in place
    edge.state.top_k[req.slot] = 4
    for _ in range(3):
        edge.step(auto_retire=False)
    truth = twin.step(auto_retire=False)["r"]
    edge.rollback_slot(req.slot, 3, 0, truth)
    edge.state.temperature[req.slot] = 0.0
    edge.state.top_k[req.slot] = 0
    req.output[:] = req.output[:2] + [truth]
    while not req.done:
        edge.step()
        if len(req.output) >= 10:
            req.done = True
    while not twin_req.done:
        twin.step()
        if len(twin_req.output) >= 10:
            twin_req.done = True
    assert req.output == twin_req.output


# -- repack_slot (heterogeneous max_len re-layout) ---------------------------

def test_repack_slot_grow_then_shrink_roundtrips_bit_exactly():
    src = mk_engine(seed=9)
    src.add_request(Request("r", np.arange(5), max_new_tokens=20))
    for _ in range(3):
        src.step()
    snap = src.extract_slot(0, keep=True)
    grown = repack_slot(snap, CLOUD_LEN)
    assert grown.arrays.tokens.shape[-1] == CLOUD_LEN
    back = repack_slot(grown, EDGE_LEN)
    assert pack_slot(back) == pack_slot(snap)      # wire-level identical


def test_repack_slot_grow_preserves_position_and_rng():
    src = mk_engine(seed=9)
    src.add_request(Request("r", np.arange(5), max_new_tokens=20,
                            temperature=0.7, top_k=4))
    src.step()
    snap = src.extract_slot(0, keep=True)
    grown = repack_slot(snap, CLOUD_LEN)
    assert int(grown.arrays.position) == int(snap.arrays.position)
    assert torch.equal(grown.arrays.rng, snap.arrays.rng)
    assert float(grown.arrays.temperature) == float(np.float32(0.7))
    # appended rows are empty: sentinel -1 abs_pos, zero tokens
    for path, leaf in leaves_with_path(grown.arrays.caches):
        if path.endswith("['abs_pos']"):
            assert (np.asarray(leaf)[..., EDGE_LEN:] == -1).all()
    assert (np.asarray(grown.arrays.tokens)[EDGE_LEN:] == 0).all()


def test_repack_slot_shrink_rejects_tail_truncation_loudly():
    src = mk_engine(seed=9, max_len=CLOUD_LEN)
    src.add_request(Request("r", np.arange(40), max_new_tokens=80))
    src.step()
    snap = src.extract_slot(0, keep=True)
    with pytest.raises(ValueError, match="tail truncation"):
        repack_slot(snap, EDGE_LEN)     # 40 + 80 live rows > 64


def test_heterogeneous_drain_migrates_and_finishes():
    """The fleet-level form of the lifted limitation: draining a
    max_len-64 engine live-migrates its slots into a max_len-160 peer
    (grow), while a too-small peer is skipped instead of truncating."""
    handles = [
        EngineHandle("a", mk_engine(seed=0, max_len=EDGE_LEN), EDGE),
        EngineHandle("b", mk_engine(seed=1, max_len=CLOUD_LEN), CLOUD),
    ]
    fleet = FleetController(handles, authority=TrustAuthority())
    reqs = mk_requests(2, max_new=12)
    for r in reqs:
        fleet.submit(r)
    for _ in range(3):
        fleet.step()
    loaded = max(fleet.handles,
                 key=lambda n: len(fleet.handles[n].engine.requests))
    n_inflight = len(fleet.handles[loaded].engine.requests)
    assert fleet.drain(loaded) == n_inflight
    outs = fleet.run()
    assert len(outs) == 2 and all(len(v) == 12 for v in outs.values())
    assert all(m.reason == "drain" for m in fleet.telemetry.migrations)


def test_drain_skips_target_too_small_for_slot():
    handles = [
        EngineHandle("big", mk_engine(seed=0, max_len=CLOUD_LEN), EDGE),
        EngineHandle("small", mk_engine(seed=1, max_len=32), CLOUD),
    ]
    fleet = FleetController(handles, authority=TrustAuthority())
    # needs 40 + 80 = 120 rows: can never fit the 32-row engine
    fleet.submit(Request("r", np.arange(40), max_new_tokens=80))
    fleet.step()
    assert fleet.placement_of("r") == "big"
    assert fleet.drain("big") == 0          # skipped, not truncated
    assert "r" in {q.rid for q in fleet.handles["big"].engine.requests.values()}


# -- telemetry percentile satellite ------------------------------------------

def test_percentile_nearest_rank_known_distribution():
    xs = [float(x) for x in range(1, 21)]       # 1..20
    np.random.default_rng(0).shuffle(xs)        # order must not matter
    assert percentile(xs, 50) == 10.0
    assert percentile(xs, 95) == 19.0           # NOT the max (rank 19)
    assert percentile(xs, 99) == 20.0
    assert percentile(xs, 100) == 20.0
    assert percentile(xs, 0) == 1.0
    big = [float(x) for x in range(1, 1001)]
    assert percentile(big, 99.9) == 999.0       # float-dust off-by-one
    assert percentile(big, 95) == 950.0
    assert percentile([], 50) == 0.0            # empty window
    assert percentile([3.0], 99) == 3.0


# -- the same stream through both packages -----------------------------------

def _speculative_stream(S, verify_mode):
    """Greedy requests over an edge->cloud pair on a SimClock (three
    slots each, max_len 64 -> 160), one sampled request on the side,
    and a mid-run failure of the draft engine with a spare engine to
    take its shadows.  Conservation holds after every step."""
    clk = S.SimClock()
    handles = [
        S.EngineHandle("edge", S.engine(seed=0, slots=3, max_len=64),
                       S.EDGE),
        S.EngineHandle("cloud", S.engine(seed=1, slots=3, max_len=160),
                       S.CLOUD),
        S.EngineHandle("spare", S.engine(seed=2, slots=3, max_len=64),
                       S.EDGE),
    ]
    fleet = S.FleetController(handles, authority=S.TrustAuthority(),
                              clock=clk, spec_tiers={"edge": "cloud"},
                              spec_options={"gamma": 3,
                                            "verify_mode": verify_mode})
    check = assert_conserved if S.side == "torch" else \
        helpers.assert_conserved
    rng = np.random.default_rng(7)
    for i in range(4):
        fleet.submit(S.RequestSpec(
            rid=f"r{i}", prompt=rng.integers(5, S.cfg.vocab_size, 6),
            max_new_tokens=10, temperature=0.8 if i == 3 else 0.0,
            top_k=8 if i == 3 else 0))
    for step in range(100):
        if step == 5:
            fleet.fail("edge")
        fleet.step()
        clk.advance(0.01)
        check(fleet)
        if all(t.done for t in fleet.tickets.values()):
            break
    rec = fleet_record(fleet)
    stats = [c.stats.summary() for c in fleet.spec_controllers.values()]
    return rec, stats


@pytest.mark.parametrize("verify_mode", ["stepwise", "distribution"])
def test_speculative_stream_matches_jax(verify_mode):
    (jrec, jst), (trec, tst) = (_speculative_stream(
        fleet_side(side, "float32"), verify_mode)
        for side in ("jax", "torch"))
    for rec in (jrec, trec):
        # the sampled request draws on each package's own RNG: its tokens
        # (and, where it speculates, its verdicts) match in distribution
        rec["outputs"].pop("r3")
        if verify_mode == "distribution":
            rec["counters"]["engines"] = None
            rec["counters"]["fleet"]["tokens"] = None
            rec["spans"] = [s for s in rec["spans"] if s[0] != "r3"]
    for key in jrec:
        assert trec[key] == jrec[key], key
    assert jst == tst
    assert all(s[-1] == "done" for s in trec["states"].values())
    assert any(m[4] == "speculative" for m in trec["migrations"])
    assert any("drafting" in s for s in trec["states"].values())
