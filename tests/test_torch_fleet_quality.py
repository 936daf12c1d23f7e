"""The port's quality tiers on the CPU: counterparts of the tests of
``tests/test_fleet_quality.py`` that do not need the autoscaler (tier
routing, hard floors and degradation causes, the monotone-degradation
property, audited downshifts, lossy cross-tier hand-offs, the upshift,
distribution-level speculation across distinct weights, preemption of a
drafting request, and the replication manager's merge and pick_tier
rules), on tiny llama-1.5b with the JAX package's seed-0 weights
bridged; the ``lite`` tier is their int8 round trip by the port's own
``optim.compression`` (bit-equal to the JAX one).
The parity tests run one tiered stream, and one distribution-verify
pair, through both packages."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get  # noqa: E402
from repro_torch.configs.tiny import make_tiny  # noqa: E402
from repro_torch.core.attestation import TrustAuthority  # noqa: E402
from repro_torch.core.channel import NetworkCondition, SimClock  # noqa: E402
from repro_torch.core.daemon import CLOUD, EDGE, DeviceProfile  # noqa: E402
from repro_torch.core.replication import (ReplicaTier,  # noqa: E402
                                          ReplicationManager)
from repro_torch.core.workspace import AgentWorkspace, VectorClock  # noqa: E402
from repro_torch.fleet import (EngineHandle, FleetController,  # noqa: E402
                               QualityTier, RequestSpec, RequestState,
                               Router)
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from tests import helpers  # noqa: E402
from tests.torch_helpers import (assert_conserved, fleet_record,  # noqa: E402
                                 fleet_side, fleet_weights)

CFG = make_tiny(get("llama-1.5b"))

FULL = QualityTier("full", 1.0, "bf16")
LITE = QualityTier("lite", 0.6, "int8")
MINI = QualityTier("mini", 0.3, "small")


def mk_engine(tier=FULL, seed=0, slots=1, max_len=64):
    cfg, params = fleet_weights()["torch"][tier.name]
    return Engine(cfg, params, slots=slots, max_len=max_len, seed=seed,
                  device="cpu")


def mk_tier_fleet(full_slots=1, lite_slots=2, **kw):
    """A scarce full-bf16 tier next to a roomier int8 tier."""
    handles = [
        EngineHandle("big", mk_engine(FULL, seed=0, slots=full_slots),
                     CLOUD, tier=FULL),
        EngineHandle("small", mk_engine(LITE, seed=1, slots=lite_slots),
                     EDGE, tier=LITE),
    ]
    return FleetController(handles, authority=TrustAuthority(), **kw)


def mk_spec(rid, *, max_new=8, floor=0.0, prompt_len=6, seed=7, **kw):
    rng = np.random.default_rng(seed + sum(map(ord, rid)))
    return RequestSpec(rid=rid,
                       prompt=rng.integers(5, CFG.vocab_size, prompt_len),
                       max_new_tokens=max_new, quality_floor=floor, **kw)


# -- router: tier preference, floors, degradation causes ---------------------

class FakeEngine:
    """Metadata-only engine for pure-router tests (no model compute)."""

    def __init__(self, *, cfg=CFG, slots=2, max_len=4096, busy=0):
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.requests = {i: object() for i in range(busy)}

    @property
    def free_slots(self):
        return list(range(len(self.requests), self.slots))

    # the token-budget capacity surface every engine speaks (dense form)
    def can_admit(self, need_tokens):
        return bool(self.free_slots) and need_tokens <= self.max_len

    def admissible(self, need_tokens):
        return need_tokens <= self.max_len

    @property
    def free_token_budget(self):
        return len(self.free_slots) * self.max_len


def fake_handle(name, tier, *, profile=None, cond=None, busy=0, slots=2):
    return EngineHandle(name, FakeEngine(busy=busy, slots=slots),
                        profile or EDGE, tier=tier, cond=cond)


ROUTE_KW = dict(sensitivity="public", prefill_tokens=6, decode_tokens=16)


def test_router_prefers_highest_acceptable_tier():
    router = Router()
    dec = router.route([fake_handle("lo", LITE), fake_handle("hi", FULL)],
                       CFG, **ROUTE_KW)
    assert dec.target == "hi" and dec.tier == "full"
    assert not dec.degraded and dec.preferred == "full"
    # saturate the full tier: downshift with an audited cause
    dec = router.route([fake_handle("lo", LITE),
                        fake_handle("hi", FULL, slots=2, busy=2)],
                       CFG, **ROUTE_KW)
    assert dec.target == "lo" and dec.degraded and dec.cause == "saturated"
    assert dec.quality == LITE.quality and dec.preferred == "full"


def test_router_quality_floor_is_hard():
    router = Router()
    handles = [fake_handle("lo", LITE),
               fake_handle("hi", FULL, slots=2, busy=2)]
    # floor above the only tier with capacity: refuse, do not degrade
    dec = router.route(handles, CFG, quality_floor=0.9, **ROUTE_KW)
    assert dec.target is None
    assert dec.saturated           # preemption may fix this, policy can't
    # floor above every tier in the fleet: a different refusal (final)
    dec = router.route(handles, CFG, quality_floor=1.5, **ROUTE_KW)
    assert dec.target is None and not dec.saturated and dec.cause == "floor"


def test_router_link_down_degrades_with_link_cause():
    router = Router()
    handles = [fake_handle("lo", LITE),
               fake_handle("hi", FULL,
                           cond=NetworkCondition(up=False))]
    dec = router.route(handles, CFG, **ROUTE_KW)
    assert dec.target == "lo" and dec.degraded and dec.cause == "link"
    # floored request refuses to follow the downshift
    dec = router.route(handles, CFG, quality_floor=0.9, **ROUTE_KW)
    assert dec.target is None
    # starved (not dead) link with a bandwidth floor armed: same story
    router2 = Router(bandwidth_floor=1e6)
    handles2 = [fake_handle("lo", LITE),
                fake_handle("hi", FULL,
                            cond=NetworkCondition(bandwidth_bps=1e5))]
    dec = router2.route(handles2, CFG, **ROUTE_KW)
    assert dec.target == "lo" and dec.degraded and dec.cause == "link"


def test_router_deadline_pressure_downshifts():
    """A slow full tier that would miss the deadline loses to a fast
    lite tier that makes it (deterministic roofline numbers)."""
    slow = DeviceProfile("slow", peak_flops=1e12, hbm_bw=1e9)
    fast = DeviceProfile("fast", peak_flops=100e12, hbm_bw=800e9)
    router = Router()
    handles = [fake_handle("hi", FULL, profile=slow),
               fake_handle("lo", LITE, profile=fast)]
    t_hi = router.score(handles[0], CFG, prefill_tokens=6,
                        decode_tokens=16, loaded=False)
    t_lo = router.score(handles[1], CFG, prefill_tokens=6,
                        decode_tokens=16, loaded=False)
    assert t_lo < t_hi
    slack = (t_lo + t_hi) / 2
    dec = router.route(handles, CFG, deadline_slack=slack, **ROUTE_KW)
    assert dec.target == "lo" and dec.degraded and dec.cause == "deadline"
    # plenty of slack: quality wins again
    dec = router.route(handles, CFG, deadline_slack=t_hi * 10, **ROUTE_KW)
    assert dec.target == "hi" and not dec.degraded
    # nothing makes it: least-bad raw-fastest, still never above floor
    dec = router.route(handles, CFG, deadline_slack=t_lo / 1e6,
                       quality_floor=0.9, **ROUTE_KW)
    assert dec.target == "hi"      # the only floor-acceptable engine


def test_degradation_monotone_property():
    """Hand-rolled property harness (the hypothesis wheel is absent
    locally): across random tiered fleets, as deadline slack decreases
    the selected tier quality never increases; as the top tier's link
    bandwidth decreases the same holds; and no route ever lands below
    the request's quality floor."""
    rng = np.random.default_rng(0)
    profiles = {}

    def profile_for(quality):
        # realistic regime: cheaper tiers are faster (smaller model /
        # lighter kernels); quality anti-correlates with speed
        if quality not in profiles:
            profiles[quality] = DeviceProfile(
                f"p{quality:.3f}", peak_flops=25e12 / quality,
                hbm_bw=float(50e9 / quality))
        return profiles[quality]

    for trial in range(150):
        n_tiers = int(rng.integers(2, 5))
        qualities = sorted(set(np.round(rng.uniform(0.1, 1.0, n_tiers),
                                        3)), reverse=True)
        handles = []
        for qi, q in enumerate(qualities):
            tier = QualityTier(f"t{qi}", float(q))
            for hi in range(int(rng.integers(1, 3))):
                handles.append(fake_handle(
                    f"e{qi}-{hi}", tier, profile=profile_for(float(q)),
                    busy=int(rng.integers(0, 2)), slots=2))
        floor = float(rng.choice([0.0, 0.0, qualities[-1],
                                  float(np.median(qualities))]))
        router = Router(bandwidth_floor=1e6)
        times = [router.score(h, CFG, prefill_tokens=4, decode_tokens=8,
                              loaded=False) for h in handles]
        slacks = sorted(rng.uniform(min(times) / 10, max(times) * 10,
                                    6), reverse=True)

        # (a) monotone in deadline slack
        picked = []
        for slack in [None] + list(slacks):
            dec = router.route(handles, CFG, sensitivity="public",
                               prefill_tokens=4, decode_tokens=8,
                               deadline_slack=slack, quality_floor=floor)
            if dec.target is None:
                picked.append(None)
                continue
            assert dec.quality >= floor - 1e-9, \
                (trial, "route below quality floor")
            picked.append(dec.quality)
        qs = [q for q in picked[1:] if q is not None]
        assert all(a >= b - 1e-9 for a, b in zip(qs, qs[1:])), \
            (trial, "quality increased as slack decreased", picked)

        # (b) monotone in the top tier's available bandwidth
        top = [h for h in handles
               if h.tier.quality == max(x.tier.quality for x in handles)]
        picked_bw = []
        for bw in [1e9, 5e6, 5e5, 1e4]:     # decreasing; floor at 1e6
            for h in top:
                h.cond = NetworkCondition(bandwidth_bps=bw,
                                          up=bw > 1e4)
            dec = router.route(handles, CFG, sensitivity="public",
                               prefill_tokens=4, decode_tokens=8,
                               quality_floor=floor)
            if dec.target is not None:
                assert dec.quality >= floor - 1e-9, \
                    (trial, "route below quality floor (bw sweep)")
            picked_bw.append(None if dec.target is None else dec.quality)
        qs = [q for q in picked_bw if q is not None]
        assert all(a >= b - 1e-9 for a, b in zip(qs, qs[1:])), \
            (trial, "quality increased as bandwidth decreased", picked_bw)
        for h in top:
            h.cond = None


# -- fleet-level degradation with audited QualityEvents ----------------------

def test_saturated_tier_downshifts_and_audits():
    fleet = mk_tier_fleet()
    ts = [fleet.submit(mk_spec(f"r{i}")) for i in range(3)]
    while not all(t.done for t in ts):
        fleet.step()
    tiers = {t.rid: fleet.handles[fleet.placements[t.rid][-1]].tier.name
             for t in ts}
    assert tiers["r0"] == "full"               # first take the best tier
    assert tiers["r1"] == "lite" and tiers["r2"] == "lite"
    evs = fleet.telemetry.quality_events()
    assert {ev.rid for ev in evs} == {"r1", "r2"}
    for ev in evs:
        assert ev.direction == "down"
        assert (ev.src_tier, ev.dst_tier) == ("full", "lite")
        assert ev.reason == "saturated"
    assert fleet.telemetry.downshifts == 2
    # no request lost, none served below its (zero) floor
    assert all(t.state is RequestState.DONE for t in ts)


def test_quality_floor_waits_instead_of_degrading():
    fleet = mk_tier_fleet()
    long = fleet.submit(mk_spec("long", max_new=12))
    fleet.step()
    assert fleet.placement_of("long") == "big"
    strict = fleet.submit(mk_spec("strict", max_new=4, floor=0.9))
    flex = fleet.submit(mk_spec("flex", max_new=4))
    fleet.step()
    # the flexible request degrades; the floored one queues for the
    # full tier rather than violating its contract
    assert fleet.placement_of("flex") == "small"
    assert fleet.placement_of("strict") is None
    while not strict.done:
        fleet.step()
    assert fleet.placements["strict"] == ["big"]
    assert all(ev.rid != "strict"
               for ev in fleet.telemetry.quality_events())


def test_link_failure_degrades_service_stays_up():
    """The availability headline: the full tier's client link dies and
    requests keep completing on the lite tier, each downshift audited;
    nothing is lost, nothing lands below its floor."""
    fleet = mk_tier_fleet(full_slots=2, lite_slots=2)
    fleet.set_link("big", NetworkCondition(up=False))
    ts = [fleet.submit(mk_spec(f"c{i}")) for i in range(3)]
    while not all(t.done for t in ts):
        fleet.step()
    for t in ts:
        assert fleet.placements[t.rid] == ["small"], t.rid
        assert t.state is RequestState.DONE
    evs = fleet.telemetry.quality_events()
    assert len(evs) == 3 and all(ev.reason == "link" for ev in evs)


# -- lossy cross-tier hand-off (re-prefill of the committed stream) ----------

def test_cross_tier_drain_reprefills_committed_stream():
    fleet = mk_tier_fleet()
    t = fleet.submit(mk_spec("r", max_new=12))
    for _ in range(4):
        fleet.step()
    committed = list(t.output)
    assert fleet.placement_of("r") == "big" and len(committed) >= 3
    assert fleet.drain("big") == 1
    out = t.result()
    # token history preserved exactly; continuation is the new tier's
    assert out[:len(committed)] == committed
    assert len(out) == 12
    assert fleet.placements["r"] == ["big", "small"]
    recs = fleet.telemetry.migrations
    assert len(recs) == 1 and recs[0].lossy and recs[0].reason == "drain"
    evs = fleet.telemetry.quality_events()
    assert len(evs) == 1 and evs[0].direction == "down"
    assert evs[0].rid == "r" and evs[0].dst_tier == "lite"


def test_cross_tier_failover_preserves_committed_stream():
    """Only a lower tier survives an engine failure: the request
    resumes there from its shadow's committed tokens -- degraded, not
    dropped."""
    fleet = mk_tier_fleet()
    t = fleet.submit(mk_spec("r", max_new=14))
    for _ in range(5):
        fleet.step()
    committed = list(t.output)
    assert fleet.placement_of("r") == "big" and committed
    fleet.fail("big")
    out = t.result()
    assert out[:len(committed)] == committed
    assert len(out) == 14
    assert fleet.placements["r"] == ["big", "small"]
    assert any(m.lossy and m.reason == "failover"
               for m in fleet.telemetry.migrations)
    assert fleet.telemetry.downshifts == 1


def test_upshift_returns_degraded_request_to_better_tier():
    fleet = mk_tier_fleet(rebalance_every=1)
    blocker = fleet.submit(mk_spec("blocker", max_new=4))
    fleet.step()
    degraded = fleet.submit(mk_spec("degraded", max_new=24))
    fleet.step()
    assert fleet.placement_of("degraded") == "small"
    assert fleet.telemetry.downshifts == 1
    out = degraded.result()
    assert len(out) == 24
    # once the full tier freed, the degraded request moved back up
    assert fleet.placements["degraded"][-1] == "big"
    ups = [ev for ev in fleet.telemetry.quality_events()
           if ev.direction == "up"]
    assert len(ups) == 1 and ups[0].rid == "degraded"
    assert blocker.result() == blocker.output   # blocker unharmed


def test_cross_tier_parked_preemption_resumes_lossily():
    """A preempted slot parked from the full tier re-places onto the
    lite tier when the full tier stays contended: the parked blob's
    committed output survives the tier change."""
    fleet = mk_tier_fleet(full_slots=1, lite_slots=1)
    low = fleet.submit(mk_spec("low", max_new=16, priority=0))
    filler = fleet.submit(mk_spec("filler", max_new=30, priority=0))
    fleet.step()
    assert {fleet.placement_of("low"),
            fleet.placement_of("filler")} == {"big", "small"}
    high = fleet.submit(mk_spec("high", max_new=24, priority=10))
    fleet.step()
    assert fleet.telemetry.preemptions == 1
    out = low.result()
    assert len(out) == 16 and low.state is RequestState.DONE


# -- distribution-level speculative acceptance -------------------------------

def mk_distribution_pair(draft_tier=LITE, verify_len=64, **spec_options):
    handles = [
        EngineHandle("edge", mk_engine(draft_tier, seed=0, slots=1),
                     EDGE, tier=draft_tier),
        EngineHandle("cloud",
                     mk_engine(FULL, seed=1, slots=1, max_len=verify_len),
                     CLOUD, tier=FULL),
    ]
    return FleetController(handles, authority=TrustAuthority(),
                           spec_tiers={"edge": "cloud"},
                           spec_options={"verify_mode": "distribution",
                                         **spec_options})


def probs_reference(prompt, max_new, *, max_len=64, seed=1234):
    """Solo run of the verify tier through its probs program (the
    compiled geometry + program distribution scoring uses): the oracle
    for greedy distribution-mode acceptance."""
    eng = mk_engine(FULL, seed=seed, slots=1, max_len=max_len)
    req = Request("ref", np.asarray(prompt), max_new_tokens=max_new)
    eng.add_request(req)
    while not req.done:
        eng.step_probs()
    return req.output


def test_distribution_same_weights_fully_accepts():
    fleet = mk_distribution_pair(draft_tier=FULL, gamma=3)
    req = Request("s", np.arange(6), max_new_tokens=9)
    outs = fleet.run([req])
    st = fleet.spec_controllers["edge"].stats
    assert st.requests == 1 and st.local_fallbacks == 0
    assert st.acceptance_rate == 1.0 and st.corrections == 0
    assert outs["s"] == probs_reference(np.arange(6), 9)


def test_distribution_distinct_weights_commits_target_stream():
    """The tentpole acceptance contract: an int8 draft tier proposes,
    the bf16 verify tier accepts/rejects at distribution level, and the
    committed greedy stream is exactly the verify tier's own (one-hot
    acceptance == argmax agreement; resamples == target argmax).  The
    hand-off is the lossy re-prefill kind -- draft cache rows never
    touch the verify engine."""
    fleet = mk_distribution_pair(gamma=3, verify_len=96)
    req = Request("s", np.arange(6), max_new_tokens=10)
    outs = fleet.run([req])
    st = fleet.spec_controllers["edge"].stats
    assert st.requests == 1 and st.handoffs == 1
    assert 0.0 < st.acceptance_rate < 1.0     # distinct weights disagree
    assert st.corrections > 0                 # ...and get corrected
    assert outs["s"] == probs_reference(np.arange(6), 10, max_len=96)
    # the hand-off shipped a request, not a cache blob
    handoff = [m for m in fleet.telemetry.migrations
               if m.reason == "speculative"]
    assert len(handoff) == 1 and handoff[0].lossy
    assert handoff[0].wire_bytes < 1000


def test_distribution_q_rows_ride_the_wire():
    """The drafter's proposal distributions travel with the token ids:
    round messages dominate the wire (the honest bandwidth price of
    distribution-level acceptance)."""
    fleet = mk_distribution_pair(gamma=3)
    fleet.run([Request("s", np.arange(6), max_new_tokens=6)])
    st = fleet.spec_controllers["edge"].stats
    per_round = st.round_msg_bytes / max(st.rounds, 1)
    # >= gamma float32 rows of padded_vocab each, plus verdicts
    assert per_round > CFG.padded_vocab * 4


def test_distribution_mode_serves_non_greedy_requests():
    """Token-equality modes refuse non-greedy requests (local
    fallback); the distribution rule is temperature-correct and lets
    them speculate."""
    fleet = mk_distribution_pair(gamma=3)
    hot = Request("hot", np.arange(5), max_new_tokens=8,
                  temperature=0.8, top_k=16)
    outs = fleet.run([hot])
    st = fleet.spec_controllers["edge"].stats
    assert st.local_fallbacks == 0 and st.requests == 1
    assert len(outs["hot"]) == 8


# -- preemption of speculative slots (the ROADMAP lifecycle gap) -------------

def test_preempted_drafting_request_resumes_with_committed_only():
    """A drafting victim is parked mid-round: the uncommitted draft
    tail is rolled back before packing (the parked snapshot holds ONLY
    committed tokens), the verify-tier replica slot dissolves, and the
    victim later resumes and completes.  Deterministic on a SimClock."""
    clk = SimClock()
    handles = [
        EngineHandle("edge", mk_engine(FULL, seed=0, slots=1), EDGE),
        EngineHandle("cloud",
                     mk_engine(FULL, seed=1, slots=1, max_len=96), CLOUD),
    ]
    fleet = FleetController(handles, authority=TrustAuthority(),
                            spec_tiers={"edge": "cloud"},
                            spec_options={"gamma": 4}, clock=clk)
    low = fleet.submit(mk_spec("low", max_new=12, priority=0))
    for _ in range(3):
        fleet.step()                  # drafting: 3 uncommitted tokens
    assert low.state is RequestState.DRAFTING
    spec = fleet.spec_controllers["edge"]
    assert len(spec._spec["low"].req.output) == 3   # pending tail
    assert low.output == []                          # nothing committed

    high = fleet.submit(mk_spec("high", max_new=8, priority=10))
    fleet.step()
    assert fleet.telemetry.preemptions == 1
    assert low.state is RequestState.MIGRATING
    # the parked snapshot carries only the committed stream (empty):
    # the uncommitted speculative tail died with the rollback
    from repro_torch.fleet import peek_slot_meta
    (item,) = fleet.queue.parked()
    assert peek_slot_meta(item.blob)["output"] == []
    # the pair's replica slot was dissolved, freeing the verify engine
    # for the preemptor (which attached speculatively in the same step)
    assert "low" not in spec._spec
    assert high.state is RequestState.DRAFTING

    assert len(high.result()) == 8
    out = low.result()
    assert len(out) == 12 and low.state is RequestState.DONE
    assert "migrating" in [ev.dst for ev in low.events]


# -- replication-layer bugfixes ----------------------------------------------

def _mgr(primary="cloud", conds=None, names=("cloud", "edge")):
    qualities = {"cloud": 1.0, "edge": 0.8, "device": 0.5}
    tiers = []
    for n in names:
        cond = (conds or {}).get(n, NetworkCondition())
        tiers.append(ReplicaTier(n, None, qualities.get(n, 0.7), 1.0,
                                 cond=cond))
    return ReplicationManager(tiers, primary=primary)


def _ws(rids_outputs, clocks):
    return AgentWorkspace(None, [{"rid": r, "output": o}
                                 for r, o in rids_outputs],
                          CFG.name, "gid", vclock=VectorClock(clocks))


def test_merge_on_reconnect_prefers_higher_quality_both_directions():
    """The old code unconditionally crowned the remote side in the
    concurrent case; the contract is 'keep the higher-quality side'.
    Both directions regress-tested, with the loser's unique requests
    unioned in either way."""
    mgr = _mgr()
    local = _ws([("x", [1]), ("only-local", [7])], {"edge": 3})
    remote = _ws([("x", [2]), ("only-remote", [9])],
                 {"edge": 1, "cloud": 4})
    # remote ran on the better (cloud) tier: remote's x wins
    m = mgr.merge_on_reconnect(local, remote, local_tier="edge",
                               remote_tier="cloud")
    assert {r["rid"]: r["output"] for r in m.requests} == \
        {"x": [2], "only-remote": [9], "only-local": [7]}
    assert m.vclock.clocks == {"edge": 3, "cloud": 4}
    # the LOCAL side on the better tier: local's x must win now (the
    # direction the old code got wrong)
    m = mgr.merge_on_reconnect(local, remote, local_tier="cloud",
                               remote_tier="edge")
    assert {r["rid"]: r["output"] for r in m.requests} == \
        {"x": [1], "only-local": [7], "only-remote": [9]}
    # dominance still fast-forwards regardless of tiers
    dominated = _ws([("x", [1])], {"edge": 1})
    dominant = _ws([("x", [2])], {"edge": 2})
    m = mgr.merge_on_reconnect(dominated, dominant, local_tier="cloud",
                               remote_tier="edge")
    assert {r["rid"]: r["output"] for r in m.requests} == {"x": [2]}


def test_merge_on_reconnect_never_mutates_inputs():
    """The old code appended the union into the winner's own request
    list (corrupting the caller's workspace) and overwrote its vclock.
    The merge must return a fresh workspace."""
    mgr = _mgr()
    local = _ws([("l", [1])], {"edge": 3})
    remote = _ws([("r", [2])], {"cloud": 4})
    m = mgr.merge_on_reconnect(local, remote, local_tier="edge",
                               remote_tier="cloud")
    assert m is not local and m is not remote
    assert [r["rid"] for r in local.requests] == ["l"]
    assert [r["rid"] for r in remote.requests] == ["r"]
    assert local.vclock.clocks == {"edge": 3}
    assert remote.vclock.clocks == {"cloud": 4}
    assert {r["rid"] for r in m.requests} == {"l", "r"}
    # and the merged request dicts are copies, not aliases
    m.requests[0]["output"].append(99)
    assert local.requests[0]["output"] == [1]
    assert remote.requests[0]["output"] == [2]


def test_pick_tier_cloud_only_manager_survives_total_disconnection():
    """The old fallback was ``self.tiers["device"]`` -- a KeyError for
    any fleet without a tier literally named "device".  Total
    disconnection must degrade to the lowest-quality (or configured
    local) tier instead."""
    down = {"cloud": NetworkCondition(up=False),
            "edge": NetworkCondition(up=False)}
    mgr = _mgr(conds=down, names=("cloud", "edge"))
    tier = mgr.pick_tier()            # must not raise
    assert tier.name == "edge"        # lowest quality of what exists
    # a configured local tier takes precedence over lowest-quality
    tiers = [ReplicaTier("cloud", None, 1.0, 1.0,
                         cond=NetworkCondition(up=False)),
             ReplicaTier("edge", None, 0.8, 1.0,
                         cond=NetworkCondition(up=False))]
    mgr2 = ReplicationManager(tiers, primary="cloud", local_tier="cloud")
    assert mgr2.pick_tier().name == "cloud"
    # the classic 3-tier fleet still lands on-device
    mgr3 = _mgr(conds={n: NetworkCondition(up=False)
                       for n in ("cloud", "edge", "device")},
                names=("cloud", "edge", "device"))
    assert mgr3.pick_tier().name == "device"


def test_pick_tier_rejects_unknown_local_tier():
    with pytest.raises(AssertionError):
        ReplicationManager([ReplicaTier("cloud", None, 1.0, 1.0)],
                           local_tier="nope")


# -- the same stream through both packages -----------------------------------

def _check(S, fleet):
    (assert_conserved if S.side == "torch" else helpers.assert_conserved)(
        fleet)


def _tiered_stream(S):
    """Two one-slot full-tier engines beside a three-slot lite engine on
    a SimClock: saturation downshifts, a floored request that waits, a
    lossy drain of one full engine, a link outage that degrades a fresh
    request, and a failure of the lite tier whose slots park and move
    back up lossily."""
    clk = S.SimClock()
    handles = [S.EngineHandle("big", S.engine("full", seed=0, slots=1),
                              S.CLOUD, tier=S.FULL),
               S.EngineHandle("big2", S.engine("full", seed=2, slots=1),
                              S.CLOUD, tier=S.FULL),
               S.EngineHandle("small", S.engine("lite", seed=1, slots=3),
                              S.EDGE, tier=S.LITE)]
    fleet = S.FleetController(handles, authority=S.TrustAuthority(),
                              clock=clk)

    def submit(rid, n, floor=0.0):
        p = np.random.default_rng(sum(map(ord, rid))).integers(
            5, S.cfg.vocab_size, 6)
        fleet.submit(S.RequestSpec(rid=rid, prompt=p, max_new_tokens=n,
                                   quality_floor=floor))

    for step in range(200):
        if step == 0:
            for rid, n, floor in (("a", 14, 0.0), ("b", 10, 0.0),
                                  ("c", 6, 0.9), ("d", 10, 0.5)):
                submit(rid, n, floor)
        if step == 3:
            fleet.drain("big")
        if step == 5:
            fleet.set_link("big2", S.NetworkCondition(up=False))
            submit("e", 8, 0.5)
        if step == 8:
            fleet.set_link("big2", None)
            fleet.fail("small")
        fleet.step()
        clk.advance(0.01)
        _check(S, fleet)
        if step > 8 and all(t.done for t in fleet.tickets.values()):
            break
    return fleet_record(fleet)


def test_tier_decisions_and_tokens_match_jax():
    jrec, trec = (_tiered_stream(fleet_side(side, "float32"))
                  for side in ("jax", "torch"))
    for key in jrec:
        assert trec[key] == jrec[key], key
    assert all(s[-1] == "done" for s in trec["states"].values())
    lossy = {m[0] for m in trec["migrations"] if m[3]}
    assert "a" in lossy                       # the drain went down a tier
    evs = [a for a in trec["audit"] if a[0] == "quality"]
    assert {a[2] for a in evs} == {"down", "up"}
    assert trec["placements"]["c"] == ["big2"]   # the floor waited


def _distribution_pair(S, requests):
    handles = [
        S.EngineHandle("edge", S.engine("lite", seed=0, slots=1), S.EDGE,
                       tier=S.LITE),
        S.EngineHandle("cloud", S.engine("full", seed=1, slots=1,
                                         max_len=96), S.CLOUD, tier=S.FULL),
    ]
    fleet = S.FleetController(handles, authority=S.TrustAuthority(),
                              clock=S.SimClock(),
                              spec_tiers={"edge": "cloud"},
                              spec_options={"verify_mode": "distribution",
                                            "gamma": 3})
    fleet.run([S.Request(rid, np.asarray(p), max_new_tokens=n)
               for rid, p, n in requests])
    return fleet, fleet.spec_controllers["edge"].stats.summary()


def test_distribution_pair_commits_the_same_stream_as_jax():
    reqs = [("s", np.arange(6), 10), ("t", np.arange(20, 27), 8)]
    (jf, jst), (tf, tst) = (_distribution_pair(fleet_side(side,
                                                          "float32"), reqs)
                            for side in ("jax", "torch"))
    for key in ("requests", "rounds", "proposed", "accepted",
                "corrections", "handoffs", "handoff_bytes",
                "round_msg_bytes", "local_fallbacks"):
        assert tst[key] == jst[key], key
    assert 0 < tst["accepted"] < tst["proposed"]
    for rid, _, _ in reqs:
        assert tf.done[rid].output == jf.done[rid].output, rid


def _long_request_fleet(S, prompt_len):
    """One full-tier engine holding a request of ``prompt_len`` tokens
    four tokens into its decode, beside a lite engine."""
    handles = [S.EngineHandle("big", S.engine("full", seed=0, slots=1,
                                              max_len=1088),
                              S.CLOUD, tier=S.FULL),
               S.EngineHandle("small", S.engine("lite", seed=1, slots=3,
                                                max_len=1088),
                              S.EDGE, tier=S.LITE)]
    fleet = S.FleetController(handles, authority=S.TrustAuthority(),
                              clock=S.SimClock())
    t = fleet.submit(S.RequestSpec(rid="long", max_new_tokens=12,
                                   prompt=np.arange(prompt_len) % 400 + 5))
    for _ in range(4):
        fleet.step()
    return fleet, t


@pytest.mark.parametrize("event", ["drain", "fail"])
def test_lossy_reprefill_outside_the_prefill_domain(event):
    """A lossy hand-off re-prefills prompt + committed output in one
    prefill: 512 + 4 = 516 tokens lies outside the prefill domain (over
    512, not a multiple of 512).  The JAX package asserts inside the
    prefill after the lite engine took the slot: the drain or failure
    raises, and the ticket stays MIGRATING with a slot held on each
    engine.  The port refuses before anything moves: a drain leaves the
    request decoding on its donor (it finishes there), a failover fails
    its ticket with the reason; conservation holds (ROADMAP Queue 3)."""
    jfleet, jt = _long_request_fleet(fleet_side("jax"), 512)
    with pytest.raises(AssertionError):
        getattr(jfleet, event)("big")
    assert jt.state.value == "migrating"
    assert [r.rid for r in jfleet.handles["small"].engine.requests.values()
            ] == ["long"]

    fleet, t = _long_request_fleet(fleet_side("torch"), 512)
    got = getattr(fleet, event)("big")
    assert_conserved(fleet)
    assert not fleet.handles["small"].engine.requests
    if event == "drain":
        assert got == 0 and t.state is RequestState.DECODING
        assert len(t.result()) == 12 and fleet.placements["long"] == ["big"]
    else:
        assert t.state is RequestState.FAILED
        assert "516" in t.events[-1].reason
        assert "prefill" in t.events[-1].reason
    # inside the domain (200 + 4 tokens) both packages hand off lossily
    for side in ("jax", "torch"):
        f, t2 = _long_request_fleet(fleet_side(side), 200)
        committed = list(t2.output)
        getattr(f, event)("big")
        out = t2.result()
        assert out[:len(committed)] == committed and len(out) == 12
        assert f.placements["long"] == ["big", "small"]
