"""The port's autoscaler on the CPU: counterparts of every test of
``tests/test_fleet_autoscale.py`` (pure policy decisions, scale-up under
a burst, an attested spawn unsticking a confidential backlog, cooldown
and the expiry signal, scale-down of idle and busy spawned engines, the
chaos soaks on dense and paged pools, pre-arm decisions, program sharing
across spawns, the warm-standby pool, floor admission, the cross-tier
borrow refusal, promotion mid-soak), of the three autoscaler tests of
``tests/test_fleet_quality.py`` (the tier the backlog needs) and of
``tests/test_properties.py::test_request_conservation_under_scale_churn``
over the port's ``WorkQueue``, on tiny llama-1.5b with the JAX package's
seed-0 weights bridged.  All engines share one geometry with one slot,
so the solo reference is exact (see the JAX file's header).

Parity: ``ScalePolicy.decide`` gives equal decisions and reasons in both
packages on the same ``ScaleSignals``; one autoscaled stream on a
``SimClock`` gives equal placements, scale events, ticket states and
greedy tokens (f32); the int8 quantizer is bit-equal to the JAX one."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get  # noqa: E402
from repro_torch.configs.tiny import make_tiny  # noqa: E402
from repro_torch.core.attestation import TrustAuthority  # noqa: E402
from repro_torch.core.channel import SimClock  # noqa: E402
from repro_torch.core.daemon import CLOUD, EDGE, MCU  # noqa: E402
from repro_torch.fleet import (Autoscaler, ControlPlane,  # noqa: E402
                               EngineHandle, EngineTemplate,
                               FleetController, QualityTier, RequestSpec,
                               RequestState, ScalePolicy, ScaleSignals,
                               TERMINAL_STATES)
from repro_torch.fleet.lifecycle import WorkItem, WorkQueue  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.paged import PagedEngine  # noqa: E402
from tests.torch_helpers import (assert_conserved, fleet_record,  # noqa: E402
                                 fleet_side, fleet_weights,
                                 jax_int8_round_trip, to_numpy)

CFG = make_tiny(get("llama-1.5b"))
SLOTS = 1          # one live request per batch: the solo oracle is exact
MAX_LEN = 64

FULL = QualityTier("full", 1.0, "bf16")
LITE = QualityTier("lite", 0.6, "int8")


def _params():
    return fleet_weights()["torch"]["full"][1]


def mk_engine(seed=0, slots=SLOTS, max_len=MAX_LEN):
    return Engine(CFG, _params(), slots=slots, max_len=max_len, seed=seed,
                  device="cpu")


def mk_template(seed=100):
    return EngineTemplate(name="auto", profile=EDGE, slots=SLOTS,
                          max_len=MAX_LEN, seed=seed)


def mk_fleet(policy, *, profile=EDGE, clock=None, **kw):
    handles = [EngineHandle("base", mk_engine(seed=0), profile)]
    return FleetController(handles, authority=TrustAuthority(),
                           clock=clock,
                           autoscaler=Autoscaler(mk_template(), policy),
                           **kw)


_REF = {}


def reference_output(prompt, max_new, *, seed=1234):
    """Uninterrupted solo run on the SAME geometry as every fleet
    engine: the bit-exactness oracle."""
    key = (tuple(int(t) for t in prompt), max_new)
    if key not in _REF:
        eng = mk_engine(seed=seed)
        req = Request("ref", np.asarray(prompt), max_new_tokens=max_new)
        eng.add_request(req)
        while not req.done:
            eng.step()
        _REF[key] = req.output
    return _REF[key]


def greedy_spec(rid, prompt, max_new=8, **kw):
    return RequestSpec(rid=rid, prompt=np.asarray(prompt),
                       max_new_tokens=max_new, **kw)


def _terminal_once(fleet, rid):
    return len([ev for ev in fleet.telemetry.events_of(rid)
                if ev.dst in {s.value for s in TERMINAL_STATES}]) == 1


# -- policy decisions (pure, no engines) -------------------------------------

def test_scale_policy_decisions_are_pure_and_bounded():
    pol = ScalePolicy(min_engines=1, max_engines=3,
                      scale_up_queue_depth=4, scale_up_wait_p95=1.0,
                      scale_down_util=0.25, cooldown_s=10.0)
    sig = lambda **kw: ScaleSignals(**{  # noqa: E731
        "depth": 0, "wait_p95": 0.0, "expired_delta": 0,
        "utilization": 0.5, "engines": 2, **kw})
    up = lambda s, now=0.0, last=None: pol.decide(  # noqa: E731
        s, now=now, last_scale=last)[0]
    assert up(sig(depth=4)) == "up"                     # queue pressure
    assert up(sig(wait_p95=2.0)) == "up"                # wait pressure
    assert up(sig(expired_delta=1)) == "up"             # deadline misses
    assert up(sig(depth=3)) is None                     # below threshold
    assert up(sig(depth=99, engines=3)) is None         # at max: never up
    assert up(sig(engines=0)) == "up"                   # below min
    assert up(sig(utilization=0.1)) == "down"           # idle
    assert up(sig(utilization=0.1, engines=1)) is None  # at min: never down
    assert up(sig(utilization=0.1, depth=1)) is None    # backlog: no down
    # cooldown gates BOTH directions on the fleet clock
    assert up(sig(depth=9), now=5.0, last=0.0) is None
    assert up(sig(depth=9), now=10.0, last=0.0) == "up"


# -- scale-up ----------------------------------------------------------------

def test_scale_up_serves_burst_and_events_hit_unified_log():
    """A burst deeper than the pool spawns engines from the template;
    queued work dispatches onto them the same step, every output is
    bit-exact, and the spawns are typed ScaleEvents on the same audit
    log as the lifecycle transitions."""
    fleet = mk_fleet(ScalePolicy(min_engines=1, max_engines=3,
                                 scale_up_queue_depth=2))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(5, CFG.vocab_size, 6) for _ in range(6)]
    tickets = [fleet.submit(greedy_spec(f"r{i}", p))
               for i, p in enumerate(prompts)]
    fleet.step()
    spawns = [ev for ev in fleet.telemetry.scale_events()
              if ev.action == "spawn"]
    assert spawns, "queue depth 6 must trigger a spawn"
    assert spawns[0].engine in fleet.handles
    assert "queue depth" in spawns[0].reason
    for _ in range(60):
        if all(t.done for t in tickets):
            break
        fleet.step()
    assert all(t.state is RequestState.DONE for t in tickets)
    assert fleet.telemetry.scale_ups == 2          # pool grew 1 -> 3
    assert len(fleet.handles) == 3
    # spawned capacity actually served requests, on the weights' device
    spawned = {ev.engine for ev in spawns}
    used = {h for hist in fleet.placements.values() for h in hist}
    assert spawned & used
    for name in spawned:
        assert fleet.handles[name].engine.device.type == "cpu"
    for t, p in zip(tickets, prompts):
        assert t.output == reference_output(p, 8)


def test_spawned_attested_engine_unsticks_confidential_backlog():
    """An unattested-only fleet cannot place confidential work (policy,
    not capacity) -- but a scale-up from an attested template can,
    because the new engine attests against the fleet authority at
    registration."""
    fleet = mk_fleet(ScalePolicy(min_engines=1, max_engines=2,
                                 scale_up_queue_depth=1),
                     profile=MCU)
    t = fleet.submit(greedy_spec("conf", np.arange(6),
                                 sensitivity="confidential"))
    fleet.step()
    assert t.state is not RequestState.QUEUED      # placed, not stuck
    out = t.result()
    assert out == reference_output(np.arange(6), 8)
    assert all(h.startswith("auto")
               for h in fleet.placements["conf"])  # never on the MCU


def test_cooldown_separates_scale_events_on_fleet_clock():
    clk = SimClock()
    fleet = mk_fleet(ScalePolicy(min_engines=1, max_engines=3,
                                 scale_up_queue_depth=1,
                                 cooldown_s=10.0),
                     clock=clk)
    for i in range(8):
        fleet.submit(greedy_spec(f"r{i}", np.arange(6), max_new=16))
    fleet.step()
    assert fleet.telemetry.scale_ups == 1
    clk.advance(5.0)
    fleet.step()                                   # within cooldown
    assert fleet.telemetry.scale_ups == 1
    clk.advance(5.0)
    fleet.step()                                   # cooldown elapsed
    assert fleet.telemetry.scale_ups == 2


def test_expiry_signal_survives_cooldown_gate():
    """Deadline expiries observed while the policy is gated (cooldown)
    are not discarded: they stay accumulated and fire the spawn as soon
    as the gate lifts."""
    clk = SimClock()
    fleet = mk_fleet(ScalePolicy(min_engines=1, max_engines=3,
                                 scale_up_queue_depth=0,   # expiry-only
                                 scale_up_on_expiry=True,
                                 cooldown_s=10.0),
                     clock=clk)
    fleet.autoscaler.scale_up(fleet, reason="arm cooldown")
    assert fleet.telemetry.scale_ups == 1
    fleet.submit(greedy_spec("blocker", np.arange(4), max_new=32))
    fleet.submit(greedy_spec("late", np.arange(4), max_new=32))
    fleet.submit(greedy_spec("doomed", np.arange(4),
                             deadline=clk() + 0.5))
    clk.advance(1.0)
    fleet.step()                       # doomed expires INSIDE cooldown
    assert fleet.telemetry.expired == 1
    assert fleet.telemetry.scale_ups == 1          # gate held
    clk.advance(5.0)
    fleet.step()                       # still gated, still retained
    assert fleet.telemetry.scale_ups == 1
    clk.advance(5.0)
    fleet.step()                       # gate lifts -> retained expiry fires
    assert fleet.telemetry.scale_ups == 2


# -- scale-down: drain via the migration path --------------------------------

def test_scale_down_retires_idle_spawned_engine_only():
    """After the burst clears, the pool shrinks back to min_engines by
    retiring SPAWNED engines; the operator's seed engine survives."""
    fleet = mk_fleet(ScalePolicy(min_engines=1, max_engines=3,
                                 scale_up_queue_depth=2,
                                 scale_down_util=0.3))
    rng = np.random.default_rng(2)
    tickets = [fleet.submit(greedy_spec(
        f"r{i}", rng.integers(5, CFG.vocab_size, 6))) for i in range(6)]
    for _ in range(80):
        fleet.step()
        assert len(fleet.handles) <= 3
        if all(t.done for t in tickets) and len(fleet.handles) == 1:
            break
    assert all(t.done for t in tickets)
    assert sorted(fleet.handles) == ["base"]
    assert fleet.telemetry.scale_downs == 2
    assert not fleet.autoscaler.spawned
    retired = [ev.engine for ev in fleet.telemetry.scale_events()
               if ev.action == "retire"]
    for name in retired:
        assert name not in fleet.handles
        assert fleet.telemetry.stats(name).retired


def test_scale_down_with_live_slots_migrates_bit_exact():
    """Retiring a busy engine is a drain, not a kill: its in-flight
    slot leaves via the migration path (live-migrate when a peer has
    room, park otherwise), resumes elsewhere, and the final output is
    bit-exactly the uninterrupted run."""
    fleet = mk_fleet(ScalePolicy(min_engines=1, max_engines=2,
                                 scale_up_queue_depth=10))  # manual only
    pads = [fleet.submit(greedy_spec("pad0", np.arange(4), max_new=16))]
    fleet.step()
    auto = fleet.autoscaler.scale_up(fleet, reason="test")
    assert {fleet.placement_of(p.rid) for p in pads} == {"base"}
    mover = fleet.submit(greedy_spec("mover", np.arange(6), max_new=16))
    fleet.step()
    assert fleet.placement_of("mover") == auto.engine
    ev = fleet.autoscaler.scale_down(fleet, reason="test")
    assert ev is not None and ev.engine == auto.engine
    assert auto.engine not in fleet.handles
    # base was full -> the slot PARKED (extract_slot -> pack_slot) and
    # re-places once capacity frees: displaced, never dropped
    assert mover.state is RequestState.MIGRATING
    assert any(it.origin == "drain" for it in fleet.queue.parked())
    assert mover.result() == reference_output(np.arange(6), 16)
    resume = [m for m in fleet.telemetry.migrations
              if m.rid == "mover" and m.src == auto.engine]
    assert resume and resume[0].reason == "drain"
    for p in pads:
        p.result()


# -- the chaos soaks ---------------------------------------------------------

def test_chaos_soak_no_request_lost_or_duplicated():
    """Mixed-priority bursty workload under autoscaling PLUS an injected
    engine failure, a mid-flight cancellation and an infeasible
    deadline, with the conservation invariant audited after every step;
    every ticket terminal exactly once, scale-down only ever drained via
    the migration path, and a greedy request that rode the churn equal
    to its uninterrupted run."""
    clk = SimClock()
    fleet = mk_fleet(ScalePolicy(min_engines=1, max_engines=3,
                                 scale_up_queue_depth=3,
                                 scale_down_util=0.3),
                     clock=clk)
    rng = np.random.default_rng(3)
    prompts = {}
    tickets = {}

    def submit(rid, prio, **kw):
        p = rng.integers(5, CFG.vocab_size, 6)
        t = fleet.submit(greedy_spec(rid, p, priority=prio, **kw))
        assert t is not None
        prompts[rid], tickets[rid] = p, t

    for i in range(6):
        submit(f"a{i}", (0, 5, 10)[i % 3])
    submit("doomed", 0, deadline=clk() + 0.01)
    clk.advance(0.05)                      # the deadline is already gone

    failed = cancelled = False
    for step in range(300):
        clk.advance(0.05)
        fleet.step()
        assert_conserved(fleet)
        assert len(fleet.handles) <= 5
        healthy_pool = [h for h in fleet.handles.values() if h.healthy]
        assert len(healthy_pool) <= 4
        if step == 2 and fleet.inflight and not cancelled:
            victim = sorted(fleet.inflight)[0]
            assert fleet.cancel(victim)
            cancelled = True
            assert_conserved(fleet)
        if step >= 3 and not failed:
            busy_spawned = [n for n in fleet.autoscaler.spawned
                            if n in fleet.handles
                            and fleet.handles[n].healthy
                            and fleet.handles[n].engine.requests]
            if busy_spawned:
                fleet.fail(busy_spawned[0])   # chaos: kill a spawned engine
                failed = True
                assert_conserved(fleet)
        if step == 6:                      # phase B: second burst
            for i in range(4):
                submit(f"b{i}", (10, 0, 5, 0)[i],
                       sensitivity="confidential" if i == 0 else "public")
        if all(t.done for t in tickets.values()):
            break
    assert failed, "chaos never fired: no spawned engine was ever busy"
    assert all(t.done for t in tickets.values()), \
        {r: t.state.value for r, t in tickets.items() if not t.done}
    for rid in tickets:
        assert _terminal_once(fleet, rid), rid
    assert tickets["doomed"].state is RequestState.EXPIRED
    done = {r for r, t in tickets.items()
            if t.state is RequestState.DONE}
    for rid in done:
        assert len(fleet.done[rid].output) == 8
    for ev in fleet.telemetry.scale_events():
        if ev.action != "retire":
            continue
        assert ev.engine not in fleet.handles
        displaced = [m.rid for m in fleet.telemetry.migrations
                     if m.src == ev.engine and m.reason == "drain"]
        displaced += [lev.rid for lev in fleet.telemetry.events
                      if getattr(lev, "engine", None) == ev.engine
                      and getattr(lev, "dst", None) == "migrating"
                      and "scale-down" in lev.reason]
        for rid in displaced:
            assert tickets[rid].done
    movers = [r for r in sorted(done)
              if len(fleet.placements.get(r, [])) > 1]
    for rid in (movers or sorted(done))[:2]:
        assert tickets[rid].output == reference_output(prompts[rid], 8), \
            rid
    assert fleet.telemetry.scale_ups >= 1
    for _ in range(20):
        clk.advance(0.05)
        fleet.step()
        assert_conserved(fleet)
    healthy = [h for h in fleet.handles.values() if h.healthy]
    assert len(healthy) == 1


def _paged_soak(template, engine, tickets_of, *, standby=False):
    clk = SimClock()
    policy = ScalePolicy(min_engines=1, max_engines=3,
                         scale_up_queue_depth=2, scale_down_util=0.3,
                         **({"standby_pool": 1, "prefix_prewarm": 2}
                            if standby else {}))
    fleet = FleetController(
        [EngineHandle("pbase", engine, EDGE)],
        authority=TrustAuthority(), clock=clk,
        autoscaler=Autoscaler(template, policy))
    if standby:
        fleet.step()                      # pre-arm before the burst
        assert len(fleet.autoscaler.standbys) == 1
    tickets = tickets_of(fleet)
    failed = False
    for step in range(300):
        clk.advance(0.05)
        fleet.step()
        assert_conserved(fleet)
        if step >= 2 and not failed:
            busy = [n for n in fleet.autoscaler.spawned
                    if n in fleet.handles and fleet.handles[n].healthy
                    and fleet.handles[n].engine.requests]
            if busy:
                fleet.fail(busy[0])
                failed = True
                assert_conserved(fleet)
        if all(t.done for t in tickets.values()):
            break
    assert failed, "no spawned paged engine was ever busy"
    assert all(t.state is RequestState.DONE for t in tickets.values()), \
        {r: t.state.value for r, t in tickets.items() if not t.done}
    for rid in tickets:
        assert _terminal_once(fleet, rid), rid
    return fleet, tickets


def test_paged_pool_chaos_soak_conserves_token_budget():
    """The soak again, on a paged-KV pool (page_size 8, 6 pages: the
    page budget, not the row count, is what admission spends), with the
    page ledger audited on every engine after every step; after the
    churn every allocator is empty."""
    def paged_engine(seed):
        return PagedEngine(CFG, _params(), page_size=8, pages=6, rows=4,
                           max_len=MAX_LEN, seed=seed, device="cpu")

    template = EngineTemplate(name="pauto", profile=EDGE, slots=4,
                              max_len=MAX_LEN, seed=300,
                              page_size=8, pages=6)
    rng = np.random.default_rng(7)

    def tickets_of(fleet):
        out = {}
        for i in range(8):
            rid = f"p{i}"
            out[rid] = fleet.submit(greedy_spec(
                rid, rng.integers(5, CFG.vocab_size, 6),
                priority=(0, 5, 10)[i % 3]))
        # each request reserves ceil((6+8)/8)=2 of 6 pages: three rows
        # fit although four rows exist -- the page budget is the gate
        assert fleet.handles["pbase"].engine.can_admit(14)
        return out

    fleet, tickets = _paged_soak(template, paged_engine(0), tickets_of)
    for rid, t in tickets.items():
        assert len(t.output) == 8, rid
    for handle in fleet.handles.values():
        if handle.healthy:
            eng = handle.engine
            assert eng.allocator.used_pages == 0, handle.name
            assert eng.free_token_budget == eng.pages * eng.page_size


# -- millisecond scale-up: program cache + warm standbys ----------------------

def test_scale_policy_prearm_decisions():
    """Pure prearm policy: the pool fills below target (horizon 0),
    fills on forecast only when a horizon is set, keeps filling under
    cooldown, and never arms with the routable pool at max."""
    base = dict(depth=0, wait_p95=0.0, expired_delta=0,
                utilization=0.5, engines=2)
    pol = ScalePolicy(min_engines=1, max_engines=3,
                      scale_up_queue_depth=4, standby_pool=1,
                      cooldown_s=10.0)
    dec = lambda now=0.0, last=None, **kw: pol.decide(  # noqa: E731
        ScaleSignals(**{**base, **kw}), now=now, last_scale=last)
    assert dec() == ("prearm", "standby pool 0/1 below target")
    assert dec(standbys=1)[0] is None                  # pool full
    assert dec(engines=3)[0] is None                   # routable at max
    assert dec(now=5.0, last=0.0)[0] == "prearm"       # inside cooldown
    assert dec(depth=4)[0] == "up"                     # real pressure wins
    fpol = ScalePolicy(min_engines=1, max_engines=3,
                       scale_up_queue_depth=4, standby_pool=1,
                       prearm_horizon_s=0.5)
    fdec = lambda **kw: fpol.decide(  # noqa: E731
        ScaleSignals(**{**base, **kw}), now=0.0, last_scale=None)
    assert fdec()[0] is None                           # no trend, no arm
    assert fdec(arrival_rate=10.0)[0] == "prearm"      # 0 + 10*0.5 >= 4
    assert fdec(depth=2, depth_slope=4.0)[0] == "prearm"   # 2 + 4*0.5 >= 4
    assert fdec(depth=2, depth_slope=2.0)[0] is None   # 2 + 1 < 4
    assert fdec(depth=3, depth_slope=-9.0)[0] is None  # falling queue


def test_warm_spawn_shares_compiled_programs_and_is_bit_exact():
    """Two engines of one (cfg, geometry) key are served the SAME step
    programs by the process-wide cache -- the second construction is a
    cache hit and its greedy decode is bit-identical."""
    e1, e2 = mk_engine(seed=51), mk_engine(seed=52)
    assert e2.program_cache_hit
    assert e1._programs is e2._programs
    assert e1._decode_fn is e2._decode_fn
    assert e1._prefill_fn is e2._prefill_fn
    prompt = np.arange(3, 9)
    outs = []
    for eng in (e1, e2):
        req = Request("r", np.asarray(prompt), max_new_tokens=8)
        eng.add_request(req)
        while not req.done:
            eng.step()
        outs.append(req.output)
    assert outs[0] == outs[1] == reference_output(prompt, 8)
    other = mk_engine(seed=53, max_len=MAX_LEN * 2)
    assert other._programs is not e1._programs


def test_standby_pool_prearms_attests_and_promotes_in_one_step():
    """The warm pool end to end: an idle step pre-arms a standby off the
    dispatch path (typed "prearm" event, no membership counters, no
    cooldown consumed, its step counter unchanged by the warm-up); the
    burst promotes it -- pre-attested, cache-served programs -- the
    spawn span records the promotion, and the pool refills."""
    fleet = mk_fleet(ScalePolicy(min_engines=1, max_engines=3,
                                 scale_up_queue_depth=2,
                                 standby_pool=1))
    auto = fleet.autoscaler
    fleet.step()                          # idle: builds the standby
    assert len(auto.standbys) == 1
    sb = auto.standbys[0]
    assert sb.attester is not None        # attested at BUILD time
    assert sb.cache_hit                   # programs from the cache
    assert "decode" in sb.engine._compiled     # warmed
    assert sb.engine.state.step_count == 0
    prearms = [ev for ev in fleet.telemetry.scale_events()
               if ev.action == "prearm"]
    assert len(prearms) == 1 and prearms[0].engine == sb.name
    assert fleet.telemetry.scale_ups == 0
    assert fleet.telemetry.scale_downs == 0
    assert auto._last_scale is None       # prearm never starts cooldown
    rng = np.random.default_rng(9)
    prompts = [rng.integers(5, CFG.vocab_size, 6) for _ in range(4)]
    tickets = [fleet.submit(greedy_spec(f"w{i}", p))
               for i, p in enumerate(prompts)]
    fleet.step()
    assert auto.promotions == 1
    assert sb.name in fleet.handles
    assert fleet.handles[sb.name].attester is sb.attester
    spawn = next(ev for ev in fleet.telemetry.scale_events()
                 if ev.action == "spawn")
    assert "promoted warm standby" in spawn.reason
    for _ in range(60):
        if all(t.done for t in tickets):
            break
        fleet.step()
    for t, p in zip(tickets, prompts):
        assert t.output == reference_output(p, 8)
    span = next(s for s in fleet.tracer.spans
                if s.name == "spawn"
                and s.trace_id == f"engine:{sb.name}")
    assert span.attrs["promoted"] is True
    assert span.attrs["cache_hit"] is True
    assert span.attrs["standby_build_s"] > 0
    assert span.attrs["time_to_useful_s"] >= 0
    assert len(auto.standbys) == 1


def test_floor_unservable_request_fails_fast_with_hint():
    """A floor above every live tier AND every template tier terminates
    FAILED at submit with a typed reject-with-hint; a floor the fleet
    could spawn for still queues."""
    fleet = mk_fleet(ScalePolicy(min_engines=1, max_engines=2))
    t = fleet.submit(greedy_spec("greedy-floor", np.arange(6),
                                 quality_floor=1.5))
    assert t is not None
    assert t.state is RequestState.FAILED
    assert "quality_floor 1.50 exceeds" in t.events[-1].reason
    assert fleet.queue.depth() == 0       # never queued
    assert fleet.telemetry.floor_rejects == 1
    rejects = [ev for ev in fleet.telemetry.events
               if getattr(ev, "kind", "") == "floor_reject"]
    assert len(rejects) == 1
    assert rejects[0].rid == "greedy-floor" and rejects[0].floor == 1.5
    assert rejects[0].hint in t.events[-1].reason
    ok = fleet.submit(greedy_spec("ok", np.arange(6), quality_floor=1.0))
    assert ok.state is RequestState.QUEUED
    assert ok.result() == reference_output(np.arange(6), 8)


def test_cross_tier_weight_borrow_refused_loudly():
    """A paramless template whose tier has no live engine must refuse to
    borrow another tier's weights -- RuntimeError, not an assert."""
    int8 = QualityTier("int8", 0.8, "int8")
    templates = [mk_template(), EngineTemplate(name="auto8", profile=EDGE,
                                               slots=SLOTS, max_len=MAX_LEN,
                                               seed=200, tier=int8)]
    fleet = mk_fleet(ScalePolicy(min_engines=1, max_engines=2))
    auto = Autoscaler(templates, ScalePolicy())
    with pytest.raises(RuntimeError, match="cross-tier weight borrowing"):
        auto._params_for(fleet, auto.templates["int8"])


def test_promotion_mid_chaos_soak_conserves_pages_and_tickets():
    """The paged chaos soak with the warm pool armed and prefix caches
    on: a standby is promoted mid-churn (engine failure included) and
    the per-step audit -- request conservation and the page ledgers,
    grafted prewarm pages included -- holds throughout."""
    def paged_engine(seed):
        return PagedEngine(CFG, _params(), page_size=8, pages=8, rows=4,
                           max_len=MAX_LEN, seed=seed, prefix_cache=True,
                           device="cpu")

    template = EngineTemplate(name="pauto", profile=EDGE, slots=4,
                              max_len=MAX_LEN, seed=400,
                              page_size=8, pages=8, prefix_cache=True)
    rng = np.random.default_rng(11)

    def tickets_of(fleet):
        return {f"q{i}": fleet.submit(greedy_spec(
            f"q{i}", rng.integers(5, CFG.vocab_size, 6),
            priority=(0, 5, 10)[i % 3], tenant=f"t{i % 2}"))
            for i in range(8)}

    fleet, _ = _paged_soak(template, paged_engine(0), tickets_of,
                           standby=True)
    assert fleet.autoscaler.promotions >= 1, \
        "the soak never promoted from the warm pool"


# -- per-tier template pools (tests/test_fleet_quality.py) --------------------

def _tier_engine(tier, seed, slots=1):
    cfg, params = fleet_weights()["torch"][tier.name]
    return Engine(cfg, params, slots=slots, max_len=MAX_LEN, seed=seed,
                  device="cpu")


def _tier_fleet(full_slots=1, lite_slots=2, **kw):
    handles = [
        EngineHandle("big", _tier_engine(FULL, 0, full_slots), CLOUD,
                     tier=FULL),
        EngineHandle("small", _tier_engine(LITE, 1, lite_slots), EDGE,
                     tier=LITE),
    ]
    return FleetController(handles, authority=TrustAuthority(), **kw)


def _tier_spec(rid, *, max_new=8, floor=0.0, prompt_len=6, seed=7):
    rng = np.random.default_rng(seed + sum(map(ord, rid)))
    return RequestSpec(rid=rid,
                       prompt=rng.integers(5, CFG.vocab_size, prompt_len),
                       max_new_tokens=max_new, quality_floor=floor)


def _tier_templates():
    return [
        EngineTemplate(name="auto-full", profile=CLOUD, slots=1,
                       max_len=MAX_LEN, seed=60, tier=FULL),
        EngineTemplate(name="auto-lite", profile=EDGE, slots=1,
                       max_len=MAX_LEN, seed=70, tier=LITE, cfg=CFG,
                       params=fleet_weights()["torch"]["lite"][1]),
    ]


def _scale_fleet(policy=None):
    return FleetController(
        [EngineHandle("seed0", _tier_engine(FULL, 0), CLOUD, tier=FULL)],
        authority=TrustAuthority(),
        autoscaler=Autoscaler(_tier_templates(), policy or ScalePolicy(
            min_engines=1, max_engines=3, scale_up_queue_depth=2)))


def test_autoscaler_spawns_the_tier_the_backlog_needs():
    fleet = _tier_fleet()             # no autoscaler: direct pick test
    scaler = Autoscaler(_tier_templates())
    for i in range(3):
        fleet.submit(_tier_spec(f"f{i}", floor=0.9))
    assert scaler.pick_template(fleet).tier.name == "full"
    fleet2 = _tier_fleet()
    for i in range(3):
        fleet2.submit(_tier_spec(f"c{i}", floor=0.0))
    assert scaler.pick_template(fleet2).tier.name == "lite"
    fleet3 = _tier_fleet()
    fleet3.submit(_tier_spec("a", floor=0.9))
    for i in range(3):
        fleet3.submit(_tier_spec(f"b{i}", floor=0.0))
    assert scaler.pick_template(fleet3).tier.name == "lite"


def test_autoscaler_spawned_engine_carries_its_tier():
    fleet = _scale_fleet()
    ts = [fleet.submit(_tier_spec(f"r{i}", max_new=6)) for i in range(4)]
    while not all(t.done for t in ts):
        fleet.step()
    spawns = [ev for ev in fleet.telemetry.scale_events()
              if ev.action == "spawn"]
    assert spawns, "queue pressure must spawn"
    for ev in spawns:
        assert ev.engine.startswith("auto-lite")
        assert "lite" in fleet.tiers
    lite_served = [t.rid for t in ts
                   if any(p.startswith("auto-lite")
                          for p in fleet.placements[t.rid])]
    assert lite_served


def test_autoscaler_floored_backlog_spawns_full_tier():
    fleet = _scale_fleet()
    ts = [fleet.submit(_tier_spec(f"r{i}", max_new=6, floor=0.9))
          for i in range(4)]
    while not all(t.done for t in ts):
        fleet.step()
    spawns = [ev for ev in fleet.telemetry.scale_events()
              if ev.action == "spawn"]
    assert spawns and all(ev.engine.startswith("auto-full")
                          for ev in spawns)
    for t in ts:
        for eng in fleet.placements[t.rid]:
            assert fleet.handles.get(eng) is None \
                or fleet.handles[eng].tier.quality >= 0.9


# -- request conservation under scale churn (tests/test_properties.py) -------

def test_request_conservation_under_scale_churn():
    """The scaling-is-migration contract as a state-machine property over
    the port's ``WorkQueue``: under random interleavings of submit /
    dispatch / complete / cancel / expire / scale_up / scale_down, every
    submitted id is in exactly one of {pending work, running, terminal},
    and a scale-down re-parks every live slot without touching blobs
    already parked (60 random sequences of up to 80 operations, as the
    JAX property's ``max_examples``)."""
    rng = np.random.default_rng(0)
    ops_names = ("submit", "dispatch", "complete", "cancel", "expire",
                 "scale_up", "scale_down")
    for _ in range(60):
        ops = [(ops_names[int(rng.integers(0, 7))], int(rng.integers(0, 32)))
               for _ in range(int(rng.integers(1, 81)))]
        slots = 2
        wq = WorkQueue()
        engines: dict[str, dict[str, object]] = {"seed0": {}}
        terminal: dict[str, str] = {}
        submitted: list[str] = []
        n_eng = 0

        def check():
            queued = [it.rid for it in wq.ordered()]
            running = [rid for e in engines.values() for rid in e]
            ids = queued + running + sorted(terminal)
            assert sorted(ids) == sorted(submitted), "lost or duplicated"
            assert len(ids) == len(set(ids)), "request in two places"

        for op, arg in ops:
            if op == "submit":
                rid = f"r{len(submitted)}"
                wq.push(WorkItem(rid=rid, priority=arg % 4,
                                 seq=wq.next_seq(), t_submit=0.0))
                submitted.append(rid)
            elif op == "dispatch":
                free = [n for n, e in sorted(engines.items())
                        if len(e) < slots]
                items = wq.ordered()
                if free and items:
                    it = items[0]
                    wq.remove(it.rid)
                    engines[free[0]][it.rid] = it
            elif op == "complete":
                running = [(n, rid) for n, e in sorted(engines.items())
                           for rid in sorted(e)]
                if running:
                    name, rid = running[arg % len(running)]
                    del engines[name][rid]
                    terminal[rid] = "done"
            elif op in ("cancel", "expire"):
                pend = [it.rid for it in wq.ordered()]
                if pend:
                    rid = pend[arg % len(pend)]
                    wq.remove(rid)
                    terminal[rid] = op
            elif op == "scale_up":
                n_eng += 1
                engines[f"auto{n_eng}"] = {}
            elif op == "scale_down" and len(engines) > 1:
                name = min(sorted(engines),
                           key=lambda n: (len(engines[n]), n))
                parked_before = {it.rid for it in wq.parked()}
                for rid, it in sorted(engines.pop(name).items()):
                    wq.push(WorkItem(rid=rid, priority=it.priority,
                                     seq=it.seq, t_submit=it.t_submit,
                                     blob=b"x", src=name, origin="drain"))
                assert parked_before <= {it.rid for it in wq.parked()}
            check()


# -- refusals the JAX package asserts ----------------------------------------

def test_autoscaler_and_service_mode_refuse_with_value_error():
    """Where the JAX package asserts (gone under ``python -O``), the port
    raises ValueError: an empty template list, a template without a
    profile, two templates of one tier, and service mode over a fleet
    with an autoscaler."""
    with pytest.raises(ValueError, match="at least one template"):
        Autoscaler([])
    with pytest.raises(ValueError, match="DeviceProfile"):
        Autoscaler(EngineTemplate(name="x"))
    with pytest.raises(ValueError, match="duplicate template"):
        Autoscaler([mk_template(), mk_template(seed=7)])
    fleet = mk_fleet(ScalePolicy())
    with pytest.raises(ValueError, match="autoscaler"):
        ControlPlane(fleet)
    assert fleet.service is None


# -- parity with the JAX package ---------------------------------------------

def test_decide_matches_jax_on_the_same_signals():
    """``ScalePolicy.decide`` -- action and reason -- is equal in both
    packages on 400 random signal sets, under three policies."""
    from repro.fleet import ScalePolicy as JPolicy
    from repro.fleet import ScaleSignals as JSignals
    rng = np.random.default_rng(5)
    policies = [dict(min_engines=1, max_engines=3, scale_up_queue_depth=4,
                     scale_up_wait_p95=1.0, cooldown_s=10.0),
                dict(min_engines=2, max_engines=4, scale_up_queue_depth=0,
                     standby_pool=2, prearm_horizon_s=0.5),
                dict(min_engines=1, max_engines=2, scale_up_on_expiry=False,
                     standby_pool=1, scale_down_util=0.5)]
    for kw in policies:
        jp, tp = JPolicy(**kw), ScalePolicy(**kw)
        for _ in range(400):
            sig = dict(depth=int(rng.integers(0, 8)),
                       wait_p95=float(rng.uniform(0, 3)),
                       expired_delta=int(rng.integers(0, 2)),
                       utilization=float(rng.uniform(0, 1)),
                       engines=int(rng.integers(0, 5)),
                       arrival_rate=float(rng.uniform(-2, 12)),
                       depth_slope=float(rng.uniform(-5, 5)),
                       standbys=int(rng.integers(0, 3)))
            now = float(rng.uniform(0, 20))
            last = None if rng.uniform() < 0.3 else float(rng.uniform(0, 20))
            assert tp.decide(ScaleSignals(**sig), now=now, last_scale=last) \
                == jp.decide(JSignals(**sig), now=now, last_scale=last), \
                (kw, sig, now, last)


def test_int8_round_trip_bit_equal_to_jax():
    """The port's ``quantize_int8`` / ``dequantize_int8`` give the JAX
    package's q, scale and round trip bit for bit, on bf16 and f32
    tensors and on every leaf of the tiny llama's weights."""
    import jax.numpy as jnp
    from repro.optim.compression import dequantize_int8 as jdq
    from repro.optim.compression import quantize_int8 as jq
    from repro_torch.optim.compression import (dequantize_int8,
                                               int8_round_trip,
                                               quantize_int8)
    rng = np.random.default_rng(1)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        x = jnp.asarray(rng.standard_normal((33, 70)) * 5, jdt)
        t = torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
        jqv, js = jq(x)
        tqv, ts = quantize_int8(t)
        assert np.array_equal(np.asarray(jqv), tqv.numpy())
        assert float(js) == float(ts)
        back = dequantize_int8(tqv, ts)
        assert back.dtype == torch.float32
        assert np.array_equal(np.asarray(jdq(jqv, js)), back.numpy())
    from repro_torch.core.tree import leaves_with_path
    from repro_torch.models.init import params_from_numpy
    jfull = fleet_side("jax").weights["full"][1]
    jlite = params_from_numpy(to_numpy(jax_int8_round_trip(jfull)),
                              device="cpu")
    tlite = int8_round_trip(fleet_weights()["torch"]["full"][1])
    want = dict(leaves_with_path(jlite))
    got = dict(leaves_with_path(tlite))
    assert want.keys() == got.keys()
    for path, leaf in got.items():
        assert leaf.dtype == want[path].dtype, path
        assert torch.equal(leaf, want[path]), path


def _autoscaled_stream(side):
    ns = fleet_side(side, "float32")
    clk = ns.SimClock()
    cfg, params = ns.weights["full"]
    template = ns.EngineTemplate(name="auto", profile=ns.EDGE, slots=1,
                                 max_len=MAX_LEN, seed=100)
    fleet = ns.FleetController(
        [ns.EngineHandle("base", ns.engine(slots=1, max_len=MAX_LEN),
                         ns.EDGE)],
        authority=ns.TrustAuthority(), clock=clk,
        autoscaler=ns.Autoscaler(template, ns.ScalePolicy(
            min_engines=1, max_engines=3, scale_up_queue_depth=2,
            scale_down_util=0.3, standby_pool=1)))
    fleet.step()                      # pre-arms the standby
    rng = np.random.default_rng(4)
    tickets = [fleet.submit(ns.RequestSpec(
        rid=f"r{i}", prompt=rng.integers(5, cfg.vocab_size, 5),
        max_new_tokens=6, priority=(0, 5)[i % 2])) for i in range(6)]
    for _ in range(200):
        clk.advance(0.05)
        fleet.step()
        if all(t.done for t in tickets) and not fleet.autoscaler.spawned:
            break
    assert all(t.state is ns.RequestState.DONE for t in tickets)
    rec = fleet_record(fleet)
    rec["scale"] = [(ev.action, ev.engine, ev.reason, ev.engines)
                    for ev in fleet.telemetry.scale_events()]
    rec["standbys"] = [sb.name for sb in fleet.autoscaler.standbys]
    return rec


def test_autoscaled_stream_matches_jax():
    """One stream with a pre-armed standby, a promotion, spawns and
    idle retirements: placements, scale events (actions, engines,
    reasons, pool sizes), ticket states, audit kinds and greedy tokens
    equal in both packages (f32)."""
    jrec, trec = _autoscaled_stream("jax"), _autoscaled_stream("torch")
    for key in ("scale", "standbys", "placements", "states", "audit",
                "outputs", "migrations"):
        assert jrec[key] == trec[key], key
    actions = [a for a, *_ in trec["scale"]]
    assert "prearm" in actions and "spawn" in actions \
        and "retire" in actions
    assert any("promoted warm standby" in r for _, _, r, _ in trec["scale"])


def test_spawn_reuses_the_donors_programs_on_the_paged_engine():
    """A paged template of the seed engine's geometry spawns an engine
    served the seed engine's programs (``program_cache_hit``; the spawn
    span says so), and its first greedy request equals the same request
    alone on the seed engine, bit for bit."""
    seed_eng = PagedEngine(CFG, _params(), page_size=8, pages=16, rows=2,
                           max_len=MAX_LEN, seed=0, device="cpu")
    template = EngineTemplate(name="pauto", profile=EDGE, slots=2,
                              max_len=MAX_LEN, seed=500, page_size=8,
                              pages=16)
    fleet = FleetController([EngineHandle("pbase", seed_eng, EDGE)],
                            authority=TrustAuthority(),
                            autoscaler=Autoscaler(template, ScalePolicy(
                                min_engines=1, max_engines=2,
                                scale_up_queue_depth=10)))
    ev = fleet.autoscaler.scale_up(fleet, reason="test")
    spawned = fleet.handles[ev.engine].engine
    assert spawned.program_cache_hit
    assert spawned._programs is seed_eng._programs
    span = next(s for s in fleet.tracer.spans if s.name == "spawn")
    assert span.attrs["cache_hit"] is True
    prompt = np.arange(5, 17)
    outs = []
    for eng in (spawned, seed_eng):
        req = Request("r", prompt, max_new_tokens=8)
        assert eng.add_request(req)
        while not req.done:
            eng.step()
        outs.append(req.output)
    assert outs[0] == outs[1]


# -- a drained paged slot is routed by its whole page reservation ------------

def _drain_into_a_short_pool(side):
    """Two paged engines (page size 8, 6 pages, 4 rows): ``b`` holds
    three requests that leave it one free page; ``a`` holds one request
    of 6 + 8 tokens (2 pages) four tokens in.  Its remaining 4 tokens
    would fit one page, its row's reservation needs two."""
    ns = fleet_side(side)
    mk = lambda seed: ns.paged(page_size=8, pages=6, rows=4,  # noqa: E731
                               max_len=MAX_LEN, seed=seed)
    fleet = ns.FleetController([ns.EngineHandle("a", mk(0), ns.EDGE),
                                ns.EngineHandle("b", mk(1), ns.EDGE)],
                               authority=ns.TrustAuthority())
    b = fleet.handles["b"].engine
    for i, (plen, new) in enumerate(((6, 8), (6, 8), (1, 7))):
        assert b.add_request(ns.Request(f"b{i}", np.arange(3, 3 + plen),
                                        max_new_tokens=new))
    assert b.allocator.free_pages == 1
    mover = ns.Request("m", np.arange(5, 11), max_new_tokens=8)
    a = fleet.handles["a"].engine
    assert a.add_request(mover)
    for _ in range(4):
        a.step()
    return ns, fleet, mover


def test_jax_drain_routes_a_paged_slot_by_its_remaining_tokens():
    """The JAX router is asked with the slot's remaining tokens, so it
    picks ``b`` (one free page) and ``inject_slot`` raises out of
    ``drain``."""
    ns, fleet, mover = _drain_into_a_short_pool("jax")
    with pytest.raises(RuntimeError, match="page"):
        fleet.balancer.drain(fleet.handles["a"], fleet)


def test_port_drain_routes_a_paged_slot_by_its_reservation():
    """The port asks for the row's whole reservation (``room_for``):
    ``b`` cannot take it, so the slot stays on ``a``, nothing moved, and
    it finishes there with the tokens of an undisturbed run."""
    ns, fleet, mover = _drain_into_a_short_pool("torch")
    assert fleet.balancer.drain(fleet.handles["a"], fleet) == []
    a, b = fleet.handles["a"].engine, fleet.handles["b"].engine
    assert [r.rid for r in a.requests.values()] == ["m"]
    assert b.allocator.free_pages == 1
    while a.requests:
        a.step()
    solo = ns.paged(page_size=8, pages=6, rows=4, max_len=MAX_LEN, seed=9)
    ref = ns.Request("m", np.arange(5, 11), max_new_tokens=8)
    solo.add_request(ref)
    while solo.requests:
        solo.step()
    assert mover.output == ref.output
