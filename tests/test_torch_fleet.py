"""The port's fleet on the CPU: counterparts of every test of
``tests/test_fleet.py`` (slot migration, sensitivity routing, admission
backpressure, failure with bit-identical resume, drain over the attested
wire, load rebalancing, liveness) and of the three fleet tests of
``tests/test_prefix_cache.py`` (router affinity, fleet counters, one
hashing pass a route), on tiny llama-1.5b with the JAX package's seed-0
weights bridged.  The parity tests drive one request stream on a
``SimClock`` through a JAX ``FleetController`` and a port one and hold
their decisions, audit logs, telemetry counters and span trees equal,
and their greedy tokens at agreement 1.0 (or a JAX knife edge at any
divergence)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get  # noqa: E402
from repro_torch.configs.tiny import make_tiny  # noqa: E402
from repro_torch.core.attestation import TrustAuthority  # noqa: E402
from repro_torch.core.channel import Channel  # noqa: E402
from repro_torch.core.daemon import CLOUD, EDGE, MCU, DeviceProfile  # noqa: E402
from repro_torch.core.migration import pack_slot, unpack_slot  # noqa: E402
from repro_torch.fleet import (EngineHandle, FleetController,  # noqa: E402
                               Rebalancer, percentile)
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.paged import PagedEngine  # noqa: E402
from tests import helpers  # noqa: E402
from tests.torch_helpers import (assert_conserved, fleet_record,  # noqa: E402
                                 fleet_side, fleet_weights,
                                 greedy_agreement)

CFG = make_tiny(get("llama-1.5b"))
# greedy tokens across the packages are compared in f32 (bf16 rounds
# differently in the two frameworks); a divergence is only legitimate
# where the JAX top-2 logit gap is below this (as test_torch_paged.py)
GAP_TOL = 1e-4


def _params():
    return fleet_weights()["torch"]["full"][1]


def mk_engine(seed=0, slots=4, max_len=64):
    return Engine(CFG, _params(), slots=slots, max_len=max_len, seed=seed,
                  device="cpu")


def mk_fleet(profiles=None, slots=4, **kw):
    profiles = profiles or [("edge", EDGE), ("cloud", CLOUD), ("mcu", MCU)]
    handles = [EngineHandle(name, mk_engine(seed=i, slots=slots), prof)
               for i, (name, prof) in enumerate(profiles)]
    return FleetController(handles, authority=TrustAuthority(), **kw)


def reference_output(prompt, max_new, *, temperature=0.0, top_k=0, seed=1234):
    """The request served alone on a fresh engine (greedy outputs are
    slot- and batch-independent, so this is the bit-exactness oracle)."""
    eng = mk_engine(seed=seed)
    req = Request("ref", np.asarray(prompt), max_new_tokens=max_new,
                  temperature=temperature, top_k=top_k)
    eng.add_request(req)
    while not req.done:
        eng.step()
    return req.output


def mk_paged(seed=0, page_size=8, rows=4, pages=None, max_len=64, **kw):
    kw.setdefault("prefix_cache", True)
    return PagedEngine(CFG, _params(), page_size=page_size, rows=rows,
                       pages=pages, max_len=max_len, seed=seed,
                       device="cpu", **kw)


def mk_req(rid, prompt, max_new=6, **kw):
    return Request(rid, np.asarray(prompt), max_new_tokens=max_new, **kw)


def drain(eng, reqs):
    for r in reqs:
        assert eng.add_request(r)
    while eng.requests:
        eng.step()
    return {r.rid: r.output for r in reqs}


# -- slot-level migration (the enabling refactor) ----------------------------

def test_extract_inject_roundtrip_different_slot_bit_identical():
    """Property: extract -> wire -> inject on a second engine, into a
    *different* slot index, resumes bit-identically vs. the un-migrated
    twin -- including non-greedy sampling state (per-slot rng)."""
    src = mk_engine(seed=42)
    twin = mk_engine(seed=42)
    for eng in (src, twin):
        eng.add_request(Request("pad", np.arange(3), max_new_tokens=18))
        eng.add_request(Request("r0", np.arange(6), max_new_tokens=18,
                                temperature=0.9, top_k=8))
    for _ in range(6):
        src.step()
        twin.step()

    snap = src.extract_slot(1)               # drains the source slot
    assert 1 not in src.requests
    assert not bool(src.state.active[1])

    dst = mk_engine(seed=777)
    dst.add_request(Request("busy0", np.arange(4), max_new_tokens=30))
    dst.add_request(Request("busy1", np.arange(4), max_new_tokens=30))
    blob = Channel().send(pack_slot(snap))   # over the (simulated) wire
    req = dst.inject_slot(unpack_slot(blob, dst.slot_like()))
    assert req.slot == 2                     # a different slot index

    while not req.done:
        dst.step()
    twin_req = twin.requests[1]
    while not twin_req.done:
        twin.step()
    assert req.output == twin_req.output


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_slot_migration_property_sweep(seed):
    """Same property across prompts/lengths/policies (seeded sweep)."""
    rng = np.random.default_rng(seed)
    prompt = rng.integers(5, CFG.vocab_size, rng.integers(3, 9))
    max_new = int(rng.integers(6, 14))
    temp = float(rng.choice([0.0, 0.7, 1.1]))
    k = int(rng.choice([0, 4, 16]))

    src = mk_engine(seed=seed)
    twin = mk_engine(seed=seed)
    for eng in (src, twin):
        eng.add_request(Request("r", prompt, max_new_tokens=max_new,
                                temperature=temp, top_k=k))
    for _ in range(3):
        src.step()
        twin.step()
    dst = mk_engine(seed=seed + 50)
    dst.add_request(Request("pad", np.arange(2), max_new_tokens=4))
    blob = pack_slot(src.extract_slot(0))
    req = dst.inject_slot(unpack_slot(blob, dst.slot_like()))
    assert req.slot != 0
    while not req.done:
        dst.step()
    twin_r = twin.requests[0]
    while not twin_r.done:
        twin.step()
    assert req.output == twin_r.output


def test_mixed_temperature_batch_samples_per_slot():
    """Per-request sampling params reach the decode step: a greedy and a
    hot request in one batch behave like they ran alone."""
    eng = mk_engine(seed=3)
    hot = Request("hot", np.arange(5), max_new_tokens=10,
                  temperature=0.9, top_k=8)
    cold = Request("cold", np.arange(5), max_new_tokens=10)
    eng.add_request(hot)
    eng.add_request(cold)
    while eng.requests:
        eng.step()
    # greedy slot is unaffected by its neighbour's sampling
    assert cold.output == reference_output(np.arange(5), 10)
    # hot slot actually sampled: deterministic given the slot's rng key,
    # and reproducible on an identical engine
    eng2 = mk_engine(seed=3)
    hot2 = Request("hot", np.arange(5), max_new_tokens=10,
                   temperature=0.9, top_k=8)
    cold2 = Request("cold", np.arange(5), max_new_tokens=10)
    eng2.add_request(hot2)
    eng2.add_request(cold2)
    while eng2.requests:
        eng2.step()
    assert hot.output == hot2.output


# -- acceptance (a): heterogeneous fleet, sensitivity routing ----------------

def test_fleet_serves_mixed_sensitivity_respecting_attestation():
    """3-engine heterogeneous fleet (one unattested MCU) serves >= 8
    mixed-sensitivity requests to completion; confidential requests are
    never routed to the unattested engine -- across their whole placement
    history -- and all outputs are bit-identical to solo references."""
    fleet = mk_fleet(slots=3)
    rng = np.random.default_rng(0)
    sens = ["public", "personal", "confidential"]
    reqs = [Request(f"r{i}", rng.integers(5, CFG.vocab_size, 5),
                    max_new_tokens=8, sensitivity=sens[i % 3])
            for i in range(9)]
    outs = fleet.run(reqs)

    assert len(outs) == 9
    for r in reqs:
        assert len(outs[r.rid]) == 8
        assert outs[r.rid] == reference_output(r.prompt, 8)
        history = fleet.placements[r.rid]
        assert history, r.rid
        if r.sensitivity != "public":
            assert "mcu" not in history, (r.rid, history)
    # the unattested engine still earns its keep on public traffic
    summary = fleet.telemetry.summary()
    assert summary["fleet"]["tokens"] == 9 * 8
    assert summary["fleet"]["p99"] >= summary["fleet"]["p50"] > 0


def test_router_leaves_confidential_queued_when_no_attested_capacity():
    """Backpressure instead of policy violation: if only the unattested
    engine has free slots, confidential work stays queued."""
    fleet = mk_fleet(profiles=[("edge", EDGE), ("mcu", MCU)], slots=1)
    fleet.submit(Request("fill", np.arange(4), max_new_tokens=20,
                         sensitivity="personal"))
    fleet.step()                      # fill occupies the attested engine
    conf = Request("conf", np.arange(4), max_new_tokens=4,
                   sensitivity="confidential")
    pub = Request("pub", np.arange(4), max_new_tokens=4)
    fleet.submit(conf)
    fleet.submit(pub)
    fleet.step()
    assert fleet.placement_of("pub") == "mcu"
    assert fleet.placement_of("conf") is None          # still queued
    assert any(r.rid == "conf" for r, _ in fleet.queue)
    outs = fleet.run()                # frees edge -> conf lands there
    assert fleet.placements["conf"] == ["edge"]
    assert len(outs["conf"]) == 4


def test_admission_control_backpressure():
    fleet = mk_fleet(slots=2, queue_limit=4)
    accepted = [fleet.submit(Request(f"r{i}", np.arange(4),
                                     max_new_tokens=4))
                for i in range(7)]
    assert accepted == [True] * 4 + [False] * 3
    assert fleet.telemetry.rejected == 3
    outs = fleet.run()
    assert len(outs) == 4


# -- acceptance (b): failure mid-decode, bit-identical resume ----------------

def test_engine_failure_replaces_inflight_bit_identically():
    """Kill the busiest engine mid-decode; the balancer re-places its
    in-flight requests on the survivors from shadow checkpoints and
    greedy outputs resume bit-identically; telemetry records it all."""
    edge2 = DeviceProfile("edge2", peak_flops=20e12, hbm_bw=300e9)
    fleet = mk_fleet(profiles=[("edge", EDGE), ("edge2", edge2),
                               ("cloud", CLOUD)])
    rng = np.random.default_rng(1)
    reqs = [Request(f"r{i}", rng.integers(5, CFG.vocab_size, 6),
                    max_new_tokens=16) for i in range(9)]
    for r in reqs:
        assert fleet.submit(r)
    for _ in range(5):
        fleet.step()                  # everyone is mid-decode now

    victim = max(fleet.handles,
                 key=lambda n: len(fleet.handles[n].engine.requests))
    moved = [rid for rid, (_, h, _) in fleet.inflight.items() if h == victim]
    assert moved, "victim must hold in-flight work"
    fleet.fail(victim)
    outs = fleet.run()

    assert len(outs) == 9
    for r in reqs:
        assert outs[r.rid] == reference_output(r.prompt, 16), r.rid
    # telemetry: the failure and every re-placement are on record
    tel = fleet.telemetry
    assert tel.failovers == 1
    assert tel.engines[victim].failed
    migrated_rids = {m.rid for m in tel.migrations}
    assert set(moved) <= migrated_rids
    for m in tel.migrations:
        assert m.src == victim and m.dst != victim
        assert m.reason == "failover"
    # re-placed requests resumed elsewhere (placement history shows it)
    for rid in moved:
        assert fleet.placements[rid][0] == victim
        assert fleet.placements[rid][-1] != victim


def test_drain_live_migrates_over_attested_wire():
    """Planned scale-down: every slot leaves through compression + the
    attested session, and the fabric's sim clock bills the transfer."""
    fleet = mk_fleet(profiles=[("edge", EDGE), ("cloud", CLOUD)])
    reqs = [Request(f"r{i}", np.arange(4 + i), max_new_tokens=12,
                    temperature=0.8, top_k=8) for i in range(4)]
    for r in reqs:
        fleet.submit(r)
    for _ in range(4):
        fleet.step()
    loaded = max(fleet.handles,
                 key=lambda n: len(fleet.handles[n].engine.requests))
    n_inflight = len(fleet.handles[loaded].engine.requests)
    assert n_inflight > 0
    assert fleet.drain(loaded) == n_inflight
    assert not fleet.handles[loaded].engine.requests
    assert fleet.fabric.clock() > 0           # wire time was billed
    outs = fleet.run()
    assert len(outs) == 4 and all(len(v) == 12 for v in outs.values())
    assert all(m.reason == "drain" and m.wire_bytes > 0
               for m in fleet.telemetry.migrations)


def test_load_rebalance_moves_request_off_hot_engine():
    edge2 = DeviceProfile("edge2", peak_flops=25e12, hbm_bw=400e9)
    handles = [EngineHandle("a", mk_engine(seed=0), EDGE),
               EngineHandle("b", mk_engine(seed=1), edge2)]
    fleet = FleetController(handles, authority=TrustAuthority(),
                            balancer=Rebalancer(imbalance_threshold=0.4),
                            rebalance_every=1)
    # force-load engine a directly, then let the balancer smooth it
    for i in range(3):
        handles[0].engine.add_request(
            Request(f"r{i}", np.arange(4), max_new_tokens=24))
        fleet.reassign(handles[0].engine.requests[i], "a")
    fleet.step()
    assert any(m.reason == "rebalance" for m in fleet.telemetry.migrations)
    loads = {n: h.load for n, h in fleet.handles.items()}
    assert abs(loads["a"] - loads["b"]) <= 0.5
    outs = fleet.run()
    assert len(outs) == 3


# -- telemetry unit ----------------------------------------------------------

def test_percentile_nearest_rank():
    xs = list(map(float, range(1, 101)))
    assert percentile(xs, 50) == 50.0
    assert percentile(xs, 99) == 99.0
    assert percentile([], 50) == 0.0
    assert percentile([3.0], 95) == 3.0


def test_failure_before_first_sync_restarts_from_prompt():
    """With shadow sync effectively disabled, a failure loses decode
    progress but not requests: they restart from their prompts on the
    survivors and (greedy) still produce the reference output."""
    fleet = mk_fleet(profiles=[("edge", EDGE), ("cloud", CLOUD)],
                     balancer=Rebalancer(sync_every=10 ** 9))
    reqs = [Request(f"r{i}", np.arange(5 + i), max_new_tokens=10)
            for i in range(4)]
    for r in reqs:
        fleet.submit(r)
    for _ in range(3):
        fleet.step()
    victim = max(fleet.handles,
                 key=lambda n: len(fleet.handles[n].engine.requests))
    fleet.fail(victim)
    outs = fleet.run()
    assert len(outs) == 4
    for r in reqs:
        assert outs[r.rid] == reference_output(r.prompt, 10), r.rid


def test_run_terminates_when_no_eligible_engine_exists():
    """Liveness: a fleet with no attested engine stalls cleanly on
    confidential work instead of spinning forever."""
    fleet = mk_fleet(profiles=[("mcu", MCU)], slots=2)
    conf = Request("conf", np.arange(4), max_new_tokens=4,
                   sensitivity="confidential")
    pub = Request("pub", np.arange(4), max_new_tokens=4)
    outs = fleet.run([conf, pub], max_steps=50)
    assert outs.get("pub") is not None and len(outs["pub"]) == 4
    assert "conf" not in outs
    assert fleet.stalled == ["conf"]


def test_run_terminates_when_failover_orphans_are_unplaceable():
    """Liveness after failure: the only attested engine dies holding a
    confidential request; the snapshot is orphaned (nowhere eligible to
    go) and run() must stall out, naming the orphan, not spin."""
    fleet = mk_fleet(profiles=[("edge", EDGE), ("mcu", MCU)], slots=2)
    conf = Request("conf", np.arange(4), max_new_tokens=30,
                   sensitivity="confidential")
    fleet.submit(conf)
    for _ in range(3):
        fleet.step()
    assert fleet.placement_of("conf") == "edge"
    fleet.fail("edge")
    outs = fleet.run(max_steps=50)
    assert "conf" not in outs
    assert fleet.stalled == ["conf"]
    assert len(fleet.orphans) == 1

# -- the fleet tests of tests/test_prefix_cache.py -----------------------

def test_router_affinity_prefers_warm_engine():
    from repro_torch.core.daemon import EDGE
    from repro_torch.fleet import EngineHandle
    from repro_torch.fleet.router import Router

    cold, warm = mk_paged(seed=1, rows=2), mk_paged(seed=2, rows=2)
    prompt = np.arange(2, 18)            # 2 full pages
    drain(warm, [mk_req("seed", prompt, max_new=1)])
    handles = [EngineHandle("cold", cold, EDGE),
               EngineHandle("warm", warm, EDGE)]
    dec = Router().route(handles, CFG, sensitivity="public",
                         prefill_tokens=len(prompt), decode_tokens=4,
                         tokens=prompt, tenant="")
    assert dec.target == "warm" and dec.prefix_hit == 16
    assert dec.to_attrs()["route_prefix_hit"] == 16


def test_fleet_harvests_prefix_counters():
    from repro_torch.core.attestation import TrustAuthority
    from repro_torch.core.daemon import EDGE
    from repro_torch.fleet import EngineHandle, FleetController, RequestSpec

    fleet = FleetController(
        [EngineHandle("solo", mk_paged(seed=3, rows=2), EDGE)],
        authority=TrustAuthority())
    prompt = np.arange(2, 18)
    for i in range(2):
        t = fleet.submit(RequestSpec(rid=f"s{i}", prompt=prompt,
                                     max_new_tokens=2, tenant="ada"))
        while not t.done:
            fleet.step()
    tel = fleet.telemetry
    assert tel.prefix_hits == 1 and tel.prefix_misses == 1
    assert tel.prefix_bytes_saved > 0
    s = tel.summary()["prefix"]
    assert s["hit_rate"] == 0.5
    text = tel.prometheus_text()
    assert "fleet_prefix_hits_total 1" in text
    assert "fleet_prefix_misses_total 1" in text
    assert "fleet_prefix_bytes_saved_total" in text


def test_route_hashes_prompt_blocks_exactly_once_per_call():
    """The route-time rehash fix: probing N candidate engines for
    cached-prefix affinity must hash the prompt's blocks ONCE per
    ``route()`` (HashedPrefix memoizes per namespace/page_size), not
    once per engine -- counted by monkeypatching the chain hash."""
    from repro_torch.core.daemon import EDGE
    from repro_torch.fleet import EngineHandle
    from repro_torch.fleet.router import Router
    from repro_torch.serving import prefix_cache as pc

    engines = [mk_paged(seed=10 + i, rows=2) for i in range(3)]
    prompt = np.arange(2, 18)            # 2 full blocks at page_size=8
    drain(engines[-1], [mk_req("seed", prompt, max_new=1)])
    handles = [EngineHandle(f"e{i}", eng, EDGE)
               for i, eng in enumerate(engines)]
    calls = []
    real = pc._child_key

    def counting(parent_key, block):
        calls.append(parent_key)
        return real(parent_key, block)

    pc._child_key = counting
    try:
        dec = Router().route(handles, CFG, sensitivity="public",
                             prefill_tokens=len(prompt), decode_tokens=4,
                             tokens=prompt, tenant="")
    finally:
        pc._child_key = real
    assert dec.target == "e2" and dec.prefix_hit == 16
    # one hashing pass: 2 full blocks -> exactly 2 digests, regardless
    # of the 3 engines probed (the legacy per-engine probe did 6)
    assert len(calls) == 2, calls




# -- the same stream through both packages -----------------------------------

SENS = ("public", "personal", "confidential")


def _conserved(S, fleet):
    (assert_conserved if S.side == "torch" else helpers.assert_conserved)(
        fleet)


def _mixed_stream(S, event):
    """Nine mixed-sensitivity greedy requests over a heterogeneous
    fleet on a SimClock, with ``event`` ("fail" or "drain") hitting the
    busiest engine after three steps; conservation holds after every
    step.  Returns (record, prompts)."""
    clk = S.SimClock()
    # slots=3: a JAX dense engine with as many slots as the model has
    # repeats (2 here) masks whole layers (ROADMAP, reference behaviours)
    handles = [S.EngineHandle(n, S.engine(seed=i, slots=3, max_len=64), p)
               for i, (n, p) in enumerate([("edge", S.EDGE),
                                           ("cloud", S.CLOUD),
                                           ("mcu", S.MCU)])]
    fleet = S.FleetController(handles, authority=S.TrustAuthority(),
                              clock=clk)
    rng = np.random.default_rng(3)
    prompts = {}
    for i in range(9):
        p = rng.integers(5, S.cfg.vocab_size, 5 + i % 3)
        prompts[f"r{i}"] = p
        fleet.submit(S.RequestSpec(rid=f"r{i}", prompt=p, max_new_tokens=8,
                                   sensitivity=SENS[i % 3]))
    for step in range(60):
        if step == 3:
            busiest = max(fleet.handles, key=lambda n: len(
                fleet.handles[n].engine.requests))
            getattr(fleet, event)(busiest)
        fleet.step()
        clk.advance(0.01)
        _conserved(S, fleet)
        if all(t.done for t in fleet.tickets.values()):
            break
    return fleet_record(fleet), prompts


@pytest.mark.parametrize("event", ["fail", "drain"])
def test_fleet_decisions_and_tokens_match_jax(event):
    recs = {side: _mixed_stream(fleet_side(side, "float32"), event)
            for side in ("jax", "torch")}
    (jrec, prompts), (trec, _) = recs["jax"], recs["torch"]
    jout, tout = jrec.pop("outputs"), trec.pop("outputs")
    for key in jrec:
        assert trec[key] == jrec[key], key
    assert all(s[-1] == "done" for s in trec["states"].values())
    assert any(m[4] in ("failover", "drain") for m in trec["migrations"])
    jcfg, jp = fleet_weights("float32")["jax"]["full"]
    rate, gaps = greedy_agreement(jout, tout, prompts, jcfg, jp)
    assert rate == 1.0 or all(g < GAP_TOL for g in gaps.values()), \
        (rate, gaps)


def _warm_fleet(S):
    """A one-engine paged fleet with a prefix cache after a 16-token
    donor: the pool has 4 free pages and the donor's two blocks cached
    at refcount 0 (``tests/test_torch_prefix_cache.py``'s probe)."""
    eng = S.paged(seed=0, page_size=8, rows=2, max_len=64, pages=6,
                  prefix_cache=True)
    fleet = S.FleetController([S.EngineHandle("p", eng, S.EDGE)],
                              authority=S.TrustAuthority(),
                              clock=S.SimClock())
    t = fleet.submit(S.RequestSpec(rid="donor", prompt=np.arange(2, 18),
                                   max_new_tokens=1))
    while not t.done:
        fleet.step()
    return fleet, eng


def test_router_gate_counts_a_matched_chain_twice():
    """``can_admit(56, cached_tokens=16)`` says yes in both packages: the
    two cached pages are discounted from the reservation and still
    counted as evictable.  The JAX engine then admits by evicting its
    own matched chain (a page mapped twice; ROADMAP Queue 3) and the
    fleet serves the request.  The port's engine refuses, and its fleet
    keeps the request queued instead of asserting: ``run`` reports it
    stalled, with conservation intact."""
    jfleet, jeng = _warm_fleet(fleet_side("jax"))
    fleet, eng = _warm_fleet(fleet_side("torch"))
    for e in (jeng, eng):
        assert e.allocator.free_pages == 4
        assert e.can_admit(56, cached_tokens=16)
    spec = lambda S: S.RequestSpec(rid="warm", prompt=np.arange(2, 18),  # noqa
                                   max_new_tokens=40)
    jt = jfleet.submit(spec(fleet_side("jax")))
    jfleet.run()
    assert jt.state.value == "done" and len(jt.output) == 40
    t = fleet.submit(spec(fleet_side("torch")))
    fleet.run(max_steps=20)
    assert fleet.stalled == ["warm"]
    assert t.state.value == "queued"
    assert_conserved(fleet)


def test_fresh_prompt_outside_the_prefill_domain_fails_its_ticket():
    """A 700-token prompt lies outside the prefill domain (over 512, not
    a multiple of 512).  The JAX fleet takes a slot and raises out of
    ``step()`` from the prefill's assert; the port's engine refuses
    before the slot is taken and its fleet fails the ticket with the
    engine's reason, serving the request beside it."""
    sides = {side: fleet_side(side) for side in ("jax", "torch")}
    fleets = {}
    for side, S in sides.items():
        fleets[side] = S.FleetController(
            [S.EngineHandle("e", S.engine(seed=0, slots=3, max_len=1088),
                            S.EDGE)],
            authority=S.TrustAuthority(), clock=S.SimClock())
        for rid, n in (("long", 700), ("ok", 40)):
            fleets[side].submit(S.RequestSpec(rid=rid, max_new_tokens=4,
                                              prompt=np.arange(n) % 400))
    with pytest.raises(AssertionError):
        fleets["jax"].step()
    fleet = fleets["torch"]
    fleet.run()
    long_, ok = fleet.tickets["long"], fleet.tickets["ok"]
    assert long_.state.value == "failed" and "700" in long_.events[-1].reason
    assert ok.state.value == "done" and len(ok.output) == 4
    assert_conserved(fleet)
