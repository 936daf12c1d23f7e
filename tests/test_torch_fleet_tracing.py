"""The port's fleet tracing and metrics on the CPU: counterparts of
every test of ``tests/test_fleet_tracing.py`` (the windowed histogram,
the Prometheus registry, typed event kinds, trace invariants over
random walks, the bounded span store, SLO roll-ups, one connected trace
across a preemption, a speculative hand-off and a link outage, the
summary contract, first-run ``jit:`` spans under a spawn span, the
profile hook, OTLP export), on tiny llama-1.5b with the JAX package's
seed-0 weights bridged.  The parity test holds the span trees of one
stream equal across the two packages."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get  # noqa: E402
from repro_torch.configs.tiny import make_tiny  # noqa: E402
from repro_torch.core.attestation import TrustAuthority  # noqa: E402
from repro_torch.core.channel import NetworkCondition, SimClock  # noqa: E402
from repro_torch.core.daemon import CLOUD, EDGE  # noqa: E402
from repro_torch.core.msgpack_subset import unpackb  # noqa: E402
from repro_torch.fleet import (Autoscaler, EngineHandle,  # noqa: E402
                               EngineTemplate, FleetController,
                               MetricsRegistry, MigrationRecord,
                               QualityEvent, RequestSpec, RequestState,
                               ScaleEvent, ScalePolicy, Tracer,
                               WindowedHistogram, percentile)
from repro_torch.fleet.lifecycle import LifecycleEvent  # noqa: E402
from repro_torch.fleet.telemetry import FleetTelemetry  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from tests import helpers  # noqa: E402
from tests.torch_helpers import (assert_conserved, fleet_record,  # noqa: E402
                                 fleet_side, fleet_weights)

CFG = make_tiny(get("llama-1.5b"))
MAX_LEN = 64


def _params():
    return fleet_weights()["torch"]["full"][1]


def mk_engine(seed=0, slots=1, max_len=MAX_LEN):
    return Engine(CFG, _params(), slots=slots, max_len=max_len, seed=seed,
                  device="cpu")


# -- the windowed histogram: storage bound + the legacy list surface ---------

def test_windowed_histogram_is_list_compatible_and_bounded():
    clk = SimClock()
    h = WindowedHistogram("x_seconds", clock=clk, maxlen=4)
    assert not h and len(h) == 0 and list(h) == []
    assert percentile(h, 50) == 0.0
    h.observe(0.0)
    assert h == [0.0]                 # the telemetry tests' exact idiom
    for v in (1.0, 2.0, 3.0, 4.0):
        h.append(v)                   # legacy list spelling
    # the window dropped the oldest sample; cumulative stats did not
    assert list(h) == [1.0, 2.0, 3.0, 4.0]
    assert h.count == 5 and h.total == 10.0
    assert h[-2:] == [3.0, 4.0]       # slicing returns plain lists
    assert h[0] == 1.0 and bool(h)
    assert percentile(h, 50) == 2.0
    assert h.quantile(100) == 4.0


def test_windowed_histogram_age_trim_on_the_injected_clock():
    clk = SimClock()
    h = WindowedHistogram("y_seconds", clock=clk, maxlen=100, window_s=10.0)
    h.observe(1.0)
    clk.advance(6.0)
    h.observe(2.0)
    clk.advance(6.0)                  # first sample is now 12s old
    h.observe(3.0)
    assert list(h) == [2.0, 3.0]
    assert h.count == 3 and h.total == 6.0


def test_metrics_registry_renders_prometheus_text():
    reg = MetricsRegistry(clock=SimClock())
    c = reg.counter("fleet_rejected_total", "Admissions rejected")
    c.inc()
    c.inc(2, engine="e0")
    g = reg.gauge("engine_up", "liveness")
    g.set(1, engine="e0")
    h = reg.histogram("lat_seconds", "latency")
    for v in (0.1, 0.2, 0.3):
        h.observe(v)
    assert reg.counter("fleet_rejected_total") is c   # get-or-create
    with pytest.raises(AssertionError):
        reg.gauge("fleet_rejected_total")             # kind conflict
    text = reg.render()
    assert "# TYPE fleet_rejected_total counter" in text
    assert 'fleet_rejected_total{engine="e0"} 2' in text
    assert 'engine_up{engine="e0"} 1' in text
    assert "# TYPE lat_seconds summary" in text
    assert 'lat_seconds{quantile="0.5"} 0.2' in text
    assert "lat_seconds_sum 0.6" in text
    assert "lat_seconds_count 3" in text


# -- typed event kinds + the per-rid index -----------------------------------

def test_event_kind_discriminators_replace_duck_typing():
    assert LifecycleEvent.kind == "lifecycle"
    assert ScaleEvent.kind == "scale"
    assert QualityEvent.kind == "quality"
    # the dummy rid ScaleEvent grew for events_of() scans is gone
    assert not hasattr(ScaleEvent(action="spawn", engine="a", reason="",
                                  t=0.0), "rid")
    tel = FleetTelemetry(clock=SimClock())
    tel.record_event(LifecycleEvent(rid="r0", src="", dst="queued", t=0.0))
    tel.record_scale(ScaleEvent(action="spawn", engine="auto0",
                                reason="burst", t=1.0))
    tel.record_quality(QualityEvent(rid="r0", src_tier="full",
                                    dst_tier="lite", direction="down",
                                    reason="saturated", quality=0.6))
    assert [ev.kind for ev in tel.events] == \
        ["lifecycle", "scale", "quality"]
    assert len(tel.scale_events()) == 1
    assert len(tel.quality_events()) == 1
    # events_of serves from the per-rid index and matches a full scan
    assert tel.events_of("r0") == \
        [ev for ev in tel.events if getattr(ev, "rid", None) == "r0"]
    assert tel.events_of("missing") == []


# -- trace invariants: the hand-rolled property harness ----------------------

def _synthetic_walk(seed: int):
    """Drive one randomized batch of synthetic request lifecycles
    through FleetTelemetry+Tracer on a SimClock, mimicking the fleet's
    real recording order (wire_context before the MIGRATING transition,
    MigrationRecord after re-placement)."""
    rng = np.random.default_rng(seed)
    clk = SimClock()
    tel = FleetTelemetry(clock=clk)
    tracer = Tracer(clock=clk)
    tel.attach_tracer(tracer)
    engines = [f"e{i}" for i in range(int(rng.integers(2, 4)))]
    for e in engines:
        tel.note_tier(e, "full")

    def ev(rid, src, dst, engine=None, reason=""):
        tel.record_event(LifecycleEvent(rid=rid, src=src, dst=dst,
                                        reason=reason, engine=engine,
                                        t=clk()))

    for i in range(int(rng.integers(1, 6))):
        rid = f"r{seed}_{i}"
        ev(rid, "", "queued", reason="submitted")
        clk.advance(float(rng.uniform(0.01, 0.1)))
        if rng.random() < 0.1:
            ev(rid, "queued", "expired", reason="deadline")
            continue
        here = str(rng.choice(engines))
        ev(rid, "queued", "prefilling", engine=here)
        clk.advance(float(rng.uniform(0.01, 0.1)))
        ev(rid, "prefilling", "decoding", engine=here)
        for _ in range(int(rng.integers(0, 3))):   # migration hops
            clk.advance(float(rng.uniform(0.01, 0.1)))
            dst = str(rng.choice(engines))
            ctx = tracer.wire_context(rid, src=here)
            ev(rid, "decoding", "migrating", engine=here, reason="move")
            clk.advance(float(rng.uniform(0.01, 0.1)))
            tracer.bind_hop(ctx, dst=dst)
            ev(rid, "migrating", "decoding", engine=dst, reason="resume")
            tel.record_migration(MigrationRecord(
                rid=rid, src=here, dst=dst, reason="move", step=1,
                wire_bytes=int(rng.integers(100, 9000))))
            here = dst
        clk.advance(float(rng.uniform(0.01, 0.1)))
        ev(rid, "decoding",
           str(rng.choice(["done", "cancelled", "halted"])), engine=here)
    return tracer


@pytest.mark.parametrize("seed", range(8))
def test_trace_invariants_over_random_walks(seed):
    tracer = _synthetic_walk(seed)
    tracer.close_open(reason="end of test")
    spans = tracer.spans
    assert spans and tracer.dropped == 0
    by_id = {sp.span_id: sp for sp in spans}
    for sp in spans:
        # every opened span closed, with a sane interval
        assert sp.t_end is not None, sp
        assert sp.t_end >= sp.t_start
        if sp.parent_id is not None:
            parent = by_id[sp.parent_id]
            # parents precede children on the fleet clock and in
            # creation order, and never end before them
            assert parent.t_start <= sp.t_start
            assert parent.span_id < sp.span_id
            assert parent.t_end >= sp.t_end
            # a child belongs to its parent's trace
            assert parent.trace_id == sp.trace_id
    # Chrome export round-trips as valid JSON with every span present
    doc = json.loads(json.dumps(tracer.chrome_trace()))
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == len(spans)
    assert all(e["dur"] >= 0 for e in xs)
    # one thread-name metadata record per distinct track
    names = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert len({e["tid"] for e in names}) == len(names)


def test_tracer_span_store_is_bounded():
    clk = SimClock()
    tracer = Tracer(clock=clk, max_spans=10)
    tel = FleetTelemetry(clock=clk)
    tel.attach_tracer(tracer)
    for i in range(50):
        tel.record_event(LifecycleEvent(rid=f"r{i}", src="",
                                        dst="queued", t=clk()))
        clk.advance(0.01)
    assert len(tracer.spans) == 10
    assert tracer.dropped > 0
    assert json.loads(json.dumps(tracer.chrome_trace()))


# -- per-tier SLO summaries from the audit log -------------------------------

def test_slo_summary_derives_time_at_tier_and_availability():
    clk = SimClock()
    tel = FleetTelemetry(clock=clk)
    tel.note_tier("big", "full")
    tel.note_tier("small", "lite")

    def ev(rid, src, dst, engine=None, t=0.0):
        tel.record_event(LifecycleEvent(rid=rid, src=src, dst=dst,
                                        engine=engine, t=t))

    # r0: serves 1s on full, downshifts, 2s on lite, done at t=4
    ev("r0", "", "queued", t=0.0)
    ev("r0", "queued", "prefilling", engine="big", t=1.0)
    ev("r0", "prefilling", "decoding", engine="big", t=1.0)
    tel.record_quality(QualityEvent(rid="r0", src_tier="full",
                                    dst_tier="lite", direction="down",
                                    reason="link", quality=0.6,
                                    engine="small", t=2.0))
    ev("r0", "decoding", "done", engine="small", t=4.0)
    # r1: full tier, fails at t=3 (submit t=1)
    ev("r1", "", "queued", t=1.0)
    ev("r1", "queued", "prefilling", engine="big", t=1.5)
    ev("r1", "prefilling", "decoding", engine="big", t=1.5)
    ev("r1", "decoding", "failed", engine="big", t=3.0)
    # r2: expires while queued -- touches no tier
    ev("r2", "", "queued", t=0.0)
    ev("r2", "queued", "expired", t=5.0)
    slo = tel.slo_summary()
    assert set(slo) == {"full", "lite"}
    assert slo["full"]["requests"] == 2
    assert slo["full"]["time_at_tier_s"] == pytest.approx(1.0 + 1.5)
    assert slo["full"]["completed"] == 0 and slo["full"]["failed"] == 1
    assert slo["full"]["availability"] == 0.0
    assert slo["lite"]["requests"] == 1
    assert slo["lite"]["time_at_tier_s"] == pytest.approx(2.0)
    assert slo["lite"]["availability"] == 1.0
    # completion latency is submit -> terminal on the finishing tier
    assert slo["lite"]["latency_p50"] == pytest.approx(4.0)
    assert tel.summary()["slo"] == slo


# -- real-fleet end-to-end ---------------------------------------------------

def test_preempted_and_migrated_trace_is_one_connected_tree():
    """Acceptance: a drafting request is preempted (speculative
    hand-off already recorded), parked through ``pack_slot`` with the
    trace context riding the wire format, survives a link outage on its
    original engine, resumes on a THIRD engine, and its exported spans
    form a single connected tree spanning >= 2 engines."""
    clk = SimClock()
    handles = [
        EngineHandle("edge", mk_engine(seed=0, slots=1), EDGE),
        EngineHandle("cloud", mk_engine(seed=1, slots=1, max_len=96),
                     CLOUD),
        EngineHandle("alt", mk_engine(seed=2, slots=1), EDGE),
    ]
    fleet = FleetController(handles, authority=TrustAuthority(),
                            spec_tiers={"edge": "cloud"},
                            spec_options={"gamma": 4}, clock=clk)
    low = fleet.submit(RequestSpec(prompt=np.arange(6), rid="low",
                                   max_new_tokens=10, priority=0))
    clk.advance(0.01)
    for _ in range(2):
        fleet.step()
        clk.advance(0.01)
    assert low.state is RequestState.DRAFTING     # speculative hand-off
    # alt is busy, so the preemptor parks low off edge
    blocker = fleet.submit(RequestSpec(prompt=np.arange(4), rid="blocker",
                                       max_new_tokens=12, priority=5))
    fleet.step()
    clk.advance(0.01)
    high = fleet.submit(RequestSpec(prompt=np.arange(5), rid="high",
                                    max_new_tokens=6, priority=10))
    fleet.step()
    clk.advance(0.01)
    assert low.state is RequestState.MIGRATING
    # the parked blob carries the trace context in the pack_slot meta
    (item,) = fleet.queue.parked()
    wire_meta = unpackb(item.blob)["meta"]
    assert wire_meta["trace"]["trace_id"] == "low"
    # injected link outage: edge becomes unreachable, the resume must
    # land elsewhere
    fleet.set_link("edge", NetworkCondition(up=False))
    assert len(high.result()) == 6
    assert len(blocker.result()) == 12
    out = low.result()
    assert len(out) == 10 and low.state is RequestState.DONE
    assert fleet.placements["low"][-1] == "alt"

    # ticket timeline reads the same spans
    spans = low.timeline()
    assert spans and all(sp.trace_id == "low" for sp in spans)
    by_id = {sp.span_id: sp for sp in spans}
    roots = [sp for sp in spans if sp.parent_id is None]
    assert len(roots) == 1 and roots[0].kind == "request"
    for sp in spans:                  # single connected tree
        assert sp.t_end is not None
        if sp.parent_id is not None:
            assert by_id[sp.parent_id].trace_id == "low"
    engines = {sp.engine for sp in spans if sp.engine}
    assert {"edge", "alt"} <= engines              # spans >= 2 engines
    # the park hop rode the wire and closed at the alt arrival
    hops = [sp for sp in spans if sp.kind == "hop"]
    wire_hops = [sp for sp in hops if sp.attrs.get("wire")]
    assert wire_hops and wire_hops[-1].attrs["dst"] == "alt"
    assert any(sp.attrs.get("reason") == "speculative" for sp in hops)
    # phase names cover the request's whole journey
    names = {sp.name for sp in spans}
    assert {"queue_wait", "prefill", "draft", "migrate"} <= names

    doc = json.loads(json.dumps(fleet.tracer.chrome_trace()))
    xs = [e for e in doc["traceEvents"]
          if e["ph"] == "X" and e["args"].get("trace_id") == "low"]
    assert len(xs) == len(spans)
    flows = [e for e in doc["traceEvents"] if e["ph"] in ("s", "f")]
    assert flows, "migration hops must draw flow arrows"


def test_summary_contract_unchanged_and_tracing_optional():
    """The summary() keys bench_fleet.py and the contract tests read
    are unchanged (slo and prefix ride alongside), and tracer=False
    disables tracing cleanly."""
    fleet = FleetController(
        [EngineHandle("e0", mk_engine(seed=0, slots=2), EDGE)],
        authority=TrustAuthority(), tracer=False)
    assert fleet.tracer is None and fleet.telemetry.tracer is None
    outs = fleet.run([Request(f"r{i}", np.arange(4), max_new_tokens=4)
                      for i in range(2)])
    assert len(outs) == 2
    s = fleet.telemetry.summary()
    assert set(s) == {"engines", "fleet", "lifecycle", "slo", "prefix"}
    assert set(s["prefix"]) == {"hits", "misses", "evictions",
                                "bytes_saved", "hit_rate"}
    assert set(s["fleet"]) == {"tokens", "tokens_per_s", "rejected",
                               "failovers", "migrations", "p50", "p95",
                               "p99"}
    assert set(s["lifecycle"]) == {
        "events", "preemptions", "cancelled", "expired", "scale_ups",
        "scale_downs", "downshifts", "upshifts", "queue_wait_p50",
        "preempt_wait_p50"}
    assert set(s["engines"]["e0"]) == {
        "tokens", "steps", "tokens_per_s", "admitted", "completed",
        "migrations_in", "migrations_out", "failed", "retired"}
    assert s["fleet"]["tokens"] == 8
    assert s["fleet"]["p99"] >= s["fleet"]["p50"] > 0
    assert json.dumps(s)              # whole summary stays serializable
    text = fleet.telemetry.prometheus_text()
    assert "fleet_request_latency_seconds_count 2" in text
    assert 'engine_tokens_total{engine="e0",tier="full"} 8' in text


def test_jit_compiles_attribute_to_spawn_spans():
    """An autoscaler spawn opens an engine-lifetime span; the spawned
    engine's first program runs attach as jit child spans and the
    first productive step closes the spawn with its time-to-useful."""
    fleet = FleetController(
        [EngineHandle("base", mk_engine(seed=0, slots=1), EDGE)],
        authority=TrustAuthority(),
        autoscaler=Autoscaler(
            EngineTemplate(name="auto", profile=EDGE, slots=1,
                           max_len=MAX_LEN, seed=100),
            ScalePolicy(min_engines=1, max_engines=2,
                        scale_up_queue_depth=2, cooldown_s=0.0)))
    ts = [fleet.submit(RequestSpec(prompt=np.arange(4), rid=f"r{i}",
                                   max_new_tokens=6)) for i in range(4)]
    while not all(t.done for t in ts):
        fleet.step()
    spawned = [ev.engine for ev in fleet.telemetry.scale_events()
               if ev.action == "spawn"]
    assert spawned, "queue pressure must spawn"
    name = spawned[0]
    spans = fleet.tracer.trace_of(f"engine:{name}")
    spawn = [sp for sp in spans if sp.kind == "spawn"]
    assert len(spawn) == 1
    assert spawn[0].t_end is not None
    assert "time_to_useful_s" in spawn[0].attrs
    assert spawn[0].attrs.get("construct_s", 0) >= 0
    jits = [sp for sp in spans if sp.kind == "jit"]
    assert jits, "spawned engine's program builds must be profiled"
    assert all(sp.parent_id == spawn[0].span_id for sp in jits)
    assert all(sp.attrs["wall_s"] > 0 for sp in jits)
    # warm programs never re-report: one jit span per program key
    keys = [sp.name for sp in jits]
    assert len(keys) == len(set(keys))


def test_engine_profile_hook_fires_once_per_program_key():
    calls = []
    eng = mk_engine(seed=7, slots=1)
    eng.profile_hook = lambda key, dt: calls.append((key, dt))
    req = Request("p", np.arange(4), max_new_tokens=3)
    eng.add_request(req)
    while not req.done:
        eng.step()
    keys = [k for k, _ in calls]
    assert keys == ["prefill[plen=4]", "decode"]
    assert all(dt > 0 for _, dt in calls)
    # same geometry again: both programs are warm, nothing re-reports
    req2 = Request("q", np.arange(4), max_new_tokens=2)
    eng.add_request(req2)
    while not req2.done:
        eng.step()
    assert len(calls) == 2


def test_otlp_export_structure(tmp_path):
    """OTLP-JSON export: one ExportTraceServiceRequest whose spans
    mirror the tracer's store -- resource/scope framing, 32/16-char hex
    ids, parent links resolving within the same trace, nanosecond
    timestamps ordered, and ints carried as strings per the OTLP JSON
    mapping."""
    fleet = FleetController(
        [EngineHandle("edge", mk_engine(seed=0, slots=2), EDGE)],
        authority=TrustAuthority())
    for i in range(2):
        t = fleet.submit(RequestSpec(prompt=np.arange(5), rid=f"r{i}",
                                     max_new_tokens=4))
        while not t.done:
            fleet.step()
    fleet.tracer.close_open(reason="test done")
    out = tmp_path / "otlp.json"
    fleet.tracer.export_otlp(str(out))
    doc = json.loads(out.read_text())
    (rs,) = doc["resourceSpans"]
    res_attrs = {a["key"]: a["value"] for a in rs["resource"]["attributes"]}
    assert res_attrs["service.name"]["stringValue"] == "repro-fleet"
    (ss,) = rs["scopeSpans"]
    assert ss["scope"]["name"] == "repro_torch.fleet.tracing"
    spans = ss["spans"]
    assert len(spans) == len(fleet.tracer.spans)
    by_trace: dict[str, set] = {}
    for sp in spans:
        assert len(sp["traceId"]) == 32 and len(sp["spanId"]) == 16
        assert int(sp["endTimeUnixNano"]) >= int(sp["startTimeUnixNano"])
        by_trace.setdefault(sp["traceId"], set()).add(sp["spanId"])
        for attr in sp["attributes"]:
            v = attr["value"]
            if "intValue" in v:       # OTLP JSON: 64-bit ints as strings
                assert isinstance(v["intValue"], str)
    for sp in spans:                  # parents resolve within the trace
        if "parentSpanId" in sp:
            assert sp["parentSpanId"] in by_trace[sp["traceId"]]
    # both requests produced distinct traces
    assert len(by_trace) >= 2


# -- the same stream through both packages -----------------------------------

def _traced_stream(S):
    """The connected-tree scenario on a SimClock: a speculative pair, a
    preemption that parks a drafting request, a link outage, and the
    resume on a third engine."""
    clk = S.SimClock()
    handles = [
        S.EngineHandle("edge", S.engine(seed=0, slots=1, max_len=64),
                       S.EDGE),
        S.EngineHandle("cloud", S.engine(seed=1, slots=1, max_len=96),
                       S.CLOUD),
        S.EngineHandle("alt", S.engine(seed=2, slots=1, max_len=64),
                       S.EDGE),
    ]
    fleet = S.FleetController(handles, authority=S.TrustAuthority(),
                              spec_tiers={"edge": "cloud"},
                              spec_options={"gamma": 4}, clock=clk)
    check = assert_conserved if S.side == "torch" else \
        helpers.assert_conserved
    sched = {0: ("low", 10, 0), 2: ("blocker", 12, 5), 3: ("high", 6, 10)}
    for step in range(80):
        if step in sched:
            rid, n, prio = sched[step]
            fleet.submit(S.RequestSpec(prompt=np.arange(4, 10), rid=rid,
                                       max_new_tokens=n, priority=prio))
        if step == 4:
            fleet.set_link("edge", S.NetworkCondition(up=False))
        fleet.step()
        clk.advance(0.01)
        check(fleet)
        if step > 4 and all(t.done for t in fleet.tickets.values()):
            break
    fleet.tracer.close_open(reason="end of test")
    return fleet_record(fleet, outputs=False), fleet.tracer.chrome_trace()


def test_span_trees_match_jax():
    (jrec, jdoc), (trec, tdoc) = (_traced_stream(fleet_side(side))
                                  for side in ("jax", "torch"))
    for key in jrec:
        assert trec[key] == jrec[key], key
    assert {k for k, *_ in trec["spans"]} >= {"low", "high", "blocker"}
    kinds = lambda doc: sorted(e["ph"] for e in doc["traceEvents"])  # noqa
    assert kinds(tdoc) == kinds(jdoc)
