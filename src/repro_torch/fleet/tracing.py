"""Fleet-wide distributed tracing + the windowed metrics registry (the
port's copy of the JAX package's ``fleet.tracing``; host Python only).

Two observability surfaces over the machinery the fleet already has:

  * ``Tracer`` -- per-request span trees derived from the unified audit
    log.  Every typed ``LifecycleEvent`` the cluster/balancer/
    speculative controller records becomes a span edge (SUBMIT ->
    QUEUE_WAIT -> PREFILL -> DECODE segments -> MIGRATE hops ->
    DRAFT/VERIFY rounds -> PARK/RESUME -> terminal), so the trace never
    duplicates bookkeeping: ``MigrationRecord`` annotates the hop span
    with wire bytes and lossy/bit-exact, ``QualityEvent`` lands as a
    tier-shift mark, ``ScaleEvent`` opens a spawn span that stays open
    until the new engine's first productive step (time-to-useful, with
    each program's first run -- on the card it includes the kernels'
    ``nvcc`` build at first use -- attributed as a child ``jit:`` span
    via ``Engine.profile_hook``).  Trace context survives migration by
    riding the ``pack_slot`` wire format (``SlotSnapshot.trace``): the
    hop span opened on the donor is the one closed when the destination
    unpacks the blob.
  * ``MetricsRegistry`` -- counters / gauges / windowed-percentile
    histograms on the injectable fleet clock.  ``WindowedHistogram``
    replaces the unbounded latency lists ``FleetTelemetry`` used to
    grow: bounded sample window (count and, optionally, age), cumulative
    count/sum for exposition, and a list-compatible read surface so
    ``percentile(tel.queue_wait_s, 95)`` and window slicing keep
    working.

Exporters: ``Tracer.chrome_trace()`` renders Chrome trace-event JSON
(open the file in Perfetto / chrome://tracing: one track per engine,
flow arrows across migration hops) and ``MetricsRegistry.render()``
emits Prometheus text exposition.

This module deliberately imports nothing from the rest of the fleet
layer: events are consumed duck-typed off their dataclass fields, so
``telemetry``/``lifecycle``/``autoscaler`` can all import from here
without cycles.
"""

from __future__ import annotations

import hashlib
import json
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Optional


def percentile(xs, q: float) -> float:
    """Nearest-rank percentile, rank = ceil(q/100 * N); 0.0 on empty.

    The product is ordered ``q * N / 100`` and nudged before the ceil:
    ``q/100 * N`` picks up float dust for common percentiles (e.g.
    0.95 * 20 == 19.000000000000004, whose ceil lands the p95 of 20
    samples on the *maximum*, one rank off)."""
    ordered = sorted(xs)
    if not ordered:
        return 0.0
    q = min(max(q, 0.0), 100.0)
    n = len(ordered)
    rank = math.ceil(q * n / 100.0 - 1e-9)
    return ordered[max(0, min(n - 1, rank - 1))]


# ---------------------------------------------------------------------------
# the metrics registry
# ---------------------------------------------------------------------------

def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _label_str(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class Counter:
    """Monotonic counter, optionally labelled.  ``inc`` is the live
    path; ``set`` exists for render-time sync of counts whose source of
    truth lives elsewhere (per-engine stats)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._values: dict[tuple, float] = {}
        # service threads and the control plane increment concurrently;
        # read-modify-write on a dict entry is not atomic under threads
        self._vlock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels):
        k = _label_key(labels)
        with self._vlock:
            self._values[k] = self._values.get(k, 0.0) + amount

    def set(self, value: float, **labels):
        with self._vlock:
            self._values[_label_key(labels)] = value

    def get(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    @property
    def value(self) -> float:
        return self._values.get((), 0.0)

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} {self.kind}"]
        for k in sorted(self._values):
            out.append(f"{self.name}{_label_str(k)} "
                       f"{_fmt(self._values[k])}")
        if not self._values:
            out.append(f"{self.name} 0")
        return out


class Gauge(Counter):
    kind = "gauge"


def _fmt(v: float) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if float(v).is_integer():
        return str(int(v))
    return repr(round(float(v), 9))


class WindowedHistogram:
    """Bounded windowed histogram of float samples on the fleet clock.

    Storage is a sliding window (at most ``maxlen`` samples; samples
    older than ``window_s`` on the registry clock are additionally
    evicted when set), plus cumulative ``count``/``total`` that never
    reset -- so percentiles describe *recent* behavior while the
    exposition's _sum/_count stay monotonic.

    The read surface is list-compatible on purpose: the pre-registry
    telemetry kept plain ``list[float]`` attributes and call sites
    slice (``xs[-64:]``), compare (``xs == [0.0]``), measure and
    iterate them; all of that works on the window."""

    kind = "summary"

    def __init__(self, name: str, help: str = "", *, clock=None,
                 maxlen: int = 2048, window_s: Optional[float] = None):
        assert maxlen > 0
        self.name, self.help = name, help
        self._clock = clock or time.perf_counter
        self.maxlen = maxlen
        self.window_s = window_s
        self._t: list[float] = []        # sample timestamps (fleet clock)
        self._x: list[float] = []        # sample values, same order
        self.count = 0                   # cumulative, never trimmed
        self.total = 0.0
        # observe() runs on service threads while the control plane
        # reads percentiles; trim + append must not interleave
        self._hlock = threading.Lock()

    def bind_clock(self, clock):
        self._clock = clock

    def observe(self, x: float, t: Optional[float] = None):
        now = self._clock() if t is None else t
        with self._hlock:
            self._t.append(now)
            self._x.append(float(x))
            self.count += 1
            self.total += float(x)
            self._trim(now)

    append = observe                     # legacy list spelling

    def _trim(self, now: float):
        drop = max(len(self._x) - self.maxlen, 0)
        if self.window_s is not None:
            horizon = now - self.window_s
            while drop < len(self._t) and self._t[drop] < horizon:
                drop += 1
        if drop:
            del self._t[:drop], self._x[:drop]

    def quantile(self, q: float) -> float:
        with self._hlock:
            window = list(self._x)
        return percentile(window, q)

    # -- list-compatible window reads ---------------------------------------
    def __len__(self):
        return len(self._x)

    def __iter__(self):
        return iter(self._x)

    def __getitem__(self, i):
        return self._x[i]

    def __bool__(self):
        return bool(self._x)

    def __eq__(self, other):
        if isinstance(other, WindowedHistogram):
            return self._x == other._x
        if isinstance(other, (list, tuple)):
            return self._x == list(other)
        return NotImplemented

    def __repr__(self):
        return (f"WindowedHistogram({self.name!r}, window={self._x!r}, "
                f"count={self.count})")

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} summary"]
        for q in (0.5, 0.95, 0.99):
            out.append(f'{self.name}{{quantile="{q}"}} '
                       f"{_fmt(self.quantile(q * 100))}")
        out.append(f"{self.name}_sum {_fmt(self.total)}")
        out.append(f"{self.name}_count {self.count}")
        return out


class MetricsRegistry:
    """Name -> instrument, in registration order.  Instruments are
    get-or-create so recording sites never race registration, and the
    whole registry renders as one Prometheus text exposition."""

    def __init__(self, clock=None):
        self._clock = clock or time.perf_counter
        self._instruments: dict[str, object] = {}
        self._rlock = threading.Lock()

    def bind_clock(self, clock):
        self._clock = clock
        for inst in self._instruments.values():
            if isinstance(inst, WindowedHistogram):
                inst.bind_clock(clock)

    def _get(self, cls, name: str, help: str, **kw):
        with self._rlock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, help, **kw)
                self._instruments[name] = inst
        assert isinstance(inst, cls), \
            f"{name!r} already registered as {type(inst).__name__}"
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "", *,
                  maxlen: int = 2048,
                  window_s: Optional[float] = None) -> WindowedHistogram:
        return self._get(WindowedHistogram, name, help,
                         clock=self._clock, maxlen=maxlen,
                         window_s=window_s)

    def render(self) -> str:
        lines = []
        for inst in self._instruments.values():
            lines.extend(inst.render())
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

# lifecycle destination state -> phase span name
_PHASE_OF = {"queued": "queue_wait", "prefilling": "prefill",
             "decoding": "decode", "drafting": "draft",
             "verifying": "verify"}
_TERMINALS = frozenset({"done", "failed", "cancelled", "expired", "halted"})
_PLACED = frozenset({"prefilling", "decoding", "drafting", "verifying"})


@dataclass
class Span:
    """One timed segment of one trace.  ``trace_id`` is the request id
    for request traces and ``engine:<name>`` for engine-lifetime traces
    (spawn / jit builds); phase and hop spans parent to the request's
    root span, jit builds to the engine's open spawn span."""
    trace_id: str
    span_id: int
    name: str                        # queue_wait | prefill | decode | ...
    kind: str                        # request | phase | hop | mark | spawn | jit
    t_start: float
    t_end: Optional[float] = None    # None while the span is open
    parent_id: Optional[int] = None
    engine: str = ""
    tier: str = ""
    attrs: dict = field(default_factory=dict)

    @property
    def open(self) -> bool:
        return self.t_end is None

    def duration(self, now: Optional[float] = None) -> float:
        end = self.t_end if self.t_end is not None else now
        return max((end or self.t_start) - self.t_start, 0.0)

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "name": self.name, "kind": self.kind,
                "t_start": self.t_start, "t_end": self.t_end,
                "parent_id": self.parent_id, "engine": self.engine,
                "tier": self.tier, "attrs": dict(self.attrs)}


def _locked(fn):
    """Run a Tracer entry point under the instance lock (``self._lock``).

    Every decorated method is atomic relative to the others, so a
    compound transition (close phase + open hop, say) can never
    interleave with a concurrent report from an engine thread."""
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)
    wrapper.__name__ = fn.__name__
    wrapper.__qualname__ = fn.__qualname__
    wrapper.__doc__ = fn.__doc__
    return wrapper


class Tracer:
    """Builds span trees by consuming the unified audit log.

    ``FleetTelemetry`` forwards every recorded event here
    (``on_lifecycle`` / ``on_migration`` / ``on_quality`` /
    ``on_scale`` / ``on_engine_step``), so the trace is a pure function
    of the machinery the fleet already runs -- no call site records the
    same fact twice.  The only explicit entry points are the wire-
    context pair (``wire_context`` on the donor / ``bind_hop`` on the
    destination, riding ``pack_slot``'s meta dict) and the engine
    profiling hook (``record_jit``).

    The span store is bounded: past ``max_spans`` new spans are counted
    in ``dropped`` instead of created (already-open spans still close),
    so a long-lived fleet cannot grow the trace without bound.

    Thread safety: in service mode engine threads record steps, jit
    builds and wire hops while the control-plane thread consumes the
    audit log, so every entry point that touches the span store runs
    under one reentrant lock."""

    def __init__(self, clock=None, *, max_spans: int = 200_000):
        self._clock = clock or time.perf_counter
        self._t0 = self._clock()
        self._lock = threading.RLock()
        self.max_spans = max_spans
        self.spans: list[Span] = []
        self.dropped = 0
        self._next_id = 1
        self._roots: dict[str, Span] = {}       # rid -> request root
        self._phase: dict[str, Span] = {}       # rid -> open phase span
        self._hop: dict[str, Span] = {}         # rid -> open migrate hop
        self._last_hop: dict[str, Span] = {}    # rid -> latest hop (closed)
        self._spawn: dict[str, Span] = {}       # engine -> open spawn span
        self.tiers: dict[str, str] = {}         # engine -> tier name

    def bind_clock(self, clock):
        self._clock = clock
        self._t0 = clock()

    def note_tier(self, engine: str, tier: str):
        self.tiers[engine] = tier

    # -- span plumbing -------------------------------------------------------
    def _new(self, trace_id: str, name: str, kind: str, t: float, *,
             parent: Optional[int] = None, engine: str = "",
             **attrs) -> Optional[Span]:
        if len(self.spans) >= self.max_spans:
            self.dropped += 1
            return None
        sp = Span(trace_id=trace_id, span_id=self._next_id, name=name,
                  kind=kind, t_start=t, parent_id=parent, engine=engine,
                  tier=self.tiers.get(engine, ""), attrs=dict(attrs))
        self._next_id += 1
        self.spans.append(sp)
        return sp

    def _root(self, rid: str, t: float) -> Optional[Span]:
        sp = self._roots.get(rid)
        if sp is None:
            sp = self._new(rid, "request", "request", t)
            if sp is not None:
                self._roots[rid] = sp
        return sp

    @staticmethod
    def _close(sp: Optional[Span], t: float, **attrs):
        if sp is not None and sp.t_end is None:
            sp.t_end = max(t, sp.t_start)
            sp.attrs.update(attrs)

    # -- audit-log consumers (called by FleetTelemetry) ----------------------
    @_locked
    def on_lifecycle(self, ev):
        """One typed transition -> one span edge."""
        t, rid, dst = ev.t, ev.rid, ev.dst
        root = self._root(rid, t)
        parent = root.span_id if root is not None else None
        if dst in _TERMINALS:
            self._close(self._phase.pop(rid, None), t, outcome=dst)
            hop = self._hop.pop(rid, None)
            if hop is not None:
                self._close(hop, t, outcome=dst)
                self._last_hop[rid] = hop
            self._close(self._roots.get(rid), t, state=dst,
                        reason=ev.reason)
            return
        if dst == "migrating":
            # departure: the open phase ends, the hop opens on the donor
            # (unless wire_context already opened it pre-pack)
            self._close(self._phase.pop(rid, None), t)
            hop = self._hop.get(rid)
            if hop is None:
                hop = self._new(rid, "migrate", "hop", t, parent=parent,
                                engine=ev.engine or "",
                                src=ev.engine or "", reason=ev.reason)
                if hop is not None:
                    self._hop[rid] = hop
            else:
                hop.attrs.setdefault("reason", ev.reason)
                if ev.engine and not hop.engine:
                    hop.engine = hop.attrs["src"] = ev.engine
                    hop.tier = self.tiers.get(ev.engine, "")
            return
        name = _PHASE_OF.get(dst)
        if name is None:
            return
        if dst in _PLACED:
            # arrival: an open hop closes with its destination recorded
            hop = self._hop.pop(rid, None)
            if hop is not None:
                self._close(hop, t, dst=ev.engine or "")
                self._last_hop[rid] = hop
        self._close(self._phase.pop(rid, None), t)
        sp = self._new(rid, name, "phase", t, parent=parent,
                       engine=ev.engine or "", reason=ev.reason)
        if sp is not None:
            self._phase[rid] = sp

    @_locked
    def on_migration(self, rec):
        """Annotate the request's hop span with the MigrationRecord's
        facts (wire bytes, lossy/bit-exact, src/dst).  A hand-off that
        never passed through MIGRATING (the speculative attach) gets an
        instantaneous hop span so the tree still shows the move."""
        hop = self._hop.get(rec.rid) or self._last_hop.get(rec.rid)
        if hop is None:
            t = self._clock()
            root = self._root(rec.rid, t)
            hop = self._new(rec.rid, "migrate", "hop", t,
                            parent=root.span_id if root else None,
                            engine=rec.src, src=rec.src)
            if hop is None:
                return
            hop.t_end = t
            self._last_hop[rec.rid] = hop
        hop.attrs.update(wire_bytes=rec.wire_bytes, lossy=rec.lossy,
                         dst=rec.dst, step=rec.step)
        if getattr(rec, "suffix_only", False):
            # v3 wire: the shared prefix chain stayed home -- record
            # how many page bytes the hop did not have to ship
            hop.attrs.update(suffix_only=True,
                             prefix_bytes_saved=rec.bytes_saved)
        hop.attrs.setdefault("reason", rec.reason)
        if not hop.attrs.get("src"):
            hop.attrs["src"] = rec.src

    @_locked
    def on_quality(self, ev):
        """A tier down-/upshift lands as an instantaneous mark span."""
        root = self._root(ev.rid, ev.t)
        sp = self._new(ev.rid, f"tier_{ev.direction}shift", "mark", ev.t,
                       parent=root.span_id if root else None,
                       engine=ev.engine, src_tier=ev.src_tier,
                       dst_tier=ev.dst_tier, quality=ev.quality,
                       reason=ev.reason)
        self._close(sp, ev.t)

    @_locked
    def on_scale(self, ev):
        """Spawn opens an engine-lifetime span that stays open until the
        engine's first productive step (time-to-useful); retire closes
        any such span and marks the membership change.  Other actions
        (e.g. "prearm": a warm standby built outside the routable set)
        are instantaneous marks -- they neither open nor close a spawn
        span."""
        trace = f"engine:{ev.engine}"
        if ev.action == "spawn":
            sp = self._new(trace, "spawn", "spawn", ev.t,
                           engine=ev.engine, reason=ev.reason)
            if sp is not None:
                self._spawn[ev.engine] = sp
        elif ev.action == "retire":
            self._close(self._spawn.pop(ev.engine, None), ev.t,
                        note="retired before first token")
            mark = self._new(trace, "retire", "mark", ev.t,
                             engine=ev.engine, reason=ev.reason)
            self._close(mark, ev.t)
        else:
            mark = self._new(trace, ev.action, "mark", ev.t,
                             engine=ev.engine, reason=ev.reason)
            self._close(mark, ev.t)

    @_locked
    def on_engine_step(self, engine: str, tokens: int):
        """First productive step of a spawned engine closes its spawn
        span -- the measured time-to-useful the autoscaler's jit
        recompiles dominate."""
        if tokens > 0 and engine in self._spawn:
            sp = self._spawn.pop(engine)
            t = self._clock()
            self._close(sp, t)
            sp.attrs["time_to_useful_s"] = round(sp.duration(), 6)

    @_locked
    def annotate_spawn(self, engine: str, **attrs):
        sp = self._spawn.get(engine)
        if sp is not None:
            sp.attrs.update(attrs)

    @_locked
    def annotate(self, rid: str, **attrs):
        """Attach attributes to the request's currently-open phase span
        (e.g. the router's decision facts at dispatch)."""
        sp = self._phase.get(rid)
        if sp is not None:
            sp.attrs.update(attrs)

    # -- jit profiling (Engine.profile_hook) ---------------------------------
    @_locked
    def record_jit(self, engine: str, key: str, wall_s: float, *,
                   cache_hit: bool = False):
        """The first run of one program on ``engine`` took ``wall_s``
        real seconds, timed to completion (on the card it includes the
        kernels' ``nvcc`` build when this run was their first use; the
        span keeps the JAX package's ``jit:`` name).  ``cache_hit``
        marks a program another engine already ran through the
        process-wide program cache: the wall is the warm execution --
        time-to-useful spans stay honest about where compile cost was
        (not) paid.  The span is anchored on the fleet clock -- under
        an injected SimClock the wall duration cannot be laid on the
        sim timeline, so the span clamps into its parent and keeps the
        truth in ``wall_s``."""
        now = self._clock()
        parent = self._spawn.get(engine)
        start = now - wall_s
        if parent is not None:
            start = max(start, parent.t_start)
        start = min(max(start, self._t0), now)
        attrs = {"engine": engine, "wall_s": round(wall_s, 6)}
        if cache_hit:
            attrs["cache_hit"] = True
        sp = self._new(f"engine:{engine}", f"jit:{key}", "jit", start,
                       parent=parent.span_id if parent else None, **attrs)
        self._close(sp, now)

    # -- wire context (rides pack_slot's meta dict) --------------------------
    @_locked
    def wire_context(self, rid: str, *, src: str = "") -> Optional[dict]:
        """Trace context for a slot blob about to leave ``src``: the hop
        span opens on the donor *before* the state is packed, and its
        identity travels inside the blob (``SlotSnapshot.trace`` ->
        ``pack_slot`` meta), so whoever unpacks the state -- possibly
        steps later, possibly another engine -- closes this exact
        span."""
        t = self._clock()
        root = self._root(rid, t)
        hop = self._hop.get(rid)
        if hop is None:
            hop = self._new(rid, "migrate", "hop", t,
                            parent=root.span_id if root else None,
                            engine=src, src=src)
            if hop is not None:
                self._hop[rid] = hop
        if hop is None:
            return None
        return {"trace_id": rid, "span_id": hop.span_id}

    @_locked
    def bind_hop(self, ctx: Optional[dict], *, dst: str = ""):
        """Destination side of a wire hop: the unpacked blob named the
        donor-opened span; mark it wire-carried (the arrival transition
        closes it)."""
        if not ctx:
            return
        hop = self._hop.get(ctx.get("trace_id", ""))
        if hop is not None and hop.span_id == ctx.get("span_id"):
            hop.attrs["wire"] = True
            if dst:
                hop.attrs["dst"] = dst

    # -- reads ---------------------------------------------------------------
    @_locked
    def trace_of(self, rid: str) -> list[Span]:
        return [sp for sp in self.spans if sp.trace_id == rid]

    @_locked
    def open_spans(self) -> list[Span]:
        return [sp for sp in self.spans if sp.open]

    @_locked
    def close_open(self, *, reason: str = "shutdown"):
        """Close every dangling span (end of run / export time)."""
        t = self._clock()
        for store in (self._phase, self._hop, self._spawn):
            for sp in store.values():
                self._close(sp, t, closed_by=reason)
            store.clear()
        for sp in self._roots.values():
            self._close(sp, t, closed_by=reason)

    # -- exporters -----------------------------------------------------------
    @_locked
    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON (the dict; ``export_chrome`` writes
        it).  One track (tid) per engine plus a ``fleet`` track for
        off-engine time (queue wait, parked hops); migration hops with
        a known destination additionally emit flow arrows src -> dst so
        Perfetto draws the request's journey across tracks."""
        events: list[dict] = []
        tracks: dict[str, int] = {}

        def tid(track: str) -> int:
            if track not in tracks:
                tracks[track] = len(tracks)
                events.append({"ph": "M", "pid": 0, "tid": tracks[track],
                               "name": "thread_name",
                               "args": {"name": track}})
            return tracks[track]

        tid("fleet")
        now = self._clock()
        for sp in self.spans:
            ts = round((sp.t_start - self._t0) * 1e6, 3)
            dur = round(sp.duration(now) * 1e6, 3)
            args = {"trace_id": sp.trace_id, "span_id": sp.span_id,
                    **({"parent_id": sp.parent_id}
                       if sp.parent_id is not None else {}),
                    **({"engine": sp.engine} if sp.engine else {}),
                    **({"tier": sp.tier} if sp.tier else {}),
                    **sp.attrs}
            events.append({"name": sp.name, "cat": sp.kind, "ph": "X",
                           "pid": 0, "tid": tid(sp.engine or "fleet"),
                           "ts": ts, "dur": dur, "args": args})
            if sp.kind == "hop" and sp.attrs.get("dst") \
                    and not sp.open:
                src_track = sp.attrs.get("src") or sp.engine or "fleet"
                flow = {"name": "migrate", "cat": "hop", "pid": 0,
                        "id": sp.span_id}
                events.append({**flow, "ph": "s", "tid": tid(src_track),
                               "ts": ts})
                events.append({**flow, "ph": "f", "bp": "e",
                               "tid": tid(sp.attrs["dst"]),
                               "ts": round(ts + dur, 3)})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped_spans": self.dropped,
                              "spans": len(self.spans)}}

    def export_chrome(self, path: str):
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    @_locked
    def otlp_trace(self) -> dict:
        """OTLP/JSON ``ExportTraceServiceRequest`` (the dict;
        ``export_otlp`` writes it) -- the spans in the standard
        OpenTelemetry wire shape, ingestible by any OTLP-JSON collector.

        Ids: OTLP wants 16-byte trace ids and 8-byte span ids in hex.
        Trace ids here are strings ("r3", "engine:edge"), so they are
        hashed to 32 hex chars (stable across exports); span ids are the
        tracer's integer ids, zero-padded to 16.  Timestamps are
        *run-relative* nanoseconds (the fleet clock is injectable and
        often starts at 0 in tests/benches): subtract nothing, compare
        within one export."""
        def trace_hex(tid: str) -> str:
            return hashlib.blake2b(tid.encode(),
                                   digest_size=16).hexdigest()

        def span_hex(sid: int) -> str:
            return f"{sid & (2 ** 64 - 1):016x}"

        def attr(k, v):
            if isinstance(v, bool):
                val = {"boolValue": v}
            elif isinstance(v, int):
                val = {"intValue": str(v)}       # OTLP JSON: int64 as str
            elif isinstance(v, float):
                val = {"doubleValue": v}
            else:
                val = {"stringValue": str(v)}
            return {"key": k, "value": val}

        def nanos(t: float) -> str:
            return str(max(int(round((t - self._t0) * 1e9)), 0))

        now = self._clock()
        otlp_spans = []
        for sp in self.spans:
            t_end = sp.t_end if sp.t_end is not None else now
            attrs = [attr("kind", sp.kind)]
            if sp.engine:
                attrs.append(attr("engine", sp.engine))
            if sp.tier:
                attrs.append(attr("tier", sp.tier))
            attrs += [attr(k, v) for k, v in sp.attrs.items()]
            one = {
                "traceId": trace_hex(sp.trace_id),
                "spanId": span_hex(sp.span_id),
                "name": sp.name,
                "kind": 1,           # SPAN_KIND_INTERNAL
                "startTimeUnixNano": nanos(sp.t_start),
                "endTimeUnixNano": nanos(t_end),
                "attributes": attrs,
            }
            if sp.parent_id is not None:
                one["parentSpanId"] = span_hex(sp.parent_id)
            otlp_spans.append(one)
        return {"resourceSpans": [{
            "resource": {"attributes": [
                attr("service.name", "repro-fleet"),
                attr("repro.dropped_spans", self.dropped),
            ]},
            "scopeSpans": [{
                "scope": {"name": "repro_torch.fleet.tracing"},
                "spans": otlp_spans,
            }],
        }]}

    def export_otlp(self, path: str):
        with open(path, "w") as f:
            json.dump(self.otlp_trace(), f)
