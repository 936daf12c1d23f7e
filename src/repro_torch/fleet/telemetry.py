"""Fleet observability: per-engine and fleet-wide counters.

Everything the balancer and the operator need to see: tokens/s per
engine and aggregate, request-completion latency percentiles
(p50/p95/p99), admission rejections (backpressure), queue-wait and
preemption-park latencies, a full audit log of per-request live
migrations (who moved, from where, to where, why), and the unified
event log: every typed ``RequestTicket`` transition (recorded by
cluster, balancer and speculative controller alike), every
``ScaleEvent`` membership change, and every ``QualityEvent`` tier
down-/upshift -- one chronological read explains a request's whole
fidelity and placement history.

Storage is the ``tracing.MetricsRegistry``: the latency series are
bounded ``WindowedHistogram`` windows (list-compatible, so existing
slicing/percentile call sites keep working) instead of unbounded
Python lists, and ``prometheus_text()`` renders the whole registry as
a text exposition.  When a ``Tracer`` is attached every recorded fact
is forwarded to it, so per-request span trees are derived from this
audit log rather than from duplicate call sites.

All timing reads go through an injectable clock (any zero-arg float
callable; ``channel.SimClock`` qualifies) so latency accounting and
deadline expiry are deterministic under test.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import ClassVar, Optional

from .tracing import MetricsRegistry, Tracer, percentile

__all__ = ["EngineStats", "MigrationRecord", "QualityEvent",
           "FleetTelemetry", "percentile"]


@dataclass
class EngineStats:
    name: str
    tokens: int = 0                  # tokens emitted
    steps: int = 0                   # decode steps executed
    busy_s: float = 0.0              # wall time inside engine.step()
    admitted: int = 0                # requests placed here
    completed: int = 0
    migrations_in: int = 0
    migrations_out: int = 0
    failed: bool = False
    retired: bool = False            # scaled down (drained + removed)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.busy_s if self.busy_s > 0 else 0.0


@dataclass
class MigrationRecord:
    rid: str
    src: str
    dst: str
    reason: str                      # "failover" | "drain" | "rebalance"
    step: int                        # donor step_count at extraction
    wire_bytes: int = 0
    lossy: bool = False              # cross-tier re-prefill (no cache rows)
    suffix_only: bool = False        # v3 wire: shared prefix stayed home
    bytes_saved: int = 0             # uncompressed page bytes not shipped


@dataclass
class QualityEvent:
    """One quality-tier change of one request on the unified audit log:
    a *downshift* (routed/migrated to a lower tier because the preferred
    tier was saturated, would miss the deadline, or its link was down)
    or an *upshift* (migrated back up once the better tier had room).
    Interleaved with ``LifecycleEvent``/``ScaleEvent`` entries, so one
    chronological read shows why a request's fidelity changed."""
    kind: ClassVar[str] = "quality"  # audit-log discriminator
    rid: str
    src_tier: str                    # tier left (or preferred-but-denied)
    dst_tier: str
    direction: str                   # "down" | "up"
    reason: str
    quality: float                   # dst tier quality in [0,1]
    engine: str = ""                 # engine serving the request now
    t: float = 0.0                   # fleet clock at the change


_TERMINAL = frozenset({"done", "failed", "cancelled", "expired", "halted"})
_SERVING = frozenset({"prefilling", "decoding", "drafting", "verifying"})


class FleetTelemetry:
    def __init__(self, clock=None):
        self._clock = clock or time.perf_counter
        # concurrent engine services record from their own threads; one
        # reentrant lock serializes every append to the audit log, the
        # per-rid index, per-engine stats and the scalar counters
        self._tlock = threading.RLock()
        self.engines: dict[str, EngineStats] = {}
        self.migrations: list[MigrationRecord] = []
        self.events: list = []           # unified audit log
        self._by_rid: dict[str, list] = {}   # rid -> its audit entries
        self.tiers: dict[str, str] = {}      # engine name -> tier name
        self.tracer: Optional[Tracer] = None
        self.metrics = MetricsRegistry(clock=self._clock)
        self.request_latency_s = self.metrics.histogram(
            "fleet_request_latency_seconds",
            "Completion latency per finished request")
        self.step_latency_s = self.metrics.histogram(
            "fleet_step_latency_seconds",
            "Wall time per fleet decode step", maxlen=4096)
        self.queue_wait_s = self.metrics.histogram(
            "fleet_queue_wait_seconds",
            "Admission queue wait per dispatched request")
        self.preempt_wait_s = self.metrics.histogram(
            "fleet_preempt_wait_seconds",
            "Park -> resume latency per preempted request")
        self.rejected = 0
        self.floor_rejects = 0
        self.failovers = 0
        self.heartbeat_losses = 0
        self.preemptions = 0
        self.cancelled = 0
        self.expired = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.downshifts = 0
        self.upshifts = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_evictions = 0
        self.prefix_bytes_saved = 0
        self._t0 = self._clock()

    def bind_clock(self, clock):
        """Adopt the fleet's injected clock so every timing read shares
        one time base; re-anchors the tokens/s window."""
        self._clock = clock
        self._t0 = clock()
        self.metrics.bind_clock(clock)
        if self.tracer is not None:
            self.tracer.bind_clock(clock)

    def attach_tracer(self, tracer: Optional[Tracer]):
        """Forward every subsequently recorded fact to ``tracer`` so it
        can derive span trees from the audit log."""
        self.tracer = tracer
        if tracer is not None:
            for eng, tier in self.tiers.items():
                tracer.note_tier(eng, tier)

    def note_tier(self, engine: str, tier: str):
        """Engine -> quality-tier binding (for SLO attribution and span
        tier attributes)."""
        self.tiers[engine] = tier
        if self.tracer is not None:
            self.tracer.note_tier(engine, tier)

    def stats(self, name: str) -> EngineStats:
        with self._tlock:
            if name not in self.engines:
                self.engines[name] = EngineStats(name)
            return self.engines[name]

    # -- recording ----------------------------------------------------------
    def record_step(self, name: str, tokens: int, dt: float):
        with self._tlock:
            s = self.stats(name)
            s.steps += 1
            s.tokens += tokens
            s.busy_s += dt
        self.step_latency_s.observe(dt)
        if self.tracer is not None:
            self.tracer.on_engine_step(name, tokens)

    def record_admit(self, name: str):
        with self._tlock:
            self.stats(name).admitted += 1

    def record_reject(self):
        with self._tlock:
            self.rejected += 1

    def record_complete(self, name: str, latency_s: float):
        with self._tlock:
            self.stats(name).completed += 1
        self.request_latency_s.observe(latency_s)

    def record_migration(self, rec: MigrationRecord):
        with self._tlock:
            self.migrations.append(rec)
            self.stats(rec.src).migrations_out += 1
            self.stats(rec.dst).migrations_in += 1
        if self.tracer is not None:
            self.tracer.on_migration(rec)

    def record_failure(self, name: str):
        with self._tlock:
            self.stats(name).failed = True
            self.failovers += 1

    def _log(self, ev):
        with self._tlock:
            self.events.append(ev)
            rid = getattr(ev, "rid", "")
            if rid:
                self._by_rid.setdefault(rid, []).append(ev)

    def record_event(self, ev):
        """A typed lifecycle transition (LifecycleEvent)."""
        self._log(ev)
        if self.tracer is not None:
            self.tracer.on_lifecycle(ev)

    def record_scale(self, ev):
        """A fleet membership change (ScaleEvent) -- rides the same
        unified audit log as lifecycle transitions, so one chronological
        read shows WHY a request moved (the retire event precedes its
        slots' MIGRATING transitions)."""
        self._log(ev)
        with self._tlock:
            if ev.action == "spawn":
                self.scale_ups += 1
            elif ev.action == "retire":
                self.scale_downs += 1
        # other actions ("prearm") change no membership counter
        if self.tracer is not None:
            self.tracer.on_scale(ev)

    def record_heartbeat_loss(self, ev):
        """A liveness-declared engine failure (bus.HeartbeatLoss): the
        service stopped heartbeating and the fleet clock timed it out.
        Typed on the unified audit log next to the failover transitions
        it triggers."""
        self._log(ev)
        with self._tlock:
            self.heartbeat_losses += 1

    def heartbeat_events(self) -> list:
        return [ev for ev in self.events
                if getattr(ev, "kind", "") == "heartbeat_loss"]

    def scale_events(self) -> list:
        return [ev for ev in self.events
                if getattr(ev, "kind", "") == "scale"]

    def record_quality(self, ev: QualityEvent):
        """A quality-tier change -- same unified audit log, so
        downshifts read in sequence with the lifecycle transitions and
        scale events that caused them."""
        self._log(ev)
        with self._tlock:
            if ev.direction == "down":
                self.downshifts += 1
            else:
                self.upshifts += 1
        if self.tracer is not None:
            self.tracer.on_quality(ev)

    def quality_events(self) -> list:
        return [ev for ev in self.events
                if getattr(ev, "kind", "") == "quality"]

    def record_queue_wait(self, wait_s: float):
        self.queue_wait_s.observe(wait_s)

    def record_preemption(self):
        with self._tlock:
            self.preemptions += 1

    def record_resume(self, wait_s: float):
        self.preempt_wait_s.observe(wait_s)

    def record_cancelled(self):
        with self._tlock:
            self.cancelled += 1

    def record_prefix(self, *, hits: int = 0, misses: int = 0,
                      evictions: int = 0, bytes_saved: int = 0):
        """Prefix-cache deltas harvested from engines (the per-engine
        ``PrefixCache.stats`` are the source of truth; the controller
        feeds the fleet-wide accumulation here so counters survive the
        engine's retirement)."""
        with self._tlock:
            self.prefix_hits += hits
            self.prefix_misses += misses
            self.prefix_evictions += evictions
            self.prefix_bytes_saved += bytes_saved

    def record_expired(self):
        with self._tlock:
            self.expired += 1

    def record_floor_reject(self, ev):
        """A typed quality-floor admission refusal (FloorReject) on the
        unified audit log: the fleet could never field the demanded
        tier, so the request failed fast instead of queueing."""
        self._log(ev)
        with self._tlock:
            self.floor_rejects += 1

    def events_of(self, rid: str) -> list:
        """This request's audit entries, chronological -- served from
        the per-rid index, not a scan of the whole log."""
        with self._tlock:
            return list(self._by_rid.get(rid, ()))

    # -- reading ------------------------------------------------------------
    def fleet_tokens(self) -> int:
        return sum(s.tokens for s in self.engines.values())

    def fleet_tokens_per_s(self) -> float:
        dt = self._clock() - self._t0
        return self.fleet_tokens() / dt if dt > 0 else 0.0

    def latency_percentiles(self) -> dict[str, float]:
        xs = self.request_latency_s
        return {"p50": percentile(xs, 50), "p95": percentile(xs, 95),
                "p99": percentile(xs, 99)}

    def slo_summary(self) -> dict:
        """Per-tier SLO roll-up derived from the audit log.

        Each request's serving time is split into time-at-tier segments:
        a segment opens when the request enters a serving state on an
        engine (tier looked up via ``note_tier``) and the tier changes
        thereafter only at ``QualityEvent`` boundaries; the segment
        closes at the next change or the terminal transition.  A
        request that never reached a serving engine (rejected at the
        queue, expired while queued) touches no tier and is excluded.

        Per tier: requests that spent time there, total time-at-tier,
        completions/terminal dispositions *attributed to the tier the
        request finished on*, availability = done / (done + failed +
        expired + halted) -- cancellations are operator-initiated and
        excluded -- and completion-latency percentiles (submit ->
        terminal) over the requests that finished on that tier."""
        per_tier: dict[str, dict] = {}

        def tier_bucket(tier: str) -> dict:
            if tier not in per_tier:
                per_tier[tier] = {"requests": 0, "time_at_tier_s": 0.0,
                                  "done": 0, "failed": 0, "expired": 0,
                                  "halted": 0, "cancelled": 0,
                                  "latencies": []}
            return per_tier[tier]

        now = self._clock()
        for rid, evs in self._by_rid.items():
            t_submit = evs[0].t
            tier = None              # tier currently serving this rid
            t_enter = 0.0
            touched: set[str] = set()
            terminal = None
            t_term = None
            for ev in evs:
                kind = getattr(ev, "kind", "")
                if kind == "quality":
                    if tier is not None and ev.src_tier == tier:
                        tier_bucket(tier)["time_at_tier_s"] += \
                            max(ev.t - t_enter, 0.0)
                    tier, t_enter = ev.dst_tier, ev.t
                    touched.add(tier)
                    continue
                if kind != "lifecycle":
                    continue
                if ev.dst in _SERVING:
                    here = self.tiers.get(ev.engine or "", "")
                    if here and here != tier:
                        if tier is not None:
                            tier_bucket(tier)["time_at_tier_s"] += \
                                max(ev.t - t_enter, 0.0)
                        tier, t_enter = here, ev.t
                    elif tier is None and here:
                        tier, t_enter = here, ev.t
                    if tier:
                        touched.add(tier)
                elif ev.dst in _TERMINAL:
                    terminal, t_term = ev.dst, ev.t
                    if tier is not None:
                        tier_bucket(tier)["time_at_tier_s"] += \
                            max(ev.t - t_enter, 0.0)
                    break
            if tier is not None and terminal is None:
                # still in flight: charge time served so far
                tier_bucket(tier)["time_at_tier_s"] += \
                    max(now - t_enter, 0.0)
            for name in touched:
                tier_bucket(name)["requests"] += 1
            if terminal is not None and tier:
                b = tier_bucket(tier)
                b[terminal] += 1
                if terminal == "done":
                    b["latencies"].append(max(t_term - t_submit, 0.0))

        out = {}
        for name in sorted(per_tier):
            b = per_tier[name]
            answered = b["done"] + b["failed"] + b["expired"] + b["halted"]
            lat = b["latencies"]
            out[name] = {
                "requests": b["requests"],
                "time_at_tier_s": round(b["time_at_tier_s"], 4),
                "completed": b["done"],
                "failed": b["failed"], "expired": b["expired"],
                "halted": b["halted"], "cancelled": b["cancelled"],
                "availability": round(b["done"] / answered, 4)
                if answered else 1.0,
                "latency_p50": round(percentile(lat, 50), 4),
                "latency_p95": round(percentile(lat, 95), 4),
                "latency_p99": round(percentile(lat, 99), 4),
            }
        return out

    def prometheus_text(self) -> str:
        """Text exposition of the registry; scalar counters and
        per-engine stats (whose source of truth are the dataclasses
        above) are synced into counter/gauge instruments first."""
        m = self.metrics
        m.counter("fleet_rejected_total",
                  "Admissions rejected").set(self.rejected)
        m.counter("fleet_failovers_total",
                  "Engine failures absorbed").set(self.failovers)
        m.counter("fleet_preemptions_total",
                  "Requests parked by preemption").set(self.preemptions)
        m.counter("fleet_cancelled_total",
                  "Requests cancelled").set(self.cancelled)
        m.counter("fleet_expired_total",
                  "Requests past deadline").set(self.expired)
        m.counter("fleet_migrations_total",
                  "Live migrations").set(len(self.migrations))
        m.counter("fleet_scale_events_total", "Membership changes") \
            .set(self.scale_ups, action="spawn")
        m.counter("fleet_scale_events_total", "") \
            .set(self.scale_downs, action="retire")
        m.counter("fleet_tier_shifts_total", "Quality-tier shifts") \
            .set(self.downshifts, direction="down")
        m.counter("fleet_tier_shifts_total", "") \
            .set(self.upshifts, direction="up")
        m.counter("fleet_prefix_hits_total",
                  "Admissions served a cached prefix").set(self.prefix_hits)
        m.counter("fleet_prefix_misses_total",
                  "Admissions with no cached prefix").set(self.prefix_misses)
        m.counter("fleet_prefix_evictions_total",
                  "Shared prefix pages evicted").set(self.prefix_evictions)
        m.counter("fleet_prefix_bytes_saved_total",
                  "KV bytes not recomputed or re-shipped thanks to "
                  "shared prefix pages").set(self.prefix_bytes_saved)
        tok = m.counter("engine_tokens_total", "Tokens emitted per engine")
        tps = m.gauge("engine_tokens_per_second",
                      "Per-engine busy-time throughput")
        up = m.gauge("engine_up", "1 while serving, 0 failed/retired")
        for name, s in sorted(self.engines.items()):
            labels = {"engine": name}
            if self.tiers.get(name):
                labels["tier"] = self.tiers[name]
            tok.set(s.tokens, **labels)
            tps.set(round(s.tokens_per_s, 3), **labels)
            up.set(0 if (s.failed or s.retired) else 1, **labels)
        return m.render()

    def summary(self) -> dict:
        return {
            "engines": {
                n: {"tokens": s.tokens, "steps": s.steps,
                    "tokens_per_s": round(s.tokens_per_s, 1),
                    "admitted": s.admitted, "completed": s.completed,
                    "migrations_in": s.migrations_in,
                    "migrations_out": s.migrations_out,
                    "failed": s.failed, "retired": s.retired}
                for n, s in sorted(self.engines.items())},
            "fleet": {
                "tokens": self.fleet_tokens(),
                "tokens_per_s": round(self.fleet_tokens_per_s(), 1),
                "rejected": self.rejected,
                "failovers": self.failovers,
                "migrations": len(self.migrations),
                **{k: round(v, 4)
                   for k, v in self.latency_percentiles().items()},
            },
            "lifecycle": {
                "events": len(self.events),
                "preemptions": self.preemptions,
                "cancelled": self.cancelled,
                "expired": self.expired,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "downshifts": self.downshifts,
                "upshifts": self.upshifts,
                "queue_wait_p50": round(percentile(self.queue_wait_s, 50),
                                        4),
                "preempt_wait_p50": round(
                    percentile(self.preempt_wait_s, 50), 4),
            },
            "prefix": {
                "hits": self.prefix_hits,
                "misses": self.prefix_misses,
                "evictions": self.prefix_evictions,
                "bytes_saved": self.prefix_bytes_saved,
                "hit_rate": round(
                    self.prefix_hits
                    / max(self.prefix_hits + self.prefix_misses, 1), 4),
            },
            "slo": self.slo_summary(),
        }
