"""Elastic autoscaling: queue/deadline-driven engine spawn & drain.

MVVM keeps service alive by moving work between heterogeneous hosts;
this module makes the *pool itself* elastic while holding the same
invariant the migration machinery already guarantees: **scaling is
migration**.  Scale-up instantiates a fresh ``Engine`` from a declared
``EngineTemplate`` and registers it with the router/balancer, so queued
and parked work dispatches onto it at the very next dispatch pass.
Scale-down never kills state: the victim engine is drained through the
exact live-migration departure path (``extract_slot -> pack_slot ->
place_blob``; anything momentarily unplaceable parks on the fleet work
queue like a preempted slot) and only then is the handle retired --
no request is ever lost or duplicated by a scale event, which is what
makes elasticity *testable* (see tests/test_fleet_autoscale.py).

The ``Autoscaler`` runs once per ``FleetController.step()``, reading
the telemetry signals the lifecycle layer already records -- work-queue
depth (fresh + parked), queue-wait p95 over a recent window, the
deadline-expiry rate, and per-engine slot utilization -- against a
declarative ``ScalePolicy``.  All timing (cooldown included) reads the
injectable fleet clock, so every decision is deterministic under a
``channel.SimClock``.

Every membership change is a typed ``ScaleEvent`` on the *unified*
audit log (``FleetTelemetry.events``), interleaved with the
``LifecycleEvent`` stream: a chronological read shows the retire event
immediately followed by the MIGRATING transitions of the slots it
displaced.

The port's copy of the JAX package's ``fleet.autoscaler``.  A spawned
or standby engine is built on the device of the weights it runs (the
template's own, or those it borrows from a live engine of its tier),
and gets its step programs from ``serving.program_cache`` under the
donor's key, so ``program_cache_hit`` and the tracer's ``jit:`` spans
say truthfully what was reused.  Refusals the JAX package states as
asserts raise ``ValueError`` here.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, ClassVar, Optional

from repro_torch.core.attestation import (Attester, capabilities,
                                          measure_config)
from repro_torch.core.daemon import DeviceProfile
from repro_torch.core.replication import FULL_TIER, QualityTier
from repro_torch.fleet.cluster import EngineHandle
from repro_torch.fleet.telemetry import percentile
from repro_torch.serving.engine import Engine
from repro_torch.serving.paged import PagedEngine


@dataclass(frozen=True)
class EngineTemplate:
    """Everything needed to stamp out one more engine replica: the
    device profile (its ``attested`` bit decides whether the fleet
    authority issues the new engine an attester -- a spawned attested
    engine can unstick a policy-gated confidential backlog), the
    compiled geometry (``slots``, ``max_len`` -- greedy bit-exactness
    only holds within one geometry, so templates should match the fleet
    they join), and a base rng seed (spawn *i* uses ``seed + i``).

    Cross-model fleets add a quality dimension: ``tier`` stamps the
    spawned engine's ``QualityTier``, and ``cfg``/``params`` carry the
    tier's own model (int8-dequantized or small-model weights).  When
    ``params`` is None the spawn borrows weights from a live engine of
    the same tier (every tier's engines share weights by definition),
    falling back to any live engine for the untiered legacy case."""
    name: str = "auto"               # spawned engines are name0, name1...
    profile: DeviceProfile = None
    slots: int = 4
    max_len: int = 128
    seed: int = 10_000
    tier: QualityTier = FULL_TIER
    cfg: Any = field(default=None, repr=False, compare=False)
    params: Any = field(default=None, repr=False, compare=False)
    # paged-KV templates: page_size > 0 spawns a PagedEngine whose
    # admission is the free-page budget (``pages``; 0 = one full
    # max_len reservation per decode row) rather than a slot count --
    # ``slots`` then sizes the decode batch (rows)
    page_size: int = 0
    pages: int = 0
    # prefix sharing: spawned paged engines come up with a (private)
    # content-addressed prefix cache armed, so warm tenants hit shared
    # pages on the new engine as soon as traffic lands there
    prefix_cache: bool = False
    shared_tenants: tuple = ()


@dataclass(frozen=True)
class ScalePolicy:
    """Declarative scaling rules.  ``min_engines``/``max_engines``
    bound the routable pool (healthy, non-verify-reserved engines).
    Scale-up fires when ANY armed pressure signal trips; scale-down
    only when the backlog is empty and mean slot utilization sits at or
    below ``scale_down_util``.  ``cooldown_s`` (fleet clock) separates
    consecutive scale events so one burst cannot thrash the pool.

    Warm capacity: ``standby_pool > 0`` keeps that many pre-built,
    pre-attested, program-warmed engines OUTSIDE the routable set;
    scale-up then *promotes* (registers a handle -- milliseconds)
    instead of constructing.  With ``prearm_horizon_s > 0`` the pool
    fills only when the queue-trend forecast (EWMA arrival rate +
    depth slope) projects the scale-up depth trigger within the
    horizon; at 0 the pool is kept topped up unconditionally.
    ``prefix_prewarm`` bounds how many hot prefix chains a spawned or
    promoted paged engine grafts from a same-tier donor (0 = off)."""
    min_engines: int = 1
    max_engines: int = 4
    scale_up_queue_depth: int = 4    # pending items (fresh+parked); 0 = off
    scale_up_wait_p95: Optional[float] = None   # seconds; None = off
    scale_up_on_expiry: bool = True  # deadline misses while queued/parked
    scale_down_util: float = 0.25    # mean occupied-slot fraction
    cooldown_s: float = 0.0
    window: int = 64                 # queue-wait samples for the p95
    standby_pool: int = 0            # warm standbys to hold (0 = off)
    prearm_horizon_s: float = 0.0    # forecast lookahead; 0 = always fill
    prefix_prewarm: int = 4          # top-K chains grafted on spawn/promote

    def _want_prearm(self, sig: "ScaleSignals") -> str:
        """Should the standby pool grow?  Returns the reason, or ""."""
        if self.standby_pool <= 0 or sig.standbys >= self.standby_pool \
                or sig.engines >= self.max_engines:
            return ""
        if self.prearm_horizon_s <= 0:
            return (f"standby pool {sig.standbys}/{self.standby_pool} "
                    "below target")
        h = self.prearm_horizon_s
        # two trend projections, believe the worse: queued depth growing
        # (slope) and raw arrivals outpacing service (EWMA rate)
        forecast = max(sig.depth + max(sig.depth_slope, 0.0) * h,
                       sig.depth + max(sig.arrival_rate, 0.0) * h)
        if 0 < self.scale_up_queue_depth <= forecast:
            return (f"forecast depth {forecast:.1f} >= "
                    f"{self.scale_up_queue_depth} within {h:.3f}s "
                    f"(rate {sig.arrival_rate:.2f}/s, "
                    f"slope {sig.depth_slope:.2f}/s)")
        return ""

    def decide(self, sig: "ScaleSignals", *, now: float,
               last_scale: Optional[float]) -> tuple[Optional[str], str]:
        """Pure decision: ("up"|"down"|"prearm"|None, reason).
        Separated from application so tests can drive it without real
        engines.  "prearm" asks for a standby build -- off the dispatch
        path, exempt from cooldown (pre-arming is preparation, not a
        membership change, so it must not be gated by -- or consume --
        the scale cooldown)."""
        prearm = self._want_prearm(sig)
        if last_scale is not None and now - last_scale < self.cooldown_s:
            return ("prearm", prearm) if prearm else (None, "cooldown")
        if sig.engines < self.min_engines:
            return "up", f"pool {sig.engines} below min {self.min_engines}"
        if sig.engines < self.max_engines:
            if 0 < self.scale_up_queue_depth <= sig.depth:
                return "up", (f"queue depth {sig.depth} >= "
                              f"{self.scale_up_queue_depth}")
            if self.scale_up_wait_p95 is not None \
                    and sig.wait_p95 > self.scale_up_wait_p95:
                return "up", (f"queue-wait p95 {sig.wait_p95:.4f}s > "
                              f"{self.scale_up_wait_p95:.4f}s")
            if self.scale_up_on_expiry and sig.expired_delta > 0:
                return "up", (f"{sig.expired_delta} deadline expiries "
                              "since last decision")
        if prearm:
            return "prearm", prearm
        if sig.engines > self.min_engines and sig.depth == 0 \
                and sig.utilization <= self.scale_down_util:
            return "down", (f"idle: utilization {sig.utilization:.2f} <= "
                            f"{self.scale_down_util:.2f}")
        return None, ""


@dataclass
class ScaleSignals:
    """One observation of the pressure signals a decision reads."""
    depth: int                       # pending work items (fresh + parked)
    wait_p95: float                  # recent queue-wait p95 (seconds)
    expired_delta: int               # deadline expiries since last look
    utilization: float               # mean occupied-slot fraction
    engines: int                     # routable pool size
    # queue-trend forecast inputs (EWMA-smoothed, fleet clock):
    arrival_rate: float = 0.0        # admissions per second
    depth_slope: float = 0.0         # d(depth)/dt, signed
    standbys: int = 0                # warm engines held outside the pool


@dataclass
class ScaleEvent:
    """One fleet membership change on the unified audit log.  The
    ``kind`` discriminator is how the mixed log is filtered -- no more
    dummy ``rid`` field to survive per-request scans.  ``action`` is
    "spawn" | "retire" | "prearm" (a standby built outside the routable
    set -- pool size unchanged); promotions record as "spawn" with the
    provenance in ``reason``."""
    kind: ClassVar[str] = "scale"    # audit-log discriminator
    action: str                      # "spawn" | "retire" | "prearm"
    engine: str
    reason: str
    t: float                         # fleet clock at the decision
    engines: int = 0                 # routable pool size AFTER the event
    signals: Optional[ScaleSignals] = None


@dataclass
class StandbyEngine:
    """One warm-pool entry: a fully constructed engine held OUTSIDE the
    routable set -- attested at build time (when the fleet has an
    authority) and program-warmed (its decode program has executed
    once, so its first-run cost is already paid).  Promotion is
    handle registration only."""
    name: str
    engine: Any
    template: EngineTemplate
    attester: Any = None
    build_s: float = 0.0             # off-path construct+warm cost
    cache_hit: bool = False          # programs served from the cache


class Autoscaler:
    """Spawn/retire engines from telemetry pressure, one decision per
    fleet step.  Only engines this autoscaler spawned are retirement
    candidates -- the operator's seed fleet is never scaled away.

    ``templates`` is one ``EngineTemplate`` (the single-tier legacy
    form) or a list of them, one per quality tier: scale-up then adds
    capacity at the tier the backlog actually needs -- each pending
    item demands the cheapest template tier at/above its
    ``quality_floor``, and the most-demanded tier spawns (capacity a
    request may not legally use is no capacity at all)."""

    def __init__(self, templates: EngineTemplate | list[EngineTemplate],
                 policy: ScalePolicy | None = None):
        if isinstance(templates, EngineTemplate):
            templates = [templates]
        if not templates:
            raise ValueError("the autoscaler needs at least one template")
        if any(t.profile is None for t in templates):
            raise ValueError("every EngineTemplate needs a DeviceProfile")
        self.templates: dict[str, EngineTemplate] = {}
        for t in templates:
            if t.tier.name in self.templates:
                raise ValueError(
                    f"duplicate template for tier {t.tier.name!r}")
            self.templates[t.tier.name] = t
        self.policy = policy or ScalePolicy()
        self.spawned: list[str] = []     # live spawned engine names
        self.events: list[ScaleEvent] = []
        self.standbys: list[StandbyEngine] = []   # the warm pool
        self.promotions = 0              # scale-ups served from the pool
        self._n_spawned = 0              # ever, for unique names/seeds
        self._last_scale: Optional[float] = None
        self._expired_seen = 0
        self._prearm_due = ""            # reason; built off-path
        # queue-trend observation state (EWMA, fleet clock)
        self._obs_t: Optional[float] = None
        self._obs_depth = 0
        self._obs_arrived = 0
        self._rate: Optional[float] = None
        self._slope: Optional[float] = None

    @property
    def template(self) -> EngineTemplate:
        """The single-template legacy view (first declared)."""
        return next(iter(self.templates.values()))

    # -- observation --------------------------------------------------------
    def _observe(self, fleet):
        """Advance the queue-trend estimators (once per step): EWMA of
        the admission rate (ticket-count delta over the fleet clock)
        and of the queue-depth slope.  Both feed the prearm forecast."""
        now = fleet.clock()
        depth = fleet.queue.depth()
        arrived = len(fleet.tickets)
        if self._obs_t is not None:
            dt = now - self._obs_t
            if dt > 0:
                rate = (arrived - self._obs_arrived) / dt
                slope = (depth - self._obs_depth) / dt
                a = 0.5
                self._rate = rate if self._rate is None \
                    else a * rate + (1 - a) * self._rate
                self._slope = slope if self._slope is None \
                    else a * slope + (1 - a) * self._slope
        self._obs_t, self._obs_depth, self._obs_arrived = \
            now, depth, arrived

    def signals(self, fleet) -> ScaleSignals:
        routable = [h for h in fleet.handles.values()
                    if h.healthy and h.spec_role != "verify"]
        waits = fleet.telemetry.queue_wait_s[-self.policy.window:]
        util = (sum(h.load for h in routable) / len(routable)
                if routable else 0.0)
        return ScaleSignals(
            depth=fleet.queue.depth(),
            wait_p95=percentile(waits, 95),
            expired_delta=fleet.telemetry.expired - self._expired_seen,
            utilization=util,
            engines=len(routable),
            arrival_rate=self._rate or 0.0,
            depth_slope=self._slope or 0.0,
            standbys=len(self.standbys))

    # -- the per-step hook --------------------------------------------------
    def step(self, fleet) -> Optional[ScaleEvent]:
        # a spawned engine that failed is a corpse, not capacity: it is
        # neither retirable nor "live spawned" (keeps idle-drain loops
        # over .spawned terminating after chaos)
        self.spawned = [n for n in self.spawned
                        if n in fleet.handles and fleet.handles[n].healthy]
        self._observe(fleet)
        sig = self.signals(fleet)
        now = fleet.clock()
        action, why = self.policy.decide(sig, now=now,
                                         last_scale=self._last_scale)
        # consume the expiry counter only when the scale-up path could
        # actually act on it (a scale decision fired, or the up-branch
        # was evaluated and declined on its merits).  Expiries observed
        # while gated -- cooldown, or pool at max -- stay accumulated
        # so the signal fires as soon as the gate lifts; a "prearm"
        # under cooldown never consumes them.
        gated = (self._last_scale is not None
                 and now - self._last_scale < self.policy.cooldown_s)
        if action in ("up", "down") or \
                (not gated and sig.engines < self.policy.max_engines):
            self._expired_seen = fleet.telemetry.expired
        if action == "up":
            return self.scale_up(fleet, reason=why, signals=sig)
        if action == "down":
            return self.scale_down(fleet, reason=why, signals=sig)
        if action == "prearm":
            # note the want only: the standby is built by replenish(),
            # which FleetController.step runs AFTER dispatch -- pool
            # construction never delays work already queued
            self._prearm_due = why
        return None

    # -- scale events -------------------------------------------------------
    def _record(self, fleet, action: str, name: str, reason: str,
                signals: Optional[ScaleSignals]) -> ScaleEvent:
        self._last_scale = fleet.clock()
        pool = len([h for h in fleet.handles.values()
                    if h.healthy and h.spec_role != "verify"])
        ev = ScaleEvent(action=action, engine=name, reason=reason,
                        t=self._last_scale, engines=pool, signals=signals)
        self.events.append(ev)
        fleet.telemetry.record_scale(ev)
        return ev

    def pick_template(self, fleet) -> EngineTemplate:
        """The tier the backlog actually needs.  Each pending work item
        (fresh or parked) demands the CHEAPEST template tier at/above
        its quality floor -- elasticity adds the least-expensive
        capacity the work may legally use -- and the most-demanded tier
        wins (ties: cheapest).  An empty backlog (min-pool refills,
        wait-p95 triggers) spawns the cheapest template."""
        if len(self.templates) == 1:
            return self.template
        by_cost = sorted(self.templates.values(),
                         key=lambda t: t.tier.quality)
        demand = {t.tier.name: 0 for t in by_cost}
        for item in fleet.queue.ordered():
            floor = getattr(item, "quality_floor", 0.0)
            for t in by_cost:
                if t.tier.quality >= floor - 1e-12:
                    demand[t.tier.name] += 1
                    break
        best = max(by_cost, key=lambda t: demand[t.tier.name])
        return best if demand[best.tier.name] > 0 else by_cost[0]

    def _params_for(self, fleet, template: EngineTemplate):
        """Weights for a spawn: the template's own, else borrowed from a
        live engine of the same tier (one tier = one weight set), else
        -- untiered legacy -- from any live engine."""
        if template.params is not None:
            return template.cfg or fleet.cfg, template.params
        for h in fleet.handles.values():
            if h.tier.name == template.tier.name:
                return h.engine.cfg, h.engine.params
        # multi-template fleets may NEVER borrow across tiers: stamping
        # tier X on tier Y's weights would serve floored requests below
        # their contract with no audit trail.  A real exception, not an
        # assert: under ``python -O`` an assert vanishes and the borrow
        # silently happens.
        if len(self.templates) != 1:
            raise RuntimeError(
                f"template tier {template.tier.name!r} declares no params "
                "and no live engine of that tier exists to borrow from "
                "(cross-tier weight borrowing is forbidden)")
        ref = next(iter(fleet.handles.values())).engine
        return ref.cfg, ref.params

    def _fresh_name(self, fleet, template: EngineTemplate) -> str:
        taken = set(fleet.handles) | {s.name for s in self.standbys}
        while f"{template.name}{self._n_spawned}" in taken:
            self._n_spawned += 1
        return f"{template.name}{self._n_spawned}"

    def _construct(self, template: EngineTemplate, cfg, params):
        # on the device of the weights it runs: a card fleet spawns on
        # the card, a CPU test fleet on the CPU -- never a silent move
        device = params["embed"].device
        if template.page_size:
            return PagedEngine(cfg, params, page_size=template.page_size,
                               pages=template.pages or None,
                               rows=template.slots,
                               max_len=template.max_len,
                               seed=template.seed + self._n_spawned,
                               prefix_cache=template.prefix_cache,
                               shared_tenants=template.shared_tenants,
                               device=device)
        return Engine(cfg, params, slots=template.slots,
                      max_len=template.max_len,
                      seed=template.seed + self._n_spawned, device=device)

    def scale_up(self, fleet, *, reason: str = "manual",
                 signals: Optional[ScaleSignals] = None) -> ScaleEvent:
        """Add one engine of the backlog-demanded tier to the routable
        set.  With a matching warm standby the scale-up *promotes* it --
        handle registration only, milliseconds; programs, attestation
        and warm-up were paid off-path at build time -- else it falls
        back to inline construction.  Either way the engine joins the
        router/balancer immediately: queued and parked work dispatches
        onto it in this very step's dispatch pass."""
        template = self.pick_template(fleet)
        sb = next((s for s in self.standbys
                   if s.template.tier.name == template.tier.name), None)
        if sb is not None:
            self.standbys.remove(sb)
            t0 = time.perf_counter()
            handle = EngineHandle(sb.name, sb.engine, sb.template.profile,
                                  attester=sb.attester,
                                  tier=sb.template.tier)
            fleet.add_engine(handle)
            promote_s = time.perf_counter() - t0
            self.spawned.append(sb.name)
            self.promotions += 1
            ev = self._record(fleet, "spawn", sb.name,
                              f"promoted warm standby: {reason}", signals)
            if fleet.telemetry.tracer is not None:
                fleet.telemetry.tracer.annotate_spawn(
                    sb.name, promoted=True,
                    construct_s=round(promote_s, 6),
                    standby_build_s=round(sb.build_s, 6),
                    cache_hit=sb.cache_hit)
            self._prefix_prewarm(fleet, handle)
            # refill off-path at the end of this step
            self._prearm_due = self._prearm_due or "refill after promotion"
            return ev
        cfg, params = self._params_for(fleet, template)
        name = self._fresh_name(fleet, template)
        t_build = time.perf_counter()
        eng = self._construct(template, cfg, params)
        build_s = time.perf_counter() - t_build
        self._n_spawned += 1
        handle = EngineHandle(name, eng, template.profile,
                              tier=template.tier)
        fleet.add_engine(handle)
        self.spawned.append(name)
        ev = self._record(fleet, "spawn", name, reason, signals)
        # the spawn span (opened by the ScaleEvent above, closed by the
        # engine's first productive step = time-to-useful) carries the
        # host-side construction cost; jit program builds attach as
        # child spans via the engine's profile hook
        if fleet.telemetry.tracer is not None:
            fleet.telemetry.tracer.annotate_spawn(
                name, construct_s=round(build_s, 6),
                cache_hit=eng.program_cache_hit)
        self._prefix_prewarm(fleet, handle)
        return ev

    # -- the warm-standby pool ----------------------------------------------
    def replenish(self, fleet) -> Optional[ScaleEvent]:
        """Build at most one pending standby.  ``FleetController.step``
        calls this AFTER dispatch, so pool construction (the one
        remaining seconds-scale cost, and only on a cache-cold
        geometry) never delays work already queued."""
        if not self._prearm_due:
            return None
        why, self._prearm_due = self._prearm_due, ""
        if len(self.standbys) >= self.policy.standby_pool:
            return None
        return self._build_standby(fleet, reason=why)

    def _build_standby(self, fleet, *, reason: str = "prearm") \
            -> Optional[ScaleEvent]:
        """Construct + attest + program-warm one engine into the pool.

        The standby is held outside the routable set: no handle, no
        routing, no load.  Attestation happens NOW (the promoted handle
        carries the attester, so ``add_engine`` does not re-issue), and
        the decode program executes once on the fresh inactive state --
        output discarded -- so the program's first run (the kernels'
        build, when this is their first use in the process) is paid
        here, not at first useful token.  The port's step updates its
        state in place: every row is inactive, so the caches, tokens and
        positions stay as they were, and the step counter is put back."""
        template = self.pick_template(fleet)
        cfg, params = self._params_for(fleet, template)
        name = self._fresh_name(fleet, template)
        t0 = time.perf_counter()
        eng = self._construct(template, cfg, params)
        self._n_spawned += 1
        attester = None
        if fleet.authority is not None and template.profile.attested:
            attester = Attester(name, fleet.authority,
                                measure_config(eng.cfg),
                                capabilities(eng.cfg))
        steps = eng.state.step_count
        eng._profiled("decode",
                      lambda: eng._decode_fn(eng.params, eng.state))
        eng.state.step_count = steps
        build_s = time.perf_counter() - t0
        self.standbys.append(StandbyEngine(
            name=name, engine=eng, template=template, attester=attester,
            build_s=build_s, cache_hit=eng.program_cache_hit))
        # on the audit log but NOT a membership change: no _last_scale
        # (prearm must not start a scale cooldown), pool size unchanged
        pool = len([h for h in fleet.handles.values()
                    if h.healthy and h.spec_role != "verify"])
        ev = ScaleEvent(action="prearm", engine=name, reason=reason,
                        t=fleet.clock(), engines=pool, signals=None)
        self.events.append(ev)
        fleet.telemetry.record_scale(ev)
        return ev

    def _prefix_prewarm(self, fleet, handle):
        """Graft the hottest prefix chains from the best same-tier
        donor into a just-added engine (bounded by the policy's
        ``prefix_prewarm``), so it is warm in *cache*, not just in
        code.  Best-effort; the outcome -- including a loud skip
        reason -- lands on the spawn span."""
        k = self.policy.prefix_prewarm
        eng = handle.engine
        if k <= 0 or getattr(eng, "prefix_cache", None) is None:
            return
        donors = [h for h in fleet.handles.values()
                  if h.name != handle.name and h.healthy
                  and h.tier.name == handle.tier.name
                  and getattr(h.engine, "prefix_cache", None) is not None
                  and h.engine.prefix_cache.pages_held > 0]
        if not donors:
            return
        donor = max(donors, key=lambda h: h.engine.prefix_cache.pages_held)
        report = eng.prewarm_chains(donor.engine, top_k=k)
        if fleet.telemetry.tracer is not None:
            attrs = {"prewarm_donor": donor.name,
                     "prewarm_chains": report["chains"],
                     "prewarm_pages": report["pages"]}
            if report["skipped"]:
                attrs["prewarm_skipped"] = report["skipped"]
            fleet.telemetry.tracer.annotate_spawn(handle.name, **attrs)

    def scale_down(self, fleet, *, reason: str = "manual",
                   signals: Optional[ScaleSignals] = None) \
            -> Optional[ScaleEvent]:
        """Retire the least-loaded eligible spawned engine.  Scaling is
        migration: ``FleetController.retire_engine`` live-migrates every
        slot off (parking what has nowhere to go) BEFORE the handle
        disappears, so a scale-down can displace work but never drop
        it."""
        pool = [fleet.handles[n] for n in self.spawned
                if n in fleet.handles]
        pool = [h for h in pool if h.healthy and h.spec_role is None]
        if not pool:
            return None
        victim = min(pool, key=lambda h: h.load)
        fleet.retire_engine(victim.name, reason=reason)
        self.spawned.remove(victim.name)
        return self._record(fleet, "retire", victim.name, reason, signals)
