"""FleetController: N heterogeneous Engine replicas behind one queue.

The controller owns the engine registry (``EngineHandle``: engine +
``DeviceProfile`` + optional attester; per-link network conditions
live in the shared ``Fabric``), admission control (a bounded queue --
``submit`` refuses work when full, the backpressure signal), the
dispatch loop (router picks an engine per request, highest priority
first), and failure handling (fail-stop an engine at a stable point
and the balancer re-places its in-flight slots on survivors).

Requests enter as immutable ``RequestSpec``s and are tracked by
``RequestTicket``s (see fleet.lifecycle): a typed state machine with
incremental token streaming, ``cancel()``, deadlines, and priorities.
When a higher-priority spec arrives and no slot is eligible, the
lowest-priority in-flight slot is *preempted via the migration
machinery*: ``extract_slot`` -> ``pack_slot`` parks it fleet-side (the
same re-placement path a failover orphan takes) and it resumes
bit-identically once capacity frees -- migration as the scheduling
primitive.

One ``step()`` advances every healthy engine one decode step -- the
fleet-level stable point: between two controller steps every request is
either queued (no device state), parked/shadow-checkpointed, or
complete.

The port's copy of the JAX package's ``fleet.cluster``: in sync mode the
controller steps every engine on the caller's thread; in service mode
(``fleet.service.ControlPlane``) each engine runs in its own service
and the controller keeps the state.  A fresh prompt, or a parked slot's
re-prefill, outside an engine's prefill domain fails its ticket with the
engine's reason instead of raising out of ``step()``, and a fresh request
an engine refuses after its ``can_admit`` accepted it stays queued
(ROADMAP Queue 3).
"""

from __future__ import annotations

import threading
import time
import warnings
from dataclasses import dataclass
from typing import ClassVar, Optional

from repro_torch.core.attestation import (Attester, capabilities,
                                          measure_config)
from repro_torch.core.channel import Fabric, NetworkCondition
from repro_torch.core.daemon import DeviceProfile
from repro_torch.core.migration import pack_slot
from repro_torch.core.replication import FULL_TIER, QualityTier
from repro_torch.fleet.balancer import (Rebalancer, ReprefillRefused,
                                        peek_slot_meta)
from repro_torch.fleet.lifecycle import (RequestSpec, RequestState,
                                         RequestTicket, WorkItem, WorkQueue,
                                         spec_of_request)
from repro_torch.fleet.router import Router
from repro_torch.fleet.speculative import SpeculativeTierController
from repro_torch.fleet.telemetry import FleetTelemetry, QualityEvent
from repro_torch.fleet.tracing import Tracer
from repro_torch.serving.engine import Engine, Request


@dataclass
class EngineHandle:
    name: str
    engine: Engine
    profile: DeviceProfile
    attester: Optional[Attester] = None
    healthy: bool = True
    spec_role: Optional[str] = None  # "draft" | "verify" when paired
    # the engine's quality point: engines of one tier share weights
    # (bit-exact migration); engines of different tiers do not (lossy
    # re-prefill hand-off).  Untiered fleets all share FULL_TIER.
    tier: QualityTier = FULL_TIER
    # link health of this engine as seen from the front door; None
    # means "always reachable" (the in-process default)
    cond: Optional[NetworkCondition] = None

    @property
    def load(self) -> float:
        return len(self.engine.requests) / max(self.engine.slots, 1)

    @property
    def reachable(self) -> bool:
        return self.cond is None or (self.cond.up and self.cond.loss < 0.95)


@dataclass
class FloorReject:
    """A typed admission refusal on the unified audit log: the spec's
    ``quality_floor`` exceeds every live tier AND every tier the
    autoscaler could ever spawn, so queueing can never help -- the
    ticket fails fast with ``hint`` instead of waiting out a deadline
    the fleet is structurally unable to meet."""
    kind: ClassVar[str] = "floor_reject"   # audit-log discriminator
    rid: str
    floor: float                     # the request's quality floor
    best: float                      # best quality the fleet could field
    hint: str                        # actionable cause, also on the ticket
    t: float                         # fleet clock at admission


class FleetController:
    def __init__(self, handles: list[EngineHandle], *,
                 router: Router | None = None,
                 balancer: Rebalancer | None = None,
                 telemetry: FleetTelemetry | None = None,
                 fabric: Fabric | None = None,
                 queue_limit: int = 32,
                 authority=None,
                 rebalance_every: int = 0,
                 spec_tiers: dict[str, str] | None = None,
                 spec_options: dict | None = None,
                 clock=None,
                 autoscaler=None,
                 aging_rate: float = 0.0,
                 tracer: "Tracer | bool | None" = True):
        assert handles, "a fleet needs at least one engine"
        self.handles: dict[str, EngineHandle] = {h.name: h for h in handles}
        self.cfg = handles[0].engine.cfg
        # the fleet clock: any zero-arg float callable (channel.SimClock
        # qualifies).  Deadlines are absolute times on THIS clock, and
        # all queue-wait / latency accounting reads it, so tests that
        # inject a SimClock get deterministic timing end to end.
        self.clock = clock or time.perf_counter
        self.router = router or Router()
        self.balancer = balancer or Rebalancer()
        if telemetry is None:
            telemetry = FleetTelemetry(clock=self.clock)
        elif clock is not None:
            telemetry.bind_clock(self.clock)  # one time base everywhere
        self.telemetry = telemetry
        # distributed tracing: on by default (span derivation rides the
        # audit log the telemetry already records; overhead is benched
        # in bench_fleet.py).  Pass tracer=False to disable, or hand in
        # a configured Tracer.
        if tracer is True:
            tracer = Tracer(clock=self.clock)
        self.tracer = tracer or None
        self.telemetry.attach_tracer(self.tracer)
        self.fabric = fabric or Fabric()
        self.queue_limit = queue_limit
        self.rebalance_every = rebalance_every
        self.measurement = measure_config(self.cfg)
        # cross-model fleets: every tier's config measures differently,
        # and the attestation whitelist must admit each of them (the
        # tiers registry survives engine retirement so audit events can
        # still rank a departed tier's quality)
        self.tiers: dict[str, QualityTier] = {}
        self.whitelist = set()
        for h in handles:
            assert h.engine.cfg.vocab_size == self.cfg.vocab_size, \
                (f"tiered engines must share a tokenizer: "
                 f"{h.engine.cfg.name} vocab {h.engine.cfg.vocab_size} "
                 f"!= {self.cfg.vocab_size}")
            self.tiers.setdefault(h.tier.name, h.tier)
            self.whitelist.add(measure_config(h.engine.cfg))
            self.telemetry.note_tier(h.name, h.tier.name)
            self._wire_profile(h)
        self.authority = authority   # kept: late-joining engines attest too
        if authority is not None:
            for h in handles:
                if h.profile.attested and h.attester is None:
                    h.attester = Attester(h.name, authority,
                                          measure_config(h.engine.cfg),
                                          capabilities(h.engine.cfg))
        # elastic membership: the autoscaler (when armed) runs once per
        # step, spawning engines from its template under queue/deadline
        # pressure and retiring idle spawned engines via retire_engine
        self.autoscaler = autoscaler
        # priority aging: dispatch points gained per second of queue
        # wait (0 = off).  Affects dispatch ORDER only -- preemption
        # keeps reading declared priorities, so aged work never parks
        # live slots
        self.aging_rate = aging_rate
        # draft/verify tier map: each entry pairs a draft engine with a
        # verify engine; the pair is stepped by its own controller and
        # the verify engine is reserved (excluded from normal routing)
        self.spec_controllers: dict[str, SpeculativeTierController] = {}
        for dname, vname in (spec_tiers or {}).items():
            d, v = self.handles[dname], self.handles[vname]
            assert d is not v, "a tier pair needs two engines"
            assert d.spec_role is None and v.spec_role is None, \
                "an engine can belong to at most one tier pair"
            d.spec_role, v.spec_role = "draft", "verify"
            self.spec_controllers[dname] = SpeculativeTierController(
                d, v, fabric=self.fabric, whitelist=self.whitelist,
                measurement=self.measurement, router=self.router,
                telemetry=self.telemetry, fleet=self, clock=self.clock,
                **(spec_options or {}))
        # fleet-state lock: a no-op in the synchronous loop, load-
        # bearing in service mode where the control thread and user
        # threads (submit/cancel/result) share queue/tickets/inflight.
        # Reentrant so ack closures and ticket transitions nest freely.
        self._lock = threading.RLock()
        # set by fleet.service.ControlPlane while service mode is
        # active: cancel (and ticket.result) route through it
        self.service = None
        self.queue = WorkQueue()             # fresh + parked work items
        self.tickets: dict[str, RequestTicket] = {}
        self.inflight: dict[str, tuple[Request, str, float]] = {}
        self.done: dict[str, Request] = {}
        self.placements: dict[str, list[str]] = {}  # rid -> engine history
        self.stalled: list[str] = []         # rids stuck at last run()
        self._steps = 0
        self._auto_rid = 0
        # prefix-cache accounting: last-seen per-engine stats snapshot,
        # so each step harvests only the delta into fleet telemetry
        self._prefix_seen: dict[str, dict] = {}

    # -- legacy view: parked slot snapshots -----------------------------------
    @property
    def orphans(self) -> list[tuple[str, bytes]]:
        """Parked slot snapshots awaiting re-placement, as (src, blob)
        pairs -- the pre-lifecycle orphan-list view.  Preempted slots
        and failover orphans both live here (same re-placement path)."""
        return [(it.src, it.blob) for it in self.queue.parked()]

    # -- admission control ----------------------------------------------------
    def submit(self, req: Request | RequestSpec):
        """Admit work: a ``RequestSpec`` returns a ``RequestTicket``
        (None when the queue is full -- backpressure, the caller must
        back off).

        Submitting a legacy mutable ``Request`` is deprecated: build a
        ``RequestSpec`` (``spec_of_request`` converts) and track the
        returned ticket instead.  The shim warns and delegates, keeping
        the old bool contract."""
        if isinstance(req, Request):
            warnings.warn(
                "FleetController.submit(Request) is deprecated; submit "
                "a RequestSpec and use the returned RequestTicket "
                "(spec_of_request converts an existing Request)",
                DeprecationWarning, stacklevel=2)
        return self._admit(req)

    def _admit(self, req: Request | RequestSpec):
        """Admission body shared by ``submit`` and ``run``: a legacy
        ``Request`` returns bool, a ``RequestSpec`` a ticket; either way
        a ticket is created internally so priorities, deadlines and the
        event log stay uniform."""
        with self._lock:
            return self._admit_locked(req)

    def _admit_locked(self, req: Request | RequestSpec):
        legacy = isinstance(req, Request)
        if legacy:
            engine_req = req
        else:
            rid = req.rid
            if rid is None:
                rid, self._auto_rid = f"req{self._auto_rid}", \
                    self._auto_rid + 1
            engine_req = req.to_request(rid)
        if len(self.queue) >= self.queue_limit:
            self.telemetry.record_reject()
            return False if legacy else None
        assert engine_req.rid not in self.tickets, \
            f"duplicate rid {engine_req.rid!r}"
        spec = spec_of_request(engine_req) if legacy else req
        ticket = RequestTicket(spec, engine_req, self)
        ticket.seq = self.queue.next_seq()
        self.tickets[engine_req.rid] = ticket
        # quality-aware admission: a floor no live tier meets AND no
        # autoscaler template could ever spawn is structurally
        # unservable -- fail fast with a typed reject-with-hint rather
        # than queueing until the deadline expires
        floor = engine_req.quality_floor
        best = self.best_quality()
        if floor > best + 1e-12:
            hint = (f"quality_floor {floor:.2f} exceeds every live and "
                    f"spawnable tier (best {best:.2f}); lower the floor "
                    "or register a higher-quality tier/template")
            self.telemetry.record_floor_reject(FloorReject(
                rid=engine_req.rid, floor=floor, best=best, hint=hint,
                t=self.clock()))
            self.ticket_transition(engine_req.rid, RequestState.FAILED,
                                   reason=hint)
            return False if legacy else ticket
        self.queue.push(WorkItem(
            rid=engine_req.rid, priority=engine_req.priority,
            seq=ticket.seq, t_submit=ticket.submitted_at,
            sensitivity=engine_req.sensitivity,
            rows_needed=len(engine_req.prompt) + engine_req.max_new_tokens,
            deadline=engine_req.deadline,
            quality_floor=engine_req.quality_floor,
            ticket=ticket, req=engine_req))
        return True if legacy else ticket

    def best_quality(self) -> float:
        """The highest quality tier the fleet could ever field: every
        registered engine's tier plus every autoscaler template tier
        (capacity a scale-up could legally create)."""
        qs = [h.tier.quality for h in self.handles.values()]
        if self.autoscaler is not None:
            qs += [t.tier.quality
                   for t in self.autoscaler.templates.values()]
        return max(qs, default=0.0)

    # -- bookkeeping shared with the balancer ----------------------------------
    def reassign(self, req: Request, handle_name: str):
        """A request object changed engines (and identity: inject_slot
        rebuilds it); keep latency accounting anchored at submission."""
        old = self.inflight.get(req.rid)
        ticket = self.tickets.get(req.rid)
        if old is not None:
            t0 = old[2]
        elif ticket is not None:
            t0 = ticket.submitted_at
        else:
            t0 = self.clock()
        self.inflight[req.rid] = (req, handle_name, t0)
        self.placements.setdefault(req.rid, []).append(handle_name)
        if ticket is not None:
            ticket._req = req

    def placement_of(self, rid: str) -> str | None:
        entry = self.inflight.get(rid)
        return entry[1] if entry is not None else None

    def request(self, rid: str) -> Request | None:
        if rid in self.done:
            return self.done[rid]
        entry = self.inflight.get(rid)
        return entry[0] if entry is not None else None

    def ticket_transition(self, rid: str, state: RequestState, *,
                          reason: str = "", engine: str | None = None):
        """Advance a ticket's state machine (no-op for unticketed rids
        -- e.g. synthetic snapshots -- and for terminal tickets)."""
        ticket = self.tickets.get(rid)
        if ticket is not None and not ticket.done:
            ticket._transition(state, reason=reason, engine=engine)

    def committed_output(self, rid: str) -> list[int]:
        """The committed token stream of a request, wherever it lives:
        a drafting slot's uncommitted speculative tail is excluded, a
        parked slot's output is read out of its snapshot."""
        for spec in self.spec_controllers.values():
            st = spec._spec.get(rid)
            if st is not None:
                return list(st.req.output[:st.committed])
        req = self.request(rid)
        if req is not None:
            return list(req.output)
        item = self.queue.find(rid)
        if item is not None and item.parked:
            return list(peek_slot_meta(item.blob)["output"])
        return []

    # -- lifecycle control ------------------------------------------------------
    def cancel(self, rid: str, *, reason: str = "caller cancelled") -> bool:
        """Cancel a request.  Queued/parked work is dropped outright; an
        in-flight slot (draft + verify replica for speculative requests)
        is retired immediately, so capacity frees within one step.

        In service mode the slot lives on another thread: the control
        plane drops the queued half under the fleet lock and sends the
        owning service a cancel message instead of touching its engine."""
        if self.service is not None:
            return self.service.cancel(rid, reason=reason)
        ticket = self.tickets.get(rid)
        if ticket is None or ticket.done:
            return False
        if self.queue.find(rid) is not None:
            self.queue.remove(rid)
        elif rid in self.inflight:
            req, hname, _ = self.inflight.pop(rid)
            handle = self.handles[hname]
            spec = self.spec_controllers.get(hname)
            if not (spec is not None and spec.release(rid)):
                if handle.engine.requests.get(req.slot) is req:
                    handle.engine.retire(req.slot)
            self.balancer.shadow.get(hname, {}).pop(rid, None)
        else:
            return False
        self.telemetry.record_cancelled()
        self.ticket_transition(rid, RequestState.CANCELLED, reason=reason)
        return True

    def abandon(self, rid: str, *, reason: str):
        """Fail a ticket that can never run (used by ``result()`` when
        the fleet stalls with the work still pending)."""
        self.queue.remove(rid)
        self.ticket_transition(rid, RequestState.FAILED, reason=reason)

    def park_blob(self, src: str, blob: bytes, *,
                  origin: str = "failover"):
        """A packed slot with nowhere to go joins the parked work list
        (the orphan re-placement path); dispatch retries it in priority
        order alongside fresh admissions.  The source engine's tier
        rides along: a later re-placement on a different tier must take
        the lossy re-prefill path, not inject foreign cache rows."""
        meta = peek_slot_meta(blob)
        ticket = self.tickets.get(meta["rid"])
        now = self.clock()
        src_handle = self.handles.get(src)
        self.queue.push(WorkItem(
            rid=meta["rid"], priority=int(meta.get("priority", 0)),
            seq=ticket.seq if ticket is not None else self.queue.next_seq(),
            t_submit=ticket.submitted_at if ticket is not None else now,
            sensitivity=meta["sensitivity"],
            rows_needed=len(meta["prompt"]) + meta["max_new_tokens"],
            deadline=meta.get("deadline"),
            quality_floor=meta.get("quality_floor", 0.0), ticket=ticket,
            blob=blob, src=src,
            src_tier=src_handle.tier.name if src_handle is not None else "",
            origin=origin, parked_at=now))

    def record_tier_change(self, rid: str, src_tier: str, dst_tier: str,
                           *, reason: str, engine: str | None = None):
        """Audit a cross-tier move as a typed ``QualityEvent`` (down- or
        upshift by the registered tiers' relative quality)."""
        if not src_tier or not dst_tier or src_tier == dst_tier:
            return
        sq = self.tiers.get(src_tier, FULL_TIER).quality
        dq = self.tiers.get(dst_tier, FULL_TIER).quality
        self.telemetry.record_quality(QualityEvent(
            rid=rid, src_tier=src_tier, dst_tier=dst_tier,
            direction="down" if dq < sq else "up", reason=reason,
            quality=dq, engine=engine or "", t=self.clock()))

    def requeue_request(self, req: Request, t_submit: float):
        """A request restarts from its prompt (failure before its first
        shadow sync): back into the queue at its original position."""
        ticket = self.tickets.get(req.rid)
        self.queue.push(WorkItem(
            rid=req.rid, priority=req.priority,
            seq=ticket.seq if ticket is not None else self.queue.next_seq(),
            t_submit=t_submit, sensitivity=req.sensitivity,
            rows_needed=len(req.prompt) + req.max_new_tokens,
            deadline=req.deadline, ticket=ticket, req=req))
        self.ticket_transition(req.rid, RequestState.QUEUED,
                               reason="failover restart (no shadow)")

    # -- dispatch ---------------------------------------------------------------
    def _expire(self, now: float):
        """Deadline expiry of queued and parked work (in-flight slots
        keep decoding: they already paid for their state)."""
        for item in self.queue.expired(now):
            self.queue.remove(item.rid)
            self.telemetry.record_expired()
            self.ticket_transition(
                item.rid, RequestState.EXPIRED,
                reason=f"deadline {item.deadline:.4f} passed at {now:.4f}",
                engine=item.src or None)

    def _park_victim(self, item: WorkItem, handles) -> bool:
        """Preemption-by-migration: free a slot for ``item`` by parking
        the lowest-priority (strictly lower than ``item``'s) in-flight
        request on an engine ``item`` could actually use.  The victim's
        slot leaves through ``extract_slot``/``pack_slot`` -- the exact
        live-migration departure path -- and resumes bit-identically
        later via the parked-work re-placement path.

        Deadline-aware victim selection: a slot whose deadline would
        pass before it could plausibly resume is never parked --
        parking it converts work that would have *finished* (in-flight
        slots keep decoding past their deadline) into a guaranteed
        expiry on the parked queue.  "Expected resume" is approximated
        by the preemptor's raw roofline time on the victim's engine:
        the victim cannot come back before the work that displaced it
        is done.

        Speculative slots ARE parkable (the ROADMAP lifecycle gap):
        the pair controller first rolls the uncommitted draft tail back
        (``Engine.rollback_slot``, which restores a recurrent draft's
        state too) and dissolves the request's replica
        slot on the verify engine, so the packed snapshot -- and the
        stream the victim later resumes from -- holds only committed
        tokens.  Plain slots win ties against speculative ones (no
        rollback to pay)."""
        best = None
        now = self.clock()
        for h in handles:
            if not h.healthy \
                    or not h.engine.admissible(item.rows_needed) \
                    or not self.router.eligible(item.sensitivity, h):
                continue
            est_resume = now + self.router.score(
                h, self.cfg, prefill_tokens=0,
                decode_tokens=item.rows_needed, loaded=False)
            spec = self.spec_controllers.get(h.name)
            for slot, req in h.engine.requests.items():
                if req.done or req.priority >= item.priority:
                    continue
                if req.deadline is not None and req.deadline < est_resume:
                    continue         # would expire while parked
                speculative = spec is not None and req.rid in spec._spec
                vt = self.tickets.get(req.rid)
                # lowest priority first; plain before speculative (a
                # spec victim pays a draft-tail rollback); youngest
                # within a class (the most recently admitted victim
                # loses the least work)
                key = (req.priority, speculative,
                       -(vt.seq if vt is not None else 0))
                if best is None or key < best[0]:
                    best = (key, h, slot, req, spec if speculative
                            else None)
        if best is None:
            return False
        _, handle, slot, req, spec = best
        if spec is not None:
            # roll the uncommitted tail back and free the verify-tier
            # replica BEFORE packing: only committed tokens may survive
            # a park
            spec.release_for_park(req.rid)
        snap = handle.engine.extract_slot(slot)
        if self.tracer is not None:
            # open the migrate-hop span BEFORE packing so its identity
            # rides the blob; whoever re-places the park closes it
            snap.trace = self.tracer.wire_context(req.rid, src=handle.name)
        blob = pack_slot(snap)
        self.balancer.shadow.get(handle.name, {}).pop(req.rid, None)
        self.inflight.pop(req.rid, None)
        self.telemetry.record_preemption()
        self.ticket_transition(req.rid, RequestState.MIGRATING,
                               reason=f"preempted by {item.rid}",
                               engine=handle.name)
        self.park_blob(handle.name, blob, origin="preempt")
        return True

    def _dispatch_fresh(self, item: WorkItem, handles,
                        slack: float | None, now: float):
        req = item.req
        route = lambda: self.router.route(  # noqa: E731
            handles, self.cfg, sensitivity=req.sensitivity,
            prefill_tokens=len(req.prompt),
            decode_tokens=req.max_new_tokens, deadline_slack=slack,
            quality_floor=req.quality_floor,
            tokens=req.prompt, tenant=req.tenant,
            fabric=self.fabric)
        dec = route()
        if dec.target is None and dec.saturated \
                and self._park_victim(item, handles):
            dec = route()
        if dec.target is None:
            return
        handle = self.handles[dec.target]
        try:
            placed = handle.engine.add_request(req)
        except ValueError as e:       # refused before the slot was taken
            self.queue.remove(item.rid)
            self.ticket_transition(req.rid, RequestState.FAILED,
                                   reason=f"{handle.name}: {e}",
                                   engine=handle.name)
            return
        if not placed:
            # the engine refused what its can_admit accepted: a matched
            # prefix chain counts both as cached and as evictable there
            # (ROADMAP Queue 3); the request stays queued, where the JAX
            # package asserts
            return
        self.queue.remove(item.rid)
        self.inflight[req.rid] = (req, handle.name, item.t_submit)
        self.placements.setdefault(req.rid, []).append(handle.name)
        self.telemetry.record_admit(handle.name)
        self.telemetry.record_queue_wait(now - item.t_submit)
        if dec.degraded:
            # routed below the best tier it could have had: a typed
            # downshift on the audit log, naming the cause
            self.telemetry.record_quality(QualityEvent(
                rid=req.rid, src_tier=dec.preferred or "",
                dst_tier=dec.tier or "", direction="down",
                reason=dec.cause or dec.reason, quality=dec.quality,
                engine=handle.name, t=now))
        self.ticket_transition(req.rid, RequestState.PREFILLING,
                               engine=handle.name, reason=dec.reason)
        if self.tracer is not None:
            # the routing decision's facts land on the prefill span;
            # the ACTUAL hit the engine served (authoritative -- the
            # router's estimate can lag a concurrent eviction) rides
            # along with the KV bytes it did not recompute
            attrs = dec.to_attrs()
            hit = getattr(handle.engine, "last_prefix_hit", 0)
            if hit:
                attrs["prefix_hit_tokens"] = hit
                attrs["prefix_bytes_saved"] = \
                    hit * handle.engine.kv_token_bytes
            self.tracer.annotate(req.rid, **attrs)
        spec = self.spec_controllers.get(handle.name)
        if spec is not None and spec.attach(req) == "spec":
            # the replica slot lives on the verify engine: audit it
            self.placements[req.rid].append(spec.verify.name)
            self.ticket_transition(
                req.rid, RequestState.DRAFTING, engine=handle.name,
                reason=f"tier pair {handle.name}->{spec.verify.name}")
        else:
            self.ticket_transition(req.rid, RequestState.DECODING,
                                   engine=handle.name)

    def _dispatch_parked(self, item: WorkItem, handles,
                         slack: float | None, now: float):
        reason = {"preempt": "resume",
                  "drain": "drain"}.get(item.origin, "failover")
        place = lambda: self.balancer.place_blob(  # noqa: E731
            item.blob, handles, self, src=item.src, reason=reason,
            deadline_slack=slack, src_tier=item.src_tier or None)
        try:
            rec = place()
            if rec is None and self._park_victim(item, handles):
                rec = place()
        except ReprefillRefused as e:
            self.queue.remove(item.rid)
            self.ticket_transition(item.rid, RequestState.FAILED,
                                   reason=str(e), engine=item.src or None)
            return
        if rec is None:
            return
        self.queue.remove(item.rid)
        self.telemetry.record_migration(rec)
        if item.origin == "preempt":
            self.telemetry.record_resume(now - item.parked_at)

    def _dispatch(self):
        now = self.clock()
        self._expire(now)
        # verify-tier engines are reserved replica capacity, never
        # dispatch targets
        handles = [h for h in self.handles.values()
                   if h.healthy and h.spec_role != "verify"]
        for item in self.queue.ordered(now=now,
                                       aging_rate=self.aging_rate):
            slack = None if item.deadline is None else item.deadline - now
            if item.parked:
                self._dispatch_parked(item, handles, slack, now)
            else:
                self._dispatch_fresh(item, handles, slack, now)

    # -- the fleet step ----------------------------------------------------------
    def step(self) -> dict[str, int]:
        """Autoscale, dispatch, advance every healthy engine one decode
        step, retire completions, shadow-checkpoint.  Returns
        {rid: token} emitted."""
        if self.autoscaler is not None:
            # before dispatch: a spawn decision serves THIS step's
            # backlog, and a retire decision's displaced slots re-place
            # in this step's dispatch pass.  Expire first so the
            # autoscaler never spawns for (or counts) work that is
            # already dead -- and sees this step's expiries as signal
            self._expire(self.clock())
            self.autoscaler.step(self)
        self._dispatch()
        emitted: dict[str, int] = {}
        for handle in self.handles.values():
            if handle.spec_role is not None:
                continue             # stepped by its tier controller
            if not handle.healthy or not handle.engine.requests:
                continue
            t0 = self.clock()
            out = handle.engine.step()
            self.telemetry.record_step(handle.name, len(out),
                                       self.clock() - t0)
            emitted.update(out)
        for dname, spec in list(self.spec_controllers.items()):
            try:
                emitted.update(spec.step())
            except ConnectionError:
                # the pair circuit itself went down mid-round: degrade,
                # don't crash -- the pair dissolves and its requests
                # continue local-only on the draft engine
                self._dissolve_pair(self.handles[dname], graceful=True)
        now = self.clock()
        for rid in list(self.inflight):
            req, hname, t0 = self.inflight[rid]
            if req.done:
                self.done[rid] = req
                del self.inflight[rid]
                self.telemetry.record_complete(hname, now - t0)
                self.ticket_transition(rid, RequestState.DONE,
                                       engine=hname)
        self.balancer.after_step(self)
        if self.rebalance_every and \
                self._steps % self.rebalance_every == self.rebalance_every - 1:
            for rec in self.balancer.rebalance(self):
                self.telemetry.record_migration(rec)
        for handle in self.handles.values():
            self._harvest_prefix(handle)
        if self.autoscaler is not None:
            # after dispatch: replenishing the warm-standby pool is the
            # one remaining seconds-scale cost (and only on a
            # cache-cold geometry) -- it must never delay queued work
            replenish = getattr(self.autoscaler, "replenish", None)
            if replenish is not None:
                replenish(self)
        self._steps += 1
        return emitted

    def _harvest_prefix(self, handle: EngineHandle):
        """Fold this engine's prefix-cache stats DELTA into fleet
        telemetry.  The cache counts every mutation site locally
        (admission hits, migration injects, pressure reclaims); the
        fleet polls the monotone totals and accumulates only what is
        new, so the counters survive the engine's retirement without
        double counting."""
        cache = getattr(handle.engine, "prefix_cache", None)
        if cache is None:
            return
        cur = cache.stats.as_dict()
        seen = self._prefix_seen.get(handle.name, {})
        delta = {k: cur[k] - seen.get(k, 0)
                 for k in ("hits", "misses", "evictions", "bytes_saved")}
        if any(delta.values()):
            self.telemetry.record_prefix(**delta)
        self._prefix_seen[handle.name] = cur

    def run(self, reqs: list[Request] | None = None, *,
            max_steps: int = 10_000) -> dict[str, list[int]]:
        """Serve ``reqs`` (plus anything already queued) to completion
        -- the thin batch-mode wrapper over the ticket API.

        Stops early when the fleet is *stalled*: nothing in flight and a
        step changed nothing, i.e. queued work no engine is eligible to
        take (e.g. confidential requests with no attested engine left).
        ``self.stalled`` then names the stuck request ids."""
        pending = list(reqs or [])
        self.stalled = []
        for _ in range(max_steps):
            # only offer work when the queue has room: the caller's
            # backlog is not an admission rejection
            while pending and len(self.queue) < self.queue_limit \
                    and self._admit(pending[0]):
                pending.pop(0)
            if not (pending or self.queue or self.inflight):
                break
            qlen, orph = len(self.queue), len(self.orphans)
            self.step()
            if self.is_stalled(qlen, orph):
                # slots may have freed this very step: one more dispatch
                # before declaring the backlog unserveable
                self._dispatch()
                if self.is_stalled(qlen, orph):
                    self.stalled = [r.rid for r, _ in self.queue] + \
                        [peek_slot_meta(b)["rid"] for _, b in self.orphans]
                    break
        return {rid: req.output for rid, req in self.done.items()}

    def is_stalled(self, qlen: int, orph: int) -> bool:
        """True when nothing can ever change: no request is decoding on
        a healthy engine, and the last step left the queue and parked
        list exactly as it found them."""
        if any(self.handles[h].healthy
               for _, h, _ in self.inflight.values()):
            return False
        return (len(self.queue) == qlen and len(self.orphans) == orph
                and bool(self.queue or self.inflight))

    # -- membership events ---------------------------------------------------------
    def add_engine(self, handle: EngineHandle) -> EngineHandle:
        """Register a late-joining engine (scale-up).  The new engine
        serves the same config, gets an attester from the fleet
        authority when its profile attests (so a spawned engine can
        take confidential work an unattested fleet could not), and is
        immediately visible to the router, balancer and telemetry --
        queued and parked work dispatches onto it at the next dispatch
        pass."""
        assert handle.name not in self.handles, \
            f"engine name {handle.name!r} already registered"
        # cross-model fleets: tiers run distinct weights and even
        # distinct (smaller) configs, but every tier must speak the
        # same tokenizer or committed token streams are untranslatable
        assert handle.engine.cfg.vocab_size == self.cfg.vocab_size, \
            (f"tokenizer mismatch: {handle.engine.cfg.name} vocab "
             f"{handle.engine.cfg.vocab_size} != {self.cfg.vocab_size}")
        self.tiers.setdefault(handle.tier.name, handle.tier)
        self.whitelist.add(measure_config(handle.engine.cfg))
        if self.authority is not None and handle.profile.attested \
                and handle.attester is None:
            handle.attester = Attester(handle.name, self.authority,
                                       measure_config(handle.engine.cfg),
                                       capabilities(handle.engine.cfg))
        self.handles[handle.name] = handle
        self.telemetry.stats(handle.name)     # appears in summaries now
        self.telemetry.note_tier(handle.name, handle.tier.name)
        self._wire_profile(handle)
        return handle

    def _wire_profile(self, handle: EngineHandle):
        """Point the engine's profile hook at the tracer (each program's
        first run, the kernels' build included when it is their first
        use), unless the caller already installed one."""
        if self.tracer is None:
            return
        if getattr(handle.engine, "profile_hook", None) is None:
            tracer, name = self.tracer, handle.name
            handle.engine.profile_hook = \
                lambda key, wall_s, **meta: tracer.record_jit(
                    name, key, wall_s, **meta)

    def set_link(self, name: str, cond: NetworkCondition | None):
        """Inject (or clear) link conditions for one engine: the fleet-
        level availability knob.  A downed/lossy link makes the engine
        unreachable to the router, and requests degrade to reachable
        tiers instead of queueing behind a dead uplink.

        The condition doubles as the engine's *endpoint uplink* on the
        shared fabric: every routed pair path that crosses this engine
        (router cost, tier degradation, migration channels) composes it
        with the pair's own link condition -- degradation is a property
        of the route, not a per-handle flag.  A draft/verify tier
        pair's wire is a pinned circuit (``Fabric.pair_link``) and
        keeps serving verify rounds across an uplink outage."""
        self.handles[name].cond = cond
        self.fabric.set_endpoint(name, cond)

    def retire_engine(self, name: str, *, reason: str = "scale-down") \
            -> int:
        """Remove an engine from the fleet without losing a single
        request: scaling is migration, the same way preemption is.
        Every live slot leaves through the migration departure path --
        ``drain()`` live-migrates what the survivors can take right
        now, and whatever has nowhere to go is parked on the work queue
        (``extract_slot -> pack_slot -> park_blob``) exactly like a
        preempted slot, to be re-placed by a later dispatch pass.  Only
        then is the handle deregistered.  Returns the number of slots
        displaced (migrated + parked)."""
        handle = self.handles[name]
        assert len(self.handles) > 1, "cannot retire the last engine"
        if handle.spec_role is not None:
            self._dissolve_pair(handle, graceful=True)
        recs = self.balancer.drain(handle, self)
        for rec in recs:
            self.telemetry.record_migration(rec)
        parked = 0
        for slot in sorted(handle.engine.requests):
            snap = handle.engine.extract_slot(slot)
            if self.tracer is not None:
                snap.trace = self.tracer.wire_context(snap.rid, src=name)
            blob = pack_slot(snap)
            self.balancer.shadow.get(name, {}).pop(snap.rid, None)
            self.inflight.pop(snap.rid, None)
            # stable "scale-down ... parked off" audit prefix: tests and
            # operators grep it regardless of the caller's policy reason
            self.ticket_transition(
                snap.rid, RequestState.MIGRATING,
                reason=f"scale-down: parked off {name} ({reason})",
                engine=name)
            self.park_blob(name, blob, origin="drain")
            parked += 1
        self.balancer.shadow.pop(name, None)
        handle.healthy = False
        self.telemetry.stats(name).retired = True
        self._harvest_prefix(handle)     # final delta before the handle goes
        del self.handles[name]
        self._prefix_seen.pop(name, None)
        return len(recs) + parked

    def fail(self, name: str, *, reason: str = "crash"):
        """Fail-stop an engine at the fleet stable point: mark it dead,
        then re-place its in-flight requests from shadow checkpoints."""
        handle = self.handles[name]
        handle.healthy = False
        self.telemetry.record_failure(name)
        self._harvest_prefix(handle)     # crash loses pages, not counters
        if handle.spec_role is not None:
            self._dissolve_pair(handle)
        for rec in self.balancer.on_failure(handle, self):
            self.telemetry.record_migration(rec)

    def _dissolve_pair(self, handle: EngineHandle, *,
                       graceful: bool = False):
        """Unpair a draft/verify tier.  ``graceful`` (planned drain)
        rolls every speculative request back to its committed prefix and
        keeps it decoding local-only; the crash form defers to the
        controller's failure handling.  Either way the reserved verify
        engine rejoins the routable fleet."""
        for dname, spec in list(self.spec_controllers.items()):
            if handle.name not in (spec.draft.name, spec.verify.name):
                continue
            spec_rids = list(spec._spec)
            if graceful:
                spec.dissolve()
            else:
                spec.on_engine_failure(handle.name)
            spec.draft.spec_role = spec.verify.spec_role = None
            del self.spec_controllers[dname]
            if graceful or handle.name == spec.verify.name:
                # the requests stay live on the draft engine, local-only
                # (draft-death restarts are requeued by the balancer)
                for rid in spec_rids:
                    self.ticket_transition(
                        rid, RequestState.DECODING,
                        reason="tier pair dissolved: local-only",
                        engine=spec.draft.name)

    def drain(self, name: str) -> int:
        """Planned removal: live-migrate every slot off ``name``.  A
        tier-paired engine dissolves its pair first (speculative
        requests drop uncommitted tails and continue local-only), then
        drains like any other engine."""
        handle = self.handles[name]
        if handle.spec_role is not None:
            self._dissolve_pair(handle, graceful=True)
        recs = self.balancer.drain(handle, self)
        for rec in recs:
            self.telemetry.record_migration(rec)
        if not handle.engine.requests:
            handle.healthy = False
        return len(recs)
