"""First-class request lifecycle: tickets, priorities, deadlines,
preemption-by-migration.

The fleet's public unit of work is split in two:

  * ``RequestSpec``   -- the immutable order: prompt, decode params,
    sensitivity, plus ``priority`` (higher preempts lower) and
    ``deadline`` (absolute time on the fleet clock after which queued or
    parked work expires instead of running).
  * ``RequestTicket`` -- the live handle ``FleetController.submit``
    returns: a typed state machine the caller can observe
    (``ticket.state``), stream (``tokens()`` yields newly *committed*
    tokens), cancel (``cancel()`` frees the slot immediately), or block
    on (``result()`` drives the fleet until the ticket is terminal).

State machine::

    QUEUED -> PREFILLING -> DECODING <-> MIGRATING
                         -> DRAFTING <-> VERIFYING
                            DRAFTING  -> MIGRATING  (spec slot parked)
    any non-terminal     -> DONE | FAILED | CANCELLED | EXPIRED | HALTED

``MIGRATING`` covers every off-engine moment: a live move between
engines, a failover snapshot awaiting re-placement, and a *parked*
preempted slot.  Preemption is migration: the lowest-priority in-flight
slot is ``extract_slot``/``pack_slot``-parked fleet-side and resumes
bit-identically later through the same re-placement path a failover
orphan uses -- the paper's thesis that in-flight state is a schedulable
object.

Every transition is a typed ``LifecycleEvent`` on the fleet-wide audit
log (``FleetTelemetry.events``), shared by the cluster, the balancer and
the speculative tier controller.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from enum import Enum
from typing import ClassVar, Optional

import numpy as np

from repro_torch.serving.engine import Request


class RequestState(str, Enum):
    QUEUED = "queued"          # admitted, no device state yet
    PREFILLING = "prefilling"  # placed, prompt entering the cache
    DECODING = "decoding"      # advancing one token per fleet step
    MIGRATING = "migrating"    # off-engine: moving, orphaned, or parked
    DRAFTING = "drafting"      # speculative pair: free-running drafts
    VERIFYING = "verifying"    # speculative pair: tail under verification
    DONE = "done"              # completed, output final
    FAILED = "failed"          # unserveable (no eligible engine left)
    CANCELLED = "cancelled"    # caller cancelled
    EXPIRED = "expired"        # deadline passed while queued/parked
    HALTED = "halted"          # validator stopped the stream mid-flight


TERMINAL_STATES = frozenset({
    RequestState.DONE, RequestState.FAILED, RequestState.CANCELLED,
    RequestState.EXPIRED, RequestState.HALTED,
})

_ALLOWED = {
    RequestState.QUEUED: {RequestState.PREFILLING, RequestState.CANCELLED,
                          RequestState.EXPIRED, RequestState.FAILED},
    RequestState.PREFILLING: {RequestState.DECODING, RequestState.DRAFTING,
                              RequestState.CANCELLED, RequestState.FAILED},
    RequestState.DECODING: {RequestState.DONE, RequestState.HALTED,
                            RequestState.CANCELLED, RequestState.MIGRATING,
                            RequestState.QUEUED, RequestState.DRAFTING,
                            RequestState.FAILED},
    RequestState.MIGRATING: {RequestState.DECODING, RequestState.CANCELLED,
                             RequestState.EXPIRED, RequestState.QUEUED,
                             RequestState.FAILED},
    # DRAFTING -> MIGRATING: a speculative slot preempted/parked (its
    # uncommitted tail rolled back first, replica slot dissolved)
    RequestState.DRAFTING: {RequestState.VERIFYING, RequestState.DECODING,
                            RequestState.DONE, RequestState.HALTED,
                            RequestState.CANCELLED, RequestState.QUEUED,
                            RequestState.MIGRATING, RequestState.FAILED},
    RequestState.VERIFYING: {RequestState.DRAFTING, RequestState.DONE,
                             RequestState.HALTED, RequestState.FAILED},
}


class LifecycleError(RuntimeError):
    """Illegal state transition, or ``result()`` on a dead ticket."""


class RequestCancelled(LifecycleError):
    pass


class DeadlineExpired(LifecycleError):
    pass


class RequestFailed(LifecycleError):
    pass


@dataclass
class LifecycleEvent:
    """One typed transition on the fleet-wide audit log."""
    kind: ClassVar[str] = "lifecycle"  # audit-log discriminator
    rid: str
    src: str                         # RequestState value ("" at submit)
    dst: str
    reason: str = ""
    engine: Optional[str] = None
    t: float = 0.0                   # fleet clock at the transition


@dataclass(frozen=True)
class RequestSpec:
    """The immutable half of a request: everything the caller decides
    up front.  ``priority`` orders dispatch (higher first; FIFO within a
    class) and arms preemption; ``deadline`` is an *absolute* time on
    the fleet clock -- queued or parked work past it expires instead of
    occupying capacity."""
    prompt: np.ndarray
    rid: Optional[str] = None        # auto-assigned when None
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    sensitivity: str = "public"      # public | personal | confidential
    priority: int = 0
    deadline: Optional[float] = None
    # minimum acceptable tier quality in [0,1]: the router may degrade
    # this request to a cheaper model tier under saturation / deadline
    # pressure / link failure, but never below this floor (0 = any tier)
    quality_floor: float = 0.0
    # prefix-cache namespace: requests of one tenant share cached KV
    # pages with each other ("" = the anonymous default tenant)
    tenant: str = ""

    def to_request(self, rid: str) -> Request:
        """Materialize the mutable engine-side carrier."""
        return Request(rid=rid, prompt=np.asarray(self.prompt),
                       max_new_tokens=self.max_new_tokens,
                       temperature=self.temperature, top_k=self.top_k,
                       sensitivity=self.sensitivity,
                       priority=self.priority, deadline=self.deadline,
                       quality_floor=self.quality_floor,
                       tenant=self.tenant)


def spec_of_request(req: Request) -> RequestSpec:
    """Freeze a legacy mutable Request into its spec (back-compat)."""
    return RequestSpec(prompt=req.prompt, rid=req.rid,
                       max_new_tokens=req.max_new_tokens,
                       temperature=req.temperature, top_k=req.top_k,
                       sensitivity=req.sensitivity, priority=req.priority,
                       deadline=req.deadline,
                       quality_floor=req.quality_floor,
                       tenant=req.tenant)


class RequestTicket:
    """Live handle for one submitted request.

    The ticket never holds tokens itself: ``output``/``tokens()`` read
    the *committed* stream through the fleet (a drafting request's
    uncommitted speculative tail is invisible here), so the view stays
    correct across migrations, preemption parks and tier hand-offs.
    """

    def __init__(self, spec: RequestSpec, req: Request, fleet):
        self.spec = spec
        self.rid = req.rid
        self._req = req              # live engine-side object (reassigned
        self._fleet = fleet          # on every inject_slot)
        self.seq = -1                # admission order, set at enqueue
        self.submitted_at = fleet.clock()
        self.state = RequestState.QUEUED
        self.events: list[LifecycleEvent] = []
        self._stream_pos = 0
        self._record("", RequestState.QUEUED, reason="submitted")

    # -- the state machine ----------------------------------------------------
    def _record(self, src, dst: RequestState, *, reason="", engine=None):
        ev = LifecycleEvent(rid=self.rid,
                            src=src.value if src else "",
                            dst=dst.value, reason=reason, engine=engine,
                            t=self._fleet.clock())
        self.events.append(ev)
        self._fleet.telemetry.record_event(ev)

    def _transition(self, dst: RequestState, *, reason: str = "",
                    engine: Optional[str] = None):
        if dst is self.state:
            return
        if dst not in _ALLOWED.get(self.state, frozenset()):
            raise LifecycleError(
                f"{self.rid}: illegal transition "
                f"{self.state.value} -> {dst.value} ({reason!r})")
        src, self.state = self.state, dst
        self._record(src, dst, reason=reason, engine=engine)

    @property
    def done(self) -> bool:
        return self.state in TERMINAL_STATES

    @property
    def request(self) -> Request:
        return self._req

    # -- observation ----------------------------------------------------------
    @property
    def output(self) -> list[int]:
        """The committed token stream so far (uncommitted drafts hidden)."""
        return self._fleet.committed_output(self.rid)

    def tokens(self) -> list[int]:
        """Newly committed tokens since the last ``tokens()`` call --
        the incremental streaming read."""
        out = self.output
        new, self._stream_pos = out[self._stream_pos:], len(out)
        return new

    def timeline(self) -> list:
        """This request's span tree so far (chronological ``Span`` list
        from the fleet tracer); empty when tracing is disabled."""
        tracer = getattr(self._fleet.telemetry, "tracer", None)
        if tracer is None:
            return []
        return tracer.trace_of(self.rid)

    # -- control --------------------------------------------------------------
    def cancel(self, *, reason: str = "caller cancelled") -> bool:
        """Cancel this request.  Queued/parked work is dropped and an
        in-flight slot is retired immediately; returns False when the
        ticket is already terminal."""
        return self._fleet.cancel(self.rid, reason=reason)

    def result(self, *, max_steps: int = 10_000) -> list[int]:
        """Drive the fleet until this ticket is terminal.

        Returns the committed output for ``DONE``/``HALTED``; raises
        ``RequestCancelled`` / ``DeadlineExpired`` / ``RequestFailed``
        for the other terminals.  A fleet-wide stall (no eligible engine
        will ever take the work) fails the ticket rather than spinning.

        In service mode (a ``ControlPlane`` owns the engines) the caller
        must *not* drive ``fleet.step()`` -- the engines belong to their
        service threads.  There ``result()`` just waits for the service
        loops to finish the ticket, bounded by ``max_steps`` polls.
        """
        fleet = self._fleet
        service = getattr(fleet, "service", None)
        if service is not None and getattr(service, "running", False):
            wait_s = max(getattr(service, "poll_s", 0.002), 1e-4)
            for _ in range(max_steps):
                if self.done:
                    break
                time.sleep(wait_s)
            return self._terminal_result(max_steps)
        for _ in range(max_steps):
            if self.done:
                break
            qlen, orph = len(fleet.queue), len(fleet.orphans)
            fleet.step()
            if fleet.is_stalled(qlen, orph):
                fleet._dispatch()    # slots may have freed this step
                if fleet.is_stalled(qlen, orph) and not self.done:
                    fleet.abandon(self.rid,
                                  reason="stalled: no eligible engine")
                    break
        return self._terminal_result(max_steps)

    def _terminal_result(self, max_steps: int) -> list[int]:
        if self.state in (RequestState.DONE, RequestState.HALTED):
            return self.output
        if self.state is RequestState.CANCELLED:
            raise RequestCancelled(self.rid)
        if self.state is RequestState.EXPIRED:
            raise DeadlineExpired(self.rid)
        if not self.done:
            # ran out of steps, not out of options: the ticket is still
            # live and a later step() can finish it -- do not claim a
            # terminal failure
            raise LifecycleError(
                f"{self.rid}: still {self.state.value} after "
                f"{max_steps} steps")
        raise RequestFailed(f"{self.rid}: {self.state.value}")


# ---------------------------------------------------------------------------
# the pending-work structure
# ---------------------------------------------------------------------------

@dataclass
class WorkItem:
    """One unit of pending fleet work: either a fresh admission
    (``req`` set) or a parked slot snapshot (``blob`` set -- a preempted
    or failover-orphaned request holding real device state)."""
    rid: str
    priority: int
    seq: int                         # admission order (kept across parks)
    t_submit: float
    sensitivity: str = "public"
    rows_needed: int = 0             # prompt + max_new context rows
    deadline: Optional[float] = None
    quality_floor: float = 0.0       # min tier quality on re-placement
    ticket: Optional[RequestTicket] = None
    req: Optional[Request] = None
    blob: Optional[bytes] = None     # packed SlotSnapshot when parked
    src: str = ""                    # engine the parked slot left
    src_tier: str = ""               # tier the parked slot's state is from
    origin: str = ""                 # "preempt" | "failover"
    parked_at: float = 0.0

    @property
    def parked(self) -> bool:
        return self.blob is not None


def effective_priority(item, now: float = 0.0,
                       aging_rate: float = 0.0) -> float:
    """Dispatch priority after aging: the declared class plus
    ``aging_rate`` points per second spent waiting since submission.
    With a positive rate a starved low-priority item eventually
    out-ranks any *later* high-priority arrival (two items submitted at
    the same instant never reorder) -- starvation freedom against an
    endless stream of fresh urgent work.  Aging affects dispatch order
    only; preemption always reads the declared priority, so an aged
    item never starts parking live slots."""
    if aging_rate <= 0.0:
        return float(item.priority)
    return item.priority + aging_rate * max(now - item.t_submit, 0.0)


def work_order(items, *, now: float = 0.0,
               aging_rate: float = 0.0) -> list:
    """Dispatch order: highest (aged) priority first, submit order (seq)
    within a class.  Parked items keep their original seq AND t_submit,
    so a preempted request resumes ahead of anything submitted after it
    and keeps accruing age while parked."""
    return sorted(items,
                  key=lambda it: (-effective_priority(it, now, aging_rate),
                                  it.seq))


class WorkQueue:
    """All pending fleet work -- fresh admissions and parked slots -- in
    one priority-ordered structure.

    The legacy views are preserved: ``len()``/iteration cover only the
    fresh entries (as ``(request, t_submitted)`` pairs, the
    pre-lifecycle queue contract), while parked entries surface through
    ``FleetController.orphans``.
    """

    def __init__(self):
        self._items: list[WorkItem] = []
        self._next_seq = 0

    def next_seq(self) -> int:
        seq, self._next_seq = self._next_seq, self._next_seq + 1
        return seq

    def push(self, item: WorkItem):
        assert self.find(item.rid) is None, f"{item.rid} already queued"
        self._items.append(item)

    def find(self, rid: str) -> Optional[WorkItem]:
        for it in self._items:
            if it.rid == rid:
                return it
        return None

    def remove(self, rid: str) -> Optional[WorkItem]:
        it = self.find(rid)
        if it is not None:
            self._items.remove(it)
        return it

    def ordered(self, *, now: float = 0.0,
                aging_rate: float = 0.0) -> list[WorkItem]:
        return work_order(self._items, now=now, aging_rate=aging_rate)

    def depth(self) -> int:
        """Total pending work -- fresh admissions AND parked slots (the
        autoscaler's backlog signal; ``len()`` stays the legacy
        fresh-only admission-control depth)."""
        return len(self._items)

    def expired(self, now: float) -> list[WorkItem]:
        return [it for it in self._items
                if it.deadline is not None and it.deadline <= now]

    def fresh(self) -> list[WorkItem]:
        return [it for it in self._items if not it.parked]

    def parked(self) -> list[WorkItem]:
        return [it for it in self._items if it.parked]

    def __len__(self) -> int:         # legacy: admission-control depth
        return len(self.fresh())

    def __bool__(self) -> bool:       # any pending work at all
        return bool(self._items)

    def __iter__(self):               # legacy: (request, t_submitted)
        for it in self.fresh():
            yield it.req, it.t_submit
