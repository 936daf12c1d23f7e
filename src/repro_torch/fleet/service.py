"""Engine services + the control plane: the fleet as a distributed
system instead of one synchronous loop.

``EngineService`` owns one engine.  It pulls typed messages from its
mailbox (place / inject / cancel / extract / stop), advances its own
decode loop, and pushes one-way reports back: per-step committed-token
deltas, completion reports, periodic shadow checkpoints, heartbeats.
On the socket transport each service runs on its own thread.  The JAX
package's services decode concurrently because a jitted call releases
the GIL; the port's step is Python per layer and holds the GIL while
it launches, so its services overlap only where a thread waits (the
card, a socket, a host copy).

``ControlPlane`` is what remains of the controller once the engines
move out: membership, admission, ticket state, routing decisions, RPC
reliability and failure detection.  It owns no engine compute; every
placement is a message.  Exactly-once placement over a lossy transport
comes from the usual pair: the control plane retries an unacked RPC
under the same ``req_id``, and the service deduplicates (by ``req_id``
via ``DedupCache`` and by live/finished rid), so a dropped frame,
a delayed frame, or a retried inject neither loses nor duplicates a
request.  Peer death is handled by liveness, not by traffic: a service
that stops heartbeating is declared failed on the fleet clock
(``HeartbeatLoss`` on the audit log) and its slots re-place from their
shadow checkpoints through the existing parked-work failover path.

Determinism: the same code paths run threadless on the in-process
transport -- tests call ``ControlPlane.tick()`` / ``EngineService.tick()``
by hand, so every contract of the synchronous fleet (bit-exact decode,
conservation) is checkable step by step.

Scope: service mode covers plain engines -- speculative draft/verify
pairs, the autoscaler and preemption remain synchronous-fleet features.

Where the port departs from the JAX package (ROADMAP Queue 3):
  * a service thread that dies of an exception stops heartbeating (the
    JAX heartbeat thread beats on for a dead service, whose requests
    then hang): the detector declares it failed and its slots fail
    over; the exception rides the failure's reason;
  * the socket transport's ``MAX_FRAME`` is 1 GiB, not 64 MiB (the JAX
    reader drops a frame over its limit and closes the connection
    silently, and a full-width slot blob is 100-200 MB); a message over
    it is refused at the sender and counted -- a refused inject fails
    its ticket, a refused shadow leaves the previous shadow in place;
  * a lossy re-prefill the target cannot take in one prefill (the
    prefill domain), or a fresh prompt outside it, is acked
    ``{"ok": False, "refused": True}`` before any page or slot moves,
    and the control plane fails the ticket with the reason;
  * a failed engine's shadow of a request whose placement ack never
    landed (still QUEUED control-side) fails over like any other, the
    ticket walked through the states the ack would have driven; the
    JAX control thread dies of ``LifecycleError`` there;
  * an ack that lands after its placement RPC expired is not ignored:
    a request still waiting in the queue adopts that placement, and
    otherwise the engine's copy is a duplicate and is cancelled (the
    JAX package ignores the ack, and the request decodes on two
    engines to the end).  A duplicate that finishes first ends the
    ticket and the other copy is cancelled; only the engine the
    control plane holds a request on reports its tokens.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.channel import FrameTooLarge, InProcTransport, Transport
from repro_torch.core.migration import pack_slot, repack_slot, unpack_slot
from repro_torch.core.msgpack_subset import packb
from repro_torch.fleet.balancer import (check_reprefill, peek_slot_header,
                                        peek_slot_meta, room_for,
                                        wire_compatible)
from repro_torch.fleet.bus import (DedupCache, FailureDetector, HeartbeatLoss,
                                   Mailbox, Message, MessageBus)
from repro_torch.fleet.lifecycle import RequestState, WorkItem
from repro_torch.fleet.telemetry import MigrationRecord, QualityEvent
from repro_torch.serving.engine import request_from_dict, request_to_dict

__all__ = ["EngineService", "ControlPlane", "CONTROL"]

CONTROL = "ctl"                      # the control plane's bus address


class EngineService:
    """One engine behind one mailbox.

    The service is deliberately fleet-blind: it sees its engine, its
    mailbox, and (same-process observability shortcuts) the thread-safe
    telemetry/tracer.  All fleet state -- tickets, queue, placement --
    lives across the bus in the control plane.
    """

    def __init__(self, name: str, engine, mailbox: Mailbox,
                 bus: MessageBus, *, clock, telemetry=None, tracer=None,
                 tier_name: str = "", sync_every: int = 8,
                 hb_interval_s: float = 0.01):
        self.name = name
        self.engine = engine
        self.mailbox = mailbox
        self.bus = bus
        self.clock = clock
        self.telemetry = telemetry
        self.tracer = tracer
        self.tier_name = tier_name
        self.sync_every = sync_every
        self.hb_interval_s = hb_interval_s
        self._dedup = DedupCache()
        self._done_rids: set[str] = set()   # completed here (idempotency)
        # completions the control plane has not confirmed yet: a "done"
        # report is the one fact that cannot tolerate frame loss (the
        # slot is retired, nothing else will ever mention the rid), so
        # it is re-offered on every heartbeat until a done_ack lands
        self._done_unacked: dict[str, list[int]] = {}
        # rid -> req_id of the RPC the control plane holds it under: a
        # cancel of an older RPC's copy must not retire a claimed one
        self._owner: dict[str, int] = {}
        self._steps = 0
        self._last_hb: float | None = None
        self._stop = False
        self.error: Optional[BaseException] = None   # what ended run()
        self.thread: Optional[threading.Thread] = None
        self._hb_thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------
    def start(self):
        self.thread = threading.Thread(target=self.run,
                                       name=f"svc-{self.name}",
                                       daemon=True)
        self.thread.start()
        # liveness must not ride the decode loop: a first step (the
        # kernels' build) blocks tick() for longer than any sane
        # heartbeat timeout, and a busy engine must still read as alive
        self._hb_thread = threading.Thread(target=self._hb_loop,
                                           name=f"hb-{self.name}",
                                           daemon=True)
        self._hb_thread.start()

    def alive(self) -> bool:
        """The service loop still runs (or, threadless, has not failed)."""
        if self._stop or self.error is not None:
            return False
        return self.thread is None or self.thread.is_alive()

    def _hb_loop(self):
        # beats only while the service loop lives: a dead service must
        # read as dead to the detector
        while self.alive():
            self._maybe_heartbeat()
            time.sleep(self.hb_interval_s)

    def request_stop(self):
        self._stop = True

    def run(self):
        """Thread body: tick until stopped, blocking briefly on the
        mailbox when idle so heartbeats still go out on time.  An
        exception ends the loop and is kept in ``error``."""
        try:
            while not self._stop:
                worked = self.tick()
                if not worked and not self._stop:
                    msg = self.mailbox.get(timeout=self.hb_interval_s / 2)
                    if msg is not None:
                        self._handle(msg)
        except Exception as e:       # noqa: BLE001 -- kept, then liveness
            self.error = e

    # -- one loop iteration ------------------------------------------
    def tick(self) -> bool:
        """Drain the mailbox, advance decode one step, report, shadow,
        heartbeat.  Returns True when any work was done (messages
        handled or tokens decoded) -- the threadless deterministic
        driver and the idle-wait in ``run`` both key off it."""
        worked = False
        for msg in self.mailbox.drain():
            self._handle(msg)
            worked = True
        if self._stop:
            return worked
        if self.engine.requests:
            self._decode_step()
            worked = True
        self._maybe_heartbeat()
        return worked

    def _decode_step(self):
        pre = dict(self.engine.requests)     # step() retires completions
        t0 = self.clock()
        out = self.engine.step()
        dt = self.clock() - t0
        if self.telemetry is not None:
            self.telemetry.record_step(self.name, len(out), dt)
        by_rid = {req.rid: req for req in pre.values()}
        emitted: dict[str, list] = {}
        done: dict[str, list] = {}
        for rid, tok in out.items():
            req = by_rid.get(rid)
            if req is None:
                continue
            emitted[rid] = [len(req.output) - 1, [int(tok)]]
            if req.done:
                done[rid] = [int(t) for t in req.output]
                self._done_rids.add(rid)
                self._owner.pop(rid, None)
                self._done_unacked[rid] = done[rid]
        self.bus.send(Message(
            type="report", src=self.name, dst=CONTROL,
            body={"emitted": emitted, "done": done, "dt": dt}))
        self._steps += 1
        if self.sync_every and self._steps % self.sync_every == 0 \
                and self.engine.requests:
            self._send_shadow()

    def _send_shadow(self):
        """Ship the current checkpoint set (the replica-sync analogue of
        the synchronous balancer's ``checkpoint``): the control plane
        replaces its shadow store for this engine wholesale, so
        completed/departed rids age out with the message.  A set the
        transport refuses for its size is counted on the bus, and the
        control plane keeps the last set that arrived."""
        blobs = {}
        for slot, req in list(self.engine.requests.items()):
            snap = self.engine.extract_slot(slot, keep=True)
            blobs[req.rid] = pack_slot(snap)
        try:
            self.bus.send(Message(type="shadow", src=self.name, dst=CONTROL,
                                  body={"blobs": blobs}))
        except FrameTooLarge:
            pass

    def _maybe_heartbeat(self):
        now = self.clock()
        if self._last_hb is None or now - self._last_hb \
                >= self.hb_interval_s:
            self._last_hb = now
            body: dict = {"t": now}
            if self._done_unacked:
                # at-least-once completion: re-offer until acknowledged
                body["done"] = dict(self._done_unacked)
            self.bus.send(Message(type="hb", src=self.name, dst=CONTROL,
                                  body=body))

    # -- message handling --------------------------------------------
    def _handle(self, msg: Message):
        if msg.type == "stop":
            self._stop = True
            return
        if msg.type == "done_ack":
            for rid in msg.body.get("rids", []):
                self._done_unacked.pop(rid, None)
            return
        if msg.type == "hb":
            return
        handler = {"place": self._on_place, "inject": self._on_inject,
                   "cancel": self._on_cancel,
                   "extract": self._on_extract}.get(msg.type)
        if handler is None:
            return                   # unknown one-way types are dropped
        if msg.req_id:
            prior = self._dedup.seen(msg.req_id)
            if prior is not None:    # retried RPC: re-ack, do not re-run
                self._ack(msg, prior)
                return
        body = handler(msg)
        if msg.req_id:
            if msg.type in ("place", "inject") and body.get("ok"):
                self._owner[msg.rid] = msg.req_id
            self._dedup.remember(msg.req_id, body)
            self._ack(msg, body)

    def _ack(self, msg: Message, body: dict):
        self.bus.send(Message(type="ack", src=self.name, dst=CONTROL,
                              rid=msg.rid, req_id=msg.req_id, body=body))

    def _live_rids(self) -> set[str]:
        return {req.rid for req in self.engine.requests.values()}

    def _admit(self, req, committed) -> dict | None:
        """``add_request`` behind the refusals the JAX package reaches
        as an assert inside the prefill: ``None`` when placed, else the
        ack body."""
        try:
            if committed:
                check_reprefill(self.engine, req, committed)
            placed = self.engine.add_request(req, committed=committed)
        except ValueError as e:      # refused before the slot was taken
            return {"ok": False, "why": str(e), "refused": True}
        return None if placed else {"ok": False, "why": "full"}

    def _on_place(self, msg: Message) -> dict:
        meta = msg.body["req"]
        rid = meta["rid"]
        if rid in self._live_rids() or rid in self._done_rids:
            return {"ok": True, "dup": True}
        req = request_from_dict(meta)
        req.done, req.slot = False, -1
        committed = meta.get("output") or None
        need = len(req.prompt) + req.max_new_tokens
        if not self.engine.can_admit(need):
            return {"ok": False, "why": "full"}
        refused = self._admit(req, committed)
        if refused is not None:
            return refused
        return {"ok": True, "prefix_hit":
                int(getattr(self.engine, "last_prefix_hit", 0))}

    def _on_inject(self, msg: Message) -> dict:
        blob = msg.body["blob"]
        src_tier = msg.body.get("src_tier") or ""
        hdr = peek_slot_header(blob)
        meta = hdr["request"]
        rid = meta["rid"]
        if rid in self._live_rids() or rid in self._done_rids:
            return {"ok": True, "dup": True}
        tier_change = bool(src_tier) and bool(self.tier_name) \
            and src_tier != self.tier_name
        need = len(meta["prompt"]) + meta["max_new_tokens"]
        if not self.engine.can_admit(need):
            return {"ok": False, "why": "full"}
        if tier_change or not wire_compatible(hdr, self.engine):
            req = request_from_dict(meta)
            req.done, req.slot = False, -1
            refused = self._admit(req, meta["output"])
            if refused is not None:
                return refused
            return {"ok": True, "lossy": True, "tier_change": tier_change,
                    "wire_bytes": len(packb(meta))}
        snap = unpack_slot(blob, self.engine.slot_like())
        snap = repack_slot(snap, self.engine.max_len)
        if self.tracer is not None and snap.trace:
            self.tracer.bind_hop(snap.trace, dst=self.name)
        self.engine.inject_slot(snap)
        return {"ok": True, "lossy": False, "tier_change": False,
                "wire_bytes": len(blob)}

    def _on_cancel(self, msg: Message) -> dict:
        rid = msg.rid
        of = msg.body.get("of")
        if of is not None and self._owner.get(rid, of) != of:
            return {"ok": True, "kept": True}   # claimed by a later RPC
        for slot, req in list(self.engine.requests.items()):
            if req.rid == rid:
                self._owner.pop(rid, None)
                self.engine.retire(slot)
                return {"ok": True, "decoded": len(req.output)}
        return {"ok": True, "gone": True}

    def _on_extract(self, msg: Message) -> dict:
        """Demand one slot leave (control-driven drain): extract + pack
        and ship the blob back in the ack.  The service holds nothing --
        the control plane owns the blob from the ack on (parks it or
        places it), so a dead destination never strands state.  A blob
        the transport could not carry is refused with the slot kept."""
        rid = msg.rid
        for slot, req in list(self.engine.requests.items()):
            if req.rid == rid:
                snap = self.engine.extract_slot(slot, keep=True)
                if self.tracer is not None:
                    snap.trace = self.tracer.wire_context(rid,
                                                          src=self.name)
                blob = pack_slot(snap)
                limit = getattr(self.bus.transport, "MAX_FRAME", None)
                if limit is not None and len(blob) + 1024 > limit:
                    return {"ok": False, "why": f"blob of {len(blob)} bytes "
                            f"over the transport's {limit}"}
                self.engine.extract_slot(slot)
                return {"ok": True, "blob": blob}
        return {"ok": False,
                "why": "done" if rid in self._done_rids else "gone"}


@dataclass
class _Rpc:
    msg: Message
    deadline: float
    tries: int
    on_ack: object
    on_fail: object


@dataclass
class _Dispatch:
    """One in-flight placement RPC: the item stays on the work queue
    (conservation: a rid is queued until its placement is acked) and
    this marker keeps dispatch from re-sending it every tick."""
    req_id: int
    item: WorkItem
    target: str


class ControlPlane:
    """The thin half of the split: fleet state + messages, no compute.

    Wraps an existing ``FleetController`` (which keeps owning handles,
    queue, tickets, telemetry -- the *state*) and replaces its
    synchronous ``step()`` loop with services + RPCs.  Start it, submit
    through it, and tickets resolve as reports arrive.
    """

    def __init__(self, fleet, *, transport: Transport | None = None,
                 sync_every: int = 8, hb_interval_s: float = 0.01,
                 hb_timeout_s: float = 1.0, rpc_timeout_s: float = 0.5,
                 rpc_retries: int = 4, poll_s: float = 0.002):
        if fleet.spec_controllers:
            raise ValueError("service mode does not cover speculative tier "
                             "pairs (run them on the synchronous fleet)")
        if fleet.autoscaler is not None:
            raise ValueError("service mode does not cover the autoscaler")
        self.fleet = fleet
        fleet.service = self
        self.transport = transport or InProcTransport()
        self.bus = MessageBus(self.transport)
        self.detector = FailureDetector(timeout_s=hb_timeout_s,
                                        clock=fleet.clock)
        self.sync_every = sync_every
        self.hb_interval_s = hb_interval_s
        self.rpc_timeout_s = rpc_timeout_s
        self.rpc_retries = rpc_retries
        self.poll_s = poll_s
        self.services: dict[str, EngineService] = {}
        self.mailbox: Optional[Mailbox] = None
        self._rpc: dict[int, _Rpc] = {}
        # expired placement RPCs whose ack may still land
        self._late: dict[int, _Rpc] = {}
        self._dispatching: dict[str, _Dispatch] = {}
        self._next_req_id = 1
        self.retried = 0             # RPC frames re-sent after a timeout
        self.late_adopted = 0        # late acks whose placement was kept
        self.duplicates = 0          # copies cancelled on a second engine
        self.wasted_tokens = 0       # tokens those copies had decoded
        self.running = False
        self.threaded = False
        self.thread: Optional[threading.Thread] = None

    # -- wiring -------------------------------------------------------
    def start(self, *, threads: bool = True):
        """Register every node on the bus and (socket mode) start the
        service + control threads.  ``threads=False`` is the
        deterministic form: nothing runs until ``tick()`` is called."""
        fleet = self.fleet
        self.mailbox = self.bus.register(CONTROL)
        for handle in fleet.handles.values():
            box = self.bus.register(handle.name)
            svc = EngineService(
                handle.name, handle.engine, box, self.bus,
                clock=fleet.clock, telemetry=fleet.telemetry,
                tracer=fleet.tracer, tier_name=handle.tier.name,
                sync_every=self.sync_every,
                hb_interval_s=self.hb_interval_s)
            self.services[handle.name] = svc
            self.detector.expect(handle.name)
        self.running = True
        self.threaded = threads
        if threads:
            for svc in self.services.values():
                svc.start()
            self.thread = threading.Thread(target=self._run,
                                           name="ctl-plane", daemon=True)
            self.thread.start()
        return self

    def stop(self):
        self.running = False
        if self.thread is not None:
            self.thread.join(timeout=5.0)
        for svc in self.services.values():
            svc.request_stop()
            self.bus.send(Message(type="stop", src=CONTROL,
                                  dst=svc.name))
        if self.threaded:
            for svc in self.services.values():
                for th in (svc.thread, svc._hb_thread):
                    if th is not None:
                        th.join(timeout=5.0)
        self.fleet.service = None
        self.bus.close()

    def kill_service(self, name: str):
        """Crash one service (test hook for peer death): the thread
        stops, its bus endpoint closes, and NO failure handling runs --
        the fleet must notice via heartbeat loss."""
        svc = self.services.get(name)
        if svc is not None:
            svc.request_stop()
            if svc.thread is not None:
                svc.thread.join(timeout=5.0)
        self.bus.deregister(name)

    # -- the control loop --------------------------------------------
    def _run(self):
        while self.running:
            worked = self.tick()
            if not worked:
                msg = self.mailbox.get(timeout=self.poll_s)
                if msg is not None:
                    self._handle(msg)

    def tick(self) -> bool:
        """One control iteration: drain messages, expire deadlines,
        dispatch queued/parked work as RPCs, sweep RPC timeouts and
        heartbeats.  Deterministic tests call this by hand."""
        worked = False
        for msg in self.mailbox.drain():
            self._handle(msg)
            worked = True
        fleet = self.fleet
        now = fleet.clock()
        with fleet._lock:
            fleet._expire(now)
        self._dispatch(now)
        self._sweep_rpcs(now)
        self._sweep_heartbeats(now)
        return worked

    # -- submission / observation ------------------------------------
    def submit(self, spec):
        with self.fleet._lock:
            return self.fleet._admit(spec)

    def serve(self, specs, *, timeout_s: float = 60.0) \
            -> dict[str, list[int]]:
        """Submit everything, wait until every ticket is terminal (or
        the wall timeout), return {rid: committed output} of the done
        ones.  Threadless control planes are ticked inline."""
        tickets = [t for t in (self.submit(s) for s in specs)
                   if t is not None]
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < timeout_s:
            if not self.threaded:
                self.tick()
                for svc in self.services.values():
                    svc.tick()
            if all(t.done for t in tickets):
                break
            if self.threaded:
                time.sleep(self.poll_s)
        return {t.rid: list(t.output) for t in tickets
                if t.state == RequestState.DONE}

    def cancel(self, rid: str, *, reason: str = "caller cancelled") \
            -> bool:
        fleet = self.fleet
        with fleet._lock:
            ticket = fleet.tickets.get(rid)
            if ticket is None or ticket.done:
                return False
            disp = self._dispatching.pop(rid, None)
            if disp is not None:
                self._rpc.pop(disp.req_id, None)
            placed_on = None
            if rid in fleet.inflight:
                placed_on = fleet.inflight.pop(rid)[1]
            elif disp is not None:
                placed_on = disp.target
            fleet.queue.remove(rid)
            fleet.telemetry.record_cancelled()
            fleet.ticket_transition(rid, RequestState.CANCELLED,
                                    reason=reason)
        if placed_on is not None:
            # best-effort slot release; the service also self-cleans
            # when it next reports the rid done
            self._call(Message(type="cancel", src=CONTROL, dst=placed_on,
                               rid=rid),
                       on_ack=lambda body: None, on_fail=lambda: None)
        return True

    # -- RPC plumbing -------------------------------------------------
    # The RPC and dispatch tables are shared between the control thread
    # and user-thread entry points (cancel); the fleet RLock guards
    # both, and ack closures re-acquire it reentrantly.
    def _register_rpc(self, msg: Message, *, on_ack, on_fail) -> int:
        """Allocate an id and arm the retry entry WITHOUT sending --
        callers that must publish bookkeeping before the first frame
        can race them (the ack may beat the next line otherwise)."""
        with self.fleet._lock:
            req_id, self._next_req_id = self._next_req_id, \
                self._next_req_id + 1
            msg.req_id = req_id
            self._rpc[req_id] = _Rpc(
                msg=msg, deadline=self.fleet.clock() + self.rpc_timeout_s,
                tries=self.rpc_retries, on_ack=on_ack, on_fail=on_fail)
        return req_id

    def _call(self, msg: Message, *, on_ack, on_fail) -> int:
        req_id = self._register_rpc(msg, on_ack=on_ack, on_fail=on_fail)
        self.bus.send(msg)
        return req_id

    def _sweep_rpcs(self, now: float):
        expired = []
        with self.fleet._lock:
            for req_id, rpc in list(self._rpc.items()):
                if now < rpc.deadline:
                    continue
                if rpc.tries > 0:
                    rpc.tries -= 1
                    rpc.deadline = now + self.rpc_timeout_s
                    self.retried += 1
                    self.bus.send(rpc.msg)   # same req_id: receiver dedups
                else:
                    del self._rpc[req_id]
                    expired.append(rpc)
                    if rpc.msg.type in ("place", "inject"):
                        self._late[req_id] = rpc
        for rpc in expired:
            rpc.on_fail()

    def _holder(self, rid: str) -> str | None:
        """The engine the control plane holds ``rid`` on (caller holds
        the fleet lock): its placement, else the target of its placement
        RPC in flight."""
        entry = self.fleet.inflight.get(rid)
        if entry is not None:
            return entry[1]
        disp = self._dispatching.get(rid)
        return disp.target if disp is not None else None

    def _on_late_ack(self, rpc: _Rpc, body: dict):
        """An ack that landed after its placement RPC expired: the
        engine took the request after all.  A request still waiting in
        the queue adopts that placement; otherwise the engine's copy is
        a duplicate and is cancelled."""
        if not body.get("ok") or body.get("dup"):
            return                   # nothing placed by this RPC
        fleet, rid, target = self.fleet, rpc.msg.rid, rpc.msg.dst
        with fleet._lock:
            ticket = fleet.tickets.get(rid)
            holder = self._holder(rid)
            item = fleet.queue.find(rid)
            handle = fleet.handles.get(target)
            adopt = (holder is None and item is not None
                     and ticket is not None and not ticket.done
                     and handle is not None and handle.healthy)
            if adopt:
                self._dispatching[rid] = _Dispatch(rpc.msg.req_id, item,
                                                   target)
                self.late_adopted += 1
        if adopt:
            rpc.on_ack(body)
        elif holder != target:
            self._cancel_copy(rid, target, of=rpc.msg.req_id)

    def _cancel_copy(self, rid: str, engine: str, *, of: int | None = None):
        """Retire a duplicate of ``rid`` on ``engine`` (only the copy RPC
        ``of`` placed, when given: frames of a pair may pass each other
        across its two connections, so a later placement on that engine
        may land first), counting the tokens it had decoded."""
        def on_ack(body):
            with self.fleet._lock:
                self.wasted_tokens += int(body.get("decoded", 0))
        with self.fleet._lock:
            self.duplicates += 1
        self._call(Message(type="cancel", src=CONTROL, dst=engine, rid=rid,
                           body={} if of is None else {"of": of}),
                   on_ack=on_ack, on_fail=lambda: None)

    def _refuse(self, rid: str, engine: str | None, why: str):
        """Fail a ticket whose placement can never succeed (caller holds
        the fleet lock): the same end the synchronous fleet gives it."""
        fleet = self.fleet
        fleet.queue.remove(rid)
        fleet.ticket_transition(rid, RequestState.FAILED, reason=why,
                                engine=engine)

    # -- dispatch -----------------------------------------------------
    def _dispatch(self, now: float):
        fleet = self.fleet
        with fleet._lock:
            handles = [h for h in fleet.handles.values() if h.healthy]
            items = [it for it in fleet.queue.ordered(
                now=now, aging_rate=fleet.aging_rate)
                if it.rid not in self._dispatching]
        for item in items:
            slack = None if item.deadline is None \
                else item.deadline - now
            if item.parked:
                self._send_inject(item, handles, slack, now)
            else:
                self._send_place(item, handles, slack, now)

    def _send_place(self, item: WorkItem, handles, slack, now: float):
        fleet = self.fleet
        req = item.req
        dec = fleet.router.route(
            handles, fleet.cfg, sensitivity=req.sensitivity,
            prefill_tokens=len(req.prompt),
            decode_tokens=req.max_new_tokens, deadline_slack=slack,
            quality_floor=req.quality_floor,
            tokens=req.prompt, tenant=req.tenant,
            fabric=fleet.fabric)
        if dec.target is None:
            return                   # stays queued (no preemption here)
        meta = request_to_dict(req)
        rid = req.rid

        def on_ack(body):
            with fleet._lock:
                disp = self._dispatching.pop(rid, None)
                if disp is None or rid in fleet.done:
                    return           # completed or cancelled meanwhile
                if not body.get("ok"):
                    if body.get("refused"):
                        self._refuse(rid, dec.target,
                                     f"{dec.target}: {body.get('why')}")
                    return           # else stays queued, re-routed next tick
                fleet.queue.remove(rid)
                fleet.inflight[rid] = (req, dec.target, item.t_submit)
                fleet.placements.setdefault(rid, []).append(dec.target)
                fleet.telemetry.record_admit(dec.target)
                fleet.telemetry.record_queue_wait(
                    fleet.clock() - item.t_submit)
                if dec.degraded:
                    fleet.telemetry.record_quality(QualityEvent(
                        rid=rid, src_tier=dec.preferred or "",
                        dst_tier=dec.tier or "", direction="down",
                        reason=dec.cause or dec.reason,
                        quality=dec.quality, engine=dec.target, t=now))
                fleet.ticket_transition(rid, RequestState.PREFILLING,
                                        engine=dec.target,
                                        reason=dec.reason)
                if fleet.tracer is not None:
                    attrs = dec.to_attrs()
                    hit = body.get("prefix_hit", 0)
                    if hit:
                        attrs["prefix_hit_tokens"] = hit
                    fleet.tracer.annotate(rid, **attrs)
                fleet.ticket_transition(rid, RequestState.DECODING,
                                        engine=dec.target)

        def on_fail():
            with fleet._lock:
                # re-routed next tick, from its prompt: tokens the target
                # reported meanwhile were never confirmed by an ack
                self._dispatching.pop(rid, None)
                if rid not in fleet.done:
                    req.output = []

        msg = Message(type="place", src=CONTROL, dst=dec.target,
                      rid=rid, body={"req": meta})
        with fleet._lock:
            req_id = self._register_rpc(msg, on_ack=on_ack,
                                        on_fail=on_fail)
            self._dispatching[rid] = _Dispatch(req_id, item, dec.target)
        self.bus.send(msg)

    def _send_inject(self, item: WorkItem, handles, slack, now: float):
        fleet = self.fleet
        meta = peek_slot_meta(item.blob)
        rid = item.rid
        remaining = meta["max_new_tokens"] - len(meta["output"])
        need = len(meta["prompt"]) + meta["max_new_tokens"]
        # the whole reservation, not the remaining tokens: a target that
        # cannot take it would refuse the 100 MB frame after receiving it
        dec = fleet.router.route(
            [h for h in handles if room_for(h, need)], fleet.cfg,
            sensitivity=meta["sensitivity"], prefill_tokens=0,
            decode_tokens=remaining, deadline_slack=slack,
            quality_floor=meta.get("quality_floor", 0.0),
            src_tier=item.src_tier or None,
            reprefill_tokens=len(meta["prompt"]) + len(meta["output"]),
            # parked blobs live control-plane-side: route from $client,
            # not from the (possibly dead) donor uplink
            fabric=fleet.fabric, path_src=None)
        if dec.target is None:
            return
        reason = {"preempt": "resume",
                  "drain": "drain"}.get(item.origin, "failover")

        def on_ack(body):
            with fleet._lock:
                disp = self._dispatching.pop(rid, None)
                if disp is None or rid in fleet.done:
                    return
                if not body.get("ok"):
                    if body.get("refused"):
                        self._refuse(rid, item.src or None,
                                     f"{dec.target}: {body.get('why')}")
                    return           # else stays parked, re-routed next tick
                fleet.queue.remove(rid)
                ticket = fleet.tickets.get(rid)
                if ticket is not None:
                    req = ticket._req
                    req.output = list(meta["output"])
                    req.done = False
                    fleet.reassign(req, dec.target)
                if body.get("tier_change"):
                    fleet.record_tier_change(
                        rid, item.src_tier, dec.tier or "",
                        reason=f"{reason}: "
                               f"{dec.cause or 'tier change'}",
                        engine=dec.target)
                why = reason if not body.get("lossy") \
                    else f"{reason} (lossy re-prefill)"
                fleet.ticket_transition(rid, RequestState.DECODING,
                                        reason=why, engine=dec.target)
                fleet.telemetry.record_migration(MigrationRecord(
                    rid=rid, src=item.src, dst=dec.target,
                    reason=reason, step=0,
                    wire_bytes=int(body.get("wire_bytes", 0)),
                    lossy=bool(body.get("lossy"))))
                if item.origin == "preempt":
                    fleet.telemetry.record_resume(
                        fleet.clock() - item.parked_at)

        def on_fail():
            self._dispatching.pop(rid, None)   # blob still parked: retry

        msg = Message(type="inject", src=CONTROL, dst=dec.target,
                      rid=rid, body={"blob": item.blob, "src": item.src,
                                     "src_tier": item.src_tier,
                                     "reason": reason})
        with fleet._lock:
            req_id = self._register_rpc(msg, on_ack=on_ack,
                                        on_fail=on_fail)
            self._dispatching[rid] = _Dispatch(req_id, item, dec.target)
        try:
            self.bus.send(msg)
        except FrameTooLarge as e:
            # no retry can carry it: the ticket ends, with the reason
            with fleet._lock:
                self._rpc.pop(req_id, None)
                self._dispatching.pop(rid, None)
                self._refuse(rid, item.src or None, str(e))

    # -- inbound ------------------------------------------------------
    def _handle(self, msg: Message):
        if msg.type == "ack":
            with self.fleet._lock:
                rpc = self._rpc.pop(msg.req_id, None)
                late = None if rpc is not None \
                    else self._late.pop(msg.req_id, None)
            if rpc is not None:
                rpc.on_ack(msg.body)
            elif late is not None:
                self._on_late_ack(late, msg.body)
        elif msg.type == "report":
            self._on_report(msg)
        elif msg.type == "shadow":
            with self.fleet._lock:
                self.fleet.balancer.shadow[msg.src] = \
                    dict(msg.body["blobs"])
        elif msg.type == "hb":
            self.detector.beat(msg.src)
            if msg.body.get("done"):
                # a heartbeat re-offering completions whose original
                # done report was lost in flight
                self._on_report(msg)

    def _on_report(self, msg: Message):
        """Token stream sync: the service-side request advanced; mirror
        the delta onto the control-side request object (position-based,
        so duplicated or re-ordered reports are idempotent), finalize
        completions.  Tokens count only from the engine the request is
        held on; a completion counts from any engine, and a copy left on
        another is cancelled."""
        fleet = self.fleet
        now = fleet.clock()
        done_rids = list(msg.body.get("done", {}))
        copies = []
        with fleet._lock:
            for rid, (base, toks) in msg.body.get("emitted", {}).items():
                ticket = fleet.tickets.get(rid)
                if ticket is None or ticket.done \
                        or self._holder(rid) != msg.src:
                    continue
                out = ticket._req.output
                if base <= len(out):
                    out[base:base + len(toks)] = toks
            for rid, full in msg.body.get("done", {}).items():
                if rid in fleet.done:
                    continue
                ticket = fleet.tickets.get(rid)
                if ticket is None or ticket.done:
                    continue
                entry = fleet.inflight.pop(rid, None)
                req = entry[0] if entry is not None else ticket._req
                t0 = entry[2] if entry is not None \
                    else ticket.submitted_at
                req.output = list(full)
                req.done = True
                fleet.done[rid] = req
                disp = self._dispatching.pop(rid, None)
                if disp is not None:
                    rpc = self._rpc.pop(disp.req_id, None)
                    if disp.target != msg.src and rpc is not None:
                        # its ack, when it lands, cancels that copy
                        self._late[disp.req_id] = rpc
                if entry is None:        # completed before the ack landed
                    fleet.queue.remove(rid)
                    fleet.placements.setdefault(rid, []).append(msg.src)
                    fleet.telemetry.record_admit(msg.src)
                elif entry[1] != msg.src:    # a duplicate finished first
                    fleet.placements.setdefault(rid, []).append(msg.src)
                    copies.append((rid, entry[1]))
                # a done report can overtake a delayed/dropped placement
                # ack: walk the ticket through the legal intermediate
                # states the ack would have driven
                st = ticket.state
                if st is RequestState.QUEUED:
                    fleet.ticket_transition(
                        rid, RequestState.PREFILLING, engine=msg.src,
                        reason="done report preceded placement ack")
                    st = RequestState.PREFILLING
                if st in (RequestState.PREFILLING,
                          RequestState.MIGRATING):
                    fleet.ticket_transition(
                        rid, RequestState.DECODING, engine=msg.src,
                        reason="done report preceded placement ack")
                fleet.telemetry.record_complete(msg.src, now - t0)
                fleet.ticket_transition(rid, RequestState.DONE,
                                        engine=msg.src)
        for rid, engine in copies:
            self._cancel_copy(rid, engine)
        if done_rids:
            # confirm every completion named in this report (even ones
            # finalized earlier: the service re-offers until confirmed)
            self.bus.send(Message(type="done_ack", src=CONTROL,
                                  dst=msg.src,
                                  body={"rids": done_rids}))

    # -- failure handling ---------------------------------------------
    def _sweep_heartbeats(self, now: float):
        for name, last in self.detector.dead(now):
            self.detector.forget(name)
            handle = self.fleet.handles.get(name)
            if handle is None or not handle.healthy:
                continue
            self.fleet.telemetry.record_heartbeat_loss(HeartbeatLoss(
                engine=name, last_beat=last,
                timeout_s=self.detector.timeout_s, t=now))
            svc = self.services.get(name)
            why = "heartbeat loss"
            if svc is not None and svc.error is not None:
                why += f" (service died: {svc.error!r})"
            self.declare_failed(name, reason=why)

    def declare_failed(self, name: str, *, reason: str):
        """Liveness-declared failure: mark the handle dead, cancel its
        in-flight RPCs, and push every shadowed slot through the
        existing parked-work failover path (uncovered requests restart
        from their prompt -- at-least-once holds)."""
        fleet = self.fleet
        svc = self.services.get(name)
        if svc is not None:
            svc.request_stop()
        self.bus.deregister(name)
        with fleet._lock:
            handle = fleet.handles[name]
            handle.healthy = False
            fleet.telemetry.record_failure(name)
            for rid, disp in list(self._dispatching.items()):
                if disp.target == name:
                    self._rpc.pop(disp.req_id, None)
                    del self._dispatching[rid]
            for req_id, rpc in list(self._late.items()):
                if rpc.msg.dst == name:
                    del self._late[req_id]
            covered = set()
            for rid, blob in sorted(
                    fleet.balancer.shadow.pop(name, {}).items()):
                covered.add(rid)
                ticket = fleet.tickets.get(rid)
                if rid in fleet.done or ticket is None or ticket.done:
                    continue
                holder = self._holder(rid)
                if holder not in (None, name) or (
                        holder is None
                        and ticket.state is not RequestState.QUEUED):
                    continue         # a duplicate's shadow: held elsewhere
                if ticket.state is RequestState.QUEUED:
                    # the engine admitted it and shadowed it, but the
                    # placement ack never landed: walk the ticket through
                    # the states that ack would have driven (the JAX
                    # package raises LifecycleError here and its control
                    # thread dies)
                    fleet.queue.remove(rid)
                    fleet.placements.setdefault(rid, []).append(name)
                    fleet.telemetry.record_admit(name)
                    for st in (RequestState.PREFILLING,
                               RequestState.DECODING):
                        fleet.ticket_transition(
                            rid, st, engine=name,
                            reason="shadow preceded placement ack")
                fleet.ticket_transition(rid, RequestState.MIGRATING,
                                        reason=reason, engine=name)
                fleet.inflight.pop(rid, None)
                fleet.park_blob(name, blob, origin="failover")
            for rid, (req, hname, t0) in list(fleet.inflight.items()):
                if hname != name or rid in covered:
                    continue
                req.output, req.done, req.slot = [], False, -1
                del fleet.inflight[rid]
                fleet.requeue_request(req, t0)
