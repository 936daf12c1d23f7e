"""The port's service mode on the CPU: counterparts of every test of
``tests/test_fleet_service.py`` (the control plane + engine services over
the in-process and the loopback-socket transports: bit-exact threadless
decode, cancel, composed path conditions, dropped and delayed frames,
heartbeat loss, socket frames, a faulty socket fleet, peer death and
threaded submission), on tiny llama-1.5b with the JAX package's seed-0
weights bridged and one-slot engines (the solo oracle is exact).

Parity: one request stream through a threadless in-process
``ControlPlane`` in each package (f32) gives equal placements, ticket
states, audit kinds and greedy tokens, and the bus frames of every
message type are byte-equal.

The two decisions where the port departs from the JAX package (ROADMAP
Queue 3), each shown on both: a message over the socket transport's
``MAX_FRAME`` (JAX: 64 MiB, and a longer frame dropped without a trace;
port: 1 GiB, and a message over it refused at the sender and counted,
its ticket failed exactly once), and a service thread that dies of an
exception (JAX: its heartbeat beats on and its request hangs; port: the
heartbeat stops, the detector declares it failed and the request fails
over).

Every threaded test bounds its own waits (a deadline on the ticket loop,
``join(timeout=...)``, ``stop()`` / ``close()`` in ``finally``)."""

import struct
import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get  # noqa: E402
from repro_torch.configs.tiny import make_tiny  # noqa: E402
from repro_torch.core.attestation import TrustAuthority  # noqa: E402
from repro_torch.core.channel import (ComposedCondition,  # noqa: E402
                                      FrameTooLarge, NetworkCondition,
                                      SimClock, SocketTransport)
from repro_torch.core.daemon import EDGE  # noqa: E402
from repro_torch.fleet import (ControlPlane, EngineHandle,  # noqa: E402
                               FleetController, RequestSpec, RequestState,
                               TERMINAL_STATES)
from repro_torch.fleet.bus import decode_message  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from tests.torch_helpers import (assert_conserved, fleet_record,  # noqa: E402
                                 fleet_side, fleet_weights)

CFG = make_tiny(get("llama-1.5b"))
SLOTS = 1          # one live request per batch: the solo oracle is exact
MAX_LEN = 64


def _params():
    return fleet_weights()["torch"]["full"][1]


def mk_engine(seed=0):
    return Engine(CFG, _params(), slots=SLOTS, max_len=MAX_LEN, seed=seed,
                  device="cpu")


def mk_fleet(n=2, *, clock=None):
    handles = [EngineHandle(f"e{i}", mk_engine(seed=i), EDGE)
               for i in range(n)]
    return FleetController(handles, authority=TrustAuthority(),
                           clock=clock)


_REF = {}


def reference_output(prompt, max_new, *, seed=1234):
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


def drive(cp, clk, *, dt=0.02, until=None, max_rounds=3000,
          skip_services=()):
    """Threadless deterministic driver: tick the control plane and
    every (non-wedged) service, advancing the SimClock between rounds
    so heartbeats, RPC timeouts and deadlines all progress."""
    for _ in range(max_rounds):
        if until is not None and until():
            return
        cp.tick()
        for name, svc in cp.services.items():
            if name not in skip_services:
                svc.tick()
        clk.advance(dt)
    if until is not None:
        raise AssertionError("driver exhausted max_rounds")


def _drain_threaded(cp, tickets, timeout_s=60.0):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        if all(t.done for t in tickets):
            return
        time.sleep(0.01)
    states = {t.rid: t.state.value for t in tickets}
    raise AssertionError(f"timeout; states={states}")


def _wait(pred, timeout_s=10.0):
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return pred()


# -- deterministic transport: the contracts survive the split ---------------

def test_threadless_inproc_bit_exact_and_conserved():
    clk = SimClock()
    fleet = mk_fleet(2, clock=clk)
    cp = ControlPlane(fleet)
    cp.start(threads=False)
    specs = [greedy_spec(f"r{i}", [3 + i, 5, 7], max_new=8)
             for i in range(4)]
    tickets = [cp.submit(s) for s in specs]
    drive(cp, clk, until=lambda: all(t.done for t in tickets))
    for i, t in enumerate(tickets):
        assert t.state is RequestState.DONE
        assert t.output == reference_output([3 + i, 5, 7], 8), t.rid
    assert_conserved(fleet)
    # both engines took work: the split kept the whole pool routable
    assert len({h for hs in fleet.placements.values() for h in hs}) == 2
    cp.stop()
    assert fleet.service is None


def test_service_mode_cancel_frees_slot_and_conserves():
    clk = SimClock()
    fleet = mk_fleet(1, clock=clk)
    cp = ControlPlane(fleet)
    cp.start(threads=False)
    victim = cp.submit(greedy_spec("rv", [3, 5, 7], max_new=32))
    waiter = cp.submit(greedy_spec("rw", [4, 5, 7], max_new=4))
    drive(cp, clk, max_rounds=20,
          until=lambda: victim.state is RequestState.DECODING)
    assert fleet.cancel("rv")          # routes through the control plane
    assert victim.state is RequestState.CANCELLED
    drive(cp, clk, until=lambda: waiter.done)
    assert waiter.output == reference_output([4, 5, 7], 4)
    assert_conserved(fleet)
    cp.stop()


# -- per-pair link conditions compose into routing --------------------------

def test_composed_condition_math():
    a = NetworkCondition(latency_s=0.01, bandwidth_bps=1e9, loss=0.1)
    b = NetworkCondition(latency_s=0.02, bandwidth_bps=1e8, loss=0.5)
    c = ComposedCondition(a, None, b)
    assert c.latency_s == pytest.approx(0.03)
    assert c.bandwidth_bps == 1e8
    assert c.loss == pytest.approx(1 - 0.9 * 0.5)
    assert c.up
    assert not ComposedCondition(a, NetworkCondition(up=False)).up


def test_path_condition_is_live_and_router_reads_it():
    clk = SimClock()
    fleet = mk_fleet(2, clock=clk)
    # the channel fleet.set_link hands out must see conditions set later
    ch = fleet.fabric.link("e0", "e1")
    fleet.fabric.set_endpoint("e0", NetworkCondition(latency_s=0.5))
    assert ch.cond.latency_s == pytest.approx(
        0.5 + fleet.fabric.default_cond.latency_s)
    # a dead endpoint uplink makes the *path* unreachable even though
    # the pair link itself is fine -- the router must skip that engine
    fleet.set_link("e0", NetworkCondition(up=False))
    cp = ControlPlane(fleet)
    cp.start(threads=False)
    t = cp.submit(greedy_spec("r0", [3, 5, 7], max_new=4))
    drive(cp, clk, until=lambda: t.done)
    assert fleet.placements["r0"] == ["e1"]
    cp.stop()


# -- fault injection on the deterministic transport -------------------------

def test_dropped_frames_lose_nothing_duplicate_nothing():
    """Drop every third frame on the floor (places, acks, reports and
    heartbeats alike): RPC retry + receiver dedup + heartbeat re-offer
    of completions must still finish every request bit-exact."""
    clk = SimClock()
    fleet = mk_fleet(2, clock=clk)
    cp = ControlPlane(fleet, rpc_timeout_s=0.1)
    seen = {"n": 0}

    def fault(src, dst, payload):
        seen["n"] += 1
        if seen["n"] % 3 == 0:
            return "drop"
        return None

    cp.transport.fault = fault
    cp.start(threads=False)
    specs = [greedy_spec(f"r{i}", [3 + i, 5, 7], max_new=6)
             for i in range(4)]
    tickets = [cp.submit(s) for s in specs]
    drive(cp, clk, until=lambda: all(t.done for t in tickets))
    cp.transport.fault = None
    assert cp.transport.dropped > 0
    for i, t in enumerate(tickets):
        assert t.state is RequestState.DONE
        assert t.output == reference_output([3 + i, 5, 7], 6), t.rid
    assert_conserved(fleet)
    cp.stop()


def test_delayed_frames_do_not_double_place():
    """Delay the first ack of every RPC: the control plane retries, the
    service re-acks from its dedup cache, and when the stale originals
    finally arrive they must be ignored (the rpc entry is gone) -- one
    placement, one finalization, bit-exact output."""
    clk = SimClock()
    fleet = mk_fleet(2, clock=clk)
    cp = ControlPlane(fleet, rpc_timeout_s=0.1)
    delayed: set[int] = set()

    def fault(src, dst, payload):
        msg = decode_message(payload)
        if msg.type == "ack" and msg.req_id not in delayed:
            delayed.add(msg.req_id)
            return ("delay", 1.0)
        return None

    cp.transport.fault = fault
    cp.start(threads=False)
    specs = [greedy_spec(f"r{i}", [3 + i, 5, 7], max_new=6)
             for i in range(3)]
    tickets = [cp.submit(s) for s in specs]
    rounds = {"n": 0}

    def step_and_release():
        rounds["n"] += 1
        if all(t.done for t in tickets):
            return True
        if rounds["n"] % 16 == 0:
            # stale originals land well after the retry was re-acked
            cp.transport.release_held()
        return False

    drive(cp, clk, until=step_and_release)
    cp.transport.fault = None
    cp.transport.release_held()
    assert delayed                     # the fault actually fired
    assert cp.retried > 0
    for i, t in enumerate(tickets):
        assert t.state is RequestState.DONE
        assert t.output == reference_output([3 + i, 5, 7], 6), t.rid
        # exactly one engine ever held the request: no double placement
        assert len(fleet.placements[t.rid]) == 1
    assert_conserved(fleet)
    cp.stop()


def test_heartbeat_loss_declares_failure_and_fails_over():
    """A wedged service stops heartbeating: the detector times it out
    on the fleet clock, a typed HeartbeatLoss lands on the audit log,
    and its slots re-place through the parked failover path."""
    clk = SimClock()
    fleet = mk_fleet(2, clock=clk)
    cp = ControlPlane(fleet, sync_every=2, hb_timeout_s=0.5,
                      rpc_timeout_s=0.1)
    cp.start(threads=False)
    t0 = cp.submit(greedy_spec("r0", [3, 5, 7], max_new=24))
    t1 = cp.submit(greedy_spec("r1", [4, 5, 7], max_new=24))
    # run until both engines hold work and e0 has shipped a shadow
    drive(cp, clk, dt=0.02,
          until=lambda: len(fleet.inflight) == 2
          and any(fleet.balancer.shadow.values()))
    on_e0 = [rid for rid, (_, h, _) in fleet.inflight.items()
             if h == "e0"]
    assert on_e0
    # e0 wedges: no more ticks, so no more heartbeats
    drive(cp, clk, dt=0.1, skip_services={"e0"},
          until=lambda: not fleet.handles["e0"].healthy)
    lost = fleet.telemetry.heartbeat_events()
    assert lost and lost[0].engine == "e0"
    assert lost[0].kind == "heartbeat_loss"
    assert lost[0].timeout_s == pytest.approx(0.5)
    # the survivor finishes everything, bit-exact (slots=1 oracle)
    drive(cp, clk, dt=0.02, skip_services={"e0"},
          until=lambda: t0.done and t1.done)
    assert t0.output == reference_output([3, 5, 7], 24)
    assert t1.output == reference_output([4, 5, 7], 24)
    assert_conserved(fleet)
    cp.stop()


# -- socket transport: real threads, real clock -----------------------------

def test_socket_transport_frames_roundtrip():
    tp = SocketTransport()
    got = []
    try:
        tp.register("a", lambda b: got.append(("a", b)))
        tp.register("b", lambda b: got.append(("b", b)))
        big = bytes(range(256)) * 4096          # multi-read frame (1 MiB)
        assert tp.send("a", "b", b"hello")
        assert tp.send("b", "a", big)
        assert _wait(lambda: len(got) >= 2)
        assert sorted(got)[0] == ("a", big)
        assert sorted(got)[1] == ("b", b"hello")
        assert not tp.send("a", "nobody", b"x")  # unknown peer: refused
    finally:
        tp.close()


def test_socket_fleet_serves_concurrently_with_faults():
    """Loopback-socket fleet under a lossy/laggy fault hook (every
    17th frame dropped, every 23rd delayed): every request still
    completes with exactly its requested token stream."""
    fleet = mk_fleet(3)
    cp = ControlPlane(fleet, transport=SocketTransport(),
                      rpc_timeout_s=0.2, hb_timeout_s=30.0)
    count = {"n": 0}
    lock = threading.Lock()

    def fault(src, dst, payload):
        with lock:
            count["n"] += 1
            n = count["n"]
        if n % 17 == 0:
            return "drop"
        if n % 23 == 0:
            return ("delay", 0.05)
        return None

    cp.transport.fault = fault
    cp.start(threads=True)
    try:
        specs = [greedy_spec(f"r{i}", [3 + i, 5, 7], max_new=8)
                 for i in range(6)]
        tickets = [cp.submit(s) for s in specs]
        _drain_threaded(cp, tickets)
        for i, t in enumerate(tickets):
            assert t.state is RequestState.DONE
            assert t.output == reference_output([3 + i, 5, 7], 8), t.rid
    finally:
        cp.transport.fault = None
        cp.stop()
    assert_conserved(fleet)


def test_socket_peer_death_mid_flight_fails_over():
    """Kill one service dead (thread stopped, endpoint closed, zero
    cleanup) while its slot decodes and placements are in flight: the
    heartbeat detector must notice, re-place the work, and every
    request must finish exactly once, bit-exact."""
    fleet = mk_fleet(3)
    cp = ControlPlane(fleet, transport=SocketTransport(),
                      sync_every=2, hb_timeout_s=0.6, rpc_timeout_s=0.2)
    cp.start(threads=True)
    try:
        specs = [greedy_spec(f"r{i}", [3 + i, 5, 7], max_new=24)
                 for i in range(6)]
        tickets = [cp.submit(s) for s in specs]

        def victimized():
            with fleet._lock:
                return any(h == "e0" for _, h, _ in fleet.inflight.values())
        assert _wait(victimized, 60.0), "e0 never took work"
        cp.kill_service("e0")
        _drain_threaded(cp, tickets)
        assert not fleet.handles["e0"].healthy
        lost = fleet.telemetry.heartbeat_events()
        assert any(ev.engine == "e0" for ev in lost)
        for i, t in enumerate(tickets):
            assert t.state is RequestState.DONE
            assert t.output == reference_output([3 + i, 5, 7], 24), t.rid
    finally:
        cp.stop()
    assert_conserved(fleet)


def test_threaded_submit_and_ticket_result_from_user_thread():
    """result() in service mode must wait, not drive: callers block on
    the service loops from any thread."""
    fleet = mk_fleet(2)
    cp = ControlPlane(fleet)
    cp.start(threads=True)
    try:
        ticket = cp.submit(greedy_spec("r0", [3, 5, 7], max_new=8))
        out = ticket.result(max_steps=100_000)
        assert out == reference_output([3, 5, 7], 8)
        # concurrent result() calls from a second user thread
        t2 = cp.submit(greedy_spec("r1", [4, 5, 7], max_new=8))
        got = {}
        th = threading.Thread(
            target=lambda: got.update(r1=t2.result(max_steps=100_000)))
        th.start()
        th.join(timeout=60.0)
        assert got["r1"] == reference_output([4, 5, 7], 8)
    finally:
        cp.stop()


# -- parity with the JAX package ---------------------------------------------

def _service_stream(side):
    """One stream through a threadless in-process ControlPlane: two
    one-slot EDGE engines, five greedy requests, one cancelled while it
    decodes; returns the fleet's record (tokens included)."""
    ns = fleet_side(side, "float32")
    clk = ns.SimClock()
    handles = [ns.EngineHandle(f"e{i}",
                               ns.engine(slots=1, max_len=MAX_LEN, seed=i),
                               ns.EDGE) for i in range(2)]
    fleet = ns.FleetController(handles, authority=ns.TrustAuthority(),
                               clock=clk)
    cp = ns.ControlPlane(fleet)
    cp.start(threads=False)
    tickets = [cp.submit(ns.RequestSpec(
        rid=f"r{i}", prompt=np.asarray([3 + i, 5, 7, 9][:3 + i % 2]),
        max_new_tokens=6 + i, sensitivity=("public", "personal")[i % 2]))
        for i in range(5)]
    cancelled = False
    for _ in range(3000):
        if all(t.done for t in tickets):
            break
        if not cancelled and tickets[4].state is ns.RequestState.DECODING:
            assert fleet.cancel("r4")
            cancelled = True
        cp.tick()
        for svc in cp.services.values():
            svc.tick()
        clk.advance(0.02)
    assert all(t.done for t in tickets) and cancelled
    rec = fleet_record(fleet)
    cp.stop()
    return rec


def test_service_stream_matches_jax_control_plane():
    """Placements, ticket states, audit kinds and greedy tokens of one
    threadless in-process stream are equal in both packages (f32)."""
    jrec, trec = _service_stream("jax"), _service_stream("torch")
    for key in ("placements", "states", "audit", "outputs"):
        assert jrec[key] == trec[key], key
    assert jrec["counters"]["lifecycle"] == trec["counters"]["lifecycle"]
    assert trec["states"]["r4"][-1] == "cancelled"


def test_bus_frames_byte_equal_to_jax():
    """``encode_message`` writes the JAX package's bytes for every
    message type the service mode sends, a slot blob included, and
    ``decode_message`` reads JAX frames back to equal envelopes."""
    from repro.fleet import bus as jbus
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import request_to_dict as jrequest_to_dict
    from repro_torch.core.migration import pack_slot
    from repro_torch.fleet import bus as tbus
    from repro_torch.serving.engine import request_to_dict

    eng = mk_engine()
    req = Request("r0", np.arange(5), max_new_tokens=4, temperature=0.5,
                  top_k=8, sensitivity="personal", deadline=3.25)
    eng.add_request(req)
    eng.step()
    blob = pack_slot(eng.extract_slot(0, keep=True))
    meta = request_to_dict(req)
    jreq = JRequest("r0", np.arange(5), max_new_tokens=4, temperature=0.5,
                    top_k=8, sensitivity="personal", deadline=3.25)
    jreq.output, jreq.slot = list(req.output), req.slot
    assert jrequest_to_dict(jreq) == meta
    msgs = [
        ("place", "ctl", "e0", "r0", 7, {"req": meta}),
        ("inject", "ctl", "e1", "r0", 8,
         {"blob": blob, "src": "e0", "src_tier": "full",
          "reason": "failover"}),
        ("ack", "e1", "ctl", "r0", 8,
         {"ok": True, "lossy": False, "tier_change": False,
          "wire_bytes": len(blob)}),
        ("ack", "e0", "ctl", "r1", 9,
         {"ok": False, "why": "full"}),
        ("report", "e0", "ctl", "", 0,
         {"emitted": {"r0": [3, [17]]}, "done": {"r2": [1, 2, 3]},
          "dt": 0.015625}),
        ("hb", "e0", "ctl", "", 0, {"t": 12.5, "done": {"r2": [1, 2]}}),
        ("shadow", "e0", "ctl", "", 0, {"blobs": {"r0": blob}}),
        ("done_ack", "ctl", "e0", "", 0, {"rids": ["r2"]}),
        ("stop", "ctl", "e0", "", 0, {}),
    ]
    for typ, src, dst, rid, req_id, body in msgs:
        jframe = jbus.encode_message(jbus.Message(
            type=typ, src=src, dst=dst, rid=rid, req_id=req_id, body=body))
        tframe = tbus.encode_message(tbus.Message(
            type=typ, src=src, dst=dst, rid=rid, req_id=req_id, body=body))
        assert tframe == jframe, typ
        back = tbus.decode_message(jframe)
        assert (back.type, back.src, back.dst, back.rid, back.req_id,
                back.body) == (typ, src, dst, rid, req_id, body)
    assert len(blob) > 1000


# -- decision 1: a message over MAX_FRAME -------------------------------------

def test_jax_socket_drops_an_oversized_frame_without_a_trace(monkeypatch):
    """The JAX ``SocketTransport`` writes any payload as one frame; its
    reader raises on a length over ``MAX_FRAME`` and closes the
    connection silently.  ``send`` said True, nothing was delivered and
    no counter moved (here with ``MAX_FRAME`` cut to 1 KiB; at full
    width a 102 MB paged slot blob meets the real 64 MiB limit)."""
    from repro.core.channel import SocketTransport as JSocket
    monkeypatch.setattr(JSocket, "MAX_FRAME", 1024)
    tp = JSocket()
    got = []
    try:
        tp.register("ctl", got.append)
        tp.register("e0", got.append)
        assert tp.send("e0", "ctl", b"x" * 4096)
        time.sleep(0.2)
        # the reader has closed the connection: a later frame on it is
        # lost too (or its send fails, depending on the socket's timing)
        tp.send("e0", "ctl", b"small")
        time.sleep(0.3)
        assert got == []
        assert tp.dropped == 0
    finally:
        tp.close()


def test_port_socket_carries_long_messages_and_refuses_with_a_trace(
        monkeypatch):
    """The port's ``MAX_FRAME`` is 1 GiB, so a full-width slot blob
    (100-200 MB, over the JAX package's 64 MiB) is one frame.  A message
    over it raises ``FrameTooLarge`` at the sender before any byte moves
    (``refused``); a frame header over it from another sender is counted
    by the reader (``refused_in``).  Here the limit is cut to 1 KiB."""
    from repro.core.channel import SocketTransport as JSocket
    assert SocketTransport.MAX_FRAME == 1 << 30
    assert JSocket.MAX_FRAME == 64 << 20
    monkeypatch.setattr(SocketTransport, "MAX_FRAME", 1024)
    tp = SocketTransport()
    got = []
    try:
        tp.register("ctl", got.append)
        tp.register("e0", got.append)
        assert tp.send("e0", "ctl", b"")        # an empty message
        edge = bytes(range(256)) * 4            # exactly the limit
        assert tp.send("e0", "ctl", edge)
        with pytest.raises(FrameTooLarge, match="MAX_FRAME"):
            tp.send("e0", "ctl", b"y" * 1025)
        assert tp.refused == 1
        assert "1025 bytes" in tp.refusals[-1]
        assert _wait(lambda: len(got) == 2)
        assert got == [b"", edge]
        # frames within one lane keep their order; small frames and
        # large ones ride two connections of the pair
        for i in range(5):
            tp.send("e0", "ctl", bytes([i]) * (200 * i))
        assert _wait(lambda: len(got) == 7)
        assert got[2:] == [bytes([i]) * (200 * i) for i in range(5)]
        monkeypatch.setattr(SocketTransport, "BULK_BYTES", 100)
        tp.send("e0", "ctl", b"b" * 200)
        assert _wait(lambda: len(got) == 8)
        assert sorted(tp._conns) == [("e0", "ctl", False),
                                     ("e0", "ctl", True)]
        # one frame over MAX_FRAME on the wire, as another sender writes
        raw = socket.create_connection(tp._addrs["ctl"])
        raw.sendall(struct.pack(">I", 4096) + b"z" * 4096)
        assert _wait(lambda: tp.refused_in == 1)
        raw.close()
        assert "over MAX_FRAME" in tp.refusals[-1]
        assert len(got) == 8
    finally:
        tp.close()


def _tiny_blob_bytes():
    from repro_torch.core.migration import pack_slot
    eng = mk_engine()
    eng.add_request(Request("r", np.arange(3), max_new_tokens=4))
    return len(pack_slot(eng.extract_slot(0, keep=True)))


def test_port_refused_shadow_and_inject_end_every_ticket_once(monkeypatch):
    """With ``MAX_FRAME`` below one slot blob: every shadow is refused
    on the bus (counted), so a wedged engine's request restarts from its
    prompt on the survivor and ends DONE once, bit-exact; a parked blob
    over the limit cannot be injected anywhere, so its ticket ends
    FAILED once, with the reason."""
    limit = _tiny_blob_bytes() // 2
    monkeypatch.setattr(SocketTransport, "MAX_FRAME", limit)
    clk = SimClock()
    fleet = mk_fleet(2, clock=clk)
    cp = ControlPlane(fleet, transport=SocketTransport(), sync_every=1,
                      hb_timeout_s=0.5, rpc_timeout_s=0.5)
    cp.start(threads=False)
    try:
        t0 = cp.submit(greedy_spec("r0", [3, 5, 7], max_new=12))

        def tick(skip=()):
            cp.tick()
            for name, svc in cp.services.items():
                if name not in skip:
                    svc.tick()
            time.sleep(0.002)      # the socket readers deliver meanwhile
            clk.advance(0.01)

        deadline = time.perf_counter() + 30.0
        while cp.bus.refused < 2 and time.perf_counter() < deadline:
            tick()
        assert cp.bus.refused >= 2
        assert {r[0] for r in cp.bus.refusals} == {"shadow"}
        assert not any(fleet.balancer.shadow.values())
        victim = fleet.placement_of("r0")
        while fleet.handles[victim].healthy \
                and time.perf_counter() < deadline:
            tick(skip={victim})
        while not t0.done and time.perf_counter() < deadline:
            tick(skip={victim})
        assert t0.state is RequestState.DONE
        assert t0.output == reference_output([3, 5, 7], 12)
        assert [ev.dst for ev in t0.events].count("done") == 1
        assert_conserved(fleet)

        # a parked slot over the limit: the inject is refused at the
        # sender and its ticket fails, once
        t1 = cp.submit(greedy_spec("r1", [4, 5, 7], max_new=12))
        while fleet.placement_of("r1") is None \
                and time.perf_counter() < deadline:
            tick(skip={victim})
        owner = fleet.placement_of("r1")
        from repro_torch.core.migration import pack_slot
        eng = fleet.handles[owner].engine
        with fleet._lock:
            # what a lost engine's shadow would hand the balancer
            slot = next(s for s, r in eng.requests.items() if r.rid == "r1")
            blob = pack_slot(eng.extract_slot(slot))
            fleet.ticket_transition("r1", RequestState.MIGRATING,
                                    reason="test park", engine=owner)
            fleet.inflight.pop("r1")
            fleet.park_blob(owner, blob, origin="failover")
        while not t1.done and time.perf_counter() < deadline:
            tick(skip={victim})
        assert t1.state is RequestState.FAILED
        assert "MAX_FRAME" in t1.events[-1].reason
        assert [ev.dst for ev in t1.events
                if ev.dst in {s.value for s in TERMINAL_STATES}] \
            == ["failed"]
        assert any(r[0] == "inject" for r in cp.bus.refusals)
        assert_conserved(fleet)
    finally:
        cp.stop()


# -- decision 2: a service thread that dies -----------------------------------

@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_jax_dead_service_keeps_beating_and_its_request_hangs():
    """A handler exception ends the JAX service thread; its heartbeat
    thread beats on, so the detector never declares it failed and the
    request it was placing stays unserved."""
    import jax
    from repro.configs import get as jget
    from repro.configs.tiny import make_tiny as jtiny
    from repro.core.attestation import TrustAuthority as JAuthority
    from repro.core.daemon import EDGE as JEDGE
    from repro.fleet import ControlPlane as JControlPlane
    from repro.fleet import EngineHandle as JHandle
    from repro.fleet import FleetController as JFleet
    from repro.fleet import RequestSpec as JSpec
    from repro.models.init import init_params
    from repro.serving.engine import Engine as JEngine

    jcfg = jtiny(jget("llama-1.5b"))
    eng = JEngine(jcfg, init_params(jcfg, jax.random.key(0)), slots=1,
                  max_len=MAX_LEN)

    def boom(*a, **kw):
        raise RuntimeError("boom in add_request")
    eng.add_request = boom
    fleet = JFleet([JHandle("e0", eng, JEDGE)], authority=JAuthority())
    cp = JControlPlane(fleet, hb_timeout_s=1.0, rpc_timeout_s=0.1)
    cp.start(threads=True)
    try:
        t = cp.submit(JSpec(rid="r0", prompt=np.asarray([3, 5, 7]),
                            max_new_tokens=4))
        svc = cp.services["e0"]
        svc.thread.join(timeout=10.0)
        assert not svc.thread.is_alive()        # the service died
        time.sleep(2.5)                         # > 2 heartbeat timeouts
        assert svc._hb_thread.is_alive()        # ... and still beats
        assert fleet.handles["e0"].healthy
        assert fleet.telemetry.heartbeat_losses == 0
        assert not t.done
    finally:
        cp.stop()


def test_port_dead_service_stops_beating_and_fails_over():
    """The port's service keeps the exception and stops beating: the
    detector declares it failed (the exception on the failure's reason)
    and the request it was placing is served by the survivor, bit for
    bit."""
    fleet = mk_fleet(2)
    raised = []

    def first_call_raises(eng):
        real = eng.add_request

        def add_request(*a, **kw):
            if not raised:
                raised.append(True)
                raise RuntimeError("boom in add_request")
            return real(*a, **kw)
        eng.add_request = add_request
    for h in fleet.handles.values():
        first_call_raises(h.engine)
    cp = ControlPlane(fleet, transport=SocketTransport(),
                      hb_timeout_s=1.0, rpc_timeout_s=0.1)
    cp.start(threads=True)
    try:
        t = cp.submit(greedy_spec("r0", [3, 5, 7], max_new=8))
        _drain_threaded(cp, [t], timeout_s=30.0)
        dead = [n for n, s in cp.services.items() if s.error is not None]
        assert len(dead) == 1
        svc = cp.services[dead[0]]
        svc._hb_thread.join(timeout=5.0)
        assert not svc._hb_thread.is_alive()
        assert not fleet.handles[dead[0]].healthy
        lost = fleet.telemetry.heartbeat_events()
        assert [ev.engine for ev in lost] == dead
        assert t.state is RequestState.DONE
        assert t.output == reference_output([3, 5, 7], 8)
        assert fleet.placements["r0"] != dead
        assert "boom in add_request" in repr(svc.error)
    finally:
        cp.stop()
    assert_conserved(fleet)


# -- decision 3: a shadow that overtakes its placement ack -------------------

def _shadow_before_ack(side):
    """One request whose placement acks are all lost: its engine admits
    it and ships its shadow, the control plane still holds it QUEUED;
    then the engine wedges and the heartbeat detector fails it."""
    ns = fleet_side(side)
    clk = ns.SimClock()
    handles = [ns.EngineHandle(f"e{i}",
                               ns.engine(slots=1, max_len=MAX_LEN, seed=i),
                               ns.EDGE) for i in range(2)]
    fleet = ns.FleetController(handles, authority=ns.TrustAuthority(),
                               clock=clk)
    cp = ns.ControlPlane(fleet, sync_every=1, hb_timeout_s=0.5,
                         rpc_timeout_s=100.0)
    cp.transport.fault = lambda src, dst, payload: \
        "drop" if decode_message(payload).type == "ack" else None
    cp.start(threads=False)
    t = cp.submit(ns.RequestSpec(rid="r0", prompt=np.asarray([3, 5, 7]),
                                 max_new_tokens=12))
    for _ in range(50):
        cp.tick()
        for svc in cp.services.values():
            svc.tick()
        clk.advance(0.02)
        if any(fleet.balancer.shadow.values()):
            break
    target = next(n for n, blobs in fleet.balancer.shadow.items() if blobs)
    assert t.state is ns.RequestState.QUEUED
    cp.transport.fault = None
    return ns, clk, fleet, cp, t, target


def test_jax_control_plane_dies_on_a_shadow_that_overtook_its_ack():
    from repro.fleet.lifecycle import LifecycleError as JLifecycleError
    ns, clk, fleet, cp, t, target = _shadow_before_ack("jax")
    with pytest.raises(JLifecycleError, match="queued -> migrating"):
        for _ in range(100):
            clk.advance(0.1)
            cp.tick()
            for name, svc in cp.services.items():
                if name != target:
                    svc.tick()
    cp.stop()


def test_port_fails_over_a_shadow_that_overtook_its_ack():
    ns, clk, fleet, cp, t, target = _shadow_before_ack("torch")
    try:
        drive(cp, clk, dt=0.1, skip_services={target},
              until=lambda: not fleet.handles[target].healthy)
        drive(cp, clk, dt=0.02, skip_services={target},
              until=lambda: t.done)
        assert t.state is RequestState.DONE
        assert t.output == reference_output([3, 5, 7], 12)
        other = "e1" if target == "e0" else "e0"
        assert fleet.placements["r0"] == [target, other]
        assert [ev.dst for ev in t.events] == [
            "queued", "prefilling", "decoding", "migrating", "decoding",
            "done"]
        assert "shadow preceded placement ack" in t.events[1].reason
        assert_conserved(fleet)
    finally:
        cp.stop()


# -- decision 4: an ack that lands after its placement RPC expired ----------

def _ack_after_expiry(side):
    """Two one-slot engines; every ack of the first placement RPC is held
    back (one retry, 0.1 s a try), so the RPC expires while its engine
    already decodes the request.  Returns once it has expired."""
    ns = fleet_side(side)
    clk = ns.SimClock()
    handles = [ns.EngineHandle(f"e{i}",
                               ns.engine(slots=1, max_len=MAX_LEN, seed=i),
                               ns.EDGE) for i in range(2)]
    fleet = ns.FleetController(handles, authority=ns.TrustAuthority(),
                               clock=clk)
    cp = ns.ControlPlane(fleet, rpc_timeout_s=0.1, rpc_retries=1)
    first = {}

    def fault(src, dst, payload):
        msg = decode_message(payload)
        if msg.type == "ack" and first.setdefault("id", msg.req_id) \
                == msg.req_id:
            return ("delay", 0.0)      # held until release_held()
        return None
    cp.transport.fault = fault
    cp.start(threads=False)
    t = cp.submit(ns.RequestSpec(rid="r0", prompt=np.asarray([3, 5, 7]),
                                 max_new_tokens=12))
    target = None
    for _ in range(40):
        cp.tick()
        if target is None and "r0" in cp._dispatching:
            target = cp._dispatching["r0"].target
        if target is not None and "r0" not in cp._dispatching:
            break
        for svc in cp.services.values():
            svc.tick()
        clk.advance(0.05)
    assert target is not None and "r0" not in cp._dispatching
    assert getattr(cp, "retried", 1) == 1
    assert t.state is ns.RequestState.QUEUED
    assert [r.rid for r in fleet.handles[target].engine.requests.values()] \
        == ["r0"]
    cp.transport.fault = None
    return ns, clk, fleet, cp, t, target


def _holders(fleet, rid="r0"):
    return sorted(n for n, h in fleet.handles.items()
                  if any(r.rid == rid for r in h.engine.requests.values()))


def test_jax_late_ack_leaves_the_request_decoding_on_two_engines():
    """The JAX control plane re-places the expired request on the other
    engine and ignores the late ack: both engines decode it to the end
    (the ticket still ends once)."""
    ns, clk, fleet, cp, t, target = _ack_after_expiry("jax")
    other = "e1" if target == "e0" else "e0"
    drive(cp, clk, until=lambda: fleet.placement_of("r0") == other)
    cp.transport.release_held()
    both = []
    drive(cp, clk, until=lambda: both.append(_holders(fleet)) or t.done)
    assert ["e0", "e1"] in both[-3:]      # two copies to the last steps
    assert t.state is ns.RequestState.DONE
    cp.stop()


def test_port_cancels_the_copy_a_late_ack_reveals():
    """The port re-places the expired request on the other engine too;
    when the late ack lands, the first engine's copy is cancelled and
    its decoded tokens counted; the ticket ends once, bit for bit."""
    ns, clk, fleet, cp, t, target = _ack_after_expiry("torch")
    other = "e1" if target == "e0" else "e0"
    try:
        drive(cp, clk, until=lambda: fleet.placement_of("r0") == other)
        assert _holders(fleet) == ["e0", "e1"]
        cp.transport.release_held()
        drive(cp, clk, until=lambda: _holders(fleet) == [other])
        assert cp.duplicates == 1 and cp.late_adopted == 0
        drive(cp, clk, until=lambda: t.done)
        assert cp.wasted_tokens > 0
        assert t.state is RequestState.DONE
        assert t.output == reference_output([3, 5, 7], 12)
        assert [ev.dst for ev in t.events].count("done") == 1
        assert fleet.placements["r0"] == [other]
        assert_conserved(fleet)
    finally:
        cp.stop()


def test_port_adopts_a_late_ack_while_the_request_waits():
    """A late ack that lands before the request was placed again: the
    port keeps that placement (the JAX package would place it a second
    time), so one engine decodes it, bit for bit."""
    ns, clk, fleet, cp, t, target = _ack_after_expiry("torch")
    try:
        cp.transport.release_held()
        drive(cp, clk, until=lambda: t.done)
        assert cp.late_adopted == 1 and cp.duplicates == 0
        assert fleet.placements["r0"] == [target]
        assert t.output == reference_output([3, 5, 7], 12)
        assert [ev.dst for ev in t.events] == [
            "queued", "prefilling", "decoding", "done"]
        assert_conserved(fleet)
    finally:
        cp.stop()


def test_a_stale_cancel_keeps_a_copy_a_later_rpc_claimed():
    """Frames of a pair may pass each other across its two connections,
    so a cancel of a late ack's copy can land after a later placement on
    the same engine claimed that copy (acked ``dup``): the service keeps
    it.  A cancel of the current claim retires it, with its tokens."""
    from repro_torch.core.channel import InProcTransport
    from repro_torch.fleet import EngineService
    from repro_torch.fleet.bus import Message, MessageBus
    from repro_torch.serving.engine import request_to_dict
    bus = MessageBus(InProcTransport())
    acks = bus.register("ctl")
    svc = EngineService("e0", mk_engine(), bus.register("e0"), bus,
                        clock=SimClock())
    req = Request("r0", np.asarray([3, 5, 7]), max_new_tokens=8)
    meta = {"req": request_to_dict(req)}
    for req_id in (1, 2):        # the expired RPC, then the one acked
        svc._handle(Message("place", "ctl", "e0", rid="r0", req_id=req_id,
                            body=dict(meta)))
    svc.tick()
    svc._handle(Message("cancel", "ctl", "e0", rid="r0", req_id=3,
                        body={"of": 1}))
    assert [r.rid for r in svc.engine.requests.values()] == ["r0"]
    svc._handle(Message("cancel", "ctl", "e0", rid="r0", req_id=4,
                        body={"of": 2}))
    assert not svc.engine.requests
    bodies = {m.req_id: m.body for m in acks.drain() if m.type == "ack"}
    assert bodies[1] == {"ok": True, "prefix_hit": 0}
    assert bodies[2] == {"ok": True, "dup": True}
    assert bodies[3] == {"ok": True, "kept": True}
    assert bodies[4] == {"ok": True, "decoded": 1}
