"""The simulated byte fabric, the attested session over it, and the
message transports of the fleet's service mode (the port's copy of the
JAX package's ``core.channel``).

A ``Channel`` is a byte pipe whose latency, bandwidth and packet loss
are modelled against a deterministic ``SimClock``: the migration report
reads transfer time off the clock.  A ``Fabric`` holds one channel per
engine pair on one shared clock; link conditions are properties of the
*path*: ``Fabric.path`` composes the per-pair condition with each
endpoint's own uplink condition (latencies add, bandwidth is the min,
loss compounds, up = every segment up).  Everything above the byte layer is
real protocol code: the attested TLS-style handshake, the session key
bound to both quotes, the sealed transfer with integrity, and multi-hop
transitive chains.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core import crypto
from repro_torch.core.attestation import Attester, Quote


class SimClock:
    def __init__(self, t0: float = 0.0):
        self.t = t0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float):
        self.t += dt


@dataclass
class NetworkCondition:
    latency_s: float = 0.02          # one-way
    bandwidth_bps: float = 1e9       # paper's 1 Gbps migration link
    loss: float = 0.0                # packet loss fraction
    up: bool = True

    def transfer_time(self, nbytes: int) -> float:
        if not self.up:
            return float("inf")
        eff = self.bandwidth_bps * (1.0 - min(self.loss, 0.99)) / 8.0
        retrans = 1.0 / (1.0 - min(self.loss, 0.99))
        return self.latency_s + nbytes / eff * retrans


@dataclass
class Channel:
    """Byte pipe with simulated timing.  ``taps`` lets tests play the
    network adversary (record / tamper with ciphertext)."""
    cond: NetworkCondition = field(default_factory=NetworkCondition)
    clock: SimClock = field(default_factory=SimClock)
    taps: list = field(default_factory=list)
    bytes_sent: int = 0

    def send(self, data: bytes) -> bytes:
        if not self.cond.up:
            raise ConnectionError("network down")
        self.clock.advance(self.cond.transfer_time(len(data)))
        self.bytes_sent += len(data)
        for tap in self.taps:
            data = tap(data)
        return data


class ComposedCondition:
    """Effective condition of a multi-segment path.

    Latencies add, bandwidth is the narrowest segment, loss compounds
    (a packet survives only if it survives every segment), and the path
    is up only when every segment is up.  Duck-types
    ``NetworkCondition`` so channels, tier policy and router cost can
    consume either.
    """

    def __init__(self, *parts):
        self.parts = [p for p in parts if p is not None]

    @property
    def latency_s(self) -> float:
        return sum(p.latency_s for p in self.parts)

    @property
    def bandwidth_bps(self) -> float:
        return min((p.bandwidth_bps for p in self.parts), default=1e9)

    @property
    def loss(self) -> float:
        keep = 1.0
        for p in self.parts:
            keep *= 1.0 - min(p.loss, 0.99)
        return 1.0 - keep

    @property
    def up(self) -> bool:
        return all(p.up for p in self.parts)

    transfer_time = NetworkCondition.transfer_time


class PathCondition:
    """Live view of the path a<->b on a fabric: endpoint uplink of
    ``a``, the pair condition, endpoint uplink of ``b``, composed at
    read time so later ``set_link``/``set_endpoint`` calls are seen by
    channels already handed out.  ``endpoints=False`` reads only the
    pair segment -- a pinned circuit that ignores uplink outages."""

    def __init__(self, fabric: "Fabric", a: str, b: str, *,
                 endpoints: bool = True):
        self.fabric, self.a, self.b = fabric, a, b
        self.endpoints = endpoints

    def _now(self) -> ComposedCondition:
        if not self.endpoints:
            return ComposedCondition(self.fabric.pair_cond(self.a, self.b))
        return self.fabric.path(self.a, self.b)

    @property
    def latency_s(self) -> float:
        return self._now().latency_s

    @property
    def bandwidth_bps(self) -> float:
        return self._now().bandwidth_bps

    @property
    def loss(self) -> float:
        return self._now().loss

    @property
    def up(self) -> bool:
        return self._now().up

    transfer_time = NetworkCondition.transfer_time


class Fabric:
    """Cluster interconnect: one ``Channel`` per engine pair, all ticking
    the same ``SimClock`` so fleet-wide transfer timings compose.  Links
    default to ``default_cond`` until ``set_link`` gives a pair its own
    conditions (a lossy edge uplink next to a fast pod fabric).  Each
    node may additionally register its own uplink condition via
    ``set_endpoint``; ``path`` composes endpoint + pair + endpoint so
    conditions are properties of the route, not of a single global
    knob."""

    def __init__(self, default_cond: NetworkCondition | None = None):
        self.clock = SimClock()
        self.default_cond = default_cond or NetworkCondition()
        self._conds: dict[frozenset, NetworkCondition] = {}
        self._endpoints: dict[str, NetworkCondition] = {}
        self._links: dict[frozenset, Channel] = {}
        self._pair_links: dict[frozenset, Channel] = {}

    def set_link(self, a: str, b: str, cond: NetworkCondition):
        self._conds[frozenset((a, b))] = cond
        self._links.pop(frozenset((a, b)), None)

    def set_endpoint(self, name: str, cond: NetworkCondition | None):
        if cond is None:
            self._endpoints.pop(name, None)
        else:
            self._endpoints[name] = cond

    def endpoint(self, name: str) -> NetworkCondition | None:
        return self._endpoints.get(name)

    def pair_cond(self, a: str, b: str) -> NetworkCondition:
        return self._conds.get(frozenset((a, b)), self.default_cond)

    def path(self, a: str, b: str, *,
             end_a: NetworkCondition | None = None,
             end_b: NetworkCondition | None = None) -> ComposedCondition:
        """Effective condition of the a->b route: a's uplink, the pair
        link, b's uplink.  Explicit ``end_*`` override the registered
        endpoint conditions (the router passes a handle's tier uplink
        here)."""
        return ComposedCondition(
            end_a if end_a is not None else self._endpoints.get(a),
            self.pair_cond(a, b),
            end_b if end_b is not None else self._endpoints.get(b),
        )

    def link(self, a: str, b: str) -> Channel:
        key = frozenset((a, b))
        if key not in self._links:
            self._links[key] = Channel(cond=PathCondition(self, a, b),
                                       clock=self.clock)
        return self._links[key]

    def pair_link(self, a: str, b: str) -> Channel:
        """A pinned circuit between two co-provisioned engines (a
        draft/verify tier pair's dedicated interconnect): the channel
        reads only the live pair-level condition, so endpoint uplink
        outages -- which gate routing and client traffic -- do not sever
        an established intra-pair wire."""
        key = frozenset((a, b))
        if key not in self._pair_links:
            self._pair_links[key] = Channel(
                cond=PathCondition(self, a, b, endpoints=False),
                clock=self.clock)
        return self._pair_links[key]


class AttestedSession:
    """Mutually-attested session between two enclaves (paper §5).

    Handshake: exchange nonces -> exchange quotes (bound to nonces) ->
    verify signature/whitelist/freshness/counter/capabilities ->
    derive attestation-bound session key.  All payloads then travel
    sealed (encrypt-then-MAC) with the workload id as AAD."""

    def __init__(self, a: Attester, b: Attester, channel: Channel,
                 whitelist: set[str], need: frozenset[str] = frozenset()):
        self.channel = channel
        self.a, self.b = a, b
        nonce_a, nonce_b = os.urandom(8).hex(), os.urandom(8).hex()
        qa = a.quote(nonce_b)        # quote binds the peer's nonce
        qb = b.quote(nonce_a)
        # wire: quotes are public; taps may observe/modify them
        self.channel.send(qa.payload())
        self.channel.send(qb.payload())
        b.verify(a.enclave_id, qa, nonce=nonce_b, whitelist=whitelist,
                 need=need)
        a.verify(b.enclave_id, qb, nonce=nonce_a, whitelist=whitelist)
        self.key_a = a.session_key(b.enclave_id, qa, qb)
        self.key_b = b.session_key(a.enclave_id, qb, qa)
        assert self.key_a == self.key_b
        self.quotes = (qa, qb)

    def transfer(self, payload: bytes, aad: bytes = b"") -> bytes:
        """Seal on A, wire (taps may tamper), open on B."""
        sealed = crypto.seal(self.key_a, payload, aad)
        wired = self.channel.send(sealed)
        return crypto.open_(self.key_b, wired, aad)


def transitive_chain(hops: list[Attester], channel: Channel,
                     whitelist: set[str]) -> list[Quote]:
    """Multi-hop migration trust chain (paper §5): every adjacent pair
    performs mutual attestation; one bad hop poisons the chain."""
    quotes = []
    for src, dst in zip(hops, hops[1:]):
        s = AttestedSession(src, dst, channel, whitelist)
        quotes.extend(s.quotes)
    return quotes


# ---------------------------------------------------------------------------
# Message transports
# ---------------------------------------------------------------------------
#
# The fleet's control plane and engine services talk in framed messages.
# A transport moves opaque messages (bytes) between named nodes; the bus
# layer (fleet/bus.py) owns encoding.  Fault injection is sender-side
# and per-message: a hook inspects (src, dst, payload) and returns
# None/"ok" (deliver), "drop" (silently lose the message), or
# ("delay", seconds) (deliver late -- immediately into a hold queue on
# the in-proc transport, via a timer on the socket transport).

FaultHook = Callable[[str, str, bytes], object]


class FrameTooLarge(ValueError):
    """A message over the socket transport's ``MAX_FRAME``: refused at
    the sender before any byte is written, and counted (``refused``).
    Also raised inside a reader for a frame header over ``MAX_FRAME``
    (counted as ``refused_in``; the connection closes)."""


class Transport:
    """Message fabric between named nodes."""

    def register(self, name: str, deliver: Callable[[bytes], None]) -> None:
        raise NotImplementedError

    def deregister(self, name: str) -> None:
        raise NotImplementedError

    def send(self, src: str, dst: str, payload: bytes) -> bool:
        """Hand one message to the fabric.  Returns False when the
        destination is known-unreachable (dead peer); a True return is
        *not* a delivery guarantee -- messages may still be lost in
        flight.  Reliability lives above (RPC retry + idempotent
        receivers)."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class InProcTransport(Transport):
    """Deterministic in-process transport: ``send`` delivers
    synchronously into the destination's handler on the caller's
    thread.  This is the transport the bit-exactness / conservation
    contracts are verified on.  Faulted "delay" messages park in
    ``held`` until the test calls ``release_held``."""

    def __init__(self):
        self._nodes: dict[str, Callable[[bytes], None]] = {}
        self.fault: Optional[FaultHook] = None
        self.held: list[tuple[str, str, bytes]] = []
        self.dropped: int = 0

    def register(self, name: str, deliver: Callable[[bytes], None]) -> None:
        self._nodes[name] = deliver

    def deregister(self, name: str) -> None:
        self._nodes.pop(name, None)

    def send(self, src: str, dst: str, payload: bytes) -> bool:
        if dst not in self._nodes:
            return False
        if self.fault is not None:
            verdict = self.fault(src, dst, payload)
            if verdict == "drop":
                self.dropped += 1
                return True
            if isinstance(verdict, tuple) and verdict and verdict[0] == "delay":
                self.held.append((src, dst, payload))
                return True
        self._nodes[dst](payload)
        return True

    def release_held(self) -> int:
        """Deliver every held message (in order); returns how many."""
        held, self.held = self.held, []
        n = 0
        for src, dst, payload in held:
            deliver = self._nodes.get(dst)
            if deliver is not None:
                deliver(payload)
                n += 1
        return n


def _close(sock: socket.socket) -> None:
    try:
        sock.close()
    except OSError:
        pass


class SocketTransport(Transport):
    """Loopback TCP transport: one listener per node, frames are
    4-byte big-endian length prefix + payload, one cached outbound
    connection per (src, dst) pair.  Each accepted connection gets a
    reader thread that feeds complete frames to the node's handler, so
    a migration blob in flight never blocks another engine's decode
    loop.  A reader takes each frame in one ``recv`` (``MSG_WAITALL``):
    under the GIL a loop of small reads waits for the interpreter once
    a chunk, which made a large frame crawl while engine threads ran.

    A pair has two connections: frames over ``BULK_BYTES`` (slot blobs,
    shadows) take one, the rest (heartbeats, acks, reports) the other,
    so a heartbeat never waits behind a shadow of hundreds of MB on the
    same socket (the JAX package keeps one connection a pair; see
    ``scripts/socket_fleet_stress.py`` for the two readings).  Frames
    keep their order within a lane, not across the two.

    ``MAX_FRAME`` is 1 GiB (the JAX package's is 64 MiB, under one
    full-width slot blob of 100-200 MB, and its reader drops a longer
    frame and closes the connection without a trace).  A message over
    it is refused at the sender (``FrameTooLarge``, counted in
    ``refused``), and a frame header over it is counted in
    ``refused_in`` before its connection closes, so no frame is lost
    without a trace."""

    MAX_FRAME = 1024 * 1024 * 1024
    BULK_BYTES = 1024 * 1024

    def __init__(self, host: str = "127.0.0.1"):
        self.host = host
        self._lock = threading.RLock()
        self._addrs: dict[str, tuple[str, int]] = {}
        self._servers: dict[str, socket.socket] = {}
        # (src, dst, bulk) -> connection and its send lock
        self._conns: dict[tuple[str, str, bool],
                          tuple[socket.socket, threading.Lock]] = {}
        self._threads: list[threading.Thread] = []
        self.fault: Optional[FaultHook] = None
        self.dropped = 0
        self.refused = 0
        self.refused_in = 0
        self.refusals: list[str] = []
        self._closed = False

    # -- wire helpers ------------------------------------------------
    @staticmethod
    def _send_frame(sock: socket.socket, payload: bytes) -> None:
        sock.sendall(struct.pack(">I", len(payload)))
        sock.sendall(payload)

    @classmethod
    def _recv_frame(cls, sock: socket.socket) -> bytearray | None:
        hdr = cls._recv_exact(sock, 4)
        if hdr is None:
            return None
        (n,) = struct.unpack(">I", hdr)
        if n > cls.MAX_FRAME:
            raise FrameTooLarge(f"frame of {n} bytes over MAX_FRAME "
                                f"{cls.MAX_FRAME}")
        return cls._recv_exact(sock, n)

    @staticmethod
    def _recv_exact(sock: socket.socket, n: int) -> bytearray | None:
        # filled in place and handed on as is: the decoder copies what
        # it keeps, so a 100 MB frame is not copied once more here
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            try:
                k = sock.recv_into(view[got:], n - got, socket.MSG_WAITALL)
            except OSError:
                return None
            if not k:
                return None
            got += k
        return buf

    # -- node lifecycle ----------------------------------------------
    def register(self, name: str, deliver: Callable[[bytes], None]) -> None:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self.host, 0))
        srv.listen(16)
        with self._lock:
            self._servers[name] = srv
            self._addrs[name] = srv.getsockname()
        t = threading.Thread(target=self._accept_loop,
                             args=(name, srv, deliver),
                             name=f"xport-accept-{name}", daemon=True)
        t.start()
        self._threads.append(t)

    def _accept_loop(self, name: str, srv: socket.socket,
                     deliver: Callable[[bytes], None]) -> None:
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return      # listener closed: node deregistered
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._reader_loop,
                                 args=(name, conn, deliver),
                                 name=f"xport-read-{name}", daemon=True)
            t.start()
            self._threads.append(t)

    def _reader_loop(self, name: str, conn: socket.socket,
                     deliver: Callable[[bytes], None]) -> None:
        while True:
            try:
                frame = self._recv_frame(conn)
            except FrameTooLarge as e:
                with self._lock:
                    self.refused_in += 1
                    self.refusals.append(f"to {name}: {e}")
                frame = None
            if frame is None:
                _close(conn)
                return
            deliver(frame)

    def deregister(self, name: str) -> None:
        """Kill the node: close its listener and every cached
        connection touching it.  In-flight frames to it are lost --
        exactly the peer-death fault the chaos suite exercises."""
        with self._lock:
            srv = self._servers.pop(name, None)
            self._addrs.pop(name, None)
            stale = [k for k in self._conns if name in k[:2]]
            socks = [self._conns.pop(k)[0] for k in stale]
        if srv is not None:
            _close(srv)
        for s in socks:
            _close(s)

    # -- sending -----------------------------------------------------
    def _conn_to(self, src: str, dst: str, bulk: bool) \
            -> tuple[socket.socket, threading.Lock] | None:
        key = (src, dst, bulk)
        with self._lock:
            conn = self._conns.get(key)
            if conn is not None:
                return conn
            addr = self._addrs.get(dst)
        if addr is None:
            return None
        try:
            sock = socket.create_connection(addr, timeout=5.0)
        except OSError:
            return None
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with self._lock:
            # lost the race to another sender thread: keep theirs
            if key in self._conns:
                _close(sock)
                return self._conns[key]
            self._conns[key] = (sock, threading.Lock())
            return self._conns[key]

    def send(self, src: str, dst: str, payload: bytes) -> bool:
        if self._closed:
            return False
        if len(payload) > self.MAX_FRAME:
            why = (f"{src} -> {dst}: message of {len(payload)} bytes over "
                   f"MAX_FRAME {self.MAX_FRAME}")
            with self._lock:
                self.refused += 1
                self.refusals.append(why)
            raise FrameTooLarge(why)
        if self.fault is not None:
            verdict = self.fault(src, dst, payload)
            if verdict == "drop":
                with self._lock:
                    self.dropped += 1
                return True
            if isinstance(verdict, tuple) and verdict and verdict[0] == "delay":
                delay_s = float(verdict[1])
                timer = threading.Timer(
                    delay_s, self._send_now, args=(src, dst, payload))
                timer.daemon = True
                timer.start()
                return True
        return self._send_now(src, dst, payload)

    def _send_now(self, src: str, dst: str, payload: bytes) -> bool:
        key = (src, dst, len(payload) > self.BULK_BYTES)
        conn = self._conn_to(*key)
        if conn is None:
            return False
        sock, lock = conn
        try:
            with lock:
                self._send_frame(sock, payload)
            return True
        except OSError:
            with self._lock:
                if self._conns.get(key) is conn:
                    del self._conns[key]
            _close(sock)
            return False

    def close(self) -> None:
        self._closed = True
        with self._lock:
            servers = list(self._servers.values())
            conns = [c[0] for c in self._conns.values()]
            self._servers.clear()
            self._conns.clear()
            self._addrs.clear()
        for s in servers + conns:
            _close(s)
