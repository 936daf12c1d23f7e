"""The fleet message bus: typed envelopes over a pluggable transport.

The control plane and the engine services never call each other --
they exchange ``Message`` envelopes through a ``MessageBus`` riding a
``core.channel.Transport`` (deterministic in-process for tests, real
loopback TCP for concurrent serving).  Frames are msgpack, byte for
byte the JAX package's (``core.msgpack_subset``; binary-safe: migration
blobs travel as raw bytes in the body).

Delivery is at-least-once *at best*: the socket transport can lose
frames (faults, dying peers), so anything that must happen exactly once
is an RPC -- the sender retries an unacked ``req_id`` and the receiver
deduplicates it (``DedupCache``), making the operation idempotent.
One-way messages (heartbeats, step reports) tolerate loss by design.
A message the transport refuses for its size raises ``FrameTooLarge``
to the sender and is counted here (``refused``, ``refusals``).

``FailureDetector`` is the liveness half: every service heartbeats on
the fleet clock; a service whose last beat is older than ``timeout_s``
is *declared* failed (``HeartbeatLoss`` on the unified audit log)
instead of the controller only noticing death when it next touches the
engine.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Callable, ClassVar, Optional

from repro_torch.core.channel import FrameTooLarge, Transport
from repro_torch.core.msgpack_subset import packb, unpackb

__all__ = ["Message", "Mailbox", "MessageBus", "FailureDetector",
           "HeartbeatLoss", "DedupCache", "encode_message",
           "decode_message"]


@dataclass
class Message:
    """One envelope on the bus.

    ``req_id`` correlates RPCs: a positive id means the sender expects
    an ``ack`` carrying the same id (and will re-send until it gets
    one); 0 is fire-and-forget.  ``body`` must be msgpack-encodable
    (ints, floats, strings, bytes, lists, dicts)."""
    type: str                        # "place" | "inject" | "extract" | ...
    src: str
    dst: str
    rid: str = ""                    # request id the message concerns
    req_id: int = 0                  # RPC correlation id (0 = one-way)
    body: dict = field(default_factory=dict)


def encode_message(msg: Message) -> bytes:
    return packb({"type": msg.type, "src": msg.src, "dst": msg.dst,
                  "rid": msg.rid, "req_id": msg.req_id, "body": msg.body})


def decode_message(frame: bytes) -> Message:
    d = unpackb(frame)
    return Message(type=d["type"], src=d["src"], dst=d["dst"],
                   rid=d.get("rid", ""), req_id=d.get("req_id", 0),
                   body=d.get("body", {}))


class Mailbox:
    """Per-node inbound queue.  Thread-safe; the in-process transport
    delivers synchronously on the sender's thread, the socket transport
    from its reader threads -- consumers see one interface either way."""

    def __init__(self, name: str):
        self.name = name
        self._q: queue.Queue = queue.Queue()

    def put(self, msg: Message):
        self._q.put(msg)

    def get(self, timeout: float | None = None) -> Optional[Message]:
        try:
            if timeout is None:
                return self._q.get_nowait()
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def drain(self, limit: int = 256) -> list[Message]:
        out = []
        while len(out) < limit:
            msg = self.get()
            if msg is None:
                break
            out.append(msg)
        return out

    def __len__(self) -> int:
        return self._q.qsize()


class MessageBus:
    """Name registry + encode/decode over one ``Transport``.  Counts what
    it sent, what the transport called unreachable, what it refused for
    size, and the largest frame of each message type."""

    def __init__(self, transport: Transport):
        self.transport = transport
        self._boxes: dict[str, Mailbox] = {}
        self._lock = threading.Lock()
        self.sent = 0
        self.send_failures = 0       # transport said "unreachable"
        self.refused = 0             # transport refused the frame's size
        self.refusals: list[tuple[str, str, str, str, int]] = []
        self.largest: dict[str, int] = {}   # message type -> frame bytes

    def register(self, name: str) -> Mailbox:
        box = Mailbox(name)
        self._boxes[name] = box
        self.transport.register(
            name, lambda frame, _b=box: _b.put(decode_message(frame)))
        return box

    def deregister(self, name: str):
        self._boxes.pop(name, None)
        self.transport.deregister(name)

    def mailbox(self, name: str) -> Optional[Mailbox]:
        return self._boxes.get(name)

    def send(self, msg: Message) -> bool:
        frame = encode_message(msg)
        try:
            ok = self.transport.send(msg.src, msg.dst, frame)
        except FrameTooLarge:
            with self._lock:
                self.refused += 1
                self.refusals.append((msg.type, msg.src, msg.dst, msg.rid,
                                      len(frame)))
            raise
        with self._lock:
            if ok:
                self.sent += 1
                if len(frame) > self.largest.get(msg.type, 0):
                    self.largest[msg.type] = len(frame)
            else:
                self.send_failures += 1
        return ok

    def close(self):
        self.transport.close()


class DedupCache:
    """Bounded idempotency window: remembers the ack body of the last
    ``maxlen`` RPC ids handled, so a retried request is re-acked
    without re-executing.  Sized far above any plausible in-flight RPC
    count; the bound only guards unbounded growth."""

    def __init__(self, maxlen: int = 4096):
        self.maxlen = maxlen
        self._acks: dict[int, dict] = {}
        self._order: list[int] = []

    def seen(self, req_id: int) -> Optional[dict]:
        return self._acks.get(req_id)

    def remember(self, req_id: int, ack_body: dict):
        if req_id in self._acks:
            self._acks[req_id] = ack_body
            return
        self._acks[req_id] = ack_body
        self._order.append(req_id)
        while len(self._order) > self.maxlen:
            self._acks.pop(self._order.pop(0), None)


@dataclass
class HeartbeatLoss:
    """Typed audit event: a service stopped heartbeating and the fleet
    clock timed it out -- declared failed *by liveness*, before any
    request traffic touched the dead engine."""
    kind: ClassVar[str] = "heartbeat_loss"   # audit-log discriminator
    engine: str
    last_beat: float                 # fleet clock of the final beat
    timeout_s: float
    t: float                         # fleet clock at declaration
    rid: str = ""                    # rides the unified log unindexed


class FailureDetector:
    """Heartbeat bookkeeping on the fleet clock (injectable, so the
    deterministic suite advances a SimClock past the timeout instead of
    sleeping)."""

    def __init__(self, *, timeout_s: float, clock: Callable[[], float]):
        self.timeout_s = timeout_s
        self.clock = clock
        self._lock = threading.Lock()
        self._last: dict[str, float] = {}

    def expect(self, name: str):
        """Start watching ``name``; its first deadline counts from now."""
        with self._lock:
            self._last[name] = self.clock()

    def forget(self, name: str):
        with self._lock:
            self._last.pop(name, None)

    def beat(self, name: str, t: float | None = None):
        with self._lock:
            if name in self._last:   # beats from forgotten nodes ignored
                self._last[name] = self.clock() if t is None else t

    def last_beat(self, name: str) -> float | None:
        with self._lock:
            return self._last.get(name)

    def dead(self, now: float | None = None) -> list[tuple[str, float]]:
        """Every watched node whose last beat is past the timeout, as
        (name, last_beat).  The caller forgets nodes it acts on."""
        now = self.clock() if now is None else now
        with self._lock:
            return [(n, t) for n, t in self._last.items()
                    if now - t > self.timeout_s]
