"""The simulated byte fabric and the attested session over it (the
port's copy of the JAX package's ``core.channel`` without its message
transports, which only the fleet's service mode uses).

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
from dataclasses import dataclass, field

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
