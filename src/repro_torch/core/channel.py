"""The simulated byte channel and the attested session over it (the
port's copy of the parts of the JAX package's ``core.channel`` that the
migration path uses).

A ``Channel`` is a byte pipe whose latency, bandwidth and packet loss
are modelled against a deterministic ``SimClock``: the migration report
reads transfer time off the clock.  Everything above the byte layer is
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
