"""Multi-tier replication with quality degradation (paper §3.5, §9.6).

Tiers (cloud / edge / device) each hold an Engine over a different
quality point: full-precision full model, int8-quantized model, or a
distilled narrow config.  ``QualityTier`` names that quality point and
is shared with the fleet layer, where it is a first-class routing
dimension (``fleet.router`` degrades a request to a lower-but-acceptable
tier under saturation, deadline pressure or link failure -- the
request-granular form of the workspace-granular degradation here).

A ``ReplicationManager``:

  * keeps replicas in sync with incremental page deltas of the primary's
    workspace (the ~12%-of-KV sync of §9.6), stamped with vector clocks;
  * monitors ``NetworkCondition`` and fails over to the best reachable
    tier within a latency budget (paper: 200ms, 80% functionality);
  * degrades quality under bandwidth limits (lightweight models,
    "trading 8% accuracy for stable response times");
  * merges diverged replicas on reconnect (vector clocks: dominance
    merges fast-forward; concurrent edits -> the higher-quality side
    wins, divergent suffix re-validated).

The port's copy of the JAX package's ``core.replication``.  A failover
restores the snapshot against the target tier engine's own state (its
structure, dtypes and int leaves) and places it on that engine's
device; ``last_failover_stages`` splits the latency into unpack, place
and attach.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.channel import NetworkCondition
from repro_torch.core.migration import (Snapshot, delta_fraction,
                                        make_delta, _pack_workspace,
                                        _unpack_workspace, page_hashes,
                                        place_tree)
from repro_torch.core.workspace import AgentWorkspace, VectorClock
from repro_torch.serving.engine import Engine


@dataclass(frozen=True)
class QualityTier:
    """One quality point of a multi-tier deployment: a name, a relative
    answer quality in [0, 1], and the kind of model behind it.  Shared
    between the replication layer (workspace-granular failover) and the
    fleet layer (request-granular routing): two engines of the *same*
    tier run identical weights, so in-flight state migrates between
    them bit-exactly; engines of *different* tiers run distinct weights
    and a hand-off must re-prefill the committed token stream instead
    (``fleet.balancer`` lossy hand-off)."""
    name: str                        # "cloud" | "edge" | "device" | ...
    quality: float = 1.0             # relative answer quality in [0,1]
    kind: str = "bf16"               # "bf16" | "int8" | "small"


# the single-tier default: a fleet that never declares tiers behaves
# exactly as before (every engine shares one tier -> every migration is
# the bit-exact kind)
FULL_TIER = QualityTier("full", 1.0, "bf16")


@dataclass
class ReplicaTier:
    name: str                        # "cloud" | "edge" | "device"
    engine: Engine
    quality: float                   # relative answer quality in [0,1]
    functionality: float             # fraction of features available
    cond: NetworkCondition = field(default_factory=NetworkCondition)
    snapshot: Optional[Snapshot] = None
    vclock: VectorClock = field(default_factory=VectorClock)

    @property
    def reachable(self) -> bool:
        return self.cond.up and self.cond.loss < 0.95

    def as_quality_tier(self, kind: str = "bf16") -> QualityTier:
        """The fleet-layer view of this replica's quality point."""
        return QualityTier(self.name, self.quality, kind)


@dataclass
class FailoverEvent:
    t: float
    src: str
    dst: str
    latency_s: float
    quality: float
    reason: str


class ReplicationManager:
    def __init__(self, tiers: list[ReplicaTier], primary: str = "cloud",
                 *, local_tier: str | None = None):
        """``local_tier`` names the always-available on-device tier the
        manager falls back to under total disconnection; when None the
        lowest-quality tier plays that role (an on-device tier needs no
        network by construction, and the lowest tier is the cheapest
        approximation of one)."""
        self.tiers = {t.name: t for t in tiers}
        self.primary = primary
        assert local_tier is None or local_tier in self.tiers, local_tier
        self.local_tier = local_tier
        self.events: list[FailoverEvent] = []
        self.sync_bytes_total = 0
        self.sync_count = 0
        self.last_delta_fraction = 1.0
        # seconds of the last failover's restore stages (0 when it had
        # no snapshot to restore)
        self.last_failover_stages = {"unpack": 0.0, "place": 0.0,
                                     "attach": 0.0}

    # -- synchronization ----------------------------------------------------
    def sync(self, ws: AgentWorkspace, src: str | None = None) -> dict:
        """Incremental sync of the primary workspace to all reachable
        replicas.  Returns per-tier wire bytes."""
        src = src or self.primary
        blob = _pack_workspace(ws)
        snap = Snapshot(blob, page_hashes(blob))
        out = {}
        for name, tier in self.tiers.items():
            if name == src or not tier.reachable:
                continue
            if tier.snapshot is None:
                payload = blob
                frac = 1.0
            else:
                payload = make_delta(tier.snapshot, snap)
                frac = delta_fraction(tier.snapshot, snap)
            tier.snapshot = snap
            tier.vclock = tier.vclock.merge(ws.vclock)
            self.sync_bytes_total += len(payload)
            self.last_delta_fraction = frac
            out[name] = len(payload)
        self.sync_count += 1
        return out

    # -- failover -----------------------------------------------------------
    def _fallback_tier(self) -> ReplicaTier:
        """The tier of last resort under total disconnection: the
        configured local tier, else the lowest-quality tier.  Always
        defined for a non-empty manager -- a cloud-only fleet degrades
        to its cheapest cloud tier instead of raising KeyError on a
        tier literally named "device"."""
        if self.local_tier is not None:
            return self.tiers[self.local_tier]
        return min(self.tiers.values(), key=lambda t: t.quality)

    def pick_tier(self, *, bandwidth_floor: float = 1e6) -> ReplicaTier:
        """Best reachable tier: highest quality whose link sustains
        interactive traffic; bandwidth-limited networks prefer
        lightweight tiers (quality degradation)."""
        fallback = self._fallback_tier()
        ranked = sorted(self.tiers.values(), key=lambda t: -t.quality)
        for tier in ranked:
            if not tier.reachable:
                continue
            if tier.cond.bandwidth_bps < bandwidth_floor \
                    and tier.quality > 0.5 and tier is not fallback:
                continue  # heavy tier over a starved link: skip
            return tier
        # total disconnection: degrade to the local/lowest tier, which
        # needs no network to serve
        return fallback

    def failover(self, reason: str = "network") -> tuple[ReplicaTier, float]:
        """Switch the active tier; returns (tier, failover latency).

        Latency = detection + restoring the last synced snapshot into the
        target tier's engine (measured, real work)."""
        t0 = time.perf_counter()
        tier = self.pick_tier()
        stages = dict.fromkeys(("unpack", "place", "attach"), 0.0)
        if tier.snapshot is not None:
            try:
                t = time.perf_counter()
                ws = _unpack_workspace(tier.snapshot.blob,
                                       tier.engine.state)
                stages["unpack"] = time.perf_counter() - t
                t = time.perf_counter()
                ws.engine_state = place_tree(ws.engine_state,
                                             tier.engine.device)
                stages["place"] = time.perf_counter() - t
                t = time.perf_counter()
                ws.attach(tier.engine)
                stages["attach"] = time.perf_counter() - t
            except Exception:
                tier.functionality *= 0.8  # degraded restore
        self.last_failover_stages = stages
        latency = time.perf_counter() - t0
        self.events.append(FailoverEvent(
            t=time.time(), src=self.primary, dst=tier.name,
            latency_s=latency, quality=tier.quality, reason=reason))
        self.primary = tier.name
        return tier, latency

    # -- reconnection merge ---------------------------------------------------
    def _quality_of(self, tier_name: str | None) -> float:
        """Quality of a named tier; unknown sides rank below every real
        tier but above nothing (-1 keeps the primary tie-break in
        charge when neither side is identified)."""
        if tier_name is not None and tier_name in self.tiers:
            return self.tiers[tier_name].quality
        return -1.0

    def merge_on_reconnect(self, local_ws: AgentWorkspace,
                           remote_ws: AgentWorkspace, *,
                           local_tier: str | None = None,
                           remote_tier: str | None = None) \
            -> AgentWorkspace:
        """Vector-clock merge of diverged replicas (paper: eventual
        consistency, temporary divergence during partitions).

        Dominance fast-forwards.  Concurrent edits keep the side that
        actually ran at higher quality -- ``local_tier``/``remote_tier``
        name the tiers the workspaces came from; the primary tier breaks
        quality ties, and with neither side identified the remote
        (reconnecting-primary) side keeps the legacy benefit of the
        doubt.  Either way the loser's request outputs are unioned in so
        no user-visible work is lost.  The merge never mutates its
        inputs: the winner is returned as a fresh workspace with copied
        request and clock state (callers keep using their own replicas
        for retries / re-validation)."""
        if remote_ws.vclock.dominates(local_ws.vclock):
            winner, loser = remote_ws, local_ws
        elif local_ws.vclock.dominates(remote_ws.vclock):
            winner, loser = local_ws, remote_ws
        else:
            # concurrent: rank by the tiers the replicas ran on (the
            # old code unconditionally crowned the remote side, which
            # inverted the "keep the higher-quality side" contract
            # whenever the LOCAL side was the better tier)
            lq = self._quality_of(local_tier)
            rq = self._quality_of(remote_tier)
            if lq != rq:
                local_wins = lq > rq
            else:                     # tie: primary side wins
                local_wins = local_tier == self.primary
            winner, loser = (local_ws, remote_ws) if local_wins \
                else (remote_ws, local_ws)
        merged_requests = [copy.deepcopy(r) for r in winner.requests]
        by_rid = {r["rid"] for r in merged_requests}
        for r in loser.requests:
            if r["rid"] not in by_rid:
                merged_requests.append(copy.deepcopy(r))
        return dataclasses.replace(
            winner, requests=merged_requests,
            vclock=local_ws.vclock.merge(remote_ws.vclock))
