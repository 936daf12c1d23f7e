"""Routing policy: where does a request (or a migrating slot) run?

Composes the daemon's placement rules with fleet-local signals:

  1. policy gate  -- ``daemon.placement_allowed``: sensitive data only on
     attested engines (the §7.4 rule, lifted from pairwise to N-way);
  2. quality      -- engines carry a ``QualityTier`` (distinct weights:
     full bf16, int8-quantized, small model); a request's
     ``quality_floor`` bounds how far it may degrade, and the router
     prefers the highest acceptable tier, downshifting only when the
     preferred tier is saturated, misses the deadline, or its links are
     down/starved (paper §3.5/§9.6: availability over fidelity);
  3. capacity     -- only engines with a free slot are candidates;
  4. cost         -- the daemon's roofline model prices the request's
     remaining work on each candidate's own model config and
     ``DeviceProfile``, scaled by the engine's current load so a
     fast-but-busy pod loses to an idle edge box when the work is small.

``route`` is shape-agnostic: fresh admissions and failover re-placements
go through the same scoring, so a re-placed slot obeys the same policy
gates as a fresh request.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.configs.base import ModelConfig
from repro_torch.core.daemon import PrivacyAwareDaemon, placement_allowed
from repro_torch.serving.prefix_cache import HashedPrefix


@dataclass
class RouteDecision:
    target: str | None               # engine name, or None (stay queued)
    reason: str
    scores: dict[str, float] = field(default_factory=dict)
    # policy gates passed but nothing had capacity: the one failure mode
    # preemption can fix (a policy refusal never is -- evicting a slot
    # does not make an engine attested)
    saturated: bool = False
    tier: str | None = None          # tier of the chosen engine
    quality: float = 1.0             # quality of the chosen tier
    preferred: str | None = None     # best acceptable tier in the fleet
    degraded: bool = False           # chosen tier < preferred tier
    cause: str = ""                  # "saturated" | "deadline" | "link"
    prefix_hit: int = 0              # cached-prefix tokens at the target

    def to_attrs(self) -> dict:
        """The decision's facts as span attributes (attached to the
        request's prefill span at dispatch) -- only what explains the
        placement, not the full score table."""
        attrs = {"route_reason": self.reason}
        if self.tier:
            attrs["route_tier"] = self.tier
        if self.prefix_hit:
            attrs["route_prefix_hit"] = self.prefix_hit
        if self.degraded:
            attrs["route_degraded"] = True
            attrs["route_cause"] = self.cause or self.reason
            if self.preferred:
                attrs["route_preferred"] = self.preferred
        return attrs


class Router:
    def __init__(self, *, max_unattested_sensitivity: str = "public",
                 load_weight: float = 1.0,
                 bandwidth_floor: float = 0.0):
        """``bandwidth_floor`` (bytes/s; 0 = off) is the interactive-
        traffic bound from replication.pick_tier, lifted per-request:
        an engine whose link has degraded below it is skipped while any
        adequately-linked tier remains -- heavy tiers over starved
        links lose to light tiers nearby."""
        self.max_unattested_sensitivity = max_unattested_sensitivity
        self.load_weight = load_weight
        self.bandwidth_floor = bandwidth_floor

    def eligible(self, sensitivity: str, handle) -> bool:
        return (handle.healthy
                and placement_allowed(sensitivity, handle.profile,
                                      self.max_unattested_sensitivity))

    def score(self, handle, cfg: ModelConfig, *, prefill_tokens: int,
              decode_tokens: int, loaded: bool = True) -> float:
        """Estimated seconds to finish this request here: roofline time
        for the remaining work on the handle's OWN model config (a
        small-model tier is genuinely cheaper per token), inflated by
        current occupancy (``loaded=False`` gives the raw
        latency-optimal estimate)."""
        cfg = getattr(handle.engine, "cfg", None) or cfg
        t = PrivacyAwareDaemon.step_time(cfg, handle.profile,
                                         prefill_tokens=prefill_tokens,
                                         decode_tokens=decode_tokens)
        if not loaded:
            return t
        return t * (1.0 + self.load_weight * handle.load)

    @staticmethod
    def _tier_of(handle):
        tier = getattr(handle, "tier", None)
        if tier is None:
            from repro_torch.core.replication import FULL_TIER
            return FULL_TIER
        return tier

    def _starved(self, cond) -> bool:
        return (self.bandwidth_floor > 0.0 and cond is not None
                and cond.bandwidth_bps < self.bandwidth_floor)

    @staticmethod
    def _reachable(cond) -> bool:
        return cond is None or (cond.up and cond.loss < 0.95)

    def route(self, handles, cfg: ModelConfig, *, sensitivity: str,
              prefill_tokens: int, decode_tokens: int,
              exclude: frozenset[str] = frozenset(),
              deadline_slack: float | None = None,
              quality_floor: float = 0.0,
              src_tier: str | None = None,
              reprefill_tokens: int = 0,
              tokens=None, tenant: str = "",
              fabric=None, path_src: str | None = None) -> RouteDecision:
        """Pick an engine.

        Tier preference is lexicographically ahead of cost: among
        acceptable tiers (quality >= ``quality_floor``, links up) the
        highest-quality tier with capacity that can meet the deadline
        wins, and cost/load only break ties *within* that tier.  A pick
        below the best acceptable tier is a *degradation* and the
        decision records why (``cause``: saturated / deadline / link)
        so the fleet can audit every downshift as a ``QualityEvent``.

        ``deadline_slack`` (seconds until the request's deadline) feeds
        the cost model: when the load-balanced pick in a tier would
        miss the deadline, routing first turns latency-optimal within
        the tier, then degrades to a cheaper tier that makes it; when
        nothing does, the raw-fastest acceptable engine wins (least-bad
        -- identical to the pre-tier behavior for one-tier fleets).

        Re-placements of existing state pass ``src_tier`` +
        ``reprefill_tokens``: a target on a DIFFERENT tier cannot
        inject the donor's cache rows and must re-prefill the committed
        stream, so its score is charged those prefill tokens -- the
        deadline gate then certifies the move that will actually
        happen, not the bit-exact one that won't.

        Session affinity: when ``tokens`` (the stream the target would
        prefill) and ``tenant`` are given, an engine holding a cached
        prefix of them is credited that overlap -- its prefill charge
        *and* its capacity check drop by the hit (shared pages cost the
        admitting engine nothing), so a warm engine beats an equally
        loaded cold one and can admit work a cold gate would refuse.

        Path-aware link health: with a ``fabric``, reachability and the
        bandwidth floor read the *composed route* from ``path_src``
        (``"$client"`` for fresh admissions, the donor engine for a
        migrating slot) to each candidate -- endpoint uplink + per-pair
        link -- instead of the candidate's endpoint condition alone, so
        a degraded pair link between donor and target is priced even
        when both endpoints are healthy.  Without a fabric the legacy
        endpoint-only view applies."""
        conds: dict[str, object] = {}

        def link_cond(h):
            if h.name not in conds:
                if fabric is None:
                    conds[h.name] = getattr(h, "cond", None)
                else:
                    conds[h.name] = fabric.path(
                        path_src or "$client", h.name,
                        end_b=getattr(h, "cond", None))
            return conds[h.name]

        gated = [h for h in handles
                 if h.name not in exclude and self.eligible(sensitivity, h)]
        if not gated:
            return RouteDecision(None, f"no attested-eligible engine for "
                                       f"{sensitivity} data")
        floored = [h for h in gated
                   if self._tier_of(h).quality >= quality_floor - 1e-12]
        if not floored:
            return RouteDecision(
                None, f"no eligible tier at/above quality floor "
                      f"{quality_floor:.2f}", cause="floor")
        # the best tier the request could have had, link health aside:
        # picks below it are degradations (a downed link on the best
        # tier makes a lower-tier pick a downshift, not a free choice)
        preferred_q = max(self._tier_of(h).quality for h in floored)
        preferred = next(self._tier_of(h).name for h in floored
                         if self._tier_of(h).quality == preferred_q)
        acceptable = [h for h in floored
                      if self._reachable(link_cond(h))]
        if not acceptable:
            return RouteDecision(None, "all eligible engines unreachable "
                                       "(links down)", cause="link",
                                 preferred=preferred)
        # starved links: skip while an adequately-linked engine exists
        # anywhere (availability beats the bandwidth preference)
        well_linked = [h for h in acceptable
                       if not self._starved(link_cond(h))]
        usable = well_linked or acceptable

        # why was each better tier passed over?  (quality, kind) pairs;
        # a degraded pick's cause is the kind of the best tier above it
        skips: list[tuple[float, str]] = []
        for h in floored:
            if not self._reachable(link_cond(h)) or \
                    (well_linked and self._starved(link_cond(h))):
                skips.append((self._tier_of(h).quality, "link"))

        by_quality: dict[float, list] = {}
        for h in usable:
            by_quality.setdefault(self._tier_of(h).quality, []).append(h)

        def pick(best, scores, note, default_cause=""):
            tier = self._tier_of(best)
            degraded = tier.quality < preferred_q - 1e-12
            cause = default_cause
            above = [(q, kind) for q, kind in skips
                     if q > tier.quality + 1e-12]
            if above:
                cause = max(above)[1]
            return RouteDecision(
                best.name, note, scores, tier=tier.name,
                quality=tier.quality, preferred=preferred,
                degraded=degraded, cause=cause if degraded else "",
                prefix_hit=hit(best))

        # cached-prefix affinity: page-aligned overlap between the
        # stream this handle would prefill and its prefix cache.  The
        # prompt's blocks are hashed ONCE here (lazily, memoized per
        # namespace/page_size inside HashedPrefix) and every engine is
        # probed with the precomputed digests -- probing N engines used
        # to re-hash the full prompt N times per route call
        hits: dict[str, int] = {}
        hashed = HashedPrefix(tokens) if tokens is not None \
            and len(tokens) else None

        def hit(h):
            if h.name not in hits:
                probe = getattr(h.engine, "prefix_hit_tokens_hashed", None)
                if probe is not None and hashed is not None:
                    hits[h.name] = probe(tenant, hashed)
                else:
                    legacy = getattr(h.engine, "prefix_hit_tokens", None)
                    hits[h.name] = 0 if (legacy is None or tokens is None) \
                        else legacy(tenant, tokens)
            return hits[h.name]

        # per-handle prefill cost: cross-tier targets pay the lossy
        # re-prefill of the committed stream on top of any fresh
        # prefill; engines holding a cached prefix of the stream are
        # credited the overlap (both cases prefill through
        # ``add_request``, which serves the hit from shared pages)
        def pf(h):
            base = prefill_tokens
            if src_tier and self._tier_of(h).name != src_tier:
                base += reprefill_tokens
            return max(base - hit(h), 0)

        all_ready: list = []
        causes: list[str] = []
        for q in sorted(by_quality, reverse=True):
            group = by_quality[q]
            tname = self._tier_of(group[0]).name
            # capacity: token-budget admission -- the engine decides
            # whether prefill+decode tokens fit right now (dense: a free
            # slot whose max_len holds them; paged: a free decode row
            # AND enough free pages), so fleets mix dense and paged
            # engines behind one gate; a cached prefix discounts the
            # page charge (shared pages need no fresh allocation) but
            # never the max_len bound, so the discount goes through the
            # paged gate's cached_tokens kwarg, not a smaller need
            need = prefill_tokens + decode_tokens
            ready = [h for h in group
                     if (h.engine.can_admit(need, cached_tokens=hit(h))
                         if hit(h) else h.engine.can_admit(need))]
            if not ready:
                causes.append(f"{tname} saturated")
                skips.append((q, "saturated"))
                continue
            all_ready.extend(ready)
            scores = {h.name: self.score(h, cfg,
                                         prefill_tokens=pf(h),
                                         decode_tokens=decode_tokens)
                      for h in ready}
            best = min(ready, key=lambda h: scores[h.name])
            if deadline_slack is None or scores[best.name] <= deadline_slack:
                return pick(best, scores,
                            f"min roofline+load cost "
                            f"{scores[best.name]:.2e}s"
                            + (f" on tier {tname}" if skips else ""))
            raw = {h.name: self.score(h, cfg,
                                      prefill_tokens=pf(h),
                                      decode_tokens=decode_tokens,
                                      loaded=False)
                   for h in ready}
            fast = min(ready, key=lambda h: raw[h.name])
            if raw[fast.name] <= deadline_slack:
                return pick(fast, raw,
                            f"deadline-urgent: raw roofline "
                            f"{raw[fast.name]:.2e}s (load-blind)")
            causes.append(f"{tname} misses deadline "
                          f"(raw {raw[fast.name]:.2e}s > "
                          f"{deadline_slack:.2e}s slack)")
            skips.append((q, "deadline"))
        if all_ready:
            # no tier makes the deadline: least-bad, the raw-fastest
            # acceptable engine of any tier
            raw = {h.name: self.score(h, cfg,
                                      prefill_tokens=pf(h),
                                      decode_tokens=decode_tokens,
                                      loaded=False)
                   for h in all_ready}
            fast = min(all_ready, key=lambda h: raw[h.name])
            return pick(fast, raw,
                        f"deadline-urgent: raw roofline "
                        f"{raw[fast.name]:.2e}s (load-blind)",
                        default_cause="deadline")
        return RouteDecision(None, "all eligible engines full "
                                   "(slots or context budget)",
                             saturated=True,
                             preferred=preferred,
                             cause="; ".join(causes))
