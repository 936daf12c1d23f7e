"""Failure- and load-driven rebalancing of individual in-flight requests.

Two mechanisms, both built on ``Engine.extract_slot``/``inject_slot``:

  * shadow checkpoints -- every ``sync_every`` fleet steps each in-flight
    slot is packed (``migration.pack_slot``) and kept fleet-side, the
    per-request analogue of §9.6 replica sync.  When an engine fail-stops
    the balancer re-places each of its requests from the latest shadow on
    a surviving engine chosen by the router; greedy decode then resumes
    bit-identically because the snapshot carries the exact cache rows,
    token tail, position and rng of the stable point.
  * live migration -- for planned moves (draining an engine, smoothing a
    load imbalance) the slot leaves its donor engine and travels the real
    migration/channel stack: compressed, then sealed through an
    ``AttestedSession`` when both endpoints attest (plain fabric link
    otherwise -- which the router only permits for public data).

Cross-tier moves are *lossy by construction*: engines of different
``QualityTier``s run distinct weights, so the donor's cache rows mean
nothing on the destination and bit-exact resume is impossible in
principle.  The lossy hand-off ships only the request metadata + the
committed token stream (a few hundred bytes instead of the cache blob)
and the destination **re-prefills** prompt + committed output before
decoding on -- token history preserved exactly, device state rebuilt on
the new tier's weights.  Every cross-tier move lands a ``QualityEvent``
(down- or upshift) on the unified audit log next to its
``MigrationRecord``.
"""

from __future__ import annotations

import numpy as np

from repro_torch import compression
from repro_torch.core.channel import AttestedSession
from repro_torch.core.migration import pack_slot, repack_slot, unpack_slot
from repro_torch.core.msgpack_subset import packb, unpack_key, unpackb
from repro_torch.fleet.lifecycle import RequestState
from repro_torch.fleet.telemetry import MigrationRecord
from repro_torch.kernels.ops import check_domain
from repro_torch.serving.engine import request_from_dict, request_to_dict


class ReprefillRefused(ValueError):
    """A lossy hand-off the target cannot re-prefill in one prefill (the
    prefill domain), refused before anything moved."""


def check_reprefill(engine, req, committed):
    """Raise ``ReprefillRefused`` if ``engine`` would refuse to admit
    ``req`` with ``committed`` re-prefilled (``add_request``'s domain
    rule for the engine's model, asked without touching the engine).  A cached full-page prefix
    on the target exempts it: that warm admission forwards the suffix
    through the decode path."""
    stream = np.concatenate([np.asarray(req.prompt, np.int32),
                             np.asarray(committed, np.int32)])
    probe = getattr(engine, "prefix_hit_tokens", None)
    if probe is not None and probe(req.tenant, stream):
        return
    try:
        check_domain(len(stream), cfg=getattr(engine, "cfg", None))
    except ValueError as e:
        raise ReprefillRefused(
            f"{req.rid}: lossy re-prefill of {len(stream)} tokens "
            f"refused: {e}") from None


def room_for(handle, need: int) -> bool:
    """Can ``handle`` take a moved slot that reserves ``need`` tokens
    (prompt + max_new) right now?  The router is asked with the slot's
    remaining decode tokens, which a paged engine's free pages may hold
    while the row's whole reservation does not; the JAX package routes
    on that alone and its ``inject_slot`` then raises (ROADMAP Queue 3)."""
    return handle.engine.admissible(need) and handle.engine.can_admit(need)


def peek_slot_meta(blob: bytes) -> dict:
    """Request metadata of a packed slot without deserializing arrays
    (routing needs sensitivity/remaining-work before a target exists).
    The payload is stepped over, not copied: the control plane peeks
    every parked blob on every dispatch pass."""
    return unpack_key(blob, "meta")["request"]


def peek_slot_header(blob: bytes) -> dict:
    """Full pack_slot meta (request + wire version + page_size + trace)
    without deserializing arrays -- placement needs the wire version to
    decide exact-inject vs lossy re-prefill before touching payload."""
    return unpack_key(blob, "meta")


def wire_compatible(hdr: dict, engine) -> bool:
    """Can a packed blob with header ``hdr`` inject exactly on
    ``engine``?  v1 (dense rows) lands dense-side only, v2 (live pages)
    needs a paged engine at the same page size, v3 (suffix-only)
    additionally needs the target to hold the shared prefix chain the
    blob rides on.  Anything else must re-prefill (lossy by geometry).
    Shared by the in-process balancer and the engine-service inject
    handler, so both transports enforce one placement contract."""
    version = hdr.get("version", 1)
    paged = getattr(engine, "paged", False)
    page_match = paged and engine.page_size == hdr.get("page_size", 0)
    return (version == 1 and not paged) \
        or (version == 2 and page_match) \
        or (version == 3 and page_match
            and getattr(engine, "prefix_cache", None) is not None
            and engine.prefix_cache.has_chain(hdr["prefix"]["chain"]))


def wire_slot(snap, dst_engine, *, link, session=None, aad=b"",
              compression_level=3):
    """The one slot wire hop every mover shares: pack -> compress ->
    (attested) transfer -> decompress -> unpack -> re-layout for the
    target's context budget.  Returns (snapshot ready for
    ``inject_slot``, compressed wire bytes)."""
    wire = compression.compress(pack_slot(snap), level=compression_level)
    if session is not None:
        received = session.transfer(wire, aad=aad)
    else:                            # plain link: public data only
        received = link.send(wire)
    snap2 = unpack_slot(compression.decompress(received),
                        dst_engine.slot_like())
    return repack_slot(snap2, dst_engine.max_len), len(wire)


class Rebalancer:
    def __init__(self, *, sync_every: int = 1,
                 imbalance_threshold: float = 0.5,
                 compression_level: int = 3):
        self.sync_every = sync_every
        self.imbalance_threshold = imbalance_threshold
        self.compression_level = compression_level
        # engine name -> rid -> packed SlotSnapshot at the last sync point
        self.shadow: dict[str, dict[str, bytes]] = {}
        self._step = 0

    # -- shadow checkpoints --------------------------------------------------
    def checkpoint(self, handle):
        store = self.shadow.setdefault(handle.name, {})
        live = set()
        for slot, req in list(handle.engine.requests.items()):
            snap = handle.engine.extract_slot(slot, keep=True)
            store[req.rid] = pack_slot(snap)
            live.add(req.rid)
        for rid in [r for r in store if r not in live]:
            del store[rid]           # completed or migrated away

    def after_step(self, fleet):
        self._step += 1
        if self._step % self.sync_every:
            return
        for handle in fleet.handles.values():
            # tier-paired engines are excluded: a draft slot's output
            # holds uncommitted drafts mid-round (restoring it would
            # serve unverified tokens) and a verify slot is already a
            # replica; their failure path restarts from the prompt
            if handle.healthy and getattr(handle, "spec_role", None) \
                    is None:
                self.checkpoint(handle)

    # -- failure-driven re-placement -----------------------------------------
    def on_failure(self, dead, fleet) -> list[MigrationRecord]:
        """Re-place every in-flight request of a fail-stopped engine from
        its latest shadow checkpoint.  Unplaceable snapshots (no eligible
        capacity right now) go to the fleet's orphan list and are retried
        at every dispatch.  Requests the shadow never covered (failure
        before their first sync) restart from their prompt -- progress is
        lost but at-least-once delivery holds."""
        recs = []
        covered = set()
        # verify-tier engines are reserved replica capacity (a draft
        # engine is fine: its controller plain-decodes foreign slots)
        survivors = [h for h in fleet.handles.values() if h.healthy
                     and getattr(h, "spec_role", None) != "verify"]
        for rid, blob in sorted(self.shadow.pop(dead.name, {}).items()):
            covered.add(rid)
            if rid in fleet.done:
                continue
            fleet.ticket_transition(rid, RequestState.MIGRATING,
                                    reason="failover", engine=dead.name)
            try:
                rec = self.place_blob(
                    blob, survivors, fleet, src=dead.name,
                    reason="failover",
                    src_tier=getattr(dead, "tier", None) and dead.tier.name)
            except ReprefillRefused as e:
                fleet.inflight.pop(rid, None)
                fleet.ticket_transition(rid, RequestState.FAILED,
                                        reason=str(e), engine=dead.name)
                continue
            if rec is None:
                fleet.inflight.pop(rid, None)
                fleet.park_blob(dead.name, blob, origin="failover")
            else:
                recs.append(rec)
        for rid, (req, hname, t0) in list(fleet.inflight.items()):
            if hname != dead.name or rid in covered:
                continue
            req.output, req.done, req.slot = [], False, -1
            del fleet.inflight[rid]
            fleet.requeue_request(req, t0)
        return recs

    def place_blob(self, blob: bytes, handles, fleet, *, src: str,
                   reason: str,
                   deadline_slack: float | None = None,
                   src_tier: str | None = None) \
            -> MigrationRecord | None:
        """Re-place a parked slot snapshot.  A same-tier target restores
        the cache rows bit-exactly (``inject_slot``); a cross-tier
        target cannot use them (distinct weights) and re-prefills the
        committed token stream instead -- the lossy hand-off.  The
        request's ``quality_floor`` bounds how far down the re-placement
        may degrade."""
        hdr = peek_slot_header(blob)
        meta = hdr["request"]
        remaining = meta["max_new_tokens"] - len(meta["output"])
        need = len(meta["prompt"]) + meta["max_new_tokens"]
        dec = fleet.router.route(
            [h for h in handles if room_for(h, need)], fleet.cfg,
            sensitivity=meta["sensitivity"],
            prefill_tokens=0, decode_tokens=remaining,
            deadline_slack=deadline_slack,
            quality_floor=meta.get("quality_floor", 0.0),
            src_tier=src_tier,
            reprefill_tokens=len(meta["prompt"]) + len(meta["output"]),
            # the blob already lives fleet-side (parked queue item or
            # shadow checkpoint): the placement route originates at the
            # control plane, not at the -- possibly dead or unreachable
            # -- donor whose uplink carried it here
            fabric=fleet.fabric, path_src=None)
        if dec.target is None:
            return None
        target = fleet.handles[dec.target]
        tier_change = src_tier and getattr(target, "tier", None) is not None \
            and target.tier.name != src_tier
        # a blob can only inject exactly where its wire format lands:
        # v1 (dense rows) on a dense engine, v2 (live pages) on a paged
        # engine with the same page size -- anything else re-prefills
        # the committed stream (lossy), like a cross-tier move
        wire_ok = wire_compatible(hdr, target.engine)
        if tier_change or not wire_ok:
            req = request_from_dict(meta)
            req.done, req.slot = False, -1
            check_reprefill(target.engine, req, meta["output"])
            placed = target.engine.add_request(req,
                                               committed=meta["output"])
            assert placed, f"router sent {req.rid} to a full engine"
            fleet.reassign(req, target.name)
            if tier_change:
                fleet.record_tier_change(
                    req.rid, src_tier, target.tier.name,
                    reason=f"{reason}: {dec.cause or 'tier change'}",
                    engine=target.name)
                why = f"{reason} (lossy re-prefill on {target.tier.name})"
            else:
                why = f"{reason} (lossy re-prefill: kv geometry)"
            fleet.ticket_transition(req.rid, RequestState.DECODING,
                                    reason=why, engine=target.name)
            return MigrationRecord(rid=req.rid, src=src, dst=target.name,
                                   reason=reason, step=0,
                                   wire_bytes=len(packb(meta)),
                                   lossy=True)
        snap = unpack_slot(blob, target.engine.slot_like())
        snap = repack_slot(snap, target.engine.max_len)
        if fleet.tracer is not None:
            # the blob carried the donor-opened hop span: close that
            # exact span here (the arrival transition below ends it)
            fleet.tracer.bind_hop(snap.trace, dst=target.name)
        req = target.engine.inject_slot(snap)
        fleet.reassign(req, target.name)
        fleet.ticket_transition(req.rid, RequestState.DECODING,
                                reason=reason, engine=target.name)
        return MigrationRecord(rid=req.rid, src=src, dst=target.name,
                               reason=reason, step=snap.step,
                               wire_bytes=len(blob))

    # -- planned live migration ----------------------------------------------
    @staticmethod
    def fits(req, handle) -> bool:
        """Could this request's full decode ever fit the handle's
        context/page budget?  (position + remaining == prompt +
        max_new; occupancy is the router's concern, not fit.)"""
        return handle.engine.admissible(
            len(req.prompt) + req.max_new_tokens)

    @staticmethod
    def same_wire(a, b) -> bool:
        """Can a slot snapshot extracted from ``a`` inject on ``b``?
        Dense rows (v1) travel dense->dense; live pages (v2) travel
        paged->paged at one page size.  Everything else re-prefills."""
        ea, eb = a.engine, b.engine
        if getattr(ea, "paged", False) != getattr(eb, "paged", False):
            return False
        return not getattr(ea, "paged", False) \
            or ea.page_size == eb.page_size

    @staticmethod
    def same_tier(a, b) -> bool:
        """Bit-exact migration is only defined between engines of one
        tier (identical weights); anything else is a lossy hand-off."""
        ta, tb = getattr(a, "tier", None), getattr(b, "tier", None)
        if ta is None or tb is None:
            return True              # untiered fleet: legacy behavior
        return ta.name == tb.name

    def migrate(self, src, dst, slot: int, fleet, *,
                reason: str = "rebalance") -> MigrationRecord:
        """Move one in-flight slot src->dst, picking the right wire:
        bit-exact ``live_migrate`` within a tier and wire geometry,
        ``lossy_migrate`` (re-prefill of the committed stream) across
        tiers or across KV layouts (dense<->paged, page-size change)."""
        if not self.same_tier(src, dst):
            return self.lossy_migrate(src, dst, slot, fleet, reason=reason)
        if not self.same_wire(src, dst):
            # same weights, but the cache state has no common layout:
            # lossy by geometry, not by quality -- no tier change lands
            return self.lossy_migrate(src, dst, slot, fleet,
                                      reason=f"{reason} (kv geometry)",
                                      tier_change=False)
        return self.live_migrate(src, dst, slot, fleet, reason=reason)

    def lossy_migrate(self, src, dst, slot: int, fleet, *,
                      reason: str = "rebalance",
                      tier_change: bool = True) -> MigrationRecord:
        """Cross-tier hand-off: the destination runs *distinct weights*,
        so the donor's cache rows are untranslatable and bit-exactness
        cannot be claimed.  Only the request metadata + committed token
        stream travel (sealed through an ``AttestedSession`` when both
        endpoints attest); the destination re-prefills prompt +
        committed output and decodes on.  Token history is preserved
        exactly; the continuation is the new tier's -- that is the
        availability-for-fidelity trade, and it is audited as a
        ``QualityEvent``."""
        req = src.engine.requests[slot]
        assert self.fits(req, dst), \
            "slot does not fit the target's context budget"
        committed = list(req.output)
        check_reprefill(dst.engine, req, committed)
        src.engine.retire(slot)
        self.shadow.get(src.name, {}).pop(req.rid, None)
        fleet.ticket_transition(req.rid, RequestState.MIGRATING,
                                reason=f"{reason} (lossy)", engine=src.name)
        link = fleet.fabric.link(src.name, dst.name)
        session = None
        if src.attester is not None and dst.attester is not None:
            session = AttestedSession(src.attester, dst.attester, link,
                                      fleet.whitelist)
        wire = compression.compress(packb(request_to_dict(req)),
                                    level=self.compression_level)
        if session is not None:
            received = session.transfer(wire,
                                        aad=fleet.measurement.encode())
        else:
            received = link.send(wire)
        meta = unpackb(compression.decompress(received))
        req2 = request_from_dict(meta)
        req2.done, req2.slot = False, -1
        placed = dst.engine.add_request(req2, committed=committed)
        assert placed, "lossy_migrate needs a free destination slot"
        fleet.reassign(req2, dst.name)
        if tier_change:
            fleet.record_tier_change(
                req2.rid,
                getattr(src, "tier", None) and src.tier.name or "",
                getattr(dst, "tier", None) and dst.tier.name or "",
                reason=reason, engine=dst.name)
        fleet.ticket_transition(
            req2.rid, RequestState.DECODING,
            reason=f"{reason} (lossy re-prefill)", engine=dst.name)
        return MigrationRecord(rid=req2.rid, src=src.name, dst=dst.name,
                               reason=reason, step=0,
                               wire_bytes=len(wire), lossy=True)

    def live_migrate(self, src, dst, slot: int, fleet, *,
                     reason: str = "rebalance") -> MigrationRecord:
        """Move one in-flight slot src->dst through the wire stack.
        Donor and target may have different ``max_len``: the slot's
        cache rows are re-laid-out (``repack_slot``) at restore."""
        assert self.fits(src.engine.requests[slot], dst), \
            "slot does not fit the target's context budget"
        assert self.same_tier(src, dst), \
            "cross-tier moves must use lossy_migrate (distinct weights)"
        assert self.same_wire(src, dst), \
            "dense<->paged / page-size moves must use lossy_migrate"
        # suffix-only wire (v3): if the donor row rides a shared prefix
        # chain the destination also holds, ship only the private
        # suffix pages -- the destination re-references its own copies.
        # When the destination misses the chain, fall back to the full
        # v2 payload *loudly*: the reason lands on the ticket's audit
        # log and the migration record.
        shared = getattr(src.engine, "_shared", {}).get(slot) or []
        suffix_only, bytes_saved = False, 0
        if shared:
            chain = [n.key for n in shared]
            dst_cache = getattr(dst.engine, "prefix_cache", None)
            if dst_cache is not None and dst_cache.has_chain(chain):
                suffix_only = True
                bytes_saved = len(shared) * src.engine.page_bytes
            else:
                reason = f"{reason} (full v2: dst missed prefix chain)"
        snap = (src.engine.extract_slot(slot, suffix_only=True)
                if suffix_only else src.engine.extract_slot(slot))
        if fleet.tracer is not None:
            # hop span opens on the donor and rides the wire format
            snap.trace = fleet.tracer.wire_context(snap.rid, src=src.name)
        self.shadow.get(src.name, {}).pop(snap.rid, None)
        fleet.ticket_transition(snap.rid, RequestState.MIGRATING,
                                reason=reason, engine=src.name)
        link = fleet.fabric.link(src.name, dst.name)
        session = None
        if src.attester is not None and dst.attester is not None:
            session = AttestedSession(src.attester, dst.attester, link,
                                      fleet.whitelist)
        snap2, wire_bytes = wire_slot(
            snap, dst.engine, link=link, session=session,
            aad=fleet.measurement.encode(),
            compression_level=self.compression_level)
        if fleet.tracer is not None:
            fleet.tracer.bind_hop(snap2.trace, dst=dst.name)
        req = dst.engine.inject_slot(snap2)
        fleet.reassign(req, dst.name)
        fleet.ticket_transition(req.rid, RequestState.DECODING,
                                reason=reason, engine=dst.name)
        return MigrationRecord(rid=req.rid, src=src.name, dst=dst.name,
                               reason=reason, step=snap2.step,
                               wire_bytes=wire_bytes,
                               suffix_only=suffix_only,
                               bytes_saved=bytes_saved)

    def drain(self, src, fleet) -> list[MigrationRecord]:
        """Live-migrate every in-flight request off ``src`` (planned
        maintenance / scale-down), routing each slot independently."""
        recs = []
        others = [h for h in fleet.handles.values()
                  if h.healthy and h.name != src.name
                  and getattr(h, "spec_role", None) != "verify"]
        src_tier = getattr(src, "tier", None)
        for slot, req in sorted(src.engine.requests.items()):
            remaining = req.max_new_tokens - len(req.output)
            need = len(req.prompt) + req.max_new_tokens
            dec = fleet.router.route(
                [h for h in others if room_for(h, need)], fleet.cfg,
                sensitivity=req.sensitivity,
                prefill_tokens=0,
                decode_tokens=remaining,
                quality_floor=req.quality_floor,
                src_tier=src_tier.name if src_tier else None,
                reprefill_tokens=len(req.prompt) + len(req.output),
                fabric=fleet.fabric, path_src=src.name)
            if dec.target is None:
                continue             # stays until capacity frees up
            # a refused re-prefill moved nothing: the slot stays
            recs += self._try_migrate(src, fleet.handles[dec.target], slot,
                                      fleet, reason="drain")
        return recs

    def rebalance(self, fleet) -> list[MigrationRecord]:
        """One smoothing move when occupancy spread exceeds the
        threshold: busiest engine sheds its most-remaining request to
        the least-loaded eligible engine.  When loads are already
        smooth, one *upshift* instead: a request serving below the best
        tier it could have (a past downshift) migrates back up as soon
        as the better tier has room -- degradation is a lease, not a
        sentence."""
        healthy = [h for h in fleet.handles.values()
                   if h.healthy and getattr(h, "spec_role", None) is None]
        if len(healthy) < 2:
            return []
        busiest = max(healthy, key=lambda h: h.load)
        # load smoothing never trades quality away: targets are the
        # busiest engine's tier or better (a move DOWN the ladder is
        # dispatch-time degradation's call, and smoothing downward
        # would ping-pong with the upshift pass below) -- an idle
        # lower-tier engine must not mask an idle same-tier peer
        peers = [h for h in healthy if h is not busiest
                 and self._tier_quality(h)
                 >= self._tier_quality(busiest) - 1e-12]
        idlest = min(peers, key=lambda h: h.load) if peers else None
        if idlest is not None \
                and busiest.load - idlest.load >= self.imbalance_threshold \
                and busiest.engine.requests \
                and idlest.engine.free_slots:
            slot, req = max(busiest.engine.requests.items(),
                            key=lambda kv: kv[1].max_new_tokens
                            - len(kv[1].output))
            if fleet.router.eligible(req.sensitivity, idlest) \
                    and idlest.engine.can_admit(
                        len(req.prompt) + req.max_new_tokens):
                return self._try_migrate(busiest, idlest, slot, fleet)
            return []
        return self.upshift(fleet, healthy)

    @staticmethod
    def _tier_quality(handle) -> float:
        tier = getattr(handle, "tier", None)
        return 1.0 if tier is None else tier.quality

    def upshift(self, fleet, healthy) -> list[MigrationRecord]:
        """Move ONE degraded request up to the best reachable tier with
        room (cross-tier, so a lossy re-prefill; emitted as an "up"
        ``QualityEvent``).  The most-degraded request with the most
        remaining work upgrades first -- it has the most quality left
        to gain."""
        best = None
        for h in healthy:
            if not getattr(h, "reachable", True):
                continue
            for slot, req in h.engine.requests.items():
                if req.done:
                    continue
                targets = [
                    t for t in healthy
                    if t is not h and getattr(t, "reachable", True)
                    and self._tier_quality(t) > self._tier_quality(h)
                    and t.engine.can_admit(
                        len(req.prompt) + req.max_new_tokens)
                    and fleet.router.eligible(req.sensitivity, t)]
                if not targets:
                    continue
                target = max(targets, key=self._tier_quality)
                gain = self._tier_quality(target) - self._tier_quality(h)
                remaining = req.max_new_tokens - len(req.output)
                key = (gain, remaining)
                if best is None or key > best[0]:
                    best = (key, h, slot, target)
        if best is None:
            return []
        _, src, slot, dst = best
        return self._try_migrate(src, dst, slot, fleet, reason="upshift")

    def _try_migrate(self, src, dst, slot: int, fleet, **kw) \
            -> list[MigrationRecord]:
        """``migrate`` as a list of records; a refused re-prefill (nothing
        moved) gives none."""
        try:
            return [self.migrate(src, dst, slot, fleet, **kw)]
        except ReprefillRefused:
            return []
