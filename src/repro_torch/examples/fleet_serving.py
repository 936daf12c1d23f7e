"""Scenario: a fleet spanning phone (unattested MCU-class), laptop edge
and cloud pod serves one request stream; the cloud node dies mid-decode
and every conversation continues, bit-identically, on the survivors.

Act two shows the request-lifecycle API: ``submit(RequestSpec)`` returns
a ``RequestTicket`` you can stream (``tokens()``), cancel, or block on
(``result()``); a high-priority arrival preempts the lowest-priority
slot *via the migration machinery* (parked with extract_slot/pack_slot,
resumed bit-identically when capacity frees).  Act three grows and
shrinks an autoscaled pool, act four serves quality tiers (bf16 next to
an int8 round trip of the same weights), act five routes tenants to the
paged engine that holds their cached system prompt.

    PYTHONPATH=src python -m repro_torch.examples.fleet_serving \
        [--device cpu] [--full]

The device profiles are keyword arguments of every act; the defaults are
the port's, whose ``CLOUD`` is one H100.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.attestation import TrustAuthority
from repro_torch.core.channel import NetworkCondition
from repro_torch.core.daemon import CLOUD, EDGE, MCU
from repro_torch.examples import FULL_HELP, check, llama, parser
from repro_torch.fleet import (Autoscaler, EngineHandle, EngineTemplate,
                               FleetController, QualityTier, RequestSpec,
                               RequestState, ScalePolicy)
from repro_torch.optim.compression import int8_round_trip
from repro_torch.serving.engine import Engine
from repro_torch.serving.paged import PagedEngine


def run(cfg, params, *, device, mcu=MCU, edge=EDGE, cloud=CLOUD) -> dict:
    """Act one (failover under the sensitivity policy), then the four
    acts it chains to, as in the JAX example; the figures of each act
    under its own key."""
    mk = lambda s: Engine(cfg, params, slots=3, max_len=64, seed=s,  # noqa
                          device=device)
    fleet = FleetController(
        [EngineHandle("phone", mk(0), mcu),       # no enclave: public only
         EngineHandle("laptop", mk(1), edge),
         EngineHandle("cloud", mk(2), cloud)],
        authority=TrustAuthority())

    rng = np.random.default_rng(7)
    sens = ["public", "personal", "confidential"]
    tickets = [fleet.submit(RequestSpec(
        rid=f"chat{i}", prompt=rng.integers(5, cfg.vocab_size, 6),
        max_new_tokens=14, sensitivity=sens[i % 3]))
        for i in range(8)]

    # everyone is mid-conversation...
    for _ in range(6):
        fleet.step()
    placed = {n: sorted(r.rid for r in h.engine.requests.values())
              for n, h in fleet.handles.items()}
    print("mid-decode placement:", placed)

    # ...when the cloud node disappears
    print("\n-- cloud node lost --")
    fleet.fail("cloud")
    while not all(t.done for t in tickets):
        fleet.step()
    print(f"all {len(tickets)} conversations finished on the survivors")

    for t in sorted(tickets, key=lambda t: t.rid):
        print(f"  {t.rid}[{t.spec.sensitivity:12s}] "
              f"via {'->'.join(fleet.placements[t.rid])}")
    tel = fleet.telemetry.summary()
    print("\nfleet telemetry:", tel["fleet"])
    check(all("phone" not in fleet.placements[t.rid]
              for t in tickets if t.spec.sensitivity != "public"),
          "sensitive work touched the phone")
    print("policy held: nothing sensitive ever touched the phone")
    got = {"failover": dict(
        placed=placed, placements={t.rid: fleet.placements[t.rid]
                                   for t in tickets},
        outputs={t.rid: t.result() for t in tickets},
        telemetry=tel["fleet"])}
    got.update(lifecycle_act(cfg, params, device=device, edge=edge,
                             cloud=cloud))
    return got


def lifecycle_act(cfg, params, *, device, edge=EDGE, cloud=CLOUD) -> dict:
    """Tickets, priorities, preemption-by-migration, cancellation."""
    print("\n-- act two: the request-lifecycle API --")
    rng = np.random.default_rng(11)
    fleet = FleetController(
        [EngineHandle("laptop",
                      Engine(cfg, params, slots=1, max_len=64, seed=4,
                             device=device),
                      edge)],
        authority=TrustAuthority())

    batch = fleet.submit(RequestSpec(
        rid="batch-job", prompt=rng.integers(5, cfg.vocab_size, 6),
        max_new_tokens=20, priority=0))
    for _ in range(4):
        fleet.step()                  # the batch job is mid-decode...
    print(f"batch-job: {batch.state.value}, "
          f"{len(batch.tokens())} tokens streamed so far")

    # ...when an interactive request arrives at higher priority: the
    # batch slot is parked (extract_slot -> pack_slot, the migration
    # departure path) and the interactive one takes the engine
    chat = fleet.submit(RequestSpec(
        rid="chat", prompt=rng.integers(5, cfg.vocab_size, 5),
        max_new_tokens=8, priority=10))
    fleet.step()
    check(batch.state is RequestState.MIGRATING,   # parked off-engine
          f"batch-job is {batch.state.value}, not parked")
    print(f"chat arrived at priority 10: batch-job is "
          f"{batch.state.value} (parked), chat is {chat.state.value}")
    chat_out = chat.result()
    print(f"chat result: {chat_out}")

    # the parked slot resumes bit-identically and finishes
    out = batch.result()
    states = [ev.dst for ev in batch.events]
    print(f"batch-job resumed and finished: {len(out)} tokens, "
          f"states {states}")

    # cancellation frees a slot immediately
    doomed = fleet.submit(RequestSpec(
        rid="doomed", prompt=rng.integers(5, cfg.vocab_size, 4),
        max_new_tokens=30))
    fleet.step()
    doomed.cancel()
    free = fleet.handles['laptop'].engine.free_slots == [0]
    print(f"doomed: {doomed.state.value}; engine free again: {free}")
    tel = fleet.telemetry.summary()["lifecycle"]
    print("lifecycle telemetry:", tel)
    got = {"lifecycle": dict(chat=chat_out, batch=out,
                             states=[str(s) for s in states],
                             doomed=doomed.state.value, free=free,
                             telemetry=tel)}
    got.update(autoscale_act(cfg, params, device=device, edge=edge,
                             cloud=cloud))
    return got


def autoscale_act(cfg, params, *, device, edge=EDGE, cloud=CLOUD) -> dict:
    """Elastic pool: a burst grows the fleet, idleness shrinks it --
    and scale-down drains via the migration path, never dropping work.
    Spawned engines come up on the device of the weights they run."""
    print("\n-- act three: elastic autoscaling --")
    rng = np.random.default_rng(23)
    fleet = FleetController(
        [EngineHandle("seed",
                      Engine(cfg, params, slots=2, max_len=64, seed=30,
                             device=device),
                      edge)],
        authority=TrustAuthority(),
        autoscaler=Autoscaler(
            EngineTemplate(name="burst", profile=edge, slots=2,
                           max_len=64, seed=40),
            ScalePolicy(min_engines=1, max_engines=3,
                        scale_up_queue_depth=3, scale_down_util=0.3)))

    # burst arrival: eight requests hit a one-engine, two-slot pool
    burst = [fleet.submit(RequestSpec(
        rid=f"burst{i}", prompt=rng.integers(5, cfg.vocab_size, 6),
        max_new_tokens=10)) for i in range(8)]
    while not all(t.done for t in burst):
        fleet.step()
    grown = [ev for ev in fleet.telemetry.scale_events()
             if ev.action == "spawn"]
    print(f"burst of {len(burst)} served; pool grew by {len(grown)}:")
    for ev in grown:
        print(f"  spawn {ev.engine} (pool {ev.engines}): {ev.reason}")

    # idle: the pool drains back down to min_engines, each retired
    # engine leaving through drain() -- migration, not deletion
    while fleet.autoscaler.spawned:
        fleet.step()
    retired = [ev for ev in fleet.telemetry.scale_events()
               if ev.action == "retire"]
    print(f"idle again: pool shrank to {sorted(fleet.handles)} "
          f"({len(retired)} retires, all drained via migration)")
    placements = {t.rid: "->".join(fleet.placements[t.rid])
                  for t in burst}
    moved = {r: p for r, p in placements.items() if "->" in p}
    print(f"requests that rode a scale event: {moved or 'none'}")
    scaling = {k: v for k, v in
               fleet.telemetry.summary()["lifecycle"].items()
               if k.startswith("scale")}
    print("scaling telemetry:", scaling)
    got = {"autoscale": dict(
        spawns=[(ev.engine, ev.engines, ev.reason) for ev in grown],
        retires=len(retired), pool=sorted(fleet.handles),
        placements=placements, outputs={t.rid: t.result() for t in burst},
        telemetry=scaling)}
    got.update(quality_act(cfg, params, device=device, edge=edge,
                           cloud=cloud))
    return got


def quality_act(cfg, params, *, device, edge=EDGE, cloud=CLOUD) -> dict:
    """Quality tiers: a full-bf16 tier next to an int8 tier.  The full
    tier saturates, then loses its client link entirely -- and service
    stays up on the lite tier, every downshift a typed QualityEvent,
    floored requests waiting rather than degrading below contract.  The
    lite tier's weights are ``optim.compression.int8_round_trip`` of the
    full tier's: a second copy of the weights."""
    print("\n-- act four: request-granular quality tiers --")
    FULL = QualityTier("full", 1.0, "bf16")
    LITE = QualityTier("lite", 0.6, "int8")
    fleet = FleetController(
        [EngineHandle("pod",
                      Engine(cfg, params, slots=1, max_len=64, seed=50,
                             device=device),
                      cloud, tier=FULL),
         EngineHandle("edge-box",
                      Engine(cfg, int8_round_trip(params), slots=3,
                             max_len=64, seed=51, device=device),
                      edge, tier=LITE)],
        authority=TrustAuthority())

    rng = np.random.default_rng(31)
    mk = lambda rid, floor: fleet.submit(RequestSpec(  # noqa: E731
        rid=rid, prompt=rng.integers(5, cfg.vocab_size, 6),
        max_new_tokens=10, quality_floor=floor))
    flexible = [mk(f"flex{i}", 0.0) for i in range(3)]
    strict = mk("strict", 0.9)        # full tier or nothing

    while not all(t.done for t in flexible + [strict]):
        fleet.step()
    tiers_of = {t.rid: fleet.handles[fleet.placements[t.rid][-1]].tier.name
                for t in flexible + [strict]}
    print("placement tiers:", tiers_of)
    check(tiers_of["strict"] == "full", "floored work never degrades")
    shifts = []
    for ev in fleet.telemetry.quality_events():
        shifts.append((ev.direction, ev.rid, ev.src_tier, ev.dst_tier,
                       ev.reason))
        print(f"  {ev.direction}shift {ev.rid} {ev.src_tier}->"
              f"{ev.dst_tier}: {ev.reason}")

    # the full tier's uplink dies: traffic continues on the lite tier
    print("-- full tier link down --")
    fleet.set_link("pod", NetworkCondition(up=False))
    survivors = [fleet.submit(RequestSpec(
        rid=f"cut{i}", prompt=rng.integers(5, cfg.vocab_size, 6),
        max_new_tokens=8)) for i in range(2)]
    while not all(t.done for t in survivors):
        fleet.step()
    cut = {}
    for t in survivors:
        eng = fleet.placements[t.rid][-1]
        cut[t.rid] = eng
        print(f"  {t.rid}: served on {eng} "
              f"(tier {fleet.handles[eng].tier.name}) despite the cut")
        check(fleet.handles[eng].tier.name == "lite",
              f"{t.rid} served on tier {fleet.handles[eng].tier.name}")
    downs = fleet.telemetry.downshifts
    print(f"service never dropped a request; {downs} audited downshifts")
    got = {"quality": dict(
        tiers=tiers_of, shifts=shifts, cut=cut, downshifts=downs,
        outputs={t.rid: t.result() for t in flexible + [strict]
                 + survivors})}
    got.update(prefix_act(cfg, params, device=device, edge=edge,
                          cloud=cloud))
    return got


def prefix_act(cfg, params, *, device, edge=EDGE, cloud=CLOUD) -> dict:
    """Warm-session routing: two tenants chat against paged engines
    with the prefix cache armed.  Each tenant's first request prefills
    its system prompt cold and donates the pages; follow-ups route to
    the engine already holding them (session affinity) and prefill only
    the fresh tail -- the router's capacity gate even discounts the
    shared pages."""
    print("\n-- act five: prefix caching & warm-session routing --")
    mk = lambda s: PagedEngine(cfg, params, rows=2, page_size=8,  # noqa
                               max_len=64, seed=s, prefix_cache=True,
                               device=device)
    fleet = FleetController(
        [EngineHandle("left", mk(60), edge),
         EngineHandle("right", mk(61), edge)],
        authority=TrustAuthority())

    rng = np.random.default_rng(41)
    system = {t: rng.integers(5, cfg.vocab_size, 16) for t in ("ada", "bob")}
    chat = lambda t, i: fleet.submit(RequestSpec(  # noqa: E731
        rid=f"{t}{i}", tenant=t,
        prompt=np.concatenate([system[t],
                               rng.integers(5, cfg.vocab_size, 4)]),
        max_new_tokens=6))

    # round one: each tenant's opener is a cold prefill somewhere
    openers = [chat("ada", 0), chat("bob", 0)]
    while not all(t.done for t in openers):
        fleet.step()
    homes = {t.rid[:3]: fleet.placements[t.rid][-1] for t in openers}
    print("cold openers placed:", homes)

    # round two: follow-ups reuse each tenant's cached system prompt
    follow = [chat("ada", 1), chat("bob", 1)]
    while not all(t.done for t in follow):
        fleet.step()
    routed = {}
    for t in follow:
        eng = fleet.placements[t.rid][-1]
        routed[t.rid] = eng
        print(f"  {t.rid}: routed to {eng} "
              f"(tenant home {homes[t.rid[:3]]})")
        check(eng == homes[t.rid[:3]],
              "affinity should pick the warm engine")
    p = fleet.telemetry.summary()["prefix"]
    print(f"prefix cache: {p['hits']} hits / {p['misses']} misses "
          f"(hit rate {p['hit_rate']:.0%}), {p['bytes_saved']} KV bytes "
          f"never recomputed")
    check(p["hits"] >= 2, "both follow-ups should hit")
    for h in fleet.handles.values():
        h.engine.check()              # shared-page refcounts audit clean
    print("allocator + refcount audits clean on both engines")
    return {"prefix": dict(homes=homes, routed=routed, stats=p,
                           outputs={t.rid: t.result()
                                    for t in openers + follow})}


def main(argv=None) -> int:
    args = parser("fleet_serving", __doc__,
                  full_help=FULL_HELP).parse_args(argv)
    cfg, params, device = llama(args)
    run(cfg, params, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
