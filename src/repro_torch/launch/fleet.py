"""Fleet serving driver: N heterogeneous engines behind one queue.

    PYTHONPATH=src python -m repro_torch.launch.fleet \
        --arch llama-1.5b --tiny --requests 12 --max-new 16 \
        --engines edge:edge,cloud:cloud,mcu:mcu --fail cloud@5

Quality tiers (cross-model fleet with graceful degradation): a full
bf16 tier next to an int8 tier; saturate the full tier or cut its link
and watch requests downshift (typed QualityEvents), never below their
quality floor:

    PYTHONPATH=src python -m repro_torch.launch.fleet --tiny --requests 8 \
        --tiers full:1.0:bf16,lite:0.6:int8 \
        --engines big:cloud:128:full,small:edge:128:lite \
        --slots 2 --quality-floor 0,0.8

(add --link-down big@4 to cut the full tier's client link mid-run:
floor-0 traffic downshifts to the lite tier, floored work waits)

Speculative tier hand-off (draft on edge, verify on cloud):

    PYTHONPATH=src python -m repro_torch.launch.fleet --tiny --requests 8 \
        --engines edge:edge:96,cloud:cloud:256,mcu:mcu \
        --spec-tiers edge:cloud --drafter-temperature 0.8

Priorities + preemption-by-migration (lifecycle API): one engine, a
mixed-priority stream -- watch low-priority slots get parked
(extract_slot/pack_slot) and resume when the high-priority work clears:

    PYTHONPATH=src python -m repro_torch.launch.fleet --tiny --requests 6 \
        --engines edge:edge --slots 2 --priorities 0,5,10 \
        --queue-limit 1 --deadline-s 60

Elastic autoscaling: a one-engine fleet grows under the burst (watch
the spawn ScaleEvents), then drains the spawned engines -- every live
slot migrating or parking via the migration path -- once idle:

    PYTHONPATH=src python -m repro_torch.launch.fleet --tiny --requests 12 \
        --engines edge:edge --slots 2 --autoscale 1:3 \
        --scale-up-queue-depth 3 --scale-cooldown-s 0

Service mode (the control-plane/engine-service split): each engine
decodes on its own thread behind a mailbox, messages ride loopback TCP
(length-prefixed msgpack frames).  The port's step holds the GIL while
it launches, so the engines' threads overlap only where one waits:

    PYTHONPATH=src python -m repro_torch.launch.fleet --tiny --requests 12 \
        --engines a:edge,b:edge,c:edge --transport socket

Runs on the card (``--device cuda``, the default); ``--device cpu`` runs
the kernels' plain versions.  The weights are the port's ``init_params``
from ``--seed``, so the tokens differ from the JAX package's
``repro.launch.fleet``.

Flags
  --arch NAME            model config (default llama-1.5b; --help lists
                         the port's configs)
  --tiny                 shrink the config (CPU-friendly smoke scale)
  --device DEV           torch device (default cuda)
  --engines SPEC         comma list of name:profile[:max_len][:tier]
                         replicas, where profile is edge | cloud | mcu
                         (mcu is the unattested endpoint -- the router
                         will keep personal/confidential work off it);
                         max_len overrides --max-len per engine
                         (heterogeneous context budgets migrate via
                         repack_slot); tier names a --tiers entry
  --tiers SPEC           comma list of name:quality[:kind] quality
                         tiers (kind: bf16 = fleet weights, int8 =
                         quantize/dequantize the fleet weights, small =
                         a narrower model with fresh weights).  Engines
                         of different tiers run distinct weights, so
                         cross-tier moves re-prefill the committed
                         stream (lossy) instead of shipping cache rows
  --quality-floor LIST   comma list of floors in [0,1] cycled across
                         the synthetic requests: a request is never
                         served below its floor (it queues instead)
  --link-down NAME@STEP  cut engine NAME's client link at fleet step
                         STEP: the router degrades its traffic to
                         reachable tiers (QualityEvents on the log)
  --slots N              request slots per engine (default 4)
  --max-len N            per-slot context budget (default 128)
  --requests N           synthetic mixed-sensitivity request count
  --max-new N            tokens generated per request (default 16)
  --temperature F        sampling temperature for odd-numbered requests
                         (even ones stay greedy: mixed-policy batches)
  --priorities LIST      comma list of ints cycled across the synthetic
                         requests (e.g. 0,5,10); a higher-priority
                         arrival preempts the lowest-priority in-flight
                         slot via the migration machinery when no slot
                         is free
  --deadline-s F         relative deadline per request (seconds on the
                         fleet clock); queued or parked work past it
                         expires instead of occupying capacity
  --queue-limit N        admission-control bound (backpressure beyond it)
  --autoscale MIN:MAX    arm the autoscaler: keep between MIN and MAX
                         routable engines, spawning from a template
                         (profile --autoscale-profile, geometry
                         --slots/--max-len) under queue/deadline
                         pressure and retiring spawned engines once
                         idle -- scale-down drains every slot via the
                         migration path before the handle disappears
  --autoscale-profile P  device profile for spawned engines (default
                         edge; attested, so spawned capacity can take
                         sensitive work)
  --scale-up-queue-depth N  pending work (fresh + parked) that triggers
                         a spawn (default 4; 0 disables the signal)
  --scale-up-wait-p95 F  recent queue-wait p95 (seconds) that triggers
                         a spawn (default: off)
  --scale-cooldown-s F   minimum fleet-clock seconds between scale
                         events (default 0)
  --aging-rate F         priority points gained per second of queue
                         wait, so starved low-priority work eventually
                         dispatches (default 0 = strict priority)
  --transport MODE       sim (default): the synchronous fleet loop on
                         the deterministic in-process fabric -- every
                         contract (bit-exactness, conservation, spec
                         pairs, autoscaling, preemption) holds here.
                         socket: service mode -- a ControlPlane plus
                         one EngineService thread per engine, messages
                         over loopback TCP; requests stream
                         concurrently and failures are detected by
                         heartbeat.  Step-indexed chaos flags (--fail /
                         --drain / --link-down), --spec-tiers and
                         --autoscale are sim-only
  --sync-every N         shadow-checkpoint cadence in fleet steps
  --rebalance-every N    load-smoothing cadence (0 = off, default)
  --fail NAME@STEP       fail-stop engine NAME before fleet step STEP;
                         its in-flight requests are re-placed from
                         shadow checkpoints and resume on survivors
  --drain NAME@STEP      live-migrate everything off NAME at step STEP
  --spec-tiers SPEC      comma list of draft:verify engine pairs; each
                         pair drafts greedily-served requests on the
                         draft engine and teacher-force verifies them on
                         the verify engine via a one-time slot hand-off
  --spec-gamma N         draft tokens per verify round (default 4)
  --drafter-temperature F  draft-tier sampling temperature (committed
                         output stays the target's greedy choice)
  --drafter-top-k N      draft-tier top-k (default 0 = full vocab)
  --verify-mode MODE     stepwise (bit-exact, default) | wide (one
                         multi-query pass; not on rwkv6-7b or jamba,
                         whose recurrent mixers step one token at a
                         time) | distribution (standard
                         speculative-sampling accept/reject: required
                         when draft and verify engines are different
                         quality tiers; see fleet.speculative docs)
  --seed N               rng seed for prompts and engines
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

PROFILES = {"edge": "EDGE", "cloud": "CLOUD", "mcu": "MCU"}


def parse_event(spec: str | None) -> tuple[str, int] | None:
    if not spec:
        return None
    name, step = spec.rsplit("@", 1)
    return name, int(step)


def parse_tiers(spec: str | None) -> dict[str, str]:
    if not spec:
        return {}
    pairs = {}
    for item in spec.split(","):
        draft, _, verify = item.partition(":")
        pairs[draft] = verify
    return pairs


def parse_quality_tiers(spec: str | None):
    """--tiers full:1.0:bf16,lite:0.6:int8 -> {name: QualityTier}."""
    from repro_torch.core.replication import QualityTier
    tiers = {}
    for item in (spec or "").split(","):
        if not item:
            continue
        parts = item.split(":")
        name = parts[0]
        quality = float(parts[1]) if len(parts) > 1 else 1.0
        kind = parts[2] if len(parts) > 2 else "bf16"
        if kind not in ("bf16", "int8", "small"):
            raise ValueError(f"tier {name!r}: kind {kind!r} is not one of "
                             "bf16, int8, small")
        tiers[name] = QualityTier(name, quality, kind)
    return tiers


def tier_model(cfg, params, tier, seed: int, device):
    """The (cfg, params) a tier's engines run: the fleet weights
    (bf16), an int8 round trip of them, or a narrower model with its
    own fresh weights (same tokenizer)."""
    from repro_torch.launch.common import weights
    from repro_torch.optim.compression import int8_round_trip
    if tier.kind == "int8":
        return cfg, int8_round_trip(params)
    if tier.kind == "small":
        small = cfg.replace(name=cfg.name + f"-{tier.name}",
                            blocks=cfg.blocks[:max(len(cfg.blocks) // 2,
                                                   1)])
        return small, weights(small, seed, device)
    return cfg, params


def main(argv=None) -> int:
    from repro_torch.launch.common import add_common, setup, weights

    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.fleet",
        description="serve a request stream over a heterogeneous fleet")
    add_common(ap)
    ap.add_argument("--engines", default="edge:edge,cloud:cloud,mcu:mcu")
    ap.add_argument("--tiers", default=None, metavar="NAME:Q[:KIND]")
    ap.add_argument("--quality-floor", default="0", metavar="LIST")
    ap.add_argument("--link-down", default=None, metavar="NAME@STEP")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--priorities", default="0", metavar="LIST")
    ap.add_argument("--deadline-s", type=float, default=None)
    ap.add_argument("--queue-limit", type=int, default=32)
    ap.add_argument("--autoscale", default=None, metavar="MIN:MAX")
    ap.add_argument("--autoscale-profile", default="edge",
                    choices=sorted(PROFILES))
    ap.add_argument("--scale-up-queue-depth", type=int, default=4)
    ap.add_argument("--scale-up-wait-p95", type=float, default=None)
    ap.add_argument("--scale-cooldown-s", type=float, default=0.0)
    ap.add_argument("--warm-pool", type=int, default=0, metavar="N",
                    help="hold N pre-built, attested, program-warmed "
                         "standby engines outside the routable set; "
                         "scale-up promotes one in milliseconds instead "
                         "of constructing inline (needs --autoscale)")
    ap.add_argument("--prearm-horizon", type=float, default=0.0,
                    metavar="SECONDS",
                    help="fill the warm pool only when the queue-trend "
                         "forecast projects the scale-up depth trigger "
                         "within this horizon (0 = keep it topped up)")
    ap.add_argument("--aging-rate", type=float, default=0.0)
    ap.add_argument("--transport", default="sim",
                    choices=["sim", "socket"])
    ap.add_argument("--sync-every", type=int, default=1)
    ap.add_argument("--rebalance-every", type=int, default=0)
    ap.add_argument("--fail", default=None, metavar="NAME@STEP")
    ap.add_argument("--drain", default=None, metavar="NAME@STEP")
    ap.add_argument("--spec-tiers", default=None, metavar="DRAFT:VERIFY")
    ap.add_argument("--spec-gamma", type=int, default=4)
    ap.add_argument("--drafter-temperature", type=float, default=0.0)
    ap.add_argument("--drafter-top-k", type=int, default=0)
    ap.add_argument("--verify-mode", default="stepwise",
                    choices=["stepwise", "wide", "distribution"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefix-cache", action="store_true",
                    help="spawn paged engines with the content-"
                         "addressed prefix cache armed (shared KV "
                         "pages, COW forks, session-affine routing)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV page size for --prefix-cache engines")
    ap.add_argument("--tenants", type=int, default=0, metavar="N",
                    help="cycle requests over N tenants, each reusing "
                         "its own system-prompt prefix (exercises "
                         "warm-session routing; needs --prefix-cache)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the run's Chrome trace-event JSON here "
                         "(open in Perfetto / chrome://tracing)")
    ap.add_argument("--otlp-out", default=None, metavar="PATH",
                    help="write the run's spans as an OTLP-JSON "
                         "ExportTraceServiceRequest here (feed to any "
                         "OpenTelemetry collector/backend)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a Prometheus text exposition of the "
                         "fleet metrics registry here")
    args = ap.parse_args(argv)
    cfg, dev = setup(ap, args)
    recurrent = cfg.recurrent_mixers
    if args.spec_tiers and args.verify_mode == "wide" and recurrent:
        ap.error(f"--verify-mode wide cannot verify {cfg.name}: its "
                 f"{'/'.join(sorted(recurrent))} mixers step one token at "
                 "a time, so a draft window cannot be scored in one pass; "
                 "use stepwise or distribution")

    import numpy as np

    from repro_torch.core import daemon
    from repro_torch.core.attestation import TrustAuthority
    from repro_torch.fleet import (Autoscaler, EngineHandle, EngineTemplate,
                                   FleetController, Rebalancer, RequestSpec,
                                   ScalePolicy)
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.paged import PagedEngine

    params = weights(cfg, args.seed, dev)

    try:
        quality_tiers = parse_quality_tiers(args.tiers)
    except ValueError as e:
        ap.error(f"--tiers: {e}")
    tier_models = {}                  # tier name -> (cfg, params)
    for i, (tname, qt) in enumerate(quality_tiers.items()):
        tier_models[tname] = tier_model(cfg, params, qt,
                                        args.seed + 1000 + i, dev)

    handles = []
    for i, spec in enumerate(args.engines.split(",")):
        parts = spec.split(":")
        name, prof = parts[0], parts[1] if len(parts) > 1 else ""
        if prof not in PROFILES:
            ap.error(f"unknown profile {prof!r} in --engines {spec!r} "
                     f"(choose from {sorted(PROFILES)})")
        profile = getattr(daemon, PROFILES[prof])
        max_len = int(parts[2]) if len(parts) > 2 and parts[2] \
            else args.max_len
        kw = {}
        ecfg, eparams = cfg, params
        if len(parts) > 3:
            if parts[3] not in quality_tiers:
                ap.error(f"--engines {spec!r} names tier {parts[3]!r} "
                         f"missing from --tiers")
            kw["tier"] = quality_tiers[parts[3]]
            ecfg, eparams = tier_models[parts[3]]
        if args.prefix_cache:
            if max_len % args.page_size:
                ap.error(f"--engines {spec!r}: max_len {max_len} not a "
                         f"multiple of --page-size {args.page_size}")
            eng = PagedEngine(ecfg, eparams, rows=args.slots,
                              page_size=args.page_size, max_len=max_len,
                              seed=args.seed + i, prefix_cache=True,
                              device=dev)
        else:
            eng = Engine(ecfg, eparams, slots=args.slots, max_len=max_len,
                         seed=args.seed + i, device=dev)
        handles.append(EngineHandle(name, eng, profile, **kw))
    spec_tiers = parse_tiers(args.spec_tiers)
    for dname, vname in spec_tiers.items():
        if dname not in {h.name for h in handles} or \
                vname not in {h.name for h in handles}:
            ap.error(f"--spec-tiers pair {dname}:{vname} names an "
                     "engine missing from --engines")
    autoscaler = None
    if args.autoscale:
        lo, _, hi = args.autoscale.partition(":")
        autoscaler = Autoscaler(
            EngineTemplate(name="auto",
                           profile=getattr(
                               daemon, PROFILES[args.autoscale_profile]),
                           slots=args.slots, max_len=args.max_len,
                           seed=args.seed + 100,
                           page_size=args.page_size
                           if args.prefix_cache else 0,
                           prefix_cache=args.prefix_cache),
            ScalePolicy(min_engines=int(lo), max_engines=int(hi or lo),
                        scale_up_queue_depth=args.scale_up_queue_depth,
                        scale_up_wait_p95=args.scale_up_wait_p95,
                        cooldown_s=args.scale_cooldown_s,
                        standby_pool=args.warm_pool,
                        prearm_horizon_s=args.prearm_horizon))
    fleet = FleetController(
        handles, authority=TrustAuthority(),
        balancer=Rebalancer(sync_every=args.sync_every),
        queue_limit=args.queue_limit,
        rebalance_every=args.rebalance_every,
        autoscaler=autoscaler,
        aging_rate=args.aging_rate,
        spec_tiers=spec_tiers,
        spec_options={"gamma": args.spec_gamma,
                      "drafter_temperature": args.drafter_temperature,
                      "drafter_top_k": args.drafter_top_k,
                      "verify_mode": args.verify_mode})

    rng = np.random.default_rng(args.seed)
    sens = ["public", "personal", "confidential"]
    prios = [int(p) for p in args.priorities.split(",")]
    floors = [float(f) for f in args.quality_floor.split(",")]
    # multi-tenant traffic: each tenant reuses its own "system prompt"
    # (2 pages of tokens) ahead of a per-request tail, so later requests
    # of a tenant hit the prefix pages its first request cached
    bases = {}
    if args.tenants:
        for t in range(args.tenants):
            bases[f"t{t}"] = rng.integers(5, cfg.vocab_size,
                                          2 * args.page_size)
    pending = []
    for i in range(args.requests):
        tenant = f"t{i % args.tenants}" if args.tenants else ""
        tail = rng.integers(5, cfg.vocab_size, 8)
        prompt = np.concatenate([bases[tenant], tail]) if tenant else tail
        pending.append(
            RequestSpec(rid=f"r{i}", prompt=prompt,
                        max_new_tokens=args.max_new,
                        temperature=args.temperature if i % 2 else 0.0,
                        top_k=16 if i % 2 else 0,
                        sensitivity=sens[i % 3],
                        priority=prios[i % len(prios)],
                        quality_floor=floors[i % len(floors)],
                        tenant=tenant))

    if args.transport == "socket":
        if spec_tiers or autoscaler is not None or args.fail \
                or args.drain or args.link_down:
            ap.error("--transport socket serves plain engines only: "
                     "--spec-tiers/--autoscale and the step-indexed "
                     "chaos flags (--fail/--drain/--link-down) are "
                     "sim-only (see the README transport matrix)")
        from repro_torch.core.channel import SocketTransport
        from repro_torch.fleet import ControlPlane
        cp = ControlPlane(fleet, transport=SocketTransport(),
                          sync_every=max(args.sync_every, 1))
        cp.start(threads=True)
        t0 = time.perf_counter()
        cp.serve(pending, timeout_s=600.0)
        wall = time.perf_counter() - t0
        cp.stop()
        for rid in sorted(fleet.tickets):
            t = fleet.tickets[rid]
            route = "->".join(fleet.placements.get(rid, [])) or "-"
            out = t.output
            print(f"{rid}[{t.spec.sensitivity:12s} p{t.spec.priority:<3d} "
                  f"{t.state.value:9s}] via {route}: "
                  f"{out[:8]}{'...' if len(out) > 8 else ''}")
        summ = fleet.telemetry.summary()
        toks = sum(len(t.output) for t in fleet.tickets.values())
        print(json.dumps(summ, indent=1))
        print(f"service mode: {len(fleet.tickets)} requests, "
              f"{toks} tokens in {wall:.2f}s wall "
              f"({toks / max(wall, 1e-9):.1f} tok/s aggregate, "
              f"{fleet.telemetry.heartbeat_losses} heartbeat losses)")
        if args.trace_out and fleet.tracer is not None:
            fleet.tracer.close_open(reason="run complete")
            fleet.tracer.export_chrome(args.trace_out)
            print(f"trace: {args.trace_out}")
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                f.write(fleet.telemetry.prometheus_text())
            print(f"metrics: {args.metrics_out}")
        return 0

    fail = parse_event(args.fail)
    drain = parse_event(args.drain)
    link_down = parse_event(args.link_down)
    tickets = {}
    step = 0
    while pending or fleet.queue or fleet.orphans or fleet.inflight:
        while pending:
            spec = pending[0]
            if args.deadline_s is not None:
                # relative per request: anchor at actual submission,
                # not at driver startup (backpressure must not shrink
                # the window)
                spec = dataclasses.replace(
                    spec, deadline=fleet.clock() + args.deadline_s)
            t = fleet.submit(spec)
            if t is None:
                break                # queue full: back off a step
            tickets[t.rid] = t
            pending.pop(0)
        if fail and step == fail[1]:
            print(f"-- failing {fail[0]} at step {step} --")
            fleet.fail(fail[0])
        if drain and step == drain[1]:
            print(f"-- draining {drain[0]} at step {step} --")
            fleet.drain(drain[0])
        if link_down and step == link_down[1]:
            from repro_torch.core.channel import NetworkCondition
            print(f"-- link to {link_down[0]} down at step {step} --")
            fleet.set_link(link_down[0], NetworkCondition(up=False))
        qlen, orph = len(fleet.queue), len(fleet.orphans)
        fleet.step()
        step += 1
        if fleet.is_stalled(qlen, orph):
            fleet._dispatch()        # slots may have freed this step
            if not fleet.is_stalled(qlen, orph):
                continue
            # stalled: backlog no surviving engine is eligible to take
            for req, _ in fleet.queue:
                dec = fleet.router.route(
                    list(fleet.handles.values()), cfg,
                    sensitivity=req.sensitivity,
                    prefill_tokens=len(req.prompt),
                    decode_tokens=req.max_new_tokens,
                    quality_floor=req.quality_floor)
                print(f"STALLED {req.rid}[{req.sensitivity}]: {dec.reason}")
            from repro_torch.fleet import peek_slot_meta
            for src, blob in fleet.orphans:
                meta = peek_slot_meta(blob)
                print(f"STALLED {meta['rid']}[{meta['sensitivity']}]: "
                      f"orphaned snapshot from {src}, no eligible engine")
            raise SystemExit(1)

    for rid in sorted(tickets):
        t = tickets[rid]
        route = "->".join(fleet.placements.get(rid, [])) or "-"
        out = t.output
        print(f"{rid}[{t.spec.sensitivity:12s} p{t.spec.priority:<3d} "
              f"{t.state.value:9s}] via {route}: "
              f"{out[:8]}{'...' if len(out) > 8 else ''}")
    if autoscaler is not None:
        # idle ticks let the autoscaler drain + retire what it spawned
        for _ in range(16):
            if not autoscaler.spawned:
                break
            fleet.step()
    preempted = [ev for ev in fleet.telemetry.events
                 if getattr(ev, "dst", None) == "migrating"
                 and "preempted" in ev.reason]
    for ev in preempted:
        print(f"preempted {ev.rid} on {ev.engine}: {ev.reason}")
    for ev in fleet.telemetry.scale_events():
        print(f"scale {ev.action} {ev.engine} at t={ev.t:.3f} "
              f"(pool {ev.engines}): {ev.reason}")
    for ev in fleet.telemetry.quality_events():
        print(f"quality {ev.direction}shift {ev.rid} "
              f"{ev.src_tier}->{ev.dst_tier} (q={ev.quality:.2f}): "
              f"{ev.reason}")
    print(json.dumps(fleet.telemetry.summary(), indent=1))
    for dname, spec in fleet.spec_controllers.items():
        print(f"speculative tier {dname}->{spec.verify.name}: "
              f"{json.dumps(spec.stats.summary())}")
    print(f"simulated wire time: {fleet.fabric.clock():.3f}s "
          f"({len(fleet.telemetry.migrations)} live migrations)")
    if args.prefix_cache:
        p = fleet.telemetry.summary()["prefix"]
        print(f"prefix cache: {p['hits']} hits / {p['misses']} misses "
              f"(hit rate {p['hit_rate']:.0%}), "
              f"{p['bytes_saved']} KV bytes saved, "
              f"{p['evictions']} evictions")
    if args.trace_out and fleet.tracer is not None:
        fleet.tracer.close_open(reason="run complete")
        fleet.tracer.export_chrome(args.trace_out)
        print(f"trace: {args.trace_out} ({len(fleet.tracer.spans)} spans"
              f" -- open in Perfetto / chrome://tracing)")
    if args.otlp_out and fleet.tracer is not None:
        fleet.tracer.close_open(reason="run complete")
        fleet.tracer.export_otlp(args.otlp_out)
        print(f"otlp: {args.otlp_out} ({len(fleet.tracer.spans)} spans"
              f" -- OTLP-JSON, collector-ready)")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(fleet.telemetry.prometheus_text())
        print(f"metrics: {args.metrics_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
