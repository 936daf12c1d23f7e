"""Scenario 1 (the travel blogger): multi-tier replication with
failover + quality degradation + reconnect merge.

    PYTHONPATH=src python -m repro_torch.examples.resilient_failover \
        [--device cpu]
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.attestation import measure_config
from repro_torch.core.replication import ReplicaTier, ReplicationManager
from repro_torch.core.workspace import AgentWorkspace
from repro_torch.examples import FULL_HELP, llama, parser
from repro_torch.serving.engine import Engine, Request


def run(cfg, params, *, device, slots=2, max_len=128, prompt_len=8,
        max_new=48, steps=6, roaming_bps=5e5) -> dict:
    gid = measure_config(cfg)
    mk = lambda s: Engine(cfg, params, slots=slots, max_len=max_len,  # noqa
                          seed=s, device=device)
    mgr = ReplicationManager([
        ReplicaTier("cloud", mk(0), quality=1.0, functionality=1.0),
        ReplicaTier("edge", mk(1), quality=0.8, functionality=0.85),
        ReplicaTier("device", mk(2), quality=0.5, functionality=0.8),
    ])
    got = {}

    # drafting an article on the cloud tier, syncing replicas as we go
    cloud = mgr.tiers["cloud"].engine
    req = Request("article", np.arange(prompt_len), max_new_tokens=max_new)
    cloud.add_request(req)
    for _ in range(steps):
        cloud.step()
        mgr.sync(AgentWorkspace.from_engine(cloud, gid))
    got.update(drafted=len(req.output), tokens=list(req.output),
               delta_fraction=mgr.last_delta_fraction,
               sync_bytes=mgr.sync_bytes_total)
    print(f"on cloud: {len(req.output)} tokens drafted; "
          f"incremental sync = {mgr.last_delta_fraction:.0%} of pages, "
          f"{mgr.sync_bytes_total}B total")

    # the bus enters the mountains
    print("\n-- network lost --")
    mgr.tiers["cloud"].cond.up = False
    tier, latency = mgr.failover("disconnect")
    got.update(failover=tier.name, latency_s=latency)
    print(f"failover -> {tier.name} in {latency*1000:.0f}ms "
          f"(quality {tier.quality:.0%}, paper budget: 200ms)")
    edge = tier.engine
    cont = next(iter(edge.requests.values()))
    for _ in range(steps):
        edge.step()
    got["offline"] = len(cont.output)
    print(f"continued offline: {len(cont.output)} tokens")

    # bandwidth-starved roaming: degrade to the on-device model
    print("\n-- roaming at <1 Mbps --")
    mgr.tiers["edge"].cond.bandwidth_bps = roaming_bps
    mgr.tiers["device"].cond.bandwidth_bps = roaming_bps
    tier = mgr.pick_tier()
    got["roaming"] = tier.name
    print(f"placement under bandwidth limit: {tier.name} "
          f"(quality {tier.quality:.0%} -- graceful degradation)")

    # reconnect: merge diverged replicas with vector clocks
    print("\n-- reconnected --")
    mgr.tiers["cloud"].cond.up = True
    ws_local = AgentWorkspace.from_engine(edge, gid, node="edge")
    ws_cloud = AgentWorkspace.from_engine(cloud, gid, node="cloud")
    merged = mgr.merge_on_reconnect(ws_local, ws_cloud)
    got.update(vclock=dict(merged.vclock.clocks),
               preserved=len(merged.requests))
    print(f"merged vector clock: {merged.vclock.clocks}; "
          f"{len(merged.requests)} request(s) preserved")
    return got


def main(argv=None) -> int:
    args = parser("resilient_failover", __doc__,
                  full_help=FULL_HELP).parse_args(argv)
    cfg, params, device = llama(args)
    run(cfg, params, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
