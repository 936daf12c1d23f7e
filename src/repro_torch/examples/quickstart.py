"""Quickstart: serve a model, snapshot its workspace mid-generation,
migrate it through an attested encrypted channel, and verify the
migrated agent continues bit-exactly.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The tokens are sampled from the port's per-slot ``(seed, counter)``
state, so they differ from the JAX example's; the continuation is held
to the unmigrated run bit for bit within the port.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import (AgentWorkspace, AttestedSession, Attester,
                              Channel, Migrator, TrustAuthority,
                              capabilities, measure_config)
from repro_torch.examples import FULL_HELP, check, llama, parser
from repro_torch.serving.engine import Engine, Request


def run(cfg, params, *, device, slots=2, max_len=64, seed=42,
        cloud_seed=999, prompt_len=6, max_new=12, temperature=0.7,
        top_k=8, before=5) -> dict:
    # 1. a model + a serving engine ("edge device")
    edge = Engine(cfg, params, slots=slots, max_len=max_len, seed=seed,
                  device=device)

    def request():
        return Request("hello", prompt=np.arange(prompt_len),
                       max_new_tokens=max_new, temperature=temperature,
                       top_k=top_k)

    # 2. serve a request for a few steps
    req = request()
    edge.add_request(req)
    for _ in range(before):
        edge.step()
    early = list(req.output)
    print("tokens before migration:", req.output)

    # 3. attested handshake edge -> cloud (simulated network)
    auth = TrustAuthority()
    gid = measure_config(cfg)
    session = AttestedSession(
        Attester("edge-1", auth, gid, capabilities(cfg)),
        Attester("cloud-1", auth, gid, capabilities(cfg)),
        Channel(), whitelist={gid})

    # 4. migrate the live workspace (KV caches, rng, positions, ...)
    ws = AgentWorkspace.from_engine(edge, gid)
    cloud = Engine(cfg, params, slots=slots, max_len=max_len,
                   seed=cloud_seed, device=device)
    cloud, report = Migrator().migrate(ws, session, cloud)
    print(f"migrated {report.raw_bytes}B raw -> {report.wire_bytes}B wire "
          f"in {report.total_s*1000:.1f}ms "
          f"(transfer {report.transfer_s*1000:.1f}ms simulated @1Gbps)")

    # 5. continue on the cloud engine
    out = list(req.output)
    while cloud.requests:
        out += list(cloud.step().values())
    print("tokens after migration: ", out)

    # 6. prove bit-exactness vs an unmigrated run
    ref_eng = Engine(cfg, params, slots=slots, max_len=max_len, seed=seed,
                     device=device)
    ref = request()
    ref_eng.add_request(ref)
    for _ in range(max_new):
        ref_eng.step()
    check(out == ref.output, "migration changed the output!")
    print("bit-exact continuation verified.")
    return dict(before=early, tokens=out, raw_bytes=report.raw_bytes,
                wire_bytes=report.wire_bytes, total_s=report.total_s,
                transfer_s=report.transfer_s)


def main(argv=None) -> int:
    args = parser("quickstart", __doc__, full_help=FULL_HELP).parse_args(
        argv)
    cfg, params, device = llama(args)
    run(cfg, params, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
