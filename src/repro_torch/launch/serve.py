"""Serving driver: batched requests through the port's stack -- engine
+ privacy daemon + validation.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama-1.5b --tiny --requests 8 --max-new 24 --validate

Runs on the card (``--device cuda``, the default); ``--device cpu``
runs the kernels' plain versions.  The weights are the port's
``init_params`` from ``--seed``, so the tokens differ from the JAX
package's ``repro.launch.serve``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    from repro_torch.launch.common import add_common, setup, weights

    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    add_common(ap)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--validate", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg, dev = setup(ap, args)

    from repro_torch.core.daemon import PrivacyAwareDaemon
    from repro_torch.core.validation import ValidationFramework
    from repro_torch.serving.engine import Engine, Request

    params = weights(cfg, args.seed, dev)
    engine = Engine(cfg, params, slots=args.slots, max_len=args.max_len,
                    seed=args.seed, device=dev)
    daemon = PrivacyAwareDaemon()
    vf = ValidationFramework() if args.validate else None

    rng = np.random.default_rng(args.seed)
    sensitivities = ["public", "personal", "confidential"]
    reqs = [Request(rid=f"r{i}",
                    prompt=rng.integers(50, cfg.vocab_size, 8),
                    max_new_tokens=args.max_new,
                    temperature=args.temperature, top_k=16,
                    sensitivity=sensitivities[i % 3])
            for i in range(args.requests)]

    t0 = time.time()
    for r in reqs:
        d = daemon.decide(sensitivity=r.sensitivity, cfg=cfg,
                          prefill_tokens=len(r.prompt),
                          decode_tokens=r.max_new_tokens,
                          workspace_bytes=10 ** 7)
        print(f"{r.rid}[{r.sensitivity}] -> {d.target} ({d.reason})")
    # drive the engine directly: admit while slots free, then batch-step
    pending = list(reqs)
    outs: dict[str, list[int]] = {}
    while pending or engine.requests:
        while pending and engine.add_request(pending[0]):
            outs[pending[0].rid] = pending[0].output
            pending.pop(0)
        if engine.requests:
            engine.step()
    dt = time.time() - t0
    total_toks = sum(len(v) for v in outs.values())
    for rid, toks in sorted(outs.items()):
        line = f"{rid}: {toks}"
        if vf is not None:
            rep = vf.validate_post_hoc(toks)
            if rep.intervened:
                line += f"  [BLOCKED @{rep.halt_position}: " + ",".join(
                    v.kind for v in rep.verdicts if not v.ok) + "]"
        print(line)
    print(f"{total_toks} tokens in {dt:.2f}s "
          f"({total_toks/dt:.1f} tok/s on {dev.type})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
