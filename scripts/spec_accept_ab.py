"""Time ``spec_accept`` of one tree of the port on the card.

    python3 scripts/spec_accept_ab.py [--src TREE/src] [--label NAME]

Times the kernel by CUDA events over calls queued behind a sleep kernel
(``chip_smoke.time_ms``) at the speculative tier's g = 4 over V = 32768
and 262144 (gemma3_4b's vocab), random drafts (n = 0) and greedy ones
(n = 2), on the inputs ``chip_smoke`` makes from seed 0, beside an empty
kernel timed the same way (the back-to-back launch floor).  ``--src``
picks the tree whose ``repro_torch`` is timed (default: this checkout's),
so two trees are compared on one card by running this once per tree in
one command: parent, change, change, parent.  Prints the card line and
one JSON line; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("spec_accept_ab: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import spec_verify as sv
    if not sv.__file__.startswith(str(Path(args.src).resolve())):
        raise SystemExit(f"imported {sv.__file__}, not from {args.src}")

    gen = torch.Generator("cuda").manual_seed(cs.SEED)
    out = {"label": args.label, "src": args.src}
    for V in (32768, 262144):
        for kind in ("random", "greedy"):
            d, q, p, u = cs._spec_case(kind, 4, V, gen)
            n, dist = sv.spec_accept(d, q, p, u)
            n_ref, dist_ref = sv.plain(d, q, p, u)
            err = cs.max_err(dist, dist_ref)
            if int(n) != int(n_ref) or err > cs.SPEC_TOL:
                raise AssertionError(f"V={V} {kind}: n {int(n)} vs "
                                     f"{int(n_ref)}, dist err {err}")
            ms = cs.time_ms(lambda: sv.spec_accept(d, q, p, u), iters=100)
            out[f"V{V}_{kind}"] = {"n": int(n), "ms": ms}
    out["launch_floor_ms"] = cs.time_ms(lambda: torch.cuda._sleep(0),
                                        iters=100)
    print(cs.gpu_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
