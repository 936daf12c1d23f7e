"""The rwkv6 scan's backward at every group size G and chain split DV, at
rwkv6-7b's train shape and at its prefill chunk, in one process.

``rwkv6_scan_bwd`` runs a chain kernel (grid (D / DV, H, B): the state's
gradient through every chunk, a checkpoint every G chunks) and a body
kernel (grid (ceil(NC / G), H, B): each group from its checkpoint); the
rules ``rwkv6_scan.groups`` and ``rwkv6_scan.chain_split`` pick G and DV.
This times every G in ``GROUPS`` with every DV the head dim has, at B 4 x
1536 tokens, chunk 8 (the train path's shape) and at B 1 x 1536, chunk
64: each reading the median of ``--reps`` runs of ``chip_smoke.time_ms``
(the configurations visited in order, then in reverse, so that a drift
of the card's clock falls on all of them alike), with the profiler's
device time of each kernel.  Every configuration's dr, dk, dv, dw and
dstate0 must equal the rule's bit for bit (the body recomputes the state
gradient inside a group with the chain's operations), and the rule's
gradients are held to ``plain_backward`` by chip_smoke's rule.  With
``--parent TREE`` the backward kernel of another checkout (a
``rwkv6_scan_bwd.cu`` of the one-kernel design: one CTA a (batch,
head), its C entry point taking no group or split) is built from
TREE/src and timed at the train shape in the same process, in turns with
the rule's configuration.  The last line is a JSON object with every reading.
Needs the card:

    python3 scripts/rwkv_bwd_designs.py [--reps 10] [--parent TREE]
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

GROUPS = (1, 2, 4, 8, 16, 32)
# (label, B, T, H, D, chunk, moderate decays)
SHAPES = (("train chunk 8", 4, 1536, 64, 64, 8, False),
          ("prefill chunk 64", 1, 1536, 64, 64, 64, True))


def parent_kernel(tree: Path):
    """The one-kernel backward from ``tree``: built with this tree's flags
    into build/, returned as fn(r, k, v, w, u, states, dy, dS, chunk)."""
    from repro_torch.kernels import build
    src = tree / "src" / "repro_torch" / "kernels" / "csrc" / \
        "rwkv6_scan_bwd.cu"
    out = build.BUILD_DIR / "parent_rwkv6_scan_bwd.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.FLAGS, "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(out)).rwkv6_scan_bwd_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 14 + [I] * 5 + [P]
    fn.restype = I

    def call(r, k, v, w, u, states, dy, dS, chunk):
        B, T, H, D = r.shape
        dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
        du = torch.empty((B, H, D), device=r.device)
        ds0 = torch.empty((B, H, D, D), device=r.device)
        err = fn(*(t.data_ptr() for t in (r, k, v, w, u, states, dy, dS,
                                          dr, dk, dv, dw, du, ds0)),
                 B, T, H, D, chunk, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent rwkv6_scan_bwd: error {err}")
        return dr, dk, dv, dw, du.sum(0), ds0
    return call


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rwkv_bwd_designs: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import rwkv6_scan as rs

    print(cs.gpu_line(), flush=True)
    build.build_all(("rwkv6_scan", "rwkv6_scan_bwd"))
    parent = parent_kernel(args.parent) if args.parent else None
    gen = torch.Generator("cuda").manual_seed(cs.SEED)
    out, ok = [], True
    for label, B, T, H, D, C, moderate in SHAPES:
        r, k, v, w, u, s0 = cs._rwkv_inputs(B, T, H, D, gen)
        if moderate:
            w = cs._moderate(w, gen)
        dy = torch.randn((B, T, H, D), generator=gen, device="cuda")
        dS = torch.randn((B, H, D, D), generator=gen, device="cuda")
        _, _, states = rs.forward_with_states(r, k, v, w, u, s0, chunk=C)
        NC = T // C
        rule = (rs.groups(B, H, NC), rs.chain_split(B, H, D))
        want = rs.rwkv6_scan_bwd(r, k, v, w, u, states, dy, dS, chunk=C)
        _, frac, worst = cs.rwkv_bwd_err(rs, want, (r, k, v, w, u, s0), dy,
                                         dS, C, states)
        ok &= frac <= 1.0
        configs = [(G, dv) for G in GROUPS for dv in rs.CHAIN_SPLITS[D]]
        times = {cfg: [] for cfg in configs}
        same, dev = {}, {}
        for order in (configs, configs[::-1]):
            for G, dv in order:
                def call(G=G, dv=dv):
                    return rs.rwkv6_scan_bwd(r, k, v, w, u, states, dy, dS,
                                             chunk=C, group=G, dv=dv)
                if (G, dv) not in same:
                    got = call()
                    same[G, dv] = all(torch.equal(want[i], got[i])
                                      for i in (0, 1, 2, 3, 5))
                    dev[G, dv] = cs.kernel_device_ms(call)
                times[G, dv] += [cs.time_ms(call, iters=5)
                                 for _ in range(-(-args.reps // 2))]
        ok &= all(same.values())
        med = {cfg: statistics.median(t) for cfg, t in times.items()}
        print(f"{label} B={B} T={T} H={H} D={D} chunk {C} ({NC} chunks; "
              f"the rule: G {rule[0]}, DV {rule[1]}; {frac:.3f} x the leaf "
              f"rule: {worst})", flush=True)
        for (G, dv), m in med.items():
            print(f"  G={G:2d} DV={dv}: {m:.4f} ms [{min(times[G, dv]):.4f},"
                  f" {max(times[G, dv]):.4f}] body CTAs "
                  f"{-(-NC // G) * B * H}, chain CTAs {D // dv * B * H}; by "
                  f"kernel {dev[G, dv]}; bit-equal to the rule's "
                  f"{same[G, dv]}", flush=True)
        best = min(med, key=med.get)
        row = dict(case=label, B=B, T=T, H=H, D=D, chunk=C, rule=rule,
                   best=best, limit_frac=frac,
                   ms_median={f"G{G} DV{dv}": m for (G, dv), m in med.items()},
                   device_ms={f"G{G} DV{dv}": d for (G, dv), d in dev.items()},
                   bit_equal=all(same.values()))
        print(f"  best G={best[0]} DV={best[1]} {med[best]:.4f} ms; the "
              f"rule's {med[rule]:.4f} ms ({med[rule] / med[best]:.3f}x)",
              flush=True)
        if parent is not None and label.startswith("train"):
            pt = {"parent": [], "rule": []}
            for who in ("parent", "rule", "rule", "parent"):
                fn = (lambda: parent(r, k, v, w, u, states, dy, dS, C)) \
                    if who == "parent" else (lambda: rs.rwkv6_scan_bwd(
                        r, k, v, w, u, states, dy, dS, chunk=C))
                pt[who] += [cs.time_ms(fn, iters=5)
                            for _ in range(-(-args.reps // 2))]
            _, pfrac, _ = cs.rwkv_bwd_err(
                rs, parent(r, k, v, w, u, states, dy, dS, C),
                (r, k, v, w, u, s0), dy, dS, C, states)
            pm = {who: statistics.median(t) for who, t in pt.items()}
            row["parent_ms_median"] = pm["parent"]
            row["rule_vs_parent_ms_median"] = pm["rule"]
            print(f"  parent (one-kernel design) {pm['parent']:.4f} ms ("
                  f"{pfrac:.3f} x the leaf rule), the rule's {pm['rule']:.4f}"
                  f" ms in turns: {pm['parent'] / pm['rule']:.2f}x faster",
                  flush=True)
        out.append(row)
        del r, k, v, w, u, s0, dy, dS, states, want
        torch.cuda.empty_cache()
    print(json.dumps({"card": cs.gpu_line(), "shapes": out}, default=str))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
