"""int8_matmul's output against its plain version and against the exact
product, over many draws of chip_smoke's prefill inputs.

The kernel and ``int8_matmul.plain`` both form every product exactly
(a bf16 x times an int8 weight), sum in fp32 in different orders, scale
and round to bf16, so an element may round to a neighbouring bf16 value
in one and not the other.  For each draw (chip_smoke's ``_int8_case`` at
rwkv6-7b's wk and wv shapes, M 1536, bf16 x, one generator per seed) this
prints max |plain| (m), one bf16 ulp at m, and the worst element's error
over m and in ulps of m for the kernel against plain, for plain against
the float64 product rounded to bf16, and for the kernel against that.
chip_smoke's limit is max(5e-3 m, one ulp at m); the draws where 5e-3 m
alone is under one ulp are marked.  The last line is a JSON object with
every reading.  Needs the card:

    python3 scripts/int8_rule.py [--draws 16]
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("int8_rule: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import int8_matmul as im

    print(cs.gpu_line(), flush=True)
    build.build_all(("int8_matmul",))
    rows = []
    for name, (K, N) in (("wk", (4096, 14336)), ("wv", (14336, 4096))):
        for seed in range(args.draws):
            gen = torch.Generator("cuda").manual_seed(seed)
            x, wq, ws = cs._int8_case(1536, K, N, torch.bfloat16, gen)
            o, p = im.int8_matmul(x, wq, ws), im.plain(x, wq, ws)
            e = ((x.double() @ wq.double())
                 * ws.double()).to(torch.bfloat16)
            m = float(p.float().abs().max())
            ulp = cs.out_ulp(m, torch.bfloat16)
            r = dict(shape=name, seed=seed, m=m, ulp=ulp,
                     below=cs.INT8_REL * m < ulp)
            for key, (a, b) in (("kernel_vs_plain", (o, p)),
                                ("plain_vs_exact", (p, e)),
                                ("kernel_vs_exact", (o, e))):
                err = cs.max_err(a, b)
                r[key] = [err / m, err / ulp]
            rows.append(r)
            print(f"{name} M=1536 seed {seed}: m {m:.4f}, ulp {ulp}"
                  f"{' (5e-3 m under one ulp)' if r['below'] else ''}; "
                  f"err / m (ulps of m): kernel vs plain "
                  f"{r['kernel_vs_plain'][0]:.3e} "
                  f"({r['kernel_vs_plain'][1]:.2f}), plain vs exact "
                  f"{r['plain_vs_exact'][0]:.3e} "
                  f"({r['plain_vs_exact'][1]:.2f}), kernel vs exact "
                  f"{r['kernel_vs_exact'][0]:.3e} "
                  f"({r['kernel_vs_exact'][1]:.2f})", flush=True)
            del x, wq, ws, o, p, e
    old = [r for r in rows if r["kernel_vs_plain"][0] > cs.INT8_REL]
    plain_old = [r for r in rows if r["plain_vs_exact"][0] > cs.INT8_REL]
    print(f"{len(rows)} draws: kernel vs plain past 5e-3 of m in "
          f"{len(old)}, plain vs exact in {len(plain_old)}; worst in ulps "
          f"of m: kernel vs plain "
          f"{max(r['kernel_vs_plain'][1] for r in rows):.2f}, plain vs "
          f"exact {max(r['plain_vs_exact'][1] for r in rows):.2f}",
          flush=True)
    print(json.dumps({"card": cs.gpu_line(), "draws": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
