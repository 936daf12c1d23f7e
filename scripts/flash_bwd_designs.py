"""Flash attention's backward at D 64 / 128 with its dK/dV kernel on CTAs
of 64 keys and of 128 keys, at the same shapes, in one process.

``flash_attention_bwd`` picks 64-key CTAs where a grid of 128-key ones
would give the card's SMs fewer than two CTAs each, else 128.  This times
both at llama-1.5b's layer (B 1 and the train path's B 4 x 1536),
gemma2-27b's softcapped one (B 1), whisper-base's decoder self-attention
(B 4 x 416, causal, D 64) and its encoder and cross shapes (full mode):
per shape the two designs in the order 64, 128, 128, 64, each reading
the median of ``--reps`` runs of ``chip_smoke.time_ms``, and the dK/dV
kernel's profiler device time; each design's gradients held to
``plain_backward`` by chip_smoke's kernel-phase rule.  The last line is a
JSON object with every reading.  Needs the card:

    python3 scripts/flash_bwd_designs.py [--reps 5]
"""

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

# (label, B, Sq, Skv, H, KV, D, causal, softcap)
SHAPES = (("llama-1.5b", 1, 1536, 1536, 16, 8, 128, True, 0.0),
          ("gemma2-27b softcap", 1, 1536, 1536, 32, 16, 128, True, 50.0),
          ("whisper-base decoder", 4, 416, 416, 8, 8, 64, True, 0.0),
          ("whisper-base encoder", 4, 1536, 1536, 8, 8, 64, False, 0.0),
          ("whisper-base cross", 4, 416, 1536, 8, 8, 64, False, 0.0),
          ("llama-1.5b train", 4, 1536, 1536, 16, 8, 128, True, 0.0))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_designs: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    print(cs.gpu_line(), flush=True)
    build.build_all(("flash_attention", "flash_attention_bwd"))
    gen = torch.Generator("cuda").manual_seed(cs.SEED)
    out, ok = [], True
    for label, B, Sq, Skv, H, KV, D, causal, softcap in SHAPES:
        kw = dict(causal=causal, softcap=softcap)
        q, k, v, do = cs.bwd_inputs(B, Sq, Skv, H, KV, D, gen)
        o, lse = fa.forward_with_lse(q, k, v, **kw)
        *ref, terms, _ = fa.plain_backward(q, k, v, o, do, terms=True, **kw)
        rule = fa.bwd_design(B, Skv, KV, D)

        def call():
            return fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)

        ms = {64: [], 128: []}
        dev, frac = {}, {}
        try:
            for keys in (64, 128, 128, 64):
                fa.set_bwd_keys(keys)
                if keys not in frac:
                    frac[keys] = cs.bwd_err(call(), ref, terms)[1]
                    dev[keys] = cs.kernel_device_ms(call).get("dkdv_wgmma")
                ms[keys] += [cs.time_ms(call) for _ in range(args.reps)]
        finally:
            fa.set_bwd_keys(0)
        med = {keys: statistics.median(t) for keys, t in ms.items()}
        ok &= max(frac.values()) <= 1.0
        row = dict(case=label, B=B, Sq=Sq, Skv=Skv, H=H, KV=KV, D=D,
                   causal=causal, softcap=softcap, rule=rule,
                   ctas={64: -(-Skv // 64) * B * KV,
                         128: -(-Skv // 128) * B * KV},
                   ms_median=med, ms_min={k: min(t) for k, t in ms.items()},
                   ms_max={k: max(t) for k, t in ms.items()},
                   dkdv_device_ms=dev, limit_frac=frac)
        out.append(row)
        print(f"{label} B={B} Sq={Sq} Skv={Skv} H={H} KV={KV} D={D} "
              f"causal={causal} softcap={softcap} (the rule: {rule}): "
              f"64-key {med[64]:.4f} ms [{min(ms[64]):.4f}, "
              f"{max(ms[64]):.4f}] dK/dV {dev[64]}, 128-key {med[128]:.4f} "
              f"ms [{min(ms[128]):.4f}, {max(ms[128]):.4f}] dK/dV "
              f"{dev[128]}; 64/128 {med[64] / med[128]:.3f}; element rule "
              f"{frac[64]:.3f} / {frac[128]:.3f}", flush=True)
        del q, k, v, do, o, lse, ref, terms
    print(json.dumps({"card": cs.gpu_line(), "shapes": out}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
