"""Flash attention's backward calls in chip_smoke's shadowed llama-1.5b
train step, each held to its plain version by both of chip_smoke's
element rules, and the plain version held the same way to float64.

The step is the one chip_smoke's ``train`` path shadows: full width and
depth, seed-0 weights trained ``TRAIN_STEPS`` steps on its batches
(``AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)``, remat on),
then batch ``TRAIN_STEPS + 1``.  For every backward call it prints the
worst element of dQ, dK, dV over two limits (``chip_smoke.bwd_err``):

  * the bf16 rule alone, 4 bf16 ulps of the magnitude of the terms the
    element sums (what chip_smoke's kernel phase holds);
  * that plus 2 fp32 ulps of the magnitude of the terms of the dot
    products dP = dO V^T and delta = rowsum(dO o O) carried into it
    (what chip_smoke's shadowed train steps hold);

for the kernel (``flash_attention_bwd``) against fp32 ``plain_backward``,
for fp32 ``plain_backward`` against itself in float64 on the same inputs
(the forward's bf16 O among them, which delta takes in both), and for the
kernel against float64.  Rows whose dP and delta cancel (dO orthogonal to
O and to V's rows) take any fp32 implementation past the bf16 rule
alone, ``plain_backward`` too.  The last line is a JSON object with every
call's readings.  Needs the card:

    python3 scripts/flash_bwd_rule.py
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_rule: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import get
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.init import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.training.train import TrainConfig, make_train_step

    print(cs.gpu_line(), flush=True)
    build.build_all(("flash_attention", "flash_attention_bwd"))
    cfg = get("llama-1.5b")
    params = init_params(cfg, torch.Generator("cuda").manual_seed(cs.SEED),
                         device="cuda")
    opt = init_opt_state(params)
    tc = TrainConfig(AdamWConfig(lr=1e-3, warmup_steps=2,
                                 total_steps=cs.TRAIN_STEPS))
    pipe = Pipeline(DataConfig(cfg.vocab_size, cs.TRAIN_SEQ, cs.TRAIN_ROWS))
    step = make_train_step(cfg, tc)
    for i in range(cs.TRAIN_STEPS):
        params, opt, m = step(params, opt, cs.train_batch(pipe, i))
    print(f"trained {cs.TRAIN_STEPS} steps: loss {float(m['loss']):.4f}",
          flush=True)
    kernel, calls = fa.backward_kernel, []

    def held(q, k, v, o, do, lse, **kw):
        grads = kernel(q, k, v, o, do, lse, **kw)
        with torch.no_grad():
            *ref, terms, dots = fa.plain_backward(q, k, v, o, do, terms=True,
                                                  **kw)
            exact = fa.plain_backward(
                *(t.double() for t in (q, k, v, o, do)), **kw)
            _, kf, kp, _ = cs.bwd_err(grads, ref, terms, dots)
            _, pf, pp, _ = cs.bwd_err(ref, exact, terms, dots)
            _, ef, ep, _ = cs.bwd_err(grads, exact, terms, dots)
        c = dict(call=len(calls), kernel_vs_plain=[kp, kf],
                 plain_vs_f64=[pp, pf], kernel_vs_f64=[ep, ef])
        calls.append(c)
        print(f"call {c['call']:2d} (x the bf16 rule alone, x with the dot "
              f"products' part): kernel vs plain_backward {kp:.3f}, "
              f"{kf:.3f}; plain_backward vs float64 {pp:.3f}, {pf:.3f}; "
              f"kernel vs float64 {ep:.3f}, {ef:.3f}", flush=True)
        del exact, ref, terms, dots
        return grads

    fa.backward_kernel = held
    try:
        step(params, opt, cs.train_batch(pipe, cs.TRAIN_STEPS + 1))
        torch.cuda.synchronize()
    finally:
        fa.backward_kernel = kernel
    worst = {key: [max(c[key][i] for c in calls) for i in range(2)]
             for key in ("kernel_vs_plain", "plain_vs_f64", "kernel_vs_f64")}
    print(f"worst of {len(calls)} calls (bf16 rule alone, with the dot "
          f"products' part): {worst}", flush=True)
    print(json.dumps({"calls": calls, "worst": worst}))
    return 0 if worst["kernel_vs_plain"][1] <= 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
