"""End-to-end training driver: a ~100M llama-family model trained for a
few hundred steps with checkpointing + restart (fault-tolerance demo).

The paper is a serving system, so the canonical e2e driver is
launch/serve.py; this trainer exercises the training substrate
(train_4k's lowering path) at example scale.

CPU note: the default runs a ~2M-param model for 120 steps.  ``--full``
selects the true ~100M config (24L/640d, head_dim 64) -- meant for the
card.  A checkpoint every 40 steps; kill the run and restart it with
``--resume`` to continue from the newest one: the data pipeline is
stateless and the AdamW schedule is the same, so the resumed run ends on
the uninterrupted run's parameters and moments bit for bit.

    PYTHONPATH=src python -m repro_torch.examples.train_100m \
        [--device cpu] [--full] [--resume]

The weights are the port's ``init_params`` from ``--seed``, so the
losses differ from the JAX example's.
"""

from __future__ import annotations

import torch

from repro_torch.checkpoint import disk
from repro_torch.configs.base import BlockDef, LayerSpec, ModelConfig
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.device import resolve
from repro_torch.examples import parser, weights
from repro_torch.models.init import count_params
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.training.train import TrainConfig, make_train_step

CFG_100M = ModelConfig(
    name="repro-100m", family="dense", d_model=640, num_heads=10,
    num_kv_heads=5, head_dim=64, d_ff=1792, vocab_size=8192,
    vocab_pad_multiple=128,
    blocks=(BlockDef((LayerSpec("attn", "dense"),), repeats=24),))

CFG_2M = ModelConfig(
    name="repro-2m", family="dense", d_model=128, num_heads=4,
    num_kv_heads=2, head_dim=32, d_ff=384, vocab_size=2048,
    vocab_pad_multiple=128,
    blocks=(BlockDef((LayerSpec("attn", "dense"),), repeats=4),))

# a separate directory from the JAX example's, so that a run never
# resumes the other package's checkpoints by accident
CKPT_DIR = "/tmp/repro_torch_train100m"


def train(cfg, params, *, steps=120, batch=8, seq=128, ckpt_dir=CKPT_DIR,
          resume=False, device, ckpt_every=40) -> dict:
    """Train ``params`` for ``steps`` steps from step 0, or with
    ``resume`` from the newest checkpoint in ``ckpt_dir``; a checkpoint
    of params and AdamW state every ``ckpt_every`` steps.  Returns the
    losses, the first and the last, whether it learned, and the final
    params and state."""
    print(f"{cfg.name}: {count_params(cfg)/1e6:.1f}M params")
    opt = init_opt_state(params)
    start = 0
    if resume:
        latest = disk.latest_step(ckpt_dir)
        if latest:
            tree = disk.restore(ckpt_dir, latest,
                                {"params": params, "opt": opt})
            params, opt, start = tree["params"], tree["opt"], latest
            print(f"resumed at step {start}")

    pipe = Pipeline(DataConfig(cfg.vocab_size, seq, batch))
    step_fn = make_train_step(cfg, TrainConfig(optimizer=AdamWConfig(
        lr=3e-3, warmup_steps=10, total_steps=steps)))
    losses = []
    for step in range(start, steps):
        data = {k: torch.from_numpy(v).to(device)
                for k, v in pipe.batch(step).items()}
        params, opt, m = step_fn(params, opt, data)
        loss = float(m["loss"])
        losses.append(loss)
        if step % 10 == 0:
            print(f"step {step:4d}  loss {loss:.4f}", flush=True)
        if (step + 1) % ckpt_every == 0:
            disk.save(ckpt_dir, step + 1, {"params": params, "opt": opt})
            print(f"  checkpointed at {step+1} "
                  "(kill + --resume to test restart)", flush=True)
    first, last = (losses[0], losses[-1]) if losses else (None, None)
    learned = bool(losses) and last < first - 0.5
    if losses:
        print(f"loss: {first:.3f} -> {last:.3f} "
              f"({'LEARNED' if learned else 'check config'})")
    return dict(losses=losses, first=first, last=last, learned=learned,
                start=start, params=params, opt=opt)


def main(argv=None) -> int:
    ap = parser("train_100m", __doc__)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    cfg = CFG_100M if args.full else CFG_2M
    train(cfg, weights(cfg, device, args.seed), steps=args.steps,
          batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
          resume=args.resume, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
