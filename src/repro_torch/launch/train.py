"""The train entry point: end-to-end training with checkpoint / restart.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch llama-1.5b --tiny --steps 200 --batch 8 --seq 128 \
        --ckpt-dir CKPT [--resume]

The JAX package's ``repro.launch.train`` flags plus ``--device``: the
card by default (``--device cpu`` runs the kernels' plain versions; with
no card, a cuda run exits 1 with ``device.resolve``'s message, never
falling back).  Checkpoints every ``--ckpt-every`` steps and at the end
(atomic, the newest 3 kept, the JAX layout); ``--resume`` restarts from
the latest one, the data pipeline's cursor included (the pipeline is
stateless: the step index is the whole cursor).  The weights are the
port's ``init_params`` from ``--seed``, so the losses differ from the JAX
CLI's.  Architectures whose model takes encoder frames or patch
embeddings are a usage error (exit 2: the pipeline makes tokens only).
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    from repro_torch.configs import get, names
    from repro_torch.configs.tiny import make_tiny
    from repro_torch.device import resolve
    from repro_torch.serving.engine import takes_front_end

    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="llama-1.5b")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs "
                         "the kernels' plain versions)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)
    if args.arch not in names():
        ap.error(f"--arch {args.arch!r}: not one of {names()}")
    cfg = get(args.arch)
    if takes_front_end(cfg) is not None:
        ap.error(f"--arch {args.arch!r}: its model also takes "
                 f"{takes_front_end(cfg)}, and the data pipeline makes "
                 "tokens only")
    try:
        dev = resolve(args.device)
    except RuntimeError as e:
        raise SystemExit(f"{ap.prog}: {e}") from None

    import torch

    from repro_torch.checkpoint import disk
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.models.init import count_params, init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.training.train import TrainConfig, make_train_step

    if args.tiny:
        cfg = make_tiny(cfg)
    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr=args.lr, warmup_steps=args.steps // 10,
                              total_steps=args.steps),
        microbatches=args.microbatches)

    params = init_params(cfg, torch.Generator(dev).manual_seed(args.seed),
                         device=dev)
    opt = init_opt_state(params)
    start = 0
    if args.resume and args.ckpt_dir:
        latest = disk.latest_step(args.ckpt_dir)
        if latest is not None:
            tree = disk.restore(args.ckpt_dir, latest,
                                {"params": params, "opt": opt})
            params, opt = tree["params"], tree["opt"]
            start = latest
            print(f"resumed from step {start}")

    print(f"training {cfg.name}: {count_params(cfg)/1e6:.1f}M params, "
          f"{args.steps} steps")
    pipe = Pipeline(DataConfig(cfg.vocab_size, args.seq, args.batch))
    step_fn = make_train_step(cfg, tcfg)

    t0 = time.time()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.batch(step).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"ce {float(metrics['ce']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0):.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            disk.save(args.ckpt_dir, step + 1,
                      {"params": params, "opt": opt})
    if args.ckpt_dir:
        disk.save(args.ckpt_dir, args.steps, {"params": params, "opt": opt})
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
