"""Dry run of every (architecture x input shape) cell for one H100: the
port's counterpart of the JAX package's ``launch/dryrun.py`` (lower and
compile on 256- and 512-chip meshes).

Each cell's step (``launch/steps.py``) runs once on the ``meta`` device
under the op analysis (``launch/op_analysis.py``): nothing is allocated,
on the card or off it, and no card is needed.  The record has the JAX
record's keys, with two departures: ``meta_run_s`` (the seconds of the
meta run, analysis included) stands where JAX writes ``lower_s`` and
``compile_s``, and ``generated_code_size`` is None (nothing is
compiled).  It adds:

  * ``argument_size``: exact bytes of the parameters, optimizer state,
    batch and caches;
  * ``peak_memory_bytes``: the analysis' peak of live storages;
  * ``fits_one_card``: that peak against the card's 80 GB;
  * ``max_global_batch``: the largest global batch whose peak would fit,
    reckoned from a second run at the smallest batch (the microbatch
    count for train, 1 otherwise) with the peak taken as linear in the
    batch -- a figure for the reader, not a cut applied to anything.

The op record (counts, FLOPs and bytes by op and by kernel unit) is
saved compressed, as JAX saves the HLO, for ``reanalyze``.  One cell:

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch llama-1.5b --shape prefill_32k

Every cell of the JAX ``all_cells`` (llama-1.5b, the paper's own model,
is not an assigned cell; a single cell takes it), a process each:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

OUT = "results/dryrun_torch"
OPS = "results/ops_torch"


def cell_name(arch: str, shape_name: str) -> str:
    return f"{arch}__{shape_name}"


def _small(shape, microbatches: int):
    """The cell at its smallest batch: one row a microbatch (train), one
    row (prefill, decode)."""
    from repro_torch.configs.base import ShapeSpec
    b = microbatches if shape.kind == "train" else 1
    return ShapeSpec(shape.name, shape.seq_len, b, shape.kind,
                     shape.rule_overrides)


def max_global_batch(peak: float, peak_small: float, batch: int,
                     small: int, fixed: float, step: int) -> int:
    """The largest multiple of ``step`` whose peak fits the card, with the
    peak linear in the batch through (small, peak_small) and (batch,
    peak); where the two batches are one, through (0, fixed)."""
    from repro_torch.launch.mesh import HBM_BYTES
    if batch > small:
        per = (peak - peak_small) / (batch - small)
        base = peak - per * batch
    else:
        per, base = (peak - fixed) / batch, fixed
    if per <= 0:
        return 0
    return max(0, math.floor((HBM_BYTES - base) / per / step) * step)


def record(cost, *, arch, shape_name, cfg, shape, meta_run_s=None,
           small_peak=None, microbatches=4) -> dict:
    """The dry-run record of a cell from its op analysis' ``Cost``."""
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import HBM_BYTES, production_device
    from repro_torch.models.init import param_bytes
    card = production_device()
    n, na = cfg.param_count(), cfg.active_param_count()
    rl = roofline.from_cost(cost, arch=arch, shape_name=shape_name, cfg=cfg,
                            shape=shape, n_params=n, n_active=na)
    small = _small(shape, microbatches).global_batch
    rec = rl.to_dict()
    rec.update(
        meta_run_s=meta_run_s, chips=1, n_params=n, n_active=na,
        argument_size=cost.argument_bytes, output_size=cost.output_bytes,
        temp_size=cost.peak_bytes - cost.argument_bytes,
        generated_code_size=None,
        fits_one_card=cost.peak_bytes <= HBM_BYTES,
        global_batch=shape.global_batch, small_batch=small,
        small_batch_peak_bytes=small_peak,
        max_global_batch=(None if small_peak is None else max_global_batch(
            cost.peak_bytes, small_peak, shape.global_batch, small,
            param_bytes(cfg), microbatches if shape.kind == "train"
            else 1)),
        device=card.name or card.source, power_limit=card.power_limit)
    return rec


def analyze_cell(cfg, shape, microbatches=4):
    """(``Cost``, seconds) of the cell's step on the ``meta`` device."""
    from repro_torch.launch import op_analysis, steps
    t0 = time.perf_counter()
    fn, args = steps.build(cfg, shape, microbatches=microbatches)
    cost, _ = op_analysis.analyze(fn, *args)
    return cost, time.perf_counter() - t0


def run_cell(arch: str, shape_name: str, *, cfg=None, shape=None,
             ops_dir: str | None = OPS, microbatches: int = 4,
             reckon: bool = True) -> dict:
    """The cell's record.  ``cfg`` / ``shape`` default to the registry's
    (a test passes a tiny config); ``ops_dir`` None saves no op record;
    ``reckon`` runs the second, smallest-batch analysis."""
    from repro_torch import compression
    from repro_torch.configs import SHAPES, get
    cfg = cfg or get(arch)
    shape = shape or SHAPES[shape_name]
    cost, secs = analyze_cell(cfg, shape, microbatches)
    small_peak = None
    if reckon:
        small_peak = analyze_cell(cfg, _small(shape, microbatches),
                                  microbatches)[0].peak_bytes
    if ops_dir is not None:
        os.makedirs(ops_dir, exist_ok=True)
        doc = dict(cost.to_record(), small_peak_bytes=small_peak,
                   meta_run_s=secs, microbatches=microbatches)
        with open(os.path.join(ops_dir, cell_name(arch, shape_name)
                               + ".ops.json.zst"), "wb") as f:
            f.write(compression.compress(json.dumps(doc).encode(), level=9))
    rec = record(cost, arch=arch, shape_name=shape_name, cfg=cfg,
                 shape=shape, meta_run_s=secs, small_peak=small_peak,
                 microbatches=microbatches)
    print(f"== {arch} x {shape_name} on {rec['mesh']} ==")
    print("op analysis: flops=%.3e bytes=%.3e argument=%.3e peak=%.3e "
          "(meta run %.1f s)" % (cost.flops, cost.bytes, cost.argument_bytes,
                                 cost.peak_bytes, secs))
    print("roofline: compute=%.4fs memory=%.4fs collective=%.4fs "
          "dominant=%s useful=%.2f frac=%.3f fits_one_card=%s "
          "max_global_batch=%s"
          % (rec["compute_s"], rec["memory_s"], rec["collective_s"],
             rec["dominant"], rec["useful_flops_ratio"],
             rec["roofline_fraction"], rec["fits_one_card"],
             rec["max_global_batch"]))
    return rec


def all_cells():
    from repro_torch.configs import entry, names
    for arch in names():
        if arch == "llama-1.5b":
            continue  # the paper's own model, not an assigned cell
        for shape in entry(arch).shapes:
            yield arch, shape


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--ops", default=OPS)
    ap.add_argument("--timeout", type=int, default=1800)
    args = ap.parse_args(argv)

    if args.all:
        os.makedirs(args.out, exist_ok=True)
        failures = []
        for arch, shape in all_cells():
            path = os.path.join(args.out, cell_name(arch, shape) + ".json")
            if os.path.exists(path):
                print("skip (cached):", path)
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--out", args.out,
                   "--ops", args.ops]
            print(">>", " ".join(cmd), flush=True)
            r = subprocess.run(cmd, timeout=args.timeout)
            if r.returncode != 0:
                failures.append((arch, shape))
                print("!! FAILED", arch, shape, flush=True)
        print("failures:", failures)
        return 1 if failures else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    rec = run_cell(args.arch, args.shape, ops_dir=args.ops)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, cell_name(args.arch, args.shape) + ".json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    print("wrote", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
