"""Re-derive the dry-run records from the saved op records, without
running any step again: the port's counterpart of the JAX package's
``launch/reanalyze.py`` (which re-reads saved HLO).

    PYTHONPATH=src python -m repro_torch.launch.reanalyze \
        [--ops results/ops_torch] [--out results/dryrun_torch]

Each ``<arch>__<shape>.ops.json.zst`` written by ``dryrun`` gives back
its ``Cost`` (``op_analysis.Cost.from_record``), and the record is made
again by ``dryrun.record`` with the registry's config and shape; keys
the op record does not hold (none, for a record ``dryrun`` wrote) are
kept from the old record.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from repro_torch import compression
from repro_torch.launch.dryrun import OPS, OUT, record


def reanalyze(ops_path: str, old: dict | None = None, *, cfg=None,
              shape=None) -> dict:
    """The record of one saved op record (``cfg`` / ``shape`` default to
    the registry's, as ``dryrun.run_cell``'s do)."""
    from repro_torch.configs import SHAPES, get
    from repro_torch.launch.op_analysis import Cost
    base = os.path.basename(ops_path)[:-len(".ops.json.zst")]
    arch, shape_name = base.split("__")
    with open(ops_path, "rb") as f:
        doc = json.loads(compression.decompress(f.read()))
    rec = record(Cost.from_record(doc), arch=arch, shape_name=shape_name,
                 cfg=cfg or get(arch), shape=shape or SHAPES[shape_name],
                 meta_run_s=doc["meta_run_s"],
                 small_peak=doc["small_peak_bytes"],
                 microbatches=doc["microbatches"])
    return {**(old or {}), **rec}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ops", default=OPS)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for f in sorted(glob.glob(os.path.join(args.ops, "*.ops.json.zst"))):
        base = os.path.basename(f)[:-len(".ops.json.zst")]
        jpath = os.path.join(args.out, f"{base}.json")
        old = None
        if os.path.exists(jpath):
            with open(jpath) as fh:
                old = json.load(fh)
        rec = reanalyze(f, old)
        with open(jpath, "w") as fh:
            json.dump(rec, fh, indent=1, default=str)
        print(f"{base}: mem={rec['memory_s']:.4f}s "
              f"comp={rec['compute_s']:.4f}s coll={rec['collective_s']:.4f}s"
              f" dom={rec['dominant']} frac={rec['roofline_fraction']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
