"""Render the dry-run and roofline markdown tables from the port's dry-run
records, per-request timelines from an exported Chrome trace, and
per-tier SLO tables from a fleet summary: a copy of the JAX package's
``launch/report.py`` (framework-free), whose mesh argument defaults to
the port's one card (``launch/mesh.MESH_NAME``), and ``card_table``
(``--section card``), the keys only the port's records hold.

    PYTHONPATH=src python -m repro_torch.launch.report [--dir results/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.report --section card
    PYTHONPATH=src python -m repro_torch.launch.report --trace TRACE_fleet.json
    PYTHONPATH=src python -m repro_torch.launch.report --trace T.json --rid r3
    PYTHONPATH=src python -m repro_torch.launch.report --slo summary.json

The trace is ``fleet.tracing.Tracer.chrome_trace()``'s, the summary a
port fleet's ``summary()``.
"""

import argparse
import glob
import json
import os

from repro_torch.launch.mesh import MESH_NAME


def fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PiB"


def load(d):
    rows = []
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        rows.append(json.load(open(f)))
    return rows


def roofline_table(rows, mesh=MESH_NAME):
    out = ["| arch | shape | compute s | memory s | collective s | "
           "dominant | MODEL/HLO flops | roofline frac | peak mem/dev |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["mesh"] != mesh:
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4f} | "
            f"{r['memory_s']:.4f} | {r['collective_s']:.4f} | "
            f"**{r['dominant']}** | {r['useful_flops_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} | "
            f"{fmt_bytes(r['peak_memory_bytes'])} |")
    return "\n".join(out)


def dryrun_table(rows):
    out = ["| arch | shape | mesh | compile s | HLO GFLOPs/dev | "
           "HBM GB/dev | coll GB/dev | ar/ag/rs/a2a/cp GB | "
           "args/dev | temps/dev |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        cb = r["coll_breakdown"]
        g = 1e9
        parts = "/".join(
            f"{cb.get(k, 0)/g:.2f}" for k in
            ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute"))
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r.get('compile_s', 0):.0f} | {r['flops']/g:.1f} | "
            f"{r['hbm_bytes']/g:.2f} | {r['coll_bytes']/g:.3f} | "
            f"{parts} | {fmt_bytes(r.get('argument_size'))} | "
            f"{fmt_bytes(r.get('temp_size'))} |")
    return "\n".join(out)


def card_table(rows):
    """The port's one-card figures of each record: what the step counts,
    its arguments and estimated peak against the 80 GB card, and its
    roofline terms."""
    out = ["| arch | shape | TFLOP | TB moved | args | est. peak | "
           "fits one card | largest global batch | compute s | memory s | "
           "dominant |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['flops'] / 1e12:.1f} | "
            f"{r['hbm_bytes'] / 1e12:.3f} | {fmt_bytes(r['argument_size'])} | "
            f"{fmt_bytes(r['peak_memory_bytes'])} | "
            f"{'yes' if r['fits_one_card'] else 'no'} | "
            f"{r['max_global_batch']} of {r['global_batch']} | "
            f"{r['compute_s']:.4f} | {r['memory_s']:.4f} | {r['dominant']} |")
    return "\n".join(out)


def trace_timelines(trace: dict, rid: str | None = None) -> str:
    """ASCII per-request timelines from an exported Chrome trace.

    Spans are grouped by ``args.trace_id`` (the request id; engine
    tracks are ``engine:<name>``), children indented under parents by
    ``args.parent_id``, and each line shows start/duration (ms) plus the
    engine and the facts that explain the segment (reason, wire bytes,
    lossy)."""
    by_trace: dict[str, list[dict]] = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        a = ev.get("args", {})
        tid = a.get("trace_id")
        if tid is None or (rid is not None and tid != rid):
            continue
        by_trace.setdefault(tid, []).append(ev)
    lines = []
    for tid in sorted(by_trace):
        evs = sorted(by_trace[tid], key=lambda e: (e["ts"],
                                                   e["args"]["span_id"]))
        children: dict = {}
        for ev in evs:
            children.setdefault(ev["args"].get("parent_id"),
                                []).append(ev)
        lines.append(f"== {tid} ==")

        def emit(parent, depth):
            for ev in children.get(parent, ()):
                a = ev["args"]
                extras = [a.get("engine") or ev.get("engine") or ""]
                for k in ("reason", "route_tier", "outcome", "state",
                          "wire_bytes", "lossy", "dst",
                          "time_to_useful_s", "wall_s", "cache_hit",
                          "promoted", "construct_s", "standby_build_s"):
                    if a.get(k) not in (None, "", False):
                        extras.append(f"{k}={a[k]}")
                lines.append(
                    f"  {'  ' * depth}{ev['name']:<12s} "
                    f"{ev['ts'] / 1e3:9.3f}ms +{ev['dur'] / 1e3:8.3f}ms"
                    f"  {' '.join(x for x in extras if x)}")
                emit(a["span_id"], depth + 1)

        emit(None, 0)
    return "\n".join(lines)


def slo_table(slo: dict) -> str:
    out = ["| tier | requests | time at tier s | completed | "
           "availability | p50 | p95 | p99 |",
           "|---|---|---|---|---|---|---|---|"]
    for name, row in sorted(slo.items()):
        out.append(
            f"| {name or '(untiered)'} | {row['requests']} | "
            f"{row['time_at_tier_s']:.4f} | {row['completed']} | "
            f"{row['availability']:.4f} | {row['latency_p50']:.4f} | "
            f"{row['latency_p95']:.4f} | {row['latency_p99']:.4f} |")
    return "\n".join(out)


def prefix_line(prefix: dict | None) -> str:
    """One-line prefix-cache digest from a fleet summary's ``prefix``
    block; empty when the run never armed the cache."""
    if not prefix or not (prefix.get("hits") or prefix.get("misses")):
        return ""
    return (f"\nPrefix cache: hit rate {prefix['hit_rate']:.0%} "
            f"({prefix['hits']} hits / {prefix['misses']} misses), "
            f"{fmt_bytes(prefix['bytes_saved'])} KV saved, "
            f"{prefix['evictions']} evictions")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--section",
                    choices=["roofline", "dryrun", "both", "card"],
                    default="both")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="render per-request timelines from an exported "
                         "Chrome trace JSON instead of the tables")
    ap.add_argument("--rid", default=None,
                    help="with --trace: only this request's timeline")
    ap.add_argument("--slo", default=None, metavar="PATH",
                    help="render the per-tier SLO table from a fleet "
                         "summary JSON (or a bare summary()['slo'] dump)")
    args = ap.parse_args(argv)
    if args.trace:
        print(trace_timelines(json.load(open(args.trace)), args.rid))
        return
    if args.slo:
        doc = json.load(open(args.slo))
        print("### Per-tier SLO\n")
        print(slo_table(doc.get("slo", doc)))
        print(prefix_line(doc.get("prefix")))
        return
    rows = load(args.dir)
    if args.section == "card":
        print(f"### One card ({MESH_NAME}, meta-device analysis, H100 SXM "
              "sheet)\n")
        print(card_table(rows))
        return
    if args.section in ("roofline", "both"):
        print(f"### Roofline (one card {MESH_NAME})\n")
        print(roofline_table(rows))
    if args.section in ("dryrun", "both"):
        print("\n### Dry-run raw\n")
        print(dryrun_table(rows))


if __name__ == "__main__":
    main()
