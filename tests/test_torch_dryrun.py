"""The port's dry-run tools against the JAX package's on the CPU:
``launch/steps.build`` (prefill, decode, train) on tiny llama-1.5b and
tiny rwkv6-7b against JAX's ``steps.build`` on a 1 x 1 mesh of Auto axes
(the JAX ``make_debug_mesh`` gives Explicit axes, which its steps'
sharding constraints refuse), on the same weights; a dry run of every
family and step kind on the ``meta`` device (nothing allocated, the
argument bytes those of the concrete tree); the full-width llama-1.5b
``prefill_32k`` cell through the CLI; ``--all``'s cells; ``reanalyze``;
and ``report``'s text against JAX's on the port's records, a port
fleet's Chrome trace and its SLO summary.

Tolerances are the parity tests': f32 logits within 1e-4 absolute
(``tests/test_torch_model.py``), the train loss within 1e-5 relative
(``tests/test_torch_train_parity.py``)."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.configs import inputs as jinputs  # noqa: E402
from repro.configs.base import ShapeSpec as JShapeSpec  # noqa: E402
from repro.configs.tiny import make_tiny as jtiny  # noqa: E402
from repro.launch import report as jreport  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.init import init_params as jinit  # noqa: E402
from repro.models.model import make_cache as jmake_cache  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.configs import ShapeSpec, get, names  # noqa: E402
from repro_torch.configs.tiny import make_tiny  # noqa: E402
from repro_torch.launch import dryrun, op_analysis, reanalyze  # noqa: E402
from repro_torch.launch import report, steps  # noqa: E402
from repro_torch.models.init import params_from_numpy  # noqa: E402
from repro_torch.optim.adamw import init_opt_state  # noqa: E402
from tests.torch_helpers import as_f32, to_numpy  # noqa: E402

LOGIT_TOL = 1e-4
LOSS_REL = 1e-5
KINDS = ("prefill", "decode", "train")
SMALL = {"prefill": (64, 2), "decode": (64, 2), "train": (64, 4)}


def _shapes(kind):
    S, B = SMALL[kind]
    return ShapeSpec(f"small_{kind}", S, B, kind), \
        JShapeSpec(f"small_{kind}", S, B, kind)


def _auto_mesh():
    from jax.sharding import AxisType
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


@pytest.fixture(scope="module", params=["llama-1.5b", "rwkv6-7b"])
def pair(request):
    """(jax cfg, torch cfg, JAX params, the same weights in torch), f32."""
    jcfg = jtiny(jget(request.param)).replace(dtype="float32")
    cfg = make_tiny(get(request.param)).replace(dtype="float32")
    jp = jinit(jcfg, jax.random.key(0))
    return jcfg, cfg, jp, params_from_numpy(to_numpy(jp), device="cpu")


@pytest.mark.parametrize("kind", KINDS)
def test_steps_build_matches_jax(pair, kind):
    jcfg, cfg, jp, tp = pair
    shape, jshape = _shapes(kind)
    fn, args = steps.build(cfg, shape, concrete=True, device="cpu",
                           microbatches=2, seed=3)
    jfn, _ = jsteps.build(jcfg, jshape, _auto_mesh(),
                          **({"microbatches": 2} if kind == "train" else {}))
    batch = jinputs.batch_specs(jcfg, jshape, concrete=True, seed=3)
    if kind == "train":
        jout = jfn(jp, jadamw.init_opt_state(jp), batch)
        out = fn(tp, init_opt_state(tp), args[2])
        want, got = float(jout[2]), float(out[2])
        assert abs(got - want) <= LOSS_REL * abs(want), (got, want)
        return
    caches = (jinputs.input_specs(jcfg, jshape, concrete=True)["caches"]
              if kind == "decode" else
              jmake_cache(jcfg, shape.global_batch, shape.seq_len))
    jlogits, _ = jfn(jp, batch, caches)
    logits, written = fn(tp, args[1], args[2])
    assert written is args[2]            # the port writes in place
    assert logits.shape == (shape.global_batch, cfg.padded_vocab)
    err = float(np.abs(as_f32(jlogits) - as_f32(logits)).max())
    assert err < LOGIT_TOL, err


class _MetaOnly(TorchDispatchMode):
    """Fails on any op that makes a tensor off the ``meta`` device."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in op_analysis._tensors(out):
            assert t.device.type == "meta", (func, t.device)
        return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", sorted(names()))
def test_tiny_dry_run_of_every_family_allocates_nothing(arch, kind):
    cfg = make_tiny(get(arch))
    shape, _ = _shapes(kind)
    fn, args = steps.build(cfg, shape, microbatches=2)
    with _MetaOnly():
        cost, out = op_analysis.analyze(fn, *args)
    assert all(t.device.type == "meta"
               for t in op_analysis._tensors((args, out)))
    assert cost.flops > 0 and cost.bytes > 0
    assert cost.peak_bytes >= cost.argument_bytes > 0
    _, concrete = steps.build(cfg, shape, concrete=True, device="cpu",
                              microbatches=2)
    assert cost.argument_bytes == op_analysis.tree_bytes(concrete)
    units = set(cost.units)
    mixers = {ls.mixer for b in cfg.blocks for ls in b.layers}
    if kind == "decode":
        assert ("decode_attention" in units) == bool(
            mixers & {"attn", "local"})
    else:
        assert ("flash_attention" in units) == bool(
            mixers & {"attn", "local"} or cfg.encoder_blocks)
        assert ("rwkv6_scan" in units) == ("rwkv" in mixers)
    if kind == "train":
        assert ("flash_attention_bwd" in units) == ("flash_attention"
                                                    in units)
        assert ("rwkv6_scan_bwd" in units) == ("rwkv" in mixers)


JAX_RECORD_KEYS = {
    "arch", "shape", "mesh", "flops", "hbm_bytes", "coll_bytes",
    "coll_breakdown", "peak_memory_bytes", "model_flops", "compute_s",
    "memory_s", "collective_s", "model_bytes", "dominant",
    "useful_flops_ratio", "roofline_fraction", "bound_s", "chips",
    "n_params", "n_active", "argument_size", "output_size", "temp_size",
    "generated_code_size"}


def test_full_width_llama_prefill_32k_cell_through_the_cli(tmp_path):
    out, ops = tmp_path / "records", tmp_path / "ops"
    assert dryrun.main(["--arch", "llama-1.5b", "--shape", "prefill_32k",
                        "--out", str(out), "--ops", str(ops)]) == 0
    rec = json.loads((out / "llama-1.5b__prefill_32k.json").read_text())
    assert JAX_RECORD_KEYS <= set(rec)
    assert {"meta_run_s", "fits_one_card", "max_global_batch"} <= set(rec)
    assert rec["mesh"] == "1xH100" and rec["chips"] == 1
    assert rec["flops"] >= rec["model_flops"] > 0
    assert rec["collective_s"] == 0.0
    # the params, and the caches of 32 rows of 32768 tokens
    cfg = get("llama-1.5b")
    kv = 2 * 24 * 32 * 32768 * cfg.num_kv_heads * cfg.head_dim * 2
    assert rec["argument_size"] >= kv + 2 * cfg.param_count()
    assert rec["peak_memory_bytes"] > rec["argument_size"]
    assert rec["fits_one_card"] is False and rec["max_global_batch"] >= 1
    # reanalyze gives the record back from the op record alone
    assert reanalyze.main(["--ops", str(ops), "--out", str(out)]) == 0
    assert json.loads((out / "llama-1.5b__prefill_32k.json").read_text()) \
        == rec


def test_all_cells_are_the_jax_dry_runs():
    saved = os.environ.get("XLA_FLAGS")
    try:                   # the JAX module sets XLA_FLAGS on import
        from repro.launch import dryrun as jdryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    assert list(dryrun.all_cells()) == list(jdryrun.all_cells())


@pytest.fixture(scope="module")
def tiny_records(tmp_path_factory):
    """Port-written records of tiny llama's three kinds and their op
    records, with the tiny configs passed in."""
    tmp_path = tmp_path_factory.mktemp("dryrun")
    out, ops = tmp_path / "records", tmp_path / "ops"
    out.mkdir()
    cfg = make_tiny(get("llama-1.5b"))
    recs = {}
    for kind in KINDS:
        shape, _ = _shapes(kind)
        rec = dryrun.run_cell("llama-1.5b", shape.name, cfg=cfg, shape=shape,
                              ops_dir=str(ops), microbatches=2)
        (out / f"llama-1.5b__{shape.name}.json").write_text(
            json.dumps(rec, indent=1, default=str))
        recs[shape.name] = (rec, cfg, shape)
    return out, ops, recs


def test_reanalyze_reproduces_run_cell(tiny_records):
    _, ops, recs = tiny_records
    for name, (rec, cfg, shape) in recs.items():
        path = ops / f"llama-1.5b__{name}.ops.json.zst"
        assert reanalyze.reanalyze(str(path), cfg=cfg, shape=shape) == rec
        assert rec["max_global_batch"] >= shape.global_batch


def _port_fleet():
    """A port fleet over two tiny engines: three requests, one of them
    cancelled; its Chrome trace and telemetry summary."""
    from repro_torch.fleet import EngineHandle, FleetController, RequestSpec
    from repro_torch.core.attestation import TrustAuthority
    from repro_torch.core.channel import SimClock
    from repro_torch.core.daemon import CLOUD, EDGE
    from repro_torch.models.init import init_params
    from repro_torch.serving.engine import Engine
    cfg = make_tiny(get("llama-1.5b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    clk = SimClock()
    fleet = FleetController(
        [EngineHandle(n, Engine(cfg, params, slots=2, max_len=48, seed=i,
                                device="cpu"), p)
         for i, (n, p) in enumerate((("edge", EDGE), ("cloud", CLOUD)))],
        authority=TrustAuthority(), clock=clk)
    tickets = [fleet.submit(RequestSpec(prompt=np.arange(3 + i), rid=f"r{i}",
                                        max_new_tokens=6 + i))
               for i in range(3)]
    fleet.step()
    tickets[2].cancel()
    for _ in range(40):
        clk.advance(0.01)
        fleet.step()
        if all(t.done for t in tickets):
            break
    fleet.tracer.close_open(reason="end of test")
    return fleet.tracer.chrome_trace(), fleet.telemetry.summary()


def test_report_text_equals_jax(tiny_records):
    out, _, _ = tiny_records
    rows = report.load(str(out))
    assert rows == jreport.load(str(out)) and len(rows) == 3
    assert report.roofline_table(rows) == \
        jreport.roofline_table(rows, "1xH100")
    assert report.roofline_table(rows).count("\n") == 4
    assert report.dryrun_table(rows) == jreport.dryrun_table(rows)
    for b in (None, 0, 1536, 5e9):
        assert report.fmt_bytes(b) == jreport.fmt_bytes(b)
    trace, summary = _port_fleet()
    trace = json.loads(json.dumps(trace))
    text = report.trace_timelines(trace)
    assert text and text == jreport.trace_timelines(trace)
    assert report.trace_timelines(trace, "r1") == \
        jreport.trace_timelines(trace, "r1")
    summary = json.loads(json.dumps(summary, default=str))
    assert report.slo_table(summary["slo"]) == \
        jreport.slo_table(summary["slo"])
    assert report.prefix_line(summary.get("prefix")) == \
        jreport.prefix_line(summary.get("prefix"))


def test_report_main_renders_port_records(tiny_records, capsys):
    out, _, _ = tiny_records
    report.main(["--dir", str(out)])
    text = capsys.readouterr().out
    assert "### Roofline (one card 1xH100)" in text
    assert text.count("| llama-1.5b |") == 6
    report.main(["--dir", str(out), "--section", "card"])
    rows = capsys.readouterr().out.splitlines()[4:]
    assert len(rows) == 3 and all("| yes |" in r for r in rows)
    assert all(f" of {SMALL[k][1]} |" in r for r, k in zip(
        rows, ("decode", "prefill", "train")))
