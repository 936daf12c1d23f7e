"""The port's roofline tools for one H100 against the JAX package's on the
CPU: the op analysis against ``hlo_analysis.analyze`` (FLOPs, exactly)
on ``tests/test_roofline.py``'s programs, ``model_flops`` and
``model_bytes`` against JAX's at every registry cell, the ``Roofline``
terms on the H100 constants, the kernels' cost formulas at the figures
of ``PERF.md``'s kernel table, the kernel units (transparent with no
analysis running, one unit each under one), and the one card of
``launch/mesh``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get as jget  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch.hlo_analysis import analyze as hlo_analyze  # noqa: E402
from repro_torch.configs import SHAPES, entry, get, names  # noqa: E402
from repro_torch.kernels import ops, units  # noqa: E402
from repro_torch.launch import mesh, op_analysis, roofline  # noqa: E402


# -- the op analysis against the HLO analyzer --------------------------------

def _single(a, b):
    return a @ b


def _scanned(x, w):
    for _ in range(10):
        x = x @ w
    return x


def _nested(x, w):
    for _ in range(4):
        for _ in range(3):
            x = x @ w
    return x


def _jax_scanned(x, w):
    def body(c, _):
        return c @ w, None
    return jax.lax.scan(body, x, None, length=10)[0]


def _jax_nested(x, w):
    def outer(c, _):
        def inner(ci, _):
            return ci @ w, None
        return jax.lax.scan(inner, c, None, length=3)[0], None
    return jax.lax.scan(outer, x, None, length=4)[0]


PROGRAMS = {
    "single_dot": (_single, lambda a, b: a @ b, (32, 512), (512, 64)),
    "loop_of_dots": (_scanned, _jax_scanned, (128, 128), (128, 128)),
    "nested_loops": (_nested, _jax_nested, (64, 64), (64, 64)),
}


@pytest.mark.parametrize("device", ["meta", "cpu"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_op_analysis_flops_equal_hlo_analysis(name, device):
    fn, jfn, sa, sb = PROGRAMS[name]
    text = jax.jit(jfn).lower(jax.ShapeDtypeStruct(sa, jnp.float32),
                              jax.ShapeDtypeStruct(sb, jnp.float32)
                              ).compile().as_text()
    want = hlo_analyze(text).flops
    a = torch.ones(sa, device=device)
    b = torch.ones(sb, device=device)
    cost, _ = op_analysis.analyze(fn, a, b)
    assert cost.flops == want
    assert cost.units == {}


def test_op_analysis_counts_bytes_and_live_storages():
    """Bytes: each op's tensor arguments read and its results written, a
    view moving nothing; peak: the arguments plus what is live at once."""
    a = torch.empty((256, 256), device="meta")        # 256 KiB each

    def fn(a):
        b = a * 2.0               # 512 KiB moved, one 256 KiB storage
        c = b.T                   # a view: nothing
        d = c + a                 # 768 KiB moved
        del b, c
        return d.sum()            # 256 KiB read, 4 B written

    cost, out = op_analysis.analyze(fn, a)
    n = 256 * 256 * 4
    assert cost.argument_bytes == n
    assert cost.bytes == 2 * n + 3 * n + n + 4
    assert cost.peak_bytes == 3 * n            # a, b and d at once
    assert cost.output_bytes == 4
    assert cost.ops["aten.permute"] == [1, 0.0, 0.0]


# -- model_flops / model_bytes against JAX at every registry cell -----------

def _cells():
    return [(a, s) for a in sorted(names()) for s in entry(a).shapes]


@pytest.mark.parametrize("arch,shape", _cells())
def test_model_flops_and_bytes_equal_jax(arch, shape):
    cfg, jcfg = get(arch), jget(arch)
    n, na = cfg.param_count(), cfg.active_param_count()
    assert (n, na) == (jcfg.param_count(), jcfg.active_param_count())
    s, js = SHAPES[shape], JSHAPES[shape]
    assert roofline.model_flops(cfg, s, n, na) == \
        jroofline.model_flops(jcfg, js, n, na)
    assert roofline.model_bytes(cfg, s, n, na, chips=256, tp=16) == \
        jroofline.model_bytes(jcfg, js, n, na, 256)
    one = roofline.model_bytes(cfg, s, n, na)
    assert one == roofline.model_bytes(cfg, s, n, na, chips=1, tp=1)
    assert one >= 2.0 * na           # one card streams every weight


def test_roofline_terms_and_dominance_on_the_h100_sheet():
    r = roofline.Roofline(arch="x", shape="y", mesh=mesh.MESH_NAME,
                          flops=989e12, hbm_bytes=3.35e12 / 2,
                          coll_bytes=0.0, coll_breakdown={},
                          peak_memory_bytes=0,
                          model_flops=494.5e12).finalize()
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(0.5)
    assert r.collective_s == 0.0
    assert r.dominant == "compute"
    assert r.bound_s == pytest.approx(1.0)
    assert r.roofline_fraction == pytest.approx(0.5)
    m = roofline.Roofline(arch="x", shape="y", mesh=mesh.MESH_NAME,
                          flops=1e12, hbm_bytes=3.35e12, coll_bytes=0.0,
                          coll_breakdown={}, peak_memory_bytes=0,
                          model_flops=0.0, model_bytes=3.35e12 / 4
                          ).finalize()
    assert m.dominant == "memory" and m.bound_s == pytest.approx(1.0)
    assert m.roofline_fraction == pytest.approx(0.25)
    # the record has JAX's keys
    j = jroofline.Roofline(arch="x", shape="y", mesh="16x16", flops=1.0,
                           hbm_bytes=1.0, coll_bytes=0.0, coll_breakdown={},
                           peak_memory_bytes=0, model_flops=0.0).finalize()
    assert set(m.to_dict()) == set(j.to_dict())


# -- the kernels' formulas at PERF.md's bound inputs ------------------------

def _paged():
    pos = [1000, 990, 1010, 1005]
    live = sum(p // 16 + 1 for p in pos)
    return roofline.paged_decode_cost(4, 16, 8, 128, 16 * live,
                                      sum(p + 1 for p in pos), 4 * 128)


def _dense():
    pos = [60, 530, 1050, 1560]
    return roofline.decode_cost(4, 16, 8, 128, sum(p + 1 for p in pos))


# (cost, "flops", "bytes" or "K+V" (the bytes less the slots' positions,
# q, o and the row positions), PERF.md's figure, its unit, the bound ms)
FORMULAS = {
    "flash S 1536": (lambda: roofline.flash_cost(1, 1536, 1536, 16, 8, 128),
                     "flops", 9.67, 1e9, 0.0098),
    "paged decode": (_paged, "bytes", 16.5, 1e6, 0.0049),
    "dense decode": (_dense, "K+V", 13.1, 1e6, 0.0039),
    "rwkv6_scan T 1536": (lambda: roofline.rwkv6_scan_cost(
        1, 1536, 64, 64, 64), "bytes", 127.9, 1e6, 0.0382),
    "int8 M 4": (lambda: roofline.int8_matmul_cost(4, 4096, 14336), "bytes",
                 58.9, 1e6, 0.0176),
    "int8 M 1536": (lambda: roofline.int8_matmul_cost(1536, 4096, 14336),
                    "flops", 180, 1e9, 0.1824),
    "spec_accept": (lambda: roofline.spec_accept_cost(4, 32768, n=0),
                    "bytes", 393, 1e3, 0.000117),
    "rwkv6 backward": (lambda: roofline.rwkv6_scan_bwd_cost(
        4, 1536, 64, 64, 8), "bytes", 914.4, 1e6, 0.2730),
}


@pytest.mark.parametrize("case", sorted(FORMULAS))
def test_kernel_costs_give_perf_bounds(case):
    make, what, figure, unit, bound_ms = FORMULAS[case]
    c = make()
    got = c.flops if what == "flops" else c.bytes
    if what == "K+V":
        valid = 61 + 531 + 1051 + 1561
        got -= valid * 4 + 2 * 4 * 16 * 128 * 2 + 4 * 4
    digits = len(str(figure).split(".")[1]) if "." in str(figure) else 0
    assert round(got / unit, digits) == figure
    ms, _ = c.bound()
    assert float(f"{ms:.{len(str(bound_ms)) - 2}f}") == bound_ms


def test_kernel_costs_by_name_and_peaks():
    assert set(roofline.KERNEL_COSTS) == {
        "flash_attention", "flash_attention_bwd", "paged_decode_attention",
        "decode_attention", "spec_accept", "rwkv6_scan", "rwkv6_scan_bwd",
        "int8_matmul"}
    fwd = roofline.kernel_cost("flash_attention", B=1, Sq=512, Skv=512,
                               H=8, KV=8, D=64, causal=True, window=0)
    bwd = roofline.kernel_cost("flash_attention_bwd", B=1, Sq=512, Skv=512,
                               H=8, KV=8, D=64, causal=True, window=0)
    assert bwd.flops == 2.5 * fwd.flops
    assert fwd.peak == mesh.PEAK_BF16_FLOPS
    assert roofline.rwkv6_scan_cost(1, 64, 4, 16, 8).peak == \
        mesh.PEAK_F32_FLOPS
    # the chunk-start states add their bytes
    assert roofline.rwkv6_scan_cost(1, 64, 4, 16, 8, states=True).bytes \
        - roofline.rwkv6_scan_cost(1, 64, 4, 16, 8).bytes == 4 * 4 * 8 * 16 ** 2


# -- kernel units -----------------------------------------------------------

def _unit_cases(device):
    g = torch.Generator().manual_seed(0)

    def r(*s, dt=torch.float32):
        return torch.randn(s, generator=g).to(dt).to(device)
    B, S, H, KV, D = 2, 64, 4, 2, 16
    q, k, v = r(B, S, H, D), r(B, S, KV, D), r(B, S, KV, D)
    pos = torch.tensor([5, 40], dtype=torch.int32, device=device)
    ap = torch.arange(S, dtype=torch.int32, device=device)[None].repeat(B, 1)
    pt = torch.arange(8, dtype=torch.int32, device=device).reshape(2, 4)
    rr = [torch.rand((1, 32, 2, 16), generator=g).to(device)
          for _ in range(4)]
    probs = torch.softmax(r(5, 50), -1)
    wq = torch.randint(-127, 127, (16, 24), generator=g,
                       dtype=torch.int8).to(device)
    return {
        "attention_causal": lambda: ops.attention_causal(q, k, v),
        "attention_windowed": lambda: ops.attention_windowed(q, k, v,
                                                             window=8),
        "attention_full": lambda: ops.attention_full(q, k, v),
        "decode_attention": lambda: ops.decode_attention(
            q[:, :1], k, v, ap, pos),
        "paged_decode_attention": lambda: ops.paged_decode_attention(
            q[:, :1], k.reshape(8, 16, KV, D), v.reshape(8, 16, KV, D), pt,
            pos, page_size=16),
        "spec_accept": lambda: ops.spec_accept(
            torch.tensor([1, 2, 3, 4], dtype=torch.int32, device=device),
            probs[:4], probs, torch.rand(4, generator=g).to(device)),
        "rwkv6_scan": lambda: ops.rwkv6_scan(
            rr[0], rr[1], rr[2], rr[3] * 0.5 + 0.4, r(2, 16),
            r(1, 2, 16, 16), chunk=8),
        "int8_matmul": lambda: ops.int8_matmul(r(3, 16), wq,
                                               r(24).abs() + 0.01),
    }


UNIT_OF = {"attention_causal": "flash_attention",
           "attention_windowed": "flash_attention",
           "attention_full": "flash_attention"}


@pytest.mark.parametrize("op", sorted(_unit_cases("cpu")))
def test_kernel_units_are_transparent_and_counted_once(op):
    """With no analysis running the call is the call; under one it gives
    the same values on the CPU, counts as one unit of its kernel and
    nothing else, and on meta makes outputs of the plain version's
    shapes, dtypes and (for flash) packed strides, with no plain op."""
    assert units.ANALYSIS.get() is None
    plain = _unit_cases("cpu")[op]()
    cost, got = op_analysis.analyze(_unit_cases("cpu")[op])
    flat = lambda x: x if isinstance(x, tuple) else (x,)  # noqa: E731
    for a, b in zip(flat(plain), flat(got)):
        assert torch.equal(a, b)
    name = UNIT_OF.get(op, op)
    assert list(cost.units) == [name] and cost.units[name][0] == 1
    meta, mgot = op_analysis.analyze(_unit_cases("meta")[op])
    assert list(meta.units) == [name]
    for a, b in zip(flat(plain), flat(mgot)):
        assert b.device.type == "meta"
        assert (b.shape, b.dtype) == (a.shape, a.dtype)
    assert meta.units[name] == cost.units[name]


@pytest.mark.parametrize("op", ["attention_causal", "rwkv6_scan"])
def test_a_plain_versions_gradient_is_one_backward_unit(op):
    """Under autograd the plain version's backward is one unit of the
    kernel's backward, with autograd's gradients on the CPU and packed
    empty gradients of the inputs' shapes on meta."""
    bwd = {"attention_causal": "flash_attention_bwd",
           "rwkv6_scan": "rwkv6_scan_bwd"}[op]
    for device in ("cpu", "meta"):
        g = torch.Generator().manual_seed(1)
        if op == "attention_causal":
            xs = [torch.randn(s, generator=g).to(device).requires_grad_()
                  for s in ((1, 64, 4, 16), (1, 64, 2, 16), (1, 64, 2, 16))]
            f = lambda *x: ops.attention_causal(*x).sum()  # noqa: E731
        else:
            xs = [(torch.rand((1, 16, 2, 8), generator=g) * 0.5 + 0.4).to(
                device).requires_grad_() for _ in range(4)]
            xs += [torch.randn(s, generator=g).to(device).requires_grad_()
                   for s in ((2, 8), (1, 2, 8, 8))]
            f = lambda *x: ops.rwkv6_scan(  # noqa: E731
                *x, chunk=8)[0].sum()

        def step(*x):
            return torch.autograd.grad(f(*x), x)
        cost, grads = op_analysis.analyze(step, *xs)
        assert cost.units[bwd][0] == 1
        if device == "cpu":
            want = torch.autograd.grad(f(*xs), xs)
            for a, b in zip(want, grads):
                assert torch.allclose(a, b, rtol=0, atol=0)
        else:
            assert [tuple(t.shape) for t in grads] == \
                [tuple(x.shape) for x in xs]


# -- the card ---------------------------------------------------------------

def test_one_card_and_no_mesh():
    card = mesh.production_device()
    assert mesh.MESH_NAME == "1xH100"
    if not torch.cuda.is_available():
        assert card.name is None and card.source == "H100 SXM sheet"
    for kw in (dict(multi_pod=True), dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
            mesh.production_device(**kw)
    assert (mesh.PEAK_BF16_FLOPS, mesh.PEAK_F32_FLOPS, mesh.HBM_BW) == \
        (989e12, 67e12, 3.35e12)


def test_chip_smoke_bounds_by_the_same_formulas():
    import chip_smoke
    assert chip_smoke.roofline is roofline
    assert chip_smoke.HBM_BW is mesh.HBM_BW
    assert np.isclose(roofline.KernelCost(989e9, 0.0).bound()[0], 1.0)
    assert np.isclose(roofline.KernelCost(0.0, 3.35e9).bound()[0], 1.0)
