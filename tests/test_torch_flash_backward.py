"""Flash attention's backward on the CPU: ``plain_backward`` (the formulas
the backward kernel computes, written out in fp32) against autograd of the
port's ``flash_attention.plain`` and against ``jax.grad`` of the JAX
package's ``models/attention.reference_attention``, at small shapes over
every mode the kernel takes (causal, a window, full with Sq != Skv, a
softcap), G 1 / 2 / 4 and head dims 64 / 128 / 160 / 256; and the kernel
wrappers' refusal to run under autograd where they have no backward.

Tolerance: 2e-5 of each gradient's max |reference| (the f32 kernel
tolerance), for dQ, dK and dV; the element rule's magnitudes
(``terms=True``) against float64 where dP and delta cancel.
The backward kernel itself runs on the card only
(tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import reference_attention as jref  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import int8_matmul as im  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rs  # noqa: E402
from repro_torch.kernels import spec_verify as sv  # noqa: E402

TOL = 2e-5
# (label, Sq, Skv, H, KV, D, kwargs)
CASES = [
    ("causal-g2-d64", 48, 48, 4, 2, 64, dict(causal=True)),
    ("causal-g1-d128", 40, 40, 2, 2, 128, dict(causal=True)),
    ("window-g4-d256", 64, 64, 8, 2, 256, dict(causal=True, window=20)),
    ("full-cross-g1-d64", 24, 56, 2, 2, 64, dict(causal=False)),
    ("full-g4-d160", 32, 32, 4, 1, 160, dict(causal=False)),
    ("softcap-g2-d128", 48, 48, 4, 2, 128, dict(causal=True, softcap=5.0)),
    ("softcap-window-g4-d160", 40, 40, 4, 1, 160,
     dict(causal=True, window=9, softcap=20.0)),
]


def _inputs(Sq, Skv, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, Sq, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((2, Skv, KV, D)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((2, Sq, H, D)).astype(np.float32)
    return q, k, v, do


def _close(got, want, what):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, name)
        top = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= TOL * top, (what, name, err / top)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_backward_matches_autograd_and_jax(case):
    label, Sq, Skv, H, KV, D, kw = case
    q, k, v, do = _inputs(Sq, Skv, H, KV, D, seed=len(label))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = fa.plain(tq, tk, tv, **kw)
    o.backward(torch.from_numpy(do))
    mine = fa.plain_backward(tq.detach(), tk.detach(), tv.detach(),
                             o.detach(), torch.from_numpy(do), **kw)
    assert all(m.dtype == torch.float32 for m in mine)
    _close([m.numpy() for m in mine],
           [t.grad.numpy() for t in (tq, tk, tv)], (label, "autograd"))

    def f(q, k, v):
        return jnp.vdot(jref(q, k, v, **kw), jnp.asarray(do))
    jg = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    _close([m.numpy() for m in mine], [np.asarray(g) for g in jg],
           (label, "jax"))


def test_plain_backward_terms_bound_its_rounding():
    """``terms=True`` adds the magnitude of each gradient's terms (dS's
    with dP - delta kept apart): at least the gradient's own magnitude,
    elementwise, and not 0 on a causal row 0, whose dS cancels."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(40, 40, 4, 2, 64, 3))
    o = fa.plain(q, k, v, causal=True)
    *grads, terms, _ = fa.plain_backward(q, k, v, o, do, causal=True,
                                         terms=True)
    for g, t in zip(grads, terms):
        assert t.shape == g.shape and t.dtype == torch.float32
        assert bool((g.abs() <= t * (1 + 1e-5) + 1e-6).all())
    assert float(grads[0][:, 0].abs().max()) < 1e-5
    assert float(terms[0][:, 0].abs().max()) > 0.1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dots_bound_the_rounding_of_cancelling_dot_products(seed):
    """On one-hot rows (each query its own dominant key) with dO
    orthogonal to O, dP = dO V^T and delta = rowsum(dO o O) cancel to
    their fp32 rounding: fp32 ``plain_backward`` against itself in float64
    on the same inputs (float64 inputs keep float64) misses 4 bf16 ulps
    of the terms dQ sums (the first magnitudes ``terms=True`` adds), and
    every element of dQ, dK and dV stays within that plus 2 fp32 ulps
    (4 x 2^-24) of the dot products' terms (the second, 0 for dV, which
    holds neither)."""
    g = torch.Generator().manual_seed(seed)
    S, H, KV, D = 48, 2, 1, 64
    q = torch.randn(1, S, H, D, generator=g, dtype=torch.float64) * 6
    k = q[:, :, :KV].clone()
    v = torch.randn(1, S, KV, D, generator=g, dtype=torch.float64) * 20
    o = fa.plain(q, k, v, causal=True).double()
    gd = torch.randn(1, S, H, D, generator=g, dtype=torch.float64) * 1e-6
    do = gd - (gd * o).sum(-1, keepdim=True) / (o * o).sum(
        -1, keepdim=True) * o
    ins = [t.float() for t in (q, k, v, o, do)]
    *grads, terms, dots = fa.plain_backward(*ins, causal=True, terms=True)
    exact = fa.plain_backward(*(t.double() for t in ins), causal=True)
    beyond = []
    for got, want, t, n in zip(grads, exact, terms, dots):
        assert want.dtype == torch.float64
        e = (got.double() - want).abs()
        assert bool((e <= 4 * 2.0 ** -7 * t + 4 * 2.0 ** -24 * n).all())
        beyond.append(float((e / (4 * 2.0 ** -7 * t).clamp(
            min=1e-300)).max()))
    assert beyond[0] > 1.0, beyond
    assert float(dots[2].abs().max()) == 0.0


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=24),
                                dict(causal=True, softcap=5.0)],
                         ids=["causal", "full", "window", "softcap"])
def test_plain_backward_meets_the_bf16_rule_on_random_inputs(kw):
    """On random inputs, where dP and delta do not cancel, fp32
    ``plain_backward`` against itself in float64 on the same inputs stays
    far inside 4 bf16 ulps of the magnitude of the terms each element sums
    alone: the rule a backward kernel is held to at random shapes, with no
    part for the dot products' rounding."""
    ins = [torch.from_numpy(a) for a in _inputs(40, 56, 4, 2, 64, 5)]
    q, k, v, do = ins
    o = fa.plain(q, k, v, **kw)
    *grads, terms, _ = fa.plain_backward(q, k, v, o, do, terms=True, **kw)
    exact = fa.plain_backward(*(t.double() for t in (q, k, v, o, do)),
                              **kw)
    for got, want, t in zip(grads, exact, terms):
        e = (got.double() - want).abs()
        assert bool((e <= 4 * 2.0 ** -7 * t * 1e-2).all())


def test_backward_wrapper_refuses_cpu_tensors():
    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _inputs(16, 16, 2, 2, 64, 0))
    lse = torch.zeros((2, 2, 16))
    with pytest.raises(ValueError, match="flash_attention_bwd kernel needs "
                                         "CUDA tensors"):
        fa.flash_attention_bwd(q, k, v, q, do, lse)
    assert "flash_attention_bwd" in build.KERNELS


def test_build_hashes_the_shared_headers(tmp_path, monkeypatch):
    """Both flash sources include ``csrc/hopper.cuh``; an edited header
    names a new library for every kernel, so a stale one is never
    loaded, and an unchanged tree names the same one."""
    for f in build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, tmp_path / f.name)
    for name in ("flash_attention", "flash_attention_bwd"):
        assert '#include "hopper.cuh"' in (tmp_path / f"{name}.cu").read_text()
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build._target(n) for n in build.KERNELS}
    assert before == {n: build._target(n) for n in build.KERNELS}
    header = tmp_path / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build._target(n) for n in build.KERNELS}
    assert all(before[n] != after[n] for n in build.KERNELS)


def _kernel_calls():
    """Each kernel wrapper without a backward, called on CPU tensors that
    require grad: (kernel name, thunk)."""
    g = lambda *s: torch.randn(*s).requires_grad_()  # noqa: E731
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    return [
        ("decode_attention", lambda: da.decode_attention(
            g(1, 1, 2, 64), g(1, 8, 2, 64), g(1, 8, 2, 64), i32(1, 8),
            i32(1))),
        ("paged_decode_attention", lambda: da.paged_decode_attention(
            g(1, 1, 2, 64), g(2, 16, 2, 64), g(2, 16, 2, 64), i32(1, 2),
            i32(1))),
        ("spec_accept", lambda: sv.spec_accept(
            i32(2), g(2, 32), g(3, 32), torch.rand(2))),
        ("rwkv6_scan", lambda: rs.rwkv6_scan(
            g(1, 8, 2, 16), g(1, 8, 2, 16), g(1, 8, 2, 16),
            torch.rand(1, 8, 2, 16), g(2, 16), torch.zeros(1, 2, 16, 16))),
        ("int8_matmul", lambda: im.int8_matmul(
            g(4, 64), torch.zeros((64, 32), dtype=torch.int8),
            torch.ones(32))),
    ]


@pytest.mark.parametrize("name", ["decode_attention", "paged_decode_attention",
                                  "spec_accept", "rwkv6_scan", "int8_matmul"])
def test_kernels_without_a_backward_refuse_autograd(name):
    """Under grad mode, with an input that requires grad, every kernel
    wrapper but flash's and rwkv6_scan's raises ``ValueError`` naming
    itself and ROADMAP Queue 1, before any device check: its output
    would be cut off from the graph with no error.  Under ``no_grad`` the
    refusal is not the one raised (the CPU tensors then meet the device
    check).  rwkv6_scan has its backward kernel (``RWKV6Scan``): under
    grad it meets the device check alone, as under ``no_grad``."""
    call = dict(_kernel_calls())[name]
    if name == "rwkv6_scan":
        for grad in (True, False):
            with torch.set_grad_enabled(grad):
                with pytest.raises(ValueError, match="^rwkv6_scan kernel "
                                                     "needs CUDA tensors"):
                    call()
        return
    with pytest.raises(ValueError, match=rf"^{name}: the CUDA kernel has no "
                                         r"backward.*ROADMAP Queue 1"):
        call()
    with torch.no_grad():
        with pytest.raises(ValueError) as e:
            call()
    assert "no backward" not in str(e.value)


def test_ops_differentiate_the_plain_versions_on_the_cpu():
    """On the CPU ``ops`` runs the plain versions, which autograd
    differentiates: the attention ops' gradients are ``plain_backward``'s."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(32, 32, 4, 2, 64, 9))
    for op, kw in ((ops.attention_causal, dict(causal=True)),
                   (ops.attention_windowed, dict(causal=True, window=8)),
                   (ops.attention_full, dict(causal=False))):
        tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
        extra = {"window": 8} if op is ops.attention_windowed else {}
        o = op(tq, tk, tv, **extra)
        o.backward(do)
        _close([t.grad.numpy() for t in (tq, tk, tv)],
               [g.numpy() for g in fa.plain_backward(q, k, v, o.detach(),
                                                     do, **kw)], op.__name__)
