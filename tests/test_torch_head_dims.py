"""The three attention kernels' plain versions at head dims 160
(stablelm-12b) and 256 (gemma3-4b), against the Pallas kernels in
interpret mode (as tests/test_kernels.py runs them on the CPU) and the
JAX oracles, and the CUDA kernels' split arithmetic (``split_plain``,
``paged_split_plain``) against the plain versions at those dims.  Every
group size the kernels take (G = 1, 2, 4, 8).  Tolerances as in the
reference tests: f32 2e-5 abs, bf16 2e-2 abs.  The CUDA kernels
themselves are held to these plain versions on the card by
tests/test_torch_cuda_kernels.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import \
    decode_attention as jax_decode  # noqa: E402
from repro.kernels.decode_attention import \
    paged_decode_attention as jax_paged  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as jax_flash  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

WIDE = (160, 256)
GROUPS = (1, 2, 4, 8)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MODES = {"causal": dict(causal=True),
         "window": dict(causal=True, window=16),
         "softcap": dict(causal=True, softcap=50.0),
         "full": dict(causal=False)}


def tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def both(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def err(jax_out, torch_out) -> float:
    a = np.asarray(jnp.asarray(jax_out, jnp.float32))
    return float(np.abs(a - torch_out.float().numpy()).max())


def test_the_wrappers_take_the_new_head_dims():
    assert {160, 256} <= set(fa.HEAD_DIMS)
    assert {160, 256} <= set(da.HEAD_DIMS)
    assert da.MAX_GROUP == 8


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("D", WIDE)
def test_flash_plain_matches_pallas_interpret(D, mode, dtype):
    """S = 64 over blocks of 32, GQA 4:2."""
    rng = np.random.default_rng(D)
    B, S, H, KV = 1, 64, 4, 2
    (qj, qt), (kj, kt), (vj, vt) = (both(rng, s, dtype) for s in (
        (B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    kw = MODES[mode]
    o_jax = jax_flash(qj, kj, vj, block_q=32, block_k=32, interpret=True,
                      **kw)
    o_port = fa.plain(qt, kt, vt, **kw)
    assert o_port.dtype == DTYPES[dtype][1]
    assert err(o_jax, o_port) < tol(dtype), mode


def _dense(D, G, mode, dtype, rng):
    """q, k, v, abs_pos, positions as (jax, torch) pairs, and kw: rows
    filled to 1, 37 and 128 slots with rolled-back slots past the
    position, or a 32-slot ring buffer (``window``)."""
    B, KV = 3, 2
    slot = np.arange(128)[None]
    if mode == "window":
        Sc, kw = 32, dict(window=32)
        pos = np.asarray([100, 31, 9], np.int32)
        p = pos[:, None] - ((pos[:, None] - slot[:, :Sc]) % Sc)
        ap = np.where(p >= 0, p, -1).astype(np.int32)
    else:
        Sc = 128
        kw = dict(softcap=50.0) if mode == "softcap" else {}
        fill = np.asarray([1, 37, 128])
        ap = np.where(slot < np.minimum(fill + 4, Sc)[:, None], slot,
                      -1).astype(np.int32)
        pos = (fill - 1).astype(np.int32)
    q, k, v = (both(rng, s, dtype) for s in (
        (B, 1, G * KV, D), (B, Sc, KV, D), (B, Sc, KV, D)))
    return (q, k, v, (jnp.asarray(ap), torch.from_numpy(ap)),
            (jnp.asarray(pos), torch.from_numpy(pos)), kw)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["fill", "window", "softcap"])
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("D", WIDE)
def test_decode_plain_matches_pallas_interpret(D, G, mode, dtype):
    (qj, qt), (kj, kt), (vj, vt), (aj, at), (pj, pt), kw = _dense(
        D, G, mode, dtype, np.random.default_rng(D + G))
    o_port = da.plain(qt, kt, vt, at, pt, **kw)
    o_pallas = jax_decode(qj, kj, vj, aj, pj, block_k=32, interpret=True,
                          **kw)
    o_oracle = jax_attn.decode_attend(qj, kj, vj, aj, pj, **kw)
    assert err(o_pallas, o_port) < tol(dtype)
    assert err(o_oracle, o_port) < tol(dtype)
    # the CUDA kernel's split arithmetic, chunks of 32 slots
    o_split = da.split_plain(qt, kt, vt, at, pt, chunk=32, **kw)
    assert float((o_split.float() - o_port.float()).abs().max()) < tol(dtype)


def _paged(D, G, mode, dtype, rng):
    """A table with a hole, a short row and a dead row (exactly 0)."""
    P, ps, NP, B, KV = 12, 8, 6, 3, 2
    q, k, v = (both(rng, s, dtype) for s in (
        (B, 1, G * KV, D), (P, ps, KV, D), (P, ps, KV, D)))
    pt = np.full((B, NP), -1, np.int32)
    pt[0] = rng.choice(P, NP, replace=False)
    pt[0, 2] = -1
    pt[1, :3] = rng.choice(P, 3, replace=False)
    pos = np.asarray([NP * ps - 1, 2 * ps + 3, 0], np.int32)
    kw = {"window": dict(window=ps + 5),
          "softcap": dict(softcap=50.0)}.get(mode, {})
    return q, k, v, pt, pos, kw


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["plain", "window", "softcap"])
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("D", WIDE)
def test_paged_plain_matches_pallas_interpret(D, G, mode, dtype):
    (qj, qt), (kj, kt), (vj, vt), pt, pos, kw = _paged(
        D, G, mode, dtype, np.random.default_rng(D * G))
    pt_t, pos_t = torch.from_numpy(pt), torch.from_numpy(pos)
    o_port = da.paged_plain(qt, kt, vt, pt_t, pos_t, **kw)
    o_jax = jax_paged(qj, kj, vj, jnp.asarray(pt), jnp.asarray(pos),
                      interpret=True, **kw)
    assert err(o_jax, o_port) < tol(dtype), mode
    assert float(o_port[2].float().abs().max()) == 0.0    # dead row
    # the CUDA kernel's split arithmetic, runs of two pages
    o_split = da.paged_split_plain(qt, kt, vt, pt_t, pos_t, slots=16, **kw)
    assert err(np.asarray(jnp.asarray(o_jax, jnp.float32))[:2],
               o_split[:2]) < tol(dtype)
    assert float(o_split[2].float().abs().max()) == 0.0
