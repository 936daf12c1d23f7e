"""The port's model on the tiny llama-1.5b, against the JAX package on the
same weights (the JAX ``init_params`` tree carried across the numpy
bridge): prefill logits in f32 and bf16, one paged decode step on the
same pools and page table, and the building blocks."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import forward as jforward  # noqa: E402
from repro.serving.paged import _weave as jweave  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import schema  # noqa: E402
from repro_torch.models.init import (  # noqa: E402
    init_params, params_from_numpy, params_to_numpy)
from repro_torch.models.model import forward as tforward  # noqa: E402
from repro_torch.serving.paged import _weave as tweave  # noqa: E402
from tests.torch_helpers import (  # noqa: E402
    as_f32, bridged_params, configs, to_numpy)

# f32: the two frameworks differ only in summation order.  bf16: every
# activation is rounded to bf16 at slightly different points through two
# layers; the tiny model's logits reach |3.5|, where one bf16 ulp is
# 1/64, so 0.1 is about six ulps (measured: 0.066 max, 0.031 at p99)
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.1}


def test_weight_bridge_round_trip_and_schema():
    jcfg, tcfg = configs()
    jp, tp = bridged_params(jcfg)
    flat_j = schema.flatten(to_numpy(jp))
    flat_t = schema.flatten(tp)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    assert tp["blocks"][0][0]["attn"]["wq"].shape == (2, 64, 4, 16)
    for (_, a), (_, t) in zip(flat_j, flat_t):
        assert tuple(a.shape) == tuple(t.shape)
        want = torch.bfloat16 if a.dtype == np.uint16 else torch.float32
        assert t.dtype == want
    # the reverse bridge gives back the identical bits
    for (_, a), (_, b) in zip(flat_j, schema.flatten(params_to_numpy(tp))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the port's own init builds the same tree, without JAX
    own = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert [(p, tuple(t.shape), t.dtype) for p, t in schema.flatten(own)] \
        == [(p, tuple(t.shape), t.dtype) for p, t in flat_t]
    assert tcfg.param_count() == jcfg.param_count()


def test_param_count_full_size_matches_jax():
    from repro.configs import get as jget
    from repro_torch.configs import get as tget
    assert tget("llama-1.5b").param_count() == jget("llama-1.5b").param_count()
    assert tget("llama-1.5b").active_param_count() \
        == jget("llama-1.5b").active_param_count()


def test_init_rules():
    _, tcfg = configs("float32")
    p = init_params(tcfg, torch.Generator().manual_seed(1), device="cpu")
    assert torch.equal(p["final_norm"]["scale"], torch.ones(64))
    # stacked (R, d, ff): the reference takes fan-in from dim 0 of the
    # stacked shape, i.e. the repeat count R = 2, and so does the port
    w = p["blocks"][0][0]["mlp"]["w_gate"]
    std = 1.0 / np.sqrt(2)
    assert float(w.abs().max()) <= 2 * std + 1e-6      # truncated at 2 std
    assert abs(float(w.std()) - 0.88 * std) < 0.05 * std
    with pytest.raises(ValueError, match="generator"):
        init_params(tcfg, torch.Generator(), device="meta")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_match_jax(dtype):
    jcfg, tcfg = configs(dtype)
    jp, tp = bridged_params(jcfg, seed=2)
    tokens = np.random.default_rng(0).integers(0, 512, (2, 24)).astype(
        np.int32)
    lj, _, _ = jforward(jp, {"tokens": jnp.asarray(tokens)}, cfg=jcfg,
                        mode="prefill")
    lt = tforward(tp, {"tokens": torch.from_numpy(tokens)}, cfg=tcfg,
                  mode="prefill")
    assert lt.shape == (2, 24, tcfg.padded_vocab)
    assert float(np.abs(as_f32(lj) - as_f32(lt)).max()) < LOGIT_TOL[dtype]


def _pools(rng, R, P, ps, KV, D):
    return [rng.standard_normal((R, P, ps, KV, D)).astype(np.float32)
            for _ in range(2)]


def test_paged_decode_step_matches_jax():
    """One decode step on the same woven pools and page table: logits and
    the K/V each row writes, including an inactive row (-1 table) whose
    write must drop."""
    jcfg, tcfg = configs("float32")
    jp, tp = bridged_params(jcfg, seed=3)
    rng = np.random.default_rng(4)
    R, P, ps, NP, B = 2, 12, 8, 4, 3
    kp, vp = _pools(rng, R, P, ps, 2, 16)
    pt = np.full((B, NP), -1, np.int32)
    pt[0, :3] = [5, 1, 9]
    pt[1, :2] = [0, 7]
    pos = np.asarray([[19], [9], [4]], np.int32)       # row 2: dead
    tok = np.asarray([[3], [100], [7]], np.int32)
    jcaches = jweave([[{"attn": {"k_pool": jnp.asarray(kp),
                                 "v_pool": jnp.asarray(vp)}}]],
                     jnp.asarray(pt))
    lj, jnew, _ = jforward(jp, {"tokens": jnp.asarray(tok)}, cfg=jcfg,
                           mode="decode", positions=jnp.asarray(pos),
                           caches=jcaches)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tcaches = tweave([[{"attn": {"k_pool": tk, "v_pool": tv}}]],
                     torch.from_numpy(pt))
    lt = tforward(tp, {"tokens": torch.from_numpy(tok)}, cfg=tcfg,
                  mode="decode", positions=torch.from_numpy(pos),
                  caches=tcaches)
    assert float(np.abs(as_f32(lj) - as_f32(lt)).max()) < 1e-4
    for name, t in (("k_pool", tk), ("v_pool", tv)):
        assert float(np.abs(as_f32(jnew[0][0]["attn"][name])
                            - as_f32(t)).max()) < 1e-5
    # exactly two slots per layer changed: rows 0 and 1; row 2 dropped
    changed = (tk != torch.from_numpy(kp)).any(-1).any(-1)
    assert int(changed.sum()) == 2 * R
    assert bool(changed[:, 9, 19 % ps].all())
    assert bool(changed[:, 7, 9 % ps].all())


def test_write_pages_drops_dead_and_out_of_table_writes():
    pool = torch.zeros((4, 2, 1, 1))
    cache = {"k_pool": pool, "v_pool": pool.clone(),
             "page_table": torch.tensor([[2, -1], [-1, -1], [3, 0]],
                                        dtype=torch.int32)}
    k = torch.arange(1, 7, dtype=torch.float32).reshape(3, 2, 1, 1)
    pos = torch.tensor([[1, 2], [0, 1], [3, 4]])     # 4: past the table
    tlayers._write_pages(cache, k, k, pos)
    want = torch.zeros((4, 2))
    want[2, 1] = 1          # row 0, pos 1 -> page 2 offset 1; pos 2 drops
    want[0, 1] = 5          # row 2, pos 3 -> page 0 offset 1; pos 4 drops
    assert torch.equal(pool[..., 0, 0], want)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_apply_matches_jax(act):
    """jax.nn.gelu is the tanh approximation; the port must match it."""
    jcfg, tcfg = configs("float32")
    jcfg, tcfg = jcfg.replace(act=act), tcfg.replace(act=act)
    rng = np.random.default_rng(6)
    p = {n: rng.standard_normal(s).astype(np.float32) * 0.3
         for n, s in (("w_gate", (64, 256)), ("w_up", (64, 256)),
                      ("w_down", (256, 64)))}
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 2
    oj = jlayers.mlp_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                           jcfg)
    ot = tlayers.mlp_apply(params_from_numpy(p, device="cpu"),
                           torch.from_numpy(x), tcfg)
    assert float(np.abs(as_f32(oj) - as_f32(ot)).max()) < 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_rope_match_jax(dtype):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    scale = rng.standard_normal((16,)).astype(np.float32)
    pos = rng.integers(0, 3000, (2, 7)).astype(np.int32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    xj, xt = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    t = 2e-2 if dtype == "bfloat16" else 1e-5
    nj = jlayers.rmsnorm(xj, jnp.asarray(scale), 1e-6)
    nt = tlayers.rmsnorm(xt, torch.from_numpy(scale), 1e-6)
    assert nt.dtype == td
    assert float(np.abs(as_f32(nj) - as_f32(nt)).max()) < t * 4
    rj = jlayers.rope(xj, jnp.asarray(pos))
    rt = tlayers.rope(xt, torch.from_numpy(pos))
    assert rt.dtype == td
    assert float(np.abs(as_f32(rj) - as_f32(rt)).max()) < t * 4
