"""The six attention-only families beyond llama-1.5b (gemma2-27b,
gemma3-4b, stablelm-12b, deepseek-7b, granite-moe-1b-a400m,
deepseek-moe-16b) in the port, against the JAX package: the configs at
full size and through ``make_tiny``, the weight bridge, and on the same
(bridged) weights the prefill logits and one dense and one paged decode
step of each tiny family, plus one case at each new head dim
(``make_tiny(gemma3-4b, d_model=1024)``: D = 256;
``make_tiny(stablelm-12b, d_model=640)``: D = 160).  The counterpart of
``tests/test_arch_smoke.py::test_forward_shapes_no_nans`` for these six.

Tolerances.  f32 logits: ``LOGIT_TOL`` of tests/test_torch_model.py
(1e-4); 3e-4 for the two MoE families, whose tiny configs give the expert
weights std 0.7 (the init takes fan-in from the stacked repeat axis), so
the residual stream reaches O(300) and f32 summation order alone moves a
logit by up to 1.41e-4 (granite, the worst of 18 seed and prompt pairs
on the CPU; the dense families' worst is 7.1e-5).  bf16 logits: the two
frameworks round at other points (JAX's blockwise softmax on the CPU
among them), and over the 16 layers of tiny gemma3 neither package's
bf16 logits stay within 0.1 of its f32 ones (JAX's move by 0.28-0.38 on
these seeds, on the CPU), so the port's bf16 logits are held to JAX's
own bf16 error: no farther from the f32 reference than 1.5x JAX's
distance, plus 0.1.  Cache leaves written by a step: 2e-5 (the f32
kernel tolerance) of the largest |value|, which reaches O(10-100) in
the tiny models' K.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.configs.tiny import make_tiny as jtiny  # noqa: E402
from repro.models.init import init_params as jinit  # noqa: E402
from repro.models.model import forward as jforward  # noqa: E402
from repro.models.model import make_cache as jmake_cache  # noqa: E402
from repro.serving.paged import _weave as jweave  # noqa: E402
from repro_torch.configs import get, names  # noqa: E402
from repro_torch.configs.tiny import make_tiny  # noqa: E402
from repro_torch.models import schema  # noqa: E402
from repro_torch.models.init import (  # noqa: E402
    init_params, params_from_numpy, params_to_numpy)
from repro_torch.models.model import forward as tforward  # noqa: E402
from repro_torch.models.model import make_cache  # noqa: E402
from repro_torch.serving.paged import _weave as tweave  # noqa: E402
from tests.torch_helpers import as_f32, to_numpy  # noqa: E402

FAMILIES = ["gemma2-27b", "gemma3-4b", "stablelm-12b", "deepseek-7b",
            "granite-moe-1b-a400m", "deepseek-moe-16b"]
# (family, tiny d_model): d_model / 4 heads is the head dim
CASES = [(n, 64) for n in FAMILIES] + [("gemma3-4b", 1024),
                                       ("stablelm-12b", 640)]
CASE_IDS = [f"{n}-d{d}" for n, d in CASES]
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.1}

# the full configurations: (params in billions to 2 places, active
# params, head dim, group size, padded vocab, layers, KV bytes a token)
FULL = {"gemma2-27b": (28.41, 28.41, 128, 2, 256000, 46, 376832),
        "gemma3-4b": (4.55, 4.55, 256, 2, 262144, 34, 139264),
        "stablelm-12b": (12.14, 12.14, 160, 4, 100352, 40, 204800),
        "deepseek-7b": (6.91, 6.91, 128, 1, 102400, 30, 491520),
        "granite-moe-1b-a400m": (1.34, 0.43, 64, 2, 50176, 24, 49152),
        "deepseek-moe-16b": (16.38, 2.83, 128, 1, 102400, 28, 229376),
        "whisper-base": (0.11, 0.11, 64, 1, 52224, 6, 12288),
        "internvl2-26b": (19.88, 19.88, 128, 6, 93184, 48, 196608)}

_PAIRS = {}


def pair(name, d_model=64, dtype="float32", seed=1):
    """Both packages' tiny config and the JAX weights bridged into torch,
    built once a module."""
    key = (name, d_model, dtype, seed)
    if key not in _PAIRS:
        jc = jtiny(jget(name), d_model=d_model).replace(dtype=dtype)
        tc = make_tiny(get(name), d_model=d_model).replace(dtype=dtype)
        jp = jinit(jc, jax.random.key(seed))
        _PAIRS[key] = (jc, tc, jp,
                       params_from_numpy(to_numpy(jp), device="cpu"))
    return _PAIRS[key]


def f32_tol(cfg) -> float:
    return 3e-4 if cfg.moe is not None else LOGIT_TOL["float32"]


def _rel_err(a, t) -> float:
    """Max |a - t| over max(1, max |a|): a cache leaf's K/V values."""
    a = np.asarray(a)
    return float(np.abs(a - t.numpy()).max()) / max(1.0,
                                                    float(np.abs(a).max()))


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


# -- configs ---------------------------------------------------------------------

def test_the_port_registers_the_six_families():
    """... and, since whisper-base and internvl2-26b, every config the
    JAX package registers."""
    from repro.configs import names as jnames
    assert set(FAMILIES) <= set(names())
    assert names() == jnames()


@pytest.mark.parametrize("name", FAMILIES + ["whisper-base",
                                             "internvl2-26b"])
def test_config_parity_full_and_tiny(name):
    for jc, tc in ((jget(name), get(name)),
                   (jtiny(jget(name)), make_tiny(get(name))),
                   (jtiny(jget(name), d_model=256),
                    make_tiny(get(name), d_model=256))):
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        assert tc.num_layers == jc.num_layers
        assert tc.padded_vocab == jc.padded_vocab
        assert [(s.mixer, s.ffn, s.window) for s in tc.layer_specs()] == \
            [(s.mixer, s.ffn, s.window) for s in jc.layer_specs()]
        for f in ("d_model", "num_heads", "num_kv_heads", "head_dim",
                  "d_ff", "vocab_size", "act", "qk_norm", "attn_softcap",
                  "logit_softcap", "rope_theta", "tie_embeddings",
                  "decoder_len", "cross_attention", "num_patches"):
            assert getattr(tc, f) == getattr(jc, f), f
        assert [(b.repeats, [(s.mixer, s.ffn) for s in b.layers])
                for b in tc.encoder_blocks] == \
            [(b.repeats, [(s.mixer, s.ffn) for s in b.layers])
             for b in jc.encoder_blocks]
    cfg = get(name)
    params, active, D, G, vpad, layers, kv_bytes = FULL[name]
    assert round(cfg.param_count() / 1e9, 2) == params
    assert round(cfg.active_param_count() / 1e9, 2) == active
    assert cfg.head_dim == D
    assert cfg.num_heads // cfg.num_kv_heads == G
    assert cfg.padded_vocab == vpad and cfg.num_layers == layers
    assert 2 * 2 * cfg.num_layers * cfg.num_kv_heads * D == kv_bytes


@pytest.mark.parametrize("name,d_model", [("gemma3-4b", 1024),
                                          ("stablelm-12b", 640)])
def test_tiny_head_dims_of_the_new_kernel_instances(name, d_model):
    cfg = make_tiny(get(name), d_model=d_model)
    assert cfg.head_dim == get(name).head_dim


# -- the weight bridge -------------------------------------------------------------

@pytest.mark.parametrize("name", FAMILIES)
def test_weight_bridge_round_trip(name):
    jc, tc, jp, tp = pair(name, dtype="bfloat16")
    flat_j = schema.flatten(to_numpy(jp))
    flat_t = schema.flatten(tp)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (_, a), (_, t) in zip(flat_j, flat_t):
        assert tuple(a.shape) == tuple(t.shape)
        want = torch.bfloat16 if a.dtype == np.uint16 else torch.float32
        assert t.dtype == want
    for (_, a), (_, b) in zip(flat_j, schema.flatten(params_to_numpy(tp))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    own = init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    assert [(p, tuple(t.shape), t.dtype) for p, t in schema.flatten(own)] \
        == [(p, tuple(t.shape), t.dtype) for p, t in flat_t]
    assert sum(math.prod(t.shape) for _, t in flat_t) == tc.param_count()
    # the family's own leaves
    paths = {"/".join(map(str, p)): t for p, t in flat_t}
    R, d = tc.blocks[-1].repeats, tc.d_model
    if tc.moe is not None:
        m = tc.moe
        g = len(tc.blocks) - 1
        leaf = lambda k: paths[f"blocks/{g}/0/moe/{k}"]  # noqa: E731
        assert leaf("router").shape == (R, d, m.num_experts)
        assert leaf("router").dtype == torch.float32
        assert leaf("w_gate").shape == (R, m.num_experts, d, m.d_expert)
        assert leaf("w_down").shape == (R, m.num_experts, m.d_expert, d)
        assert (f"blocks/{g}/0/moe/shared/w_up" in paths) == bool(
            m.num_shared)
    if tc.qk_norm:
        assert paths["blocks/0/0/attn/q_norm"].shape == (
            tc.blocks[0].repeats, tc.head_dim)
        assert paths["blocks/0/0/attn/k_norm"].dtype == torch.float32
    assert ("lm_head" in tp) == (not tc.tie_embeddings)


# -- the forward, the same weights in both packages ------------------------------

@pytest.mark.parametrize("name,d_model", CASES, ids=CASE_IDS)
def test_prefill_logits_match_jax_f32(name, d_model):
    """40 tokens: past the tiny local window of 32."""
    jc, tc, jp, tp = pair(name, d_model)
    tokens = _tokens(2, 40)

    lj = jforward(jp, {"tokens": jnp.asarray(tokens)}, cfg=jc,
                  mode="prefill")[0]
    lt = tforward(tp, {"tokens": torch.from_numpy(tokens)}, cfg=tc,
                  mode="prefill")
    assert lt.shape == (2, 40, tc.padded_vocab)
    assert bool(torch.isfinite(lt).all())
    err = float(np.abs(as_f32(lj) - as_f32(lt)).max())
    assert err < f32_tol(tc), err


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_logits_bf16_as_accurate_as_jax(name):
    jc, tc, jp, tp = pair(name, dtype="bfloat16")
    jc32 = jc.replace(dtype="float32")
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32)
                        if a.dtype == jnp.bfloat16 else a, jp)
    tokens = _tokens(2, 40)
    batch = {"tokens": jnp.asarray(tokens)}
    l32 = as_f32(jforward(jp32, batch, cfg=jc32, mode="prefill")[0])
    lj = as_f32(jforward(jp, batch, cfg=jc, mode="prefill")[0])
    lt = tforward(tp, {"tokens": torch.from_numpy(tokens)}, cfg=tc,
                  mode="prefill")
    assert lt.dtype == torch.bfloat16
    jax_err = float(np.abs(lj - l32).max())
    port_err = float(np.abs(as_f32(lt) - l32).max())
    assert port_err <= 1.5 * jax_err + LOGIT_TOL["bfloat16"], \
        (port_err, jax_err)


@pytest.mark.parametrize("name,d_model", CASES, ids=CASE_IDS)
def test_dense_decode_step_matches_jax(name, d_model):
    """Prefill 40 tokens into each package's dense cache (local layers'
    32-slot ring buffers overflow), then one decode step: logits and every
    cache leaf."""
    jc, tc, jp, tp = pair(name, d_model)
    tokens = _tokens(2, 40, seed=1)
    nxt = np.asarray([[7], [300]], np.int32)
    pos = np.full((2, 1), 40, np.int32)
    _, jcache, _ = jforward(jp, {"tokens": jnp.asarray(tokens)}, cfg=jc,
                            mode="prefill", caches=jmake_cache(jc, 2, 64))

    lj, jnew, _ = jforward(jp, {"tokens": jnp.asarray(nxt)}, cfg=jc,
                           mode="decode", positions=jnp.asarray(pos),
                           caches=jcache)
    tcache = make_cache(tc, 2, 64, device="cpu")
    with torch.no_grad():
        tforward(tp, {"tokens": torch.from_numpy(tokens)}, cfg=tc,
                 mode="prefill", caches=tcache)
        lt = tforward(tp, {"tokens": torch.from_numpy(nxt)}, cfg=tc,
                      mode="decode", positions=torch.from_numpy(pos),
                      caches=tcache)
    err = float(np.abs(as_f32(lj) - as_f32(lt)).max())
    assert err < f32_tol(tc), err
    for g, grp in enumerate(tcache):
        for li, layer in enumerate(grp):
            for key, t in layer["attn"].items():
                a = np.asarray(jnew[g][li]["attn"][key])
                if key == "abs_pos":
                    assert np.array_equal(a, t.numpy()), (g, li)
                else:
                    assert _rel_err(a, t) < 2e-5, (g, li, key)


@pytest.mark.parametrize("name,d_model", CASES, ids=CASE_IDS)
def test_paged_decode_step_matches_jax(name, d_model):
    """One decode step on the same woven pools and page table: rows past
    the local window, a row mid-page, and a dead row (-1 table) whose
    write must drop."""
    jc, tc, jp, tp = pair(name, d_model)
    rng = np.random.default_rng(4)
    P, ps, NP, B = 24, 8, 8, 3
    KV, D = tc.num_kv_heads, tc.head_dim
    pools = [[[rng.standard_normal((b.repeats, P, ps, KV, D)).astype(
        np.float32) for _ in range(2)] for _ in b.layers] for b in tc.blocks]
    pt = np.full((B, NP), -1, np.int32)
    pt[0, :7] = rng.choice(P, 7, replace=False)
    pt[1, :5] = rng.choice(P, 5, replace=False)
    pos = np.asarray([[50], [37], [4]], np.int32)
    tok = np.asarray([[3], [100], [7]], np.int32)

    def jcaches():
        return jweave([[{"attn": {"k_pool": jnp.asarray(k),
                                  "v_pool": jnp.asarray(v)}}
                        for k, v in grp] for grp in pools],
                      jnp.asarray(pt))

    lj, jnew, _ = jforward(jp, {"tokens": jnp.asarray(tok)}, cfg=jc,
                           mode="decode", positions=jnp.asarray(pos),
                           caches=jcaches())
    tpools = [[(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
               for k, v in grp] for grp in pools]
    tcaches = tweave([[{"attn": {"k_pool": k, "v_pool": v}}
                       for k, v in grp] for grp in tpools],
                     torch.from_numpy(pt))
    with torch.no_grad():
        lt = tforward(tp, {"tokens": torch.from_numpy(tok)}, cfg=tc,
                      mode="decode", positions=torch.from_numpy(pos),
                      caches=tcaches)
    err = float(np.abs(as_f32(lj) - as_f32(lt)).max())
    assert err < f32_tol(tc), err
    for g, grp in enumerate(tpools):
        for li, (k, v) in enumerate(grp):
            for key, t in (("k_pool", k), ("v_pool", v)):
                a = np.asarray(jnew[g][li]["attn"][key])
                assert _rel_err(a, t) < 2e-5, (g, li, key)
            # rows 0 and 1 wrote one slot each; the dead row's write dropped
            changed = (k != torch.from_numpy(pools[g][li][0])).any(-1).any(-1)
            assert int(changed.sum()) == 2 * k.shape[0]
