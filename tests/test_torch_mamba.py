"""The port's mamba mixer (``repro_torch.models.mamba``, the mamba branch
of ``models.layers``) on the tiny jamba-v0.1-52b, against the JAX
package's ``models/mamba.py`` on the same bridged weights: the chunked
scan and the decode step in f32 and bf16, with a carried state and conv
tail, over one chunk and several; prefill-then-decode against the
teacher-forced forward within the port; the scan's chunk domain in both
packages; the mamba cache and its masked writes; the config.

Tolerances.  f32: relative to the largest |ref| (``F32_REL``), since at
the reference init the SSM state reaches the thousands and the
projections' outputs the millions (the stacked fan-in makes them large),
where the summation order of a matmul alone moves a few f32 ulps.  bf16:
the port's bf16 run against JAX's f32 run within twice JAX's own bf16
error against that f32 run (``BF16_OWN``; measured up to 1.33 x).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.configs.tiny import make_tiny as jtiny  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models.init import init_params as jinit  # noqa: E402
from repro.models.model import make_cache as jmake_cache  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.configs.base import BlockDef  # noqa: E402
from repro_torch.configs.tiny import make_tiny as ttiny  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import schema  # noqa: E402
from repro_torch.models.init import params_from_numpy  # noqa: E402
from repro_torch.models.model import forward as tforward  # noqa: E402
from repro_torch.models.model import make_cache  # noqa: E402
from tests.torch_helpers import as_f32, to_numpy  # noqa: E402

NAME = "jamba-v0.1-52b"
F32_REL = 2e-6           # f32, relative to max |ref| (measured <= 5e-7)
BF16_OWN = 2.0           # bf16 vs JAX's f32: x JAX's own bf16 error
_PAIRS = {}


def pair(dtype="float32", seed=0):
    """The tiny jamba of both packages on bridged weights: (jcfg, tcfg,
    jax params, torch params), shared within the module."""
    key = (dtype, seed)
    if key not in _PAIRS:
        jcfg = jtiny(jget(NAME)).replace(dtype=dtype)
        tcfg = ttiny(tget(NAME)).replace(dtype=dtype)
        jp = jinit(jcfg, jax.random.key(seed))
        _PAIRS[key] = (jcfg, tcfg, jp,
                       params_from_numpy(to_numpy(jp), device="cpu"))
    return _PAIRS[key]


def mixer(tree):
    """Repeat 0 of the first layer's mamba params (either package)."""
    sub = tree["blocks"][0][0]["mamba"]
    if isinstance(sub["in_proj"], torch.Tensor):
        return schema.tree_map(lambda a: a[0], sub)
    return jax.tree.map(lambda a: a[0], sub)


def err(a, b) -> float:
    return float(np.abs(as_f32(a) - as_f32(b)).max())


def rel(ref, out) -> float:
    return err(ref, out) / max(1.0, float(np.abs(as_f32(ref)).max()))


def inputs(cfg, B, T, seed, carried):
    """x (B,T,d), and a carried (state, conv tail) or Nones, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    if not carried:
        return x, None, None
    state = (rng.standard_normal((B, cfg.d_inner, cfg.mamba_d_state))
             * 100).astype(np.float32)
    tail = rng.standard_normal((B, cfg.mamba_d_conv - 1, cfg.d_inner)
                               ).astype(np.float32)
    return x, state, tail


def both(fn_j, fn_t, dtype, x, state, tail, **kw):
    """Run the JAX and the port form on the same inputs in ``dtype``."""
    jdt = jnp.dtype(dtype)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jcfg, tcfg, jp, tp = pair(dtype)
    jkw = {} if state is None else dict(
        state=jnp.asarray(state), conv_tail=jnp.asarray(tail, jdt))
    tkw = {} if state is None else dict(
        state=torch.from_numpy(state),
        conv_tail=torch.from_numpy(tail).to(tdt))
    oj = fn_j(mixer(jp), jnp.asarray(x, jdt), jcfg, **jkw, **kw)
    ot = fn_t(mixer(tp), torch.from_numpy(x).to(tdt), tcfg, **tkw, **kw)
    return oj, ot


# -- the config ---------------------------------------------------------------

def test_jamba_config_and_param_count_match_jax():
    for jcfg, tcfg in ((jget(NAME), tget(NAME)),
                       (jtiny(jget(NAME)), ttiny(tget(NAME)))):
        for attr in ("param_count", "active_param_count"):
            assert getattr(tcfg, attr)() == getattr(jcfg, attr)()
        for attr in ("num_layers", "padded_vocab", "d_inner",
                     "mamba_d_state", "mamba_d_conv", "family"):
            assert getattr(tcfg, attr) == getattr(jcfg, attr), attr
        assert [(ls.mixer, ls.ffn) for ls in tcfg.layer_specs()] == \
            [(ls.mixer, ls.ffn) for ls in jcfg.layer_specs()]
    full = tget(NAME)
    assert full.param_count() == 51_570_315_264
    cut = full.replace(blocks=(BlockDef(full.blocks[0].layers, repeats=2),))
    assert cut.param_count() == 26_053_595_136         # chip_smoke's cut
    tiny = ttiny(full)
    assert (tiny.d_model, tiny.d_inner, tiny.mamba_d_state,
            tiny.blocks[0].repeats, tiny.moe.num_experts,
            tiny.moe.top_k) == (64, 128, 4, 2, 8, 2)
    _, _, _, tp = pair()
    m = mixer(tp)
    assert m["in_proj"].shape == (64, 2, 128)
    assert m["A_log"].dtype == torch.float32
    assert torch.equal(m["A_log"][0], torch.log(torch.arange(1.0, 5.0)))


# -- the scan and the step ----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,carried", [
    (37, False),         # T <= 64: one chunk of its own length
    (64, True),          # one whole chunk from a carried state
    (192, True),         # three chunks
])
def test_mamba_parallel_matches_jax(dtype, T, carried):
    x, state, tail = inputs(pair()[1], 2, T, T, carried)
    (oj, sj, cj), (ot, st, ct) = both(jmamba.mamba_parallel,
                                      tmamba.mamba_parallel, dtype, x,
                                      state, tail)
    assert ot.shape == (2, T, 64) and st.dtype == torch.float32
    assert ct.shape == (2, 3, 128) and str(ct.dtype).endswith(dtype)
    if dtype == "float32":
        assert rel(oj, ot) < F32_REL and rel(sj, st) < F32_REL
        assert err(cj, ct) == 0.0
        return
    (fo, fs, _), _ = both(jmamba.mamba_parallel, tmamba.mamba_parallel,
                          "float32", x, state, tail)
    assert err(cj, ct) == 0.0          # the tail is the input, exactly
    for j, t, f in ((oj, ot, fo), (sj, st, fs)):
        assert err(f, t) <= BF16_OWN * err(f, j), (err(f, t), err(f, j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_step_matches_jax(dtype):
    x, state, tail = inputs(pair()[1], 3, 1, 5, True)
    (oj, sj, cj), (ot, st, ct) = both(jmamba.mamba_step, tmamba.mamba_step,
                                      dtype, x, state, tail)
    assert ot.shape == (3, 1, 64)
    assert err(cj, ct) == 0.0
    if dtype == "float32":
        assert rel(oj, ot) < F32_REL and rel(sj, st) < F32_REL
        return
    (fo, fs, _), _ = both(jmamba.mamba_step, tmamba.mamba_step, "float32",
                          x, state, tail)
    for j, t, f in ((oj, ot, fo), (sj, st, fs)):
        assert err(f, t) <= BF16_OWN * err(f, j), (err(f, t), err(f, j))


def test_parallel_equals_stepping_the_recurrence():
    """Within the port: a 128-token scan (two chunks) from a carried
    state ends where 128 ``mamba_step`` calls end, and emits their
    outputs (f32)."""
    _, tcfg, _, tp = pair()
    x, state, tail = (torch.from_numpy(a) for a in
                      inputs(tcfg, 2, 128, 11, True))
    out, st, ct = tmamba.mamba_parallel(mixer(tp), x, tcfg, state=state,
                                        conv_tail=tail)
    s, c, outs = state, tail, []
    for t in range(128):
        o, s, c = tmamba.mamba_step(mixer(tp), x[:, t:t + 1], tcfg,
                                    state=s, conv_tail=c)
        outs.append(o)
    assert rel(torch.cat(outs, 1), out) < F32_REL
    assert rel(s, st) < F32_REL and torch.equal(c, ct)


def test_chunk_domain_refused_in_both_packages():
    """A 100-token scan: the JAX package asserts, the port raises
    ``ValueError``; 64 and under, and multiples of 64, are taken."""
    jcfg, tcfg, jp, tp = pair()
    x = np.zeros((1, 100, 64), np.float32)
    with pytest.raises(AssertionError):
        jmamba.mamba_parallel(mixer(jp), jnp.asarray(x), jcfg)
    with pytest.raises(ValueError, match="mamba scan's domain"):
        tmamba.mamba_parallel(mixer(tp), torch.from_numpy(x), tcfg)
    for T in (1, 37, 64, 128, 640):
        ops.check_chunks(T)
    for T in (65, 100, 700):
        with pytest.raises(ValueError):
            ops.check_chunks(T)
    # the model's rule: attention's and the scan's; rwkv takes any length
    ops.check_domain(1024, cfg=tcfg)
    for S in (100, 700):
        with pytest.raises(ValueError):
            ops.check_domain(S, cfg=tcfg)
    ops.check_domain(100, 700, cfg=ttiny(tget("rwkv6-7b")))
    ops.check_domain(100, cfg=ttiny(tget("llama-1.5b")))
    with pytest.raises(ValueError, match="multiple of 512"):
        ops.check_domain(700, cfg=ttiny(tget("llama-1.5b")))


# -- the cache and the layer --------------------------------------------------

def test_mamba_cache_layout_and_masked_writes():
    jcfg, tcfg, _, _ = pair("bfloat16")
    jc = jmake_cache(jcfg, 3, 16)[0][0]["mamba"]
    tc = make_cache(tcfg, 3, 16, device="cpu")[0][0]["mamba"]
    for key in ("ssm", "conv"):
        assert tuple(jc[key].shape) == tuple(tc[key].shape)
        assert str(jc[key].dtype) == str(tc[key].dtype).split(".")[-1]
        assert not tc[key].any()
    assert tuple(tc["ssm"].shape) == (2, 3, 128, 4)
    assert tc["conv"].dtype == torch.bfloat16
    cache = tlayers.make_mamba_cache(tcfg, 3, device="cpu")
    old = {k: v.clone() for k, v in cache.items()}
    cache["write"] = torch.tensor([True, False, True])
    new = {k: torch.full_like(v, 2.0) for k, v in old.items()}
    tlayers._write_state(cache, ssm=new["ssm"], conv=new["conv"])
    for key in new:
        assert torch.equal(cache[key][[0, 2]], new[key][[0, 2]])
        assert torch.equal(cache[key][1], old[key][1])       # masked row


def test_prefill_decode_matches_full_forward():
    """The port's twin of ``tests/test_arch_smoke.py::
    test_prefill_decode_matches_full_forward[jamba-v0.1-52b]``: a
    24-token prefill into the caches, then three decode steps, against
    the teacher-forced forward of all 27 tokens (f32, the JAX test's
    1e-3)."""
    tcfg = ttiny(tget(NAME)).replace(dtype="float32")
    jcfg = jtiny(jget(NAME)).replace(dtype="float32")
    tp = params_from_numpy(to_numpy(jinit(jcfg, jax.random.key(1))),
                           device="cpu")
    rng = np.random.default_rng(0)
    B, S, extra = 2, 24, 3
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab_size,
                                         (B, S + extra)).astype(np.int64))
    full = tforward(tp, {"tokens": toks}, cfg=tcfg, mode="train")
    caches = make_cache(tcfg, B, S + extra + 4, device="cpu")
    lg = tforward(tp, {"tokens": toks[:, :S]}, cfg=tcfg, mode="prefill",
                  caches=caches)
    errs = [err(lg[:, -1], full[:, S - 1])]
    for t in range(extra):
        pos = torch.full((B, 1), S + t, dtype=torch.int32)
        lgd = tforward(tp, {"tokens": toks[:, S + t:S + t + 1]}, cfg=tcfg,
                       mode="decode", caches=caches, positions=pos)
        errs.append(err(lgd[:, 0], full[:, S + t]))
    assert max(errs) < 1e-3, errs
    assert caches[0][0]["mamba"]["ssm"].abs().max() > 0


def port_input_errors(seed, tokens_seed=1, T=64) -> list:
    """Tiny jamba's layers in train mode along the port's own chain (each
    layer on the port's output of the layer before): for each layer in
    order, the port's layer against JAX's layer on that same input,
    relative to max |JAX's|.  The inputs and weights are
    ``chain_errors``'s."""
    from repro.models import layers as jlayers
    from repro_torch.models.schema import tree_map
    from tests.test_torch_jamba import pair as jamba_pair
    jcfg, tcfg, jp, tp = jamba_pair(seed=seed)
    tokens = np.random.default_rng(tokens_seed).integers(0, 512, (2, T))
    xt = torch.from_numpy(np.array(jnp.asarray(np.asarray(jp["embed"])
                                               [tokens])))
    pos = jnp.broadcast_to(jnp.arange(T)[None], (2, T))
    tpos = torch.arange(T)[None].expand(2, T)
    same = []
    for r in range(jcfg.blocks[0].repeats):
        for li, ls in enumerate(jcfg.blocks[0].layers):
            oj = jlayers.layer_apply(
                jax.tree.map(lambda a: a[r], jp["blocks"][0][li]),
                jnp.asarray(xt.numpy()), cfg=jcfg, lspec=ls, mode="train",
                positions=pos)[0]
            xt, _ = tlayers.layer_apply(
                tree_map(lambda a: a[r], tp["blocks"][0][li]), xt, cfg=tcfg,
                lspec=tcfg.blocks[0].layers[li], mode="train",
                positions=tpos)
            same.append(rel(oj, xt))
    return same


def test_jamba_chained_error_is_the_references_own_amplification():
    """Where the chained f32 error of tiny jamba grows (weight seed 2,
    the worst reading: 5.4e-5 of max |ref| into layer 11, a mamba
    mixer, 3.0e-4 out of it), JAX's own layer on the port's chained
    input moves as far from JAX's chain: on every input the chain
    visits, the port's layer stays within ``LAYER_REL`` of JAX's layer
    on that same input (``port_input_errors``).  No op of the port
    departs from the reference's order; the growth is the reference
    function's sensitivity to its input (ROADMAP Queue 3)."""
    from tests.test_torch_jamba import LAYER_REL, chain_errors
    local, chained, _ = chain_errors(seed=2)
    same = port_input_errors(seed=2)
    assert max(local) < LAYER_REL, local
    assert max(same) < LAYER_REL, same
    assert max(chained) > 100 * max(same)
