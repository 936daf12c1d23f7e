"""whisper-base in the port against the JAX package: the encoder, the
decoder's cross-attention and its cross cache, through ``models.forward``
(train, prefill, decode), on the same bridged weights and inputs of the
tiny config (f32).  The counterpart of
``tests/test_arch_smoke.py::test_prefill_decode_matches_full_forward``
for this family, plus ``ops.attention_full`` against the reference's
oracle with Sq != Skv and the cross cache's length cases.

Tolerances.  Logits: 1e-4 of max |ref| (the families' f32 tolerance).
Cache leaves after prefill: 2e-5 of max |ref| (the f32 kernel
tolerance), ``abs_pos`` exact.  Decode against the teacher-forced
forward within the port: 5e-4, the reference's own bound.  The JAX
references are computed once a module (a tiny whisper compiles for
seconds on the CPU).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.configs.base import LayerSpec as JLayerSpec  # noqa: E402
from repro.configs.tiny import make_tiny as jtiny  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.init import init_params as jinit  # noqa: E402
from repro.models.model import forward as jforward  # noqa: E402
from repro.models.model import make_cache as jmake_cache  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.configs.tiny import make_tiny  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import schema  # noqa: E402
from repro_torch.models.init import params_from_numpy  # noqa: E402
from repro_torch.models.model import forward as tforward  # noqa: E402
from repro_torch.models.model import make_cache  # noqa: E402
from tests.torch_helpers import as_f32, to_numpy  # noqa: E402

NAME = "whisper-base"
B, FRAMES, EXTRA = 2, 24, 3
LOGIT_REL = 1e-4
CACHE_REL = 2e-5
TEACHER = 5e-4


def rel(a, t) -> float:
    a, t = as_f32(a), as_f32(t)
    return float(np.abs(a - t).max()) / max(1e-30, float(np.abs(a).max()))


@pytest.fixture(scope="module")
def run():
    """Both packages on one tiny whisper (f32, weights of seed 1): the
    teacher-forced train logits over ``decoder_len`` tokens, then a
    prefill of ``decoder_len - 3`` tokens into caches whose cross part
    holds 8 slots more than the frames (both packages mask them) and 3
    decode steps; JAX's caches after the prefill."""
    jc = jtiny(jget(NAME)).replace(dtype="float32")
    tc = make_tiny(get(NAME)).replace(dtype="float32")
    jp = jinit(jc, jax.random.key(1))
    tp = params_from_numpy(to_numpy(jp), device="cpu")
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((B, FRAMES, jc.d_model)).astype(np.float32)
    toks = rng.integers(0, jc.vocab_size, (B, jc.decoder_len)).astype(
        np.int32)
    plen = jc.decoder_len - EXTRA
    max_len, cross_len = jc.decoder_len + 4, FRAMES + 8
    out = {"jc": jc, "tc": tc, "jp": jp, "tp": tp, "frames": frames,
           "toks": toks, "plen": plen}

    jb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)}
    out["j_train"] = jforward(jp, jb, cfg=jc, mode="train")[0]
    jcache = jmake_cache(jc, B, max_len, cross_len=cross_len)
    lg, jcache, _ = jforward(
        jp, {"frames": jb["frames"], "tokens": jb["tokens"][:, :plen]},
        cfg=jc, mode="prefill", caches=jcache)
    out["j_prefill"], out["j_cache"] = lg, jcache
    steps = []
    for t in range(EXTRA):
        pos = jnp.full((B, 1), plen + t, jnp.int32)
        lg, jcache, _ = jforward(
            jp, {"tokens": jb["tokens"][:, plen + t:plen + t + 1]}, cfg=jc,
            mode="decode", caches=jcache, positions=pos)
        steps.append(lg)
    out["j_steps"] = steps

    tb = {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(toks)}
    with torch.no_grad():
        out["t_train"] = tforward(tp, tb, cfg=tc, mode="train")
        tcache = make_cache(tc, B, max_len, "cpu", cross_len=cross_len)
        out["t_prefill"] = tforward(
            tp, {"frames": tb["frames"], "tokens": tb["tokens"][:, :plen]},
            cfg=tc, mode="prefill", caches=tcache)
        out["t_cache"] = [[{k: {n: a.clone() for n, a in d.items()}
                            for k, d in layer.items()} for layer in grp]
                          for grp in tcache]
        steps = []
        for t in range(EXTRA):
            pos = torch.full((B, 1), plen + t, dtype=torch.int32)
            steps.append(tforward(
                tp, {"tokens": tb["tokens"][:, plen + t:plen + t + 1]},
                cfg=tc, mode="decode", caches=tcache, positions=pos))
    out["t_steps"] = steps
    return out


def test_config_and_bridge_carry_the_encoder_and_cross_trees(run):
    tp, jp = run["tp"], run["jp"]
    flat_j = schema.flatten(to_numpy(jp))
    flat_t = schema.flatten(tp)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (_, a), (_, t) in zip(flat_j, flat_t):
        assert np.array_equal(a, t.numpy())
    paths = {"/".join(map(str, p)) for p, _ in flat_t}
    assert "encoder/final_norm/scale" in paths
    assert "encoder/blocks/0/0/attn/wq" in paths
    assert "blocks/0/0/cross/wk" in paths
    assert not any(p.startswith("encoder/") and "/cross/" in p
                   for p in paths)
    cfg = get(NAME)
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.decoder_len, cfg.act) == (512, 8, 8, 64, 448, "gelu")
    assert round(cfg.param_count() / 1e6, 1) == 110.1


def test_train_logits_match_jax(run):
    lt = run["t_train"]
    assert lt.shape == (B, run["tc"].decoder_len, run["tc"].padded_vocab)
    assert bool(torch.isfinite(lt).all())
    assert rel(run["j_train"], lt) < LOGIT_REL


def test_prefill_and_decode_logits_match_jax(run):
    assert run["t_prefill"].shape[1] == run["plen"]
    assert rel(run["j_prefill"], run["t_prefill"]) < LOGIT_REL
    for j, t in zip(run["j_steps"], run["t_steps"]):
        assert t.shape == (B, 1, run["tc"].padded_vocab)
        assert rel(j, t) < LOGIT_REL


def test_self_and_cross_caches_after_prefill_match_jax(run):
    """Leaf by leaf; the cross cache's 8 extra slots stay at -1."""
    for jg, tg in zip(run["j_cache"], run["t_cache"]):
        for jl, tl in zip(jg, tg):
            assert set(jl) == set(tl) == {"attn", "cross"}
            for part in ("attn", "cross"):
                for key in ("k", "v"):
                    assert rel(jl[part][key], tl[part][key]) < CACHE_REL
                ap = np.asarray(jl[part]["abs_pos"])
                assert np.array_equal(ap, tl[part]["abs_pos"].numpy())
            cross = tl["cross"]["abs_pos"]
            assert cross.shape[-1] == FRAMES + 8
            assert bool((cross[..., :FRAMES] == torch.arange(FRAMES)).all())
            assert bool((cross[..., FRAMES:] == -1).all())


def test_decode_continues_the_teacher_forced_forward(run):
    plen, full = run["plen"], run["t_train"]
    errs = [float((run["t_prefill"][:, -1] - full[:, plen - 1]).abs().max())]
    for t, lg in enumerate(run["t_steps"]):
        errs.append(float((lg[:, 0] - full[:, plen + t]).abs().max()))
    assert max(errs) < TEACHER, errs


def test_a_precomputed_encoder_output_is_honoured(run):
    """``enc_out`` in the batch replaces the encoder run: the train
    logits on the frames' encoder output equal those on the frames."""
    tc, tp = run["tc"], run["tp"]
    from repro_torch.models.model import _run_groups
    from repro_torch.models.layers import rmsnorm
    frames = torch.from_numpy(run["frames"])
    pos = torch.arange(FRAMES)[None].expand(B, FRAMES)
    with torch.no_grad():
        enc, _ = _run_groups(tp["encoder"]["blocks"], frames, cfg=tc,
                             blocks=tc.encoder_blocks, mode="train",
                             positions=pos, caches=None, causal=False)
        enc = rmsnorm(enc, tp["encoder"]["final_norm"]["scale"], tc.norm_eps)
        lt = tforward(tp, {"enc_out": enc,
                           "tokens": torch.from_numpy(run["toks"])},
                      cfg=tc, mode="train")
    assert torch.equal(lt, run["t_train"])


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_attention_full_matches_jax_reference_with_sq_ne_skv(dtype, tol):
    """Cross-attention's shape (Sq decoder tokens over Skv frames, both in
    the prefill domain), and the encoder's (Sq = Skv), with a softcap."""
    rng = np.random.default_rng(3)
    for Sq, Skv, softcap in ((13, 40, 0.0), (40, 40, 0.0), (16, 1024, 30.0)):
        q, k, v = (rng.standard_normal((2, S, h, 64)).astype(np.float32)
                   for S, h in ((Sq, 8), (Skv, 8), (Skv, 8)))
        jd = jnp.dtype(dtype)
        ref = jattn.reference_attention(
            *(jnp.asarray(a, jd) for a in (q, k, v)), causal=False,
            softcap=softcap)
        td = getattr(torch, dtype)
        out = ops.attention_full(*(torch.from_numpy(a).to(td)
                                   for a in (q, k, v)), softcap=softcap)
        assert out.shape == (2, Sq, 8, 64)
        err = float(np.abs(as_f32(ref) - as_f32(out)).max())
        assert err < tol, (Sq, Skv, err)


def test_attention_full_keeps_the_domain_of_both_lengths():
    """JAX ``flash_full`` asserts both lengths; the port raises."""
    q = torch.zeros((1, 16, 8, 64))
    kv = torch.zeros((1, 700, 8, 64))
    with pytest.raises(AssertionError):
        jattn.flash_full(jnp.zeros((1, 16, 8, 64)),
                         jnp.zeros((1, 700, 8, 64)),
                         jnp.zeros((1, 700, 8, 64)))
    with pytest.raises(ValueError, match="700"):
        ops.attention_full(q, kv, kv)
    with pytest.raises(ValueError, match="700"):
        ops.attention_full(kv, q, q)


def test_cross_cache_shorter_than_the_frames(run):
    """The reference writes frame p at slot min(p, S_c - 1): the frames
    past the cache pile into its last slot, and on the JAX CPU scatter
    the last of them survives.  The port refuses the prefill before any
    cache row moves."""
    S_c = FRAMES - 4
    k = jnp.arange(FRAMES, dtype=jnp.float32)[None, :, None, None] * \
        jnp.ones((1, FRAMES, 2, 4))
    pos = jnp.arange(FRAMES)[None]
    cache = {"k": jnp.zeros((1, S_c, 2, 4)), "v": jnp.zeros((1, S_c, 2, 4)),
             "abs_pos": jnp.full((1, S_c), -1, jnp.int32)}
    new = jlayers._write_cache(cache, JLayerSpec("attn", "none"), k, k, pos)
    assert int(new["abs_pos"][0, -1]) == FRAMES - 1
    assert float(new["k"][0, -1, 0, 0]) == FRAMES - 1

    tc, tp = run["tc"], run["tp"]
    caches = make_cache(tc, B, tc.decoder_len, "cpu", cross_len=S_c)
    before = [a.clone() for grp in caches for layer in grp
              for d in layer.values() for a in d.values()]
    with pytest.raises(ValueError, match=f"{S_c} slots"):
        tforward(tp, {"frames": torch.from_numpy(run["frames"]),
                      "tokens": torch.from_numpy(run["toks"][:, :4])},
                 cfg=tc, mode="prefill", caches=caches)
    after = [a for grp in caches for layer in grp
             for d in layer.values() for a in d.values()]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_cross_cache_longer_than_the_frames_is_masked(run):
    """The fixture's cross caches hold 8 empty slots; the same prefill
    and decode steps on caches of exactly the frames' length give the
    same logits, within the f32 kernel tolerance (the masked slots move
    only the order of the f32 sums: 1.3e-6 here)."""
    tc, tp, plen = run["tc"], run["tp"], run["plen"]
    toks = torch.from_numpy(run["toks"])
    caches = make_cache(tc, B, tc.decoder_len + 4, "cpu", cross_len=FRAMES)
    with torch.no_grad():
        tforward(tp, {"frames": torch.from_numpy(run["frames"]),
                      "tokens": toks[:, :plen]},
                 cfg=tc, mode="prefill", caches=caches)
        for t in range(EXTRA):
            lg = tforward(tp, {"tokens": toks[:, plen + t:plen + t + 1]},
                          cfg=tc, mode="decode", caches=caches,
                          positions=torch.full((B, 1), plen + t,
                                               dtype=torch.int32))
            assert rel(run["t_steps"][t], lg) < CACHE_REL
