"""internvl2-26b in the port against the JAX package: the patch prefix
(``patch_proj`` over 1024-wide stub patch embeddings, prepended to the
text) through ``models.forward`` (train, prefill, decode), on the same
bridged weights and inputs of the tiny config (f32); the logits cover the
patches and the text, and decode positions start after both.  The
counterpart of
``tests/test_arch_smoke.py::test_prefill_decode_matches_full_forward``
for this family.

Tolerances as in tests/test_torch_whisper.py: logits 1e-4 of max |ref|,
cache leaves 2e-5 of max |ref| with ``abs_pos`` exact, decode against
the teacher-forced forward within the port 5e-4.  The JAX references
are computed once a module.
"""

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
from repro_torch.configs import get  # noqa: E402
from repro_torch.configs.tiny import make_tiny  # noqa: E402
from repro_torch.models import schema  # noqa: E402
from repro_torch.models.init import params_from_numpy  # noqa: E402
from repro_torch.models.model import forward as tforward  # noqa: E402
from repro_torch.models.model import make_cache  # noqa: E402
from tests.torch_helpers import as_f32, to_numpy  # noqa: E402

NAME = "internvl2-26b"
B, TEXT, EXTRA = 2, 24, 3
LOGIT_REL = 1e-4
CACHE_REL = 2e-5
TEACHER = 5e-4


def rel(a, t) -> float:
    a, t = as_f32(a), as_f32(t)
    return float(np.abs(a - t).max()) / max(1e-30, float(np.abs(a).max()))


@pytest.fixture(scope="module")
def run():
    """Both packages on one tiny internvl2 (f32, weights of seed 1, 8
    patches): the teacher-forced train logits over the patches and
    ``TEXT + 3`` tokens, then a prefill of the patches and ``TEXT``
    tokens and 3 decode steps at positions ``P + TEXT + t``; JAX's
    caches after the prefill."""
    jc = jtiny(jget(NAME)).replace(dtype="float32")
    tc = make_tiny(get(NAME)).replace(dtype="float32")
    jp = jinit(jc, jax.random.key(1))
    tp = params_from_numpy(to_numpy(jp), device="cpu")
    rng = np.random.default_rng(0)
    P = jc.num_patches
    toks = rng.integers(0, jc.vocab_size, (B, TEXT + EXTRA)).astype(np.int32)
    pe = rng.standard_normal((B, P, 1024)).astype(np.float32)
    max_len = P + TEXT + EXTRA + 4
    out = {"jc": jc, "tc": tc, "jp": jp, "tp": tp, "toks": toks, "pe": pe,
           "P": P}

    jt, jpe = jnp.asarray(toks), jnp.asarray(pe)
    out["j_train"] = jforward(jp, {"tokens": jt, "patch_embeds": jpe},
                              cfg=jc, mode="train")[0]
    jcache = jmake_cache(jc, B, max_len)
    lg, jcache, _ = jforward(jp, {"tokens": jt[:, :TEXT],
                                  "patch_embeds": jpe},
                             cfg=jc, mode="prefill", caches=jcache)
    out["j_prefill"], out["j_cache"] = lg, jcache
    steps = []
    for t in range(EXTRA):
        pos = jnp.full((B, 1), P + TEXT + t, jnp.int32)
        lg, jcache, _ = jforward(jp, {"tokens": jt[:, TEXT + t:TEXT + t + 1]},
                                 cfg=jc, mode="decode", caches=jcache,
                                 positions=pos)
        steps.append(lg)
    out["j_steps"] = steps

    tt, tpe = torch.from_numpy(toks), torch.from_numpy(pe)
    with torch.no_grad():
        out["t_train"] = tforward(tp, {"tokens": tt, "patch_embeds": tpe},
                                  cfg=tc, mode="train")
        tcache = make_cache(tc, B, max_len, "cpu")
        out["t_prefill"] = tforward(tp, {"tokens": tt[:, :TEXT],
                                         "patch_embeds": tpe},
                                    cfg=tc, mode="prefill", caches=tcache)
        out["t_cache"] = [[{k: {n: a.clone() for n, a in d.items()}
                            for k, d in layer.items()} for layer in grp]
                          for grp in tcache]
        steps = []
        for t in range(EXTRA):
            pos = torch.full((B, 1), P + TEXT + t, dtype=torch.int32)
            steps.append(tforward(tp, {"tokens": tt[:, TEXT + t:TEXT + t + 1]},
                                  cfg=tc, mode="decode", caches=tcache,
                                  positions=pos))
    out["t_steps"] = steps
    return out


def test_config_and_bridge_carry_patch_proj(run):
    flat_j = schema.flatten(to_numpy(run["jp"]))
    flat_t = schema.flatten(run["tp"])
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (_, a), (_, t) in zip(flat_j, flat_t):
        assert np.array_equal(a, t.numpy())
    proj = run["tp"]["patch_proj"]
    assert proj.shape == (1024, run["tc"].d_model)
    cfg = get(NAME)
    assert (cfg.num_patches, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.num_layers) == (256, 48, 8, 128, 48)
    assert round(cfg.param_count() / 1e9, 3) == 19.875


def test_train_logits_over_patches_and_text_match_jax(run):
    lt = run["t_train"]
    assert lt.shape == (B, run["P"] + TEXT + EXTRA, run["tc"].padded_vocab)
    assert bool(torch.isfinite(lt).all())
    assert rel(run["j_train"], lt) < LOGIT_REL


def test_prefill_and_decode_logits_match_jax(run):
    assert run["t_prefill"].shape[1] == run["P"] + TEXT
    assert rel(run["j_prefill"], run["t_prefill"]) < LOGIT_REL
    for j, t in zip(run["j_steps"], run["t_steps"]):
        assert t.shape == (B, 1, run["tc"].padded_vocab)
        assert rel(j, t) < LOGIT_REL


def test_caches_after_prefill_match_jax_and_hold_the_patches(run):
    held = run["P"] + TEXT
    for jg, tg in zip(run["j_cache"], run["t_cache"]):
        for jl, tl in zip(jg, tg):
            assert set(jl) == set(tl) == {"attn"}
            for key in ("k", "v"):
                assert rel(jl["attn"][key], tl["attn"][key]) < CACHE_REL
            ap = tl["attn"]["abs_pos"]
            assert np.array_equal(np.asarray(jl["attn"]["abs_pos"]),
                                  ap.numpy())
            assert bool((ap[..., :held] == torch.arange(held)).all())
            assert bool((ap[..., held:] == -1).all())


def test_decode_continues_the_teacher_forced_forward(run):
    off, full = run["P"], run["t_train"]
    errs = [float((run["t_prefill"][:, -1] - full[:, off + TEXT - 1])
                  .abs().max())]
    for t, lg in enumerate(run["t_steps"]):
        errs.append(float((lg[:, 0] - full[:, off + TEXT + t]).abs().max()))
    assert max(errs) < TEACHER, errs
