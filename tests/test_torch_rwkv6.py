"""The port's RWKV6 model family (``repro_torch.models.rwkv6``, the rwkv
branch of ``models.layers`` and the dense ``Engine`` serving it) on the
tiny rwkv6-7b, against the JAX package on the same weights: the time
mix, decode step, channel mix and head norm, prefill logits in f32 and
bf16, prefill-then-decode, and the JAX ``Engine``.

The zero-initialised LoRA and mix parameters of the reference init are
replaced by seeded random values in both packages, so the data-dependent
lerps and decays (down to the exp(-e^1.5) floor) are exercised.  On the
CPU the chunk loop runs the plain ``rwkv6_scan``; the CUDA kernel is
held against it on the card (tests/test_torch_cuda_kernels.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.configs.tiny import make_tiny as jtiny  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models import schema as jschema  # noqa: E402
from repro.models.init import init_params as jinit  # noqa: E402
from repro.models.model import forward as jforward  # noqa: E402
from repro.models.model import make_cache as jmake_cache  # noqa: E402
from repro.models.model import vocab_mask_logits  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.configs.base import LayerSpec  # noqa: E402
from repro_torch.configs.tiny import make_tiny as ttiny  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402
from repro_torch.models import schema  # noqa: E402
from repro_torch.models.init import params_from_numpy  # noqa: E402
from repro_torch.models.model import forward as tforward  # noqa: E402
from repro_torch.models.model import make_cache  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from tests.test_torch_model import LOGIT_TOL  # noqa: E402
from tests.torch_helpers import as_f32, to_numpy  # noqa: E402

F32_REL = 1e-5           # f32 activations, relative to the largest |ref|
GAP_TOL = 1e-4           # a greedy divergence needs a knife-edge top-2 gap
PROBS_TOL = 1e-5

# zero-initialised leaves of the reference init, and the scale of the
# random values that replace them
PERTURB = {"rwkv": (("mix_base", 0.5), ("mix_first", 0.5),
                    ("mix_lora_B", 0.3), ("decay_lora_B", 1.0)),
           "mlp": (("mix_k", 0.5), ("mix_r", 0.5))}

_PAIRS = {}


def pair(dtype="float32", seed=0):
    """The tiny rwkv6-7b of both packages on bridged weights: (jcfg,
    tcfg, jax params, torch params), shared within the module."""
    key = (dtype, seed)
    if key not in _PAIRS:
        jcfg = jtiny(jget("rwkv6-7b")).replace(dtype=dtype)
        tcfg = ttiny(tget("rwkv6-7b")).replace(dtype=dtype)
        jp = jinit(jcfg, jax.random.key(seed))
        rng = np.random.default_rng(seed)
        for grp in jp["blocks"]:
            for layer in grp:
                for part, leaves in PERTURB.items():
                    for name, scale in leaves:
                        a = layer[part][name]
                        layer[part][name] = jnp.asarray(
                            rng.standard_normal(a.shape) * scale, a.dtype)
        tp = params_from_numpy(to_numpy(jp), device="cpu")
        _PAIRS[key] = (jcfg, tcfg, jp, tp)
    return _PAIRS[key]


def layer0(tree, part):
    """Repeat 0 of the first layer's ``part`` params."""
    sub = tree["blocks"][0][0][part]
    if isinstance(next(iter(sub.values())), torch.Tensor):
        return schema.tree_map(lambda a: a[0], sub)
    return jax.tree.map(lambda a: a[0], sub)


def err(a, b) -> float:
    return float(np.abs(as_f32(a) - as_f32(b)).max())


def rel(ref, out) -> float:
    """Max abs error over max(1, max |ref|): the tiny model's activations
    reach |60| and its states |900| (the reference init's stacked fan-in
    makes r, k, v large), where f32 summation order alone moves 1e-6 of
    the magnitude."""
    return err(ref, out) / max(1.0, float(np.abs(as_f32(ref)).max()))


# -- configuration and parameters -------------------------------------------

def test_rwkv_schema_and_param_count_match_jax():
    for jcfg, tcfg in ((jget("rwkv6-7b"), tget("rwkv6-7b")),
                       (jtiny(jget("rwkv6-7b")), ttiny(tget("rwkv6-7b")))):
        assert tcfg.param_count() == jcfg.param_count()
        assert (tcfg.rwkv_heads, tcfg.rwkv_head_dim, tcfg.rwkv_lora) == \
            (jcfg.rwkv_heads, jcfg.rwkv_head_dim, jcfg.rwkv_lora)
        jleaves = jax.tree_util.tree_flatten_with_path(
            jschema.model_schema(jcfg),
            is_leaf=lambda x: isinstance(x, jschema.ParamDef))[0]
        tleaves = schema.flatten(schema.model_schema(tcfg))
        assert len(jleaves) == len(tleaves)
        for (_, jd), (_, td) in zip(jleaves, tleaves):
            assert (tuple(jd.shape), jd.init, jd.dtype) == \
                (td.shape, td.init, td.dtype)
    assert tget("rwkv6-7b").param_count() == 7_618_564_096
    tiny = ttiny(tget("rwkv6-7b"))
    assert (tiny.rwkv_head_dim, tiny.rwkv_lora) == (16, 8)
    _, _, _, tp = pair()
    assert tp["blocks"][0][0]["rwkv"]["decay_base"].shape == (2, 4, 16)
    assert tp["blocks"][0][0]["mlp"]["wk"].shape == (2, 64, 256)


# -- the building blocks ------------------------------------------------------

def test_groupnorm_heads_uses_the_population_variance():
    rng = np.random.default_rng(3)
    y = (rng.standard_normal((2, 5, 4, 16)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal((4, 16)).astype(np.float32)
    oj = jrwkv._groupnorm_heads(jnp.asarray(y), jnp.asarray(scale))
    ot = trwkv._groupnorm_heads(torch.from_numpy(y), torch.from_numpy(scale))
    assert err(oj, ot) < 1e-5
    unbiased = (torch.from_numpy(y) - torch.from_numpy(y).mean(-1, True)) \
        * torch.rsqrt(torch.from_numpy(y).var(-1, keepdim=True) + 64e-5)
    assert err(oj, unbiased * torch.from_numpy(scale)) > 1e-3


@pytest.mark.parametrize("T,chunk,carried", [
    (64, 64, False),
    (100, 64, True),     # ragged: 64 rows, then a 36-row tail chunk
    (37, 8, True),       # train chunk, ragged: 32 + 5
    (24, 8, False),
])
def test_timemix_parallel_matches_jax(T, chunk, carried):
    jcfg, tcfg, jp, tp = pair()
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, 64)).astype(np.float32)
    H, D = tcfg.rwkv_heads, tcfg.rwkv_head_dim
    state = (rng.standard_normal((2, H, D, D)) * 0.5).astype(np.float32)
    xl = rng.standard_normal((2, 64)).astype(np.float32)
    jkw = dict(state=jnp.asarray(state), x_last=jnp.asarray(xl)) \
        if carried else {}
    tkw = dict(state=torch.from_numpy(state), x_last=torch.from_numpy(xl)) \
        if carried else {}
    oj, sj, xj = jrwkv.timemix_parallel(layer0(jp, "rwkv"), jnp.asarray(x),
                                        jcfg, chunk=chunk, **jkw)
    ot, st, xt = trwkv.timemix_parallel(layer0(tp, "rwkv"),
                                        torch.from_numpy(x), tcfg,
                                        chunk=chunk, **tkw)
    assert ot.shape == (2, T, 64) and st.dtype == torch.float32
    assert rel(oj, ot) < F32_REL and rel(sj, st) < F32_REL
    assert err(xj, xt) == 0.0


def test_timemix_step_and_channelmix_match_jax():
    jcfg, tcfg, jp, tp = pair()
    rng = np.random.default_rng(5)
    H, D = tcfg.rwkv_heads, tcfg.rwkv_head_dim
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    state = (rng.standard_normal((3, H, D, D)) * 0.5).astype(np.float32)
    xl = rng.standard_normal((3, 64)).astype(np.float32)
    oj, sj, xj = jrwkv.timemix_step(layer0(jp, "rwkv"), jnp.asarray(x), jcfg,
                                    state=jnp.asarray(state),
                                    x_last=jnp.asarray(xl))
    ot, st, xt = trwkv.timemix_step(layer0(tp, "rwkv"), torch.from_numpy(x),
                                    tcfg, state=torch.from_numpy(state),
                                    x_last=torch.from_numpy(xl))
    assert rel(oj, ot) < F32_REL and rel(sj, st) < F32_REL
    assert err(xj, xt) == 0.0
    xs = rng.standard_normal((3, 9, 64)).astype(np.float32)
    for last in (None, xl):
        cj, lj = jrwkv.channelmix(
            layer0(jp, "mlp"), jnp.asarray(xs),
            x_last=None if last is None else jnp.asarray(last))
        ct, lt = trwkv.channelmix(
            layer0(tp, "mlp"), torch.from_numpy(xs),
            x_last=None if last is None else torch.from_numpy(last))
        assert rel(cj, ct) < F32_REL and err(lj, lt) == 0.0


# -- the model -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_match_jax(dtype):
    jcfg, tcfg, jp, tp = pair(dtype, seed=2)
    tokens = np.random.default_rng(0).integers(0, 512, (2, 100)).astype(
        np.int32)
    lj, _, _ = jforward(jp, {"tokens": jnp.asarray(tokens)}, cfg=jcfg,
                        mode="prefill")
    lt = tforward(tp, {"tokens": torch.from_numpy(tokens)}, cfg=tcfg,
                  mode="prefill")
    assert lt.shape == (2, 100, tcfg.padded_vocab)
    assert err(lj, lt) < LOGIT_TOL[dtype]


def test_prefill_then_decode_matches_jax():
    """A 70-token prefill (a 64-row chunk and a 6-row tail) into the
    caches, then three decode steps: logits and every cache leaf."""
    jcfg, tcfg, jp, tp = pair(seed=4)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, 512, (2, 70)).astype(np.int32)
    jc = jmake_cache(jcfg, 2, 128)
    tc = make_cache(tcfg, 2, 128, device="cpu")
    lj, jc, _ = jforward(jp, {"tokens": jnp.asarray(prompt)}, cfg=jcfg,
                         mode="prefill", caches=jc)
    lt = tforward(tp, {"tokens": torch.from_numpy(prompt)}, cfg=tcfg,
                  mode="prefill", caches=tc)
    assert err(lj, lt) < LOGIT_TOL["float32"]
    for step in range(3):
        tok = rng.integers(0, 512, (2, 1)).astype(np.int32)
        pos = np.full((2, 1), 70 + step, np.int32)
        lj, jc, _ = jforward(jp, {"tokens": jnp.asarray(tok)}, cfg=jcfg,
                             mode="decode", caches=jc,
                             positions=jnp.asarray(pos))
        lt = tforward(tp, {"tokens": torch.from_numpy(tok)}, cfg=tcfg,
                      mode="decode", caches=tc,
                      positions=torch.from_numpy(pos))
        assert err(lj, lt) < LOGIT_TOL["float32"], step
    for key in ("state", "x_tm", "x_cm"):
        assert rel(jc[0][0]["rwkv"][key], tc[0][0]["rwkv"][key]) < F32_REL, \
            key


def test_rwkv_cache_layout_and_masked_writes():
    jcfg, tcfg, _, _ = pair()
    jc = jmake_cache(jcfg, 3, 16)[0][0]["rwkv"]
    tc = make_cache(tcfg, 3, 16, device="cpu")[0][0]["rwkv"]
    for key in ("state", "x_tm", "x_cm"):
        assert tuple(jc[key].shape) == tuple(tc[key].shape)
        assert str(jc[key].dtype) == str(tc[key].dtype).split(".")[-1]
        assert not tc[key].any()
    cache = tlayers.make_rwkv_cache(tcfg, 3, device="cpu")
    old = {k: v.clone() for k, v in cache.items()}
    cache["write"] = torch.tensor([True, False, True])
    new = {k: torch.full_like(v, 2.0) for k, v in old.items()}
    tlayers._write_rwkv(cache, new["state"], new["x_tm"], new["x_cm"])
    for key in new:
        assert torch.equal(cache[key][[0, 2]], new[key][[0, 2]])
        assert torch.equal(cache[key][1], old[key][1])       # masked row
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        tlayers.make_layer_cache(tcfg, LayerSpec("mamba", "dense"), 1, 8,
                                 device="cpu")


# -- the dense Engine -------------------------------------------------------------

def engines(slots=3, max_len=128, seed=0):
    jcfg, tcfg, jp, tp = pair(seed=6)
    return (JEngine(jcfg, jp, slots=slots, max_len=max_len, seed=seed),
            Engine(tcfg, tp, slots=slots, max_len=max_len, seed=seed,
                   device="cpu"))


def reqs(prompts, max_new=10, prefix="r", **kw):
    return ([JRequest(f"{prefix}{i}", np.asarray(p), max_new_tokens=max_new,
                      **kw) for i, p in enumerate(prompts)],
            [Request(f"{prefix}{i}", np.asarray(p), max_new_tokens=max_new,
                     **kw) for i, p in enumerate(prompts)])


# 7 and 17 tokens: one chunk each; 70: a 64-row chunk and a 6-row tail
PROMPTS = [np.arange(2, 9), np.arange(40, 57), (np.arange(70) * 7) % 500]


def test_greedy_decode_agrees_with_jax_engine():
    """Three fresh slots decode greedily in lockstep with the JAX engine;
    at a divergence the JAX top-2 logit gap must be a knife edge."""
    jeng, teng = engines()
    jr, tr = reqs(PROMPTS, max_new=12)
    for a, b in zip(jr, tr):
        assert jeng.add_request(a) and teng.add_request(b)
    jcfg, _, jp, _ = pair(seed=6)
    matched, diverged = 0, {}
    while jeng.requests:
        before = jeng.state
        je, te = jeng.step(), teng.step()
        assert set(je) == set(te)
        for rid, tok in je.items():
            if rid in diverged:
                continue
            if te[rid] == tok:
                matched += 1
                continue
            row = [r for r in jr if r.rid == rid][0].slot
            lg, _, _ = jforward(jp, {"tokens": before.last_token[:, None]},
                                cfg=jcfg, mode="decode",
                                caches=before.caches,
                                positions=before.positions[:, None])
            top2 = jax.lax.top_k(vocab_mask_logits(lg[row, 0], jcfg), 2)[0]
            diverged[rid] = float(top2[0] - top2[1])
    assert all(len(r.output) == 12 for r in tr)
    # measured on this seed: 36/36 (no divergence)
    assert all(gap < GAP_TOL for gap in diverged.values()), diverged
    assert matched == 36 or diverged


def test_step_probs_match_jax_engine():
    jeng, teng = engines()
    jr, tr = reqs(PROMPTS, max_new=6)
    for rs in (jr, tr):
        rs[1].temperature, rs[1].top_k = 0.8, 5
        rs[2].temperature = 1.3
    for a, b in zip(jr, tr):
        assert jeng.add_request(a) and teng.add_request(b)
    for step in range(3):
        je, jpr = jeng.step_probs()
        te, tpr = teng.step_probs()
        rows = [0, 1, 2] if step == 0 else [0]
        assert np.abs(jpr[rows] - tpr[rows]).max() < PROBS_TOL, step
        assert je["r0"] == te["r0"]


def test_add_request_committed_matches_jax_engine():
    # not slots=2: with as many slots as the tiny model has repeats, the
    # JAX engine's mask-back (``_bcast``) masks the repeat axis instead
    # of the slot axis (ROADMAP, reference behaviours)
    jeng, teng = engines(slots=3)
    committed = [11, 12, 13, 14, 15]
    jr, tr = reqs(PROMPTS[:1], max_new=10)
    assert jeng.add_request(jr[0], committed=committed)
    assert teng.add_request(tr[0], committed=committed)
    assert tr[0].output == committed == jr[0].output
    for f in ("positions", "last_token", "tokens", "active"):
        assert np.array_equal(np.asarray(getattr(jeng.state, f)),
                              getattr(teng.state, f).numpy()), f
    while jeng.requests:
        assert jeng.step() == teng.step()
    assert tr[0].output == jr[0].output and len(tr[0].output) == 10


def test_inactive_slot_state_stays_untouched():
    _, teng = engines(slots=2)
    _, tr = reqs(PROMPTS[:2], max_new=20)
    for r in tr:
        assert teng.add_request(r)
    teng.step(auto_retire=False)
    teng.retire(1)
    snap = [{k: a[:, 1].clone() for k, a in layer["rwkv"].items()}
            for grp in teng.state.caches for layer in grp]
    for _ in range(3):
        teng.step(auto_retire=False)
    now = [{k: a[:, 1] for k, a in layer["rwkv"].items()}
           for grp in teng.state.caches for layer in grp]
    for a, b in zip(snap, now):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert not torch.equal(snap[0]["state"],
                           teng.state.caches[0][0]["rwkv"]["state"][:, 0])


def test_reused_slot_starts_from_the_zero_state():
    """A request admitted into a slot another request left gives what the
    JAX engine gives it on a fresh slot: the slot's recurrent state is
    cleared before prefill (the JAX engine would carry it over)."""
    first, second = PROMPTS[2], np.arange(3, 27)
    jfresh, _ = engines(slots=1)
    jq = JRequest("b", second, max_new_tokens=8)
    assert jfresh.add_request(jq)
    while jfresh.requests:
        jfresh.step()
    _, teng = engines(slots=1)
    assert teng.add_request(Request("a", first, max_new_tokens=8))
    while teng.requests:
        teng.step()
    tq = Request("b", second, max_new_tokens=8)
    assert teng.add_request(tq) and tq.slot == 0
    while teng.requests:
        teng.step()
    assert tq.output == jq.output
    _, tfresh = engines(slots=1)
    fq = Request("b", second, max_new_tokens=8)
    assert tfresh.add_request(fq)
    while tfresh.requests:
        tfresh.step()
    assert fq.output == tq.output


def test_recurrent_verify_and_rollback_raise_and_long_prompts_admit():
    jeng, teng = engines(slots=1, max_len=1024)
    assert not teng.supports_wide_verify
    q = np.eye(tget("rwkv6-7b").replace(vocab_size=512,
                                        vocab_pad_multiple=16).padded_vocab,
               dtype=np.float32)[[1]]
    # the attention prompt-length domain does not apply: 1000 tokens admit
    r = Request("long", np.arange(1000) % 500, max_new_tokens=4)
    assert teng.add_request(r)
    for call in (lambda: teng.rollback_slot(0, 1, 0, None),
                 lambda: teng.verify_slots({0: [1]}),
                 lambda: teng.verify_slots_stepwise({0: [1]}),
                 lambda: teng.verify_slots_distribution(
                     {0: [1]}, {0: q}, rng=torch.Generator())):
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            call()
    teng.step()
    assert len(r.output) == 1


def test_jax_engine_leaks_a_reused_slot_and_the_port_does_not():
    """The reference behaviour the port departs from (ROADMAP): on the
    JAX ``Engine`` a request in a reused slot starts from the state the
    slot's last request left, so its greedy tokens differ from a fresh
    engine's; the port's equal the fresh ones.  Tiny rwkv6 in f32 on the
    reference init (``key(1)``), two 24-token prompts, 8 tokens each."""
    jcfg = jtiny(jget("rwkv6-7b")).replace(dtype="float32")
    tcfg = ttiny(tget("rwkv6-7b")).replace(dtype="float32")
    jp = jinit(jcfg, jax.random.key(1))
    tp = params_from_numpy(to_numpy(jp), device="cpu")
    rng = np.random.default_rng(0)
    a, b = rng.integers(0, 512, 24), rng.integers(0, 512, 24)

    def serve(eng, make, prompts):
        outs = []
        for i, prompt in enumerate(prompts):
            r = make(f"r{i}", prompt, max_new_tokens=8)
            assert eng.add_request(r) and r.slot == 0
            while eng.requests:
                eng.step()
            outs.append(list(r.output))
        return outs

    geo = dict(slots=1, max_len=64)
    j_reused = serve(JEngine(jcfg, jp, **geo), JRequest, [a, b])[1]
    j_fresh = serve(JEngine(jcfg, jp, **geo), JRequest, [b])[0]
    t_reused = serve(Engine(tcfg, tp, device="cpu", **geo), Request,
                     [a, b])[1]
    assert j_reused != j_fresh                     # the leak
    assert t_reused == j_fresh
