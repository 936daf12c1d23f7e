"""One train step of the port against the JAX package's, on the same
bridged weights and the same ``Pipeline`` batch (tiny configs, f32):
llama-1.5b, granite-moe-1b-a400m (the MoE aux loss) and gemma2-27b
(softcaps, a local window) here; whisper-base (the encoder in full mode,
cross-attention) and internvl2-26b (the patch prefix's offset) run the
same tests in ``tests/test_torch_train_parity_front.py`` (one xdist
worker a file).

Tolerances, each against JAX:
  * loss, ce, z_loss and aux: 1e-5 relative;
  * every gradient leaf, relative to that leaf's max |grad|: within 1e-4
    of JAX's, or within 3x JAX's own f32 error where that is larger.  The
    yardstick is a float64 run of the port (its norms, attention scores
    and router stay f32, as the reference keeps them): JAX's f32 grads
    must lie within 1e-3 of it (the two packages compute one function),
    and the port's f32 grads within max(1e-4, 2x JAX's distance).  Where
    a config's fixture measures the function's own f32 sensitivity
    (``tests/test_torch_train_parity_recurrent.py``: jamba's, the
    smaller of the port's and JAX's), 3x that sensitivity joins the max
    of the tolerance, and 2x it that of the port's distance.  Each
    package's f32 gradients carry their own rounding of the same size
    (measured: JAX 2.4e-5 / port 1.7e-5 on llama, 1.8e-4 / 1.5e-4 on the
    MoE config, 6.5e-4 / 7.0e-4 on whisper's embedding), so 1e-4 between
    the two holds only where each is well under 5e-5;
  * ``adamw.apply_updates`` on identical (params, grads, state), twice in
    a row (so the second has live moments): 1e-6 absolute;
  * one whole ``train_step``'s params.  Adam's first step moves every
    element by about lr * g / |g|, so an element whose gradient is within
    the two packages' f32 disagreement of 0 takes the sign of its
    rounding (on internvl2 a wq element has g -2.3e-6 in JAX, +6.1e-7 in
    the port, 1e-5 of the leaf's max): elements with |g| under the leaf's
    gradient tolerance above (at least 1e-6 of its max) are held to 2 lr
    (the most two opposite first steps differ by), the rest to 1e-4.
The JAX side of each config is computed once a module (a fixture), on
one bridged weight tree a config.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.configs.tiny import make_tiny as jtiny  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import Pipeline as JPipeline  # noqa: E402
from repro.models.init import init_params as jinit  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.training import train as jtrain  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.configs.tiny import make_tiny  # noqa: E402
from repro_torch.core.tree import leaves_with_path, tree_map  # noqa: E402
from repro_torch.models.init import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.training import train  # noqa: E402
from tests.torch_helpers import as_f32, to_numpy  # noqa: E402

ARCHS = ("llama-1.5b", "granite-moe-1b-a400m", "gemma2-27b")
B, S = 2, 32
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
LOSS_REL = 1e-5
GRAD_REL = 1e-4
JAX_OWN_MAX = 1e-3
UPDATE_ABS = 1e-6
STEP_ABS = 1e-4
TINY_G = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for this module: the tiny models' ops are too
    small to split, and under the suite's six workers on a shared CPU the
    split cost up to 30x the module's time alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed=0):
    """The Pipeline's tokens, and the front end's input where the model
    takes one (whisper: 32 frames; internvl: its patch embeddings ahead
    of S - num_patches tokens), as numpy."""
    S_t = S - cfg.num_patches
    batch = dict(JPipeline(JDataConfig(cfg.vocab_size, S_t, B)).batch(seed))
    rng = np.random.default_rng(seed)
    if cfg.encoder_blocks:
        batch["frames"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    if cfg.num_patches:
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_patches, 1024)).astype(np.float32)
    return batch


def _keyed(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(a, np.float32)
            for p, a in flat}


def compute_pair(name: str) -> dict:
    """One config on both packages: the JAX loss, grads and one train
    step, and the port's, on the same weights (seed 0) and batch."""
    jcfg = jtiny(jget(name)).replace(dtype="float32")
    tcfg = make_tiny(get(name)).replace(dtype="float32")
    jp = jinit(jcfg, jax.random.key(0))
    tp = params_from_numpy(to_numpy(jp), device="cpu")
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    opt = jadamw.AdamWConfig(**OPT)
    jt = jtrain.TrainConfig(optimizer=opt)
    tt = train.TrainConfig(optimizer=adamw.AdamWConfig(**OPT))

    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jtrain.loss_fn, has_aux=True), static_argnums=(2, 3))(
            jp, jb, jcfg, jt)
    jstep = jtrain.make_train_step(jcfg, jt)
    jp1, _, _ = jstep(jax.tree.map(jnp.copy, jp),
                      jadamw.init_opt_state(jp), jb)
    tloss, tmet, tgrads = train._value_and_grad(tp, tb, tcfg, tt)
    _, _, g64 = train._value_and_grad(
        tree_map(lambda a: a.double(), tp),
        {k: v.double() if v.is_floating_point() else v
         for k, v in tb.items()}, tcfg.replace(dtype="float64"), tt)
    tp1, _, tm1 = train.train_step(tp, adamw.init_opt_state(tp), tb,
                                   cfg=tcfg, tcfg=tt)
    return dict(name=name, jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp,
                jloss=float(jloss), jmet={k: float(v) for k, v in
                                          jmet.items()},
                tloss=float(tloss), tmet={k: float(v) for k, v in
                                          tmet.items()},
                jgrads=jgrads, tgrads=tgrads, jp1=_keyed(jp1),
                g64={k: v.numpy() for k, v in leaves_with_path(g64)},
                tp1={k: as_f32(v) for k, v in leaves_with_path(tp1)},
                tm1=tm1, lr1=float(jadamw.schedule(opt, 1)))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return compute_pair(request.param)


def test_loss_terms_match_jax(pair):
    """loss, ce, z_loss and aux within 1e-5 relative; an MoE config's
    aux is live (the port no longer drops it)."""
    got = {"loss": pair["tloss"], **pair["tmet"]}
    want = {"loss": pair["jloss"], **pair["jmet"]}
    assert set(want) == {"loss", "ce", "z_loss", "aux"}
    for k in want:
        assert abs(got[k] - want[k]) <= LOSS_REL * max(abs(want[k]), 1e-30), \
            (k, got[k], want[k])
    cfg = pair["tcfg"]
    if "moe" in {ls.ffn for b in cfg.blocks for ls in b.layers}:
        assert want["aux"] > 0.5
    else:
        assert want["aux"] == got["aux"] == 0.0


def grad_tols(pair) -> dict:
    """Each leaf's gradient tolerance (relative to its max |grad|) by the
    rule of the module docstring: max(1e-4, 3x JAX's own f32 error), and
    3x the leaf's measured f32 sensitivity where the pair carries one
    (``sens``, ``tests/test_torch_train_parity_recurrent.py``)."""
    want = _keyed(pair["jgrads"])
    out = {}
    for k, w in want.items():
        ref = pair["g64"][k]
        top = max(float(np.abs(ref).max()), 1e-30)
        own = float(np.abs(w - ref).max()) / top
        assert own <= JAX_OWN_MAX, (k, own)
        out[k] = max(GRAD_REL, 3 * own, 3 * pair.get("sens", {}).get(k, 0.0))
    return out


def test_every_grad_leaf_matches_jax(pair):
    """Each gradient leaf against JAX's under the same key paths, and
    against the float64 yardstick, by the rule of the module
    docstring."""
    want = _keyed(pair["jgrads"])
    got = {k: as_f32(v) for k, v in leaves_with_path(pair["tgrads"])}
    assert list(want) == list(got) == list(pair["g64"])
    tols = grad_tols(pair)
    for k, w in want.items():
        ref = pair["g64"][k]
        top = max(float(np.abs(ref).max()), 1e-30)
        err = float(np.abs(got[k] - w).max())
        assert err <= tols[k] * top, (k, err / top, tols[k])
        own = float(np.abs(got[k] - ref).max()) / top
        assert own <= max(GRAD_REL, 2 * tols[k] / 3), (k, own)


def test_apply_updates_matches_jax(pair):
    """AdamW on identical (params, grads, state), twice in a row: params,
    mu, nu, step, the grad norm and the lr within 1e-6."""
    jg = pair["jgrads"]
    tg = params_from_numpy(to_numpy(jg), device="cpu")
    opt = jadamw.AdamWConfig(**OPT)
    topt = adamw.AdamWConfig(**OPT)
    jp, js = pair["jp"], jadamw.init_opt_state(pair["jp"])
    tp, ts = pair["tp"], adamw.init_opt_state(pair["tp"])
    for _ in range(2):
        jp, js, jm = jadamw.apply_updates(jp, jg, js, opt)
        tp, ts, tm = adamw.apply_updates(tp, tg, ts, topt)
        for want, got in ((jp, tp), (js["mu"], ts["mu"]),
                          (js["nu"], ts["nu"])):
            w = _keyed(want)
            g = {k: as_f32(v) for k, v in leaves_with_path(got)}
            assert list(w) == list(g)
            for k in w:
                assert float(np.abs(g[k] - w[k]).max()) <= UPDATE_ABS, k
        assert int(ts["step"]) == int(js["step"])
        assert ts["step"].dtype == torch.int32
        for k in ("grad_norm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) <= UPDATE_ABS * max(
                1.0, abs(float(jm[k]))), k


def test_train_step_params_match_jax(pair):
    """One whole train step (grads, clip, AdamW): the port's params
    against JAX's ``make_train_step``, by the rule of the module
    docstring."""
    grads = _keyed(pair["jgrads"])
    tols = grad_tols(pair)
    lr = pair["lr1"]
    assert abs(float(pair["tm1"]["lr"]) - lr) <= 1e-9
    for k, want in pair["jp1"].items():
        got = pair["tp1"][k]
        g = np.abs(grads[k])
        tiny = g < max(TINY_G, tols[k]) * max(float(g.max()), 1e-30)
        err = np.abs(got - want)
        assert float(err[~tiny].max(initial=0.0)) <= STEP_ABS, k
        assert float(err[tiny].max(initial=0.0)) <= 2 * lr, k
