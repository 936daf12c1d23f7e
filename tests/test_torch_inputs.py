"""The port's ``configs.inputs`` and shape cells against the JAX
package's, and the engines' refusal of the two families whose models take
more than tokens.

``batch_specs`` / ``input_specs(concrete=True)`` must equal JAX's bit for
bit for every registered config and each step kind (train, prefill,
decode): the same draws from ``np.random.default_rng(seed)`` in the same
order, tokens int32, frames and patch embeddings bf16, decode caches of
the same tree, shapes, dtypes and values.  Small ``ShapeSpec``s built
here (B 2, S 320): ``prefill_32k``'s frames alone would be 4 GB.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.configs import inputs as jinputs  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import ShapeSpec as JShapeSpec  # noqa: E402
from repro.configs.tiny import make_tiny as jtiny  # noqa: E402
from repro.models.init import init_params as jinit  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.paged import PagedEngine as JPagedEngine  # noqa: E402
from repro_torch.configs import SHAPES, ShapeSpec, get, names  # noqa: E402
from repro_torch.configs import inputs  # noqa: E402
from repro_torch.configs.tiny import make_tiny  # noqa: E402
from repro_torch.models.init import params_from_numpy  # noqa: E402
from repro_torch.models.schema import flatten  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.paged import PagedEngine  # noqa: E402
from tests.torch_helpers import to_numpy  # noqa: E402

KINDS = ("train", "prefill", "decode")
FRONT = {"whisper-base": "frames", "internvl2-26b": "patch_embeds"}


def test_shape_cells_equal_jax():
    assert set(SHAPES) == set(JSHAPES)
    for name, s in SHAPES.items():
        j = JSHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind,
                s.rule_overrides) == (j.name, j.seq_len, j.global_batch,
                                      j.kind, j.rule_overrides)
        assert s.overrides == j.overrides


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", sorted(names()))
def test_concrete_inputs_equal_jax_bit_for_bit(arch, kind):
    shape = ShapeSpec(f"small_{kind}", 320, 2, kind)
    jshape = JShapeSpec(f"small_{kind}", 320, 2, kind)
    want = to_numpy(jinputs.input_specs(jget(arch), jshape, concrete=True,
                                        seed=5))
    got = inputs.input_specs(get(arch), shape, concrete=True, seed=5,
                             device="cpu")
    assert set(got) == set(want)
    if kind != "decode":
        assert "caches" not in got
    flat_w, flat_g = flatten(want), flatten(got)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        bf16 = w.dtype == np.uint16
        assert g.dtype == (torch.bfloat16 if bf16 else
                           getattr(torch, str(w.dtype))), path
        bits = g.view(torch.int16).numpy().view(np.uint16) if bf16 \
            else g.numpy()
        assert bits.shape == w.shape and np.array_equal(bits, w), path
    batch = inputs.batch_specs(get(arch), shape, concrete=True, seed=5,
                               device="cpu")
    assert all(torch.equal(batch[k], got[k]) for k in batch)


def _cells():
    from repro_torch.configs import entry
    return [(a, s) for a in sorted(names()) for s in entry(a).shapes]


@pytest.mark.parametrize("arch,shape", _cells())
def test_abstract_specs_equal_jax_leaf_for_leaf(arch, shape):
    """``batch_specs`` / ``input_specs`` / ``cache_specs_abstract`` with
    ``concrete=False`` give ``meta`` tensors of the shapes and dtypes of
    JAX's ``ShapeDtypeStruct``s, leaf for leaf, at every registered
    cell's full size, with nothing allocated."""
    from repro_torch.core.tree import leaves_with_path

    def jax_leaves(tree):
        return [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
                for p, a in jax.tree_util.tree_leaves_with_path(tree)]

    def port_leaves(tree):
        got = leaves_with_path(tree)
        assert all(t.device.type == "meta" for _, t in got)
        return [(p, tuple(t.shape), str(t.dtype).removeprefix("torch."))
                for p, t in got]

    jcfg, cfg = jget(arch), get(arch)
    jshape, shp = JSHAPES[shape], SHAPES[shape]
    pairs = [(jinputs.batch_specs(jcfg, jshape),
              inputs.batch_specs(cfg, shp)),
             (jinputs.input_specs(jcfg, jshape),
              inputs.input_specs(cfg, shp))]
    if shp.kind == "decode":
        pairs.append((jinputs.cache_specs_abstract(jcfg, jshape),
                       inputs.cache_specs_abstract(cfg, shp)))
    for want, got in pairs:
        assert port_leaves(got) == jax_leaves(want)


@pytest.mark.parametrize("arch", sorted(FRONT))
def test_engines_refuse_a_model_they_cannot_feed(arch):
    """JAX takes either family into an engine and fails at the first
    request (a ``KeyError`` for the missing input, or the paged engine's
    attention-only assert on whisper); the port refuses at construction
    with a ``ValueError`` naming the input (ROADMAP Queue 3)."""
    jc = jtiny(jget(arch))
    jp = jinit(jc, jax.random.key(0))
    prompt = np.arange(8, dtype=np.int32)
    eng = JEngine(jc, jp, slots=2, max_len=64)
    with pytest.raises(KeyError, match=FRONT[arch]):
        eng.add_request(JRequest("r0", prompt, max_new_tokens=2))
    if arch == "whisper-base":
        with pytest.raises(AssertionError, match="attention-only"):
            JPagedEngine(jc, jp, rows=2, max_len=64)
    else:
        peng = JPagedEngine(jc, jp, rows=2, max_len=64)
        with pytest.raises(KeyError, match=FRONT[arch]):
            peng.add_request(JRequest("r0", prompt, max_new_tokens=2))

    tc = make_tiny(get(arch))
    tp = params_from_numpy(to_numpy(jp), device="cpu")
    for cls, kw in ((Engine, dict(slots=2)), (PagedEngine, dict(rows=2))):
        with pytest.raises(ValueError, match=f"'{FRONT[arch]}'"):
            cls(tc, tp, max_len=64, device="cpu", **kw)


def test_bf16_draws_round_through_float32_as_jax():
    """The bf16 front-end inputs round the float64 draws through float32,
    as JAX canonicalises them without x64."""
    assert not jax.config.jax_enable_x64
    x = np.random.default_rng(0).standard_normal((4, 4096))
    j = np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.uint16)
    t = torch.from_numpy(x).float().to(torch.bfloat16)
    assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16), j)
