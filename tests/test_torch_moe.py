"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's one-device half (``repro.models.moe``) on the same numpy
inputs: the router's ids and weights, the experts, the shared experts,
``moe_dense``'s output and its load-balancing loss, at the tiny configs'
structure (8 experts, top-2, 1 shared) and at deepseek-moe-16b's (64
experts, top-6, 2 shared) with a small width.  Tolerances: f32 2e-5
relative to the largest |reference| (the outputs reach O(100) with these
weight scales), bf16 one bf16 ulp of the largest |reference|."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MoESpec as JMoESpec  # noqa: E402
from repro.configs import get as jget  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import MoESpec, get  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from tests.torch_helpers import as_f32  # noqa: E402

# (experts, top-k, d_expert, shared, d_model)
STRUCTURES = {"tiny": (8, 2, 32, 1, 64),
              "deepseek-moe-16b": (64, 6, 48, 2, 32),
              "granite-moe": (32, 8, 24, 0, 32)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(name, dtype):
    E, k, dx, shared, d = STRUCTURES[name]
    base = "deepseek-moe-16b"
    jc = jget(base).replace(d_model=d, dtype=dtype, moe=JMoESpec(
        num_experts=E, top_k=k, d_expert=dx, num_shared=shared))
    tc = get(base).replace(d_model=d, dtype=dtype, moe=MoESpec(
        num_experts=E, top_k=k, d_expert=dx, num_shared=shared))
    return jc, tc


def _params(name, dtype, seed=0):
    """One MoE layer's weights as numpy, in both packages' dtypes."""
    E, k, dx, shared, d = STRUCTURES[name]
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((d, E)).astype(np.float32) * 0.5,
         "w_gate": rng.standard_normal((E, d, dx)).astype(np.float32) * 0.3,
         "w_up": rng.standard_normal((E, d, dx)).astype(np.float32) * 0.3,
         "w_down": rng.standard_normal((E, dx, d)).astype(np.float32) * 0.3}
    if shared:
        p["shared"] = {
            "w_gate": rng.standard_normal((d, shared * dx)) * 0.3,
            "w_up": rng.standard_normal((d, shared * dx)) * 0.3,
            "w_down": rng.standard_normal((shared * dx, d)) * 0.3}
    jp = {n: (jnp.asarray(a, jnp.float32) if n == "router"
              else jnp.asarray(a, JDT[dtype])) for n, a in p.items()
          if n != "shared"}
    tp = {n: (torch.from_numpy(a) if n == "router"
              else torch.from_numpy(a).to(TDT[dtype])) for n, a in p.items()
          if n != "shared"}
    if shared:
        jp["shared"] = {n: jnp.asarray(a.astype(np.float32), JDT[dtype])
                        for n, a in p["shared"].items()}
        tp["shared"] = {n: torch.from_numpy(a.astype(np.float32)).to(
            TDT[dtype]) for n, a in p["shared"].items()}
    return jp, tp


def _x(name, dtype, B=2, S=24, seed=1):
    d = STRUCTURES[name][4]
    x = np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _close(a, b, dtype):
    a, b = as_f32(a), as_f32(b)
    top = float(np.abs(a).max())
    if dtype == "float32":
        lim = 2e-5 * max(top, 1.0)
    else:       # one bf16 ulp of the largest |reference|
        lim = 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 7)
    err = float(np.abs(a - b).max())
    assert err <= lim, (err, lim, top)


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_router_ids_and_weights_match_jax(name):
    jc, tc = _cfgs(name, "float32")
    jp, tp = _params(name, "float32")
    xj, xt = _x(name, "float32")
    d = xj.shape[-1]
    wj, ij, pj = jmoe._router(jp, xj.reshape(-1, d), jc.moe)
    wt, it, pt = tmoe._router(tp, xt.reshape(-1, d), tc.moe)
    assert np.array_equal(np.asarray(ij), it.numpy())
    assert float(np.abs(np.asarray(wj) - wt.numpy()).max()) < 1e-6
    assert float(np.abs(np.asarray(pj) - pt.numpy()).max()) < 1e-6
    assert np.allclose(wt.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("name", ["tiny", "deepseek-moe-16b"])
def test_router_takes_the_lower_id_on_ties_as_lax_top_k(name):
    """A zero router gives every expert the same probability: lax.top_k
    takes ids 0..k-1 in order, and so must the port (torch.topk promises
    no order on ties)."""
    jc, tc = _cfgs(name, "float32")
    jp, tp = _params(name, "float32")
    jp["router"] = jnp.zeros_like(jp["router"])
    tp["router"] = torch.zeros_like(tp["router"])
    xj, xt = _x(name, "float32")
    d = xj.shape[-1]
    ij = np.asarray(jmoe._router(jp, xj.reshape(-1, d), jc.moe)[1])
    it = tmoe._router(tp, xt.reshape(-1, d), tc.moe)[1].numpy()
    k = tc.moe.top_k
    assert np.array_equal(ij, np.broadcast_to(np.arange(k), ij.shape))
    assert np.array_equal(it, ij)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(STRUCTURES))
def test_moe_dense_and_aux_match_jax(name, dtype):
    jc, tc = _cfgs(name, dtype)
    jp, tp = _params(name, dtype)
    xj, xt = _x(name, dtype)
    oj, aj = jmoe.moe_dense(jp, xj, jc)
    ot, at = tmoe.moe_dense(tp, xt, tc)
    assert ot.dtype == TDT[dtype] and ot.shape == tuple(oj.shape)
    _close(oj, ot, dtype)
    assert abs(float(aj) - float(at)) < 1e-5
    # moe_apply with no mesh is moe_dense, in both packages
    oj2, _ = jmoe.moe_apply(jp, xj, jc)
    ot2, _ = tmoe.moe_apply(tp, xt, tc)
    assert np.array_equal(as_f32(oj2), as_f32(oj))
    assert torch.equal(ot2, ot)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_and_routed_experts_match_jax(dtype):
    name = "deepseek-moe-16b"
    jp, tp = _params(name, dtype)
    xj, xt = _x(name, dtype)
    _close(jmoe.shared_expert_ffn(jp["shared"], xj),
           tmoe.shared_expert_ffn(tp["shared"], xt), dtype)
    E = STRUCTURES[name][0]
    hj = jmoe._expert_ffn(jp["w_gate"], jp["w_up"], jp["w_down"],
                          jnp.broadcast_to(xj[0], (E,) + xj.shape[1:]))
    ht = tmoe._expert_ffn(tp["w_gate"], tp["w_up"], tp["w_down"],
                          xt[0][None].expand(E, *xt.shape[1:]))
    _close(hj, ht, dtype)


def test_aux_loss_matches_jax_on_skewed_routing():
    """Every token routed to experts 3 and 5, which hold nearly all the
    probability: the loss nears its largest value, E, in both packages."""
    rng = np.random.default_rng(3)
    moe = MoESpec(num_experts=8, top_k=2, d_expert=4)
    jmoe_spec = JMoESpec(num_experts=8, top_k=2, d_expert=4)
    logits = rng.standard_normal((40, 8)).astype(np.float32)
    logits[:, 3] += 20.0
    logits[:, 5] += 19.0
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    ids = np.argsort(-probs, -1)[:, :2].astype(np.int32)
    aj = jmoe._aux_loss(jnp.asarray(probs), jnp.asarray(ids), jmoe_spec)
    at = tmoe._aux_loss(torch.from_numpy(probs),
                        torch.from_numpy(ids).long(), moe)
    assert abs(float(aj) - float(at)) < 1e-5
    assert float(at) > 7.0
