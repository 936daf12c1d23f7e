"""``repro_torch.examples.fleet_serving`` against the JAX package's
``examples/fleet_serving.py`` on the same weights (the tiny llama from
``jax.random.key(0)``, bridged; the lite tier each package's own int8
round trip of them) and the same device profiles (the JAX package's; the
port's own ``CLOUD`` is the H100's).  The JAX example runs once a module
as it stands, the port's five acts once in their chain; each act's
printed lines must equal the JAX act's after the mask list.  Placements,
tiers, telemetry counts, the greedy chat result and the prefix cache's
hits, misses and bytes are compared exactly."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import fleet_serving  # noqa: E402
from tests.torch_helpers import (assert_same_lines, captured,  # noqa: E402
                                 fleet_weights, jax_example, jax_profiles,
                                 to_numpy)

FLEET_MASKS = [
    (r"'tokens_per_s': [\d.]+", "'tokens_per_s': <clock>", "the host clock"),
    (r"'(p50|p95|p99)': [\d.]+", lambda m: f"'{m.group(1)}': <clock>",
     "request latencies on the host clock"),
    (r"'(queue_wait_p50|preempt_wait_p50)': [\d.]+",
     lambda m: f"'{m.group(1)}': <clock>", "waits on the host clock"),
]

# each act's first line
ACTS = (("failover", "mid-decode placement"),
        ("lifecycle", "-- act two"),
        ("autoscale", "-- act three"),
        ("quality", "-- act four"),
        ("prefix", "-- act five"))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for this module, as in
    ``tests/test_torch_train_parity.py``: the tiny models' ops are too
    small to split, and under the suite's six workers on a shared CPU
    the split costs many times the module's time alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sections(lines) -> dict:
    """The printed lines split by act."""
    starts = [next(i for i, ln in enumerate(lines) if ln.startswith(head))
              for _, head in ACTS]
    ends = starts[1:] + [len(lines)]
    return {name: lines[a:b] for (name, _), a, b in zip(ACTS, starts, ends)}


@pytest.fixture(scope="module")
def runs():
    _, jax_lines = captured(jax_example("fleet_serving").main)
    tcfg, tparams = fleet_weights()["torch"]["full"]
    prof = jax_profiles()
    out, lines = captured(fleet_serving.run, tcfg, tparams, device="cpu",
                          **prof)
    return sections(jax_lines), sections(lines), out


@pytest.mark.parametrize("act", [a for a, _ in ACTS])
def test_fleet_serving_act_prints_the_jax_examples_lines(runs, act):
    jax_acts, acts, _ = runs
    masks = [m for m in FLEET_MASKS
             if any(re.search(m[0], ln)
                    for ln in jax_acts[act])]
    assert_same_lines(jax_acts[act], acts[act], masks)


def test_fleet_serving_figures(runs):
    """The returned figures: the policy held (no sensitive request on the
    phone), the batch job parked and resumed to its 20 tokens, both
    floors kept, both follow-ups warm."""
    _, _, out = runs
    for rid, path in out["failover"]["placements"].items():
        if int(rid[4:]) % 3:
            assert "phone" not in path, (rid, path)
    assert all(len(o) == 14 for o in out["failover"]["outputs"].values())
    life = out["lifecycle"]
    assert len(life["batch"]) == 20 and len(life["chat"]) == 8
    assert life["doomed"] == "cancelled" and life["free"]
    assert out["autoscale"]["retires"] == 2
    assert out["autoscale"]["pool"] == ["seed"]
    assert out["quality"]["tiers"]["strict"] == "full"
    assert set(out["quality"]["cut"].values()) == {"edge-box"}
    assert out["prefix"]["routed"] == {"ada1": "left", "bob1": "right"}
    assert out["prefix"]["stats"]["hits"] == 2


def examples_int8_round_trip():
    """The JAX example's own ``int8_round_trip`` (nested in its
    ``quality_act``, ``examples/fleet_serving.py``), compiled from the
    example's source."""
    import ast
    import inspect
    import textwrap

    import jax
    import jax.numpy as jnp

    from repro.optim.compression import dequantize_int8, quantize_int8
    src = inspect.getsource(jax_example("fleet_serving").quality_act)
    fn = next(n for n in ast.walk(ast.parse(textwrap.dedent(src)))
              if isinstance(n, ast.FunctionDef)
              and n.name == "int8_round_trip")
    ns = dict(jax=jax, jnp=jnp, quantize_int8=quantize_int8,
              dequantize_int8=dequantize_int8)
    exec(compile(ast.Module([fn], []), "<example>", "exec"), ns)
    return ns["int8_round_trip"]


def test_lite_tier_is_the_jax_examples_tree_map():
    """Act four's lite weights: the port's ``int8_round_trip`` equals the
    JAX example's own tree map (``quantize_int8`` / ``dequantize_int8``
    of every floating leaf, back in its dtype) leaf for leaf, bit for
    bit, on the same weights."""
    from repro_torch.core.tree import leaves_with_path
    from repro_torch.models.init import params_to_numpy
    from repro_torch.optim.compression import int8_round_trip
    jparams = fleet_weights()["jax"]["full"][1]
    tparams = fleet_weights()["torch"]["full"][1]
    want = dict(leaves_with_path(to_numpy(
        examples_int8_round_trip()(jparams))))
    got = dict(leaves_with_path(params_to_numpy(int8_round_trip(tparams))))
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
