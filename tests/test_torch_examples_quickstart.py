"""``repro_torch.examples.quickstart`` and ``resilient_failover`` against
the JAX package's ``examples/quickstart.py`` and
``examples/resilient_failover.py``, on the same weights (the tiny llama
from ``jax.random.key(0)``, bridged): each JAX example runs once a
module, as it stands, its printed lines captured; the port's scenario
runs on the bridged weights on the CPU; the lines must be equal after
the mask list of each example, each mask with its reason."""

import ast

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import quickstart, resilient_failover  # noqa: E402
from tests.torch_helpers import (assert_same_lines, bridged_params,  # noqa: E402
                                 captured, configs, jax_example)


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


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = configs()
    _, tparams = bridged_params(jcfg)
    return tcfg, tparams


def _count(m):
    return f"[{len(ast.literal_eval(m.group(0)))} tokens]"


# -- quickstart ----------------------------------------------------------------

QUICKSTART_MASKS = [
    (r"\[[\d, ]*\]", _count,
     "sampled tokens: the port draws from its own (seed, counter) state, "
     "so only their number is compared"),
    (r"migrated \d+B raw -> \d+B wire", "migrated <raw>B raw -> <wire>B wire",
     "raw bytes hold the RNG leaf (the port's tag and state); wire bytes "
     "are the codec's output on them"),
    (r"wire in [\d.]+ms", "wire in <clock>ms", "the host clock"),
]


@pytest.fixture(scope="module")
def quickstart_runs(weights):
    _, jax_lines = captured(jax_example("quickstart").main)
    tcfg, tparams = weights
    out, lines = captured(quickstart.run, tcfg, tparams, device="cpu")
    return jax_lines, lines, out


def test_quickstart_prints_the_jax_examples_lines(quickstart_runs):
    jax_lines, lines, _ = quickstart_runs
    assert_same_lines(jax_lines, lines, QUICKSTART_MASKS)


def test_quickstart_continuation_is_the_unmigrated_run(quickstart_runs,
                                                        weights):
    """The JAX example's assert: the migrated run's tokens equal an
    unmigrated run's; here again against a fresh seed-42 engine, and the
    tokens before the hop are its first five."""
    from repro_torch.serving.engine import Engine, Request
    _, _, out = quickstart_runs
    tcfg, tparams = weights
    eng = Engine(tcfg, tparams, slots=2, max_len=64, seed=42, device="cpu")
    req = Request("hello", prompt=np.arange(6), max_new_tokens=12,
                  temperature=0.7, top_k=8)
    eng.add_request(req)
    while eng.requests:
        eng.step()
    assert out["tokens"] == req.output and len(req.output) == 12
    assert out["before"] == req.output[:5]
    assert 0 < out["wire_bytes"] < out["raw_bytes"]


def test_quickstart_check_fires_on_a_changed_continuation(weights,
                                                           monkeypatch):
    """The assertion is live: a hop into an engine that lost the
    request's sampling state (a fresh RNG on arrival) is caught."""
    from repro_torch.core.workspace import AgentWorkspace
    from repro_torch.serving.sampling import rng_state
    tcfg, tparams = weights
    attach = AgentWorkspace.attach

    def reseeded(self, engine):
        engine = attach(self, engine)
        engine.state.rng = rng_state(range(777, 777 + engine.slots))
        return engine

    monkeypatch.setattr(AgentWorkspace, "attach", reseeded)
    with pytest.raises(AssertionError, match="migration changed"):
        captured(quickstart.run, tcfg, tparams, device="cpu")


# -- resilient_failover ----------------------------------------------------------

RESILIENT_MASKS = [
    (r", \d+B total", ", <bytes>B total",
     "each synced workspace blob holds the RNG leaf (the port's tag and "
     "state) and goes through the codec"),
    (r"in \d+ms", "in <clock>ms", "the host clock"),
    (r"\{[^{}]*\}", lambda m: str(dict(sorted(
        ast.literal_eval(m.group(0)).items()))),
     "not a mask: the merged clock's key order is a set's (both packages "
     "build it from a set union), so the dict is compared sorted"),
]
# a departure of the reference, not a mask: at slots == the tiny model's
# repeat count (2) the JAX engine's mask-back (``_bcast``) masks the
# repeat axis, so its decode steps drop the second layer's cache writes
# and fewer workspace pages change between syncs (ROADMAP Queue 3, "the
# JAX mask-back confuses repeats with slots");
# ``test_resilient_failover_delta_fraction_equals_jax_at_three_slots``
# holds the figure exactly where the fault does not fire
RESILIENT_DEPARTURES = [
    (r"sync = \d+% of pages", "sync = <JAX mask-back>% of pages",
     "ROADMAP Queue 3: the JAX mask-back at slots == repeats"),
]


def _jax_sync(slots):
    """The JAX example's first act at ``slots``: the last sync's delta
    fraction and the drafted tokens."""
    import jax
    from repro.configs import get as jget
    from repro.configs.tiny import make_tiny as jtiny
    from repro.core.attestation import measure_config
    from repro.core.replication import ReplicaTier, ReplicationManager
    from repro.core.workspace import AgentWorkspace
    from repro.models.init import init_params
    from repro.serving.engine import Engine, Request
    cfg = jtiny(jget("llama-1.5b"))
    params = init_params(cfg, jax.random.key(0))
    gid = measure_config(cfg)
    mk = lambda s: Engine(cfg, params, slots=slots, max_len=128,  # noqa
                          seed=s)
    mgr = ReplicationManager([
        ReplicaTier("cloud", mk(0), quality=1.0, functionality=1.0),
        ReplicaTier("edge", mk(1), quality=0.8, functionality=0.85),
        ReplicaTier("device", mk(2), quality=0.5, functionality=0.8)])
    cloud = mgr.tiers["cloud"].engine
    req = Request("article", np.arange(8), max_new_tokens=48)
    cloud.add_request(req)
    for _ in range(6):
        cloud.step()
        mgr.sync(AgentWorkspace.from_engine(cloud, gid))
    return mgr.last_delta_fraction, list(req.output)


@pytest.fixture(scope="module")
def resilient_runs(weights):
    _, jax_lines = captured(jax_example("resilient_failover").main)
    tcfg, tparams = weights
    out, lines = captured(resilient_failover.run, tcfg, tparams,
                          device="cpu")
    return jax_lines, lines, out


def test_resilient_failover_prints_the_jax_examples_lines(resilient_runs):
    jax_lines, lines, _ = resilient_runs
    assert_same_lines(jax_lines, lines,
                      RESILIENT_MASKS + RESILIENT_DEPARTURES)


def test_resilient_failover_delta_fraction_equals_jax_at_three_slots(
        resilient_runs, weights):
    """The sync's delta fraction and the drafted greedy tokens equal the
    JAX engine's at three slots, where its mask-back masks the batch
    axis; at the example's two slots they depart (the JAX fault), and
    the port's figure is the three-slot rule's, not the fault's."""
    tcfg, tparams = weights
    jax_delta, jax_tokens = _jax_sync(3)
    out, _ = captured(resilient_failover.run, tcfg, tparams, device="cpu",
                      slots=3)
    assert out["delta_fraction"] == jax_delta
    assert out["tokens"] == jax_tokens
    jax_delta2, _ = _jax_sync(2)
    assert resilient_runs[2]["delta_fraction"] != jax_delta2


def test_resilient_failover_figures(resilient_runs):
    """The returned figures are the printed ones: six tokens drafted,
    failover to the edge inside the paper's 200 ms budget, roaming on
    the device tier, one request kept with both sides' clocks."""
    _, _, out = resilient_runs
    assert out["drafted"] == 6 and out["offline"] == 12
    assert out["failover"] == "edge" and out["latency_s"] < 0.2
    assert out["roaming"] == "device"
    assert out["vclock"] == {"cloud": 1, "edge": 1}
    assert out["preserved"] == 1 and 0 < out["delta_fraction"] < 1
