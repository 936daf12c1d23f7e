"""``repro_torch.examples.speculative_fleet`` against the JAX package's
``examples/speculative_fleet.py`` on the same weights (the tiny llama
from ``jax.random.key(0)``, bridged) and the same device profiles (the
JAX package's; the port's own ``CLOUD`` is the H100's): the JAX example
runs once a module as it stands, the port's scenario on the bridged
weights; the printed lines must be equal after the mask list.  At
drafter T 0 every figure but the hand-off's bytes is compared exactly:
the acceptance, the rounds, the committed tokens (the one-program
contract: equal to a pure cloud engine's)."""

import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import speculative_fleet  # noqa: E402
from tests.torch_helpers import (assert_same_lines, captured,  # noqa: E402
                                 fleet_weights, jax_example, jax_profiles)

SAMPLED = r"drafter T=(0\.8|1\.5): acceptance +[\d.]+% \(\d+/\d+\), \d+ rounds, \d+ corrections"

FLEET_MASKS = [
    (SAMPLED, lambda m: f"drafter T={m.group(1)}: <rng>",
     "a sampling drafter draws from the port's own RNG: its acceptance, "
     "rounds and corrections differ"),
    (r"hand-off \d+ B/slot", "hand-off <bytes> B/slot",
     "each handed-off slot blob holds the RNG leaf (the port's tag and "
     "state)"),
]


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
def runs():
    _, jax_lines = captured(jax_example("speculative_fleet").main)
    tcfg, tparams = fleet_weights()["torch"]["full"]
    prof = jax_profiles()
    out, lines = captured(speculative_fleet.run, tcfg, tparams,
                          device="cpu", edge=prof["edge"],
                          cloud=prof["cloud"])
    return jax_lines, lines, out


def test_speculative_fleet_prints_the_jax_examples_lines(runs):
    jax_lines, lines, _ = runs
    assert_same_lines(jax_lines, lines, FLEET_MASKS)


def test_speculative_fleet_greedy_figures(runs):
    """T 0: every draft accepted (edge and cloud share weights), 96/96 in
    8 rounds; the confidential request local; no intervention on a
    random model.  The hand-off bytes differ from JAX's by the RNG leaf
    alone: the same number for every slot at T 0."""
    jax_lines, _, out = runs
    t0 = out["tiers"][0.0]
    assert (t0["accepted"], t0["proposed"], t0["rounds"],
            t0["corrections"]) == (96, 96, 8, 0)
    assert out["conf_placements"] == ["edge"]
    assert out["local_fallbacks"] == 1
    jax_b = int(re.search(r"T=0\.0:.*hand-off (\d+) B/slot",
                          "\n".join(jax_lines)).group(1))
    assert abs(t0["handoff_bytes"] - jax_b) < 64


def test_speculative_fleet_assert_fires(runs, monkeypatch):
    """The JAX example's assert is live: a pure cloud engine whose greedy
    output differs (its drain shifted by one token) fails the run."""
    tcfg, tparams = fleet_weights()["torch"]["full"]
    real = speculative_fleet.drain

    def shifted(engine, reqs):
        outs = real(engine, reqs)
        return {r: [(t + 1) % tcfg.vocab_size for t in o]
                for r, o in outs.items()}

    monkeypatch.setattr(speculative_fleet, "drain", shifted)
    with pytest.raises(AssertionError, match="pure cloud"):
        captured(speculative_fleet.run, tcfg, tparams, device="cpu",
                 temperatures=(0.0,), n_prompts=2, max_new=4)
