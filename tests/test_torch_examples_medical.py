"""``repro_torch.examples.validated_medical_agent`` against the JAX
package's ``examples/validated_medical_agent.py`` on the same weights
(the tiny llama from ``jax.random.key(0)``, bridged) and the same device
profiles (the JAX package's; the port's own ``CLOUD`` is the H100's),
line for line after the mask list; and every example's ``main``: with no
card it stops with the device's error, with ``--device cpu`` it runs the
tiny scenario to the end."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import validated_medical_agent  # noqa: E402
from tests.torch_helpers import (assert_same_lines, bridged_params,  # noqa: E402
                                 captured, configs, jax_example,
                                 jax_profiles)

MEDICAL_MASKS = [
    (r"validator '\w+' INTERVENED at position -?\d+",
     "validator <rng> INTERVENED at position <rng>",
     "the validated tokens are sampled from the port's own RNG, so which "
     "validator stops the stream, and where, differ"),
    (r"\(\d+ safe tokens kept\)", "(<rng> safe tokens kept)",
     "the same: the kept prefix ends where the stream was stopped"),
    (r"wall \d+ms", "wall <clock>ms", "the host clock"),
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
def medical_runs():
    _, jax_lines = captured(jax_example("validated_medical_agent").main)
    jcfg, tcfg = configs()
    _, tparams = bridged_params(jcfg)
    prof = jax_profiles()
    out, lines = captured(validated_medical_agent.run, tcfg, tparams,
                          device="cpu", local=prof["edge"],
                          remote=prof["cloud"])
    return jax_lines, lines, out, (tcfg, tparams)


def test_medical_prints_the_jax_examples_lines(medical_runs):
    jax_lines, lines, _, _ = medical_runs
    assert_same_lines(jax_lines, lines, MEDICAL_MASKS)


def test_medical_intervenes_at_or_before_the_planted_marker(medical_runs):
    """The stream is stopped no later than the planted medical marker
    (the 9th emitted token, position 8), and the decisions are the JAX
    daemon's on the same profiles: local by policy, then remote."""
    _, _, out, _ = medical_runs
    assert out["intervened"] and out["position"] <= 8
    assert out["kept"] <= 8 and out["mode"] == "parallel"
    assert (out["default"], out["hospital"]) == ("local", "remote")


def test_medical_check_fires_without_an_intervention(medical_runs):
    """The intervention check is live: with a zoo whose one validator
    never fires, the run raises."""
    from repro_torch.core import validation
    _, _, _, (tcfg, tparams) = medical_runs

    class Never(validation.Validator):
        kind = "never"

        def check(self, tokens, logprobs=None):
            return validation.Verdict(True, self.kind, 1.0)

    zoo = validation.default_zoo
    validation.default_zoo = lambda seed=0: [Never()]
    try:
        with pytest.raises(AssertionError, match="no validator"):
            captured(validated_medical_agent.run, tcfg, tparams,
                     device="cpu", max_new=4)
    finally:
        validation.default_zoo = zoo


def test_port_cloud_is_the_card():
    """By default the daemon's remote is the port's ``CLOUD`` (one H100),
    so the hospital speedup is the port's own figure, not JAX's."""
    from repro.core import daemon as jdaemon
    from repro_torch.configs import get
    from repro_torch.core.daemon import CLOUD, EDGE, PrivacyAwareDaemon
    d = PrivacyAwareDaemon(EDGE, CLOUD,
                           max_remote_sensitivity="confidential")
    dec = d.decide(sensitivity="confidential", cfg=get("llama-1.5b"),
                   prefill_tokens=200_000, decode_tokens=20_000,
                   workspace_bytes=10 ** 8)
    assert dec.target == "remote"
    assert CLOUD.peak_flops != jdaemon.CLOUD.peak_flops
    assert dec.speedup == pytest.approx(
        PrivacyAwareDaemon.step_time(get("llama-1.5b"), EDGE,
                                     prefill_tokens=200_000,
                                     decode_tokens=20_000)
        / PrivacyAwareDaemon.step_time(get("llama-1.5b"), CLOUD,
                                       prefill_tokens=200_000,
                                       decode_tokens=20_000))


# -- every example's entry point -------------------------------------------------

EXAMPLES = ("quickstart", "resilient_failover", "validated_medical_agent",
            "speculative_serving", "speculative_fleet", "fleet_serving",
            "train_100m")


def _main(name):
    import importlib
    return importlib.import_module(f"repro_torch.examples.{name}").main


@pytest.mark.parametrize("name", EXAMPLES)
def test_main_without_a_card_raises_the_devices_error(name, monkeypatch):
    """The default device is the card: with none, ``main`` stops with
    ``device.resolve``'s error (no fallback to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _main(name)([])


@pytest.mark.parametrize("name", EXAMPLES)
def test_main_on_the_cpu_exits_0(name, tmp_path, capsys):
    """``--device cpu`` runs the tiny scenario to the end; the trainer
    at 3 steps of 2 x 32 tokens into a temporary directory (its default,
    120 steps of 8 x 128, is the same code for longer)."""
    argv = ["--device", "cpu"]
    if name == "train_100m":
        argv += ["--steps", "3", "--batch", "2", "--seq", "32",
                 "--ckpt-dir", str(tmp_path)]
    assert _main(name)(argv) == 0
    assert capsys.readouterr().out.strip()
