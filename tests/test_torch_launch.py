"""The port's two CLIs on the CPU, in-process through ``main([...])`` with
``--tiny --device cpu``: the README's and the verify notes' probes of the
JAX package's ``repro.launch.fleet`` / ``repro.launch.serve`` -- the
default sim fleet with a failure, the socket transport (service mode),
the speculative tiers, priorities with preemption, the autoscaler, the
quality tiers with a link cut, the prefix cache, the exporters -- each
exit 0 with its lines; ``STALLED`` exit 1; the usage errors (an unknown
profile, an architecture the port lacks, socket with a sim-only flag)
exit 2; without ``--device`` and without a card, each CLI ends with the
device's refusal and never runs on the CPU.  One case holds the
telemetry JSON's keys equal to the JAX CLI's for the same flags."""

import json
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import fleet as fleet_cli  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402

TINY = ["--tiny", "--device", "cpu"]


def run(cli, argv, capsys):
    """(exit code, stdout, stderr) of ``cli.main(argv)``."""
    try:
        code = cli.main(argv)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
        if not isinstance(e.code, int) and e.code is not None:
            print(e.code, file=sys.stderr)
    out, err = capsys.readouterr()
    return code, out, err


def telemetry(out: str) -> dict:
    """The indented telemetry JSON block the fleet CLI prints."""
    lines = out.splitlines()
    start = lines.index("{")
    end = start + lines[start:].index("}")
    return json.loads("\n".join(lines[start:end + 1]))


def keys(d) -> object:
    if isinstance(d, dict):
        return {k: keys(v) for k, v in d.items()}
    return None


def test_serve_runs_and_prints_its_summary(capsys):
    code, out, _ = run(serve_cli, TINY + ["--requests", "4", "--max-new",
                                          "8", "--validate"], capsys)
    assert code == 0
    assert "r0[public] -> " in out
    assert out.splitlines()[-1].startswith("32 tokens in ")
    assert out.splitlines()[-1].endswith("tok/s on cpu)")


def test_fleet_default_with_a_failure(capsys):
    code, out, _ = run(fleet_cli, TINY + [
        "--requests", "9", "--max-new", "8", "--slots", "2", "--max-len",
        "64", "--fail", "cloud@4"], capsys)
    assert code == 0
    assert "-- failing cloud at step 4 --" in out
    assert "r0[public       p0   done     ] via " in out
    tel = telemetry(out)
    assert tel["fleet"]["failovers"] >= 1
    assert "simulated wire time:" in out


def test_fleet_socket_transport_service_mode(capsys, tmp_path):
    trace, metrics = tmp_path / "t.json", tmp_path / "m.txt"
    code, out, _ = run(fleet_cli, TINY + [
        "--requests", "12", "--engines", "a:edge,b:edge,c:edge",
        "--transport", "socket", "--trace-out", str(trace),
        "--metrics-out", str(metrics)], capsys)
    assert code == 0
    last = [ln for ln in out.splitlines() if ln.startswith("service mode")]
    assert last and last[0].startswith("service mode: 12 requests, 192 "
                                       "tokens in ")
    assert last[0].endswith("0 heartbeat losses)")
    assert out.count(" done     ] via ") == 12
    assert json.loads(trace.read_text())["traceEvents"]
    assert "fleet_request_latency_seconds" in metrics.read_text()


def test_fleet_speculative_tiers(capsys):
    code, out, _ = run(fleet_cli, TINY + [
        "--requests", "6", "--max-new", "8", "--slots", "3", "--engines",
        "edge:edge:64,cloud:cloud:160,mcu:mcu", "--spec-tiers", "edge:cloud",
        "--drafter-temperature", "0.8"], capsys)
    assert code == 0
    line = [ln for ln in out.splitlines()
            if ln.startswith("speculative tier edge->cloud: ")]
    assert line
    stats = json.loads(line[0].split(": ", 1)[1])
    assert stats["handoffs"] > 0
    assert "via edge->cloud" in out


def test_fleet_priorities_preempt(capsys):
    code, out, _ = run(fleet_cli, TINY + [
        "--requests", "6", "--max-new", "10", "--slots", "2", "--engines",
        "edge:edge", "--priorities", "0,5,10", "--temperature", "0",
        "--queue-limit", "1"], capsys)
    assert code == 0
    assert "preempted r" in out and "preempted by r" in out
    assert telemetry(out)["lifecycle"]["preemptions"] > 0


def test_fleet_autoscale_spawns_and_retires(capsys):
    code, out, _ = run(fleet_cli, TINY + [
        "--requests", "10", "--max-new", "8", "--slots", "2", "--engines",
        "edge:edge", "--autoscale", "1:3", "--scale-up-queue-depth", "3",
        "--scale-cooldown-s", "0", "--warm-pool", "1"], capsys)
    assert code == 0
    assert "scale spawn auto" in out and "queue depth" in out
    assert "scale retire auto" in out and "idle: utilization" in out
    lc = telemetry(out)["lifecycle"]
    assert lc["scale_ups"] > 0 and lc["scale_downs"] > 0
    assert "via auto" in out


def test_fleet_quality_tiers_downshift(capsys, tmp_path):
    """The docstring's tier example: saturation downshifts unfloored
    work to the int8 tier, never below a floor; a cut link downshifts
    by link (floor 0), and with floored work behind the cut the fleet
    stalls with exit 1, as the JAX CLI does."""
    otlp = tmp_path / "o.json"
    tiers = ["--tiers", "full:1.0:bf16,lite:0.6:int8", "--engines",
             "big:cloud:128:full,small:edge:128:lite"]
    code, out, _ = run(fleet_cli, TINY + tiers + [
        "--requests", "8", "--slots", "2", "--quality-floor", "0,0.8",
        "--otlp-out", str(otlp)], capsys)
    assert code == 0
    assert "quality downshift r2 full->lite (q=0.60): saturated" in out
    assert json.loads(otlp.read_text())["resourceSpans"]
    code, out, _ = run(fleet_cli, TINY + tiers + [
        "--requests", "8", "--slots", "1", "--link-down", "big@2"], capsys)
    assert code == 0
    assert "-- link to big down at step 2 --" in out
    assert "(q=0.60): link" in out
    code, out, _ = run(fleet_cli, TINY + tiers + [
        "--requests", "8", "--slots", "2", "--quality-floor", "0,0.8",
        "--link-down", "big@4"], capsys)
    assert code == 1
    assert "STALLED r3[public]: all eligible engines unreachable" in out


def test_fleet_prefix_cache_tenants(capsys):
    code, out, _ = run(fleet_cli, TINY + [
        "--requests", "6", "--max-new", "4", "--slots", "2", "--engines",
        "a:edge,b:cloud", "--prefix-cache", "--tenants", "2"], capsys)
    assert code == 0
    assert "prefix cache: " in out and " hits / " in out


def test_fleet_unattested_only_stalls_with_exit_1(capsys):
    code, out, _ = run(fleet_cli, TINY + ["--engines", "mcu:mcu",
                                          "--requests", "3"], capsys)
    assert code == 1
    assert "STALLED r1[personal]: " in out


def test_fleet_unknown_profile_is_a_usage_error(capsys):
    code, _, err = run(fleet_cli, TINY + ["--engines", "edge:tpu"], capsys)
    assert code == 2
    assert "unknown profile 'tpu'" in err


@pytest.mark.parametrize("flag", [
    ["--spec-tiers", "a:b"], ["--autoscale", "1:2"], ["--fail", "a@1"],
    ["--drain", "a@1"], ["--link-down", "a@1"]])
def test_fleet_socket_refuses_sim_only_flags(flag, capsys):
    code, _, err = run(fleet_cli, TINY + [
        "--engines", "a:edge,b:edge", "--transport", "socket"] + flag,
        capsys)
    assert code == 2
    assert "sim-only" in err and "transport matrix" in err


@pytest.mark.parametrize("cli", [fleet_cli, serve_cli],
                         ids=["fleet", "serve"])
def test_arch_the_port_lacks_is_a_usage_error(cli, capsys):
    """whisper-base and internvl2-26b are ported, but take frames or
    patch embeddings, which no engine feeds: a usage error naming the
    token-only rule."""
    for arch in ("whisper-base", "internvl2-26b"):
        code, _, err = run(cli, TINY + ["--arch", arch], capsys)
        assert code == 2
        assert "token-only" in err and arch in err


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="shows the refusal on a machine without a card")
@pytest.mark.parametrize("cli", [fleet_cli, serve_cli],
                         ids=["fleet", "serve"])
def test_default_device_is_the_card_and_never_falls_back(cli, capsys):
    code, out, err = run(cli, ["--tiny", "--requests", "1"], capsys)
    assert code == 1
    assert "torch.cuda.is_available() is False" in err
    assert "tokens" not in out and "via" not in out


def test_telemetry_keys_match_the_jax_cli(capsys, monkeypatch):
    """The JAX CLI and the port's print telemetry JSON with the same key
    tree for the same flags."""
    from repro.launch import fleet as jax_cli
    flags = ["--tiny", "--requests", "4", "--max-new", "4", "--slots", "2",
             "--max-len", "64", "--engines", "edge:edge,cloud:cloud",
             "--drain", "cloud@2"]
    monkeypatch.setattr(sys, "argv", ["repro.launch.fleet"] + flags)
    jax_cli.main()
    jout, _ = capsys.readouterr()
    code, tout, _ = run(fleet_cli, flags + ["--device", "cpu"], capsys)
    assert code == 0
    jtel, ttel = telemetry(jout), telemetry(tout)
    assert keys(ttel) == keys(jtel)
    assert ttel["fleet"]["tokens"] == jtel["fleet"]["tokens"] == 16
