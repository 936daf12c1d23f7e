"""The port stands alone: importing every ``repro_torch`` module (and
``chip_smoke.py``) loads neither JAX nor the JAX package, nor the
``msgpack`` and ``ml_dtypes`` wheels the JAX wire uses, and the smoke
script refuses to run without a CUDA card."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
core = importlib.import_module("repro_torch.core")
for n in core.__all__:        # the lazy re-exports resolve too
    getattr(core, n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack",
                                    "ml_dtypes"))
missing = sorted({{"repro_torch.core.speculation", "repro_torch.core.validation",
                  "repro_torch.serving.engine", "repro_torch.kernels.spec_verify",
                  "repro_torch.kernels.decode_attention",
                  "repro_torch.kernels.rwkv6_scan",
                  "repro_torch.kernels.int8_matmul",
                  "repro_torch.models.rwkv6",
                  "repro_torch.configs.rwkv6_7b",
                  "repro_torch.configs.gemma2_27b",
                  "repro_torch.configs.gemma3_4b",
                  "repro_torch.configs.stablelm_12b",
                  "repro_torch.configs.deepseek_7b",
                  "repro_torch.configs.granite_moe_1b",
                  "repro_torch.configs.deepseek_moe_16b",
                  "repro_torch.models.moe",
                  "repro_torch.configs.jamba_52b",
                  "repro_torch.configs.whisper_base",
                  "repro_torch.configs.internvl2_26b",
                  "repro_torch.configs.inputs",
                  "repro_torch.models.mamba",
                  "repro_torch.core.migration", "repro_torch.core.workspace",
                  "repro_torch.core.channel", "repro_torch.core.attestation",
                  "repro_torch.core.crypto", "repro_torch.core.msgpack_subset",
                  "repro_torch.compression",
                  "repro_torch.serving.prefix_cache",
                  "repro_torch.core.daemon", "repro_torch.core.replication",
                  "repro_torch.fleet", "repro_torch.fleet.lifecycle",
                  "repro_torch.fleet.tracing", "repro_torch.fleet.telemetry",
                  "repro_torch.fleet.router", "repro_torch.fleet.balancer",
                  "repro_torch.fleet.speculative",
                  "repro_torch.fleet.cluster", "repro_torch.fleet.bus",
                  "repro_torch.fleet.service", "repro_torch.fleet.autoscaler",
                  "repro_torch.optim", "repro_torch.optim.compression",
                  "repro_torch.launch", "repro_torch.launch.common",
                  "repro_torch.launch.serve",
                  "repro_torch.launch.fleet",
                  "repro_torch.launch.train", "repro_torch.training",
                  "repro_torch.training.train", "repro_torch.optim.adamw",
                  "repro_torch.data", "repro_torch.data.pipeline",
                  "repro_torch.checkpoint",
                  "repro_torch.checkpoint.disk",
                  "repro_torch.examples",
                  "repro_torch.examples.quickstart",
                  "repro_torch.examples.resilient_failover",
                  "repro_torch.examples.speculative_serving",
                  "repro_torch.examples.speculative_fleet",
                  "repro_torch.examples.validated_medical_agent",
                  "repro_torch.examples.fleet_serving",
                  "repro_torch.examples.train_100m"}} - set(names))
assert not missing, missing
print(len(names), bad)
"""


def _clean_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_imports_neither_jax_nor_repro():
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(src=str(SRC), root=str(ROOT))],
        capture_output=True, text=True, timeout=120, env=_clean_env(),
        cwd=ROOT)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().rsplit("\n", 1)[-1].split(" ", 1)
    assert int(n) >= 55, out.stdout          # every module was imported
    assert bad == "[]", bad


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA the script exits non-zero and prints no result line,
    both from the checkout and from a directory holding only itself."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=120,
                             env=_clean_env(), cwd=cwd)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
