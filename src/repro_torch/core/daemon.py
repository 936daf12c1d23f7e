"""Privacy-aware daemon: the placement scheduler (paper §7.4, §9.4).

Decides local-vs-remote execution from
  (1) data-sensitivity policy -- confidential workloads never leave the
      local enclave unless the remote attests AND policy allows;
  (2) a roofline cost model of both endpoints -- decode is HBM-bound
      (active param bytes / bandwidth per token), prefill is
      tensor-core-bound (2*N_active*S FLOPs / peak);
  (3) migration amortization -- the paper's empirical rule: migrate only
      when remote speedup >= 1.5x and remaining work >= 2x migration time.

The port's copy of the JAX package's ``core.daemon``.  Its ``CLOUD`` is
the card the port runs on, one H100 SXM; ``EDGE`` and ``MCU`` keep the
reference's figures.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig
from repro_torch.core.channel import NetworkCondition


@dataclass(frozen=True)
class DeviceProfile:
    name: str
    peak_flops: float                # bf16
    hbm_bw: float                    # bytes/s
    chips: int = 1
    attested: bool = True

    @property
    def agg_flops(self):
        return self.peak_flops * self.chips

    @property
    def agg_bw(self):
        return self.hbm_bw * self.chips


# edge = one M3-Max-class device; mcu = a Cortex-M-class endpoint with
# no enclave (never attested); cloud = one H100 SXM, from its data sheet
# (dense bf16 tensor-core peak, HBM3 rate), as chip_smoke.py's bounds
EDGE = DeviceProfile("edge", peak_flops=25e12, hbm_bw=400e9, chips=1)
CLOUD = DeviceProfile("cloud", peak_flops=989e12, hbm_bw=3.35e12, chips=1)
MCU = DeviceProfile("mcu", peak_flops=5e11, hbm_bw=25e9, chips=1,
                    attested=False)


@dataclass
class PlacementDecision:
    target: str                      # "local" | "remote"
    reason: str
    est_local_s: float = 0.0
    est_remote_s: float = 0.0
    migration_s: float = 0.0
    speedup: float = 1.0


SENSITIVITY_RANK = {"public": 0, "personal": 1, "confidential": 2}


def placement_allowed(sensitivity: str, profile: DeviceProfile,
                      max_unattested: str = "public") -> bool:
    """The sensitivity/attestation rule, factored out so the fleet router
    and the pairwise daemon share one policy: data above
    ``max_unattested`` may only be placed on an attested device."""
    if profile.attested:
        return True
    return SENSITIVITY_RANK[sensitivity] <= SENSITIVITY_RANK[max_unattested]


class PrivacyAwareDaemon:
    def __init__(self, local: DeviceProfile = EDGE,
                 remote: DeviceProfile = CLOUD,
                 net: NetworkCondition | None = None,
                 *, min_speedup: float = 1.5,
                 amortize_factor: float = 2.0,
                 max_remote_sensitivity: str = "personal"):
        self.local, self.remote = local, remote
        self.net = net or NetworkCondition()
        self.min_speedup = min_speedup
        self.amortize_factor = amortize_factor
        self.max_remote_sensitivity = max_remote_sensitivity

    # -- roofline cost model -------------------------------------------------
    @staticmethod
    def step_time(cfg: ModelConfig, profile: DeviceProfile, *,
                  prefill_tokens: int = 0, decode_tokens: int = 0,
                  param_bytes: int | None = None) -> float:
        from repro_torch.models.init import param_bytes as pb
        n_bytes = param_bytes if param_bytes is not None else pb(cfg)
        active_bytes = n_bytes
        if cfg.moe is not None:          # only routed top-k touched/token
            m = cfg.moe
            frac = (m.top_k + m.num_shared) / (m.num_experts + m.num_shared)
            active_bytes = int(n_bytes * max(frac, 0.05))
        n_active_params = active_bytes // 2          # bf16
        t = 0.0
        if prefill_tokens:                           # tensor-core-bound
            t += 2 * n_active_params * prefill_tokens / profile.agg_flops
        if decode_tokens:                            # HBM-bound
            t += decode_tokens * active_bytes / profile.agg_bw
        return t

    def migration_time(self, workspace_bytes: int,
                       compress_ratio: float = 4.0) -> float:
        wire = workspace_bytes / compress_ratio
        return (self.net.transfer_time(int(wire))
                + 0.05          # attestation (paper: ~50ms)
                + workspace_bytes / 2e9 * 2)  # serialize+restore @2GB/s

    # -- decision -------------------------------------------------------------
    def decide(self, *, sensitivity: str, cfg: ModelConfig,
               prefill_tokens: int, decode_tokens: int,
               workspace_bytes: int,
               param_bytes: int | None = None) -> PlacementDecision:
        if SENSITIVITY_RANK[sensitivity] > \
                SENSITIVITY_RANK[self.max_remote_sensitivity]:
            return PlacementDecision("local",
                                     f"policy: {sensitivity} data must "
                                     "stay in the local enclave")
        if not self.remote.attested:
            return PlacementDecision("local", "remote enclave unattested")
        if not self.net.up:
            return PlacementDecision("local", "network down")

        t_local = self.step_time(cfg, self.local,
                                 prefill_tokens=prefill_tokens,
                                 decode_tokens=decode_tokens,
                                 param_bytes=param_bytes)
        t_remote = self.step_time(cfg, self.remote,
                                  prefill_tokens=prefill_tokens,
                                  decode_tokens=decode_tokens,
                                  param_bytes=param_bytes)
        t_mig = self.migration_time(workspace_bytes)
        speedup = t_local / max(t_remote, 1e-12)
        dec = PlacementDecision("local", "", t_local, t_remote, t_mig,
                                speedup)
        if speedup < self.min_speedup:
            dec.reason = (f"speedup {speedup:.2f}x < "
                          f"{self.min_speedup}x threshold")
            return dec
        if t_local < self.amortize_factor * t_mig:
            dec.reason = (f"work {t_local:.2f}s < {self.amortize_factor}x "
                          f"migration {t_mig:.2f}s (not amortized)")
            return dec
        dec.target = "remote"
        dec.reason = (f"speedup {speedup:.2f}x, work {t_local:.2f}s >= "
                      f"{self.amortize_factor}x migration {t_mig:.2f}s")
        return dec
