"""MVVM core: the paper's contribution as composable modules (the port's
copy of the JAX package's ``core``).

workspace    -- the migratable agent state (KV/SSM caches, tokens, rng)
attestation  -- measurements, Merkle trees, quotes, capability vectors
channel      -- simulated network fabric + attested TLS-style sessions
                + the service mode's message transports
migration    -- checkpoint/compress/encrypt/transfer/restore
replication  -- multi-tier replicas, vector clocks, failover
speculation  -- token-level spec decoding + request-level fast/slow merge
validation   -- parallel-with-generation safety validators
daemon       -- privacy-aware placement scheduler (roofline cost model)

The names below are re-exported as in the JAX package, but resolved on
first access: ``serving.engine`` imports ``core.tree``, and
``core.migration`` imports ``serving.engine``, so importing every
submodule here would close that cycle.
"""

import importlib

_EXPORTS = {
    "attestation": ("Attester", "AttestationError", "MerkleTree", "Quote",
                    "TrustAuthority", "capabilities", "measure_config",
                    "semantic_attest"),
    "channel": ("AttestedSession", "Channel", "Fabric", "FrameTooLarge",
                "InProcTransport", "NetworkCondition", "SimClock",
                "SocketTransport", "Transport"),
    "daemon": ("CLOUD", "EDGE", "MCU", "DeviceProfile", "PlacementDecision",
               "PrivacyAwareDaemon", "placement_allowed"),
    "migration": ("MigrationReport", "Migrator", "Snapshot", "criu_restore",
                  "criu_snapshot", "pack_slot", "qemu_snapshot",
                  "unpack_slot"),
    "replication": ("FULL_TIER", "FailoverEvent", "QualityTier",
                    "ReplicaTier", "ReplicationManager"),
    "speculation": ("SpecStats", "SpeculationOutcome", "SpeculativeExecutor",
                    "autoregressive_generate", "speculative_generate"),
    "validation": ("ValidationFramework", "ValidationReport", "Validator",
                   "default_zoo"),
    "workspace": ("AgentWorkspace", "VectorClock"),
}
_OWNER = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = sorted(_OWNER)


def __getattr__(name):
    mod = _OWNER.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value
