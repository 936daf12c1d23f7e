"""Attestation: measurements, Merkle trees, quotes, capabilities,
semantic (accelerator) attestation.  Paper §5-§6.

Mapping to MVVM:
  global_id   = SHA-256 over (runtime version, canonical model config,
                parameter Merkle root)  -- the enclave-binary measurement
  entry_id    = capability vector (WASI interface set); a migration is
                refused unless the target's capabilities cover the
                workload's requirements (e.g. WASI-NN / ID_1003 -> our
                KERNEL_* and family capabilities)
  quote       = signed(global_id, entry_ids, nonce, monotonic counter)
  semantic attestation = canonical inputs through kernel vs oracle with
                epsilon bounds (paper: accelerators may differ in fp
                behaviour; byte-level attestation would fail)

This is the port's copy.  Leaves are named by their JAX key paths and
hashed over their numpy bytes and dtype name (``core.tree``), so the
same weights give the same Merkle root in both packages, and an
enclave's platform comes from a torch device (``cuda`` is ``"gpu"``).

Root of trust is simulated: each "enclave" holds an HMAC key issued by a
``TrustAuthority`` standing in for the PSP/TPM.  All protocol logic
(freshness windows, counters, whitelists, transitive chains) is real and
unit-tested; the signature primitive is swappable.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import time
from dataclasses import dataclass, field, asdict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import leaves_with_path, to_numpy

RUNTIME_VERSION = "mvvm-torch-1.0"
FRESHNESS_WINDOW_S = 300.0          # paper: 5-minute sliding window


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def measure_config(cfg: ModelConfig) -> str:
    """Canonical-JSON measurement of the model configuration."""
    def default(o):
        if hasattr(o, "__dataclass_fields__"):
            return asdict(o)
        return str(o)
    blob = json.dumps(asdict(cfg), sort_keys=True, default=default)
    return sha256(blob.encode())


# ---------------------------------------------------------------------------
# Merkle tree over parameters (incremental attestation, paper §6)
# ---------------------------------------------------------------------------

def _leaf_hashes(params) -> dict[str, str]:
    out = {}
    for key, leaf in leaves_with_path(params):
        arr, dtype = to_numpy(leaf)
        out[key] = sha256(arr.tobytes() + dtype.encode())
    return out


@dataclass
class MerkleTree:
    """Binary Merkle tree over sorted parameter leaves.

    ``update(changed)`` re-hashes only touched leaves and the O(log n)
    path to the root -- the paper's incremental attestation for models
    under frequent fine-tuning."""
    leaves: dict[str, str]
    _levels: list[list[str]] = field(default_factory=list)

    @classmethod
    def build(cls, params) -> "MerkleTree":
        t = cls(leaves=_leaf_hashes(params))
        t._rebuild()
        return t

    def _rebuild(self):
        level = [self.leaves[k] for k in sorted(self.leaves)]
        self._levels = [level]
        while len(level) > 1:
            nxt = []
            for i in range(0, len(level), 2):
                pair = level[i] + (level[i + 1] if i + 1 < len(level)
                                   else level[i])
                nxt.append(sha256(pair.encode()))
            level = nxt
            self._levels.append(level)

    @property
    def root(self) -> str:
        return self._levels[-1][0] if self._levels else sha256(b"")

    def update(self, changed_params) -> tuple[str, int]:
        """Re-hash only the changed leaves.  Returns (root, n_rehashed)."""
        new = _leaf_hashes(changed_params)
        n = 0
        for k, h in new.items():
            if self.leaves.get(k) != h:
                self.leaves[k] = h
                n += 1
        self._rebuild()  # O(n) here; O(log n) path-update on real trees
        return self.root, n


# ---------------------------------------------------------------------------
# capabilities (entry_id set)
# ---------------------------------------------------------------------------

def platform_of(device=None) -> str:
    """The JAX backend name of a torch device: ``cuda`` is ``"gpu"``.
    With no device, the default one: the card if there is one."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    kind = torch.device(device).type
    return "gpu" if kind == "cuda" else kind


def capabilities(cfg: ModelConfig, *, max_kv_len: int = 1 << 20,
                 platform: str | None = None) -> frozenset[str]:
    """The entry_id set an enclave running ``cfg`` advertises; its
    platform is ``platform``, else that of the default device."""
    caps = {"WASI_CORE", f"MAX_KV_LEN:{max_kv_len}"}
    platform = platform or platform_of()
    caps.add("WASI_NN" if platform in ("tpu", "gpu") else "WASI_NN_CPU")
    if cfg.moe is not None:
        caps.add("MOE_EP")
    kinds = {ls.mixer for ls in cfg.layer_specs()}
    if kinds & {"rwkv", "mamba"} or kinds == {"local"}:
        caps.add("SUBQUADRATIC_ATTN")
    if "local" in kinds:
        caps.add("WINDOWED_ATTN")
    if cfg.cross_attention:
        caps.add("ENC_DEC")
    return frozenset(caps)


def required_capabilities(cfg: ModelConfig, kv_len: int) -> frozenset[str]:
    req = set()
    if cfg.moe is not None:
        req.add("MOE_EP")
    if cfg.cross_attention:
        req.add("ENC_DEC")
    req.add(f"KV_LEN:{kv_len}")
    return frozenset(req)


def covers(have: frozenset[str], need: frozenset[str]) -> bool:
    max_kv = max((int(c.split(":")[1]) for c in have
                  if c.startswith("MAX_KV_LEN:")), default=0)
    for c in need:
        if c.startswith("KV_LEN:"):
            if int(c.split(":")[1]) > max_kv:
                return False
        elif c not in have:
            return False
    return True


# ---------------------------------------------------------------------------
# quotes + trust authority (simulated PSP/TPM)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Quote:
    global_id: str
    entry_ids: frozenset[str]
    nonce: str
    counter: int
    timestamp: float
    signature: str

    def payload(self) -> bytes:
        return json.dumps({
            "global_id": self.global_id,
            "entry_ids": sorted(self.entry_ids),
            "nonce": self.nonce,
            "counter": self.counter,
            "timestamp": self.timestamp,
        }, sort_keys=True).encode()


class TrustAuthority:
    """Simulated hardware root of trust: issues per-enclave HMAC keys and
    verifies signatures.  Stands in for the TDX QGS / PSP."""

    def __init__(self, seed: bytes = b"mvvm-root"):
        self._root = hashlib.sha256(seed).digest()

    def issue_key(self, enclave_id: str) -> bytes:
        return hmac.new(self._root, enclave_id.encode(),
                        hashlib.sha256).digest()

    def verify(self, enclave_id: str, quote: Quote) -> bool:
        key = self.issue_key(enclave_id)
        expect = hmac.new(key, quote.payload(), hashlib.sha256).hexdigest()
        return hmac.compare_digest(expect, quote.signature)

    def pair_key(self, a: str, b: str) -> bytes:
        """KMS-style pairwise secret (stands in for the ECDH exchange of a
        real TLS-1.3 handshake; only attested enclaves may request it)."""
        ids = "|".join(sorted([a, b]))
        return hmac.new(self._root, b"pair:" + ids.encode(),
                        hashlib.sha256).digest()


class AttestationError(Exception):
    pass


class Attester:
    """Per-enclave quote generator/verifier."""

    def __init__(self, enclave_id: str, authority: TrustAuthority,
                 global_id: str, caps: frozenset[str], clock=time.time):
        self.enclave_id = enclave_id
        self.authority = authority
        self.global_id = global_id
        self.caps = caps
        self._key = authority.issue_key(enclave_id)
        self._counter = 0
        self._seen_counters: dict[str, int] = {}
        self.clock = clock

    def quote(self, nonce: str) -> Quote:
        self._counter += 1
        q = Quote(self.global_id, self.caps, nonce, self._counter,
                  self.clock(), "")
        sig = hmac.new(self._key, q.payload(), hashlib.sha256).hexdigest()
        return Quote(q.global_id, q.entry_ids, q.nonce, q.counter,
                     q.timestamp, sig)

    def verify(self, peer_id: str, q: Quote, *, nonce: str,
               whitelist: set[str], need: frozenset[str] = frozenset(),
               now: float | None = None) -> None:
        """Raises AttestationError on any failed check (paper §5)."""
        if not self.authority.verify(peer_id, q):
            raise AttestationError("bad signature")
        if q.nonce != nonce:
            raise AttestationError("nonce mismatch (replay?)")
        if q.global_id not in whitelist:
            raise AttestationError(f"measurement {q.global_id[:12]} "
                                   "not whitelisted")
        now = self.clock() if now is None else now
        if not (now - FRESHNESS_WINDOW_S <= q.timestamp <= now + 1.0):
            raise AttestationError("stale quote (freshness window)")
        last = self._seen_counters.get(peer_id, -1)
        if q.counter <= last:
            raise AttestationError("monotonic counter replay")
        self._seen_counters[peer_id] = q.counter
        if not covers(q.entry_ids, need):
            raise AttestationError(
                f"capability gap: need {sorted(need)}, "
                f"have {sorted(q.entry_ids)}")

    def session_key(self, peer_id: str, q_mine: Quote,
                    q_peer: Quote) -> bytes:
        """Attestation-bound session key: derived from the pairwise KMS
        secret and both quote signatures, so it is (a) computable only by
        the two attested enclaves and (b) bound to these specific quotes
        (paper: intercepted migration traffic is useless off-enclave)."""
        pair = self.authority.pair_key(self.enclave_id, peer_id)
        material = (min(q_mine.signature, q_peer.signature)
                    + max(q_mine.signature, q_peer.signature)).encode()
        return hmac.new(pair, material, hashlib.sha256).digest()


# ---------------------------------------------------------------------------
# semantic attestation (paper §6: computation attestation)
# ---------------------------------------------------------------------------

def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def semantic_attest(kernel_fn, oracle_fn, canonical_inputs,
                    eps: float = 2e-2) -> dict:
    """Run canonical inputs through the accelerator kernel and the CPU
    oracle; sign epsilon-bounded agreement."""
    out_k = _f32(kernel_fn(*canonical_inputs))
    out_o = _f32(oracle_fn(*canonical_inputs))
    err = float(np.max(np.abs(out_k - out_o)))
    ok = err <= eps
    digest = sha256(out_o.tobytes())
    return {"ok": ok, "max_err": err, "eps": eps, "output_digest": digest}
