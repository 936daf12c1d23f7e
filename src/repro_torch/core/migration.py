"""Live migration: checkpoint -> compress -> encrypt -> transfer ->
restore.  Paper §7.3/§8.1/§9.3.  The port's copy of the JAX package's
``core.migration``, on the same wire.

Stage structure mirrors the paper's 4GB-workspace walkthrough
(checkpoint / compress / transfer / restore); ``MigrationReport``
carries the four stages.  The paper's figures (2.1 s checkpoint,
4 GB -> 900 MB) are its own, not this port's.

The wire is msgpack (``core.msgpack_subset``) and every leaf crosses
under its JAX key path with a numpy dtype tag (``core.tree``): a slot
blob lists ``.caches[g][l]['attn']['abs_pos']`` (dense only), ``['k']``,
``['v']``, ``.tokens``, ``.position``, ``.last_token``, ``.rng``,
``.temperature``, ``.top_k``; bf16 travels as its uint16 bytes under
``"bfloat16"``; a workspace's ``.step_count`` (a Python int in the
port's state) is an int32 ``[]`` leaf, as in the JAX state.  So every
non-RNG leaf and the meta of a blob are byte-identical between the
packages.

RNG state cannot cross frameworks.  JAX keys travel tagged
``prng:<impl>``; the port's per-row ``(seed, counter)`` int64 pair (see
``serving.sampling``) travels tagged ``RNG_TAG``.  A foreign RNG leaf is
refused loudly for any sampled (temperature > 0) slot.  A greedy slot
draws nothing, so it takes a defined fresh state instead: what a fresh
seed-0 engine gives that row, ``(row, 0)`` -- ``(0, 0)`` for a single
slot.

Incremental checkpoints: every serialized leaf is split into fixed-size
pages, hashed (blake2b); a delta ships only pages whose hash changed
since the base snapshot.

Baselines for Fig 2/3:
  * criu_snapshot  -- full uncompressed same-topology snapshot
  * qemu_snapshot  -- full snapshot plus emulation tax on restore
"""

from __future__ import annotations

import hashlib
import re
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import compression
from repro_torch.core.channel import AttestedSession, Channel
from repro_torch.core.msgpack_subset import packb, unpackb
from repro_torch.core.tree import (from_bytes, leaves_with_path,
                                   map_with_path, to_numpy)
from repro_torch.core.workspace import AgentWorkspace, VectorClock
from repro_torch.serving.engine import Engine, SlotArrays, SlotSnapshot

PAGE_BYTES = 1 << 12   # 4 KiB: fine enough that one decode step dirties
                       # only the touched cache slots (paper's ~12% sync)
RNG_TAG = "counter:seed-int64"   # the port's (seed, counter) rows
KNOWN_WIRE_VERSIONS = (1, 2, 3)


# ---------------------------------------------------------------------------
# serialization (layout-independent)
# ---------------------------------------------------------------------------

@dataclass
class ForeignKey:
    """An RNG leaf another framework wrote (JAX: ``prng:<impl>`` key
    data), read back as is; ``unpack_slot`` / ``_unpack_workspace``
    replace it or refuse the blob."""
    tag: str
    data: np.ndarray


def _is_rng(key: str) -> bool:
    return key.endswith(".rng")


def serialize_tree(tree) -> bytes:
    """A tree of dataclasses, lists, dicts and tensors -> msgpack blob
    (dtype-tagged, bf16-safe).  A Python int leaf is an int32 ``[]``
    leaf; the tensor at a field named ``rng`` is tagged ``RNG_TAG``."""
    items = []
    for key, leaf in leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            arr, dtype = to_numpy(leaf)
            if _is_rng(key):
                dtype = RNG_TAG
        elif isinstance(leaf, int) and not isinstance(leaf, bool):
            arr, dtype = np.asarray(leaf, np.int32), "int32"
        else:
            raise TypeError(f"{key}: cannot serialize a "
                            f"{type(leaf).__name__} leaf")
        items.append({"key": key, "shape": list(arr.shape), "dtype": dtype,
                      "data": arr.tobytes()})
    return packb({"leaves": items})


def deserialize_tree(blob: bytes, like_tree):
    """Blob -> tree with the structure of ``like_tree``, tensors on the
    CPU (``place_tree`` moves them).  Shapes and dtypes come from the
    blob; a like leaf that is a Python int reads back as an int; a
    foreign RNG leaf reads back as a ``ForeignKey``."""
    obj = unpackb(blob)
    by_key = {it["key"]: it for it in obj["leaves"]}

    def one(key, like):
        if key not in by_key:
            raise ValueError(f"blob has no leaf {key}")
        it = by_key[key]
        dtype, shape = it["dtype"], tuple(it["shape"])
        if dtype.startswith("prng:"):
            return ForeignKey(dtype, np.frombuffer(
                it["data"], np.uint32).reshape(shape))
        if dtype == RNG_TAG:
            dtype = "int64"
        t = from_bytes(it["data"], dtype, shape, "cpu")
        return int(t) if isinstance(like, int) else t

    return map_with_path(one, like_tree)


def place_tree(tree, device):
    """Every tensor leaf on ``device``, except the rng rows, which the
    engines keep on the CPU."""
    def one(key, leaf):
        if isinstance(leaf, torch.Tensor) and not _is_rng(key):
            return leaf.to(device)
        return leaf
    return map_with_path(one, tree)


def _settle_rng(rng, temperature, live, what: str) -> torch.Tensor:
    """The rng rows of a deserialized slot or state.  A foreign leaf is
    refused if a live row samples; otherwise every row takes the fresh
    state of a seed-0 engine, ``(row, 0)``."""
    if not isinstance(rng, ForeignKey):
        return rng
    temperature = temperature.reshape(-1)
    live = live.reshape(-1)
    hot = [i for i in range(temperature.numel())
           if bool(live[i]) and float(temperature[i]) > 0.0]
    if hot:
        raise ValueError(
            f"{what}: RNG state tagged {rng.tag!r} cannot be carried into "
            f"this framework, and rows {hot} sample (temperature > 0); "
            "refusing rather than changing their random stream")
    rows = int(np.prod(rng.data.shape[:-1], dtype=np.int64))
    fresh = torch.stack([torch.arange(rows, dtype=torch.int64),
                         torch.zeros(rows, dtype=torch.int64)], dim=1)
    return fresh.reshape(tuple(rng.data.shape[:-1]) + (2,))


# ---------------------------------------------------------------------------
# paged snapshots + deltas (incremental checkpointing)
# ---------------------------------------------------------------------------

def _pages(blob: bytes) -> list[bytes]:
    return [blob[i:i + PAGE_BYTES] for i in range(0, len(blob), PAGE_BYTES)]


def page_hashes(blob: bytes) -> list[bytes]:
    return [hashlib.blake2b(p, digest_size=16).digest()
            for p in _pages(blob)]


@dataclass
class Snapshot:
    blob: bytes
    hashes: list[bytes]

    @classmethod
    def of(cls, tree) -> "Snapshot":
        blob = serialize_tree(tree)
        return cls(blob, page_hashes(blob))


def make_delta(base: Snapshot, new: Snapshot) -> bytes:
    """Pages of ``new`` that differ from ``base`` (+ total length)."""
    pages = _pages(new.blob)
    changed = []
    for i, p in enumerate(pages):
        if i >= len(base.hashes) or new.hashes[i] != base.hashes[i]:
            changed.append((i, p))
    return packb({
        "total_len": len(new.blob),
        "n_pages": len(pages),
        "pages": [{"i": i, "data": p} for i, p in changed],
    })


def apply_delta(base: Snapshot, delta_blob: bytes) -> Snapshot:
    obj = unpackb(delta_blob)
    pages = _pages(base.blob)
    pages = pages[:obj["n_pages"]] + [b""] * (obj["n_pages"] - len(pages))
    for item in obj["pages"]:
        pages[item["i"]] = item["data"]
    blob = b"".join(pages)[:obj["total_len"]]
    return Snapshot(blob, page_hashes(blob))


def delta_fraction(base: Snapshot, new: Snapshot) -> float:
    changed = sum(1 for i, h in enumerate(new.hashes)
                  if i >= len(base.hashes) or base.hashes[i] != h)
    return changed / max(len(new.hashes), 1)


# ---------------------------------------------------------------------------
# the migration flow
# ---------------------------------------------------------------------------

@dataclass
class MigrationReport:
    raw_bytes: int = 0
    wire_bytes: int = 0
    checkpoint_s: float = 0.0
    compress_s: float = 0.0
    transfer_s: float = 0.0          # simulated network time
    restore_s: float = 0.0
    incremental: bool = False
    delta_fraction: float = 1.0

    @property
    def total_s(self) -> float:
        return (self.checkpoint_s + self.compress_s + self.transfer_s
                + self.restore_s)


def _pack_workspace(ws: AgentWorkspace) -> bytes:
    state_blob = serialize_tree(ws.engine_state)
    meta = {
        "requests": ws.requests,
        "config_name": ws.config_name,
        "measurement": ws.measurement,
        "phase": ws.phase,
        "step": ws.step,
        "vclock": ws.vclock.clocks,
    }
    # fixed-size state FIRST: variable-length metadata (growing request
    # outputs) must not shift the state bytes, or every page downstream
    # of the insertion point dirties and incremental deltas degenerate
    return packb({"state": state_blob, "meta": meta})


def pack_slot(snap: SlotSnapshot) -> bytes:
    """SlotSnapshot -> wire blob.  Same layout discipline as
    ``_pack_workspace``: the fixed-size array tree first, variable-length
    request metadata after it, so paged deltas of successive shadow
    checkpoints stay small."""
    meta = {"request": snap.request,
            "config_name": snap.config_name,
            "step": snap.step,
            "version": snap.version}
    if snap.version in (2, 3):
        meta["page_size"] = snap.page_size
    if snap.version == 3:
        meta["prefix"] = snap.prefix
    if snap.trace is not None:
        meta["trace"] = snap.trace
    return packb({
        "arrays": serialize_tree(snap.arrays),
        "meta": meta,
    })


def _resize_axis(arr: torch.Tensor, axis: int, new_len: int, fill):
    """Grow (pad with ``fill``) or shrink (truncate) one axis."""
    axis = axis % arr.ndim
    old = arr.shape[axis]
    if new_len <= old:
        return arr.narrow(axis, 0, new_len)
    shape = list(arr.shape)
    shape[axis] = new_len - old
    return torch.cat([arr, torch.full(shape, fill, dtype=arr.dtype,
                                      device=arr.device)], dim=axis)


_LEAF_NAME = re.compile(r"\['([^']*)'\]$")


def repack_slot(snap: SlotSnapshot, target_max_len: int) -> SlotSnapshot:
    """Re-layout a slot's cache rows for a target engine with a different
    per-slot context budget (heterogeneous ``max_len`` hand-off).

    Growing appends empty rows: zeros for k/v, -1 (the "slot empty"
    sentinel of ``make_attn_cache``) for ``abs_pos``, zeros for the
    token tail.  Row indices are absolute positions on both sides, so no
    re-rotation is needed; position and rng travel untouched.
    Shrinking is allowed only when the live prefix AND the remaining
    decode budget still fit; otherwise it raises ``ValueError``.
    Recurrent state (rwkv) has no sequence axis and passes through.

    v2/v3 snapshots (live pages) are geometry-free up to the page size:
    only the budget check applies.
    """
    a = snap.arrays
    need = int(a.position) + max(snap.remaining_tokens, 0)
    if snap.version in (2, 3):
        # the version check must come first: a v2 token axis is
        # n_live * page_size, which can collide with a v1 src_len
        if need > target_max_len:
            raise ValueError(
                f"cannot repack slot {snap.rid!r} into max_len="
                f"{target_max_len}: position {int(a.position)} + "
                f"{snap.remaining_tokens} remaining tokens need {need} "
                "rows (tail truncation would drop live state)")
        return snap
    src_len = int(a.tokens.shape[-1])
    if src_len == target_max_len:
        return snap
    if target_max_len < src_len and need > target_max_len:
        raise ValueError(
            f"cannot repack slot {snap.rid!r} into max_len="
            f"{target_max_len}: position {int(a.position)} + "
            f"{snap.remaining_tokens} remaining tokens need {need} "
            "rows (tail truncation would drop live state)")

    def one(path, leaf):
        m = _LEAF_NAME.search(path)
        name = m.group(1) if m else None
        if name in ("k", "v") and leaf.ndim >= 3 \
                and leaf.shape[-3] == src_len:
            return _resize_axis(leaf, -3, target_max_len, 0)
        if name == "abs_pos" and leaf.shape[-1] == src_len:
            return _resize_axis(leaf, -1, target_max_len, -1)
        return leaf

    arrays = SlotArrays(
        caches=map_with_path(one, a.caches),
        tokens=_resize_axis(a.tokens, -1, target_max_len, 0),
        position=a.position,
        last_token=a.last_token,
        rng=a.rng,
        temperature=a.temperature,
        top_k=a.top_k,
    )
    return SlotSnapshot(arrays=arrays, request=snap.request,
                        config_name=snap.config_name, step=snap.step,
                        trace=snap.trace)


def unpack_slot(blob: bytes, like_arrays) -> SlotSnapshot:
    """Wire blob -> SlotSnapshot placed on the target's device.

    ``like_arrays`` is the target engine's ``slot_like()``: its
    structure, and the device of its ``.tokens`` leaf, where every leaf
    but the rng row lands.  Shapes come from the blob (a v2 page axis
    varies per snapshot; a v1 geometry mismatch fails at
    ``inject_slot``).  Blobs from a future wire version are rejected
    rather than misread, and a foreign RNG leaf of a sampled slot is
    refused (module docstring)."""
    obj = unpackb(blob)
    meta = obj["meta"]
    version = meta.get("version", 1)
    if version not in KNOWN_WIRE_VERSIONS:
        raise ValueError(
            f"unknown pack_slot wire version {version!r} (this build "
            f"understands {KNOWN_WIRE_VERSIONS}); refusing to guess at "
            "the payload layout")
    arrays = deserialize_tree(obj["arrays"], like_arrays)
    arrays.rng = _settle_rng(arrays.rng, arrays.temperature,
                             torch.ones((), dtype=torch.bool),
                             f"slot {meta['request']['rid']!r}")
    arrays = place_tree(arrays, like_arrays.tokens.device)
    return SlotSnapshot(arrays=arrays, request=meta["request"],
                        config_name=meta["config_name"], step=meta["step"],
                        trace=meta.get("trace"), version=version,
                        page_size=meta.get("page_size", 0),
                        prefix=meta.get("prefix"))


def _unpack_workspace(blob: bytes, like_state) -> AgentWorkspace:
    obj = unpackb(blob)
    meta = obj["meta"]
    state = deserialize_tree(obj["state"], like_state)
    state.rng = _settle_rng(state.rng, state.temperature, state.active,
                            f"workspace of {meta['config_name']}")
    return AgentWorkspace(
        engine_state=state,
        requests=meta["requests"],
        config_name=meta["config_name"],
        measurement=meta["measurement"],
        phase=meta["phase"],
        step=meta["step"],
        vclock=VectorClock(dict(meta["vclock"])),
    )


class Migrator:
    """Attested, compressed, optionally-incremental workspace migration
    onto one card (the JAX ``shardings`` re-layout has no counterpart)."""

    def __init__(self, *, compression_level: int = 3):
        self.cctx = compression.Compressor(level=compression_level)
        self.dctx = compression.Decompressor()
        self._base: Snapshot | None = None  # for incremental sends

    def migrate(self, ws: AgentWorkspace, session: AttestedSession,
                target_engine: Engine, *,
                incremental: bool = False) -> tuple[Engine, MigrationReport]:
        rep = MigrationReport(incremental=incremental)

        # 1. checkpoint at the stable point
        t0 = time.perf_counter()
        payload = _pack_workspace(ws)
        snap = Snapshot(payload, page_hashes(payload))
        if incremental and self._base is not None:
            rep.delta_fraction = delta_fraction(self._base, snap)
            payload = make_delta(self._base, snap)
        self._base = snap
        rep.raw_bytes = len(snap.blob)
        rep.checkpoint_s = time.perf_counter() - t0

        # 2. compress
        t0 = time.perf_counter()
        compressed = self.cctx.compress(payload)
        rep.wire_bytes = len(compressed)
        rep.compress_s = time.perf_counter() - t0

        # 3. encrypted, attested transfer (simulated wire time)
        clock0 = session.channel.clock()
        aad = ws.measurement.encode()
        received = session.transfer(compressed, aad=aad)
        rep.transfer_s = session.channel.clock() - clock0

        # 4. restore (decompress, place on the target's card); the
        # target's own state is the template: structure, int leaves
        t0 = time.perf_counter()
        raw = self.dctx.decompress(received)
        if incremental and self._is_delta(raw):
            base = getattr(target_engine, "_mvvm_base", None)
            if base is None:
                raise ValueError("incremental restore without a base "
                                 "snapshot on the target engine")
            raw = apply_delta(base, raw).blob
        ws2 = _unpack_workspace(raw, target_engine.state)
        ws2.engine_state = place_tree(ws2.engine_state, target_engine.device)
        target_engine._mvvm_base = Snapshot(raw, page_hashes(raw))
        engine = ws2.attach(target_engine)
        rep.restore_s = time.perf_counter() - t0
        return engine, rep

    @staticmethod
    def _is_delta(raw: bytes) -> bool:
        try:
            obj = unpackb(raw)
        except ValueError:
            return False
        return isinstance(obj, dict) and "pages" in obj


# ---------------------------------------------------------------------------
# baselines (Fig 2/3)
# ---------------------------------------------------------------------------

def criu_snapshot(ws: AgentWorkspace, channel: Channel) \
        -> tuple[bytes, MigrationReport]:
    """CRIU-style: full state, no compression, no attestation/encryption,
    restore requires the *identical* topology (no re-layout)."""
    rep = MigrationReport()
    t0 = time.perf_counter()
    payload = _pack_workspace(ws)
    rep.raw_bytes = rep.wire_bytes = len(payload)
    rep.checkpoint_s = time.perf_counter() - t0
    c0 = channel.clock()
    channel.send(payload)
    rep.transfer_s = channel.clock() - c0
    return payload, rep


def criu_restore(payload: bytes, target_engine: Engine) -> Engine:
    ws = _unpack_workspace(payload, target_engine.state)
    ws.engine_state = place_tree(ws.engine_state, target_engine.device)
    return ws.attach(target_engine)


def qemu_snapshot(ws: AgentWorkspace, channel: Channel,
                  emu_overhead: float = 4.0) \
        -> tuple[bytes, MigrationReport]:
    """QEMU-style: device-state-inflated snapshot; restore lands in an
    emulated runtime -- the checkpoint itself also carries emulator
    state (modeled as a payload multiplier)."""
    rep = MigrationReport()
    t0 = time.perf_counter()
    payload = _pack_workspace(ws)
    payload = payload + b"\x00" * int(len(payload) * (emu_overhead - 1))
    rep.raw_bytes = rep.wire_bytes = len(payload)
    rep.checkpoint_s = time.perf_counter() - t0
    c0 = channel.clock()
    channel.send(payload)
    rep.transfer_s = channel.clock() - c0
    return payload, rep
