"""The port's migration wire on the CPU: counterparts of
``tests/test_migration.py`` and of the wire tests in
``tests/test_paging.py`` (bit-exact resume, incremental deltas, the
CRIU baseline, the page-level contract and its refusals, the v2 wire),
a tiny rwkv6 slot, the workspace ``Migrator``, and blobs crossing
between the two packages.  Bit-exact oracles use solo requests."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402

from repro.core import migration as jmig  # noqa: E402
from repro.core.workspace import AgentWorkspace as JWorkspace  # noqa: E402
from repro.models.model import forward as jforward  # noqa: E402
from repro.models.model import vocab_mask_logits  # noqa: E402
from repro.serving import paged as jpaged  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.configs.tiny import make_tiny  # noqa: E402
from repro_torch.core.attestation import (Attester, TrustAuthority,  # noqa: E402
                                          capabilities, measure_config)
from repro_torch.core.channel import (AttestedSession, Channel,  # noqa: E402
                                      NetworkCondition)
from repro_torch.core.migration import (  # noqa: E402
    RNG_TAG, Migrator, Snapshot, _pack_workspace, apply_delta,
    criu_restore, criu_snapshot, delta_fraction, deserialize_tree,
    make_delta, pack_slot, page_hashes, place_tree, qemu_snapshot,
    repack_slot, serialize_tree, unpack_slot)
from repro_torch.core.msgpack_subset import unpackb  # noqa: E402
from repro_torch.core.tree import spec_of, tree_map  # noqa: E402
from repro_torch.core.workspace import AgentWorkspace, VectorClock  # noqa: E402
from repro_torch.models.init import init_params  # noqa: E402
from repro_torch.serving.engine import (Engine, Request,  # noqa: E402
                                        SlotArrays, SlotSnapshot,
                                        request_to_dict)
from repro_torch.serving.paged import PagedEngine  # noqa: E402
from tests.torch_helpers import bridged_params, configs  # noqa: E402

CFG = make_tiny(get("llama-1.5b"))
AUTH = TrustAuthority()
GID = measure_config(CFG)
# greedy tokens across frameworks: a divergence is only legitimate where
# the JAX top-2 logit gap is below this (as tests/test_torch_paged.py)
GAP_TOL = 1e-4
_CACHE = {}


def _params():
    if "p" not in _CACHE:
        _CACHE["p"] = init_params(CFG, torch.Generator().manual_seed(0),
                                  device="cpu")
    return _CACHE["p"]


def _session(cond=None):
    a = Attester("edge", AUTH, GID, capabilities(CFG, platform="gpu"))
    b = Attester("cloud", AUTH, GID, capabilities(CFG, platform="gpu"))
    return AttestedSession(a, b, Channel(cond=cond or NetworkCondition()),
                           {GID})


def _engine(seed=0, slots=2, max_len=64):
    return Engine(CFG, _params(), slots=slots, max_len=max_len, seed=seed,
                  device="cpu")


def mk_paged(seed=0, page_size=8, rows=1, pages=None, max_len=64):
    return PagedEngine(CFG, _params(), page_size=page_size, rows=rows,
                       pages=pages, max_len=max_len, seed=seed, device="cpu")


def mk_req(rid, prompt, max_new=8, **kw):
    return Request(rid, np.asarray(prompt), max_new_tokens=max_new, **kw)


def _finish(eng, req):
    while not req.done:
        eng.step()
    return list(req.output)


# -- test_migration.py counterparts -------------------------------------------

def test_migration_bit_exact_continuation():
    """Paper §4.3: 'agents resume execution with perfect fidelity' -- a
    sampled request's whole workspace moves mid-decode."""
    eng = _engine(seed=42)
    req = mk_req("r0", np.arange(6), max_new=12, temperature=0.9, top_k=8)
    eng.add_request(req)
    for _ in range(5):
        eng.step()
    pre = list(req.output)

    ws = AgentWorkspace.from_engine(eng, GID)
    eng2, rep = Migrator().migrate(ws, _session(), _engine(seed=777))
    post = []
    while eng2.requests:
        post += list(eng2.step().values())

    ref_eng = _engine(seed=42)
    ref = mk_req("r0", np.arange(6), max_new=12, temperature=0.9, top_k=8)
    ref_eng.add_request(ref)
    for _ in range(12):
        ref_eng.step()
    assert pre + post == ref.output
    assert rep.wire_bytes < rep.raw_bytes  # compression worked


def test_serialize_roundtrip_all_dtypes():
    tree = {
        "bf16": torch.ones((3, 4), dtype=torch.bfloat16) * 1.5,
        "f32": torch.arange(5, dtype=torch.float32),
        "i32": torch.arange(4, dtype=torch.int32),
        "bool": torch.tensor([True, False]),
        "count": 7,
        "nested": {"x": torch.zeros((2,), dtype=torch.int8)},
        "slot": SlotArrays(caches=[[{"attn": {"k": torch.randn(2, 3)}}]],
                           tokens=torch.arange(4, dtype=torch.int32),
                           position=torch.tensor(3, dtype=torch.int32),
                           last_token=torch.tensor(2, dtype=torch.int32),
                           rng=torch.tensor([5, 9]),
                           temperature=torch.tensor(0.5),
                           top_k=torch.tensor(4, dtype=torch.int32)),
    }
    blob = serialize_tree(tree)
    back = deserialize_tree(blob, tree)
    assert back["count"] == 7 and isinstance(back["count"], int)
    assert isinstance(back["slot"], SlotArrays)
    leaves = [it for it in unpackb(blob)["leaves"]]
    assert [it["key"] for it in leaves][:3] == ["['bf16']", "['bool']",
                                                "['count']"]
    assert {it["key"]: it["dtype"] for it in leaves}["['slot'].rng"] \
        == RNG_TAG
    flat_a, flat_b = [], []
    tree_map(flat_a.append, tree)
    tree_map(flat_b.append, back)
    for a, b in zip(flat_a, flat_b):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b


def test_incremental_delta_small_after_one_step():
    """Paper §9.6: after one decode step only the touched pages move."""
    eng = _engine(max_len=512)
    eng.add_request(mk_req("r0", np.arange(8), max_new=20))
    eng.step()
    b1 = _pack_workspace(AgentWorkspace.from_engine(eng, GID))
    s1 = Snapshot(b1, page_hashes(b1))
    eng.step()
    b2 = _pack_workspace(AgentWorkspace.from_engine(eng, GID))
    s2 = Snapshot(b2, page_hashes(b2))
    frac = delta_fraction(s1, s2)
    assert frac < 0.5, frac
    delta = make_delta(s1, s2)
    assert len(delta) < len(b2)
    assert apply_delta(s1, delta).blob == s2.blob


def test_migration_beats_criu_style_baseline_on_wire():
    """Fig 2/3: compressed wire bytes < CRIU full snapshot bytes <
    QEMU's inflated snapshot."""
    eng = _engine()
    eng.add_request(mk_req("r0", np.arange(8), max_new=8))
    eng.step()
    ws = AgentWorkspace.from_engine(eng, GID)
    _, criu_rep = criu_snapshot(ws, Channel())
    _, qemu_rep = qemu_snapshot(ws, Channel())
    _, mvvm_rep = Migrator().migrate(ws, _session(), _engine(seed=5))
    assert mvvm_rep.wire_bytes < criu_rep.wire_bytes < qemu_rep.wire_bytes
    assert criu_rep.transfer_s < qemu_rep.transfer_s


def test_criu_roundtrip_same_topology():
    eng = _engine(seed=1)
    req = mk_req("r0", np.arange(8), max_new=6)
    eng.add_request(req)
    eng.step()
    ws = AgentWorkspace.from_engine(eng, GID)
    payload, _ = criu_snapshot(ws, Channel())
    eng2 = criu_restore(payload, _engine(seed=2))
    assert int(eng2.state.positions[0]) == int(eng.state.positions[0])
    assert eng2.state.step_count == 1 and eng2.requests[0].rid == "r0"
    assert eng2.state.rng.device.type == "cpu"


def test_workspace_migrator_full_then_incremental_is_bit_exact():
    """The whole workspace moves once in full and once as a delta after
    one more step; the continuation equals the unmoved engine's, and the
    delta ships a small share of the pages."""
    def start(seed):
        eng = _engine(seed=seed, slots=2, max_len=512)
        reqs = [mk_req("g", np.arange(2, 9), max_new=10),
                mk_req("s", np.arange(20, 31), max_new=10, temperature=0.8,
                       top_k=6)]
        for r in reqs:
            eng.add_request(r)
        for _ in range(3):
            eng.step()
        return eng, reqs

    ref, ref_reqs = start(3)
    for _ in range(7):
        ref.step()

    src, reqs = start(3)
    mig, target = Migrator(), _engine(seed=11, max_len=512)
    _, full = mig.migrate(AgentWorkspace.from_engine(src, GID), _session(),
                          target)
    src.step()
    dst, inc = mig.migrate(AgentWorkspace.from_engine(src, GID), _session(),
                           target, incremental=True)
    assert dst is target and inc.incremental
    assert 0.0 < inc.delta_fraction < 0.5, inc.delta_fraction
    assert full.delta_fraction == 1.0
    outs = {r.rid: list(r.output) for r in dst.requests.values()}
    while dst.requests:
        for rid, t in dst.step().items():
            outs[rid].append(t)
    assert outs == {r.rid: r.output for r in ref_reqs}


def test_workspace_blob_has_the_jax_key_list():
    """The port's workspace blob lists JAX's leaves in JAX's order with
    JAX's dtype tags; ``.step_count`` is an int32 ``[]`` leaf."""
    jcfg, tcfg = configs()
    jp, tp = bridged_params(jcfg)
    jeng = JEngine(jcfg, jp, slots=3, max_len=64)
    teng = Engine(tcfg, tp, slots=3, max_len=64, device="cpu")
    for eng, R in ((jeng, JRequest), (teng, Request)):
        eng.add_request(R("r0", np.arange(6), max_new_tokens=8))
        eng.step()
    theirs = msgpack.unpackb(msgpack.unpackb(jmig._pack_workspace(
        JWorkspace.from_engine(jeng, "gid")))["state"])["leaves"]
    ours = unpackb(unpackb(_pack_workspace(
        AgentWorkspace.from_engine(teng, "gid")))["state"])["leaves"]
    assert [it["key"] for it in ours] == [it["key"] for it in theirs]
    for a, b in zip(ours, theirs):
        assert a["shape"] == b["shape"], a["key"]
        if a["key"] != ".rng":
            assert a["dtype"] == b["dtype"], a["key"]
    step = [it for it in ours if it["key"] == ".step_count"][0]
    assert step["dtype"] == "int32" and step["shape"] == []
    assert np.frombuffer(step["data"], np.int32)[0] == 1


# -- test_paging.py wire counterparts -----------------------------------------

def test_same_page_size_migration_is_bit_exact():
    """Same page size + same program (rows, max_len) => bit-exact resume,
    even when the destination's pool is bigger and its seed differs."""
    prompt, max_new = np.arange(2, 8), 12
    baseline = mk_paged(seed=0, pages=8)
    ref = mk_req("m", prompt, max_new=max_new)
    assert baseline.add_request(ref)
    _finish(baseline, ref)

    src = mk_paged(seed=0, pages=8)
    req = mk_req("m", prompt, max_new=max_new)
    assert src.add_request(req)
    for _ in range(5):
        src.step()
    blob = pack_slot(src.extract_slot(req.slot))
    assert src.allocator.used_pages == 0   # departure freed the pages

    dst = mk_paged(seed=9, pages=12)       # bigger pool
    snap = unpack_slot(blob, dst.slot_like())
    moved = dst.inject_slot(repack_slot(snap, dst.max_len))
    dst.check()
    assert _finish(dst, moved) == ref.output
    # the wire shipped live pages only: ceil(pos/ps) pages, not max_len
    n_live = snap.arrays.caches[0][0]["attn"]["k"].shape[1]
    assert n_live == -(-(len(prompt) + 5) // 8)


def test_cross_page_size_injection_rejected_loudly():
    src = mk_paged(seed=0, page_size=8, pages=8)
    req = mk_req("x", np.arange(2, 8), max_new=8)
    assert src.add_request(req)
    src.step()
    snap = src.extract_slot(req.slot)
    dst = mk_paged(seed=1, page_size=16, pages=4)
    with pytest.raises(ValueError, match="page_size mismatch"):
        dst.inject_slot(snap)
    dst.check()
    assert dst.allocator.used_pages == 0 and not dst.requests


def test_paged_engine_rejects_dense_v1_snapshot():
    dense = _engine(slots=1)
    req = mk_req("d", np.arange(2, 8), max_new=8)
    assert dense.add_request(req)
    dense.step()
    snap = dense.extract_slot(req.slot)
    assert snap.version == 1
    paged = mk_paged(page_size=8)
    with pytest.raises(ValueError, match="v2"):
        paged.inject_slot(snap)
    assert paged.allocator.used_pages == 0
    paged_snap = mk_paged_snapshot(seed=0)
    paged_snap.config_name = CFG.name
    with pytest.raises(ValueError, match="v1"):
        _engine().inject_slot(paged_snap)


def mk_paged_snapshot(*, seed=0, repeats=1, page_size=8, kv_heads=1,
                      head_dim=4, plen=2, out_len=0, max_new=4):
    """A v2 (paged-wire) SlotSnapshot with arbitrary geometry, as
    ``PagedEngine.extract_slot`` ships it (the port's counterpart of
    ``tests.helpers.synthetic_paged_snapshot``)."""
    rng = np.random.default_rng(seed)
    pos = plen + out_len
    n_live = max(1, -(-pos // page_size))
    shape = (repeats, n_live, page_size, kv_heads, head_dim)
    slot_idx = np.arange(n_live * page_size).reshape(1, n_live, page_size,
                                                     1, 1)
    live = slot_idx < pos

    def kv():
        a = np.where(live, rng.normal(size=shape), 0.0)
        return torch.from_numpy(a).to(torch.bfloat16)

    tokens = np.concatenate([rng.integers(1, 100, pos),
                             np.zeros(n_live * page_size - pos)])
    req = Request("syn-paged", np.asarray(rng.integers(1, 100, plen)),
                  max_new_tokens=max_new)
    req.output = list(map(int, rng.integers(1, 100, out_len)))
    arrays = SlotArrays(
        caches=[[{"attn": {"k": kv(), "v": kv()}}]],
        tokens=torch.from_numpy(tokens.astype(np.int32)),
        position=torch.tensor(pos, dtype=torch.int32),
        last_token=torch.tensor(int(tokens[max(pos - 1, 0)]),
                                dtype=torch.int32),
        rng=torch.tensor([seed, 0]),
        temperature=torch.tensor(0.0),
        top_k=torch.tensor(0, dtype=torch.int32))
    return SlotSnapshot(arrays=arrays, request=request_to_dict(req),
                        config_name="synthetic", step=out_len, version=2,
                        page_size=page_size)


def test_v2_wire_roundtrip_sweep():
    """pack -> unpack -> pack is byte-identical for random v2 snapshot
    geometries, with the trace context riding."""
    for seed in range(24):
        rng = np.random.default_rng(seed)
        snap = mk_paged_snapshot(
            seed=seed, repeats=int(rng.integers(1, 3)),
            page_size=int(rng.choice([4, 8])),
            kv_heads=int(rng.integers(1, 3)),
            head_dim=int(rng.choice([4, 8])),
            plen=int(rng.integers(1, 6)),
            out_len=int(rng.integers(0, 4)),
            max_new=int(rng.integers(4, 9)))
        if seed % 3 == 0:
            snap.trace = {"trace_id": f"t{seed}", "span_id": seed}
        wire = pack_slot(snap)
        back = unpack_slot(wire, tree_map(spec_of, snap.arrays))
        assert back.version == 2 and back.page_size == snap.page_size
        assert back.trace == snap.trace
        assert pack_slot(back) == wire


def test_v2_repack_is_budget_check_only():
    snap = mk_paged_snapshot(seed=3, page_size=8, plen=5, out_len=2,
                             max_new=6)
    need = int(snap.arrays.position) + snap.remaining_tokens
    assert repack_slot(snap, need) is snap
    assert repack_slot(snap, need + 100) is snap
    assert pack_slot(repack_slot(snap, need)) == pack_slot(snap)
    with pytest.raises(ValueError, match="truncation"):
        repack_slot(snap, need - 1)


def test_unknown_wire_version_rejected_loudly():
    snap = mk_paged_snapshot(seed=0)
    snap.version = 99
    blob = pack_slot(snap)
    with pytest.raises(ValueError, match="unknown pack_slot wire version"):
        unpack_slot(blob, tree_map(spec_of, snap.arrays))


# -- the port's own moves -----------------------------------------------------

def test_dense_slot_moves_into_another_slot_index_bit_exact():
    """A sampled request leaves slot 0 of one engine mid-decode and
    resumes in slot 2 of another (other seed); its tokens equal the
    unmoved run's bit for bit."""
    def run(move):
        eng = _engine(seed=4, slots=3)
        req = mk_req("m", np.arange(3, 12), max_new=12, temperature=0.7,
                     top_k=5)
        eng.add_request(req)
        for _ in range(4):
            eng.step()
        if not move:
            return _finish(eng, req)
        blob = pack_slot(eng.extract_slot(req.slot))
        assert not eng.requests and not bool(eng.state.active[0])
        dst = _engine(seed=9, slots=3)
        moved = dst.inject_slot(unpack_slot(blob, dst.slot_like()), slot=2)
        assert moved.slot == 2
        return _finish(dst, moved)

    assert run(True) == run(False)


def test_repack_grows_and_shrinks_dense_rows():
    """A slot of a max_len-64 engine resumes bit-exactly in a max_len-96
    engine (grown rows), and shrinking below the live need raises."""
    src = _engine(slots=1, max_len=64)
    req = mk_req("g", np.arange(2, 9), max_new=10)
    src.add_request(req)
    for _ in range(3):
        src.step()
    snap = src.extract_slot(req.slot, keep=True)
    grown = repack_slot(snap, 96)
    k = grown.arrays.caches[0][0]["attn"]["k"]
    assert k.shape[1] == 96 and not k[:, 64:].any()
    assert (grown.arrays.caches[0][0]["attn"]["abs_pos"][:, 64:] == -1).all()
    back = repack_slot(grown, 64)
    assert pack_slot(back) == pack_slot(snap)
    with pytest.raises(ValueError, match="truncation"):
        repack_slot(snap, 12)
    dst = _engine(slots=1, max_len=96)
    moved = dst.inject_slot(grown)
    ref = _engine(slots=1, max_len=96)
    r2 = mk_req("g", np.arange(2, 9), max_new=10)
    ref.add_request(r2)
    assert _finish(dst, moved) == _finish(ref, r2)


def test_rwkv_slot_moves_bit_exact():
    """A tiny rwkv6 slot (the O(1) workspace: state, x_tm, x_cm) moves
    mid-decode into another engine and slot; tokens equal bit for bit."""
    cfg = make_tiny(get("rwkv6-7b"))
    params = init_params(cfg, torch.Generator().manual_seed(2),
                         device="cpu")

    def run(move):
        eng = Engine(cfg, params, slots=3, max_len=64, seed=0, device="cpu")
        req = mk_req("w", np.arange(5, 22), max_new=10, temperature=0.6,
                     top_k=7)
        eng.add_request(req)
        for _ in range(4):
            eng.step()
        if not move:
            return _finish(eng, req)
        snap = eng.extract_slot(req.slot)
        blob = pack_slot(snap)
        keys = [it["key"] for it in unpackb(unpackb(blob)["arrays"])
                ["leaves"]]
        assert keys[:3] == [".caches[0][0]['rwkv']['state']",
                            ".caches[0][0]['rwkv']['x_cm']",
                            ".caches[0][0]['rwkv']['x_tm']"]
        dst = Engine(cfg, params, slots=3, max_len=64, seed=9, device="cpu")
        moved = dst.inject_slot(unpack_slot(blob, dst.slot_like()), slot=1)
        return _finish(dst, moved)

    assert run(True) == run(False)


def test_blobs_carry_no_transient_keys():
    """The write mask and page table the forward weaves into copies of
    the caches never reach a blob."""
    for eng in (_engine(slots=2), mk_paged(rows=2)):
        req = mk_req("t", np.arange(2, 8), max_new=6)
        eng.add_request(req)
        eng.step()
        keys = [it["key"] for it in unpackb(unpackb(pack_slot(
            eng.extract_slot(req.slot)))["arrays"])["leaves"]]
        assert not [k for k in keys if "write" in k or "page_table" in k]
        assert keys[-6:] == [".tokens", ".position", ".last_token", ".rng",
                             ".temperature", ".top_k"]


def test_dense_inject_refuses_before_touching_state():
    src = _engine(slots=1, max_len=64)
    req = mk_req("g", np.arange(2, 9), max_new=6)
    src.add_request(req)
    src.step()
    snap = src.extract_slot(req.slot)
    dst = _engine(slots=2, max_len=96)
    busy = mk_req("b", np.arange(4, 9), max_new=4)
    dst.add_request(busy)
    before = tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                      else x, dst.state)
    with pytest.raises(ValueError, match="max_len mismatch"):
        dst.inject_slot(snap)
    snap.config_name = "llama-1.5b"
    with pytest.raises(ValueError, match="config mismatch"):
        dst.inject_slot(snap)
    snap.config_name = CFG.name
    with pytest.raises(ValueError, match="busy"):
        dst.inject_slot(repack_slot(snap, 96), slot=0)
    for a, b in zip(serialize_tree(before), serialize_tree(dst.state)):
        assert a == b
    assert list(dst.requests) == [0]


def test_paged_refusals_move_no_page():
    src = mk_paged(rows=2)
    req = mk_req("v3", np.arange(2, 8), max_new=6)
    src.add_request(req)
    src.step()
    # no shared chain (no prefix cache): suffix_only refuses, row intact
    with pytest.raises(ValueError, match="shared prefix chain"):
        src.extract_slot(req.slot, suffix_only=True)
    assert req.slot in src.requests
    src.check()
    warm = PagedEngine(CFG, _params(), page_size=8, rows=2, max_len=64,
                       device="cpu", prefix_cache=True)
    wreq = mk_req("w", np.arange(2, 20), max_new=6)
    assert warm.add_request(wreq)
    warm.step()
    v3 = warm.extract_slot(wreq.slot, suffix_only=True)
    assert v3.version == 3 and len(v3.prefix["chain"]) == 2
    assert v3.arrays.caches[0][0]["attn"]["k"].shape[1] == 1
    warm.check()
    snap = src.extract_slot(req.slot)
    snap.version = 3
    dst = mk_paged(rows=2, pages=10)
    with pytest.raises(ValueError, match="no prefix cache"):
        dst.inject_slot(snap)
    snap.version = 2
    assert dst.add_request(mk_req("a", np.arange(3, 9), max_new=4))
    assert dst.add_request(mk_req("b", np.arange(3, 9), max_new=4))
    with pytest.raises(RuntimeError, match="no free row"):
        dst.inject_slot(snap)
    dst.check()
    assert dst.allocator.used_pages == 4


def _malformed(a, case):
    """``a`` (SlotArrays) broken one way: a page or cache axis of 1, a
    cast leaf, a missing layer or a short token prefix."""
    def each(fn):
        return [[{m: {k: fn(k, t) for k, t in c.items()}
                  for m, c in layer.items()} for layer in grp]
                for grp in a.caches]
    kv = ("k", "v")
    caches = {
        "axis1": lambda: each(lambda k, t: t[:, :1] if k in kv else t),
        "dtype": lambda: each(lambda k, t: t.half() if k in kv else t),
        "layers": lambda: [grp[:-1] for grp in a.caches],
    }.get(case, lambda: a.caches)()
    tokens = a.tokens[:-1] if case == "tokens" else a.tokens
    return dataclasses.replace(a, caches=caches, tokens=tokens)


@pytest.mark.parametrize("case", ["axis1", "dtype", "layers", "tokens",
                                  "slot"])
def test_paged_inject_refuses_malformed_payload_before_any_page(case):
    """A payload that does not fit the pools exactly (no broadcast, no
    cast) or an explicit row out of range is refused before a page is
    allocated, scattered or mapped."""
    src = mk_paged(rows=2)
    req = mk_req("p", np.arange(2, 14), max_new=6)
    src.add_request(req)
    src.step()
    snap = src.extract_slot(req.slot)
    assert snap.arrays.caches[0][0]["attn"]["k"].shape[1] == 2
    snap.arrays = _malformed(snap.arrays, case)
    dst = mk_paged(rows=2, pages=10)
    with pytest.raises(ValueError):
        dst.inject_slot(snap, slot=2 if case == "slot" else None)
    dst.check()
    assert dst.allocator.used_pages == 0 and not dst.requests
    assert bool((dst.state.page_table == -1).all())


@pytest.mark.parametrize("case", ["axis1", "dtype", "layers", "slot"])
def test_dense_inject_refuses_malformed_rows(case):
    """Cache rows of another count, shape or dtype, or a slot out of
    range, are refused before any state is written."""
    src = _engine(slots=1)
    req = mk_req("g", np.arange(2, 9), max_new=6)
    src.add_request(req)
    src.step()
    snap = src.extract_slot(req.slot)
    snap.arrays = _malformed(snap.arrays, case)
    dst = _engine(slots=2)
    before = serialize_tree(dst.state)
    with pytest.raises(ValueError):
        dst.inject_slot(snap, slot=2 if case == "slot" else None)
    assert serialize_tree(dst.state) == before and not dst.requests


def test_paged_speculative_surface():
    """``rollback_slot``, ``_force_slot_token`` and ``committed=`` on the
    paged engine, against the dense engine's contract."""
    eng = mk_paged(rows=2)
    assert not eng.supports_wide_verify
    req = mk_req("c", np.arange(2, 8), max_new=8)
    assert eng.add_request(req, committed=[17, 18])
    assert req.output == [17, 18]
    assert int(eng.state.positions[req.slot]) == 8
    assert eng.state.tokens[req.slot, :8].tolist() == [2, 3, 4, 5, 6, 7, 17,
                                                       18]
    eng.step(auto_retire=False)
    eng.step(auto_retire=False)
    eng._force_slot_token(req.slot, 99)
    assert int(eng.state.last_token[req.slot]) == 99
    assert int(eng.state.tokens[req.slot, 9]) == 99
    eng.rollback_slot(req.slot, 2, 1, 42)
    assert int(eng.state.positions[req.slot]) == 10
    assert int(eng.state.tokens[req.slot, 9]) == 42
    eng.rollback_slot(req.slot, 2, 0, None)
    assert int(eng.state.positions[req.slot]) == 8
    assert int(eng.state.last_token[req.slot]) == 18


# -- blobs across the two packages ----------------------------------------------

def _jax_pair(kind, dtype):
    jcfg, tcfg = configs(dtype)
    jp, tp = bridged_params(jcfg, seed=5)
    if kind == "dense":
        return (JEngine(jcfg, jp, slots=3, max_len=64, seed=0),
                Engine(tcfg, tp, slots=3, max_len=64, seed=0, device="cpu"),
                jcfg, jp)
    kw = dict(page_size=8, rows=3, max_len=64, seed=0)
    return (jpaged.PagedEngine(jcfg, jp, **kw),
            PagedEngine(tcfg, tp, device="cpu", **kw), jcfg, jp)


def _jax_blob(jeng, temperature=0.0, steps=3):
    """A JAX engine with a filler in row 0 and the migrating request in
    row 1, ``steps`` decode steps in: (blob of row 1, its request)."""
    filler = JRequest("f", np.arange(30, 41), max_new_tokens=12)
    req = JRequest("m", np.arange(2, 9), max_new_tokens=12,
                   temperature=temperature, top_k=5 if temperature else 0)
    assert jeng.add_request(filler) and jeng.add_request(req)
    assert req.slot == 1
    for _ in range(steps):
        jeng.step()
    return jmig.pack_slot(jeng.extract_slot(1, keep=True)), req


def _busy_port_engine(teng, steps=3):
    """The port engine with a filler in row 0 that took ``steps`` steps,
    so its step count and free row match the JAX source's."""
    assert teng.add_request(mk_req("f", np.arange(30, 41), max_new=12))
    for _ in range(steps):
        teng.step()


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_jax_blob_roundtrips_through_the_port(kind):
    """JAX blob -> port unpack_slot / inject_slot -> port extract_slot /
    pack_slot: every non-RNG leaf (key, order, shape, dtype tag, bytes)
    and the meta equal the JAX blob's."""
    jeng, teng, _, _ = _jax_pair(kind, "bfloat16")
    jblob, _ = _jax_blob(jeng)
    _busy_port_engine(teng)
    snap = unpack_slot(jblob, teng.slot_like())
    assert snap.version == (1 if kind == "dense" else 2)
    assert snap.arrays.rng.tolist() == [0, 0]   # greedy: fresh state
    teng.inject_slot(snap, slot=1)
    tblob = pack_slot(teng.extract_slot(1, keep=True))
    theirs, ours = msgpack.unpackb(jblob), unpackb(tblob)
    assert ours["meta"] == theirs["meta"]
    tl = msgpack.unpackb(theirs["arrays"])["leaves"]
    ol = unpackb(ours["arrays"])["leaves"]
    assert [it["key"] for it in ol] == [it["key"] for it in tl]
    for a, b in zip(ol, tl):
        if a["key"] == ".rng":
            assert a["dtype"] == RNG_TAG and b["dtype"].startswith("prng:")
            continue
        assert a == b, a["key"]
    if kind == "paged":
        teng.check()


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_sampled_jax_slot_is_refused_for_its_rng(kind):
    jeng, teng, _, _ = _jax_pair(kind, "bfloat16")
    jblob, _ = _jax_blob(jeng, temperature=0.8)
    with pytest.raises(ValueError, match="prng:threefry2x32"):
        unpack_slot(jblob, teng.slot_like())
    assert not teng.requests


def _jax_gap(jcfg, jp, jeng, before, row, kind):
    if kind == "dense":
        caches = before.caches
    else:
        pt = jnp.where(before.active[:, None], before.page_table, -1)
        caches = jpaged._weave(before.caches, pt)
    lg, _, _ = jforward(jp, {"tokens": before.last_token[:, None]},
                        cfg=jcfg, mode="decode", caches=caches,
                        positions=before.positions[:, None])
    top2 = jax.lax.top_k(vocab_mask_logits(lg[row, 0], jcfg), 2)[0]
    return float(top2[0] - top2[1])


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_port_continuation_after_a_jax_blob_agrees_with_jax(kind):
    """f32 tiny llama: the port resumes a JAX-packed greedy slot and
    decodes in lockstep with the JAX source; agreement is expected to be
    1.0, and a divergence must sit on a knife-edge JAX top-2 gap."""
    jeng, teng, jcfg, jp = _jax_pair(kind, "float32")
    jblob, jreq = _jax_blob(jeng)
    moved = teng.inject_slot(unpack_slot(jblob, teng.slot_like()))
    matched, gap = 0, None
    while not jreq.done:
        before = jeng.state
        je, te = jeng.step(), teng.step()
        if gap is not None:
            continue
        if te["m"] == je["m"]:
            matched += 1
        else:
            gap = _jax_gap(jcfg, jp, jeng, before, jreq.slot, kind)
    assert len(moved.output) == len(jreq.output) == 12
    # measured on this seed: 1.0 (no divergence)
    assert gap is None or gap < GAP_TOL, (matched, gap)


def test_jax_workspace_blob_restores_into_the_port():
    """A JAX greedy workspace restores into a port engine through the
    port's own unpacking; the greedy rows take the fresh rng state."""
    jeng, teng, _, _ = _jax_pair("dense", "bfloat16")
    _jax_blob(jeng)
    blob = jmig._pack_workspace(JWorkspace.from_engine(jeng, "gid"))
    from repro_torch.core.migration import _unpack_workspace
    ws = _unpack_workspace(blob, teng.state)
    ws.engine_state = place_tree(ws.engine_state, teng.device)
    eng = ws.attach(teng)
    assert sorted(eng.requests) == [0, 1]
    assert eng.state.step_count == 3
    assert eng.state.rng.tolist() == [[0, 0], [1, 0], [2, 0]]
    assert eng.state.tokens.tolist() == np.asarray(jeng.state.tokens).tolist()
    assert isinstance(ws.vclock, VectorClock)


def test_jax_refuses_the_port_rng_tag_loudly():
    """The reverse direction: the JAX package, unchanged, cannot read the
    port's RNG tag and raises rather than misreading the slot."""
    jeng, teng, _, _ = _jax_pair("dense", "bfloat16")
    assert teng.add_request(mk_req("m", np.arange(2, 9), max_new=6))
    teng.step()
    blob = pack_slot(teng.extract_slot(0))
    with pytest.raises(TypeError):
        jmig.unpack_slot(blob, jeng.slot_like())
