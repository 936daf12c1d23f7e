"""The port's prefix KV cache (``repro_torch.serving.prefix_cache`` and
the warm paths of ``PagedEngine``) on the CPU: counterparts of the
non-fleet tests of ``tests/test_prefix_cache.py`` (refcounts under a
randomized harness, LRU order, tenant isolation, full and partial hits,
copy on write, evictable admission, the v3 suffix-only wire, pre-warm,
``python -O``), then the port against the JAX package: chain keys, one
request sequence on both engines, v3 blobs across the packages, the
reference's self-eviction on a warm admission, and the prefill domain of
a warm prompt.  Tiny llama, plain kernels.  Tolerances: the port-only
token checks are bit-exact; across packages greedy tokens are compared
in f32 and may differ only where the JAX top-2 logit gap is a knife edge
(``GAP_TOL``); page tables, owners, stats, keys and blob leaves are
compared exactly."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402

from repro.core import migration as jmig  # noqa: E402
from repro.models.model import forward as jforward  # noqa: E402
from repro.models.model import vocab_mask_logits  # noqa: E402
from repro.serving import paged as jpaged  # noqa: E402
from repro.serving import prefix_cache as jpc  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.configs.tiny import make_tiny  # noqa: E402
from repro_torch.core.migration import (RNG_TAG, pack_slot,  # noqa: E402
                                        repack_slot, unpack_slot)
from repro_torch.core.msgpack_subset import unpackb  # noqa: E402
from repro_torch.models.init import init_params  # noqa: E402
from repro_torch.serving import prefix_cache as pc  # noqa: E402
from repro_torch.serving.engine import Request  # noqa: E402
from repro_torch.serving.paged import PageAllocator, PagedEngine  # noqa: E402
from repro_torch.serving.prefix_cache import (HashedPrefix,  # noqa: E402
                                              PrefixCache)
from tests.torch_helpers import bridged_params, configs  # noqa: E402

CFG = make_tiny(get("llama-1.5b"))
SRC = Path(__file__).resolve().parents[1] / "src"
# greedy tokens across frameworks: a divergence is only legitimate where
# the JAX top-2 logit gap is below this (as tests/test_torch_paged.py)
GAP_TOL = 1e-4
_CACHE = {}


def _params():
    if "p" not in _CACHE:
        _CACHE["p"] = init_params(CFG, torch.Generator().manual_seed(0),
                                  device="cpu")
    return _CACHE["p"]


def mk_paged(seed=0, page_size=8, rows=4, pages=None, max_len=64, **kw):
    kw.setdefault("prefix_cache", True)
    return PagedEngine(CFG, _params(), page_size=page_size, rows=rows,
                       pages=pages, max_len=max_len, seed=seed,
                       device="cpu", **kw)


def mk_req(rid, prompt, max_new=6, **kw):
    return Request(rid, np.asarray(prompt), max_new_tokens=max_new, **kw)


def drain(eng, reqs):
    for r in reqs:
        assert eng.add_request(r)
    while eng.requests:
        eng.step()
    return {r.rid: r.output for r in reqs}


def pool_pages(eng, page):
    """Every layer's k/v pool bytes at one physical page."""
    out = []
    for group in eng.state.caches:
        for layer in group:
            a = layer["attn"]
            out.append(a["k_pool"][:, page].clone())
            out.append(a["v_pool"][:, page].clone())
    return out


def cached_pages(cache):
    return [n.page for n in cache.nodes.values()] \
        + [n.page for v in cache.tails.values() for n in v]


# -- property harness: refcounts against a bare allocator ---------------------

def test_prefix_cache_refcount_property_harness_300_trials():
    """>= 300 randomized admit/retire/reclaim trials against a bare
    ``PageAllocator``, doing what the engine does (match -> acquire ->
    donate the missing blocks -> release on retire), with every invariant
    audited after every operation: allocator conservation, cache owner
    tags, refs == row refs + child count, and eviction never touching a
    referenced page."""
    trials = 0
    for seed in range(6):
        rng = np.random.default_rng(seed)
        ps = int(rng.choice([4, 8]))
        total = int(rng.integers(12, 48))
        alloc = PageAllocator(total)
        cache = PrefixCache(alloc, page_size=ps, token_bytes=2)
        streams = {}
        for t in ("a", "b", "c"):
            base = rng.integers(5, 1000, 3 * ps)
            streams[t] = [base,
                          np.concatenate([base[:2 * ps],
                                          rng.integers(5, 1000, ps + 3)]),
                          np.concatenate([base[:ps],
                                          rng.integers(5, 1000, 5)])]
        rows: dict[int, list] = {}       # row -> acquired nodes
        privates: dict[int, list] = {}   # row -> privately owned pages
        next_row = 0

        def audit():
            alloc.check()                # runs the cache's auditor too
            cache.check(rows.values())
            assert alloc.free_pages + alloc.used_pages == total
            private = sum(len(p) for p in privates.values())
            assert alloc.used_pages == private + cache.pages_held

        for _ in range(60):
            trials += 1
            dice = rng.random()
            if dice < 0.55:              # admit
                t = str(rng.choice(list(streams)))
                toks = streams[t][int(rng.integers(len(streams[t])))]
                full, tail, hit = cache.match(t, toks)
                need = (len(toks) + ps - 1) // ps - len(full)
                cache.acquire(full)      # the port's order: pin, then reclaim
                pages = alloc.alloc(need, f"row{next_row}")
                if pages is None:
                    cache.reclaim(need - alloc.free_pages)
                    pages = alloc.alloc(need, f"row{next_row}")
                if pages is None:
                    cache.release(full)
                    audit()
                    continue             # honestly full: skip
                row, next_row = next_row, next_row + 1
                rows[row], privates[row] = list(full), pages
                for d in range(len(full), len(toks) // ps):
                    node = cache.adopt(t, toks, d, privates[row][0])
                    if node is None:
                        break
                    privates[row].pop(0)
                    cache.acquire([node])
                    rows[row].append(node)
                if len(toks) % ps and rng.random() < 0.7:
                    cache.adopt_tail(t, toks, lambda dst: None)
                cache.account(hit)
            elif dice < 0.85 and rows:   # retire
                row = int(rng.choice(list(rows)))
                cache.release(rows.pop(row))
                pages = privates.pop(row)
                if pages:
                    alloc.free(pages)
            else:                        # reclaim under pressure
                referenced = {n.page
                              for nodes in rows.values() for n in nodes}
                before = cache.pages_held
                freed = cache.reclaim(int(rng.integers(1, 6)))
                assert cache.pages_held == before - freed
                for page in referenced:
                    assert alloc.owners.get(page, "").startswith("prefix:")
            audit()
        for row in list(rows):
            cache.release(rows.pop(row))
            if privates[row]:
                alloc.free(privates.pop(row))
        cache.reclaim(total)
        assert cache.pages_held == 0
        audit()
    assert trials >= 300, trials


def test_lru_eviction_order_and_refcount_guard():
    ps = 4
    alloc = PageAllocator(8)
    cache = PrefixCache(alloc, page_size=ps)
    streams = [np.arange(ps) + 10 * i for i in range(3)]
    nodes = []
    for toks in streams:
        page = alloc.alloc(1, "tmp")[0]
        nodes.append(cache.adopt("t", toks, 0, page))
    cache.match("t", streams[0])         # stream 0 most recently used
    cache.acquire([nodes[2]])            # stream 2 pinned by a "row"
    assert cache.reclaim(3) == 2         # only the two refcount-0 pages
    assert nodes[1].key not in cache.nodes   # the LRU victim went first
    assert nodes[2].key in cache.nodes   # referenced: untouchable
    assert cache.stats.evictions == 2
    cache.release([nodes[2]])
    assert cache.reclaim(1) == 1
    assert cache.pages_held == 0


def test_match_is_tenant_isolated_and_cross_tenant_opt_in():
    ps = 4
    toks = np.arange(2 * ps) + 5
    for cross, want in [((), 0), (("a", "b"), 2 * ps)]:
        alloc = PageAllocator(8)
        cache = PrefixCache(alloc, page_size=ps, cross_tenant=cross)
        for d in range(2):
            assert cache.adopt("a", toks, d, alloc.alloc(1, "tmp")[0])
        assert cache.hit_tokens("a", toks) == 2 * ps
        assert cache.hit_tokens("b", toks) == want


# -- engine: copy on write and bit-exactness (bit-exact, same engine) ---------

def test_warm_full_hit_is_bit_exact_and_skips_prefill():
    eng = mk_paged(rows=1)
    prompt = np.arange(2, 22)            # 2 full pages + a 4-token tail
    cold = drain(eng, [mk_req("cold", prompt)])["cold"]
    assert eng.last_prefix_hit == 0

    def boom(*a, **kw):
        raise AssertionError("a full hit must not run a forward pass")
    eng._prefill_fn = eng._suffix_fn = boom
    warm = drain(eng, [mk_req("warm", prompt)])["warm"]
    assert eng.last_prefix_hit == len(prompt)    # the copied tail included
    assert warm == cold, "a full-prefix hit must decode bit-exactly"
    eng.check()


def test_partial_hit_suffix_prefill_matches_cold_run():
    donor_prompt = np.arange(2, 18)      # 2 full pages
    prompt = np.concatenate([donor_prompt[:8],
                             np.arange(40, 50)])  # shares block 0 only
    cold = drain(mk_paged(rows=1, prefix_cache=False),
                 [mk_req("x", prompt)])["x"]
    eng = mk_paged(rows=1)
    drain(eng, [mk_req("donor", donor_prompt)])
    warm = drain(eng, [mk_req("x", prompt)])["x"]
    assert eng.last_prefix_hit >= 8
    assert warm == cold, \
        "the suffix prefill must match the cold run token for token"
    eng.check()


def test_cow_shared_pages_are_immutable():
    """A second request decoding over a shared chain never writes the
    shared pages: its first decode position lands in a private copy, so
    the cached bytes are equal before and after."""
    eng = mk_paged(rows=2)
    prompt = np.arange(2, 14)            # 1 full page + a 4-token tail
    drain(eng, [mk_req("donor", prompt)])
    shared = cached_pages(eng.prefix_cache)
    assert shared, "the donor must have donated"
    before = {p: pool_pages(eng, p) for p in shared}
    out = drain(eng, [mk_req("warm", prompt, max_new=8)])["warm"]
    assert len(out) == 8
    for p in shared:
        for a, b in zip(before[p], pool_pages(eng, p)):
            assert torch.equal(a, b), \
                f"shared page {p} mutated by a consumer's decode"
    eng.check()


# -- admission honesty --------------------------------------------------------

def test_admission_counts_evictable_pages_and_reclaims():
    eng = mk_paged(rows=2, pages=6, max_len=64)
    ps = eng.page_size
    drain(eng, [mk_req("seed", np.arange(2, 2 + 2 * ps), max_new=1)])
    free, evict = eng.allocator.free_pages, eng._evictable_pages()
    # only the leaf is refcount-0 (its child ref pins the parent)
    assert evict == 1
    assert eng.free_token_budget == (free + evict) * ps
    need = (free + 1) * ps
    assert eng.can_admit(need)
    req = mk_req("big", np.arange(3, 3 + need - 1), max_new=1)
    assert eng.add_request(req)
    assert eng.prefix_cache.stats.evictions > 0
    eng.check()
    # the max_len bound is never weakened by a cached prefix
    assert not eng.can_admit(eng.max_len + 1, cached_tokens=eng.max_len)


# -- v3 suffix-only migration (bit-exact) -------------------------------------

def test_v3_suffix_only_migration_bit_exact_and_smaller():
    prompt = np.arange(2, 26)            # 3 full pages
    reference = drain(mk_paged(seed=0, rows=1),
                      [mk_req("r", prompt, max_new=8)])["r"]

    src, dst = mk_paged(seed=0, rows=1), mk_paged(seed=0, rows=1)
    drain(dst, [mk_req("warmer", prompt, max_new=1)])  # dst holds the chain
    req = mk_req("r", prompt, max_new=8)
    assert src.add_request(req)
    for _ in range(3):
        src.step()
    slot = next(iter(src.requests))
    full_blob = pack_slot(src.extract_slot(slot, keep=True))
    snap = src.extract_slot(slot, suffix_only=True)
    assert snap.version == 3
    assert snap.prefix and len(snap.prefix["chain"]) == 3
    blob = pack_slot(snap)
    assert len(blob) < len(full_blob), (len(blob), len(full_blob))

    moved = dst.inject_slot(unpack_slot(blob, dst.slot_like()))
    while dst.requests:
        dst.step()
    assert moved.output == reference, \
        "the suffix-only hand-off must resume bit-exactly"
    src.check()
    dst.check()


def test_v3_inject_without_chain_fails_loudly():
    prompt = np.arange(2, 26)
    src = mk_paged(seed=0, rows=1)
    assert src.add_request(mk_req("r", prompt, max_new=8))
    src.step()
    snap = src.extract_slot(next(iter(src.requests)), suffix_only=True)
    blob = pack_slot(snap)
    cold_dst = mk_paged(seed=0, rows=1)  # cache armed, chain missing
    with pytest.raises(ValueError, match="missing the 3-block chain"):
        cold_dst.inject_slot(unpack_slot(blob, cold_dst.slot_like()))
    plain_dst = mk_paged(seed=0, rows=1, prefix_cache=False)
    with pytest.raises(ValueError, match="v2"):
        plain_dst.inject_slot(unpack_slot(blob, plain_dst.slot_like()))
    for dst in (cold_dst, plain_dst):
        dst.check()
        assert dst.allocator.used_pages == 0 and not dst.requests


def test_hit_tokens_hashed_matches_legacy_probe():
    eng = mk_paged(seed=20, rows=2)
    prompt = np.arange(3, 25)            # 2 full blocks + a partial tail
    drain(eng, [mk_req("seed", prompt, max_new=1)])
    for probe in (prompt, prompt[:8], np.arange(50, 60)):
        hashed = HashedPrefix(probe)
        assert eng.prefix_cache.hit_tokens_hashed("", hashed) \
            == eng.prefix_cache.hit_tokens("", probe)
        assert eng.prefix_hit_tokens_hashed("", hashed) \
            == eng.prefix_hit_tokens("", probe)


def test_prewarm_chains_grafts_donor_chains_bit_exact():
    """A fresh engine grafts the donor's hot chains page by page, serves
    a warm full hit at once, and decodes bit-identically to a cold run
    of the same prompt."""
    donor, fresh = mk_paged(seed=30), mk_paged(seed=31)
    prompt = np.arange(2, 18)            # 2 full blocks
    live = mk_req("live", prompt, max_new=20)
    assert donor.add_request(live)       # live: the chain is refcount > 0
    report = fresh.prewarm_chains(donor, top_k=4)
    assert report == {"chains": 1, "pages": 2, "skipped": None}
    assert fresh.prefix_cache.hit_tokens("", prompt) == 16
    fresh.allocator.check()
    dn, fn = donor.prefix_cache.nodes, fresh.prefix_cache.nodes
    assert set(dn) == set(fn)
    for key in dn:
        for a, b in zip(pool_pages(donor, dn[key].page),
                        pool_pages(fresh, fn[key].page)):
            assert torch.equal(a, b)
    cold = mk_paged(seed=32)
    out_cold = drain(cold, [mk_req("c", prompt, max_new=6)])["c"]
    out_warm = drain(fresh, [mk_req("w", prompt, max_new=6)])["w"]
    assert fresh.last_prefix_hit == 16   # served from grafted pages
    assert out_warm == out_cold
    fresh.check()


def test_prewarm_chains_loud_skips():
    donor = mk_paged(seed=40)
    prompt = np.arange(2, 18)
    assert donor.add_request(mk_req("live", prompt, max_new=20))
    other = mk_paged(seed=41, page_size=4, max_len=64)
    report = other.prewarm_chains(donor, top_k=4)
    assert report["pages"] == 0
    assert "geometry mismatch" in report["skipped"]
    tiny = mk_paged(seed=42, pages=1)    # fits half the 2-page chain
    report = tiny.prewarm_chains(donor, top_k=4)
    assert report["pages"] == 1
    assert "budget exhausted" in report["skipped"]
    tiny.allocator.check()
    bare = mk_paged(seed=43, prefix_cache=False)
    report = bare.prewarm_chains(donor, top_k=4)
    assert "no prefix cache" in report["skipped"]


_DASH_O = r"""
import numpy as np
from repro_torch.serving.paged import PageAllocator
from repro_torch.serving.prefix_cache import PrefixCache
assert not __debug__
alloc = PageAllocator(4)
cache = PrefixCache(alloc, page_size=2)
node = cache.adopt("t", np.arange(2), 0, alloc.alloc(1, "r")[0])
cache.acquire([node])
try:
    cache._evict(node)
except RuntimeError as e:
    print("evict:", e)
cache.release([node])
try:
    cache.release([node])
except RuntimeError as e:
    print("release:", e)
alloc.owners[node.page] = "someone"
try:
    alloc.check()
except RuntimeError as e:
    print("audit:", e)
"""


def test_allocator_invariants_raise_under_python_O():
    """The allocator's and the cache's invariants are real exceptions:
    ``python -O`` cannot silence them."""
    alloc = PageAllocator(4)
    pages = alloc.alloc(2, "r1")
    alloc.check()
    alloc._free.append(pages[0])         # corrupt: page free AND owned
    with pytest.raises(RuntimeError, match="ledger broken"):
        alloc.check()
    alloc._free.pop()
    del alloc.owners[pages[1]]
    alloc._free.append(pages[0])         # count holds, pages[0] aliased
    with pytest.raises(RuntimeError, match="free and owned"):
        alloc.check()
    out = subprocess.run([sys.executable, "-O", "-c", _DASH_O],
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    assert "evict: evicting referenced node" in out.stdout
    assert "release: releasing unreferenced node" in out.stdout
    assert "audit: cached page" in out.stdout


# -- against the JAX package --------------------------------------------------

@pytest.mark.parametrize("tenant,cross,ps", [("", (), 8), ("ada", (), 16),
                                             ("ada", ("ada",), 4)])
def test_chain_keys_and_hashed_chains_equal_jax(tenant, cross, ps):
    """The chain keys the v3 wire ships are the JAX package's byte for
    byte: roots, child keys, ``chain_keys`` and ``HashedPrefix``."""
    toks = np.random.default_rng(ps).integers(0, 32000, 5 * ps + 3)
    assert pc._root_key(tenant) == jpc._root_key(tenant)
    assert pc._child_key(pc._root_key(tenant), toks[:ps]) \
        == jpc._child_key(jpc._root_key(tenant), toks[:ps])
    mine = PrefixCache(PageAllocator(4), page_size=ps, cross_tenant=cross)
    theirs = jpc.PrefixCache(jpaged.PageAllocator(4), page_size=ps,
                             cross_tenant=cross)
    assert mine.chain_keys(tenant, toks) == theirs.chain_keys(tenant, toks)
    ns = mine.namespace(tenant)
    a = HashedPrefix(toks).chain(ns, ps)
    b = jpc.HashedPrefix(toks).chain(ns, ps)
    assert [k for k, _ in a] == [k for k, _ in b]
    assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(a, b))


def _jax_pair(dtype, **kw):
    jcfg, tcfg = configs(dtype)
    jp, tp = bridged_params(jcfg, seed=5)
    return (jpaged.PagedEngine(jcfg, jp, prefix_cache=True, **kw),
            PagedEngine(tcfg, tp, device="cpu", prefix_cache=True, **kw),
            jcfg, jp)


def _jax_gap(jcfg, jp, before, row):
    """The JAX top-2 logit gap of ``row`` in the decode step taken from
    state ``before``."""
    pt = jnp.where(before.active[:, None], before.page_table, -1)
    lg, _, _ = jforward(jp, {"tokens": before.last_token[:, None]},
                        cfg=jcfg, mode="decode",
                        caches=jpaged._weave(before.caches, pt),
                        positions=before.positions[:, None])
    top2 = jax.lax.top_k(vocab_mask_logits(lg[row, 0], jcfg), 2)[0]
    return float(top2[0] - top2[1])


def _lockstep(jeng, teng, jcfg, jp, diverged):
    """Step both engines until the JAX one drains; a token that differs
    must sit on a JAX top-2 gap under ``GAP_TOL`` (its request is then
    left out of further comparison)."""
    rows = {r.rid: r.slot for r in jeng.requests.values()}
    while jeng.requests:
        before = jeng.state
        je, te = jeng.step(), teng.step()
        assert set(je) == set(te)
        for rid, tok in je.items():
            if rid not in diverged and te[rid] != tok:
                diverged[rid] = _jax_gap(jcfg, jp, before, rows[rid])
    assert not teng.requests
    assert all(g < GAP_TOL for g in diverged.values()), diverged


def _same_ledger(jeng, teng):
    assert np.asarray(jeng.state.page_table).tolist() \
        == teng.state.page_table.tolist()
    assert jeng.allocator.owners == teng.allocator.owners
    assert sorted(jeng.allocator._free) == sorted(teng.allocator._free)
    assert jeng.prefix_cache.stats.as_dict() \
        == teng.prefix_cache.stats.as_dict()
    assert jeng.last_prefix_hit == teng.last_prefix_hit
    jn, tn = jeng.prefix_cache, teng.prefix_cache
    assert {k: (n.page, n.refs) for k, n in jn.nodes.items()} \
        == {k: (n.page, n.refs) for k, n in tn.nodes.items()}
    assert {k: [(n.key, n.page, n.refs) for n in v]
            for k, v in jn.tails.items()} \
        == {k: [(n.key, n.page, n.refs) for n in v]
            for k, v in tn.tails.items()}


def test_request_sequence_matches_jax_paged_engine():
    """One sequence on both engines (f32, bridged weights): a cold donor,
    a full hit beside a partial hit that copies the donor's tail, another
    tenant's miss, the retires, and an admission that must reclaim.
    After every admission and drain the page tables, owners, free lists,
    nodes, stats and ``last_prefix_hit`` are equal; greedy tokens agree
    (1.0 on this seed; a divergence must be a knife edge)."""
    jeng, teng, jcfg, jp = _jax_pair("float32", page_size=8, rows=2,
                                     max_len=64, pages=12, seed=0)
    A = np.arange(2, 22)                 # 2 full blocks + a 4-token tail
    part = np.concatenate([A[:18], np.arange(300, 306)])
    waves = [[("donor", A, "a", 4)],
             [("full", A, "a", 6), ("part", part, "a", 4)],
             [("other", A, "b", 4)],
             [("big", np.arange(100, 144), "c", 4)]]
    hits = []
    diverged = {}
    outs = ({}, {})
    for wave in waves:
        for rid, prompt, tenant, max_new in wave:
            jr = JRequest(rid, prompt, max_new_tokens=max_new,
                          tenant=tenant)
            tr = mk_req(rid, prompt, max_new=max_new, tenant=tenant)
            assert jeng.add_request(jr) and teng.add_request(tr)
            outs[0][rid], outs[1][rid] = jr, tr
            hits.append(teng.last_prefix_hit)
            _same_ledger(jeng, teng)
            teng.check()
        _lockstep(jeng, teng, jcfg, jp, diverged)
        _same_ledger(jeng, teng)
        teng.check()
    assert hits == [0, 20, 18, 0, 0]
    assert teng.prefix_cache.stats.evictions > 0
    # measured on this seed: no divergence
    for rid, jr in outs[0].items():
        if rid not in diverged:
            assert outs[1][rid].output == jr.output, rid


def _jax_v3_blob(jeng, prompt, donor):
    """JAX: a donor served and retired, then a filler in row 0 and the
    migrating request (a partial hit over the donor's chain) in row 1,
    3 steps in: the suffix-only blob of row 1 and the request."""
    assert jeng.add_request(JRequest("d", donor, max_new_tokens=1))
    jeng.step()
    filler = JRequest("f", np.arange(30, 41), max_new_tokens=12)
    req = JRequest("m", prompt, max_new_tokens=12)
    assert jeng.add_request(filler) and jeng.add_request(req)
    assert req.slot == 1 and jeng.last_prefix_hit == len(donor)
    for _ in range(3):
        jeng.step()
    snap = jeng.extract_slot(1, keep=True, suffix_only=True)
    return jmig.pack_slot(snap), req


def _port_like_source(teng, donor):
    """The port engine holding the donor's chain, with a filler in row 0
    stepped as the JAX source was, so step counts and free rows match."""
    assert teng.add_request(mk_req("d", donor, max_new=1))
    teng.step()
    assert teng.add_request(mk_req("f", np.arange(30, 41), max_new=12))
    for _ in range(3):
        teng.step()


_DONOR = np.arange(2, 26)                # 3 full blocks at page size 8
_MOVER = np.concatenate([_DONOR, np.arange(60, 65)])


def test_jax_v3_blob_roundtrips_through_the_port():
    """JAX v3 blob -> port unpack_slot / inject_slot (the chain resolved
    in the port's own cache) -> port extract_slot(suffix_only) /
    pack_slot: the meta (prefix chain included) and every non-RNG leaf
    equal the JAX blob's."""
    jeng, teng, _, _ = _jax_pair("bfloat16", page_size=8, rows=3,
                                 max_len=64, seed=0)
    jblob, _ = _jax_v3_blob(jeng, _MOVER, _DONOR)
    _port_like_source(teng, _DONOR)
    snap = unpack_slot(jblob, teng.slot_like())
    assert snap.version == 3 and len(snap.prefix["chain"]) == 3
    assert teng.prefix_cache.has_chain(snap.prefix["chain"])
    # repack_slot passes a v3 snapshot through as JAX's does
    jsnap = jmig.repack_slot(jmig.unpack_slot(jblob, jeng.slot_like()), 128)
    snap = repack_slot(snap, 128)
    assert snap.prefix == jsnap.prefix and snap.version == jsnap.version
    teng.inject_slot(snap, slot=1)
    teng.check()
    tblob = pack_slot(teng.extract_slot(1, keep=True, suffix_only=True))
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
    # the payload is the suffix: 1 private page of the 4 live ones
    assert ol[0]["shape"][1] == 1


def test_port_continuation_after_a_jax_v3_blob_agrees_with_jax():
    """f32: the port resumes a JAX-packed v3 slot over its own cached
    chain and decodes in lockstep with the JAX source (agreement 1.0 on
    this seed; a divergence must sit on a knife-edge JAX top-2 gap)."""
    jeng, teng, jcfg, jp = _jax_pair("float32", page_size=8, rows=3,
                                     max_len=64, seed=0)
    jblob, jreq = _jax_v3_blob(jeng, _MOVER, _DONOR)
    _port_like_source(teng, _DONOR)
    moved = teng.inject_slot(unpack_slot(jblob, teng.slot_like()), slot=1)
    assert teng.state.page_table[1, :3].tolist() == [
        n.page for n in teng._shared[1]]
    diverged = {}
    _lockstep(jeng, teng, jcfg, jp, diverged)
    assert len(moved.output) == len(jreq.output) == 12
    if "m" not in diverged:
        assert moved.output == jreq.output
    teng.check()


def test_jax_warm_admit_evicts_its_own_chain_and_the_port_does_not():
    """JAX ``add_request`` matches both blocks, fails ``alloc(5)`` and
    reclaims block 1 of the chain it just matched; the LIFO allocator
    hands that page straight back as the row's first private page, so
    the page table maps it twice and the first decode step writes
    position 16 over position 8's KV: the warm tokens leave the cold
    run's.  The port pins the chain before it reclaims and refuses, with
    no page moved and ``check()`` intact."""
    jcfg, tcfg = configs("float32")
    jp, tp = bridged_params(jcfg, seed=5)
    geo = dict(page_size=8, rows=2, max_len=64)
    donor = np.arange(2, 18)
    jeng = jpaged.PagedEngine(jcfg, jp, pages=6, prefix_cache=True, **geo)
    teng = PagedEngine(tcfg, tp, pages=6, prefix_cache=True, device="cpu",
                       **geo)
    for eng, R in ((jeng, JRequest), (teng, Request)):
        assert eng.add_request(R("d", donor, max_new_tokens=1))
        while eng.requests:
            eng.step()
        assert eng.allocator.free_pages == 4
        assert eng.can_admit(56, cached_tokens=16)
    # the reference: admitted, with a page mapped twice
    jr = JRequest("w", donor, max_new_tokens=40)
    assert jeng.add_request(jr)
    pt = [int(p) for p in np.asarray(jeng.state.page_table[jr.slot])]
    live = [p for p in pt if p >= 0]
    assert len(set(live)) < len(live), pt
    while jeng.requests:
        jeng.step()
    cold = jpaged.PagedEngine(jcfg, jp, pages=8, **geo)
    cr = JRequest("c", donor, max_new_tokens=40)
    assert cold.add_request(cr)
    while cold.requests:
        cold.step()
    assert jr.output != cr.output
    # the port: refused before any page moves
    before = (dict(teng.allocator.owners), list(teng.allocator._free),
              teng.prefix_cache.stats.as_dict(),
              {k: n.refs for k, n in teng.prefix_cache.nodes.items()})
    assert not teng.add_request(mk_req("w", donor, max_new=40))
    assert (dict(teng.allocator.owners), list(teng.allocator._free),
            teng.prefix_cache.stats.as_dict(),
            {k: n.refs for k, n in teng.prefix_cache.nodes.items()}) \
        == before
    assert not teng.requests and bool((teng.state.page_table == -1).all())
    teng.check()
    # with two more pages the port admits it warm, equal to its cold run
    outs = []
    for cache in (True, False):
        eng = PagedEngine(tcfg, tp, pages=8, prefix_cache=cache,
                          device="cpu", **geo)
        if cache:
            drain(eng, [mk_req("d", donor, max_new=1)])
        outs.append(drain(eng, [mk_req("w", donor, max_new=40)])["w"])
        assert eng.last_prefix_hit == (16 if cache else 0)
        eng.check()
    assert outs[0] == outs[1]


def test_jax_v3_inject_evicts_its_own_chain_and_the_port_does_not():
    """The v3 branch of JAX ``inject_slot`` has the same order
    (lookup_chain -> alloc -> reclaim -> acquire): it evicts block 1 of
    the chain it looked up and maps that page twice.  The port pins the
    chain first and raises ``RuntimeError`` with no page moved."""
    jcfg, tcfg = configs("float32")
    jp, tp = bridged_params(jcfg, seed=5)
    geo = dict(page_size=8, rows=2, max_len=64)
    donor = np.arange(2, 18)
    out = {}
    for name, make, R, pack, unpack in (
            ("jax", lambda **k: jpaged.PagedEngine(jcfg, jp, **geo, **k),
             JRequest, jmig.pack_slot, jmig.unpack_slot),
            ("port", lambda **k: PagedEngine(tcfg, tp, device="cpu", **geo,
                                             **k),
             Request, pack_slot, unpack_slot)):
        src = make(prefix_cache=True)
        req = R("m", donor, max_new_tokens=40)
        assert src.add_request(req)
        src.step()
        blob = pack(src.extract_slot(req.slot, suffix_only=True))
        dst = make(pages=6, prefix_cache=True)
        assert dst.add_request(R("d", donor, max_new_tokens=1))
        while dst.requests:
            dst.step()
        assert dst.allocator.free_pages == 4
        out[name] = (dst, unpack(blob, dst.slot_like()))
    jdst, jsnap = out["jax"]
    moved = jdst.inject_slot(jsnap)
    pt = [int(p) for p in np.asarray(jdst.state.page_table[moved.slot])]
    live = [p for p in pt if p >= 0]
    assert len(set(live)) < len(live), pt
    tdst, tsnap = out["port"]
    owners, free = dict(tdst.allocator.owners), list(tdst.allocator._free)
    with pytest.raises(RuntimeError, match="no free page budget"):
        tdst.inject_slot(tsnap)
    assert tdst.allocator.owners == owners and tdst.allocator._free == free
    assert not tdst.requests and tdst.prefix_cache.stats.evictions == 0
    tdst.check()


def test_warm_prompt_outside_the_cold_domain():
    """A cold prefill is held to the flash domain (a prompt over 512
    tokens must be a multiple of 512); a warm one forwards its suffix
    through the decode path.  So a 1061-token prompt over a cached
    1024-token prefix is admitted with hit 1024, and the same prompt
    cold is refused before any page moves."""
    geo = dict(page_size=16, rows=1, max_len=1152)
    rng = np.random.default_rng(3)
    base = rng.integers(0, CFG.vocab_size, 1024)
    prompt = np.concatenate([base, rng.integers(0, CFG.vocab_size, 37)])
    eng = mk_paged(**geo)
    drain(eng, [mk_req("donor", base, max_new=2)])
    out = drain(eng, [mk_req("warm", prompt, max_new=4)])["warm"]
    assert eng.last_prefix_hit == 1024 and len(out) == 4
    eng.check()
    for cold in (mk_paged(**geo), mk_paged(prefix_cache=False, **geo)):
        with pytest.raises(ValueError, match="domain"):
            cold.add_request(mk_req("cold", prompt, max_new=4))
        assert cold.allocator.used_pages == 0 and not cold.requests
        cold.check()
