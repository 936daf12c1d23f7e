"""Paged-KV serving engine: token-budget continuous batching.

``PagedEngine`` carves its KV memory into fixed-size *pages* shared by
every batch row: a ``PageAllocator`` hands out pages, each request holds
a page table (logical position i lives at offset ``i % page_size`` of
page ``page_table[i // page_size]``), and admission is gated by the free
page budget rather than a free-slot count.  A request reserves
``ceil((prompt + max_new) / page_size)`` pages up front, so an admitted
request never waits for pages mid-decode.

Prefill runs the hand-written flash-attention kernel over the prompt and
scatters its K/V into the row's reserved pages; every decode step runs
the paged-decode kernel over the pools in place.  The decode batch width
(``rows``) is fixed; rows carry no KV memory of their own.

With ``prefix_cache=True`` a ``PrefixCache`` shares prompt pages
between requests: a warm admission references the cached chain's pages
in place, copies a cached partial tail into a private page, and forwards
only the uncovered suffix -- one decode-mode forward a token, so each
reads the shared pages through the paged-decode kernel.  A full hit runs
no forward at all.  Shared pages are only ever read: every position a
row writes lies in one of its private pages.

A request moves between engines on wire version 2 (``extract_slot`` /
``inject_slot``): only its live pages travel, position-ordered and free
of this engine's pool indices, so the destination's pool may differ in
size, occupancy and seed as long as the page size and the program
geometry match (the page-level contract).  Wire version 3
(``suffix_only=True``) ships the shared chain as its hashes and only the
private pages; the destination re-references its own cached copies.
The speculative surface (``rollback_slot``, ``_force_slot_token``,
``add_request(committed=)``) follows the dense engine's.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.kernels.ops import check_domain
from repro_torch.models.init import torch_dtype
from repro_torch.models.layers import make_paged_attn_cache
from repro_torch.models.model import forward
from repro_torch.core.tree import LeafSpec, register_node
from repro_torch.serving.engine import (Request, SlotArrays, SlotSnapshot,
                                        request_from_dict, request_to_dict)
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.program_cache import get_programs
from repro_torch.serving.sampling import rng_state, sample


class PageAllocator:
    """LIFO free-list allocator over a fixed pool of KV pages.

    Tracks ownership so conservation is checkable at any point:
    ``len(free) + len(owners) == total`` always, no page is handed out
    twice, and freeing a page that is not owned raises.
    """

    def __init__(self, total: int):
        self.total = total
        self._free: list[int] = list(range(total - 1, -1, -1))
        self.owners: dict[int, str] = {}
        # extra invariant checks run by check() -- the prefix cache
        # registers its refcount/ownership audit here so every existing
        # allocator.check() call site also audits shared pages
        self.auditors: list = []

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return len(self.owners)

    def alloc(self, n: int, owner: str) -> list[int] | None:
        """Hand out ``n`` pages to ``owner`` or None (never partial)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self.owners[p] = owner
        return pages

    def free(self, pages: list[int]):
        for p in pages:
            if p not in self.owners:
                raise ValueError(f"freeing unowned page {p}")
            del self.owners[p]
            self._free.append(p)

    def retag(self, page: int, owner: str):
        """Transfer ownership of an allocated page (request -> prefix
        cache donation) without it ever appearing free."""
        if page not in self.owners:
            raise ValueError(f"retagging unowned page {page}")
        self.owners[page] = owner

    def check(self):
        """Conservation invariant; raises ``RuntimeError`` on violation.

        Real exceptions, not ``assert``: this is the load-bearing page
        ledger -- it must keep firing under ``python -O``."""
        if len(self._free) + len(self.owners) != self.total:
            raise RuntimeError(
                f"page ledger broken: {len(self._free)} free + "
                f"{len(self.owners)} owned != {self.total} total")
        if len(set(self._free)) != len(self._free):
            raise RuntimeError("free-list dup")
        if set(self._free) & set(self.owners):
            raise RuntimeError(
                f"pages both free and owned: "
                f"{sorted(set(self._free) & set(self.owners))}")
        for audit in self.auditors:
            audit()


@register_node
@dataclass
class PagedEngineState:
    """Decode-loop state.  Tensors live on the engine's device and are
    updated in place, except ``rng``: (B, 2) int64 ``(seed, counter)``
    pairs on the CPU (see ``serving.sampling``)."""
    caches: list                     # [group][layer] {"attn": {k/v_pool}}
    page_table: torch.Tensor         # (B, NP) int32 page ids, -1 = unmapped
    tokens: torch.Tensor             # (B, max_len) int32
    positions: torch.Tensor          # (B,) int32
    last_token: torch.Tensor         # (B,) int32
    active: torch.Tensor             # (B,) bool
    rng: torch.Tensor                # (B, 2) int64, CPU
    step_count: int
    temperature: torch.Tensor        # (B,) float32
    top_k: torch.Tensor              # (B,) int32


class PagedEngine:
    """Serving engine over a paged KV cache (attention-only decoders)."""

    def __init__(self, cfg: ModelConfig, params, *, page_size: int = 16,
                 pages: int | None = None, rows: int = 4,
                 max_len: int = 256, seed: int = 0, device="cuda",
                 prefix_cache: bool = False, shared_tenants: tuple = ()):
        if not (all(ls.mixer in ("attn", "local")
                    for b in cfg.blocks for ls in b.layers)
                and not cfg.cross_attention and not cfg.encoder_blocks):
            raise ValueError(
                "PagedEngine requires an attention-only decoder model")
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} is not a multiple of "
                             f"page_size {page_size}")
        self.device = resolve(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params on {params['embed'].device}, engine "
                             f"on {self.device}")
        self.cfg = cfg
        self.params = params
        self.page_size = page_size
        self.np_pages = max_len // page_size     # page-table width NP
        # default pool: every row could hold a full max_len request
        self.pages = pages if pages is not None else rows * self.np_pages
        self.rows = rows
        self.max_len = max_len
        self.requests: dict[int, Request] = {}
        self.allocator = PageAllocator(self.pages)
        self.state = self._fresh_state(seed)
        self._programs, self.program_cache_hit = get_programs(
            "paged", cfg, None, None, slots=rows, max_len=max_len,
            page_size=page_size, pages=self.pages,
            build=lambda: {
                "decode": partial(_paged_decode_step, cfg=cfg),
                "prefill": partial(_paged_prefill, cfg=cfg),
                "suffix": partial(_paged_suffix_prefill, cfg=cfg),
            })
        self._decode_fn = self._programs.fns["decode"]
        self._prefill_fn = self._programs.fns["prefill"]
        self._suffix_fn = self._programs.fns["suffix"]
        # -- multi-tenant prefix sharing (opt-in) ---------------------------
        self.prefix_cache = None
        self._shared: dict[int, list] = {}   # row -> referenced PrefixNodes
        self.last_prefix_hit = 0             # tokens served shared, last admit
        if prefix_cache:
            self.prefix_cache = PrefixCache(
                self.allocator, page_size=page_size,
                cross_tenant=tuple(shared_tenants),
                token_bytes=self.kv_token_bytes)

    @property
    def kv_token_bytes(self) -> int:
        """KV bytes one token occupies across every layer's pools."""
        return (2 * self.cfg.num_layers * self.cfg.num_kv_heads
                * self.cfg.head_dim * torch_dtype(self.cfg.dtype).itemsize)

    @property
    def page_bytes(self) -> int:
        return self.kv_token_bytes * self.page_size

    def _run(self, key: str, fn):
        self._programs.compiled.add(key)
        return fn()

    # -- state ------------------------------------------------------------
    def _fresh_state(self, seed: int) -> PagedEngineState:
        B, dev = self.rows, self.device
        caches = []
        for block in self.cfg.blocks:
            layers = []
            for _ in block.layers:
                # pools stacked over repeats, as the params are
                one = make_paged_attn_cache(self.cfg, self.pages,
                                            self.page_size, device=dev)
                layers.append({"attn": {
                    k: a[None].repeat(block.repeats, 1, 1, 1, 1)
                    for k, a in one.items()}})
            caches.append(layers)
        return PagedEngineState(
            caches=caches,
            page_table=torch.full((B, self.np_pages), -1, dtype=torch.int32,
                                  device=dev),
            tokens=torch.zeros((B, self.max_len), dtype=torch.int32,
                               device=dev),
            positions=torch.zeros((B,), dtype=torch.int32, device=dev),
            last_token=torch.zeros((B,), dtype=torch.int32, device=dev),
            active=torch.zeros((B,), dtype=torch.bool, device=dev),
            rng=rng_state(range(seed, seed + B)),
            step_count=0,
            temperature=torch.zeros((B,), dtype=torch.float32, device=dev),
            top_k=torch.zeros((B,), dtype=torch.int32, device=dev),
        )

    # -- capacity ----------------------------------------------------------
    @property
    def free_slots(self) -> list[int]:
        return [i for i in range(self.rows) if i not in self.requests]

    def _pages_for(self, need_tokens: int) -> int:
        return -(-need_tokens // self.page_size)

    def _evictable_pages(self) -> int:
        """Refcount-0 prefix-cache pages: reclaimed on demand at
        admission, so they count as free capacity."""
        return (self.prefix_cache.evictable_pages()
                if self.prefix_cache is not None else 0)

    def can_admit(self, need_tokens: int, *, cached_tokens: int = 0) -> bool:
        """``cached_tokens`` (page-aligned, from ``prefix_hit_tokens``)
        discounts the page reservation only; the ``max_len`` bound stays
        unreduced, since the row holds the whole stream."""
        need_pages = (self._pages_for(need_tokens)
                      - cached_tokens // self.page_size)
        return (bool(self.free_slots)
                and need_tokens <= self.max_len
                and need_pages
                <= self.allocator.free_pages + self._evictable_pages())

    def admissible(self, need_tokens: int) -> bool:
        return (need_tokens <= self.max_len
                and self._pages_for(need_tokens) <= self.allocator.total)

    def prefix_hit_tokens(self, tenant: str, tokens) -> int:
        """Full-page cached coverage of ``tokens`` for ``tenant``: that
        many prefill tokens (and pages) a warm admission would skip."""
        if self.prefix_cache is None or tokens is None or not len(tokens):
            return 0
        return self.prefix_cache.hit_tokens(tenant, tokens)

    def prefix_hit_tokens_hashed(self, tenant: str, hashed) -> int:
        """``prefix_hit_tokens`` over a precomputed ``HashedPrefix``."""
        if self.prefix_cache is None or hashed is None \
                or not len(hashed.tokens):
            return 0
        return self.prefix_cache.hit_tokens_hashed(tenant, hashed)

    @property
    def free_token_budget(self) -> int:
        if not self.free_slots:
            return 0
        return ((self.allocator.free_pages + self._evictable_pages())
                * self.page_size)

    # -- request lifecycle --------------------------------------------------
    def _row_pages(self, row: int) -> list[int]:
        pt = self.state.page_table[row].cpu().tolist()
        return [p for p in pt if p >= 0]

    def _reserve(self, n: int, owner: str, nodes: list) -> list[int] | None:
        """Allocate ``n`` private pages, reclaiming refcount-0 cache pages
        if the free list is short.  ``nodes`` -- the chain the caller is
        about to reference -- is acquired first, so the reclaim can never
        evict it and hand its page back as a private one; on failure it is
        released again and None returned, with no page moved for it."""
        cache = self.prefix_cache
        if nodes:
            cache.acquire(nodes)
        pages = self.allocator.alloc(n, owner)
        if pages is None and cache is not None:
            cache.reclaim(n - self.allocator.free_pages)
            pages = self.allocator.alloc(n, owner)
        if pages is None and nodes:
            cache.release(nodes)
        return pages

    def add_request(self, req: Request, *,
                    committed: list[int] | None = None) -> bool:
        """Admit iff a decode row is free AND the reservation fits the
        free page budget -- reserving up front means an admitted request
        can never deadlock mid-decode waiting for pages.

        With a prefix cache the reservation is charged for what the cache
        does not cover: the longest cached chain is referenced in place,
        a cached partial tail is copied into the first private page, and
        only the uncovered suffix is forwarded (a full hit runs no forward
        at all).  The prefill domain applies to a cold prefill only; a
        warm suffix goes through the decode path.

        ``committed`` is the lossy cross-tier restore path, as on the
        dense engine: the row prefills prompt + the committed tokens,
        which become the request's output prefix."""
        free = self.free_slots
        if not free:
            return False
        need = len(req.prompt) + req.max_new_tokens
        if need > self.max_len:
            raise ValueError(f"request {req.rid!r} needs {need} tokens > "
                             f"max_len {self.max_len}")
        prefix = np.asarray(req.prompt, np.int32)
        if committed:
            prefix = np.concatenate(
                [prefix, np.asarray(committed, np.int32)])
        plen = len(prefix)
        cache = self.prefix_cache
        tenant = req.tenant
        full_nodes, tail, hit = (cache.match(tenant, prefix)
                                 if cache is not None else ([], None, 0))
        if hit == 0:
            check_domain(plen)           # refuse before any page moves
        n_ref = len(full_nodes)
        pages = self._reserve(self._pages_for(need) - n_ref, req.rid,
                              full_nodes)
        if pages is None:
            return False
        row = free[0]
        req.slot = row
        self.requests[row] = req
        if committed:
            req.output[:] = list(committed)
        self._shared[row] = list(full_nodes)
        pt_row = np.full((self.np_pages,), -1, np.int32)
        pt_row[:n_ref] = [n.page for n in full_nodes]
        pt_row[n_ref:n_ref + len(pages)] = pages
        s = self.state
        s.page_table[row] = torch.from_numpy(pt_row).to(self.device)
        s.temperature[row] = req.temperature
        s.top_k[row] = req.top_k
        if tail is not None and hit > n_ref * self.page_size:
            # copy on write: the block holding the first position this row
            # writes is the cached tail's copy, never the shared page
            self._copy_page(tail.page, pages[0])
        self.last_prefix_hit = hit
        if hit >= plen:
            # full hit: every prompt token's KV is already in the row's
            # page table (shared chain + copied tail)
            self._warm_start(row, prefix)
        elif hit == 0:
            prompt = torch.from_numpy(prefix).to(self.device)[None]
            self.state = self._run(
                f"prefill[plen={plen}]",
                lambda: self._prefill_fn(self.params, s, prompt, slot=row,
                                         plen=plen))
        else:
            # suffix prefill: seed the covered region, then forward the
            # uncovered tokens through the decode path (prefill attention
            # never reads the pools, so the suffix could not see the
            # shared prefix there)
            self._warm_start(row, prefix[:hit])
            suffix = torch.from_numpy(prefix[hit:]).to(self.device)[None]
            slen = plen - hit
            self.state = self._run(
                f"suffix[slen={slen}]",
                lambda: self._suffix_fn(self.params, self.state, suffix,
                                        slot=row, slen=slen))
        if cache is not None:
            self._donate(row, tenant, prefix, hit)
            cache.account(hit)
        return True

    def _warm_start(self, row: int, covered: np.ndarray):
        """Seed a row as if ``covered`` had just been prefilled: tokens
        written, position past the covered region, last token primed.
        The region's KV must already sit in the row's page table."""
        s = self.state
        n = len(covered)
        s.tokens[row, :n] = torch.from_numpy(
            np.asarray(covered, np.int32)).to(self.device)
        s.positions[row] = n
        s.last_token[row] = int(covered[-1])
        s.active[row] = True

    def _copy_page(self, src: int, dst: int):
        """Copy one physical page across every layer's pools (the
        copy-on-write fork and the tail donation), in place."""
        for grp in self.state.caches:
            for layer in grp:
                a = layer["attn"]
                for name in ("k_pool", "v_pool"):
                    a[name][:, dst].copy_(a[name][:, src])

    def _copy_page_from(self, donor: PagedEngine, src: int, dst: int):
        """Copy one physical page of ``donor``'s pools into this engine's
        (cross-engine pre-warm; the engines share config and page size)."""
        for grp, dgrp in zip(self.state.caches, donor.state.caches):
            for layer, dlayer in zip(grp, dgrp):
                a, b = layer["attn"], dlayer["attn"]
                for name in ("k_pool", "v_pool"):
                    a[name][:, dst].copy_(b[name][:, src])

    def prewarm_chains(self, donor: PagedEngine, *, top_k: int = 4) -> dict:
        """Pre-warm this engine's prefix cache from a same-geometry donor:
        graft the donor's hottest referenced chains (most recently touched
        first, at most ``top_k``) root first, copying each page into a
        page allocated here.  Best effort with a loud skip: the report
        says how many chains and pages landed and why it stopped
        (``skipped``); it never raises."""
        report = {"chains": 0, "pages": 0, "skipped": None}
        mine, theirs = self.prefix_cache, donor.prefix_cache
        if mine is None or theirs is None:
            report["skipped"] = "no prefix cache on donor or target"
            return report
        if (donor.page_size != self.page_size
                or donor.cfg.name != self.cfg.name):
            report["skipped"] = (
                f"geometry mismatch: donor {donor.cfg.name}"
                f"/ps={donor.page_size} vs {self.cfg.name}"
                f"/ps={self.page_size}")
            return report
        # hottest chain := most recently touched referenced node; the
        # chain is that node's ancestry, grafted root first
        hot = sorted((n for n in theirs.nodes.values() if n.refs > 0),
                     key=lambda n: n.stamp, reverse=True)
        planned: list = []
        chains = 0
        for leaf in hot:
            if chains >= top_k:
                break
            chain = []
            node, seen = leaf, {n.key for n in planned}
            while node is not None:
                if node.key in seen or node.key in mine.nodes:
                    break            # ancestry already planned or local
                chain.append(node)
                node = theirs.nodes.get(node.parent) \
                    if node.parent is not None else None
            if not chain:
                continue
            planned.extend(reversed(chain))
            chains += 1
        for node in planned:
            pages = self.allocator.alloc(1, f"prewarm:{node.key}")
            if pages is None:
                report["skipped"] = (
                    f"page budget exhausted after {report['pages']} of "
                    f"{len(planned)} pages")
                break
            self._copy_page_from(donor, node.page, pages[0])
            if mine.graft(node, pages[0]) is None:
                self.allocator.free(pages)
                continue
            report["pages"] += 1
        report["chains"] = chains
        return report

    def _donate(self, row: int, tenant: str, prefix: np.ndarray, hit: int):
        """Publish this row's freshly prefilled prompt blocks into the
        cache: full blocks move to the cache in place (the row keeps a
        reference), the partial tail is donated as a copy (the row's own
        tail page is about to be written by decode)."""
        cache, ps = self.prefix_cache, self.page_size
        nodes = self._shared[row]
        row_pages = self._row_pages(row)
        for d in range(len(nodes), len(prefix) // ps):
            node = cache.adopt(tenant, prefix, d, row_pages[d])
            if node is None:
                # a peer cached this block since the match: keep the
                # private page and stop extending the chain
                return
            cache.acquire([node])
            nodes.append(node)
        if len(prefix) % ps and hit < len(prefix):
            d = len(prefix) // ps
            cache.adopt_tail(tenant, prefix,
                             lambda dst: self._copy_page(row_pages[d], dst))

    def step(self, *, auto_retire: bool = True) -> dict[str, int]:
        if not self.requests:
            return {}
        self.state, toks = self._run(
            "decode", lambda: self._decode_fn(self.params, self.state))
        toks = toks.cpu().numpy()
        emitted = {}
        for row, req in list(self.requests.items()):
            if req.done:
                continue
            t = int(toks[row])
            req.output.append(t)
            emitted[req.rid] = t
            if auto_retire and len(req.output) >= req.max_new_tokens:
                req.done = True
                self.retire(row)
        return emitted

    def retire(self, row: int):
        self.requests.pop(row, None)
        pages = self._row_pages(row)
        nodes = self._shared.pop(row, None)
        if nodes:
            # shared pages lead the page table: drop the references (the
            # cache frees them only at refcount-0 eviction) and free just
            # the row's private pages
            self.prefix_cache.release(nodes)
            pages = pages[len(nodes):]
        if pages:
            self.allocator.free(pages)
        self.state.page_table[row] = -1
        self.state.active[row] = False

    # -- per-slot live migration (v2: live pages; v3: suffix only) ----------
    def extract_slot(self, slot: int, *, keep: bool = False,
                     suffix_only: bool = False) -> SlotSnapshot:
        """Detach one request shipping only its live pages (wire v2).

        The payload's cache leaves are (R, n_live, page_size, KV, Dh)
        where ``n_live = ceil(position / page_size)`` -- position-ordered
        pages, free of this engine's pool indices -- plus the token
        prefix trimmed to the live region.  Unless ``keep``, the row is
        retired and its pages freed.

        ``suffix_only`` (wire v3) leaves the row's shared chain pages out
        and ships their chain hashes instead (``snap.prefix``): a
        destination whose cache holds the chain references its own copies
        and only the private pages cross.  Callers check the destination
        first (``prefix_cache.has_chain``).  A row with no shared chain
        raises ``ValueError`` before anything changes."""
        req = self.requests[slot]
        s = self.state
        pos = int(s.positions[slot])
        ps = self.page_size
        n_live = max(1, -(-pos // ps))
        shared = self._shared.get(slot, [])
        n_skip, prefix_meta = 0, None
        if suffix_only:
            if not shared:
                raise ValueError(
                    f"suffix_only extract of {req.rid!r} needs a shared "
                    "prefix chain; this row references none")
            n_skip = min(len(shared), n_live)
            prefix_meta = {"tenant": req.tenant,
                           "chain": [n.key for n in shared[:n_skip]],
                           "len": n_skip * ps}
        live = torch.tensor(self._row_pages(slot)[n_skip:n_live],
                            dtype=torch.long, device=self.device)
        arrays = SlotArrays(
            caches=[[{"attn": {"k": layer["attn"]["k_pool"][:, live],
                               "v": layer["attn"]["v_pool"][:, live]}}
                     for layer in grp] for grp in s.caches],
            tokens=s.tokens[slot, :n_live * ps].clone(),
            position=s.positions[slot].clone(),
            last_token=s.last_token[slot].clone(),
            rng=s.rng[slot].clone(),
            temperature=s.temperature[slot].clone(),
            top_k=s.top_k[slot].clone())
        snap = SlotSnapshot(arrays=arrays, request=request_to_dict(req),
                            config_name=self.cfg.name,
                            step=int(s.step_count),
                            version=3 if suffix_only else 2, page_size=ps,
                            prefix=prefix_meta)
        if not keep:
            self.retire(slot)
        return snap

    def inject_slot(self, snap: SlotSnapshot,
                    slot: int | None = None) -> Request:
        """Resume a v2 or v3 snapshot: allocate a fresh reservation of
        ``max(pages_for(prompt + max_new) - n_shared, n_live)`` pages
        here, scatter the shipped pages into it, pad the token prefix out
        to this engine's max_len and write the row's page table.  A v3
        snapshot's chain must be in this engine's cache: its ``n_shared``
        pages are referenced in place and lead the page table.  Page ids
        are engine-local, so the pools never need to line up -- only the
        page size and the program geometry do.  Every refusal raises
        before any page moves: ``ValueError`` for a snapshot this engine
        cannot take, ``RuntimeError`` when no row or page budget is
        free."""
        if snap.config_name != self.cfg.name:
            raise ValueError(f"config mismatch: {self.cfg.name} != "
                             f"{snap.config_name}")
        if snap.version not in (2, 3):
            raise ValueError(
                f"PagedEngine.inject_slot needs a v2/v3 (paged) "
                f"snapshot, got v{snap.version}; route dense blobs "
                f"through lossy re-prefill")
        if snap.page_size != self.page_size:
            raise ValueError(
                f"page_size mismatch: blob {snap.page_size} != engine "
                f"{self.page_size} (cross-geometry moves are lossy)")
        req = request_from_dict(snap.request)
        nodes = []
        if snap.version == 3:
            if self.prefix_cache is None:
                raise ValueError(
                    f"v3 (suffix-only) blob for {req.rid!r} but this "
                    "engine has no prefix cache; the sender must fall "
                    "back to full v2")
            chain = snap.prefix["chain"]
            nodes = self.prefix_cache.lookup_chain(chain)
            if nodes is None:
                raise ValueError(
                    f"v3 (suffix-only) blob for {req.rid!r}: destination "
                    f"prefix cache is missing the {len(chain)}-block "
                    f"chain; the sender must fall back to full v2")
            if snap.prefix["len"] != len(nodes) * self.page_size:
                raise ValueError(
                    f"v3 blob for {req.rid!r}: prefix len "
                    f"{snap.prefix['len']} != {len(nodes)} blocks")
        n_sh = len(nodes)
        a = snap.arrays
        need = len(req.prompt) + req.max_new_tokens
        n_live = self._check_pages(a, n_sh)
        if need > self.max_len \
                or (n_sh + n_live) * self.page_size > self.max_len:
            raise ValueError(
                f"{req.rid!r} needs {need} tokens and {n_sh} + {n_live} "
                f"live pages; this engine's max_len is {self.max_len}")
        if slot is None:
            free = self.free_slots
            if not free:
                raise RuntimeError(f"no free row to inject {req.rid!r} into")
            slot = free[0]
        if not 0 <= slot < self.rows:
            raise ValueError(f"row {slot} out of range [0, {self.rows})")
        if slot in self.requests:
            raise RuntimeError(f"row {slot} busy")
        pages = self._reserve(max(self._pages_for(need) - n_sh, n_live),
                              req.rid, nodes)
        if pages is None:
            raise RuntimeError(
                f"no free page budget to inject {req.rid!r} into")
        s = self.state
        live = torch.tensor(pages[:n_live], dtype=torch.long,
                            device=self.device)
        for grp, pgrp in zip(s.caches, a.caches):
            for layer, pay in zip(grp, pgrp):
                p, q = layer["attn"], pay["attn"]
                p["k_pool"][:, live] = q["k"]
                p["v_pool"][:, live] = q["v"]
        if nodes:
            self._shared[slot] = list(nodes)
        pt_row = np.full((self.np_pages,), -1, np.int32)
        pt_row[:n_sh] = [n.page for n in nodes]
        pt_row[n_sh:n_sh + len(pages)] = pages
        s.page_table[slot] = torch.from_numpy(pt_row).to(self.device)
        s.tokens[slot] = 0
        s.tokens[slot, :a.tokens.shape[0]] = a.tokens.to(self.device)
        s.positions[slot] = a.position.to(self.device)
        s.last_token[slot] = a.last_token.to(self.device)
        s.active[slot] = True
        s.rng[slot] = a.rng.to(s.rng.device)
        s.temperature[slot] = a.temperature.to(self.device)
        s.top_k[slot] = a.top_k.to(self.device)
        req.slot = slot
        self.requests[slot] = req
        return req

    def _check_pages(self, a: SlotArrays, n_shared: int = 0) -> int:
        """The payload's page count; refuses one whose layers, page
        leaves or token prefix (``n_shared`` chain pages + the payload's,
        in tokens) do not fit this engine's pools exactly (no broadcast,
        no cast)."""
        if [len(g) for g in a.caches] != [len(g) for g in self.state.caches]:
            raise ValueError(
                f"layer mismatch: blob {[len(g) for g in a.caches]} != "
                f"engine {[len(g) for g in self.state.caches]}")
        n_live = a.caches[0][0]["attn"]["k"].shape[1]
        for grp, pgrp in zip(self.state.caches, a.caches):
            for layer, pay in zip(grp, pgrp):
                for name in ("k", "v"):
                    pool, leaf = layer["attn"][f"{name}_pool"], \
                        pay["attn"][name]
                    want = (pool.shape[0], n_live) + tuple(pool.shape[2:])
                    if tuple(leaf.shape) != want or leaf.dtype != pool.dtype:
                        raise ValueError(
                            f"live-page leaf {name} {tuple(leaf.shape)} "
                            f"{leaf.dtype} != {want} {pool.dtype}")
        want = ((n_shared + n_live) * self.page_size,)
        if tuple(a.tokens.shape) != want:
            raise ValueError(f"token prefix {tuple(a.tokens.shape)} != "
                             f"{want}")
        return n_live

    def slot_like(self) -> SlotArrays:
        """``LeafSpec`` template for v2 wire deserialization.  Only the
        structure, dtypes and devices matter (``deserialize_tree`` takes
        shapes from the blob -- the live-page axis varies per
        snapshot), so the page axis here is a placeholder 1."""
        ps, KV, Dh = (self.page_size, self.cfg.num_kv_heads,
                      self.cfg.head_dim)
        dev = self.device
        dt = torch_dtype(self.cfg.dtype)

        def layer(repeats):
            sds = LeafSpec((repeats, 1, ps, KV, Dh), dt, dev)
            return {"attn": {"k": sds, "v": sds}}

        return SlotArrays(
            caches=[[layer(block.repeats) for _ in block.layers]
                    for block in self.cfg.blocks],
            tokens=LeafSpec((ps,), torch.int32, dev),
            position=LeafSpec((), torch.int32, dev),
            last_token=LeafSpec((), torch.int32, dev),
            rng=LeafSpec((2,), torch.int64, self.state.rng.device),
            temperature=LeafSpec((), torch.float32, dev),
            top_k=LeafSpec((), torch.int32, dev))

    # -- speculative tier surface -------------------------------------------
    @property
    def supports_wide_verify(self) -> bool:
        return False                 # single-token decode program only

    def _force_slot_token(self, slot: int, token: int):
        """Overwrite the token a decode step just emitted for ``slot``
        (teacher-forcing: the next step consumes ``token`` instead)."""
        s = self.state
        s.tokens[slot, (s.positions[slot] - 1).long()] = token
        s.last_token[slot] = token

    def rollback_slot(self, slot: int, drafted: int, accepted: int,
                      commit_token: int | None = None):
        """The dense engine's contract: stale page contents past the
        rewound position stay behind but are invisible (the attend mask
        cuts at ``position``) and are rewritten in place."""
        s = self.state
        p0 = int(s.positions[slot]) - drafted
        assert p0 >= 0, (slot, drafted)
        if commit_token is None:
            new_pos = p0
            s.last_token[slot] = s.tokens[slot, max(p0 - 1, 0)]
        else:
            assert 0 <= accepted <= drafted
            new_pos = p0 + accepted + 1
            s.tokens[slot, new_pos - 1] = commit_token
            s.last_token[slot] = commit_token
        s.positions[slot] = new_pos

    def check(self):
        """Engine-level conservation audit: allocator invariants (with
        the prefix cache's ownership and refcount auditor), the page
        ledger (used == row-private + cache-held), and exact refcounts
        against the live rows' shared chains."""
        self.allocator.check()
        if not set(self._shared) <= set(self.requests):
            raise RuntimeError(
                f"shared-chain rows without live requests: "
                f"{sorted(set(self._shared) - set(self.requests))}")
        private = sum(len(self._row_pages(r)) - len(self._shared.get(r, ()))
                      for r in self.requests)
        held = self.prefix_cache.pages_held \
            if self.prefix_cache is not None else 0
        if self.allocator.used_pages != private + held:
            raise RuntimeError(
                f"page ledger broken: used={self.allocator.used_pages} != "
                f"private={private} + cache-held={held}")
        if self.prefix_cache is not None:
            self.prefix_cache.check(self._shared.values())


# ---------------------------------------------------------------------------
# step functions (the engine's shared programs)
# ---------------------------------------------------------------------------

def _weave(caches, pt):
    """Attach the page table (B, NP) to every attn layer's cache dict,
    expanded (a view, no copy) to the layer's stacked (R, B, NP) so
    `attention_apply` can address the shared pools per batch row."""
    out = []
    for grp in caches:
        layers = []
        for layer in grp:
            a = dict(layer["attn"])
            R = a["k_pool"].shape[0]
            a["page_table"] = pt[None].expand((R,) + tuple(pt.shape))
            layers.append({"attn": a})
        out.append(layers)
    return out


@torch.no_grad()
def _paged_prefill(params, state: PagedEngineState, prompt, *, slot: int,
                   plen: int, cfg):
    """Prefill one row: the batch=1 forward writes straight into the
    row's reserved pages (the pools are shared)."""
    pt_row = state.page_table[slot:slot + 1]
    forward(params, {"tokens": prompt}, cfg=cfg, mode="prefill",
            caches=_weave(state.caches, pt_row))
    state.tokens[slot, :plen] = prompt[0]
    state.positions[slot] = plen
    state.last_token[slot] = prompt[0, -1]
    state.active[slot] = True
    return state


@torch.no_grad()
def _paged_suffix_prefill(params, state: PagedEngineState, suffix, *,
                          slot: int, slen: int, cfg):
    """Prefill the uncovered suffix of a warm row, one token a forward.

    Prefill-mode attention reads only the tokens it is fed, so a suffix
    that must attend to a cached prefix goes through the decode path:
    each token is forwarded at batch 1 at its absolute position, reads
    the shared pages through the row's page table (one paged-decode
    launch a layer) and writes its K/V into the row's private pages.
    The row's position must sit at the covered length (``_warm_start``);
    the logits are dropped, and the row ends as a cold prefill leaves it:
    position at plen, the last prompt token primed."""
    start = int(state.positions[slot])
    # the paged kernel reads its int32 inputs as 16-byte vectors: the
    # row's page table is copied out (a row slice need not be aligned)
    # and each token's position opens a row of 4 int32
    caches = _weave(state.caches, state.page_table[slot:slot + 1].clone())
    pos = torch.zeros((slen, 4), dtype=torch.int32, device=suffix.device)
    pos[:, 0] = torch.arange(start, start + slen, dtype=torch.int32,
                             device=suffix.device)
    for i in range(slen):
        forward(params, {"tokens": suffix[:, i:i + 1]}, cfg=cfg,
                mode="decode", caches=caches, positions=pos[i:i + 1, :1])
    state.tokens[slot, start:start + slen] = suffix[0]
    state.positions[slot] = start + slen
    state.last_token[slot] = suffix[0, -1]
    state.active[slot] = True
    return state


@torch.no_grad()
def _paged_decode_step(params, state: PagedEngineState, *, cfg):
    """One decode step for every row.

    Inactive rows decode on garbage, but their page-table rows are
    swapped to -1 for the step, so their pool writes drop and their
    attends see only dead pages (exactly-0 attention)."""
    active = state.active
    pt_eff = torch.where(active[:, None], state.page_table,
                         torch.full_like(state.page_table, -1))
    pos = state.positions[:, None]
    logits = forward(params, {"tokens": state.last_token[:, None]},
                     cfg=cfg, mode="decode",
                     caches=_weave(state.caches, pt_eff), positions=pos)
    toks, state.rng = sample(logits[:, 0], state.rng, cfg,
                             temperature=state.temperature,
                             top_k=state.top_k)
    toks = torch.where(active, toks, torch.zeros_like(toks))
    at = pos.clamp(max=state.tokens.shape[1] - 1).long()
    old = torch.gather(state.tokens, 1, at)
    state.tokens.scatter_(1, at, torch.where(active[:, None], toks[:, None],
                                             old))
    state.positions += active.to(state.positions.dtype)
    state.last_token.copy_(torch.where(active, toks, state.last_token))
    state.step_count += 1
    return state, toks
