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

A request moves between engines on wire version 2 (``extract_slot`` /
``inject_slot``): only its live pages travel, position-ordered and free
of this engine's pool indices, so the destination's pool may differ in
size, occupancy and seed as long as the page size and the program
geometry match (the page-level contract).  The speculative surface
(``rollback_slot``, ``_force_slot_token``, ``add_request(committed=)``)
follows the dense engine's.  The prefix cache (``prefix_cache=True``,
suffix prefill, warm start, donation, pre-warm, and with it the v3
suffix-only wire) is a later slice (ROADMAP Queue 1 item 2).
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
                 prefix_cache: bool = False):
        if prefix_cache:
            raise NotImplementedError(
                "PagedEngine(prefix_cache=True) is not ported yet: ROADMAP "
                "Queue 1 item 2 (prefix cache)")
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
            })
        self._decode_fn = self._programs.fns["decode"]
        self._prefill_fn = self._programs.fns["prefill"]

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

    def can_admit(self, need_tokens: int) -> bool:
        return (bool(self.free_slots)
                and need_tokens <= self.max_len
                and self._pages_for(need_tokens)
                <= self.allocator.free_pages)

    def admissible(self, need_tokens: int) -> bool:
        return (need_tokens <= self.max_len
                and self._pages_for(need_tokens) <= self.allocator.total)

    @property
    def free_token_budget(self) -> int:
        if not self.free_slots:
            return 0
        return self.allocator.free_pages * self.page_size

    # -- request lifecycle --------------------------------------------------
    def _row_pages(self, row: int) -> list[int]:
        pt = self.state.page_table[row].cpu().tolist()
        return [p for p in pt if p >= 0]

    def add_request(self, req: Request, *,
                    committed: list[int] | None = None) -> bool:
        """Admit iff a decode row is free AND the reservation fits the
        free page budget -- reserving up front means an admitted request
        can never deadlock mid-decode waiting for pages.

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
        check_domain(plen)               # refuse before any page moves
        pages = self.allocator.alloc(self._pages_for(need), req.rid)
        if pages is None:
            return False
        row = free[0]
        req.slot = row
        self.requests[row] = req
        if committed:
            req.output[:] = list(committed)
        pt_row = np.full((self.np_pages,), -1, np.int32)
        pt_row[:len(pages)] = pages
        s = self.state
        s.page_table[row] = torch.from_numpy(pt_row).to(self.device)
        s.temperature[row] = req.temperature
        s.top_k[row] = req.top_k
        prompt = torch.from_numpy(prefix).to(self.device)[None]
        self.state = self._run(
            f"prefill[plen={plen}]",
            lambda: self._prefill_fn(self.params, s, prompt, slot=row,
                                     plen=plen))
        return True

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
        if pages:
            self.allocator.free(pages)
        self.state.page_table[row] = -1
        self.state.active[row] = False

    # -- per-slot live migration (wire v2: live pages) -----------------------
    def extract_slot(self, slot: int, *, keep: bool = False,
                     suffix_only: bool = False) -> SlotSnapshot:
        """Detach one request shipping only its live pages (wire v2).

        The payload's cache leaves are (R, n_live, page_size, KV, Dh)
        where ``n_live = ceil(position / page_size)`` -- position-ordered
        pages, free of this engine's pool indices -- plus the token
        prefix trimmed to the live region.  Unless ``keep``, the row is
        retired and its pages freed."""
        if suffix_only:
            raise NotImplementedError(
                "extract_slot(suffix_only=True) (wire v3) needs the prefix "
                "cache, which is not ported yet: ROADMAP Queue 1 item 2")
        req = self.requests[slot]
        s = self.state
        pos = int(s.positions[slot])
        ps = self.page_size
        n_live = max(1, -(-pos // ps))
        live = torch.tensor(self._row_pages(slot)[:n_live], dtype=torch.long,
                            device=self.device)
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
                            step=int(s.step_count), version=2, page_size=ps)
        if not keep:
            self.retire(slot)
        return snap

    def inject_slot(self, snap: SlotSnapshot,
                    slot: int | None = None) -> Request:
        """Resume a v2 snapshot: allocate a fresh reservation of
        ``max(pages_for(prompt + max_new), n_live)`` pages here, scatter
        the live pages into it, pad the token prefix out to this
        engine's max_len and write the row's page table.  Page ids are
        engine-local, so the donor's and destination's pools never need
        to line up -- only the page size and the program geometry do.
        Every refusal raises before any page moves: ``ValueError`` for a
        snapshot this engine cannot take, ``RuntimeError`` when no row
        or page budget is free."""
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
        if snap.version == 3:
            raise ValueError(
                f"v3 (suffix-only) blob for {req.rid!r} but this "
                "engine has no prefix cache; the sender must fall "
                "back to full v2")
        a = snap.arrays
        need = len(req.prompt) + req.max_new_tokens
        n_live = self._check_pages(a)
        if need > self.max_len or n_live * self.page_size > self.max_len:
            raise ValueError(
                f"{req.rid!r} needs {need} tokens and {n_live} live pages; "
                f"this engine's max_len is {self.max_len}")
        if slot is None:
            free = self.free_slots
            if not free:
                raise RuntimeError(f"no free row to inject {req.rid!r} into")
            slot = free[0]
        if not 0 <= slot < self.rows:
            raise ValueError(f"row {slot} out of range [0, {self.rows})")
        if slot in self.requests:
            raise RuntimeError(f"row {slot} busy")
        pages = self.allocator.alloc(max(self._pages_for(need), n_live),
                                     req.rid)
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
        pt_row = np.full((self.np_pages,), -1, np.int32)
        pt_row[:len(pages)] = pages
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

    def _check_pages(self, a: SlotArrays) -> int:
        """The payload's live-page count; refuses one whose layers, page
        leaves or token prefix do not fit this engine's pools exactly
        (no broadcast, no cast)."""
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
        if tuple(a.tokens.shape) != (n_live * self.page_size,):
            raise ValueError(f"token prefix {tuple(a.tokens.shape)} != "
                             f"({n_live * self.page_size},)")
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
        """Engine-level conservation audit: allocator invariants and the
        page ledger (used == the live rows' reservations)."""
        self.allocator.check()
        private = sum(len(self._row_pages(r)) for r in self.requests)
        if self.allocator.used_pages != private:
            raise RuntimeError(
                f"page ledger broken: used={self.allocator.used_pages} != "
                f"reserved by live rows={private}")


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
