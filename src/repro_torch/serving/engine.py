"""Serving engine: slot-based continuous batching over a dense KV grid.

The engine owns a fixed number of request *slots* (the batch dimension
of the decode step).  Requests attach to free slots, prefill fills the
slot's cache rows, and every ``step()`` advances all active slots one
token.  All device state lives in one ``EngineState``.  The speculative
surface (``step_probs``, the three ``verify_slots*`` modes and
``rollback_slot``) is the draft and verify side of the paper's
speculative execution.

Prefill runs the hand-written flash-attention kernel (attention
models) or the ``rwkv6_scan`` kernel (rwkv models); every one-token
decode step of an attention model runs the dense ``decode_attention``
kernel over the caches in place, and an rwkv model steps its recurrence
in plain torch; a wide verify window (several queries per slot) runs
the plain ``decode_attend``, as the JAX package leaves that window to
XLA.

Where the JAX package returns a new state from each jitted step, the
port updates the state's tensors in place, and masks inactive slots'
cache writes inside the forward (``cache["write"]``) instead of copying
every cache back afterwards.  A request starts from the zero recurrent
state: ``add_request`` clears the slot's rwkv caches before its prefill
(the JAX engine starts from whatever the slot's last request left).
The migration surface (``extract_slot``, ``inject_slot``,
``slot_like``) moves one slot's cache rows (attention KV or recurrent
state alike), tokens, position, RNG and policy as a ``SlotSnapshot``
(wire version 1, ``core.migration``).  On models with recurrent mixers
the verify modes and ``rollback_slot`` are a later slice (ROADMAP
Queue 1 item 7).  This module also carries the ``Request`` record, its
wire form and the slot snapshot types, which ``serving.paged``
imports.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import leaves, register_node, spec_of, tree_map
from repro_torch.device import resolve
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ops import check_domain
from repro_torch.models.model import forward, make_cache, vocab_mask_logits
from repro_torch.serving.program_cache import get_programs
from repro_torch.serving.sampling import policy_probs, rng_state, sample

_MIX = 0x9E3779B97F4A7C15        # golden-ratio multiplier (splitmix64)
_MASK63 = (1 << 63) - 1


@dataclass
class Request:
    rid: str
    prompt: np.ndarray
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    sensitivity: str = "public"      # public | personal | confidential
    priority: int = 0                # higher dispatches first / preempts
    deadline: Optional[float] = None  # absolute fleet-clock expiry
    quality_floor: float = 0.0       # min tier quality this request accepts
    tenant: str = ""                 # prefix-cache namespace ("" = default)
    done: bool = False
    output: list = field(default_factory=list)
    slot: int = -1


def request_to_dict(req: Request) -> dict:
    """Wire form of request metadata (workspace / slot snapshots)."""
    return {
        "rid": req.rid, "prompt": np.asarray(req.prompt).tolist(),
        "max_new_tokens": req.max_new_tokens,
        "temperature": req.temperature, "top_k": req.top_k,
        "sensitivity": req.sensitivity, "priority": req.priority,
        "deadline": req.deadline, "quality_floor": req.quality_floor,
        "tenant": req.tenant,
        "output": list(req.output),
        "slot": req.slot, "done": req.done,
    }


def request_from_dict(d: dict) -> Request:
    req = Request(rid=d["rid"], prompt=np.asarray(d["prompt"]),
                  max_new_tokens=d["max_new_tokens"],
                  temperature=d["temperature"], top_k=d["top_k"],
                  sensitivity=d["sensitivity"],
                  priority=d.get("priority", 0),
                  deadline=d.get("deadline"),
                  quality_floor=d.get("quality_floor", 0.0),
                  tenant=d.get("tenant", ""))
    req.output = list(d["output"])
    req.slot = d["slot"]
    req.done = d["done"]
    return req


@register_node
@dataclass
class EngineState:
    """Everything the decode loop carries across steps (the workspace).
    Tensors live on the engine's device and are updated in place, except
    ``rng``: (B, 2) int64 ``(seed, counter)`` pairs on the CPU (see
    ``serving.sampling``)."""
    caches: list                     # [group][layer] {"attn"|"rwkv": {...}}
    tokens: torch.Tensor             # (B, max_len) int32 prompt + generated
    positions: torch.Tensor          # (B,) int32 next position to write
    last_token: torch.Tensor         # (B,) int32 most recent token per slot
    active: torch.Tensor             # (B,) bool slot in use
    rng: torch.Tensor                # (B, 2) int64, CPU
    step_count: int                  # total decode steps executed
    temperature: torch.Tensor        # (B,) float32 per-slot temperature
    top_k: torch.Tensor              # (B,) int32 per-slot top-k (0 = all)


@register_node
@dataclass
class SlotArrays:
    """One slot's share of an engine state (batch dim sliced away).
    Tensors are copies on the engine's device, except ``rng``: the
    slot's ``(seed, counter)`` pair, (2,) int64 on the CPU."""
    caches: list                     # per-leaf (R, ...) cache rows
    tokens: torch.Tensor             # (max_len,) or (n_live * page_size,)
    position: torch.Tensor           # ()
    last_token: torch.Tensor         # ()
    rng: torch.Tensor                # (2,) int64, CPU
    temperature: torch.Tensor        # ()
    top_k: torch.Tensor              # ()


@dataclass
class SlotSnapshot:
    """A single in-flight request, detached from its engine: the unit of
    per-request live migration (one slot leaves a draining engine and
    resumes -- bit-identically -- in any free slot of a peer engine)."""
    arrays: SlotArrays
    request: dict                    # request_to_dict form
    config_name: str
    step: int                        # donor step_count at extraction
    trace: Optional[dict] = None     # tracer wire context (pack_slot meta)
    version: int = 1                 # wire format: 1 = dense cache rows,
    #                                  2 = live pages only (paged engine),
    #                                  3 = suffix pages + prefix-chain
    #                                      hashes (shared-prefix moves)
    page_size: int = 0               # v2/v3 only: tokens per KV page
    prefix: Optional[dict] = None    # v3 only: {"tenant", "chain", "len"}

    @property
    def rid(self) -> str:
        return self.request["rid"]

    @property
    def sensitivity(self) -> str:
        return self.request["sensitivity"]

    @property
    def remaining_tokens(self) -> int:
        return self.request["max_new_tokens"] - len(self.request["output"])


def _slot_generator(rng: torch.Generator, slot: int) -> torch.Generator:
    """A per-slot CPU generator from one draw of ``rng`` mixed with the
    slot index (the counterpart of ``jax.random.fold_in``)."""
    base = int(torch.randint(0, 1 << 62, (1,), generator=rng))
    gen = torch.Generator()
    gen.manual_seed((base * _MIX + slot) & _MASK63)
    return gen


class Engine:
    """Single-replica serving engine for one model on one card."""

    paged = False                    # dense (slots, max_len) KV grid
    page_size = 0                    # >0 only on paged engines

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 256, seed: int = 0, device="cuda"):
        self.device = resolve(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params on {params['embed'].device}, engine "
                             f"on {self.device}")
        self.cfg = cfg
        self.params = params
        mixers = {ls.mixer for b in cfg.blocks for ls in b.layers}
        self._attention = bool(mixers & {"attn", "local"})
        self._recurrent = "rwkv" in mixers
        self.slots = slots
        self.max_len = max_len
        self.requests: dict[int, Request] = {}
        self.state = self._fresh_state(seed)
        # every engine of one (cfg, slots, max_len) key shares one set of
        # step callables (see serving.program_cache)
        self._programs, self.program_cache_hit = get_programs(
            "dense", cfg, None, None, slots=slots, max_len=max_len,
            build=lambda: {
                "decode": partial(_decode_step, cfg=cfg),
                "prefill": partial(_prefill, cfg=cfg),
                "verify": partial(_verify_window, cfg=cfg),
                "probs": partial(_decode_step_probs, cfg=cfg),
            })
        self._decode_fn = self._programs.fns["decode"]
        self._prefill_fn = self._programs.fns["prefill"]
        self._verify_fn = self._programs.fns["verify"]
        self._decode_probs = self._programs.fns["probs"]

    def _run(self, key: str, fn):
        self._programs.compiled.add(key)
        return fn()

    # -- state ------------------------------------------------------------
    def _fresh_state(self, seed: int) -> EngineState:
        B, dev = self.slots, self.device
        return EngineState(
            caches=make_cache(self.cfg, B, self.max_len, device=dev),
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

    # -- capacity (token-budget admission surface) -------------------------
    @property
    def free_slots(self) -> list[int]:
        return [i for i in range(self.slots) if i not in self.requests]

    def can_admit(self, need_tokens: int) -> bool:
        """True if a request needing ``need_tokens`` KV slots (prompt +
        max_new) can be admitted right now."""
        return bool(self.free_slots) and need_tokens <= self.max_len

    def admissible(self, need_tokens: int) -> bool:
        """True if such a request could ever fit on this engine."""
        return need_tokens <= self.max_len

    @property
    def free_token_budget(self) -> int:
        """KV-token headroom: a dense engine pins a full max_len row per
        request regardless of its length."""
        return len(self.free_slots) * self.max_len

    # -- request lifecycle --------------------------------------------------
    def add_request(self, req: Request, *,
                    committed: list[int] | None = None) -> bool:
        """Attach a request to a free slot and prefill it.

        ``committed`` is the lossy cross-tier restore path: the slot
        re-prefills prompt + the committed token stream (cache rows
        computed by other weights cannot move), and the committed tokens
        become the request's output prefix."""
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
        if self._attention:
            check_domain(plen)           # refuse before the slot is taken
        slot = free[0]
        req.slot = slot
        self.requests[slot] = req
        if committed:
            req.output[:] = list(committed)
        s = self.state
        s.temperature[slot] = req.temperature
        s.top_k[slot] = req.top_k
        prompt = torch.from_numpy(prefix).to(self.device)[None]
        self.state = self._run(
            f"prefill[plen={plen}]",
            lambda: self._prefill_fn(self.params, s, prompt, slot=slot,
                                     plen=plen))
        return True

    def _emit(self, toks, auto_retire: bool) -> dict[str, int]:
        toks = toks.cpu().numpy()
        emitted = {}
        for slot, req in list(self.requests.items()):
            if req.done:
                continue
            t = int(toks[slot])
            req.output.append(t)
            emitted[req.rid] = t
            if auto_retire and len(req.output) >= req.max_new_tokens:
                req.done = True
                self.retire(slot)
        return emitted

    def step(self, *, auto_retire: bool = True) -> dict[str, int]:
        """One batched decode step; returns {rid: token} emitted.

        ``auto_retire=False`` keeps slots open past ``max_new_tokens``:
        a speculative drafting tier appends *uncommitted* tokens to
        ``req.output`` and must retire or roll back explicitly after the
        verifier rules on them."""
        if not self.requests:
            return {}
        self.state, toks = self._run(
            "decode", lambda: self._decode_fn(self.params, self.state))
        return self._emit(toks, auto_retire)

    def step_probs(self, *, auto_retire: bool = True) \
            -> tuple[dict[str, int], Optional[np.ndarray]]:
        """One batched decode step that also returns, per slot, the full
        distribution the emitted token was drawn from (``(B,
        padded_vocab)`` float32 numpy; one-hot argmax for greedy slots):
        the draft side of distribution-level speculative acceptance."""
        if not self.requests:
            return {}, None
        self.state, toks, probs = self._run(
            "decode_probs",
            lambda: self._decode_probs(self.params, self.state))
        emitted = self._emit(toks, auto_retire)
        return emitted, probs.cpu().numpy()

    def retire(self, slot: int):
        self.requests.pop(slot, None)
        self.state.active[slot] = False

    # -- per-slot live migration ---------------------------------------------
    def extract_slot(self, slot: int, *, keep: bool = False) -> SlotSnapshot:
        """Detach one in-flight request as a ``SlotSnapshot``.

        The snapshot copies the slot's cache rows (KV or recurrent
        state), token row, position, sampling rng and per-slot policy --
        everything needed to resume this request bit-identically in
        *any* free slot of a compatible engine.  Unless ``keep``, the
        slot is drained (request removed, slot deactivated) as in a live
        migration's departure side; ``keep=True`` is the
        shadow-checkpoint (replica sync) form."""
        req = self.requests[slot]
        snap = SlotSnapshot(
            arrays=_slot_arrays(self.state, slot, copy=True),
            request=request_to_dict(req),
            config_name=self.cfg.name,
            step=int(self.state.step_count))
        if not keep:
            self.retire(slot)
        return snap

    def inject_slot(self, snap: SlotSnapshot,
                    slot: int | None = None) -> Request:
        """Resume a migrated request in a free slot (any index).

        The donor's slot index is irrelevant: rows are written into
        whatever slot is free here, and decode continues bit-identically
        because every piece of cross-step state rides in the snapshot.
        Every check (exact config name -- cache-row geometry must be
        identical --, max_len, wire version, a free slot in range, cache
        leaves of this engine's count, shapes and dtypes) raises
        ``ValueError`` before any state is written."""
        if snap.config_name != self.cfg.name:
            raise ValueError(f"config mismatch: {self.cfg.name} != "
                             f"{snap.config_name}")
        if snap.version != 1:
            raise ValueError(
                f"Engine.inject_slot needs a v1 (dense) snapshot, got "
                f"v{snap.version}; route paged blobs to a PagedEngine")
        a = snap.arrays
        if a.tokens.shape[-1] != self.max_len:
            raise ValueError(f"max_len mismatch: {a.tokens.shape[-1]} != "
                             f"{self.max_len}")
        if slot is None:
            free = self.free_slots
            if not free:
                raise ValueError("no free slot to inject into")
            slot = free[0]
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} out of range [0, {self.slots})")
        if slot in self.requests:
            raise ValueError(f"slot {slot} busy")
        s = self.state
        rows = _slot_arrays(s, slot, copy=False)
        if len(leaves(rows.caches)) != len(leaves(a.caches)):
            raise ValueError(f"cache leaf count {len(leaves(a.caches))} != "
                             f"{len(leaves(rows.caches))}")
        for full, row in zip(leaves(rows.caches), leaves(a.caches)):
            if full.shape != row.shape or full.dtype != row.dtype:
                raise ValueError(f"cache row {tuple(row.shape)} {row.dtype} "
                                 f"!= {tuple(full.shape)} {full.dtype}")
        for full, row in zip(leaves(rows.caches), leaves(a.caches)):
            full.copy_(row)
        s.tokens[slot] = a.tokens.to(s.tokens.device)
        s.positions[slot] = a.position.to(s.positions.device)
        s.last_token[slot] = a.last_token.to(s.last_token.device)
        s.active[slot] = True
        s.rng[slot] = a.rng.to(s.rng.device)
        s.temperature[slot] = a.temperature.to(s.temperature.device)
        s.top_k[slot] = a.top_k.to(s.top_k.device)
        req = request_from_dict(snap.request)
        req.slot = slot
        self.requests[slot] = req
        return req

    def slot_like(self) -> SlotArrays:
        """``LeafSpec``s (shape, dtype, device) of one slot's arrays: the
        template ``unpack_slot`` reads a blob against."""
        return tree_map(spec_of, _slot_arrays(self.state, 0, copy=False))

    # -- speculative verify tier --------------------------------------------
    @property
    def supports_wide_verify(self) -> bool:
        """Wide (multi-query) verify windows need every mixer to be
        cache-attention; recurrent mixers step one token at a time."""
        return (not self.cfg.cross_attention
                and not self.cfg.encoder_blocks
                and all(ls.mixer in ("attn", "local")
                        for b in self.cfg.blocks for ls in b.layers))

    def _refuse_recurrent(self, what: str):
        """The verify modes and ``rollback_slot`` rewind or teacher-force
        positions only; a recurrent state would keep the rejected drafts
        (the JAX ``rollback_slot`` leaves it so)."""
        if self._recurrent:
            raise NotImplementedError(
                f"Engine.{what} on a model with recurrent mixers "
                f"({self.cfg.name}) is not ported: ROADMAP Queue 1 item 7 "
                "(recurrent-state rollback)")

    def verify_slots(self, drafts: dict[int, list[int]], *,
                     width: int | None = None) -> dict[int, tuple[int, int]]:
        """Teacher-forced batch verification of drafted tails in ONE wide
        forward pass (gamma+1 queries per slot, each causally masked at
        its own position).  Greedy acceptance: a draft token is accepted
        iff it equals the target argmax given the accepted prefix; the
        first rejection cuts the tail and the target's own argmax there
        is committed instead.

        The wide pass's shapes differ from the one-token decode step's,
        so greedy choices on knife-edge logits can deviate from a pure
        decode run of this engine; ``verify_slots_stepwise`` is the
        bit-exact mode.  Slot state advances to the committed prefix.
        Returns {slot: (n_accepted, correction_token | None)}."""
        self._refuse_recurrent("verify_slots")
        assert drafts, "nothing to verify"
        g = width if width is not None else max(map(len, drafts.values()))
        B = self.slots
        arr = np.zeros((B, g), np.int32)
        cnt = np.zeros((B,), np.int32)
        mask = np.zeros((B,), bool)
        pos = self.state.positions.cpu().numpy()
        for slot, toks in drafts.items():
            assert slot in self.requests, f"slot {slot} not in use"
            assert 0 < len(toks) <= g, (slot, len(toks), g)
            assert pos[slot] + g + 1 <= self.max_len, \
                f"verify window overruns max_len at slot {slot}"
            arr[slot, :len(toks)] = toks
            cnt[slot] = len(toks)
            mask[slot] = True
        dev = self.device
        self.state, n_acc, commit = self._run(
            "verify_wide",
            lambda: self._verify_fn(self.params, self.state,
                                    torch.from_numpy(arr).to(dev),
                                    torch.from_numpy(cnt).to(dev),
                                    torch.from_numpy(mask).to(dev)))
        n_acc, commit = n_acc.cpu().numpy(), commit.cpu().numpy()
        return {slot: (int(n_acc[slot]),
                       None if commit[slot] < 0 else int(commit[slot]))
                for slot in drafts}

    def verify_slots_stepwise(self, drafts: dict[int, list[int]]) \
            -> dict[int, tuple[int, int]]:
        """Bit-exact verification: teacher-force the engine's OWN decode
        program over each drafted tail, so the greedy token each burst
        step emits *is* the pure-run token.  Slots that finish (first
        rejection, or tail exhausted) are deactivated for the rest of
        the burst.  Same return contract as ``verify_slots``."""
        self._refuse_recurrent("verify_slots_stepwise")
        assert drafts, "nothing to verify"
        saved_active = self.state.active.clone()
        burst = torch.zeros((self.slots,), dtype=torch.bool)
        for slot, toks in drafts.items():
            assert slot in self.requests, f"slot {slot} not in use"
            assert toks, f"empty draft tail for slot {slot}"
            burst[slot] = True
        self.state.active = burst.to(self.device) & saved_active
        results: dict[int, tuple[int, int | None]] = {}
        pending = {slot: list(toks) for slot, toks in drafts.items()}
        step = 0
        while pending:
            self.state, toks = self._decode_fn(self.params, self.state)
            toks = toks.cpu().numpy()
            for slot in list(pending):
                t = int(toks[slot])
                if t != pending[slot][step]:          # rejection: t is
                    results[slot] = (step, t)         # the correction,
                elif step + 1 == len(pending[slot]):  # already committed
                    results[slot] = (step + 1, None)
                else:
                    continue
                del pending[slot]
                self.state.active[slot] = False
            step += 1
        self.state.active = saved_active
        return results

    def verify_slots_distribution(self, drafts: dict[int, list[int]],
                                  draft_probs: dict[int, np.ndarray], *,
                                  rng: torch.Generator) \
            -> dict[int, tuple[int, int]]:
        """Distribution-level verification (Leviathan et al.) of drafted
        tails against this engine's own next-token distributions: accept
        draft token ``d_i`` with probability ``min(1, p(d_i)/q(d_i))``
        and resample the cut position from ``max(p - q, 0)``; greedy
        requests reduce to argmax agreement (one-hot p and q).

        ``draft_probs[slot]`` is the ``(len(tail), padded_vocab)`` stack
        of the drafter's ``step_probs`` rows; ``rng`` (a CPU
        ``torch.Generator``) drives acceptance and resampling, split per
        slot.  Scoring teacher-forces the drafts through the probs
        program, then the slot rewinds to its committed prefix.  A
        fully-accepted window commits only the drafts (no bonus token:
        the KV-gap rule of ``_verify_window``).  Returns {slot:
        (n_accepted, commit_token | None)}."""
        self._refuse_recurrent("verify_slots_distribution")
        assert drafts, "nothing to verify"
        saved_active = self.state.active.clone()
        positions = self.state.positions.cpu().numpy()
        burst = torch.zeros((self.slots,), dtype=torch.bool)
        for slot, toks in drafts.items():
            assert slot in self.requests, f"slot {slot} not in use"
            assert toks, f"empty draft tail for slot {slot}"
            assert len(draft_probs[slot]) == len(toks), slot
            assert int(positions[slot]) + len(toks) + 1 <= self.max_len, \
                f"scoring window overruns max_len at slot {slot}"
            burst[slot] = True
        self.state.active = burst.to(self.device) & saved_active
        p_rows: dict[int, list] = {slot: [] for slot in drafts}
        live = dict(drafts)
        step = 0
        while live:
            self.state, _, probs = self._decode_probs(self.params,
                                                      self.state)
            for slot in list(live):
                p_rows[slot].append(probs[slot])
                if step < len(live[slot]):
                    # teacher-force: the NEXT step must consume the
                    # draft token, not the engine's own sample
                    self._force_slot_token(slot, live[slot][step])
                else:                 # bonus row collected: done
                    del live[slot]
                    self.state.active[slot] = False
            step += 1
        self.state.active = saved_active

        results: dict[int, tuple[int, int | None]] = {}
        for slot in sorted(drafts):
            tail = drafts[slot]
            q = torch.as_tensor(np.asarray(draft_probs[slot], np.float32),
                                device=self.device)
            p = torch.stack(p_rows[slot])
            n_acc, nxt = kops.spec_verify(
                torch.tensor(tail, dtype=torch.int32, device=self.device),
                q, p, _slot_generator(rng, slot))
            n_acc = int(n_acc)
            if n_acc >= len(tail):
                # fully accepted: rewind past the scored bonus row only
                self.rollback_slot(slot, 1, 0, None)
                results[slot] = (len(tail), None)
            else:
                self.rollback_slot(slot, len(tail) + 1, n_acc, int(nxt))
                results[slot] = (n_acc, int(nxt))
        return results

    def _force_slot_token(self, slot: int, token: int):
        """Overwrite the token a decode step just emitted for ``slot``
        (teacher-forcing: the next step consumes ``token`` instead)."""
        s = self.state
        s.tokens[slot, (s.positions[slot] - 1).long()] = token
        s.last_token[slot] = token

    def rollback_slot(self, slot: int, drafted: int, accepted: int,
                      commit_token: int | None = None):
        """Rewind a slot's speculative tail to the verified prefix.

        Of the last ``drafted`` uncommitted tokens keep ``accepted`` and
        splice ``commit_token`` (the verifier's correction) in as the
        next committed token; ``commit_token=None`` drops the whole tail.
        Cache rows the dropped suffix wrote stay behind but are invisible
        -- their ``abs_pos`` exceeds the rewound position -- and decode
        rewrites each row in place before it becomes attendable again."""
        self._refuse_recurrent("rollback_slot")
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


# ---------------------------------------------------------------------------
# slot slicing (the migration surface)
# ---------------------------------------------------------------------------

def _slot_arrays(state: EngineState, slot: int, *, copy: bool) -> SlotArrays:
    """One slot of the batched state (a cache leaf's batch dim is axis 1,
    after the stacked repeats).  ``copy=False`` gives views into the
    state; a snapshot takes copies, since the state changes in place.
    The rng row stays on the CPU, where the state keeps it."""
    arrays = SlotArrays(caches=tree_map(lambda a: a[:, slot], state.caches),
                        tokens=state.tokens[slot],
                        position=state.positions[slot],
                        last_token=state.last_token[slot],
                        rng=state.rng[slot],
                        temperature=state.temperature[slot],
                        top_k=state.top_k[slot])
    return tree_map(torch.clone, arrays) if copy else arrays


# ---------------------------------------------------------------------------
# step functions (the engine's shared programs)
# ---------------------------------------------------------------------------

def _weave_write(caches, write):
    """Attach the (B,) write mask to every layer's cache dicts (attn or
    rwkv), expanded (a view) to the layer's stacked (R, B)."""
    def weave(c):
        c = dict(c)
        R = next(iter(c.values())).shape[0]
        c["write"] = write[None].expand(R, write.shape[0])
        return c
    return [[{kind: weave(c) for kind, c in layer.items()} for layer in grp]
            for grp in caches]


@torch.no_grad()
def _prefill(params, state: EngineState, prompt, *, slot: int, plen: int,
             cfg):
    """Prefill one slot: the batch=1 forward writes straight into the
    slot's cache rows (views of the batched caches).  The slot's
    recurrent caches are zeroed first, so the request starts from the
    zero state; stale attention rows stay hidden by ``abs_pos``."""
    sub = [[{kind: {k: a[:, slot:slot + 1] for k, a in c.items()}
             for kind, c in layer.items()}
            for layer in grp] for grp in state.caches]
    for grp in sub:
        for layer in grp:
            for a in layer.get("rwkv", {}).values():
                a.zero_()
    forward(params, {"tokens": prompt}, cfg=cfg, mode="prefill", caches=sub)
    state.tokens[slot, :plen] = prompt[0]
    state.positions[slot] = plen
    state.last_token[slot] = prompt[0, -1]
    state.active[slot] = True
    return state


def _decode_logits(params, state: EngineState, cfg):
    """The decode forward for every slot; inactive slots compute on
    garbage but their cache writes are masked out."""
    return forward(params, {"tokens": state.last_token[:, None]}, cfg=cfg,
                   mode="decode",
                   caches=_weave_write(state.caches, state.active),
                   positions=state.positions[:, None])[:, 0]


def _advance(state: EngineState, toks):
    """Only active slots advance: token row, position, last token."""
    active = state.active
    toks = torch.where(active, toks, torch.zeros_like(toks))
    at = state.positions[:, None].clamp(max=state.tokens.shape[1] - 1).long()
    old = torch.gather(state.tokens, 1, at)
    state.tokens.scatter_(1, at, torch.where(active[:, None], toks[:, None],
                                             old))
    state.positions += active.to(state.positions.dtype)
    state.last_token.copy_(torch.where(active, toks, state.last_token))
    state.step_count += 1
    return toks


@torch.no_grad()
def _decode_step(params, state: EngineState, *, cfg):
    """One decode step for every active slot.  Sampling policy is
    per-slot (temperature / top_k rows of the state)."""
    logits = _decode_logits(params, state, cfg)
    toks, state.rng = sample(logits, state.rng, cfg,
                             temperature=state.temperature,
                             top_k=state.top_k)
    return state, _advance(state, toks)


@torch.no_grad()
def _decode_step_probs(params, state: EngineState, *, cfg):
    """``_decode_step`` that also returns each slot's full sampling
    distribution (B, padded_vocab), one-hot argmax for greedy slots."""
    logits = _decode_logits(params, state, cfg)
    probs = policy_probs(logits, cfg, temperature=state.temperature,
                         top_k=state.top_k)
    toks, state.rng = sample(logits, state.rng, cfg,
                             temperature=state.temperature,
                             top_k=state.top_k)
    return state, _advance(state, toks), probs


@torch.no_grad()
def _verify_window(params, state: EngineState, drafts, counts, verify, *,
                   cfg):
    """Score g drafted tokens per slot in ONE forward pass and commit the
    greedy-accepted prefix (+ correction token on a rejection).

    drafts: (B, g) proposed tokens (row b valid up to counts[b]);
    verify: (B,) bool, the slots verifying this round.  The window's
    inputs are (last_token, d_1 .. d_g) at positions p0 .. p0+g, the
    tokens a plain decode loop would have fed.  Non-verifying slots
    compute on garbage; their cache writes are masked out."""
    B, g = drafts.shape
    W = g + 1
    inputs = torch.cat([state.last_token[:, None], drafts], dim=1)
    pos = state.positions[:, None] + torch.arange(
        W, dtype=torch.int32, device=drafts.device)[None]
    logits = forward(params, {"tokens": inputs}, cfg=cfg, mode="decode",
                     caches=_weave_write(state.caches, verify),
                     positions=pos)
    # greedy target choice, identical to sample()'s temperature-0 path
    greedy = torch.argmax(vocab_mask_logits(logits, cfg).float(),
                          -1).to(torch.int32)                     # (B, W)
    j = torch.arange(g, dtype=torch.int32, device=drafts.device)[None]
    match = (greedy[:, :g] == drafts) & (j < counts[:, None])
    n_acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    commit = torch.gather(greedy, 1, n_acc[:, None].long())[:, 0]

    # A fully-accepted window takes no bonus token: neither tier has fed
    # the window's last draft as an input yet, so advancing past it would
    # leave a hole in the KV rows at its position.
    full = n_acc == counts
    n_commit = torch.where(full, n_acc, n_acc + 1).to(torch.int32)
    last_acc = torch.gather(drafts, 1,
                            (n_acc - 1).clamp(min=0)[:, None].long())[:, 0]
    new_last = torch.where(full, last_acc, commit)

    # committed window: accepted drafts, then (on rejection) the
    # correction token, then whatever the token rows already held
    at = (state.positions[:, None] + torch.arange(
        W, device=drafts.device)[None]).clamp(max=state.tokens.shape[1] - 1)
    at = at.long()
    old_win = torch.gather(state.tokens, 1, at)
    drafts_w = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    jw = torch.arange(W, device=drafts.device)[None]
    new_win = torch.where(
        jw < n_acc[:, None], drafts_w,
        torch.where((jw == n_acc[:, None]) & ~full[:, None],
                    commit[:, None], old_win))
    state.tokens.scatter_(1, at, torch.where(verify[:, None], new_win,
                                             old_win))
    state.positions.copy_(torch.where(verify, state.positions + n_commit,
                                      state.positions))
    state.last_token.copy_(torch.where(verify, new_last, state.last_token))
    state.step_count += 1
    return state, n_acc, torch.where(full, torch.full_like(commit, -1),
                                     commit)
