"""Speculative tier hand-off: draft on an edge engine, verify on a
cloud engine, per request (paper §3.5 lifted to the fleet layer).

The controller pairs a *draft* engine (cheap, close to the user, short
context budget) with a *verify* engine (the target tier, long context).
Each eligible request:

  1. prefills on the draft engine, then its slot is shipped ONCE to the
     verify engine -- ``Engine.extract_slot`` -> ``migration.pack_slot``
     -> compression -> ``AttestedSession`` (when both endpoints attest)
     -> ``migration.repack_slot`` re-layouts the cache rows for the
     verify engine's larger ``max_len`` -> ``Engine.inject_slot``.  The
     verify tier starts from the edge-computed prefix instead of
     re-prefilling: the MVVM migration primitive as a latency tool.
  2. the draft engine free-runs ``gamma`` tokens per round at the
     drafter's own temperature (a knob: hotter drafts trade acceptance
     for diversity of proposals);
  3. the round's tail travels to the verify tier as a token-id message
     (tiny -- the caches never move again) and is teacher-force verified
     against the target's greedy choice.  Accepted prefix + the target's
     correction token are committed; the rejected suffix bounces back as
     a verdict message and the draft slot rewinds
     (``Engine.rollback_slot``) -- stale KV rows are masked by
     ``abs_pos`` until decode rewrites them in place.
  4. validators (core/validation.py) run on the *committed* stream in
     parallel with the next draft round and can halt a request
     mid-generation.

Requests the policy gate refuses to place on the verify tier
(``daemon.placement_allowed``: sensitivity x attestation), non-greedy
requests, and requests that do not fit either tier's context budget fall
back to local-only drafting: they decode to completion on the draft
engine and never leave it.

Verify modes
  * ``stepwise`` (default): teacher-forces the verify engine's own
    decode program, so committed output is bit-exactly what a
    pure run on the verify engine would produce -- the acceptance-
    equivalence contract the tests assert.  Token equality assumes the
    draft runs the SAME weights as the target.
  * ``wide``: scores the whole tail in ONE multi-query forward pass
    (``Engine.verify_slots``) -- the paper's one-wide-matmul fast path.
    Its window runs other matmul shapes, and the plain multi-query
    attention instead of the decode kernel, so greedy choices on
    knife-edge bf16 logits can deviate from a pure decode run
    (production speculative-decoding stacks share this numerics
    property).
  * ``distribution``: the cross-model-tier mode.  A draft tier with
    *distinct weights* (an int8 or small-model quality tier) can never
    match the target token-for-token on purpose; instead the drafter
    ships each proposal's full sampling distribution q alongside the
    token ids (``Engine.step_probs``) and the verify engine runs the
    standard speculative-sampling accept/reject (Leviathan et al.)
    against its own distributions p: accept with probability
    min(1, p/q), resample the cut position from max(p - q, 0).  The
    committed stream is then distributed exactly as a pure run of the
    verify engine -- for greedy requests (one-hot p, q) this reduces
    to argmax agreement with the target correction spliced in.
    Non-greedy requests may speculate in this mode (the rule is
    temperature-correct); q rows dominate the round message bytes --
    the bandwidth price of distribution-level acceptance.

The port's copy of the JAX package's ``fleet.speculative``.  The
accept/reject randomness of the distribution mode is a CPU
``torch.Generator`` seeded from ``accept_seed``: each round takes one
draw of it and seeds the round's generator with it, where the JAX
controller splits its key (the engine then derives a generator per slot,
as for ``fold_in``).  Sampled verdicts match the JAX package in
distribution, greedy ones exactly.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import compression
from repro_torch.core.channel import AttestedSession
from repro_torch.core.migration import pack_slot
from repro_torch.core.msgpack_subset import packb, unpackb
from repro_torch.core.validation import ValidationFramework
from repro_torch.fleet.balancer import wire_slot
from repro_torch.fleet.lifecycle import RequestState
from repro_torch.fleet.router import Router
from repro_torch.fleet.telemetry import MigrationRecord
from repro_torch.serving.engine import request_from_dict, request_to_dict


@dataclass
class SpecTierStats:
    """Counters the benchmark and the CLI report."""
    requests: int = 0                # requests running draft/verify
    local_fallbacks: int = 0         # requests kept local-only
    rounds: int = 0                  # batched verify passes executed
    proposed: int = 0                # draft tokens offered for verification
    accepted: int = 0                # draft tokens the target accepted
    corrections: int = 0             # rounds cut short by a rejection
    handoffs: int = 0                # slot snapshots shipped
    handoff_bytes: int = 0           # compressed slot wire bytes
    handoff_wire_s: float = 0.0      # sim-clock time of slot transfers
    round_msg_bytes: int = 0         # draft-tail + verdict message bytes
    interventions: int = 0           # validator halts

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.proposed, 1)

    def summary(self) -> dict:
        return {
            "requests": self.requests,
            "local_fallbacks": self.local_fallbacks,
            "rounds": self.rounds,
            "proposed": self.proposed,
            "accepted": self.accepted,
            "acceptance_rate": round(self.acceptance_rate, 4),
            "corrections": self.corrections,
            "handoffs": self.handoffs,
            "handoff_bytes": self.handoff_bytes,
            "handoff_wire_s": round(self.handoff_wire_s, 6),
            "round_msg_bytes": self.round_msg_bytes,
            "interventions": self.interventions,
        }


@dataclass
class _SpecReq:
    """Fleet-side view of one speculative request."""
    req: object                      # the draft engine's Request object
    replica_slot: int                # slot on the verify engine
    committed: int = 0               # committed tokens (prefix of output)
    # distribution mode: the drafter's sampling distribution for each
    # uncommitted tail token (rows of (padded_vocab,) float32) -- the q
    # of the accept/reject rule; cleared every verify round
    qrows: list = field(default_factory=list)


class SpeculativeTierController:
    """Drives one draft/verify engine pair inside a fleet.

    The fleet step loop hands the pair's engines to this controller
    instead of stepping them directly: ``step()`` advances the draft
    engine one decode step (drafting for speculative slots, plain decode
    for local-fallback slots) and, whenever a slot's tail reaches
    ``gamma`` (or the request's remaining budget), runs a verify round
    for every due slot at once."""

    def __init__(self, draft, verify, *, fabric, whitelist, measurement,
                 router: Router | None = None, telemetry=None,
                 fleet=None, clock=None,
                 gamma: int = 4, drafter_temperature: float = 0.0,
                 drafter_top_k: int = 0, verify_mode: str = "stepwise",
                 validators=None, compression_level: int = 3,
                 accept_seed: int = 0):
        assert verify_mode in ("stepwise", "wide", "distribution"), \
            verify_mode
        assert gamma >= 1, gamma
        assert draft.name != verify.name
        if verify_mode == "distribution":
            # q and p must live over one (padded) vocabulary: tiers may
            # differ in depth/width but must share the tokenizer
            assert draft.engine.cfg.padded_vocab \
                == verify.engine.cfg.padded_vocab, \
                "distribution verify needs a shared (padded) vocab"
        if verify_mode == "wide":
            eng = verify.engine
            rings_ok = all(
                ls.mixer != "local"
                or min(ls.window, eng.max_len) >= gamma + 1
                for b in eng.cfg.blocks for ls in b.layers)
            if not (eng.supports_wide_verify and rings_ok):
                raise ValueError(
                    "verify_mode='wide' needs cache-attention mixers "
                    "only, with every local ring >= gamma+1 rows "
                    "(recurrent mixers step one token at a time); use "
                    "verify_mode='stepwise'")
        self.draft, self.verify = draft, verify
        self.router = router or Router()
        self.telemetry = telemetry
        self.fleet = fleet               # lifecycle transitions (optional)
        self._clock = clock or time.perf_counter
        self.gamma = gamma
        self.drafter_temperature = drafter_temperature
        self.drafter_top_k = drafter_top_k
        self.verify_mode = verify_mode
        self.validation = ValidationFramework(validators) \
            if validators else None
        self.compression_level = compression_level
        self.measurement = measurement
        # pinned circuit: the tier pair is co-provisioned, so its wire
        # reads the live pair-level condition but not endpoint uplinks
        # (an edge uplink outage reroutes clients, it does not sever the
        # established draft<->verify interconnect)
        self.link = fabric.pair_link(draft.name, verify.name)
        self.session = None
        if draft.attester is not None and verify.attester is not None:
            self.session = AttestedSession(draft.attester, verify.attester,
                                           self.link, whitelist)
        self.stats = SpecTierStats()
        self._spec: dict[str, _SpecReq] = {}     # rid -> speculative state
        self._local: set[str] = set()            # local-fallback rids
        # rid -> packed committed-prefix snapshot, refreshed after every
        # verify round (the fleet balancer's shadow sync skips tier-
        # paired engines because a draft slot's output holds uncommitted
        # tokens mid-round; right after a round it is exactly the
        # committed stream, so the controller shadows it here instead)
        self._shadow: dict[str, bytes] = {}
        self._dissolved = False
        # acceptance/resample randomness for distribution verify: its
        # own seeded stream (slot rngs drive the engines' sampling; the
        # accept/reject coin must not perturb them)
        self._accept_rng = torch.Generator().manual_seed(accept_seed)

    # -- wire helpers --------------------------------------------------------
    def _send(self, payload: bytes) -> bytes:
        if self.session is not None:
            return self.session.transfer(payload,
                                         aad=self.measurement.encode())
        return self.link.send(payload)

    # -- admission -----------------------------------------------------------
    def eligible(self, req) -> str | None:
        """None when the request may speculate; else the fallback reason."""
        if self._dissolved or not self.verify.healthy:
            return "verify tier gone"
        if not self.link.cond.up:
            return "pair wire down"
        if req.temperature != 0.0 and self.verify_mode != "distribution":
            # token-equality acceptance cannot re-weight sampled drafts;
            # the distribution mode's accept/reject rule can
            return "non-greedy request (drafts cannot be re-weighted)"
        if not self.router.eligible(req.sensitivity, self.verify):
            return (f"policy: {req.sensitivity} data not placeable on "
                    f"{self.verify.name}")
        if not self.verify.engine.free_slots:
            return "no free replica slot on the verify engine"
        need = len(req.prompt) + req.max_new_tokens
        if self.verify_mode == "wide":
            need += self.gamma
        elif self.verify_mode == "distribution":
            need += self.gamma + 1   # scoring advances one bonus row
        if need > self.verify.engine.max_len:
            return (f"request needs {need} rows > verify max_len "
                    f"{self.verify.engine.max_len}")
        return None

    def attach(self, req) -> str:
        """Adopt a request just placed on the draft engine.

        Returns "spec" after a successful slot hand-off to the verify
        tier, "local" when the request stays draft-engine-only."""
        reason = self.eligible(req)
        if reason is not None:
            self._local.add(req.rid)
            self.stats.local_fallbacks += 1
            return "local"
        # hand-off BEFORE the drafter policy override: the replica must
        # keep the request's own (greedy) sampling state
        lossy = self.verify_mode == "distribution"
        clock0 = self.link.clock()
        if lossy:
            # distinct weights: the draft engine's cache rows are
            # untranslatable on the verify tier, so only the request
            # (prompt + committed stream, empty at attach) travels and
            # the verify engine re-prefills with its OWN weights -- the
            # same lossy hand-off rule every cross-tier move obeys
            wire = compression.compress(
                packb(request_to_dict(req)),
                level=self.compression_level)
            received = self._send(wire)
            meta = unpackb(compression.decompress(received))
            replica = request_from_dict(meta)
            replica.done, replica.slot = False, -1
            placed = self.verify.engine.add_request(
                replica, committed=list(req.output))
            assert placed, "eligible() guaranteed a free replica slot"
            wire_bytes, step = len(wire), 0
        else:
            snap = self.draft.engine.extract_slot(req.slot, keep=True)
            snap2, wire_bytes = wire_slot(
                snap, self.verify.engine, link=self.link,
                session=self.session, aad=self.measurement.encode(),
                compression_level=self.compression_level)
            replica = self.verify.engine.inject_slot(snap2)
            step = snap.step
        self.stats.handoff_wire_s += self.link.clock() - clock0
        self.stats.handoffs += 1
        self.stats.handoff_bytes += wire_bytes
        self.stats.requests += 1
        if self.telemetry is not None:
            self.telemetry.record_migration(MigrationRecord(
                rid=req.rid, src=self.draft.name, dst=self.verify.name,
                reason="speculative", step=step,
                wire_bytes=wire_bytes, lossy=lossy))
            if self.telemetry.tracer is not None:
                # the replica hand-off is a copy, not a move: it lands
                # as an instantaneous hop (record_migration above); the
                # pair facts annotate the request's open span
                self.telemetry.tracer.annotate(
                    req.rid, verify_mode=self.verify_mode,
                    spec_pair=f"{self.draft.name}->{self.verify.name}")
        self._set_policy(self.draft.engine, req.slot,
                         self.drafter_temperature, self.drafter_top_k)
        self._spec[req.rid] = _SpecReq(req=req, replica_slot=replica.slot)
        return "spec"

    @staticmethod
    def _set_policy(engine, slot: int, temperature: float, top_k: int):
        engine.state.temperature[slot] = temperature
        engine.state.top_k[slot] = top_k

    # -- the per-fleet-step advance ------------------------------------------
    def step(self) -> dict[str, int]:
        """One draft decode step for the pair + verify rounds as tails
        fill.  Returns {rid: last token committed this step}."""
        emitted: dict[str, int] = {}
        if not self.draft.healthy or not self.draft.engine.requests:
            return emitted
        t0 = self._clock()
        if self.verify_mode == "distribution":
            # the drafter must remember the law each proposal was drawn
            # from: q rows ride to the verifier with the token ids
            out, probs = self.draft.engine.step_probs(auto_retire=False)
            for st in self._spec.values():
                pending = len(st.req.output) - st.committed
                if st.req.rid in out and len(st.qrows) < pending:
                    st.qrows.append(
                        np.asarray(probs[st.req.slot], np.float32))
        else:
            out = self.draft.engine.step(auto_retire=False)
        dt = self._clock() - t0
        # every non-speculative slot decodes plainly here: local
        # fallbacks, and requests the balancer re-placed onto the draft
        # engine (failover/drain targets) that never went through attach
        n_local = 0
        for slot, req in list(self.draft.engine.requests.items()):
            if req.rid in self._spec:
                continue
            if req.rid in out:
                emitted[req.rid] = out[req.rid]
                n_local += 1
            if len(req.output) >= req.max_new_tokens:
                req.done = True
                self._local.discard(req.rid)
                self.draft.engine.retire(slot)
        if self.telemetry is not None:
            self.telemetry.record_step(self.draft.name, n_local, dt)

        # speculative slots: collect tails that reached their round size
        due: dict[int, str] = {}     # replica slot -> rid
        for rid, st in self._spec.items():
            pending = len(st.req.output) - st.committed
            target = min(self.gamma,
                         st.req.max_new_tokens - st.committed)
            if pending >= target > 0:
                due[st.replica_slot] = rid
        if due:
            emitted.update(self._verify_round(due))
        return emitted

    def _verify_round(self, due: dict[int, str]) -> dict[str, int]:
        emitted: dict[str, int] = {}
        tails = {slot: self._spec[rid].req.output[self._spec[rid].committed:]
                 for slot, rid in due.items()}
        # the tails travel to the verify tier as token ids (the caches
        # never move again after the hand-off)...
        payload = {"slots": [[s, list(map(int, t))]
                             for s, t in sorted(tails.items())]}
        qstacks = None
        if self.verify_mode == "distribution":
            # ...with the drafter's proposal distributions riding along:
            # the verifier's accept/reject rule needs q, and the wire
            # honestly pays for it (float32 rows dominate the message)
            qstacks = {slot: np.stack(self._spec[rid].qrows)
                       for slot, rid in due.items()}
            payload["q"] = {str(s): q.tobytes()
                            for s, q in sorted(qstacks.items())}
        msg = packb(payload)
        self._send(msg)
        for rid in due.values():
            self._ticket(rid, RequestState.VERIFYING,
                         reason=f"{len(tails[self._spec[rid].replica_slot])}"
                                " drafted tokens due")
        t0 = self._clock()
        if self.verify_mode == "wide":
            results = self.verify.engine.verify_slots(tails,
                                                      width=self.gamma)
        elif self.verify_mode == "distribution":
            round_rng = torch.Generator().manual_seed(int(torch.randint(
                0, 1 << 62, (1,), generator=self._accept_rng)))
            results = self.verify.engine.verify_slots_distribution(
                tails, qstacks, rng=round_rng)
        else:
            results = self.verify.engine.verify_slots_stepwise(tails)
        dt = self._clock() - t0
        # ...and the rejected suffix bounces back as a verdict message
        verdict = packb({"verdicts": [
            [s, results[s][0], results[s][1]] for s in sorted(results)]})
        self._send(verdict)
        self.stats.round_msg_bytes += len(msg) + len(verdict)
        self.stats.rounds += 1       # one batched pass, however many slots

        n_committed = 0
        for slot, rid in due.items():
            st = self._spec[rid]
            req = st.req
            tail = tails[slot]
            n_acc, correction = results[slot]
            self.stats.proposed += len(tail)
            self.stats.accepted += n_acc
            commit = list(tail[:n_acc])
            if correction is not None:
                commit.append(correction)
                self.stats.corrections += 1
                self.draft.engine.rollback_slot(req.slot, len(tail),
                                                n_acc, correction)
            req.output[:] = req.output[:st.committed] + commit
            st.committed += len(commit)
            st.qrows = []            # next round drafts a fresh tail
            n_committed += len(commit)
            if commit:
                emitted[rid] = commit[-1]
            if self.validation is not None and self._intervene(st):
                continue
            if st.committed >= req.max_new_tokens:
                self._finish(rid)    # stays VERIFYING; the fleet's
                continue             # retire loop transitions it DONE
            self._ticket(rid, RequestState.DRAFTING,
                         reason=f"{n_acc}/{len(tail)} accepted")
            self._checkpoint(st)
        if self.telemetry is not None:
            self.telemetry.record_step(self.verify.name, n_committed, dt)
        return emitted

    def _checkpoint(self, st: _SpecReq):
        """Shadow the committed prefix.  Right after a verify round the
        draft slot holds exactly the committed stream (any rejected
        suffix was rolled back), so this snapshot can resume the request
        from its last committed token if the draft engine fail-stops --
        previously a draft death restarted every speculative request
        from its prompt.  The drafter's sampling override is swapped for
        the request's own policy so a failover resume decodes as the
        request asked, not as the drafter was tuned."""
        req = st.req
        if req.slot not in self.draft.engine.requests:
            return
        snap = self.draft.engine.extract_slot(req.slot, keep=True)
        snap.arrays = dataclasses.replace(
            snap.arrays,
            temperature=torch.tensor(req.temperature, dtype=torch.float32,
                                     device=snap.arrays.temperature.device),
            top_k=torch.tensor(req.top_k, dtype=torch.int32,
                               device=snap.arrays.top_k.device))
        self._shadow[req.rid] = pack_slot(snap)

    def _ticket(self, rid: str, state, *, reason: str = ""):
        """Lifecycle transition on the shared audit log (no-op when the
        controller runs outside a fleet)."""
        if self.fleet is not None:
            engine = self.verify.name if state is RequestState.VERIFYING \
                else self.draft.name
            self.fleet.ticket_transition(rid, state, reason=reason,
                                         engine=engine)

    def _intervene(self, st: _SpecReq) -> bool:
        """Validators run on the *committed* stream only: an accepted
        token can still be harmful, and this is the paper's mid-stream
        halt (§3.5) at round granularity."""
        report = self.validation.validate_post_hoc(st.req.output)
        if not report.intervened:
            return False
        st.req.output[:] = st.req.output[:max(report.halt_position, 0)]
        st.committed = len(st.req.output)
        self.stats.interventions += 1
        st.req.done = True
        self._ticket(st.req.rid, RequestState.HALTED,
                     reason=f"validator halt at {report.halt_position}")
        self._finish(st.req.rid, retired_done=True)
        return True

    def _finish(self, rid: str, *, retired_done: bool = False):
        st = self._spec.pop(rid)
        self._shadow.pop(rid, None)
        if not retired_done:
            st.req.done = True
        if st.req.slot in self.draft.engine.requests:
            self.draft.engine.retire(st.req.slot)
        if st.replica_slot in self.verify.engine.requests:
            self.verify.engine.retire(st.replica_slot)

    # -- lifecycle hooks -------------------------------------------------------
    def release(self, rid: str) -> bool:
        """Free a speculative request's slots (cancellation): the draft
        slot and the verify replica are retired, the uncommitted tail is
        discarded.  Returns False for requests this pair never attached
        (local fallbacks keep their plain slot for the caller to free)."""
        self._local.discard(rid)
        self._shadow.pop(rid, None)
        st = self._spec.pop(rid, None)
        if st is None:
            return False
        if self.draft.engine.requests.get(st.req.slot) is st.req:
            self.draft.engine.retire(st.req.slot)
        if st.replica_slot in self.verify.engine.requests:
            self.verify.engine.retire(st.replica_slot)
        return True

    def _fall_back_to_local(self, rid: str, st: _SpecReq):
        """Roll one speculative request back to its committed prefix and
        hand it to the draft engine as a plain local request: drop the
        uncommitted tail, restore the request's own sampling policy."""
        req = st.req
        pending = len(req.output) - st.committed
        if pending > 0 and req.slot in self.draft.engine.requests:
            self.draft.engine.rollback_slot(req.slot, pending, 0, None)
        req.output[:] = req.output[:st.committed]
        st.qrows = []
        self._set_policy(self.draft.engine, req.slot,
                         req.temperature, req.top_k)
        self._local.add(rid)
        self.stats.local_fallbacks += 1

    def release_for_park(self, rid: str) -> bool:
        """Detach one speculative request so preemption can park its
        slot (the ROADMAP lifecycle gap): roll the uncommitted draft
        tail back to the committed prefix, restore the request's own
        sampling policy, and dissolve the replica slot on the verify
        engine.  The slot then packs like any plain victim -- only
        committed tokens survive the park.  Returns False for requests
        this pair never attached."""
        st = self._spec.pop(rid, None)
        self._shadow.pop(rid, None)
        if st is None:
            return False
        req = st.req
        pending = len(req.output) - st.committed
        if pending > 0 and req.slot in self.draft.engine.requests:
            self.draft.engine.rollback_slot(req.slot, pending, 0, None)
        req.output[:] = req.output[:st.committed]
        self._set_policy(self.draft.engine, req.slot,
                         req.temperature, req.top_k)
        if st.replica_slot in self.verify.engine.requests:
            self.verify.engine.retire(st.replica_slot)
        return True

    def dissolve(self):
        """Planned pair dissolution (drain/rebalance of a tier-paired
        engine): every speculative request falls back to local-only
        drafting; replica slots on the verify engine are freed.  Unlike
        ``on_engine_failure`` both engines stay healthy and rejoin the
        routable fleet."""
        if self._dissolved:
            return
        self._dissolved = True
        for rid, st in list(self._spec.items()):
            self._fall_back_to_local(rid, st)
            if st.replica_slot in self.verify.engine.requests:
                self.verify.engine.retire(st.replica_slot)
        self._spec.clear()
        self._shadow.clear()     # live again on a balancer-shadowed engine

    # -- membership events ---------------------------------------------------
    def on_engine_failure(self, name: str):
        """A pair member fail-stopped.  Verify died: speculative slots
        drop their uncommitted tails and continue local-only on the
        draft engine.  Draft died: replica slots are freed and the
        per-round shadow checkpoints are handed to the balancer, so the
        fleet's failover path resumes each covered request from its last
        committed token -- only requests that never survived a verify
        round restart from their prompts."""
        if self._dissolved:
            return
        self._dissolved = True
        if name == self.verify.name:
            for rid, st in list(self._spec.items()):
                self._fall_back_to_local(rid, st)
        else:                                   # draft died
            for st in self._spec.values():
                if st.replica_slot in self.verify.engine.requests:
                    self.verify.engine.retire(st.replica_slot)
            if self.fleet is not None and self._shadow:
                # seed the balancer's shadow store (it skips tier-paired
                # engines during regular sync): ``Rebalancer.on_failure``
                # re-places these exactly like any dense failover
                store = self.fleet.balancer.shadow.setdefault(
                    self.draft.name, {})
                for rid, blob in self._shadow.items():
                    store.setdefault(rid, blob)
            self._local.clear()     # uncovered rids restart from prompt
        self._spec.clear()
        self._shadow.clear()
