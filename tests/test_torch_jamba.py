"""Tiny jamba-v0.1-52b (mamba and attention layers in one hybrid block,
the MoE FFN on every other layer) through the port, against the JAX
package on the same bridged weights: the model's layers and logits and
every cache leaf; the dense ``Engine`` (greedy tokens, the reused slot,
the refusals, the prefill domain); the migration wire (JAX blobs through
the port byte-equal, ``repack_slot``, slot and workspace moves); a sync
fleet with a live migration and a failover; capabilities and the
daemon's decisions; the serve and fleet CLIs.

Tolerances, f32.  Each layer on JAX's own input is held to
``LAYER_REL`` of its output's largest |value| (a few f32 ulps: the
reference init's stacked fan-in makes the residual stream reach 1e7).
Chained through the model (each package on its own output), those
ulps grow by a geometric mean of 1.27-1.55x a layer over the 16 layers
(single layers up to 8x), to 2.2e-5-3.5e-4 of the residual's largest
|value| after the last one; the final norm lifts the logits' error to
6.7e-5-8.7e-4 of theirs.  Those are ``chain_errors`` over weight seeds
5, 0, 1, 2, token draws 1-3 and 64 and 128 tokens (24 readings), so
logits and cache leaves are held to ``CHAIN_REL`` of their largest
|value| and the chain's growth to ``GROWTH`` a layer.
bf16: the port's bf16 logits against JAX's f32 within twice JAX's own
bf16 error against them.  Dense engines use 3 slots, never 2 (the tiny
repeat count: the JAX ``_bcast`` mask-back then masks the repeat axis,
ROADMAP Queue 3)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.configs.tiny import make_tiny as jtiny  # noqa: E402
from repro.core import attestation as jatt  # noqa: E402
from repro.core import daemon as jdaemon  # noqa: E402
from repro.core import migration as jmig  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.init import init_params as jinit  # noqa: E402
from repro.models.model import forward as jforward  # noqa: E402
from repro.models.model import make_cache as jmake_cache  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.configs.tiny import make_tiny as ttiny  # noqa: E402
from repro_torch.core import attestation as tatt  # noqa: E402
from repro_torch.core.attestation import TrustAuthority  # noqa: E402
from repro_torch.core.daemon import (DeviceProfile,  # noqa: E402
                                     PrivacyAwareDaemon)
from repro_torch.core.migration import (RNG_TAG, Migrator,  # noqa: E402
                                        pack_slot, repack_slot,
                                        unpack_slot)
from repro_torch.core.msgpack_subset import unpackb  # noqa: E402
from repro_torch.core.tree import leaves  # noqa: E402
from repro_torch.core.workspace import AgentWorkspace  # noqa: E402
from repro_torch.fleet.balancer import (ReprefillRefused,  # noqa: E402
                                        check_reprefill)
from repro_torch.launch import fleet as fleet_cli  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.init import params_from_numpy  # noqa: E402
from repro_torch.models.model import forward as tforward  # noqa: E402
from repro_torch.models.model import make_cache  # noqa: E402
from repro_torch.models.schema import tree_map  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.paged import PagedEngine  # noqa: E402
from tests import helpers  # noqa: E402
from tests.test_torch_migration import _session  # noqa: E402
from tests.torch_helpers import (as_f32, assert_conserved,  # noqa: E402
                                 fleet_record, fleet_side,
                                 greedy_agreement, to_numpy)

NAME = "jamba-v0.1-52b"
LAYER_REL = 2e-6         # one layer on JAX's input, relative to max |ref|
CHAIN_REL = 1e-3         # through the model, relative to max |ref|
GROWTH = 2.0             # the chained error's geometric growth a layer
BF16_OWN = 2.0           # bf16 vs JAX's f32: x JAX's own bf16 error
# 7 and 17 tokens: one chunk each; 64: one whole chunk
PROMPTS = [np.arange(2, 9), np.arange(40, 57), (np.arange(64) * 7) % 500]
_PAIRS = {}


def pair(dtype="float32", seed=5):
    """The tiny jamba of both packages on bridged weights: (jcfg, tcfg,
    jax params, torch params), shared within the module."""
    key = (dtype, seed)
    if key not in _PAIRS:
        jcfg = jtiny(jget(NAME)).replace(dtype=dtype)
        tcfg = ttiny(tget(NAME)).replace(dtype=dtype)
        jp = jinit(jcfg, jax.random.key(seed))
        _PAIRS[key] = (jcfg, tcfg, jp,
                       params_from_numpy(to_numpy(jp), device="cpu"))
    return _PAIRS[key]


def err(a, b) -> float:
    return float(np.abs(as_f32(a) - as_f32(b)).max())


def rel(ref, out) -> float:
    return err(ref, out) / max(1.0, float(np.abs(as_f32(ref)).max()))


def engines(slots=3, max_len=96, seed=0, dtype="float32"):
    jcfg, tcfg, jp, tp = pair(dtype)
    return (JEngine(jcfg, jp, slots=slots, max_len=max_len, seed=seed),
            Engine(tcfg, tp, slots=slots, max_len=max_len, seed=seed,
                   device="cpu"))


def serve(eng, req):
    assert eng.add_request(req)
    while not req.done:
        eng.step()
    return list(req.output)


def mamba_rows(caches, slot):
    """Every mamba leaf of ``slot``, as f32 numpy copies, by (layer,
    key)."""
    return {(li, k): as_f32(a[:, slot]).copy()
            for li, layer in enumerate(caches[0]) if "mamba" in layer
            for k, a in layer["mamba"].items() if k in ("ssm", "conv")}


# -- the model ----------------------------------------------------------------

def chain_errors(seed=5, tokens_seed=1, T=64):
    """Both packages through every layer of tiny jamba in train mode, each
    on the output of its own layer before: the error of the port's layer
    on JAX's input (local) and on its own (chained), relative to max
    |ref|, for each layer in order; and the prefill logits' error."""
    jcfg, tcfg, jp, tp = pair(seed=seed)
    tokens = np.random.default_rng(tokens_seed).integers(0, 512, (2, T))
    xj = jnp.asarray(np.asarray(jp["embed"])[tokens])
    xt = torch.from_numpy(np.array(xj))
    pos = jnp.broadcast_to(jnp.arange(T)[None], (2, T))
    tpos = torch.arange(T)[None].expand(2, T)
    local, chained = [], []
    for r in range(jcfg.blocks[0].repeats):
        for li, ls in enumerate(jcfg.blocks[0].layers):
            tl = tree_map(lambda a: a[r], tp["blocks"][0][li])
            kw = dict(cfg=tcfg, lspec=tcfg.blocks[0].layers[li],
                      mode="train", positions=tpos)
            oj, _, _ = jlayers.layer_apply(
                jax.tree.map(lambda a: a[r], jp["blocks"][0][li]), xj,
                cfg=jcfg, lspec=ls, mode="train", positions=pos)
            local.append(rel(oj, tlayers.layer_apply(
                tl, torch.from_numpy(np.array(xj)), **kw)[0]))
            xt, _ = tlayers.layer_apply(tl, xt, **kw)
            chained.append(rel(oj, xt))
            xj = oj
    tok = tokens.astype(np.int32)
    lj, _, _ = jforward(jp, {"tokens": jnp.asarray(tok)}, cfg=jcfg,
                        mode="prefill")
    lt = tforward(tp, {"tokens": torch.from_numpy(tok)}, cfg=tcfg,
                  mode="prefill")
    return local, chained, rel(lj, lt)


@pytest.mark.parametrize("seed", [5, 0, 1, 2])
def test_chained_error_grows_slowly_layer_by_layer(seed):
    """The bounds of the module docstring, on one token draw a weight
    seed: every layer local within ``LAYER_REL``, the chained error's
    geometric growth a layer within ``GROWTH``, the logits within
    ``CHAIN_REL`` (measured 1.2e-4, 5.1e-4, 2.4e-4, 8.7e-4)."""
    local, chained, logits = chain_errors(seed)
    assert max(local) < LAYER_REL, local
    growth = (chained[-1] / chained[0]) ** (1 / (len(chained) - 1))
    assert growth < GROWTH, (growth, chained)
    assert logits < CHAIN_REL, logits


def test_every_layer_matches_jax_on_its_own_inputs():
    """Both repeats of the eight-layer block (mamba with the dense MLP or
    the MoE FFN, attention with the dense MLP), each fed JAX's output of
    the layer before, in train mode over 64 tokens."""
    jcfg, tcfg, jp, tp = pair()
    tokens = np.random.default_rng(0).integers(0, 512, (2, 64))
    x = jnp.asarray(np.asarray(jp["embed"])[tokens])
    pos = jnp.broadcast_to(jnp.arange(64)[None], (2, 64))
    tpos = torch.arange(64)[None].expand(2, 64)
    kinds = set()
    for r in range(jcfg.blocks[0].repeats):
        for li, ls in enumerate(jcfg.blocks[0].layers):
            out, _, _ = jlayers.layer_apply(
                jax.tree.map(lambda a: a[r], jp["blocks"][0][li]), x,
                cfg=jcfg, lspec=ls, mode="train", positions=pos)
            got, _ = tlayers.layer_apply(
                tree_map(lambda a: a[r], tp["blocks"][0][li]),
                torch.from_numpy(np.array(x)), cfg=tcfg,
                lspec=tcfg.blocks[0].layers[li], mode="train",
                positions=tpos)
            assert rel(out, got) < LAYER_REL, (r, li, rel(out, got))
            kinds.add((ls.mixer, ls.ffn))
            x = out
    assert kinds == {("mamba", "dense"), ("mamba", "moe"),
                     ("attn", "dense")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_match_jax(dtype):
    jcfg, tcfg, jp, tp = pair(dtype)
    tokens = np.random.default_rng(1).integers(0, 512, (2, 128)).astype(
        np.int32)
    lt = tforward(tp, {"tokens": torch.from_numpy(tokens)}, cfg=tcfg,
                  mode="prefill")
    assert lt.shape == (2, 128, tcfg.padded_vocab)
    lj, _, _ = jforward(jp, {"tokens": jnp.asarray(tokens)}, cfg=jcfg,
                        mode="prefill")
    if dtype == "float32":
        assert rel(lj, lt) < CHAIN_REL, rel(lj, lt)
        return
    fj, ft, fjp, _ = pair("float32")
    lf, _, _ = jforward(fjp, {"tokens": jnp.asarray(tokens)}, cfg=fj,
                        mode="prefill")
    assert np.isfinite(as_f32(lt)).all()
    assert err(lf, lt) <= BF16_OWN * err(lf, lj), (err(lf, lt), err(lf, lj))


def test_prefill_then_decode_cache_leaves_match_jax():
    """A 64-token prefill into the caches, then two decode steps: the
    logits and every cache leaf (mamba ssm / conv, attention k / v /
    abs_pos) against JAX's."""
    jcfg, tcfg, jp, tp = pair()
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, 512, (2, 64)).astype(np.int32)
    jc = jmake_cache(jcfg, 2, 96)
    tc = make_cache(tcfg, 2, 96, device="cpu")
    lj, jc, _ = jforward(jp, {"tokens": jnp.asarray(prompt)}, cfg=jcfg,
                         mode="prefill", caches=jc)
    lt = tforward(tp, {"tokens": torch.from_numpy(prompt)}, cfg=tcfg,
                  mode="prefill", caches=tc)
    assert rel(lj, lt) < CHAIN_REL
    for step in range(2):
        tok = rng.integers(0, 512, (2, 1)).astype(np.int32)
        pos = np.full((2, 1), 64 + step, np.int32)
        lj, jc, _ = jforward(jp, {"tokens": jnp.asarray(tok)}, cfg=jcfg,
                             mode="decode", caches=jc,
                             positions=jnp.asarray(pos))
        lt = tforward(tp, {"tokens": torch.from_numpy(tok)}, cfg=tcfg,
                      mode="decode", caches=tc,
                      positions=torch.from_numpy(pos))
        assert rel(lj, lt) < CHAIN_REL, step
    n = 0
    for jl, tl in zip(jc[0], tc[0]):
        assert set(jl) == set(tl)
        for kind in jl:
            assert set(jl[kind]) == set(tl[kind])
            for key in jl[kind]:
                a, b = jl[kind][key], tl[kind][key]
                assert tuple(a.shape) == tuple(b.shape), key
                if key == "abs_pos":
                    assert np.array_equal(np.asarray(a), b.numpy())
                else:
                    assert rel(a, b) < CHAIN_REL, (kind, key, rel(a, b))
                n += 1
    assert n == 7 * 2 + 3          # seven mamba layers, one attention


# -- the dense Engine ---------------------------------------------------------

def test_greedy_decode_agrees_with_jax_engine():
    """Three fresh slots decode greedily in lockstep with the JAX engine
    (measured: 30/30 tokens agree); at a divergence the JAX top-2 logit
    gap must be a knife edge (below twice ``CHAIN_REL`` of the logits'
    scale, ~4)."""
    jeng, teng = engines()
    jr = [JRequest(f"r{i}", p, max_new_tokens=10)
          for i, p in enumerate(PROMPTS)]
    tr = [Request(f"r{i}", p, max_new_tokens=10)
          for i, p in enumerate(PROMPTS)]
    for a, b in zip(jr, tr):
        assert jeng.add_request(a) and teng.add_request(b)
    while jeng.requests:
        assert set(jeng.step()) == set(teng.step())
    assert not teng.requests and all(len(r.output) == 10 for r in tr)
    jcfg, _, jp, _ = pair()
    rate, gaps = greedy_agreement(
        {r.rid: r.output for r in jr}, {r.rid: r.output for r in tr},
        {f"r{i}": p for i, p in enumerate(PROMPTS)}, jcfg, jp)
    assert rate == 1.0 or all(g < 2 * CHAIN_REL * 4 for g in gaps.values()
                              ), (rate, gaps)


def test_jax_engine_leaks_a_reused_mamba_slot_and_the_port_does_not():
    """On the JAX ``Engine`` a request prefilled into a slot another
    request left starts from that request's mamba state (its ``_prefill``
    hands the slot's caches to ``mamba_parallel``); the port zeroes the
    slot's ``ssm`` and ``conv`` first.  Request a (37 tokens, 6 new) runs
    and retires from slot 0; request b (37 tokens) is prefilled into slot
    0.  Its state is compared with a fresh engine's: the tokens may well
    agree, the state does not."""
    rng = np.random.default_rng(0)
    a, b = rng.integers(0, 512, 37), rng.integers(0, 512, 37)

    def after_b(jax_side, reuse):
        jeng, teng = engines(slots=3, max_len=160)
        eng, R = (jeng, JRequest) if jax_side else (teng, Request)
        if reuse:
            first = R("a", a, max_new_tokens=6)
            serve(eng, first)
            assert first.slot == 0 and not eng.requests
        req = R("b", b, max_new_tokens=6)
        assert eng.add_request(req) and req.slot == 0
        return mamba_rows(eng.state.caches, 0), eng, req

    j_reused, _, _ = after_b(True, True)
    j_fresh, _, _ = after_b(True, False)
    t_reused, teng, treq = after_b(False, True)
    t_fresh, tfresh, freq = after_b(False, False)
    ssm = max(np.abs(j_reused[k] - j_fresh[k]).max()
              for k in j_fresh if k[1] == "ssm")
    conv = max(np.abs(j_reused[k] - j_fresh[k]).max()
               for k in j_fresh if k[1] == "conv")
    assert ssm > 10.0 and conv > 0.1, (ssm, conv)          # the leak
    for k in t_fresh:                 # the port: the fresh state, exactly
        assert np.array_equal(t_reused[k], t_fresh[k]), k
        assert rel(j_fresh[k], t_reused[k]) < CHAIN_REL, k
    assert serve(teng, treq) == serve(tfresh, freq)


def test_reused_slot_is_zeroed_before_its_prefill_and_idle_rows_kept(
        monkeypatch):
    """The port's prefill clears every mamba leaf of its slot before the
    forward (seen by a forward that records them), and a decode step
    leaves inactive slots' ``ssm`` / ``conv`` untouched."""
    import repro_torch.serving.engine as tengine
    _, teng = engines(slots=3)
    first = Request("a", PROMPTS[1], max_new_tokens=4)
    serve(teng, first)
    assert any(np.abs(v).max() > 0
               for v in mamba_rows(teng.state.caches, 0).values())
    seen = {}

    def spy(params, batch, *, caches=None, mode, **kw):
        if mode == "prefill":
            seen.update(mamba_rows(caches, 0))
        return tforward(params, batch, caches=caches, mode=mode, **kw)

    monkeypatch.setattr(tengine, "forward", spy)
    assert teng.add_request(Request("b", PROMPTS[0], max_new_tokens=6))
    monkeypatch.undo()
    assert seen and all(not v.any() for v in seen.values())
    assert teng.add_request(Request("c", PROMPTS[2], max_new_tokens=6))
    teng.step(auto_retire=False)
    teng.retire(1)
    idle = mamba_rows(teng.state.caches, 1)
    busy = mamba_rows(teng.state.caches, 0)
    teng.step(auto_retire=False)
    teng.step(auto_retire=False)
    now = mamba_rows(teng.state.caches, 1)
    assert all(np.array_equal(idle[k], now[k]) for k in idle)
    assert any(not np.array_equal(busy[k], v)
               for k, v in mamba_rows(teng.state.caches, 0).items())


def test_recurrent_verify_and_rollback_are_refused():
    """The wide verify mode raises ``ValueError`` on the dense engine
    (the stepwise and distribution modes and ``rollback_slot`` run:
    tests/test_torch_spec_recurrent.py), and ``PagedEngine`` refuses the
    hybrid model at construction."""
    _, teng = engines(slots=3)
    assert teng._recurrent and not teng.supports_wide_verify
    r = Request("r", PROMPTS[0], max_new_tokens=4)
    assert teng.add_request(r)
    with pytest.raises(ValueError, match="one token at a time"):
        teng.verify_slots({r.slot: [1]})
    teng.step()
    assert len(r.output) == 1
    with pytest.raises(ValueError, match="attention-only"):
        PagedEngine(pair()[1], pair()[3], device="cpu")


def test_prompt_outside_the_domain_is_refused_before_the_slot_is_taken():
    """A 100-token jamba prompt (over 64, not a multiple of 64): the JAX
    engine takes the slot and its mamba layers assert; the port's engine
    raises ``ValueError`` before anything moves, as does the balancer's
    lossy re-prefill check.  A 100-token llama prompt is taken."""
    jeng, teng = engines(slots=3, max_len=160)
    with pytest.raises(AssertionError):
        jeng.add_request(JRequest("long", np.arange(100), max_new_tokens=4))
    before = [a.clone() for a in leaves(teng.state.caches)]
    with pytest.raises(ValueError, match="mamba scan's domain"):
        teng.add_request(Request("long", np.arange(100), max_new_tokens=4))
    assert not teng.requests and teng.free_slots == [0, 1, 2]
    assert not teng.state.active.any()
    for a, b in zip(before, leaves(teng.state.caches)):
        assert torch.equal(a, b)
    req = Request("x", np.arange(90), max_new_tokens=20)
    with pytest.raises(ReprefillRefused, match="100 tokens"):
        check_reprefill(teng, req, list(range(10)))
    check_reprefill(teng, req, list(range(38)))            # 128: taken
    assert not teng.requests
    llama = fleet_side("torch").engine(seed=0, slots=3, max_len=160)
    check_reprefill(llama, req, list(range(10)))
    assert llama.add_request(Request("l", np.arange(100), max_new_tokens=4))
    assert teng.add_request(Request("ok", np.arange(128), max_new_tokens=4))


# -- the wire -----------------------------------------------------------------

def _jax_blob(jeng, temperature=0.0):
    """A JAX engine with a filler in row 0 and the migrating 17-token
    request in row 1, three decode steps in: the blob of row 1."""
    filler = JRequest("f", PROMPTS[0], max_new_tokens=12)
    req = JRequest("m", PROMPTS[1], max_new_tokens=12,
                   temperature=temperature)
    assert jeng.add_request(filler) and jeng.add_request(req)
    for _ in range(3):
        jeng.step()
    return jmig.pack_slot(jeng.extract_slot(1, keep=True))


def test_jax_blob_roundtrips_through_the_port():
    """JAX blob -> port unpack_slot / inject_slot -> port extract_slot /
    pack_slot: every non-RNG leaf (key, order, shape, dtype tag, bytes:
    f32 ``ssm``, bf16 ``conv`` as uint16) and the meta equal the JAX
    blob's; then both engines continue the row."""
    jeng, teng = engines(slots=3, dtype="bfloat16")
    jblob = _jax_blob(jeng)
    assert teng.add_request(Request("f", PROMPTS[0], max_new_tokens=12))
    for _ in range(3):
        teng.step()
    snap = unpack_slot(jblob, teng.slot_like())
    assert snap.version == 1
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
    tags = {it["key"]: it["dtype"] for it in ol}
    assert tags[".caches[0][0]['mamba']['ssm']"] == "float32"
    assert tags[".caches[0][0]['mamba']['conv']"] == "bfloat16"
    assert tags[".caches[0][4]['attn']['k']"] == "bfloat16"
    assert ".caches[0][4]['mamba']['ssm']" not in tags
    for _ in range(2):
        teng.step()
    assert len(teng.requests[1].output) == 5


def test_repack_leaves_the_mamba_leaves_untouched():
    """``repack_slot`` re-lays out attention rows by name (k, v,
    abs_pos).  At a target max_len of 128 -- tiny jamba's d_inner, the
    length of ``conv``'s last axis -- the mamba leaves stay as they
    are; the grown slot resumes in a max_len-128 engine as a fresh run
    there does, and shrinking back gives the original blob."""
    jcfg, tcfg, jp, tp = pair()
    src = Engine(tcfg, tp, slots=3, max_len=64, seed=0, device="cpu")
    req = Request("g", PROMPTS[1], max_new_tokens=10)
    assert src.add_request(req)
    for _ in range(3):
        src.step()
    snap = src.extract_slot(req.slot, keep=True)
    grown = repack_slot(snap, tcfg.d_inner)
    for old, new in zip(snap.arrays.caches[0], grown.arrays.caches[0]):
        if "mamba" in old:
            assert torch.equal(old["mamba"]["ssm"], new["mamba"]["ssm"])
            assert torch.equal(old["mamba"]["conv"], new["mamba"]["conv"])
            assert new["mamba"]["conv"].shape == (2, 3, 128)
        else:
            assert new["attn"]["k"].shape[1] == 128
            assert (new["attn"]["abs_pos"][:, 64:] == -1).all()
    assert pack_slot(repack_slot(grown, 64)) == pack_slot(snap)
    dst = Engine(tcfg, tp, slots=3, max_len=128, seed=0, device="cpu")
    moved = dst.inject_slot(grown)
    ref = Engine(tcfg, tp, slots=3, max_len=128, seed=0, device="cpu")
    r2 = Request("g", PROMPTS[1], max_new_tokens=10)
    out = list(moved.output)
    while not moved.done:
        out.append(dst.step()["g"])
        moved.done = len(out) >= 10
    assert out == serve(ref, r2)


def test_sampled_slot_moves_bit_exact_into_another_slot_index():
    """A sampled jamba slot leaves after four steps through pack_slot ->
    unpack_slot into slot 2 of an engine of another seed, beside a
    resident request, and finishes with the unmigrated run's tokens."""
    _, tcfg, _, tp = pair("bfloat16")

    def run(move):
        eng = Engine(tcfg, tp, slots=3, max_len=96, seed=0, device="cpu")
        req = Request("w", PROMPTS[2], max_new_tokens=10, temperature=0.7,
                      top_k=8)
        assert eng.add_request(req)
        for _ in range(4):
            eng.step()
        if not move:
            while not req.done:
                eng.step()
            return list(req.output)
        blob = pack_slot(eng.extract_slot(req.slot))
        dst = Engine(tcfg, tp, slots=3, max_len=96, seed=9, device="cpu")
        assert dst.add_request(Request("x", PROMPTS[0], max_new_tokens=3))
        moved = dst.inject_slot(unpack_slot(blob, dst.slot_like()), slot=2)
        while not moved.done:
            dst.step()
        return list(moved.output)

    assert run(True) == run(False)


def test_workspace_migrator_full_then_incremental_is_bit_exact():
    """A whole jamba workspace (two requests, one sampled) moves once in
    full and once as a delta after one more step through ``Migrator``;
    the continuation equals the unmoved engine's."""
    _, tcfg, _, tp = pair("bfloat16")

    def start(seed):
        eng = Engine(tcfg, tp, slots=3, max_len=96, seed=seed, device="cpu")
        reqs = [Request("g", PROMPTS[0], max_new_tokens=10),
                Request("s", PROMPTS[1], max_new_tokens=10,
                        temperature=0.8, top_k=6)]
        for r in reqs:
            assert eng.add_request(r)
        for _ in range(3):
            eng.step()
        return eng, reqs

    ref, ref_reqs = start(3)
    for _ in range(7):
        ref.step()
    src, _ = start(3)
    mig = Migrator()
    target = Engine(tcfg, tp, slots=3, max_len=96, seed=11, device="cpu")
    _, full = mig.migrate(AgentWorkspace.from_engine(src, "gid"),
                          _session(), target)
    src.step()
    dst, inc = mig.migrate(AgentWorkspace.from_engine(src, "gid"),
                           _session(), target, incremental=True)
    assert dst is target and inc.incremental and full.delta_fraction == 1.0
    assert 0.0 < inc.delta_fraction < 1.0, inc.delta_fraction
    outs = {r.rid: list(r.output) for r in dst.requests.values()}
    while dst.requests:
        for rid, t in dst.step().items():
            outs[rid].append(t)
    assert outs == {r.rid: r.output for r in ref_reqs}


# -- the fleet ----------------------------------------------------------------

def jamba_side(side: str):
    """``fleet_side`` with tiny jamba (f32, the bridged seed-5 weights)
    in place of the tiny llama."""
    S = fleet_side(side, "float32")
    jcfg, tcfg, jp, tp = pair()
    cfg, params = (jcfg, jp) if side == "jax" else (tcfg, tp)
    dev = {} if side == "jax" else {"device": "cpu"}
    engine_cls = type(S.engine(seed=0, slots=3, max_len=64))
    S.cfg = cfg
    S.engine = lambda seed=0, **kw: engine_cls(cfg, params, seed=seed,
                                               **kw, **dev)
    return S


def _jamba_stream(S):
    """Five greedy requests over three dense engines on a SimClock (each
    engine's slots enough that no slot is reused by a fresh prefill: the
    JAX engine would leak the mamba state into it); after 3 steps the
    busiest engine drains (a live migration), after 6 the busiest fails
    (failover from shadows).  Conservation after every step."""
    clk = S.SimClock()
    handles = [S.EngineHandle(n, S.engine(seed=i, slots=3, max_len=64), p)
               for i, (n, p) in enumerate([("a", S.CLOUD), ("b", S.CLOUD),
                                           ("c", S.EDGE)])]
    fleet = S.FleetController(handles, authority=S.TrustAuthority(),
                              clock=clk)
    rng = np.random.default_rng(4)
    prompts = {}
    for i in range(5):
        p = rng.integers(5, S.cfg.vocab_size, 6 + i)
        prompts[f"r{i}"] = p
        fleet.submit(S.RequestSpec(rid=f"r{i}", prompt=p, max_new_tokens=10,
                                   sensitivity=("public", "personal")[i % 2]))
    prefills = []
    for h in handles:
        orig = h.engine.add_request

        def counted(req, *a, orig=orig, name=h.name, **kw):
            ok = orig(req, *a, **kw)
            if ok:
                prefills.append((name, req.slot))
            return ok
        h.engine.add_request = counted
    for step in range(60):
        if step in (3, 6):
            busiest = max((n for n, h in fleet.handles.items()
                           if h.healthy and n in {"a", "b"}),
                          key=lambda n: len(fleet.handles[n].engine.requests))
            (fleet.drain if step == 3 else fleet.fail)(busiest)
        fleet.step()
        clk.advance(0.01)
        (assert_conserved if S.side == "torch" else helpers.assert_conserved)(
            fleet)
        if all(t.done for t in fleet.tickets.values()):
            break
    assert len(prefills) == len(set(prefills)), prefills
    return fleet_record(fleet), prompts


def test_fleet_decisions_and_tokens_match_jax():
    (jrec, prompts), (trec, _) = (_jamba_stream(jamba_side(s))
                                  for s in ("jax", "torch"))
    jout, tout = jrec.pop("outputs"), trec.pop("outputs")
    for key in ("placements", "states", "migrations"):
        assert trec[key] == jrec[key], key
    assert all(s[-1] == "done" for s in trec["states"].values())
    reasons = {m[4] for m in trec["migrations"]}
    assert {"drain", "failover"} <= reasons, reasons
    assert not any(m[3] for m in trec["migrations"])       # all exact
    jcfg, _, jp, _ = pair()
    rate, gaps = greedy_agreement(jout, tout, prompts, jcfg, jp)
    assert rate == 1.0 or all(g < 2 * CHAIN_REL * 4 for g in gaps.values()
                              ), (rate, gaps)


def test_speculative_pair_with_a_jamba_target_is_refused():
    """The wide verify mode is refused at construction (recurrent
    mixers); a stepwise pair verifies on the jamba engine
    (tests/test_torch_spec_recurrent.py runs both modes to the end)."""
    from repro_torch.core.channel import Fabric
    from repro_torch.core.daemon import CLOUD, EDGE
    from repro_torch.fleet import EngineHandle, SpeculativeTierController
    _, tcfg, _, tp = pair()
    mk = lambda s: Engine(tcfg, tp, slots=3, max_len=64, seed=s,  # noqa
                          device="cpu")
    draft, verify = EngineHandle("d", mk(0), EDGE), EngineHandle("v", mk(1),
                                                                 CLOUD)
    with pytest.raises(ValueError, match="recurrent mixers"):
        SpeculativeTierController(draft, verify, fabric=Fabric(),
                                  whitelist=set(), measurement="m",
                                  verify_mode="wide")
    SpeculativeTierController(draft, verify, fabric=Fabric(),
                              whitelist=set(), measurement="m")
    r = Request("r", PROMPTS[0], max_new_tokens=4)
    assert verify.engine.add_request(r)
    n, corr = verify.engine.verify_slots_stepwise({r.slot: [3]})[r.slot]
    assert (n, corr) == (1, None) or (n == 0 and corr != 3)


# -- attestation, the daemon and the CLIs -------------------------------------

def test_capabilities_and_decide_match_jax():
    jcfg, tcfg = jget(NAME), tget(NAME)
    for platform in ("gpu", "cpu"):
        caps = tatt.capabilities(tcfg, platform=platform)
        assert caps == jatt.capabilities(jcfg, platform=platform)
        assert {"SUBQUADRATIC_ATTN", "MOE_EP"} <= caps
    for sens in ("public", "personal", "confidential"):
        for prefill in (16, 200_000):
            kw = dict(sensitivity=sens, prefill_tokens=prefill,
                      decode_tokens=64, workspace_bytes=25_000_000)
            jdec = jdaemon.PrivacyAwareDaemon().decide(cfg=jcfg, **kw)
            # the JAX profiles on both sides (the port's CLOUD is the
            # H100's)
            tdec = PrivacyAwareDaemon(
                local=DeviceProfile(**dataclasses.asdict(jdaemon.EDGE)),
                remote=DeviceProfile(**dataclasses.asdict(jdaemon.CLOUD)),
            ).decide(cfg=tcfg, **kw)
            assert dataclasses.asdict(tdec) == dataclasses.asdict(jdec)


@pytest.mark.parametrize("cli", ["serve", "fleet"])
def test_clis_serve_jamba(cli, capsys):
    if cli == "serve":
        code = serve_cli.main(["--arch", NAME, "--tiny", "--device", "cpu",
                               "--requests", "3", "--max-new", "4"])
    else:
        code = fleet_cli.main(["--arch", NAME, "--tiny", "--device", "cpu",
                               "--requests", "3", "--max-new", "4",
                               "--slots", "3", "--max-len", "64",
                               "--engines", "a:cloud,b:edge"])
    out, _ = capsys.readouterr()
    assert code == 0
    if cli == "serve":
        assert out.splitlines()[-1].startswith("12 tokens in ")
    else:
        assert out.count(" via ") == 3
