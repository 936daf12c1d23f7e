"""The six attention-only families on the port's engines, against the JAX
package's engines on the same (bridged, f32) weights: greedy tokens of
``PagedEngine`` and of the dense ``Engine`` compared as an agreement rate,
with the JAX top-2 logit gap at each first divergence; JAX-packed slot
blobs of tiny gemma3-4b (local ring buffers) and deepseek-moe-16b (two
block groups, MoE) through the port leaf-equal (dense v1, paged v2); and
``repro_torch.launch.serve`` on each tiny family.

Prompts of 40 tokens pass the tiny configs' local window of 32, so the
dense engines' ring buffers wrap.  Dense engines use 3 slots, never 2:
with slots equal to a tiny config's repeat count the JAX ``_bcast``
mask-back masks the repeat axis (ROADMAP, reference behaviours).  A
divergence is legitimate only where the JAX top-2 gap is below twice the
f32 logit tolerance of tests/test_torch_families.py (1e-4, 3e-4 for the
MoE families)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import msgpack  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.configs.tiny import make_tiny as jtiny  # noqa: E402
from repro.core import migration as jmig  # noqa: E402
from repro.models.init import init_params as jinit  # noqa: E402
from repro.serving import paged as jpaged  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.configs.tiny import make_tiny  # noqa: E402
from repro_torch.core.migration import (RNG_TAG, pack_slot,  # noqa: E402
                                        unpack_slot)
from repro_torch.core.msgpack_subset import unpackb  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.init import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.paged import PagedEngine  # noqa: E402
from tests.torch_helpers import greedy_agreement, to_numpy  # noqa: E402

FAMILIES = ["gemma2-27b", "gemma3-4b", "stablelm-12b", "deepseek-7b",
            "granite-moe-1b-a400m", "deepseek-moe-16b"]
PROMPTS = [np.arange(2, 42), np.arange(100, 117), np.arange(300, 309)]
MAX_NEW = 10
_PAIRS = {}


def pair(name, dtype="float32", seed=5):
    key = (name, dtype, seed)
    if key not in _PAIRS:
        jc = jtiny(jget(name)).replace(dtype=dtype)
        tc = make_tiny(get(name)).replace(dtype=dtype)
        jp = jinit(jc, jax.random.key(seed))
        _PAIRS[key] = (jc, tc, jp,
                       params_from_numpy(to_numpy(jp), device="cpu"))
    return _PAIRS[key]


def gap_tol(cfg) -> float:
    return 2 * (3e-4 if cfg.moe is not None else 1e-4)


def _run_lockstep(jeng, teng):
    """Both engines serve PROMPTS greedily in lockstep; returns the JAX
    and port outputs by rid."""
    jreqs = [JRequest(f"r{i}", p, max_new_tokens=MAX_NEW)
             for i, p in enumerate(PROMPTS)]
    treqs = [Request(f"r{i}", p, max_new_tokens=MAX_NEW)
             for i, p in enumerate(PROMPTS)]
    for jr, tr in zip(jreqs, treqs):
        assert jeng.add_request(jr) and teng.add_request(tr)
    while jeng.requests:
        je, te = jeng.step(), teng.step()
        assert set(je) == set(te)
    assert not teng.requests
    return ({r.rid: list(r.output) for r in jreqs},
            {r.rid: list(r.output) for r in treqs})


@pytest.mark.parametrize("kind", ["paged", "dense"])
@pytest.mark.parametrize("name", FAMILIES)
def test_greedy_tokens_agree_with_jax(name, kind):
    jc, tc, jp, tp = pair(name)
    if kind == "paged":
        kw = dict(page_size=8, rows=3, max_len=64, seed=0)
        jeng = jpaged.PagedEngine(jc, jp, **kw)
        teng = PagedEngine(tc, tp, device="cpu", **kw)
    else:
        jeng = JEngine(jc, jp, slots=3, max_len=64, seed=0)
        teng = Engine(tc, tp, slots=3, max_len=64, seed=0, device="cpu")
    jouts, touts = _run_lockstep(jeng, teng)
    prompts = {f"r{i}": p for i, p in enumerate(PROMPTS)}
    rate, gaps = greedy_agreement(jouts, touts, prompts, jc, jp)
    assert all(g < gap_tol(tc) for g in gaps.values()), (rate, gaps)
    assert rate == 1.0 or gaps
    if kind == "paged":
        teng.check()
        assert teng.allocator.free_pages == teng.pages


def _jax_blob(jeng):
    """A JAX engine with a filler in row 0 and the migrating 40-token
    request in row 1, three decode steps in: the blob of row 1."""
    filler = JRequest("f", np.arange(30, 41), max_new_tokens=12)
    req = JRequest("m", np.arange(2, 42), max_new_tokens=12)
    assert jeng.add_request(filler) and jeng.add_request(req)
    assert req.slot == 1
    for _ in range(3):
        jeng.step()
    return jmig.pack_slot(jeng.extract_slot(1, keep=True))


@pytest.mark.parametrize("kind", ["dense", "paged"])
@pytest.mark.parametrize("name", ["gemma3-4b", "deepseek-moe-16b"])
def test_jax_blob_roundtrips_through_the_port(name, kind):
    """JAX blob -> port unpack_slot / inject_slot -> port extract_slot /
    pack_slot: every non-RNG leaf (key, order, shape, dtype tag, bytes)
    and the meta equal the JAX blob's: gemma3-4b's 32-slot local rings
    beside its global rows, deepseek-moe-16b's two block groups."""
    jc, tc, jp, tp = pair(name, "bfloat16")
    if kind == "dense":
        jeng = JEngine(jc, jp, slots=3, max_len=64, seed=0)
        teng = Engine(tc, tp, slots=3, max_len=64, seed=0, device="cpu")
    else:
        kw = dict(page_size=8, rows=3, max_len=64, seed=0)
        jeng = jpaged.PagedEngine(jc, jp, **kw)
        teng = PagedEngine(tc, tp, device="cpu", **kw)
    jblob = _jax_blob(jeng)
    assert teng.add_request(Request("f", np.arange(30, 41),
                                    max_new_tokens=12))
    for _ in range(3):
        teng.step()
    snap = unpack_slot(jblob, teng.slot_like())
    assert snap.version == (1 if kind == "dense" else 2)
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
    if kind == "dense" and name == "gemma3-4b":
        # a local layer's rows are its 32-slot ring, a global one's
        # max_len: (repeats, slots) of the one row
        shapes = {tuple(it["shape"]) for it in ol
                  if it["key"].endswith("['k']")}
        assert shapes == {(2, 32, tc.num_kv_heads, tc.head_dim),
                          (2, 64, tc.num_kv_heads, tc.head_dim),
                          (1, 32, tc.num_kv_heads, tc.head_dim)}
    if kind == "paged":
        teng.check()


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_cli_runs_each_family(name, capsys):
    code = serve_cli.main(["--arch", name, "--tiny", "--device", "cpu",
                           "--requests", "3", "--max-new", "4"])
    out, _ = capsys.readouterr()
    assert code == 0
    assert out.splitlines()[-1].startswith("12 tokens in ")
    assert out.splitlines()[-1].endswith("tok/s on cpu)")
