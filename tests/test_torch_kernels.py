"""The port's kernels: plain versions against the JAX package.

The same numpy-seeded inputs go through the JAX Pallas kernels (interpret
mode, as tests/test_kernels.py and tests/test_paging.py run them on the
CPU) or the JAX oracles, and through the port's plain PyTorch versions.
Tolerances as in the reference tests: f32 2e-5 abs, bf16 2e-2 abs, rwkv
5e-4 abs, int8 5e-3 relative to the largest |reference|.  The
CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda_kernels.py.
"""

import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import \
    decode_attention as jax_decode  # noqa: E402
from repro.kernels.decode_attention import \
    paged_decode_attention as jax_paged  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as jax_flash  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.int8_matmul import int8_matmul as jax_int8  # noqa: E402
from repro.kernels.rwkv6_scan import rwkv6_scan as jax_rwkv  # noqa: E402
from repro.kernels.spec_verify import spec_accept as jax_accept  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import int8_matmul as im  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rs  # noqa: E402
from repro_torch.kernels import spec_verify as sv  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(dtype: str) -> float:
    return 2e-2 if dtype == "bfloat16" else 2e-5


def both(x: np.ndarray, dtype: str):
    """One numpy array as a JAX array and a torch tensor of one dtype
    (bf16 rounds the same way, to nearest even, in both)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def err(jax_out, torch_out) -> float:
    a = np.asarray(jnp.asarray(jax_out, jnp.float32))
    return float(np.abs(a - torch_out.float().numpy()).max())


MODES = {"causal": dict(causal=True), "window": dict(causal=True, window=48),
         "full": dict(causal=False),
         "softcap": dict(causal=True, softcap=20.0)}


@pytest.mark.parametrize("B,S,H,KV,D", [
    (1, 128, 4, 4, 64),    # MHA
    (2, 256, 8, 2, 64),    # GQA 4:1
    (1, 128, 4, 1, 128),   # MQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", list(MODES))
def test_flash_plain_matches_pallas_interpret(B, S, H, KV, D, dtype, mode):
    rng = np.random.default_rng(7)
    (qj, qt), (kj, kt), (vj, vt) = (
        both(rng.standard_normal(s).astype(np.float32), dtype)
        for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    kw = MODES[mode]
    o_jax = jax_flash(qj, kj, vj, block_q=64, block_k=64, interpret=True,
                      **kw)
    o_port = fa.plain(qt, kt, vt, **kw)
    assert o_port.dtype == DTYPES[dtype][1]
    assert err(o_jax, o_port) < tol(dtype), mode


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_attention_q_offset_and_kv_len(dtype):
    """Continuation prefill (q_offset != 0) and a per-row valid kv prefix,
    against the JAX oracle (the Pallas kernel takes neither)."""
    rng = np.random.default_rng(3)
    B, Sq, Skv, H, KV, D = 2, 24, 64, 4, 2, 32
    (qj, qt), (kj, kt), (vj, vt) = (
        both(rng.standard_normal(s).astype(np.float32), dtype)
        for s in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D)))
    for kw in (dict(causal=True, q_offset=40),
               dict(causal=True, window=16, q_offset=40),
               dict(causal=False, softcap=20.0)):
        o_jax = jax_attn.reference_attention(qj, kj, vj, **kw)
        o_port = ref.reference_attention(qt, kt, vt, **kw)
        assert err(o_jax, o_port) < tol(dtype), kw
    kv_len = np.asarray([10, 64], np.int32)
    o_jax = jax_attn.reference_attention(qj, kj, vj, causal=False,
                                         kv_len=jnp.asarray(kv_len))
    o_port = ref.reference_attention(qt, kt, vt, causal=False,
                                     kv_len=torch.from_numpy(kv_len))
    assert err(o_jax, o_port) < tol(dtype)


@pytest.mark.parametrize("window", [0, 32])
@pytest.mark.parametrize("per_query", [False, True])
def test_decode_attend_matches_jax(window, per_query):
    rng = np.random.default_rng(5)
    B, Sq, Sc, H, KV, D = 2, 3, 96, 8, 2, 64
    (qj, qt), (kj, kt), (vj, vt) = (
        both(rng.standard_normal(s).astype(np.float32), "float32")
        for s in ((B, Sq, H, D), (B, Sc, KV, D), (B, Sc, KV, D)))
    ap = np.where(np.arange(Sc)[None] < np.asarray([[80], [50]]),
                  np.arange(Sc)[None], -1).astype(np.int32)
    pos = (np.asarray([[77, 78, 79], [40, 41, 42]], np.int32) if per_query
           else np.asarray([79, 42], np.int32))
    o_jax = jax_attn.decode_attend(qj, kj, vj, jnp.asarray(ap),
                                   jnp.asarray(pos), window=window)
    o_port = ref.decode_attend(qt, kt, vt, torch.from_numpy(ap),
                               torch.from_numpy(pos), window=window)
    assert err(o_jax, o_port) < 2e-5


def _dense_case(mode, rng, dtype):
    """A dense decode case: (q, k, v, abs_pos, positions, kw) as (jax,
    torch) pairs, every row holding at least one valid slot.

    ``fill``: rows filled to 1, 37 and all 128 slots, with rolled-back
    slots past the position; ``window``: a 32-slot ring buffer holding
    the last 32 positions (and one short row); ``softcap``: ``fill`` with
    a softcap."""
    B, H, KV, D = 3, 8, 2, 64
    slot = np.arange(128)[None]
    if mode == "window":
        Sc, kw = 32, dict(window=32)
        pos = np.asarray([100, 31, 9], np.int32)
        p = pos[:, None] - ((pos[:, None] - slot[:, :Sc]) % Sc)
        ap = np.where(p >= 0, p, -1).astype(np.int32)
    else:
        Sc = 128
        kw = dict(softcap=20.0) if mode == "softcap" else {}
        fill = np.asarray([1, 37, 128])
        held = np.minimum(fill + 4, Sc)              # rolled-back slots
        ap = np.where(slot < held[:, None], slot, -1).astype(np.int32)
        pos = (fill - 1).astype(np.int32)
    q, k, v = (both(rng.standard_normal(s).astype(np.float32), dtype)
               for s in ((B, 1, H, D), (B, Sc, KV, D), (B, Sc, KV, D)))
    return (q, k, v, (jnp.asarray(ap), torch.from_numpy(ap)),
            (jnp.asarray(pos), torch.from_numpy(pos)), kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["fill", "window", "softcap"])
def test_decode_plain_matches_pallas_interpret(dtype, mode):
    """The plain dense ``decode_attention`` against the Pallas kernel
    (interpret mode, block_k=64) and the JAX oracle ``decode_attend``."""
    (qj, qt), (kj, kt), (vj, vt), (aj, at), (pj, pt), kw = _dense_case(
        mode, np.random.default_rng(13), dtype)
    o_port = da.plain(qt, kt, vt, at, pt, **kw)
    assert o_port.dtype == DTYPES[dtype][1]
    o_pallas = jax_decode(qj, kj, vj, aj, pj, block_k=64, interpret=True,
                          **kw)
    o_oracle = jax_attn.decode_attend(qj, kj, vj, aj, pj, **kw)
    assert err(o_pallas, o_port) < tol(dtype), mode
    assert err(o_oracle, o_port) < tol(dtype), mode
    assert torch.equal(ops.decode_attention(qt, kt, vt, at, pt, **kw),
                       o_port)                 # CPU tensors -> plain


def _split_case(mode, chunk, rng, dtype):
    """A dense decode case for the split over slots: (q, k, v, abs_pos,
    positions) as (jax, torch) pairs, kw, the rows that hold a valid slot,
    and the Pallas block size.  Rows end on the last slot of a chunk and
    the first slot of the next, and at the last slot of a cache whose
    length (200) is not a multiple of the chunk; ``holes`` empties whole
    chunks inside rows; ``empty_row`` leaves row 3 with no valid slot;
    ``window`` is a 64-slot ring buffer."""
    B, H, KV, D = 4, 8, 2, 64
    kw, live = {}, [0, 1, 2, 3]
    if mode == "window":
        Sc, block = 64, 32
        kw = dict(window=64)
        pos = np.asarray([100, 63, 10, 200], np.int32)
        slot = np.arange(Sc)[None]
        p = pos[:, None] - ((pos[:, None] - slot) % Sc)
        ap = np.where(p >= 0, p, -1).astype(np.int32)
    else:
        Sc, block = 200, 40
        slot = np.arange(Sc)[None]
        pos = np.asarray([chunk - 1, chunk, Sc - 1, 50], np.int32)
        held = np.minimum(pos + 4, Sc)              # rolled-back slots
        ap = np.where(slot < held[:, None], slot, -1).astype(np.int32)
        if mode == "holes":
            ap[1, :chunk] = -1                      # chunk 0 empty
            ap[2, chunk:2 * chunk] = -1             # a middle chunk empty
            ap[3, 5:45:3] = -1
        elif mode == "empty_row":
            ap[3] = -1
            live = [0, 1, 2]
        elif mode == "softcap":
            kw = dict(softcap=20.0)
    q, k, v = (both(rng.standard_normal(s).astype(np.float32), dtype)
               for s in ((B, 1, H, D), (B, Sc, KV, D), (B, Sc, KV, D)))
    return (q, k, v, (jnp.asarray(ap), torch.from_numpy(ap)),
            (jnp.asarray(pos), torch.from_numpy(pos)), kw, live, block)


@pytest.mark.parametrize("chunk", [32, da.CHUNK])
@pytest.mark.parametrize("mode", ["fill", "holes", "empty_row", "window",
                                  "softcap"])
def test_decode_split_plain_matches_plain_and_pallas(mode, chunk):
    """The dense kernel's split over slots (per-chunk m and l merged in
    chunk order, normalised p per chunk, the chunks' P V summed in chunk
    order), in plain PyTorch, against the plain version and the Pallas
    kernel (interpret mode) in f32; a row with no valid slot is exactly
    0."""
    (qj, qt), (kj, kt), (vj, vt), (aj, at), (pj, pt), kw, live, block = \
        _split_case(mode, chunk, np.random.default_rng(21), "float32")
    o = da.split_plain(qt, kt, vt, at, pt, chunk=chunk, **kw)
    o_plain = da.plain(qt, kt, vt, at, pt, **kw)
    o_pallas = jax_decode(qj, kj, vj, aj, pj, block_k=block, interpret=True,
                          **kw)
    assert o.dtype == torch.float32 and o.shape == qt.shape
    assert float((o[live] - o_plain[live]).abs().max()) < 2e-5
    assert err(np.asarray(o_pallas)[live], o[live]) < 2e-5
    dead = [b for b in range(4) if b not in live]
    assert all(float(o[b].abs().max()) == 0.0 for b in dead)


@pytest.mark.parametrize("mode", ["fill", "holes", "window", "softcap"])
def test_decode_split_plain_bf16_matches_plain(mode):
    """bf16 caches: normalised p rounded to bf16, as the kernel and the
    reference do."""
    (_, qt), (_, kt), (_, vt), (_, at), (_, pt), kw, live, _ = _split_case(
        mode, 32, np.random.default_rng(22), "bfloat16")
    o = da.split_plain(qt, kt, vt, at, pt, chunk=32, **kw)
    assert o.dtype == torch.bfloat16
    assert float((o[live].float() - da.plain(qt, kt, vt, at, pt, **kw)[
        live].float()).abs().max()) < 2e-2


def _accept_case(rng, g, V, kind):
    """(tokens, q, p, u) as numpy.  ``random``: drafts drawn from q;
    ``greedy``: one-hot q and p agreeing on a prefix (g = 1: full
    acceptance, then the bonus row); ``q0``: q_tok = 0 at one draft."""
    u = rng.random(g).astype(np.float32)
    if kind == "greedy":
        t = rng.integers(0, V, g + 1)
        d = t[:g].copy()
        if g > 1:
            d[g // 2:] = (d[g // 2:] + 1) % V
        q = np.eye(V, dtype=np.float32)[d]
        p = np.eye(V, dtype=np.float32)[t]
        return d.astype(np.int32), q, p, u
    def soft(x):
        e = np.exp(2 * (x - x.max(-1, keepdims=True)))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)
    q = soft(rng.standard_normal((g, V)))
    p = soft(rng.standard_normal((g + 1, V)))
    d = np.asarray([rng.choice(V, p=row / row.sum()) for row in q],
                   np.int32)
    if kind == "q0":
        q[g // 2, d[g // 2]] = 0.0
        p[:g][np.arange(g), d] = np.maximum(p[:g][np.arange(g), d], 0.5)
    return d, q, p, u


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("V", [32, 512])
@pytest.mark.parametrize("kind", ["random", "greedy", "q0"])
def test_spec_accept_plain_matches_pallas_interpret(g, V, kind):
    """Same uniforms on both sides: n exactly, dist within 1e-6."""
    for seed in range(2):
        d, q, p, u = _accept_case(np.random.default_rng(seed), g, V, kind)
        n_j, dist_j = jax_accept(jnp.asarray(d), jnp.asarray(q),
                                 jnp.asarray(p), jnp.asarray(u),
                                 interpret=True)
        args = tuple(torch.from_numpy(a) for a in (d, q, p, u))
        n_t, dist_t = sv.plain(*args)
        assert n_t.dtype == torch.int32 and int(n_t) == int(n_j)
        assert float(np.abs(np.asarray(dist_j) - dist_t.numpy()).max()) \
            < 1e-6
        n_o, dist_o = ops.spec_accept(*args)        # CPU tensors -> plain
        assert int(n_o) == int(n_t) and torch.equal(dist_o, dist_t)


# draft ids outside [0, V): the Pallas kernel's one-hot finds no column, so
# p = q = 0 there, a rejection; (position, id) pairs, "over" = V + 3
@pytest.mark.parametrize("g,bad", [
    (1, ((0, "over"),)), (1, ((0, "neg"),)),
    (4, ((0, "over"),)), (4, ((2, "neg"),)), (4, ((3, "over"),)),
    (4, ((1, "neg"), (3, "over"))), (4, ((2, "over"), (0, "neg")))])
@pytest.mark.parametrize("kind", ["random", "greedy", "zero_resid"])
def test_spec_accept_plain_rejects_out_of_range_ids_as_pallas(g, bad, kind):
    """n exactly and dist within 1e-6 of the Pallas kernel; with greedy
    drafts every in-range draft is accepted, so n is the first bad id's
    position.  ``zero_resid`` makes row n of p equal row n of q at the
    first bad id: the residual is all zero and dist is p_n."""
    V = 32
    kind_of = "random" if kind == "zero_resid" else kind
    d, q, p, u = _accept_case(np.random.default_rng(g), g, V, kind_of)
    if kind_of == "greedy":
        q = np.eye(V, dtype=np.float32)[d]
        p = np.eye(V, dtype=np.float32)[np.append(d, 0)]
    for pos, which in bad:
        d[pos] = V + 3 if which == "over" else -1
    first = min(pos for pos, _ in bad)
    if kind == "zero_resid":
        p[first] = q[first]
    n_j, dist_j = jax_accept(jnp.asarray(d), jnp.asarray(q), jnp.asarray(p),
                             jnp.asarray(u), interpret=True)
    n_t, dist_t = sv.plain(*(torch.from_numpy(a) for a in (d, q, p, u)))
    assert int(n_t) == int(n_j)
    assert float(np.abs(np.asarray(dist_j) - dist_t.numpy()).max()) < 1e-6
    if kind == "greedy":
        assert int(n_t) == first
    if kind == "zero_resid" and int(n_t) == first:
        assert torch.equal(dist_t, torch.from_numpy(p[first]))


# the kernel's cluster split over V: a pure rule
@pytest.mark.parametrize("V,want", [(1, (1, 32)), (3, (1, 32)),
                                    (33, (1, 32)), (512, (1, 128)),
                                    (32768, (8, 1024)), (65536, (8, 1024)),
                                    (262144, (8, 1024))])
def test_spec_split_of_vocab_sizes(V, want):
    """V = 32768 fills 8 CTAs with one 16-byte load of each row a thread;
    below that fewer, narrower CTAs; above it 8 CTAs of 1024 threads."""
    assert sv.split(V) == want


def test_spec_split_domain_is_whole():
    """Every V gets a cluster of 1-8 CTAs of whole warps, at most 1024
    threads, whose runs of ceil(quads / C) quads cover the vocabulary once
    with no CTA left empty; V < 1 is refused."""
    for V in [*range(1, 2100), 4095, 4097, 32767, 32769, 131072, 131073,
              262144, 1 << 20]:
        C, threads = sv.split(V)
        quads = -(-V // sv.QUAD)
        per = -(-quads // C)
        assert 1 <= C <= sv.MAX_CLUSTER and (C - 1) * per < quads <= C * per
        assert threads % 32 == 0 and 32 <= threads <= sv.MAX_THREADS
        assert threads >= min(per, sv.MAX_THREADS)
        assert C == sv.MAX_CLUSTER or per <= sv.MAX_THREADS
    with pytest.raises(ValueError, match="no split"):
        sv.split(0)


def test_spec_split_holds_the_source_constants():
    """csrc/spec_verify.cu states the rule's constants as the wrapper
    does."""
    src = (pathlib.Path(sv.__file__).parent / "csrc" / "spec_verify.cu"
           ).read_text()
    consts = dict(re.findall(r"^constexpr int (\w+) = (\d+);", src, re.M))
    assert consts == {"QUAD": str(sv.QUAD),
                      "MAX_CLUSTER": str(sv.MAX_CLUSTER),
                      "MAX_THREADS": str(sv.MAX_THREADS),
                      "REG_QUADS": str(sv.REG_QUADS)}


def test_spec_verify_draws_from_the_generator():
    """``spec_verify`` is a function of the generator's state: one seed,
    one result; the greedy case is free of randomness."""
    rng = np.random.default_rng(4)
    d, q, p, _ = (torch.from_numpy(a)
                  for a in _accept_case(rng, 4, 64, "random"))
    one = [ops.spec_verify(d, q, p, torch.Generator().manual_seed(7))
           for _ in range(2)]
    assert [(int(a), int(b)) for a, b in one[0:1]] == \
        [(int(a), int(b)) for a, b in one[1:2]]
    dg, qg, pg, _ = (torch.from_numpy(a)
                     for a in _accept_case(rng, 4, 64, "greedy"))
    for seed in range(5):
        n, nxt = ops.spec_verify(dg, qg, pg,
                                 torch.Generator().manual_seed(seed))
        assert int(n) == 2 and int(nxt) == int(pg[2].argmax())


def _paged_case(rng, P, ps, NP, B, H, KV, D, dtype):
    (qj, qt), (kj, kt), (vj, vt) = (
        both(rng.standard_normal(s).astype(np.float32), dtype)
        for s in ((B, 1, H, D), (P, ps, KV, D), (P, ps, KV, D)))
    return qj, qt, kj, kt, vj, vt


@pytest.mark.parametrize("P,ps,NP", [(8, 16, 4), (16, 8, 4), (6, 32, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["plain", "window", "softcap"])
def test_paged_plain_matches_pallas_interpret(P, ps, NP, dtype, mode):
    """Tables with unmapped (-1) entries, a partial row and a fully dead
    row, whose output must be exactly 0 (tests/test_paging.py sweep)."""
    rng = np.random.default_rng(11)
    B, H, KV, D = 3, 4, 2, 64
    qj, qt, kj, kt, vj, vt = _paged_case(rng, P, ps, NP, B, H, KV, D, dtype)
    pt = np.full((B, NP), -1, np.int32)
    pt[0, :NP] = rng.choice(P, NP, replace=False)
    half = max(NP // 2, 1)
    pt[1, :half] = rng.choice(P, half, replace=False)
    pos = np.asarray([NP * ps - 1, min(ps + 1, half * ps - 1), 0], np.int32)
    kw = {"window": dict(window=ps + ps // 2),
          "softcap": dict(softcap=20.0)}.get(mode, {})
    o_jax = jax_paged(qj, kj, vj, jnp.asarray(pt), jnp.asarray(pos),
                      interpret=True, **kw)
    o_port = da.paged_plain(qt, kt, vt, torch.from_numpy(pt),
                      torch.from_numpy(pos), **kw)
    assert err(o_jax, o_port) < tol(dtype), mode
    assert float(o_port[2].abs().max()) == 0.0      # dead row: exactly 0


def test_paged_plain_randomized_tables():
    P, ps, NP, B, H, KV, D = 12, 8, 3, 4, 2, 1, 64
    for seed in range(4):
        rng = np.random.default_rng(seed)
        qj, qt, kj, kt, vj, vt = _paged_case(rng, P, ps, NP, B, H, KV, D,
                                             "float32")
        pt = np.full((B, NP), -1, np.int32)
        pos = np.zeros((B,), np.int32)
        perm = list(rng.permutation(P))
        for b in range(B):
            n = int(rng.integers(1, NP + 1))
            pt[b, :n] = [perm.pop() for _ in range(n)]
            pos[b] = int(rng.integers(0, n * ps))
        o_jax = jax_paged(qj, kj, vj, jnp.asarray(pt), jnp.asarray(pos),
                          interpret=True)
        o_port = da.paged_plain(qt, kt, vt, torch.from_numpy(pt),
                          torch.from_numpy(pos))
        assert err(o_jax, o_port) < 2e-5, seed


# the paged kernel's split over pages: a pure rule of (NP, page size)

def _paged_split_case(rng, ps, run, dtype, mode):
    """A paged case for the split over runs of ``run`` pages: NP = 2 run +
    1 pages, so the last run is short.  Row 0 maps every page and decodes
    at the last slot; row 1 leaves its first run unmapped, has a hole in
    its second (run > 1) and decodes at the first slot of its third run;
    row 2 decodes at the last slot of its first run; row 3 maps nothing
    and must be exactly 0."""
    B, H, KV, D = 4, 4, 2, 64
    NP = 2 * run + 1
    P = 3 * NP + 2
    qj, qt, kj, kt, vj, vt = _paged_case(rng, P, ps, NP, B, H, KV, D, dtype)
    pt = np.full((B, NP), -1, np.int32)
    perm = rng.permutation(P)
    for b in range(3):
        pt[b] = perm[b * NP:(b + 1) * NP]
    pt[1, :run] = -1
    if run > 1:
        pt[1, run + 1] = -1
    pos = np.asarray([NP * ps - 1, 2 * run * ps, run * ps - 1, 3], np.int32)
    kw = {"window": dict(window=ps + 3),
          "softcap": dict(softcap=20.0)}.get(mode, {})
    return qj, qt, kj, kt, vj, vt, pt, pos, kw


@pytest.mark.parametrize("mode", ["holes", "window", "softcap"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("run", [1, 2, 8])
@pytest.mark.parametrize("ps", [8, 16, 32])
def test_paged_split_plain_matches_plain_and_pallas(ps, run, dtype, mode):
    """The paged kernel's split (per-run m, l and acc with p rounded to
    the pools' dtype against the run's max, merged in run order), in plain
    PyTorch, against the gathered plain version and the Pallas kernel
    (interpret mode): f32 2e-5, bf16 2e-2; the dead row exactly 0."""
    rng = np.random.default_rng(ps * 10 + run)
    qj, qt, kj, kt, vj, vt, pt, pos, kw = _paged_split_case(
        rng, ps, run, dtype, mode)
    pt_t, pos_t = torch.from_numpy(pt), torch.from_numpy(pos)
    o = da.paged_split_plain(qt, kt, vt, pt_t, pos_t, slots=run * ps, **kw)
    assert o.dtype == qt.dtype and o.shape == qt.shape
    o_plain = da.paged_plain(qt, kt, vt, pt_t, pos_t, **kw)
    o_jax = jax_paged(qj, kj, vj, jnp.asarray(pt), jnp.asarray(pos),
                      interpret=True, **kw)
    assert float((o[:3].float() - o_plain[:3].float()).abs().max()) \
        < tol(dtype)
    assert err(np.asarray(o_jax)[:3], o[:3]) < tol(dtype)
    assert float(o[3].float().abs().max()) == 0.0


def test_paged_split_plain_window_without_a_mapped_page():
    """A row whose window holds no mapped page: the Pallas kernel skips
    every page and writes 0, and so does the split (the gathered oracle
    averages every slot there instead; ROADMAP, reference behaviours)."""
    rng = np.random.default_rng(5)
    P, ps, NP, B, H, KV, D = 12, 8, 6, 2, 4, 2, 64
    qj, qt, kj, kt, vj, vt = _paged_case(rng, P, ps, NP, B, H, KV, D,
                                         "float32")
    pt = np.stack([rng.permutation(P)[:NP] for _ in range(B)]).astype(
        np.int32)
    pt[1, 3:] = -1                       # row 1: pages 3-5 unmapped
    pos = np.asarray([NP * ps - 1, 5 * ps + 3], np.int32)
    kw = dict(window=ps)                 # row 1's window: pages 4 and 5
    o = da.paged_split_plain(qt, kt, vt, torch.from_numpy(pt),
                             torch.from_numpy(pos), slots=2 * ps, **kw)
    o_jax = jax_paged(qj, kj, vj, jnp.asarray(pt), jnp.asarray(pos),
                      interpret=True, **kw)
    assert float(np.abs(np.asarray(o_jax)[1]).max()) == 0.0
    assert float(o[1].abs().max()) == 0.0
    assert err(o_jax, o) < 2e-5


def test_paged_split_holds_the_source_constant():
    """csrc/paged_decode_attention.cu's SLOTS is the wrapper's PAGE_SLOTS,
    and ``paged_split`` gives every page size of the domain a run that
    fits it and wastes less than one page of it, covering NP once; the
    engine's geometry (NP = 128, ps = 16) splits into 16 runs of 8."""
    src = (pathlib.Path(da.__file__).parent / "csrc"
           / "paged_decode_attention.cu").read_text()
    slots = re.findall(r"^constexpr int SLOTS = (\d+);", src, re.M)
    assert slots == [str(da.PAGE_SLOTS)]
    for ps in range(1, da.MAX_PAGE_SIZE + 1):
        for NP in (1, 2, 7, 8, 9, 64, 128, 129):
            pages, splits = da.paged_split(NP, ps)
            assert da.PAGE_SLOTS - ps < pages * ps <= da.PAGE_SLOTS
            assert (splits - 1) * pages < NP <= splits * pages
    assert da.paged_split(128, 16) == (8, 16)


# -- rwkv6 scan and int8 matmul ---------------------------------------------

RWKV_TOL = 5e-4
INT8_REL = 5e-3


def _rwkv_inputs(rng, B, T, H, D, ww_lo=None):
    """r, k, v, w, u, state0 as float32 numpy, as tests/test_kernels.py
    draws them; ``ww_lo`` draws w = exp(-exp(ww)) with ww in [ww_lo, 1.5]
    instead, the range ``rwkv6._projections`` can produce."""
    r, k, v = (rng.standard_normal((B, T, H, D)).astype(np.float32)
               for _ in range(3))
    if ww_lo is None:
        w = rng.uniform(0.2, 0.99, (B, T, H, D)).astype(np.float32)
    else:
        w = np.exp(-np.exp(rng.uniform(ww_lo, 1.5, (B, T, H, D)))).astype(
            np.float32)
    u = rng.standard_normal((H, D)).astype(np.float32)
    s0 = rng.standard_normal((B, H, D, D)).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("B,T,H,D,chunk", [
    (1, 64, 2, 16, 16), (2, 128, 4, 32, 32), (1, 96, 1, 64, 32),
    (1, 40, 2, 16, 64),     # T < chunk: one chunk of 40
])
def test_rwkv6_plain_matches_pallas_interpret(B, T, H, D, chunk):
    """The plain chunked scan against the Pallas kernel (interpret mode)
    and both packages' sequential oracles, at the sweep of
    tests/test_kernels.py: output and final state within 5e-4."""
    a = _rwkv_inputs(np.random.default_rng(17), B, T, H, D)
    o_j, s_j = jax_rwkv(*map(jnp.asarray, a), chunk=chunk, interpret=True)
    o_r, s_r = jax_ref.rwkv6_ref(*map(jnp.asarray, a))
    t = tuple(torch.from_numpy(x) for x in a)
    o_t, s_t = rs.plain(*t, chunk=chunk)
    o_o, s_o = ref.rwkv6_ref(*t)
    assert o_t.dtype == torch.float32 and o_t.shape == (B, T, H, D)
    for jo, js in ((o_j, s_j), (o_r, s_r)):
        assert err(jo, o_t) < RWKV_TOL and err(js, s_t) < RWKV_TOL
    assert err(o_r, o_o) < RWKV_TOL and err(s_r, s_o) < RWKV_TOL
    o_d, s_d = ops.rwkv6_scan(*t, chunk=chunk)      # CPU tensors -> plain
    assert torch.equal(o_d, o_t) and torch.equal(s_d, s_t)


def test_rwkv6_ragged_tail_split_matches_oracle():
    """T = 100 at chunk 32, split as timemix_parallel splits it: the 96
    whole-chunk rows in one call, then the 4-row tail as its own chunk,
    carrying the state; against the sequential oracle."""
    a = _rwkv_inputs(np.random.default_rng(19), 2, 100, 2, 32)
    t = tuple(torch.from_numpy(x) for x in a)
    r, k, v, w, u, s0 = t
    o1, s1 = rs.plain(r[:, :96], k[:, :96], v[:, :96], w[:, :96], u, s0,
                      chunk=32)
    o2, s2 = rs.plain(r[:, 96:], k[:, 96:], v[:, 96:], w[:, 96:], u, s1,
                      chunk=4)
    o_r, s_r = jax_ref.rwkv6_ref(*map(jnp.asarray, a))
    assert err(o_r, torch.cat([o1, o2], 1)) < RWKV_TOL
    assert err(s_r, s2) < RWKV_TOL
    with pytest.raises(ValueError, match="multiple"):
        rs.plain(*t, chunk=32)


def test_rwkv6_plain_matches_pallas_at_the_decay_floor():
    """Decays down to exp(-e^1.5) at chunk 64, where the cumulative decay
    underflows inside a chunk: the plain version follows the Pallas
    kernel's arithmetic (the 1e-24 clamp) there too."""
    a = _rwkv_inputs(np.random.default_rng(23), 1, 128, 2, 16, ww_lo=-6.0)
    o_j, s_j = jax_rwkv(*map(jnp.asarray, a), chunk=64, interpret=True)
    o_t, s_t = rs.plain(*(torch.from_numpy(x) for x in a), chunk=64)
    assert torch.isfinite(o_t).all() and torch.isfinite(s_t).all()
    assert err(o_j, o_t) < RWKV_TOL and err(s_j, s_t) < RWKV_TOL


# the scan's split over value columns: a pure rule of (B, H, D)

def test_rwkv6_split_of_the_timed_shape():
    """rwkv6-7b's prefill (B=1, H=64, D=64): 32 value columns a CTA, 128
    CTAs, within the H100's 132 SMs; B=2 splits the same way."""
    assert rs.split(1, 64, 64) == 32
    assert 64 * (64 // rs.split(1, 64, 64)) <= 132
    assert rs.split(2, 64, 64) == 32


@pytest.mark.parametrize("D", rs.HEAD_DIMS)
def test_rwkv6_split_domain_is_whole(D):
    """Every head dim and B x H from 1 to 512 gets a plan: a DV of at
    least one 16-column mma tile that divides D, the same for every B
    and H; no other head dim, and no empty batch, has one."""
    sizes = {1, 2, 3, 8, 33, 64, 65, 128, 132, 133, 256, 264, 512}
    plans = set()
    for BH in sorted(sizes):
        for B, H in {(1, BH), (BH, 1)} | ({(2, BH // 2)} if BH % 2 == 0
                                          else set()):
            plans.add(rs.split(B, H, D))
    (dv,) = plans
    assert dv % 16 == 0 and D % dv == 0
    for bad in ((1, 64, 48), (0, 64, D), (1, 0, D)):
        with pytest.raises(ValueError, match="no split"):
            rs.split(*bad)


def test_rwkv6_aligned_rule():
    """TMA loads where every row of r, k, v, w starts on 16 bytes: the
    contiguous tensors and timemix_parallel's T slices, not a view 4
    bytes off; a size-1 dim's stride does not count."""
    r = torch.zeros((2, 100, 2, 32))
    assert rs.aligned(r, r, r, r)
    assert rs.aligned(*(r[:, 96:] for _ in range(4)))
    off = torch.zeros(r.numel() + 1)[1:].view(r.shape)
    assert not rs.aligned(off, r, r, r)
    odd = torch.zeros((1, 3, 5, 16)).as_strided((1, 3, 2, 16),
                                                (7, 80, 16, 1))
    assert rs.aligned(odd, odd, odd, odd)        # B = 1: stride 7 unused
    assert not rs.aligned(*(torch.zeros(200).as_strided(
        (2, 3, 2, 16), (97, 32, 16, 1)) for _ in range(4)))


def test_rwkv6_split_reaches_every_instance():
    """The (D, DV) instances csrc/rwkv6_scan.cu launches are exactly the
    ones ``split`` picks: none unreached, none missing."""
    src = (pathlib.Path(rs.__file__).parent / "csrc" / "rwkv6_scan.cu"
           ).read_text()
    cases = {(int(d), int(dv)) for d, dv in
             re.findall(r"^\s*RWKV6_CASE\((\d+), (\d+)\)$", src, re.M)}
    assert cases == {(D, rs.split(1, 1, D)) for D in rs.HEAD_DIMS}


def _rel(ref_out, out) -> float:
    a = np.asarray(jnp.asarray(ref_out, jnp.float32))
    return float(np.abs(a - out.float().numpy()).max() / np.abs(a).max())


@pytest.mark.parametrize("M,K,N", [(64, 128, 64), (32, 256, 128),
                                   (5, 96, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_plain_matches_pallas_interpret(M, K, N, dtype):
    """The plain W8A16 product against the Pallas kernel (interpret mode,
    which rounds x to bf16 as the port does) and the oracle
    ``int8_matmul_ref`` (which does not), within 5e-3 relative.  The
    ragged (5, 96, 40) case runs the Pallas kernel with whole blocks."""
    rng = np.random.default_rng(29)
    x = rng.standard_normal((M, K)).astype(np.float32)
    wq = rng.integers(-127, 127, (K, N)).astype(np.int8)
    ws = rng.uniform(0.001, 0.01, (N,)).astype(np.float32)
    xj, xt = both(x, dtype)
    o_t = im.plain(xt, torch.from_numpy(wq), torch.from_numpy(ws))
    assert o_t.dtype == DTYPES[dtype][1] and o_t.shape == (M, N)
    blocks = dict(block_m=32, block_n=64, block_k=64) if M % 32 == 0 \
        else dict(block_m=M, block_n=N, block_k=K)
    o_p = jax_int8(xj, jnp.asarray(wq), jnp.asarray(ws), interpret=True,
                   **blocks)
    o_r = jax_ref.int8_matmul_ref(xj, jnp.asarray(wq), jnp.asarray(ws))
    assert _rel(o_p, o_t) < INT8_REL and _rel(o_r, o_t) < INT8_REL
    o_o = ref.int8_matmul_ref(xt, torch.from_numpy(wq), torch.from_numpy(ws))
    assert _rel(o_r, o_o) < INT8_REL
    assert torch.equal(ops.int8_matmul(xt, torch.from_numpy(wq),
                                       torch.from_numpy(ws)), o_t)
    x3 = xt.reshape(1, M, K)                       # leading dims kept
    assert im.plain(x3, torch.from_numpy(wq),
                    torch.from_numpy(ws)).shape == (1, M, N)



# the kernel's route and split plan: pure rules of shape, dtype, alignment

@pytest.mark.parametrize("M,K,N,want", [(4, 4096, 14336, "splitk"),
                                        (4, 14336, 4096, "splitk"),
                                        (1536, 4096, 14336, "wgmma"),
                                        (1536, 14336, 4096, "wgmma")])
def test_int8_route_of_the_timed_shapes(M, K, N, want):
    """chip_smoke's timed shapes (rwkv6-7b's channel-mix wk and wv at
    decode and prefill M) take the designs made for them."""
    assert im.route(M, N, K, torch.bfloat16, True) == want


@pytest.mark.parametrize("M", [1, 4, 16, 32, 33, 200, 1536])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_route_domain_is_whole(M, dtype):
    """Every (dtype, alignment, ragged N / K) has a route, so the kernel
    takes every shape it took before; the fast routes only where their
    TMA copies are legal, and wgmma only for bf16 x above the split-K
    limit."""
    for N in (16, 17, 70, 4096, 4104, 4112):
        for K in (1, 8, 33, 4096, 4100, 4104):
            for aligned in (True, False):
                r = im.route(M, N, K, dtype, aligned)
                assert r in im.ROUTES
                if not aligned or N % 16:
                    assert r == "general"
                elif M <= im.SPLITK_MAX_M:
                    assert r == "splitk"
                elif dtype == torch.bfloat16 and K % 8 == 0:
                    assert r == "wgmma"
                else:
                    assert r == "general"


@pytest.mark.parametrize("M", [1, 4, 8, 9, 16, 17, 32])
@pytest.mark.parametrize("N,K", [(16, 1), (16, 63), (4096, 64), (4112, 4104),
                                 (14336, 4096), (4096, 14336),
                                 (128, 100000)])
def test_int8_split_plan_covers_k_once_in_order(M, N, K):
    """Split s takes K rows [s chunk, min(K, (s + 1) chunk)): together
    they cover K once, in order, with no empty split; chunk is whole
    64-row stages and x's slice fits its shared memory."""
    splits, chunk = im.split_plan(M, N, K)
    spans = [(s * chunk, min(K, (s + 1) * chunk)) for s in range(splits)]
    assert spans[0][0] == 0 and spans[-1][1] == K
    assert all(lo < hi for lo, hi in spans)
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert chunk % im.SK_BK == 0 and 1 <= splits <= 65535
    rows = 8 if M <= 8 else 16 if M <= 16 else 32
    assert rows * (2 * chunk + im.SK_XPAD) <= im.SK_X_BYTES
    # one wave at four CTAs a SM, unless x's slice caps the chunk
    cols = -(-N // im.SK_BN)
    if chunk < (im.SK_X_BYTES // rows - im.SK_XPAD) // 2 - im.SK_BK:
        assert cols * splits <= max(cols, im.SK_CTAS_PER_SM * im.SM_COUNT)


def test_int8_route_counts_start_at_zero():
    """A per-route launch count sits beside the total; CPU calls take
    the plain version and count nothing."""
    assert set(im.int8_matmul.routes) == set(im.ROUTES)
    x = torch.zeros((2, 16))
    wq = torch.ones((16, 32), dtype=torch.int8)
    assert torch.equal(ops.int8_matmul(x, wq, torch.ones(32)),
                       torch.full((2, 32), 0.0))
    assert sum(im.int8_matmul.routes.values()) == 0


# -- dispatch ---------------------------------------------------------------

def test_kernels_refuse_cpu_tensors():
    """The kernel wrappers launch on CUDA tensors or raise; they never
    fall back to the plain version themselves."""
    q = torch.zeros((1, 64, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, k)
    pool = torch.zeros((4, 16, 2, 64), dtype=torch.bfloat16)
    pt = torch.zeros((1, 2), dtype=torch.int32)
    pos = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        da.paged_decode_attention(q[:, :1], pool, pool, pt, pos)
    cache = torch.zeros((1, 16, 2, 64), dtype=torch.bfloat16)
    ap = torch.zeros((1, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention(q[:, :1], cache, cache, ap, pos)
    toks = torch.zeros((2,), dtype=torch.int32)
    probs = torch.full((3, 8), 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        sv.spec_accept(toks, probs[:2], probs, torch.zeros(2))
    r = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        rs.rwkv6_scan(r, r, r, r, torch.zeros((2, 16)),
                      torch.zeros((1, 2, 16, 16)), chunk=8)
    with pytest.raises(ValueError, match="CUDA"):
        im.int8_matmul(torch.zeros((2, 8)), torch.zeros((8, 4),
                                                        dtype=torch.int8),
                       torch.ones(4))
    assert fa.flash_attention.launches == 0
    assert da.paged_decode_attention.launches == 0
    assert da.decode_attention.launches == 0
    assert sv.spec_accept.launches == 0
    assert rs.rwkv6_scan.launches == 0
    assert im.int8_matmul.launches == 0


def test_ops_dispatch_cpu_to_plain_and_domain():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 32, 4, 16),
                                             dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 32, 2, 16),
                                             dtype=np.float32))
    assert torch.equal(ops.attention_causal(q, k, k),
                       fa.plain(q, k, k, causal=True))
    assert torch.equal(ops.attention_windowed(q, k, k, window=8),
                       fa.plain(q, k, k, window=8))
    # the reference's prompt-length domain: > 512 must be a multiple
    ops.check_domain(37, 511, 512, 1024, 1536)
    for bad in (513, 700, 1000):
        with pytest.raises(ValueError, match="domain"):
            ops.check_domain(bad)
    long_q = torch.zeros((1, 700, 4, 16))
    with pytest.raises(ValueError, match="domain"):
        ops.attention_causal(long_q, long_q[:, :, :2], long_q[:, :, :2])
    with pytest.raises(ValueError):
        ops.set_backend("pallas")
    ops.set_backend("ref")               # forces the plain version
    try:
        assert torch.equal(ops.attention_causal(q, k, k),
                           fa.plain(q, k, k, causal=True))
    finally:
        ops.set_backend(None)


def test_launch_counts_exact_under_threads():
    """Every wrapper counts its launches through ``build.count_launch``,
    one lock for all: eight threads counting at once (as engine
    services launch from their own threads) lose no count, on a stub
    and on int8_matmul's per-route table."""
    import os
    import sys
    import threading

    from repro_torch.kernels import build

    def stub():
        pass
    stub.launches = 0
    stub.routes = {"a": 0, "b": 0}
    n, threads = 5_000, 2 * ((os.cpu_count() or 4) // 2 + 2)
    barrier = threading.Barrier(threads)

    def count(i):
        barrier.wait()
        for _ in range(n):
            build.count_launch(stub, "ab"[i % 2])
    ts = [threading.Thread(target=count, args=(i,)) for i in range(threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)          # switch threads as often as it can
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert stub.launches == n * threads
    assert stub.routes == {"a": n * threads // 2, "b": n * threads // 2}
    # each wrapper's source counts through the lock, not ``+= 1``
    for mod in (fa, da, sv, rs, im):
        src = pathlib.Path(mod.__file__).read_text()
        assert "launches += 1" not in src, mod.__name__
        assert "build.count_launch(" in src, mod.__name__
