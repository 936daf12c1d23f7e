"""The port's CUDA kernels against their plain PyTorch versions.

These need the card (and nvcc, which builds the kernels at first use);
they carry the ``cuda`` marker and skip without one.  The module imports
neither JAX nor ``repro``, so it runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py

Tolerances as in the reference kernel tests: bf16 2e-2 abs, f32 2e-5 abs;
``spec_accept``: n exactly, dist 1e-6 abs; ``rwkv6_scan``: 5e-4 abs on
output and state; ``int8_matmul``: 5e-3 relative to the largest |plain|.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import int8_matmul as im  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rs  # noqa: E402
from repro_torch.kernels import spec_verify as sv  # noqa: E402

MODES = {"causal": dict(causal=True), "window": dict(causal=True, window=48),
         "full": dict(causal=False),
         "softcap": dict(causal=True, softcap=20.0)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run on the card, see "
                    "README 'PyTorch / H100 port')")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S", [37, 64, 128, 129, 200, 512, 1024, 2048])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("D,H,KV", [(128, 16, 8), (64, 8, 2)])
def test_flash_kernel_matches_plain(cuda, S, mode, D, H, KV):
    """Every mode at the engine's prompt lengths and the edges of the
    128-row query and key tiles."""
    gen = torch.Generator(cuda).manual_seed(S)
    q, k, v = (torch.randn((2, S, n, D), generator=gen, device=cuda,
                           dtype=torch.bfloat16) for n in (H, KV, KV))
    kw = MODES[mode]
    o = fa.flash_attention(q, k, v, **kw)
    assert float((o.float() - fa.plain(q, k, v, **kw).float()).abs().max()) \
        < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
def test_flash_kernel_is_deterministic(cuda, mode):
    """No split of a row's keys across CTAs, no atomics: the same inputs
    give the same bits."""
    gen = torch.Generator(cuda).manual_seed(1)
    q, k, v = (torch.randn((1, 1536, n, 128), generator=gen, device=cuda,
                           dtype=torch.bfloat16) for n in (16, 8, 8))
    kw = MODES[mode]
    assert torch.equal(fa.flash_attention(q, k, v, **kw),
                       fa.flash_attention(q, k, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernel_reads_strided_views(cuda, D):
    """q, k, v as head slices of one fused (B, S, H + 2 KV, D) tensor are
    read in place through their strides."""
    gen = torch.Generator(cuda).manual_seed(D)
    H, KV = 8, 2
    qkv = torch.randn((2, 300, H + 2 * KV, D), generator=gen, device=cuda,
                      dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    assert not q.is_contiguous()
    o = fa.flash_attention(q, k, v)
    ref = fa.plain(q.contiguous(), k.contiguous(), v.contiguous())
    assert float((o.float() - ref.float()).abs().max()) < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["plain", "window", "softcap"])
def test_paged_kernel_matches_plain(cuda, dtype, mode):
    rng = np.random.default_rng(1)
    P, ps, NP, B, H, KV, D = 64, 16, 16, 4, 16, 8, 128
    gen = torch.Generator(cuda).manual_seed(0)
    q = torch.randn((B, 1, H, D), generator=gen, device=cuda, dtype=dtype)
    kp, vp = (torch.randn((P, ps, KV, D), generator=gen, device=cuda,
                          dtype=dtype) for _ in range(2))
    pt = np.full((B, NP), -1, np.int32)
    pos = np.asarray([NP * ps - 1, 20, 5, 100], np.int32)   # row 3: dead
    for b in range(B - 1):
        n = int(rng.integers(1, NP + 1))
        pt[b, :n] = rng.choice(P, n, replace=False)
        # inside the mapped pages: a window holding no mapped page is
        # where the oracle and the TPU kernel disagree (ROADMAP)
        pos[b] = min(pos[b], n * ps - 1)
    pt_t, pos_t = torch.from_numpy(pt).to(cuda), torch.from_numpy(pos).to(cuda)
    kw = {"window": dict(window=40),
          "softcap": dict(softcap=20.0)}.get(mode, {})
    o = da.paged_decode_attention(q, kp, vp, pt_t, pos_t, **kw)
    o_ref = da.paged_plain(q, kp, vp, pt_t, pos_t, **kw)
    t = 2e-2 if dtype == torch.bfloat16 else 2e-5
    assert float((o.float() - o_ref.float()).abs().max()) < t
    _hold_rows(o, o_ref, slice(0, B - 1))
    assert float(o[B - 1].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("D,H,KV,ps", [(64, 8, 2, 8), (128, 16, 2, 32)])
def test_paged_kernel_other_geometries(cuda, D, H, KV, ps):
    rng = np.random.default_rng(2)
    P, NP, B = 40, 6, 3
    gen = torch.Generator(cuda).manual_seed(1)
    q = torch.randn((B, 1, H, D), generator=gen, device=cuda,
                    dtype=torch.bfloat16)
    kp, vp = (torch.randn((P, ps, KV, D), generator=gen, device=cuda,
                          dtype=torch.bfloat16) for _ in range(2))
    pt = np.stack([rng.choice(P, NP, replace=False) for _ in range(B)])
    pt[1, 2] = -1                                    # a hole mid-row
    pos = np.asarray([NP * ps - 1, 3 * ps + 1, 0], np.int32)
    pt_t = torch.from_numpy(pt.astype(np.int32)).to(cuda)
    pos_t = torch.from_numpy(pos).to(cuda)
    o = da.paged_decode_attention(q, kp, vp, pt_t, pos_t)
    o_ref = da.paged_plain(q, kp, vp, pt_t, pos_t)
    assert float((o.float() - o_ref.float()).abs().max()) < 2e-2
    _hold_rows(o, o_ref, slice(0, B))


def _hold_rows(o, want, rows):
    """Each row of ``rows`` within its limit: 4 bf16 ulps of the row's
    max |want| (at most 2e-2) in bf16, 2e-5 in f32.  On a long row the
    output averages many V rows and is small, so a flat 2e-2 would hide a
    dropped page there."""
    ref = want[rows].float()
    if want.dtype == torch.bfloat16:
        top = ref.abs().flatten(1).amax(1).clamp(min=1e-30)
        lim = torch.clamp(4 * torch.exp2(torch.floor(torch.log2(top)) - 7),
                          max=2e-2)
    else:
        lim = torch.full((ref.shape[0],), 2e-5, device=ref.device)
    e = (o[rows].float() - ref).abs().flatten(1).amax(1)
    assert bool((e <= lim).all()), (e.tolist(), lim.tolist())


def _hold_query_rows(o, want):
    """``_hold_rows`` on a flash output (B, S, H, D), one row a query: in
    full mode over 1536 keys an output row is about 0.04 in size, where
    a flat 2e-2 would hide a dropped key block."""
    _hold_rows(o.flatten(0, 1), want.flatten(0, 1), slice(None))


def _paged_pools(cuda, B, P, ps, KV, H, D, dtype, seed):
    """(q, k_pool, v_pool) on the card."""
    gen = torch.Generator(cuda).manual_seed(seed)
    q = torch.randn((B, 1, H, D), generator=gen, device=cuda, dtype=dtype)
    kp, vp = (torch.randn((P, ps, KV, D), generator=gen, device=cuda,
                          dtype=dtype) for _ in range(2))
    return q, kp, vp


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_is_deterministic_and_rows_independent(cuda, dtype):
    """Split over pages, combined in split order with no atomics: two
    calls give the same bits at the engine's geometry, and row 0 does not
    move when another row's table and position change."""
    B, H, KV, D, ps, NP, P = 4, 16, 8, 128, 16, 128, 512
    q, kp, vp = _paged_pools(cuda, B, P, ps, KV, H, D, dtype, 3)
    rng = np.random.default_rng(3)
    pt = torch.from_numpy(np.stack([rng.permutation(P)[:NP]
                                    for _ in range(B)]).astype(np.int32))
    pt = pt.to(cuda)
    pos = torch.tensor([1000, 990, 1010, 1005], device=cuda,
                       dtype=torch.int32)
    o = da.paged_decode_attention(q, kp, vp, pt, pos)
    assert torch.equal(o, da.paged_decode_attention(q, kp, vp, pt, pos))
    pt2, pos2 = pt.clone(), pos.clone()
    pt2[1:] = pt2[1:].flip(1)
    pos2[1:] = torch.tensor([2047, 7, 300], device=cuda, dtype=torch.int32)
    o2 = da.paged_decode_attention(q, kp, vp, pt2, pos2)
    assert torch.equal(o[0], o2[0])
    assert not torch.equal(o[1:], o2[1:])


# (page size, NP): a run of max(1, 128 // ps) pages a CTA; NP is not a
# multiple of the run, so each row's last run is short
PAGED_GEOMETRIES = {"ps1": (1, 300), "ps3": (3, 100), "ps8": (8, 37),
                    "ps16": (16, 20), "ps32": (32, 10)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*PAGED_GEOMETRIES, "one_page", "g8_f32"])
def test_paged_kernel_at_every_split_geometry(cuda, case):
    """Every page size's run, against the gathered plain version and the
    split arithmetic, each row within its limit.  Rows decode at the last
    slot of the table, the last slot of the first run and the first slot
    of the second; ``one_page`` maps one page a row (mid-table, the
    first, the last); row 3 maps nothing and must be exactly 0."""
    B, H, KV, D, dtype = 4, 16, 8, 128, torch.bfloat16
    ps, NP = PAGED_GEOMETRIES.get(case, (16, 20))
    if case == "g8_f32":
        KV, dtype = 2, torch.float32
    pages, splits = da.paged_split(NP, ps)
    assert splits > 1 and NP % pages
    P = 3 * NP + 1
    q, kp, vp = _paged_pools(cuda, B, P, ps, KV, H, D, dtype, NP * ps)
    rng = np.random.default_rng(ps)
    pt = np.full((B, NP), -1, np.int32)
    perm = rng.permutation(P)
    if case == "one_page":
        for b, j in ((0, 5), (1, 0), (2, NP - 1)):
            pt[b, j] = perm[b]
        pos = np.asarray([5 * ps + 7, 0, NP * ps - 1, 40], np.int32)
    else:
        for b in range(3):
            pt[b] = perm[b * NP:(b + 1) * NP]
        pos = np.asarray([NP * ps - 1, pages * ps - 1, pages * ps, 40],
                         np.int32)
    pt_t, pos_t = torch.from_numpy(pt).to(cuda), torch.from_numpy(pos).to(cuda)
    o = da.paged_decode_attention(q, kp, vp, pt_t, pos_t)
    for want in (da.paged_plain(q, kp, vp, pt_t, pos_t),
                 da.paged_split_plain(q, kp, vp, pt_t, pos_t)):
        _hold_rows(o, want, slice(0, 3))
    assert float(o[3].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["unmapped", "window"])
def test_paged_kernel_with_only_the_last_split_live(cuda, mode):
    """Every split of a row but the last holds no valid slot: its pages
    are unmapped, or lie outside the window.  The combine skips the dead
    splits' partials; row 3 maps nothing and must be exactly 0."""
    B, H, KV, D, ps, NP = 4, 16, 8, 128, 16, 20      # runs of 8, 8 and 4
    P = 3 * NP
    q, kp, vp = _paged_pools(cuda, B, P, ps, KV, H, D, torch.bfloat16, 7)
    rng = np.random.default_rng(7)
    pt = np.full((B, NP), -1, np.int32)
    perm = rng.permutation(P)
    for b in range(3):
        pt[b] = perm[b * NP:(b + 1) * NP]
    if mode == "unmapped":
        pt[:3, :16] = -1
        kw, first = {}, 16 * ps               # row 1: the run's first slot
    else:
        kw, first = dict(window=2 * ps), 18 * ps - 1
    pos = np.asarray([NP * ps - 1, first, 18 * ps + 5, 100], np.int32)
    pt_t, pos_t = torch.from_numpy(pt).to(cuda), torch.from_numpy(pos).to(cuda)
    o = da.paged_decode_attention(q, kp, vp, pt_t, pos_t, **kw)
    for want in (da.paged_plain(q, kp, vp, pt_t, pos_t, **kw),
                 da.paged_split_plain(q, kp, vp, pt_t, pos_t, **kw)):
        _hold_rows(o, want, slice(0, 3))
    assert float(o[3].abs().max()) == 0.0


@pytest.mark.cuda
def test_dispatch_and_refusals_on_the_card(cuda):
    q = torch.randn((1, 64, 8, 64), device=cuda, dtype=torch.bfloat16)
    k = torch.randn((1, 64, 2, 64), device=cuda, dtype=torch.bfloat16)
    n = fa.flash_attention.launches
    ops.attention_causal(q, k, k)
    assert fa.flash_attention.launches == n + 1      # CUDA -> kernel
    ops.set_backend("ref")
    try:
        ops.attention_causal(q, k, k)
    finally:
        ops.set_backend(None)
    assert fa.flash_attention.launches == n + 1      # "ref" -> plain
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(q.float(), k.float(), k.float())
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                           k[..., :32].contiguous())
    pool = torch.zeros((4, 16, 2, 64), device=cuda, dtype=torch.bfloat16)
    pt = torch.zeros((1, 2), device=cuda, dtype=torch.int32)
    pos = torch.zeros((1,), device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous"):
        da.paged_decode_attention(q[:, :1], pool.transpose(1, 2), pool, pt,
                                  pos)
    with pytest.raises(ValueError, match="int32"):
        da.paged_decode_attention(q[:, :1], pool, pool, pt.long(), pos)
    # an empty page table maps no page: exactly 0, as the plain version
    o = da.paged_decode_attention(q[:, :1], pool, pool, pt[:, :0], pos)
    assert float(o.abs().max()) == 0.0
    assert float(da.paged_plain(q[:, :1], pool, pool, pt[:, :0],
                                pos).abs().max()) == 0.0


@pytest.mark.cuda
def test_tiny_engine_on_the_card_runs_both_kernels(cuda):
    """A narrow llama (head dim 64) served on the card: every prefill
    and decode step goes through the kernels, and the ledger holds."""
    from repro_torch.configs import get
    from repro_torch.configs.tiny import make_tiny
    from repro_torch.models.init import init_params
    from repro_torch.serving.engine import Request
    from repro_torch.serving.paged import PagedEngine
    cfg = make_tiny(get("llama-1.5b"), d_model=256)
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    eng = PagedEngine(cfg, params, page_size=16, rows=2, max_len=128,
                      device=cuda)
    f0 = fa.flash_attention.launches
    d0 = da.paged_decode_attention.launches
    reqs = [Request(f"r{i}", np.arange(2, 30 + 7 * i) % 500,
                    max_new_tokens=6, temperature=0.8 * i)
            for i in range(3)]
    pending = list(reqs)
    steps = 0
    while pending or eng.requests:
        while pending and eng.add_request(pending[0]):
            pending.pop(0)
        eng.step()
        eng.check()
        steps += 1
    assert all(len(r.output) == 6 for r in reqs)
    assert eng.allocator.free_pages == eng.pages
    assert fa.flash_attention.launches - f0 == cfg.num_layers * 3
    assert da.paged_decode_attention.launches - d0 == cfg.num_layers * steps


@pytest.mark.cuda
@pytest.mark.parametrize("rows,max_len", [(2, 128), (3, 48)])
def test_tiny_engine_prefix_cache_on_the_card(cuda, rows, max_len):
    """Warm admissions on the card (head dim 64): a full hit runs no
    kernel and decodes the cold donor's tokens bit for bit; a partial
    hit's suffix launches the paged kernel once a layer a token, in row 1,
    whose page-table slice need not be 16-byte aligned (48 / 16 = 3 pages
    a row); the shared pages are never written; the ledger holds."""
    from repro_torch.configs import get
    from repro_torch.configs.tiny import make_tiny
    from repro_torch.models.init import init_params
    from repro_torch.serving.engine import Request
    from repro_torch.serving.paged import PagedEngine
    cfg = make_tiny(get("llama-1.5b"), d_model=256)
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    eng = PagedEngine(cfg, params, page_size=16, rows=rows,
                      max_len=max_len, device=cuda, prefix_cache=True)
    donor = np.arange(2, 23)             # 1 full page + a 5-token tail
    part = np.concatenate([donor[:16], np.arange(100, 107)])

    def serve(rid, prompt):
        req = Request(rid, prompt, max_new_tokens=6)
        assert eng.add_request(req)
        hit = eng.last_prefix_hit
        while eng.requests:
            eng.step()
        eng.check()
        return req.output, hit

    cold, hit = serve("cold", donor)
    assert hit == 0
    cache = eng.prefix_cache
    shared = [n.page for n in cache.nodes.values()] \
        + [n.page for v in cache.tails.values() for n in v]
    kept = [layer["attn"][n][:, shared].clone() for grp in eng.state.caches
            for layer in grp for n in ("k_pool", "v_pool")]
    f0 = fa.flash_attention.launches
    d0 = da.paged_decode_attention.launches
    warm, hit = serve("warm", donor)
    assert hit == len(donor) and warm == cold
    assert fa.flash_attention.launches == f0
    assert da.paged_decode_attention.launches - d0 == cfg.num_layers * 6
    # a filler in row 0, so the partial hit's row is row 1
    assert eng.add_request(Request("filler", np.arange(200, 210),
                                   max_new_tokens=12))
    f0 = fa.flash_attention.launches
    d0 = da.paged_decode_attention.launches
    out, hit = serve("part", part)
    assert hit == 16 and len(out) == 6
    assert fa.flash_attention.launches == f0
    assert da.paged_decode_attention.launches - d0 \
        == cfg.num_layers * (len(part) - 16 + 12)
    now = [layer["attn"][n][:, shared] for grp in eng.state.caches
           for layer in grp for n in ("k_pool", "v_pool")]
    assert all(torch.equal(a, b) for a, b in zip(kept, now))
    assert eng.allocator.used_pages == cache.pages_held


def _dense(cuda, B, Sc, KV, D, dtype, seed):
    gen = torch.Generator(cuda).manual_seed(seed)
    return (torch.randn((B, Sc, KV, D), generator=gen, device=cuda,
                        dtype=dtype) for _ in range(2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["fill", "window", "softcap"])
@pytest.mark.parametrize("D,H,KV", [(128, 16, 8), (64, 8, 1)])
def test_dense_decode_kernel_matches_plain(cuda, dtype, mode, D, H, KV):
    """Fill levels with rolled-back slots past the position, a ring
    buffer, a softcap; row 3 has no valid slot and must be exactly 0."""
    B, Sc = 4, 256
    slot = np.arange(Sc)[None]
    if mode == "window":
        W = 64
        pos = np.asarray([300, 63, 10, 5], np.int32)
        p = pos[:, None] - ((pos[:, None] - slot[:, :W]) % W)
        ap = np.where(p >= 0, p, -1).astype(np.int32)
        kw, Sc = dict(window=W), W
    else:
        fill = np.asarray([1, 37, 256, 0])
        held = np.minimum(fill + 5, Sc)
        held[3] = 0
        ap = np.where(slot < held[:, None], slot, -1).astype(np.int32)
        pos = np.asarray([0, 36, 255, 9], np.int32)
        kw = dict(softcap=20.0) if mode == "softcap" else {}
    ap[3] = -1
    kc, vc = _dense(cuda, B, Sc, KV, D, dtype, D + Sc)
    q = torch.randn((B, 1, H, D), device=cuda, dtype=dtype)
    ap_t, pos_t = (torch.from_numpy(a).to(cuda) for a in (ap, pos))
    o = da.decode_attention(q, kc, vc, ap_t, pos_t, **kw)
    o_ref = da.plain(q, kc, vc, ap_t, pos_t, **kw)
    t = 2e-2 if dtype == torch.bfloat16 else 2e-5
    assert float((o[:3].float() - o_ref[:3].float()).abs().max()) < t
    assert float(o[3].abs().max()) == 0.0


def _decode_rows(cuda, B, Sc, KV, H, D, dtype, seed):
    """q and caches on the card: (q, k_cache, v_cache)."""
    gen = torch.Generator(cuda).manual_seed(seed)
    q = torch.randn((B, 1, H, D), generator=gen, device=cuda, dtype=dtype)
    return (q, *_dense(cuda, B, Sc, KV, D, dtype, seed + 1))


def _global_ap(cuda, Sc, pos):
    """abs_pos of a global cache filled up to each row's position."""
    slot = torch.arange(Sc, device=cuda, dtype=torch.int32)[None]
    return torch.where(slot <= pos[:, None], slot, -1).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["chunk_last", "chunk_first", "ragged_sc",
                                  "ring_256", "g8_f32"])
def test_dense_decode_split_edges(cuda, case):
    """Positions on the last slot of a chunk and the first of the next, a
    cache length that is not a multiple of the chunk, a 256-slot window
    ring, and G=8 in f32; row 3 has no valid slot and must be exactly 0.
    Held per row to 4 bf16 ulps of the row's max |ref| (bf16) or 2e-5
    (f32), and to the plain split arithmetic at the same tolerance."""
    C = da.CHUNK
    B, H, KV, D, Sc, dtype, kw = 4, 16, 8, 128, 2048, torch.bfloat16, {}
    if case == "chunk_last":
        pos = [C - 1, 2 * C - 1, 5 * C - 1, 0]
    elif case == "chunk_first":
        pos = [C, 2 * C, 7 * C, 0]
    elif case == "ragged_sc":
        Sc, pos = 3 * C + 44, [3 * C + 43, 3 * C, C + 5, 0]
    elif case == "ring_256":
        Sc, kw, pos = 256, dict(window=256), [700, 1000, 100, 0]
    else:
        H, KV, dtype, pos = 16, 2, torch.float32, [C - 1, C, 1500, 0]
    q, kc, vc = _decode_rows(cuda, B, Sc, KV, H, D, dtype, Sc)
    pos_t = torch.tensor(pos, device=cuda, dtype=torch.int32)
    if case == "ring_256":
        slot = torch.arange(Sc, device=cuda)[None]
        p = pos_t[:, None] - ((pos_t[:, None] - slot) % Sc)
        ap = torch.where(p >= 0, p, -1).to(torch.int32)
    else:
        ap = _global_ap(cuda, Sc, pos_t)
    ap[3] = -1                                        # the empty row
    o = da.decode_attention(q, kc, vc, ap, pos_t, **kw)
    ref = da.plain(q, kc, vc, ap, pos_t, **kw)
    split = da.split_plain(q, kc, vc, ap, pos_t, **kw)
    if dtype == torch.bfloat16:
        top = ref[:3].float().abs().flatten(1).amax(1)
        tol = 4 * torch.exp2(torch.floor(torch.log2(top)) - 7)
    else:
        tol = torch.full((3,), 2e-5, device=cuda)
    for want in (ref, split):
        e = (o[:3].float() - want[:3].float()).abs().flatten(1).amax(1)
        assert bool((e <= tol).all()), (case, e.tolist(), tol.tolist())
    assert float(o[3].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_decode_is_deterministic_and_rows_independent(cuda, dtype):
    """Fixed-order combine with no atomics: two calls give the same bits,
    and row 0's output does not move when another row's cache and
    position change."""
    B, H, KV, D, Sc = 4, 16, 8, 128, 2048
    q, kc, vc = _decode_rows(cuda, B, Sc, KV, H, D, dtype, 5)
    pos = torch.tensor([60, 530, 1050, 1560], device=cuda, dtype=torch.int32)
    ap = _global_ap(cuda, Sc, pos)
    o = da.decode_attention(q, kc, vc, ap, pos)
    assert torch.equal(o, da.decode_attention(q, kc, vc, ap, pos))
    kc2, vc2, ap2, pos2 = kc.clone(), vc.clone(), ap.clone(), pos.clone()
    kc2[1:] = torch.randn_like(kc2[1:])
    vc2[2] *= 3
    pos2[1:] = torch.tensor([2047, 7, 300], device=cuda, dtype=torch.int32)
    ap2[1:] = _global_ap(cuda, Sc, pos2)[1:]
    o2 = da.decode_attention(q, kc2, vc2, ap2, pos2)
    assert torch.equal(o[0], o2[0])
    assert not torch.equal(o[1:], o2[1:])


@pytest.mark.cuda
def test_dense_decode_refusals_and_dispatch(cuda):
    B, Sc, KV, D = 2, 64, 2, 64
    kc, vc = _dense(cuda, B, Sc, KV, D, torch.bfloat16, 0)
    q = torch.randn((B, 1, 8, D), device=cuda, dtype=torch.bfloat16)
    ap = torch.arange(Sc, device=cuda, dtype=torch.int32)[None].repeat(B, 1)
    pos = torch.tensor([10, 63], device=cuda, dtype=torch.int32)
    n = da.decode_attention.launches
    ops.decode_attention(q, kc, vc, ap, pos)
    assert da.decode_attention.launches == n + 1      # CUDA -> kernel
    ops.set_backend("ref")
    try:
        ops.decode_attention(q, kc, vc, ap, pos)
    finally:
        ops.set_backend(None)
    assert da.decode_attention.launches == n + 1      # "ref" -> plain
    with pytest.raises(ValueError, match="dtypes"):
        da.decode_attention(q.half(), kc.half(), vc.half(), ap, pos)
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention(q, kc.transpose(1, 2).contiguous().transpose(
            1, 2), vc, ap, pos)
    with pytest.raises(ValueError, match="int32"):
        da.decode_attention(q, kc, vc, ap.long(), pos)
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention(q, kc, vc, ap.cpu(), pos)
    with pytest.raises(ValueError, match="shapes"):
        da.decode_attention(q.repeat(1, 2, 1, 1), kc, vc, ap, pos)
    with pytest.raises(ValueError, match="head dim"):
        da.decode_attention(q[..., :32].contiguous(),
                            kc[..., :32].contiguous(),
                            vc[..., :32].contiguous(), ap, pos)
    assert da.decode_attention.launches == n + 1


def _spec_inputs(cuda, g, V, seed, kind="random"):
    gen = torch.Generator(cuda).manual_seed(seed)
    q = torch.softmax(2 * torch.randn((g, V), generator=gen, device=cuda), -1)
    p = torch.softmax(2 * torch.randn((g + 1, V), generator=gen,
                                      device=cuda), -1)
    d = torch.multinomial(q, 1, generator=gen)[:, 0]
    if kind == "greedy":
        t = torch.randint(0, V, (g + 1,), generator=gen, device=cuda)
        d = t[:g].clone()
        d[-1] = (d[-1] + 1) % V                    # last draft rejected
        q = torch.nn.functional.one_hot(d, V).float()
        p = torch.nn.functional.one_hot(t, V).float()
    elif kind == "q0":
        q[0, d[0]] = 0.0
    u = torch.rand((g,), generator=gen, device=cuda)
    return d.to(torch.int32), q.contiguous(), p.contiguous(), u


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("V", [32, 512, 32768])
@pytest.mark.parametrize("kind", ["random", "greedy", "q0"])
def test_spec_accept_kernel_matches_plain(cuda, g, V, kind):
    for seed in range(3):
        args = _spec_inputs(cuda, g, V, seed, kind)
        n, dist = sv.spec_accept(*args)
        n_ref, dist_ref = sv.plain(*args)
        assert int(n) == int(n_ref)
        assert float((dist - dist_ref).abs().max()) < 1e-6


def _spec_vs_plain(args):
    n, dist = sv.spec_accept(*args)
    n_ref, dist_ref = sv.plain(*args)
    assert int(n) == int(n_ref)
    assert float((dist - dist_ref).abs().max()) < 1e-6
    return int(n), dist


def _greedy_prefix(cuda, g, V, k, seed):
    """One-hot drafts of which the first k agree with the target's
    tokens and draft k (when k < g) does not: n = k."""
    gen = torch.Generator(cuda).manual_seed(seed)
    t = torch.randint(0, V, (g + 1,), generator=gen, device=cuda)
    d = t[:g].clone()
    if k < g:
        d[k] = (d[k] + 1) % V
    u = torch.rand((g,), generator=gen, device=cuda)
    return (d.to(torch.int32), torch.nn.functional.one_hot(d, V).float(),
            torch.nn.functional.one_hot(t, V).float(), u)


@pytest.mark.cuda
@pytest.mark.parametrize("V", [33, 1001, 262144])
@pytest.mark.parametrize("kind", ["random", "greedy", "q0"])
def test_spec_accept_kernel_at_scalar_and_large_vocabs(cuda, V, kind):
    """V = 33 and 1001 (V % 4 != 0) take the scalar path; V = 262144
    (gemma3_4b's vocab) takes 8 CTAs, each thread in two passes."""
    for seed in range(3):
        _spec_vs_plain(_spec_inputs(cuda, 4, V, seed, kind))


@pytest.mark.cuda
@pytest.mark.parametrize("g,k", [(33, 0), (33, 31), (33, 32), (33, 33),
                                 (64, 31), (64, 32), (64, 33), (64, 63),
                                 (64, 64)])
@pytest.mark.parametrize("V", [512, 32768])
def test_spec_accept_kernel_past_one_ballot(cuda, g, k, V):
    """g > 32 takes the ballot in chunks of 32: the first rejection in any
    chunk, and none at all (k = g, the bonus row)."""
    assert _spec_vs_plain(_greedy_prefix(cuda, g, V, k, g + k))[0] == k
    _spec_vs_plain(_spec_inputs(cuda, g, V, k))


@pytest.mark.cuda
@pytest.mark.parametrize("g,bad", [(1, ((0, "over"),)), (1, ((0, "neg"),)),
                                   (4, ((0, "over"),)), (4, ((2, "neg"),)),
                                   (4, ((3, "over"),)),
                                   (4, ((1, "neg"), (3, "over"))),
                                   (33, ((32, "over"),))])
@pytest.mark.parametrize("V", [33, 512, 32768])
def test_spec_accept_kernel_rejects_out_of_range_ids(cuda, g, bad, V):
    """A draft id of V + 3 or -1 reads nothing and is a rejection, as in
    the Pallas kernel: after in-range drafts that are all accepted, n is
    the first bad id's position (a last draft of V + 3 would read past
    the end of q if it were read)."""
    d, q, p, u = _greedy_prefix(cuda, g, V, g, V)
    for pos, which in bad:
        d[pos] = V + 3 if which == "over" else -1
    n, _ = _spec_vs_plain((d, q, p, u))
    assert n == min(pos for pos, _ in bad)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rejected", "bonus"])
@pytest.mark.parametrize("V", [33, 32768, 262144])
def test_spec_accept_kernel_all_zero_residual(cuda, case, V):
    """A residual that sums to 0 takes the 1e-9 branch in every CTA:
    dist is p_n exactly.  ``rejected``: draft 1 is out of range and p_1 =
    q_1; ``bonus``: every draft accepted and p_g all zero."""
    g = 4
    d, q, p, u = _greedy_prefix(cuda, g, V, g, V + 1)
    if case == "rejected":
        d[1] = V + 3
        p[1] = q[1]
    else:
        p[g] = 0.0
    n, dist = _spec_vs_plain((d, q, p, u))
    assert n == (1 if case == "rejected" else g)
    assert torch.equal(dist, p[n])


@pytest.mark.cuda
@pytest.mark.parametrize("V,kind", [(32768, "random"), (32768, "greedy"),
                                    (262144, "random"), (1001, "q0")])
def test_spec_accept_kernel_is_deterministic(cuda, V, kind):
    """The cluster's partial sums merge in rank order, with no atomics:
    a second call gives the same bits."""
    args = _spec_inputs(cuda, 4, V, 5, kind)
    n1, d1 = sv.spec_accept(*args)
    n2, d2 = sv.spec_accept(*args)
    assert torch.equal(n1, n2) and torch.equal(d1, d2)


@pytest.mark.cuda
def test_spec_accept_kernel_reads_unaligned_rows(cuda):
    """Rows that start off a 16-byte boundary (V % 4 == 0, base pointers
    one float in) take the scalar path with the same result."""
    g, V = 4, 1024
    gen = torch.Generator(cuda).manual_seed(11)
    buf = torch.softmax(2 * torch.randn((2 * g + 2, V), generator=gen,
                                        device=cuda), -1).flatten()
    q = buf[1:1 + g * V].view(g, V)
    p = buf[1 + g * V:1 + (2 * g + 1) * V].view(g + 1, V)
    assert q.data_ptr() % 16 and p.is_contiguous()
    d = torch.multinomial(q, 1, generator=gen)[:, 0].to(torch.int32)
    u = torch.rand((g,), generator=gen, device=cuda)
    _spec_vs_plain((d, q, p, u))


@pytest.mark.cuda
def test_spec_accept_source_split_is_the_rule(cuda):
    """The split the kernel source launches is ``spec_verify.split``."""
    import ctypes
    from repro_torch.kernels import build
    fn = build.load(sv.NAME).spec_accept_split
    for V in [*range(1, 300), 1001, 4096, 32767, 32768, 32769, 65536,
              131072, 262144, 1 << 20]:
        C, T = ctypes.c_int(), ctypes.c_int()
        assert fn(V, ctypes.byref(C), ctypes.byref(T)) == 0
        assert (C.value, T.value) == sv.split(V)


@pytest.mark.cuda
def test_spec_verify_refusals_dispatch_and_draws(cuda):
    d, q, p, u = _spec_inputs(cuda, 4, 512, 0)
    n0 = sv.spec_accept.launches
    a = ops.spec_verify(d, q, p, torch.Generator().manual_seed(3))
    assert sv.spec_accept.launches == n0 + 1          # CUDA -> kernel
    ops.set_backend("ref")
    try:
        b = ops.spec_verify(d, q, p, torch.Generator().manual_seed(3))
    finally:
        ops.set_backend(None)
    assert sv.spec_accept.launches == n0 + 1          # "ref" -> plain
    assert (int(a[0]), int(a[1])) == (int(b[0]), int(b[1]))
    with pytest.raises(ValueError, match="int32"):
        sv.spec_accept(d.long(), q, p, u)
    with pytest.raises(ValueError, match="float32"):
        sv.spec_accept(d, q.half(), p, u)
    with pytest.raises(ValueError, match="shapes"):
        sv.spec_accept(d, q, p[:4], u)
    with pytest.raises(ValueError, match="contiguous"):
        sv.spec_accept(d, q.t().contiguous().t(), p, u)
    with pytest.raises(ValueError, match="CUDA"):
        sv.spec_accept(d, q, p, u.cpu())
    assert sv.spec_accept.launches == n0 + 1


@pytest.mark.cuda
def test_tiny_dense_engine_on_the_card_runs_the_kernels(cuda):
    """A narrow llama (head dim 64) on the dense Engine: every prefill,
    decode step and distribution verify goes through the kernels."""
    from repro_torch.configs import get
    from repro_torch.configs.tiny import make_tiny
    from repro_torch.models.init import init_params
    from repro_torch.serving.engine import Engine, Request
    cfg = make_tiny(get("llama-1.5b"), d_model=256)
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    eng = Engine(cfg, params, slots=2, max_len=128, device=cuda)
    f0, d0 = fa.flash_attention.launches, da.decode_attention.launches
    reqs = [Request(f"r{i}", np.arange(2, 30 + 7 * i) % 500,
                    max_new_tokens=6, temperature=0.8 * i)
            for i in range(2)]
    for r in reqs:
        assert eng.add_request(r)
    steps = 0
    while eng.requests:
        eng.step()
        steps += 1
    assert all(len(r.output) == 6 for r in reqs)
    assert fa.flash_attention.launches - f0 == cfg.num_layers * 2
    assert da.decode_attention.launches - d0 == cfg.num_layers * steps
    r = Request("v", np.arange(2, 40) % 500, max_new_tokens=8)
    assert eng.add_request(r)
    s0 = sv.spec_accept.launches
    q = np.eye(cfg.padded_vocab, dtype=np.float32)[[5, 6, 7]]
    res = eng.verify_slots_distribution({r.slot: [5, 6, 7]}, {r.slot: q},
                                        rng=torch.Generator().manual_seed(0))
    assert sv.spec_accept.launches == s0 + 1
    n_acc, tok = res[r.slot]
    assert 0 <= n_acc <= 3 and (tok is None) == (n_acc == 3)


def _rwkv(cuda, B, T, H, D, seed, ww_lo=None):
    """r, k, v, w, u, state0 on the card; w in (0.2, 0.99) as in the
    reference sweep, or exp(-exp(ww)) with ww in [ww_lo, 1.5], the range
    ``rwkv6._projections`` produces."""
    gen = torch.Generator(cuda).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda)

    r, k, v = rnd(B, T, H, D), rnd(B, T, H, D), rnd(B, T, H, D)
    x = torch.rand((B, T, H, D), generator=gen, device=cuda)
    w = (0.2 + 0.79 * x if ww_lo is None
         else torch.exp(-torch.exp(ww_lo + (1.5 - ww_lo) * x)))
    return r, k, v, w, rnd(H, D), rnd(B, H, D, D)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,D,chunk", [
    (1, 64, 2, 16, 16), (2, 128, 4, 32, 32), (1, 96, 1, 64, 32),
    (1, 40, 2, 16, 64), (2, 192, 3, 64, 64), (1, 37, 2, 32, 37),
    (1, 30, 1, 64, 6),
])
@pytest.mark.parametrize("decay", ["sweep", "floor"])
def test_rwkv6_kernel_matches_plain(cuda, B, T, H, D, chunk, decay):
    a = _rwkv(cuda, B, T, H, D, T + D, -6.0 if decay == "floor" else None)
    o, s = rs.rwkv6_scan(*a, chunk=chunk)
    o_ref, s_ref = rs.plain(*a, chunk=chunk)
    assert o.shape == (B, T, H, D) and s.shape == (B, H, D, D)
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    assert float((o - o_ref).abs().max()) < 5e-4
    assert float((s - s_ref).abs().max()) < 5e-4


@pytest.mark.cuda
def test_rwkv6_kernel_reads_strided_inputs_and_refuses(cuda):
    """Slices along T (as timemix_parallel's ragged split passes them) are
    read in place; the wrapper refuses what the kernel does not take."""
    r, k, v, w, u, s0 = _rwkv(cuda, 2, 100, 2, 32, 0)
    o, s = rs.rwkv6_scan(r[:, :96], k[:, :96], v[:, :96], w[:, :96], u, s0,
                         chunk=32)
    o_ref, s_ref = rs.plain(r[:, :96].contiguous(), k[:, :96], v[:, :96],
                            w[:, :96], u, s0, chunk=32)
    assert float((o - o_ref).abs().max()) < 5e-4
    assert float((s - s_ref).abs().max()) < 5e-4
    n = rs.rwkv6_scan.launches
    ops.rwkv6_scan(r, k, v, w, u, s0, chunk=50)
    assert rs.rwkv6_scan.launches == n + 1            # CUDA -> kernel
    ops.set_backend("ref")
    try:
        ops.rwkv6_scan(r, k, v, w, u, s0, chunk=50)
    finally:
        ops.set_backend(None)
    assert rs.rwkv6_scan.launches == n + 1            # "ref" -> plain
    with pytest.raises(ValueError, match="multiple"):
        rs.rwkv6_scan(r, k, v, w, u, s0, chunk=64)
    with pytest.raises(ValueError, match="float32"):
        rs.rwkv6_scan(r.bfloat16(), k, v, w, u, s0, chunk=50)
    with pytest.raises(ValueError, match="head dim"):
        rs.rwkv6_scan(*(x[..., :8].contiguous() for x in (r, k, v, w)),
                      u[:, :8].contiguous(),
                      s0[:, :, :8, :8].contiguous(), chunk=50)
    with pytest.raises(ValueError, match="unit-stride"):
        rs.rwkv6_scan(r.transpose(2, 3).contiguous().transpose(2, 3), k, v,
                      w, u, s0, chunk=50)
    with pytest.raises(ValueError, match="CUDA"):
        rs.rwkv6_scan(r, k, v, w, u.cpu(), s0, chunk=50)
    assert rs.rwkv6_scan.launches == n + 1


def _rwkv_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


@pytest.mark.cuda
def test_rwkv6_kernel_is_deterministic(cuda):
    """Fixed orders, no atomics: a second call gives the same bits."""
    a = _rwkv(cuda, 1, 256, 64, 64, 5, -6.0)
    o1, s1 = rs.rwkv6_scan(*a, chunk=64)
    o2, s2 = rs.rwkv6_scan(*a, chunk=64)
    assert torch.equal(o1, o2) and torch.equal(s1, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("decay", ["sweep", "floor"])
@pytest.mark.parametrize("runs", [[(64, 1536)], [(64, 960), (40, 40)]],
                         ids=["T1536", "T1000"])
def test_rwkv6_kernel_at_the_rwkv6_7b_prefill(cuda, runs, decay):
    """rwkv6-7b's heads (B=1, H=64, D=64, split 32) at T=1536, and T=1000
    split as timemix_parallel splits it (960 rows, then a 40-row tail
    carrying the state), against plain within 5e-4."""
    T = sum(n for _, n in runs)
    assert rs.split(1, 64, 64) == 32
    a = _rwkv(cuda, 1, T, 64, 64, T, -6.0 if decay == "floor" else None)
    r, k, v, w, u, s0 = a
    outs = []
    for fn in (rs.rwkv6_scan, rs.plain):
        s, ys, t0 = s0, [], 0
        for c, n in runs:
            y, s = fn(r[:, t0:t0 + n], k[:, t0:t0 + n], v[:, t0:t0 + n],
                      w[:, t0:t0 + n], u, s, chunk=c)
            ys.append(y)
            t0 += n
        outs.append((torch.cat(ys, 1), s))
    assert torch.isfinite(outs[0][0]).all()
    assert _rwkv_err(outs[0], outs[1]) < 5e-4


@pytest.mark.cuda
@pytest.mark.parametrize("B,H", [(2, 64), (3, 64)])
def test_rwkv6_kernel_past_one_wave(cuda, B, H):
    """More CTAs than one wave of the card holds (256 and 384 CTAs at
    split 32, one a SM: two and three waves)."""
    a = _rwkv(cuda, B, 192, H, 64, B)
    assert _rwkv_err(rs.rwkv6_scan(*a, chunk=64),
                     rs.plain(*a, chunk=64)) < 5e-4


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 64])
def test_rwkv6_kernel_at_the_train_chunk(cuda, D):
    """Chunk 8, the train mode's (models/layers.py): one 16-row tile with
    8 pad rows, 24 chunks."""
    a = _rwkv(cuda, 2, 192, 4, D, D, -6.0)
    assert _rwkv_err(rs.rwkv6_scan(*a, chunk=8), rs.plain(*a, chunk=8)) \
        < 5e-4


@pytest.mark.cuda
def test_rwkv6_kernel_reads_unaligned_inputs(cuda):
    """r 4 bytes off a 16-byte boundary: the kernel loads by 4-byte
    copies instead of 16-byte bulk rows, with the same result."""
    a = _rwkv(cuda, 2, 128, 3, 64, 7)
    r = torch.empty(a[0].numel() + 1, device=cuda)[1:].view(a[0].shape)
    r.copy_(a[0])
    assert r.data_ptr() % 16 == 4
    assert rs.aligned(*a[:4]) and not rs.aligned(r, *a[1:4])
    got = rs.rwkv6_scan(r, *a[1:], chunk=64)
    assert _rwkv_err(got, rs.plain(*a, chunk=64)) < 5e-4


@pytest.mark.cuda
@pytest.mark.parametrize("D", rs.HEAD_DIMS)
@pytest.mark.parametrize("chunk", [64, 37])
def test_rwkv6_kernel_at_every_split(cuda, D, chunk):
    """Each (D, split) instance of the kernel, with whole and ragged
    (37-row) chunks."""
    a = _rwkv(cuda, 1, 2 * chunk, 3, D, D + rs.split(1, 3, D), -6.0)
    assert _rwkv_err(rs.rwkv6_scan(*a, chunk=chunk),
                     rs.plain(*a, chunk=chunk)) < 5e-4


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(4, 4096, 1024), (64, 256, 128),
                                   (130, 200, 70), (1, 33, 17),
                                   (77, 1000, 300)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_kernel_matches_plain(cuda, M, K, N, dtype):
    """Whole tiles and edges that are not a multiple of the 64 x 64 x 32
    tile (nor of the 16-byte vector loads)."""
    gen = torch.Generator(cuda).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=gen, device=cuda).to(dtype)
    wq = torch.randint(-128, 128, (K, N), generator=gen, device=cuda,
                       dtype=torch.int8)
    ws = 0.001 + 0.009 * torch.rand((N,), generator=gen, device=cuda)
    o = im.int8_matmul(x, wq, ws)
    o_ref = im.plain(x, wq, ws)
    assert o.dtype == dtype and o.shape == (M, N)
    rel = float((o.float() - o_ref.float()).abs().max()
                / o_ref.float().abs().max())
    assert rel < 5e-3


@pytest.mark.cuda
def test_int8_kernel_dispatch_and_refusals(cuda):
    x = torch.randn((2, 3, 64), device=cuda, dtype=torch.bfloat16)
    wq = torch.randint(-128, 128, (64, 32), device=cuda, dtype=torch.int8)
    ws = torch.rand((32,), device=cuda)
    n = im.int8_matmul.launches
    o = ops.int8_matmul(x, wq, ws)
    assert o.shape == (2, 3, 32) and im.int8_matmul.launches == n + 1
    ops.set_backend("ref")
    try:
        ops.int8_matmul(x, wq, ws)
    finally:
        ops.set_backend(None)
    assert im.int8_matmul.launches == n + 1
    # an x view that is not contiguous is packed by the wrapper
    xt = torch.randn((64, 5), device=cuda, dtype=torch.bfloat16).T
    rel = float((im.int8_matmul(xt, wq, ws).float()
                 - im.plain(xt, wq, ws).float()).abs().max()
                / im.plain(xt, wq, ws).float().abs().max())
    assert rel < 5e-3
    with pytest.raises(ValueError, match="int8"):
        im.int8_matmul(x, wq.float(), ws)
    with pytest.raises(ValueError, match="shapes"):
        im.int8_matmul(x[..., :32], wq, ws)
    with pytest.raises(ValueError, match="x in"):
        im.int8_matmul(x.half(), wq, ws)
    with pytest.raises(ValueError, match="contiguous"):
        im.int8_matmul(x, wq.T.contiguous().T, ws)
    with pytest.raises(ValueError, match="CUDA"):
        im.int8_matmul(x, wq.cpu(), ws)


# (design, M, K, N, x dtype): rwkv6-7b's channel-mix wk / wv, the ragged
# edges of each design and the shapes only the general kernel takes
_WK, _WV = (4096, 14336), (14336, 4096)
INT8_DESIGNS = (
    [("wgmma", 1536, *_WK, torch.bfloat16), ("wgmma", 1536, *_WV, torch.bfloat16),
     ("wgmma", 200, 4104, 4112, torch.bfloat16),     # ragged M, N, K: tile 192
     ("wgmma", 2000, 4104, 4112, torch.bfloat16),    # ragged M, N, K: tile 256
     ("wgmma", 33, 64, 16, torch.bfloat16),          # just above the limit
     ("wgmma", 384, 1024, 2048, torch.bfloat16)]     # whole tiles
    + [("splitk", M, *kn, dt) for M in (1, 4, 16) for kn in (_WK, _WV)
       for dt in (torch.bfloat16, torch.float32)]
    + [("splitk", 32, 4104, 4112, torch.bfloat16), ("splitk", 5, 1, 16,
                                                     torch.float32),
       ("splitk", 9, 1000, 128, torch.bfloat16),
       ("general", 200, 4096, 4096, torch.float32),  # f32 above the limit
       ("general", 100, 4100, 4096, torch.bfloat16),  # K % 8 != 0
       ("general", 4, 4096, 4100, torch.bfloat16)])   # N % 16 != 0


@pytest.mark.cuda
@pytest.mark.parametrize("design,M,K,N,dtype", INT8_DESIGNS)
def test_int8_designs_match_plain_and_repeat(cuda, design, M, K, N, dtype):
    """Each design against plain within 5e-3 of max |plain|, the same bits
    on a second call, and the per-route count shows the design ran.  The
    reference is plain's fp32 product before its cast to x's dtype: a
    bf16 output then differs by its own rounding, at most half an ulp
    (under 3.9e-3 of max |plain|), whereas two bf16 results whose fp32
    sums straddle a rounding boundary differ by a whole ulp, up to 7.8e-3
    of max |plain| when that max sits low in its binade (the general
    kernel's (4, 4096, 4100) case does)."""
    assert im.route(M, N, K, dtype, True) == design
    gen = torch.Generator(cuda).manual_seed(M * 7 + K + N)
    x = torch.randn((M, K), generator=gen, device=cuda).to(dtype)
    wq = torch.randint(-128, 128, (K, N), generator=gen, device=cuda,
                       dtype=torch.int8)
    ws = 0.001 + 0.009 * torch.rand((N,), generator=gen, device=cuda)
    before = dict(im.int8_matmul.routes)
    o = im.int8_matmul(x, wq, ws)
    ran = {r: n - before[r] for r, n in im.int8_matmul.routes.items()}
    assert ran == {r: int(r == design) for r in im.ROUTES}
    o_ref = im.plain(x.float(), wq, ws)   # x is rounded to bf16 first
    assert o.dtype == dtype and o.shape == (M, N)
    rel = float((o.float() - o_ref).abs().max() / o_ref.abs().max())
    assert rel < 5e-3
    assert torch.equal(o, im.int8_matmul(x, wq, ws))


@pytest.mark.cuda
def test_int8_unaligned_x_takes_the_general_kernel(cuda):
    """A view of x that starts off a 16-byte boundary cannot be read by
    TMA: the route is general, and the result still matches."""
    base = torch.randn((300 * 1024 + 1,), device=cuda, dtype=torch.bfloat16)
    x = base[1:].view(300, 1024)
    wq = torch.randint(-128, 128, (1024, 256), device=cuda, dtype=torch.int8)
    ws = torch.rand((256,), device=cuda)
    n = im.int8_matmul.routes["general"]
    o = im.int8_matmul(x, wq, ws)
    assert im.int8_matmul.routes["general"] == n + 1
    o_ref = im.plain(x, wq, ws)
    assert float((o.float() - o_ref.float()).abs().max()
                 / o_ref.float().abs().max()) < 5e-3


@pytest.mark.cuda
def test_tiny_rwkv_engine_on_the_card_runs_the_scan(cuda):
    """A narrow rwkv6 (head dim 64) on the dense Engine: every prefill
    runs rwkv6_scan once per layer per chunk run (twice for a ragged
    prompt over 64 tokens), and a reused slot matches a fresh engine."""
    from repro_torch.configs import get
    from repro_torch.configs.tiny import make_tiny
    from repro_torch.models.init import init_params
    from repro_torch.serving.engine import Engine, Request
    cfg = make_tiny(get("rwkv6-7b"), d_model=256).replace(rwkv_head_dim=64)
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    eng = Engine(cfg, params, slots=2, max_len=256, device=cuda)
    n0 = rs.rwkv6_scan.launches
    lens = (30, 100)                   # one chunk run; 64 + a 36-row tail
    reqs = [Request(f"r{i}", np.arange(2, 2 + n) % 500, max_new_tokens=6)
            for i, n in enumerate(lens)]
    for r in reqs:
        assert eng.add_request(r)
    while eng.requests:
        eng.step()
    assert all(len(r.output) == 6 for r in reqs)
    assert rs.rwkv6_scan.launches - n0 == cfg.num_layers * (1 + 2)
    again = Request("b", np.arange(5, 45) % 500, max_new_tokens=6)
    assert eng.add_request(again) and again.slot == 0
    while eng.requests:
        eng.step()
    fresh = Engine(cfg, params, slots=2, max_len=256, device=cuda)
    ref = Request("b", np.arange(5, 45) % 500, max_new_tokens=6)
    assert fresh.add_request(ref)
    while fresh.requests:
        fresh.step()
    assert again.output == ref.output


def _tiny_on_card(cuda, seed=0):
    from repro_torch.configs import get
    from repro_torch.configs.tiny import make_tiny
    from repro_torch.models.init import init_params
    cfg = make_tiny(get("llama-1.5b"), d_model=256)
    return cfg, init_params(cfg, torch.Generator(cuda).manual_seed(seed),
                            cuda)


@pytest.mark.cuda
def test_fleet_failover_on_the_card_resumes_bit_for_bit(cuda):
    """Two one-row PagedEngines in a fleet (head dim 64): the engine
    holding a greedy request fails mid-decode, the balancer re-places
    the request from its shadow checkpoint (wire v2) on the other, and
    its tokens equal the request served alone on a fresh engine."""
    from repro_torch.core.attestation import TrustAuthority
    from repro_torch.core.daemon import CLOUD
    from repro_torch.fleet import EngineHandle, FleetController, RequestSpec
    from repro_torch.serving.engine import Request
    from repro_torch.serving.paged import PagedEngine
    cfg, params = _tiny_on_card(cuda)
    mk = lambda seed: PagedEngine(cfg, params, page_size=16, rows=1,  # noqa
                                  max_len=128, seed=seed, device=cuda)
    prompt = np.arange(3, 40) % 500
    solo = mk(9)
    ref = Request("ref", prompt, max_new_tokens=16)
    solo.add_request(ref)
    while solo.requests:
        solo.step()
    fleet = FleetController([EngineHandle("a", mk(0), CLOUD),
                             EngineHandle("b", mk(1), CLOUD)],
                            authority=TrustAuthority())
    t = fleet.submit(RequestSpec(rid="r", prompt=prompt, max_new_tokens=16))
    for _ in range(5):
        fleet.step()
    src = fleet.placement_of("r")
    fleet.fail(src)
    assert t.result() == ref.output
    assert fleet.placements["r"] == [src, "b" if src == "a" else "a"]
    (rec,) = fleet.telemetry.migrations
    assert rec.reason == "failover" and not rec.lossy


@pytest.mark.cuda
def test_fleet_distribution_pair_launches_spec_accept_once_a_round(cuda):
    """A draft (seed 1) -> verify (seed 0) pair in ``distribution``
    mode on the card: every verify round of the one-slot pair launches
    ``spec_accept`` once, and the committed stream is complete."""
    from repro_torch.core.attestation import TrustAuthority
    from repro_torch.core.daemon import CLOUD, EDGE
    from repro_torch.fleet import EngineHandle, FleetController, RequestSpec
    from repro_torch.serving.engine import Engine
    cfg, target = _tiny_on_card(cuda, 0)
    _, draft = _tiny_on_card(cuda, 1)
    fleet = FleetController(
        [EngineHandle("draft", Engine(cfg, draft, slots=1, max_len=128,
                                      device=cuda), EDGE),
         EngineHandle("verify", Engine(cfg, target, slots=1, max_len=128,
                                       device=cuda), CLOUD)],
        authority=TrustAuthority(), spec_tiers={"draft": "verify"},
        spec_options={"verify_mode": "distribution", "gamma": 4})
    n0 = sv.spec_accept.launches
    ts = [fleet.submit(RequestSpec(rid=f"r{i}", prompt=np.arange(5, 30 + i),
                                   max_new_tokens=12,
                                   temperature=0.7 * i, top_k=16 * i))
          for i in range(2)]
    for t in ts:
        assert len(t.result()) == 12
    st = fleet.spec_controllers["draft"].stats
    assert st.requests == 2 and st.rounds > 0
    assert sv.spec_accept.launches - n0 == st.rounds


@pytest.mark.cuda
def test_socket_fleet_kill_service_fails_over_bit_for_bit(cuda):
    """Service mode on the card: two one-row PagedEngines behind a
    ``ControlPlane`` over the loopback-socket transport, one service
    thread each.  The service holding a greedy request is killed after
    its shadow arrived; the heartbeat detector declares it failed and
    the request resumes from the shadow (wire v2) on the other engine,
    its tokens equal to the request served alone on a fresh engine."""
    import time

    from repro_torch.core.attestation import TrustAuthority
    from repro_torch.core.channel import SocketTransport
    from repro_torch.core.daemon import CLOUD
    from repro_torch.fleet import (ControlPlane, EngineHandle,
                                   FleetController, RequestSpec,
                                   RequestState)
    from repro_torch.serving.engine import Request
    from repro_torch.serving.paged import PagedEngine
    cfg, params = _tiny_on_card(cuda)
    mk = lambda seed: PagedEngine(cfg, params, page_size=16, rows=1,  # noqa
                                  max_len=128, seed=seed, device=cuda)
    prompt = np.arange(3, 40) % 500
    solo = mk(9)
    ref = Request("ref", prompt, max_new_tokens=48)
    solo.add_request(ref)
    while solo.requests:
        solo.step()
    fleet = FleetController([EngineHandle("a", mk(0), CLOUD),
                             EngineHandle("b", mk(1), CLOUD)],
                            authority=TrustAuthority())
    cp = ControlPlane(fleet, transport=SocketTransport(), sync_every=4,
                      hb_timeout_s=1.0)
    cp.start(threads=True)
    try:
        t = cp.submit(RequestSpec(rid="r", prompt=prompt,
                                  max_new_tokens=48))
        deadline = time.perf_counter() + 120.0
        while time.perf_counter() < deadline and not any(
                fleet.balancer.shadow.values()):
            time.sleep(0.005)
        src = fleet.placement_of("r")
        assert src is not None and fleet.balancer.shadow.get(src)
        cp.kill_service(src)
        while time.perf_counter() < deadline and not t.done:
            time.sleep(0.01)
        assert t.state is RequestState.DONE
        assert t.output == ref.output
        other = "b" if src == "a" else "a"
        assert fleet.placements["r"] == [src, other]
        assert [ev.engine for ev in fleet.telemetry.heartbeat_events()] \
            == [src]
        (rec,) = fleet.telemetry.migrations
        assert rec.reason == "failover" and not rec.lossy
    finally:
        cp.stop()


@pytest.mark.cuda
def test_autoscaler_spawn_shares_its_donors_programs(cuda):
    """A paged template of the seed engine's geometry spawns, on the
    card, an engine served the seed engine's program set
    (``program_cache_hit``, the spawn span's ``cache_hit``), and a
    greedy request on it equals the same request alone on the seed
    engine, bit for bit."""
    from repro_torch.core.attestation import TrustAuthority
    from repro_torch.core.daemon import CLOUD
    from repro_torch.fleet import (Autoscaler, EngineHandle, EngineTemplate,
                                   FleetController, ScalePolicy)
    from repro_torch.serving.engine import Request
    from repro_torch.serving.paged import PagedEngine
    cfg, params = _tiny_on_card(cuda)
    seed_eng = PagedEngine(cfg, params, page_size=16, rows=2, max_len=128,
                           pages=16, seed=0, device=cuda)
    fleet = FleetController(
        [EngineHandle("base", seed_eng, CLOUD)], authority=TrustAuthority(),
        autoscaler=Autoscaler(
            EngineTemplate(name="auto", profile=CLOUD, slots=2, max_len=128,
                           page_size=16, pages=16),
            ScalePolicy(min_engines=1, max_engines=2,
                        scale_up_queue_depth=10)))
    ev = fleet.autoscaler.scale_up(fleet, reason="test")
    spawned = fleet.handles[ev.engine].engine
    assert spawned.device.type == "cuda"
    assert spawned.program_cache_hit
    assert spawned._programs is seed_eng._programs
    span = next(s for s in fleet.tracer.spans if s.name == "spawn")
    assert span.attrs["cache_hit"] is True
    prompt = np.arange(7, 50) % 500
    outs = []
    for eng in (spawned, seed_eng):
        req = Request("r", prompt, max_new_tokens=16)
        assert eng.add_request(req)
        while not req.done:
            eng.step()
        outs.append(req.output)
    assert outs[0] == outs[1]


# -- head dims 160 (stablelm-12b) and 256 (gemma3-4b) ----------------------

WIDE = (160, 256)
GROUPS = (1, 2, 4, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [64, 129, 1024])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("D", WIDE)
def test_flash_kernel_wide_head_dims(cuda, D, G, mode, S):
    """The padded-tile instances (D = 160 in three 64-column boxes, the
    last one past D zero-filled; D = 256 with two stages of 64-key tiles)
    in every mode, at the edges of the 128-row query and 64-key tiles."""
    KV = 2
    gen = torch.Generator(cuda).manual_seed(D + G + S)
    q, k, v = (torch.randn((2, S, n, D), generator=gen, device=cuda,
                           dtype=torch.bfloat16) for n in (G * KV, KV, KV))
    kw = MODES[mode]
    o = fa.flash_attention(q, k, v, **kw)
    _hold_query_rows(o, fa.plain(q, k, v, **kw))
    assert torch.equal(o, fa.flash_attention(q, k, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("D", WIDE)
def test_flash_kernel_wide_strided_views_and_local_window(cuda, D):
    """Head slices of one fused tensor read in place, and gemma3-4b's
    local layer shape (H 8 / KV 4, window 1024) over 1536 tokens."""
    gen = torch.Generator(cuda).manual_seed(D)
    qkv = torch.randn((1, 1536, 16, D), generator=gen, device=cuda,
                      dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:12], qkv[:, :, 12:]
    for kw in (dict(causal=True), dict(causal=True, window=1024),
               dict(causal=True, softcap=50.0)):
        o = fa.flash_attention(q, k, v, **kw)
        ref = fa.plain(q.contiguous(), k.contiguous(), v.contiguous(), **kw)
        assert float((o.float() - ref.float()).abs().max()) < 2e-2, kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["plain", "window", "softcap"])
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("D", WIDE)
def test_paged_kernel_wide_head_dims(cuda, D, G, mode, dtype):
    """Tables with holes and a split over several runs; each live row
    within its limit against the plain version and the split arithmetic,
    the dead row exactly 0, and the same bits on a second call."""
    B, KV, ps, NP = 4, 2, 16, 20
    P = 3 * NP + 1
    q, kp, vp = _paged_pools(cuda, B, P, ps, KV, G * KV, D, dtype, D + G)
    rng = np.random.default_rng(D + G)
    pt = np.full((B, NP), -1, np.int32)
    perm = rng.permutation(P)
    for b in range(3):
        pt[b] = perm[b * NP:(b + 1) * NP]
    pt[1, 3] = -1                                     # a hole mid-row
    pos = np.asarray([NP * ps - 1, 8 * ps, 10 * ps + 3, 40], np.int32)
    kw = {"window": dict(window=5 * ps + 3),
          "softcap": dict(softcap=50.0)}.get(mode, {})
    pt_t, pos_t = torch.from_numpy(pt).to(cuda), torch.from_numpy(pos).to(cuda)
    o = da.paged_decode_attention(q, kp, vp, pt_t, pos_t, **kw)
    for want in (da.paged_plain(q, kp, vp, pt_t, pos_t, **kw),
                 da.paged_split_plain(q, kp, vp, pt_t, pos_t, **kw)):
        _hold_rows(o, want, slice(0, 3))
    assert float(o[3].abs().max()) == 0.0
    assert torch.equal(o, da.paged_decode_attention(q, kp, vp, pt_t, pos_t,
                                                    **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["fill", "ring", "softcap"])
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("D", WIDE)
def test_dense_decode_kernel_wide_head_dims(cuda, D, G, mode, dtype):
    """Fill levels across chunk edges, a 1024-slot ring buffer (gemma3-4b's
    local layer) and a softcap; each row within its limit against the
    plain version and the split arithmetic, the empty row exactly 0, the
    same bits on a second call."""
    C, B, KV = da.CHUNK, 4, 2
    kw = {"softcap": dict(softcap=50.0)}.get(mode, {})
    if mode == "ring":
        Sc, kw, pos = 1024, dict(window=1024), [1500, 1023, 200, 0]
    else:
        Sc, pos = 3 * C + 44, [3 * C + 43, C, C - 1, 0]
    q, kc, vc = _decode_rows(cuda, B, Sc, KV, G * KV, D, dtype, D + G)
    pos_t = torch.tensor(pos, device=cuda, dtype=torch.int32)
    if mode == "ring":
        slot = torch.arange(Sc, device=cuda)[None]
        p = pos_t[:, None] - ((pos_t[:, None] - slot) % Sc)
        ap = torch.where(p >= 0, p, -1).to(torch.int32)
    else:
        ap = _global_ap(cuda, Sc, pos_t)
    ap[3] = -1                                        # the empty row
    o = da.decode_attention(q, kc, vc, ap, pos_t, **kw)
    for want in (da.plain(q, kc, vc, ap, pos_t, **kw),
                 da.split_plain(q, kc, vc, ap, pos_t, **kw)):
        _hold_rows(o, want, slice(0, 3))
    assert float(o[3].abs().max()) == 0.0
    assert torch.equal(o, da.decode_attention(q, kc, vc, ap, pos_t, **kw))


@pytest.mark.cuda
def test_long_prefill_into_a_ring_buffer_keeps_the_last_window(cuda):
    """A prefill three times a local layer's ring buffer writes each slot
    once, with its latest position: the CUDA scatter with repeated
    indices would keep any one of the positions that share a slot."""
    from repro_torch.configs import LayerSpec, get
    from repro_torch.configs.tiny import make_tiny
    from repro_torch.models import layers
    cfg = make_tiny(get("gemma3-4b"))
    lspec = LayerSpec("local", "dense", window=32)
    cache = layers.make_attn_cache(cfg, lspec, 2, 256, device=cuda)
    S = 96
    k = torch.arange(S, device=cuda, dtype=torch.float32)[None, :, None,
                                                          None]
    k = k.expand(2, S, cfg.num_kv_heads, cfg.head_dim).to(torch.bfloat16)
    pos = torch.arange(S, device=cuda)[None].expand(2, S)
    layers._write_cache(cache, lspec, k, k, pos)
    # S is a multiple of 32: slot s holds position S - 32 + s
    want = torch.arange(S - 32, S, device=cuda, dtype=torch.int32)
    assert torch.equal(cache["abs_pos"][0], want)
    assert torch.equal(cache["k"][1, :, 0, 0].float(), want.float())


# -- whisper-base and internvl2-26b: full mode, D 64, G 6 ------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Skv", [(13, 1536), (416, 1536), (448, 37),
                                    (1536, 1536), (129, 512)])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_flash_full_mode_with_sq_ne_skv(cuda, Sq, Skv, softcap):
    """whisper-base's encoder (Sq = Skv) and cross-attention (decoder
    tokens over frames) at D 64, H 8 / KV 8: each query row within its
    limit of the plain version (``_hold_query_rows``), the same bits on
    a second call."""
    gen = torch.Generator(cuda).manual_seed(Sq + Skv)
    q = torch.randn((2, Sq, 8, 64), generator=gen, device=cuda,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((2, Skv, 8, 64), generator=gen, device=cuda,
                        dtype=torch.bfloat16) for _ in range(2))
    kw = dict(causal=False, softcap=softcap)
    o = fa.flash_attention(q, k, v, **kw)
    _hold_query_rows(o, fa.plain(q, k, v, **kw))
    assert torch.equal(o, fa.flash_attention(q, k, v, **kw))
    assert torch.equal(o, ops.attention_full(q, k, v, softcap=softcap))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [200, 1536])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_at_group_6(cuda, S, causal):
    """internvl2-26b's heads: H 48 over KV 8, D 128; each query row
    within its limit of the plain version (``_hold_query_rows``)."""
    gen = torch.Generator(cuda).manual_seed(S)
    q, k, v = (torch.randn((1, S, n, 128), generator=gen, device=cuda,
                           dtype=torch.bfloat16) for n in (48, 8, 8))
    o = fa.flash_attention(q, k, v, causal=causal)
    _hold_query_rows(o, fa.plain(q, k, v, causal=causal))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_decode_at_group_6(cuda, dtype):
    """internvl2-26b's decode rows: G 6, D 128, 1568 slots."""
    B, Sc = 4, 1568
    pos = torch.tensor([300, 1000, 1535, 1567], device=cuda,
                       dtype=torch.int32)
    q, kc, vc = _decode_rows(cuda, B, Sc, 8, 48, 128, dtype, 6)
    ap = _global_ap(cuda, Sc, pos)
    o = da.decode_attention(q, kc, vc, ap, pos)
    _hold_rows(o, da.plain(q, kc, vc, ap, pos), slice(0, B))
    assert torch.equal(o, da.decode_attention(q, kc, vc, ap, pos))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_decode_over_a_cross_cache(cuda, dtype):
    """whisper-base's cross-attention decode: D 64, G 1, every row at
    position 2^30 over a cache that holds the frames in its first slots
    and -1 past them (a cache longer than the frames); row 3 is empty."""
    B, Sc = 4, 1536
    frames = torch.tensor([1536, 1500, 37, 0], device=cuda)
    q, kc, vc = _decode_rows(cuda, B, Sc, 8, 8, 64, dtype, 64)
    slot = torch.arange(Sc, device=cuda, dtype=torch.int32)[None]
    ap = torch.where(slot < frames[:, None], slot, -1).to(torch.int32)
    pos = torch.full((B,), 1 << 30, device=cuda, dtype=torch.int32)
    o = da.decode_attention(q, kc, vc, ap, pos)
    _hold_rows(o, da.plain(q, kc, vc, ap, pos), slice(0, 3))
    assert float(o[3].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["whisper-base", "internvl2-26b"])
def test_tiny_front_end_models_on_the_card(cuda, name, monkeypatch):
    """A tiny whisper-base and internvl2-26b (bf16, D 64) through
    ``models.forward``: a prefill and two decode steps launch flash and
    dense decode once an attention call (whisper: encoder, causal and
    cross) and nothing else, and each call is within 4 bf16 ulps of sum
    p|v| (the plain version on |V|: the magnitude of the terms it sums)
    of its plain version on its own inputs, as chip_smoke's ``Shadowed``
    holds them: the random model's values reach O(10), where a flat 2e-2
    is under one ulp.  (Its logits amplify those one-ulp differences
    chaotically; chip_smoke's ``whisper`` path holds them by its nudge
    rule.)"""
    from repro_torch.configs import ShapeSpec, get
    from repro_torch.configs.inputs import batch_specs
    from repro_torch.configs.tiny import make_tiny
    from repro_torch.models.init import init_params
    from repro_torch.models.model import forward, make_cache
    cfg = make_tiny(get(name), d_model=256)           # D 64
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    batch = batch_specs(cfg, ShapeSpec("t", 40, 2, "prefill"),
                        concrete=True, device=cuda)
    frames = 40 if cfg.encoder_blocks else 0
    n = cfg.num_layers
    n_enc = sum(len(b.layers) * b.repeats for b in cfg.encoder_blocks)
    cross = n if cfg.cross_attention else 0
    per_prefill, per_step = n_enc + n + cross, n + cross
    S = batch["tokens"].shape[1] + cfg.num_patches
    errs = []

    def shadowed(fn, plain):
        def call(q, k, v, *a, **kw):
            out = fn(q, k, v, *a, **kw)
            ref = plain(q, k, v, *a, **kw).float()
            terms = plain(q, k, v.abs(), *a, **kw).float()
            errs.append(float(((out.float() - ref).abs() / (
                4 * 2.0 ** -7 * terms).clamp(min=1e-30)).max()))
            return out
        return call

    for op, causal in (("attention_causal", True), ("attention_full", False)):
        monkeypatch.setattr(ops, op, shadowed(
            getattr(ops, op),
            lambda q, k, v, causal=causal, **kw: fa.plain(
                q, k, v, causal=causal, **kw)))
    monkeypatch.setattr(ops, "decode_attention",
                        shadowed(ops.decode_attention, da.plain))
    fa.flash_attention.launches = da.decode_attention.launches = 0
    caches = make_cache(cfg, 2, 64, cuda, cross_len=frames)
    with torch.no_grad():
        out = [forward(params, batch, cfg=cfg, mode="prefill",
                       caches=caches)[:, -1]]
        for t in range(2):
            pos = torch.full((2, 1), S + t, device=cuda, dtype=torch.int32)
            out.append(forward(params, {"tokens": batch["tokens"][:, t:t + 1]},
                               cfg=cfg, mode="decode", caches=caches,
                               positions=pos)[:, 0])
    assert fa.flash_attention.launches == per_prefill
    assert da.decode_attention.launches == 2 * per_step
    assert len(errs) == per_prefill + 2 * per_step
    assert max(errs) <= 1.0, errs
    assert bool(torch.isfinite(torch.stack(out)).all())


# ---------------------------------------------------------------------------
# flash attention's backward kernel and training on the card
# ---------------------------------------------------------------------------

BWD_MODES = {"causal": dict(causal=True),
             "window": dict(causal=True, window=100),
             "full": dict(causal=False),
             "softcap": dict(causal=True, softcap=30.0)}


def _bwd_case(cuda, B, Sq, Skv, H, KV, D, seed):
    gen = torch.Generator(cuda).manual_seed(seed)
    q, do = (torch.randn((B, Sq, H, D), generator=gen, device=cuda,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, Skv, KV, D), generator=gen, device=cuda,
                        dtype=torch.bfloat16) for _ in range(2))
    return q, k, v, do


def _hold_grads(grads, q, k, v, o, do, kw):
    """Each element of dQ, dK, dV within 4 bf16 ulps of the magnitude of
    the terms it sums (``plain_backward(..., terms=True)``)."""
    *ref, terms, _ = fa.plain_backward(q, k, v, o, do, terms=True, **kw)
    for g, r, t in zip(grads, ref, terms):
        assert g.shape == r.shape and g.dtype == torch.bfloat16
        e = (g.float() - r.float()).abs()
        assert bool((e <= 4 * 2.0 ** -7 * t).all()), float(
            (e / (4 * 2.0 ** -7 * t).clamp(min=1e-30)).max())


def _bwd_holds(cuda, B, Sq, Skv, H, KV, D, kw, seed):
    """dQ, dK, dV held by ``_hold_grads`` and bit-equal on a second call;
    the forward's O bit-equal with and without its LSE output."""
    q, k, v, do = _bwd_case(cuda, B, Sq, Skv, H, KV, D, seed)
    o, lse = fa.forward_with_lse(q, k, v, **kw)
    assert torch.equal(o, fa.flash_attention(q, k, v, **kw))
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    grads = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    _hold_grads(grads, q, k, v, o, do, kw)
    again = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [127, 128, 129, 200])
@pytest.mark.parametrize("mode", list(BWD_MODES))
@pytest.mark.parametrize("D,H,KV", [(64, 8, 8), (128, 16, 8), (160, 8, 2),
                                    (256, 8, 4), (64, 16, 2), (128, 12, 2)])
def test_flash_backward_matches_plain(cuda, mode, D, H, KV, S):
    """dQ, dK, dV at every head dim and mode, G 1, 2, 4, 6 and 8, B 1 and
    3, with Sq at, just under and just over a whole 128-row tile and past
    it (Skv = Sq, or 133 more in full mode: Sq < Skv); the window (100)
    ends inside a 64-row tile."""
    Skv = S + 133 if mode == "full" else S
    _bwd_holds(cuda, 1 if S % 2 else 3, S, Skv, H, KV, D, BWD_MODES[mode],
               D + S)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(BWD_MODES))
@pytest.mark.parametrize("D", [64, 128])
def test_flash_backward_at_both_dkdv_designs(cuda, mode, D):
    """The wgmma head dims' two dK/dV designs: 64-key CTAs on a grid that
    would leave the card's SMs short of two 128-key CTAs each, 128-key
    CTAs on one that would not (a ragged 1500-key sequence, B chosen from
    the card's SM count); then each design at the other's shape, chosen
    by ``set_bwd_keys``, and the rule again after it."""
    kw = BWD_MODES[mode]
    Skv = 1700 if mode == "full" else 1500
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    big = -(-2 * sms // (-(-Skv // 128) * 8))
    shapes = []
    for B, Sq, want in ((1, 200, 64), (big, 1500, 128)):
        skv = Skv if B == big else Sq + (133 if mode == "full" else 0)
        assert fa.bwd_design(B, skv, 8, D) == f"wgmma, {want}-key dK/dV CTAs"
        _bwd_holds(cuda, B, Sq, skv, 16, 8, D, kw, D + B)
        shapes.append((B, Sq, skv, 192 - want))
    try:
        for B, Sq, skv, keys in shapes:
            fa.set_bwd_keys(keys)
            assert fa.bwd_design(B, skv, 8, D) == \
                f"wgmma, {keys}-key dK/dV CTAs"
            _bwd_holds(cuda, B, Sq, skv, 16, 8, D, kw, D + B + 1)
    finally:
        fa.set_bwd_keys(0)
    assert fa.bwd_design(1, 200, 8, D) == "wgmma, 64-key dK/dV CTAs"
    with pytest.raises(ValueError):
        fa.set_bwd_keys(96)


@pytest.mark.cuda
def test_flash_backward_workspace_rows_come_from_the_source(cuda):
    """The wrapper sizes the backward's workspace by the library's own
    export: Sq rounded up to a whole 128-row tile."""
    assert [fa.bwd_rows(n) for n in (1, 127, 128, 129, 416, 1536)] == [
        128, 128, 128, 256, 512, 1536]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 160])
def test_flash_backward_is_bit_equal_after_other_work(cuda, D):
    """dQ, dK, dV bit-equal across calls with other work between them on
    the stream (a backward at another shape, a matmul) and with a call on
    a side stream while a matmul keeps the card's SMs busy: a sum whose
    order followed the scheduling would show."""
    kw = dict(causal=True)
    q, k, v, do = _bwd_case(cuda, 2, 300, 300, 16, 4, D, 11)
    o, lse = fa.forward_with_lse(q, k, v, **kw)
    first = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    q2, k2, v2, do2 = _bwd_case(cuda, 3, 700, 900, 8, 8, D, 12)
    o2, lse2 = fa.forward_with_lse(q2, k2, v2, causal=False)
    fa.flash_attention_bwd(q2, k2, v2, o2, do2, lse2, causal=False)
    x = torch.randn((4096, 4096), device=cuda)
    y = x @ x
    assert all(torch.equal(a, b) for a, b in zip(
        first, fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)))
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    for _ in range(4):
        y = y @ x
    with torch.cuda.stream(side):
        on_side = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize(cuda)
    assert all(torch.equal(a, b) for a, b in zip(first, on_side))
    assert bool(torch.isfinite(y).any())


@pytest.mark.cuda
def test_flash_autograd_goes_through_the_backward_kernel(cuda):
    """With grad, ``ops.attention_*`` go through ``FlashAttention``: the
    forward kernel with its LSE, the backward kernel for the gradients
    (one launch each), never the plain version; a non-contiguous dO is
    made contiguous first."""
    q, k, v, do = _bwd_case(cuda, 1, 256, 256, 8, 2, 128, 5)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    f0, b0 = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    o = ops.attention_windowed(qq, kk, vv, window=64)
    assert o.grad_fn is not None
    dot = do.transpose(0, 1).contiguous().transpose(0, 1)
    o.backward(dot)
    assert fa.flash_attention.launches - f0 == 1
    assert fa.flash_attention_bwd.launches - b0 == 1
    kw = dict(causal=True, window=64)
    want = fa.flash_attention_bwd(q, k, v, o.detach(), do,
                                  fa.forward_with_lse(q, k, v, **kw)[1], **kw)
    assert all(torch.equal(a, b) for a, b in
               zip((qq.grad, kk.grad, vv.grad), want))


@pytest.mark.cuda
def test_kernels_without_a_backward_raise_under_grad_on_the_card(cuda):
    """decode, paged decode, spec_accept and int8_matmul raise under
    grad with an input that requires it; never a silent detach
    (rwkv6_scan has its backward kernel:
    ``test_rwkv6_autograd_goes_through_the_backward_kernel``)."""
    g = lambda *s: torch.randn(*s, device=cuda).requires_grad_()  # noqa
    i32 = lambda *s: torch.zeros(s, device=cuda, dtype=torch.int32)  # noqa
    bf = lambda *s: g(*s).bfloat16().detach().requires_grad_()  # noqa
    calls = {
        "decode_attention": lambda: ops.decode_attention(
            bf(1, 1, 2, 64), bf(1, 8, 2, 64), bf(1, 8, 2, 64), i32(1, 8),
            i32(1)),
        "paged_decode_attention": lambda: ops.paged_decode_attention(
            bf(1, 1, 2, 64), bf(2, 16, 2, 64), bf(2, 16, 2, 64), i32(1, 2),
            i32(1), page_size=16),
        "spec_accept": lambda: ops.spec_accept(
            i32(2), g(2, 32), g(3, 32), torch.rand(2, device=cuda)),
        "int8_matmul": lambda: ops.int8_matmul(
            bf(4, 64), torch.zeros((64, 32), device=cuda, dtype=torch.int8),
            torch.ones(32, device=cuda)),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match=f"^{name}: the CUDA kernel has "
                                             "no backward"):
            call()


# ---------------------------------------------------------------------------
# the rwkv6 scan's backward kernel
# ---------------------------------------------------------------------------

def _hold_rwkv_grads(grads, a, dy, dS, chunk, states):
    """Each leaf of the kernel's gradient against ``plain_backward`` by
    ``rs.backward_error``'s rule on the same chunk-start states (within
    max(3x the float32 ``plain_backward``'s own error there,
    ``rs.BWD_ULPS`` f32 ulps of the leaf's max |grad|)).  Returns the
    worst error over its limit."""
    _, worst, what = rs.backward_error(grads, *a, dy, dS, chunk=chunk,
                                       states=states)
    assert worst <= 1.0, (worst, what)
    return worst


@pytest.mark.cuda
@pytest.mark.parametrize("D", rs.HEAD_DIMS)
@pytest.mark.parametrize("T,chunk", [(192, 8), (128, 64), (40, 40),
                                     (30, 6)])
@pytest.mark.parametrize("ds_T", [False, True])
def test_rwkv6_backward_matches_plain(cuda, D, T, chunk, ds_T):
    """The backward kernel at every head dim, the train chunk 8, chunk
    64, a 40-row ragged tail carrying a state and a 6-row chunk, dS_T
    zero and nonzero; decays to exp(-e^1.5) at the short chunks, and w
    in [exp(-e^-1), exp(-e^-4)] = [0.69, 0.98] past them (where kA /
    A_incl, the gradient's own term, stays in float32: the train path
    runs chunk 8); the forward's out and final state bit-equal with and
    without the states output, whose first chunk is state0 and every
    chunk within 5e-4 x max(1, the chunk's max |plain|) of
    ``plain_states``; bit-equal on a second call."""
    a = list(_rwkv(cuda, 2, T, 3, D, T + D, -6.0))
    if chunk > 8:
        x = torch.rand(a[3].shape, generator=torch.Generator(cuda)
                       .manual_seed(T), device=cuda)
        a[3] = torch.exp(-torch.exp(-4.0 + 3.0 * x))
    gen = torch.Generator(cuda).manual_seed(D)
    dy = torch.randn((2, T, 3, D), generator=gen, device=cuda)
    dS = torch.randn((2, 3, D, D), generator=gen, device=cuda) \
        if ds_T else None
    o, sT, states = rs.forward_with_states(*a, chunk=chunk)
    o2, sT2 = rs.rwkv6_scan(*a, chunk=chunk)
    assert torch.equal(o, o2) and torch.equal(sT, sT2)
    assert states.shape == (2, 3, T // chunk, D, D)
    assert torch.equal(states[:, :, 0], a[5])
    assert rs.states_error(states, *a[:4], chunk=chunk, tol=5e-4) <= 1.0
    grads = rs.rwkv6_scan_bwd(*a[:5], states, dy, dS, chunk=chunk)
    _hold_rwkv_grads(grads, a, dy, dS, chunk, states)
    again = rs.rwkv6_scan_bwd(*a[:5], states, dy, dS, chunk=chunk)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))


@pytest.mark.cuda
@pytest.mark.parametrize("D", rs.HEAD_DIMS)
@pytest.mark.parametrize("T,group", [(40, 2), (24, 8), (8, 4)])
def test_rwkv6_backward_groups_and_checkpoints(cuda, D, T, group):
    """The backward's two kernels at chunk 8 on a ragged last group (5
    chunks in groups of 2), on fewer chunks than a group (3 of 8) and on
    one chunk, at every head dim: one launch counted a call; every leaf
    within ``backward_error``'s rule of ``plain_backward`` on the
    kernel's chunk-start states; the chain's checkpoints and dstate0
    within ``dstate_error``'s rule of ``plain_dstate``; bit-equal on a
    second call; dr, dk, dv, dw and dstate0 the same bits at group 1 and
    at every chain split (the body recomputes dS inside a group with the
    chain's operations), du within the rule there."""
    a = list(_rwkv(cuda, 2, T, 3, D, T + D, -6.0))
    gen = torch.Generator(cuda).manual_seed(D + group)
    dy = torch.randn((2, T, 3, D), generator=gen, device=cuda)
    dS = torch.randn((2, 3, D, D), generator=gen, device=cuda)
    _, _, states = rs.forward_with_states(*a, chunk=8)
    n = rs.rwkv6_scan_bwd.launches
    *grads, ck = rs.rwkv6_scan_bwd(*a[:5], states, dy, dS, chunk=8,
                                   group=group, checkpoints=True)
    assert rs.rwkv6_scan_bwd.launches == n + 1
    assert ck.shape == (2, 3, -(-(T // 8) // group), D, D)
    _hold_rwkv_grads(grads, a, dy, dS, 8, states)
    _, frac, what = rs.dstate_error(ck, grads[5], a[0], a[3], dy, dS,
                                    chunk=8, group=group)
    assert frac <= 1.0, (frac, what)
    again = rs.rwkv6_scan_bwd(*a[:5], states, dy, dS, chunk=8, group=group,
                              checkpoints=True)
    assert all(torch.equal(x, y) for x, y in zip([*grads, ck], again))
    for g2, dv in [(1, None)] + [(group, dv) for dv in rs.CHAIN_SPLITS[D]]:
        other = rs.rwkv6_scan_bwd(*a[:5], states, dy, dS, chunk=8,
                                  group=g2, dv=dv)
        assert all(torch.equal(grads[i], other[i]) for i in (0, 1, 2, 3, 5))
        _hold_rwkv_grads(other, a, dy, dS, 8, states)


@pytest.mark.cuda
def test_rwkv6_backward_reads_unaligned_inputs(cuda):
    """r starting 4 bytes past a 16-byte boundary sends the backward's
    loads to 4-byte cp.async copies (``aligned`` is False) and gives the
    same bits as the TMA loads of an aligned copy; states that do not
    start on 16 bytes are refused."""
    a = list(_rwkv(cuda, 2, 64, 3, 64, 23, -6.0))
    gen = torch.Generator(cuda).manual_seed(23)
    dy = torch.randn((2, 64, 3, 64), generator=gen, device=cuda)
    _, _, states = rs.forward_with_states(*a, chunk=8)
    buf = torch.empty(a[0].numel() + 1, device=cuda)
    buf[1:] = a[0].flatten()
    r = buf[1:].view(a[0].shape)
    assert r.data_ptr() % 16 and not rs.aligned(r, *a[1:4])
    got = rs.rwkv6_scan_bwd(r, *a[1:5], states, dy, chunk=8)
    want = rs.rwkv6_scan_bwd(*a[:5], states, dy, chunk=8)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    sbuf = torch.empty(states.numel() + 1, device=cuda)
    sbuf[1:] = states.flatten()
    with pytest.raises(ValueError, match="16 bytes"):
        rs.rwkv6_scan_bwd(*a[:5], sbuf[1:].view(states.shape), dy, chunk=8)


@pytest.mark.cuda
def test_rwkv6_autograd_goes_through_the_backward_kernel(cuda):
    """With grad, ``ops.rwkv6_scan`` goes through ``RWKV6Scan``: one
    forward launch (with the chunk-start states), one backward launch,
    never a plain version; the gradients are the backward kernel's on
    the same inputs bit for bit (``test_rwkv6_backward_matches_plain``
    holds the kernel to ``plain_backward``); a strided input (``timemix_parallel``'s split of the ragged tail)
    and a dS_T from the next call are taken."""
    a = _rwkv(cuda, 2, 100, 4, 64, 11, -6.0)
    xs = [t.clone().requires_grad_() for t in a]
    gen = torch.Generator(cuda).manual_seed(3)
    dy = torch.randn((2, 100, 4, 64), generator=gen, device=cuda)
    f0, b0 = rs.rwkv6_scan.launches, rs.rwkv6_scan_bwd.launches
    y1, s1 = ops.rwkv6_scan(*(t[:, :96] for t in xs[:4]), xs[4], xs[5],
                            chunk=8)
    y2, s2 = ops.rwkv6_scan(*(t[:, 96:] for t in xs[:4]), xs[4], s1,
                            chunk=4)
    assert y1.grad_fn is not None and y2.grad_fn is not None
    torch.autograd.backward(torch.cat([y1, y2], 1), dy)
    assert rs.rwkv6_scan.launches - f0 == 2
    assert rs.rwkv6_scan_bwd.launches - b0 == 2
    # the tail call's gradients, and the first call's under the tail's
    # dstate0, by hand
    tail = [t[:, 96:].contiguous() for t in a[:4]]
    _, sT, st1 = rs.forward_with_states(*(t[:, :96] for t in a[:4]), a[4],
                                        a[5], chunk=8)
    _, _, st2 = rs.forward_with_states(*tail, a[4], sT, chunk=4)
    g2 = rs.rwkv6_scan_bwd(*tail, a[4], st2, dy[:, 96:], None, chunk=4)
    g1 = rs.rwkv6_scan_bwd(*(t[:, :96].contiguous() for t in a[:4]), a[4],
                           st1, dy[:, :96].contiguous(), g2[5], chunk=8)
    for i in range(4):
        assert torch.equal(xs[i].grad, torch.cat([g1[i], g2[i]], 1))
    assert torch.equal(xs[4].grad, g1[4] + g2[4])
    assert torch.equal(xs[5].grad, g1[5])


@pytest.mark.cuda
def test_tiny_rwkv_train_step_on_the_card_matches_the_plain_versions(cuda):
    """A narrow rwkv6's train step on the card (the scan and its backward
    kernel) launches exactly 2 x layers scans (remat) and layers backward
    calls, and its loss is within 1e-3 relative of the same step under
    ``ops.set_backend("ref")``, its params finite.  Its gradients, in
    float32, are held leaf by leaf against a float64 run of the ref
    backend: within max(1e-4, 3x the float32 ref backend's own error
    there) of the leaf's max |grad|, the rule of
    ``tests/test_torch_train_parity.py``; a zero or wrong gradient from
    the backward kernel is off by about the leaf's max."""
    from repro_torch.configs import get
    from repro_torch.configs.tiny import make_tiny
    from repro_torch.core.tree import leaves, leaves_with_path, tree_map
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.models.init import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.training.train import (TrainConfig, grads_fn,
                                            train_step)
    cfg = make_tiny(get("rwkv6-7b"), d_model=256)
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    batch = {k: torch.from_numpy(a).to(cuda) for k, a in Pipeline(
        DataConfig(cfg.vocab_size, 128, 2)).batch(0).items()}
    tc = TrainConfig(AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10))
    L = cfg.num_layers
    f0, b0 = rs.rwkv6_scan.launches, rs.rwkv6_scan_bwd.launches
    pk, _, mk = train_step(params, init_opt_state(params), batch, cfg=cfg,
                           tcfg=tc)
    assert rs.rwkv6_scan.launches - f0 == 2 * L
    assert rs.rwkv6_scan_bwd.launches - b0 == L
    assert all(bool(torch.isfinite(a).all()) for a in leaves(pk))
    ops.set_backend("ref")
    try:
        _, _, mr = train_step(params, init_opt_state(params), batch,
                              cfg=cfg, tcfg=tc)
    finally:
        ops.set_backend(None)
    assert abs(float(mk["loss"]) - float(mr["loss"])) <= 1e-3 * abs(
        float(mr["loss"]))

    c32 = cfg.replace(dtype="float32")
    p32 = tree_map(lambda a: a.float(), params)
    f0, b0 = rs.rwkv6_scan.launches, rs.rwkv6_scan_bwd.launches
    gk, _, _ = grads_fn(p32, batch, c32, tc)
    assert rs.rwkv6_scan.launches - f0 == 2 * L
    assert rs.rwkv6_scan_bwd.launches - b0 == L
    ops.set_backend("ref")
    try:
        gr, _, _ = grads_fn(p32, batch, c32, tc)
        g64, _, _ = grads_fn(tree_map(lambda a: a.double(), params), batch,
                             cfg.replace(dtype="float64"), tc)
    finally:
        ops.set_backend(None)
    for (key, a), b, c in zip(leaves_with_path(gk), leaves(gr),
                              leaves(g64)):
        assert bool(torch.isfinite(a).all()), key
        top = max(float(c.abs().max()), 1e-30)
        own = float((b.double() - c).abs().max()) / top
        err = float((a.double() - c).abs().max()) / top
        assert err <= max(1e-4, 3 * own), (key, err, own)


@pytest.mark.cuda
def test_tiny_train_step_on_the_card_matches_the_plain_versions(cuda):
    """A narrow llama's train step on the card (flash and its backward
    kernel) against the same step under ``ops.set_backend("ref")``: the
    loss within 1e-3 relative, every param within 2 lr plus one bf16 ulp
    of the element (Adam's first step sends g / |g|), most of them
    equal; launches exactly 2 x layers flash (remat) and layers
    backward."""
    from repro_torch.configs import get
    from repro_torch.configs.tiny import make_tiny
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.models.init import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.training.train import TrainConfig, train_step
    cfg = make_tiny(get("llama-1.5b"), d_model=256)
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    batch = {k: torch.from_numpy(a).to(cuda) for k, a in Pipeline(
        DataConfig(cfg.vocab_size, 128, 2)).batch(0).items()}
    tc = TrainConfig(AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10))
    f0, b0 = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    pk, _, mk = train_step(params, init_opt_state(params), batch, cfg=cfg,
                           tcfg=tc)
    assert fa.flash_attention.launches - f0 == 2 * cfg.num_layers
    assert fa.flash_attention_bwd.launches - b0 == cfg.num_layers
    ops.set_backend("ref")
    try:
        pr, _, mr = train_step(params, init_opt_state(params), batch,
                               cfg=cfg, tcfg=tc)
    finally:
        ops.set_backend(None)
    assert abs(float(mk["loss"]) - float(mr["loss"])) <= 1e-3 * abs(
        float(mr["loss"]))
    lr, same, total = float(mk["lr"]), 0, 0
    for a, b in zip(leaves(pk), leaves(pr)):
        top = torch.maximum(a.float().abs(), b.float().abs()).clamp(
            min=2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
        assert bool(((a.float() - b.float()).abs() <= 2 * lr + ulp).all())
        same += int((a == b).sum())
        total += a.numel()
    assert same / total > 0.5
