"""The port's CUDA kernels against their plain PyTorch versions.

These need the card (and nvcc, which builds the kernels at first use);
they carry the ``cuda`` marker and skip without one.  The module imports
neither JAX nor ``repro``, so it runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py

Tolerances as in the reference kernel tests: bf16 2e-2 abs, f32 2e-5 abs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

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
@pytest.mark.parametrize("S", [37, 64, 200, 512])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("D,H,KV", [(128, 16, 8), (64, 8, 2)])
def test_flash_kernel_matches_plain(cuda, S, mode, D, H, KV):
    gen = torch.Generator(cuda).manual_seed(S)
    q, k, v = (torch.randn((2, S, n, D), generator=gen, device=cuda,
                           dtype=torch.bfloat16) for n in (H, KV, KV))
    kw = MODES[mode]
    o = fa.flash_attention(q, k, v, **kw)
    assert float((o.float() - fa.plain(q, k, v, **kw).float()).abs().max()) \
        < 2e-2


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
    o_ref = da.plain(q, kp, vp, pt_t, pos_t, **kw)
    t = 2e-2 if dtype == torch.bfloat16 else 2e-5
    assert float((o.float() - o_ref.float()).abs().max()) < t
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
    o_ref = da.plain(q, kp, vp, pt_t, pos_t)
    assert float((o.float() - o_ref.float()).abs().max()) < 2e-2


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
