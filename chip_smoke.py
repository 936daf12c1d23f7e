"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; imports nothing of JAX or ``repro``.
Phases, each printing its own lines (any failure exits non-zero before
the result line):

  1. device  : the card's name and power limit (nvidia-smi)
  2. build   : both CUDA kernels built from ``src/repro_torch/kernels/csrc``
  3. kernels : each kernel against its plain PyTorch version on the card
               in bf16 at the slice's shapes, with the tolerance, and its
               time beside the plain version's, the library call's and the
               bound
  4. engine  : llama-1.5b at full width (bf16, random weights from a seed)
               served by ``PagedEngine``: six requests, greedy and sampled
               rows mixed, page-gated admission, conservation, the
               kernels' launch counts on that run, and one decode step's
               logits against the plain versions
  5. the kernels' JSON line, the card line, and the result line
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM data sheet, dense: bf16 tensor cores, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16_TOL = 2e-2            # kernel vs plain, per element, abs
# One decode step's logits, kernels vs plain versions, relative to the
# largest logit.  The two paths differ by about one bf16 ulp per attention
# output, and the random-init model amplifies that over 24 layers: the
# reference init takes fan-in from the stacked repeat axis (std 24**-0.5),
# so scores reach O(100), the softmax is near one-hot and the residual
# stream grows to O(1000), where a bf16 ulp is 4 to 8.
LOGIT_REL_TOL = 0.1
SEED = 0


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    tf, tb = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (tf, "operations") if tf >= tb else (tb, "bytes")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_flash(fa, gen) -> dict:
    B, H, KV, D = 1, 16, 8, 128
    # causal at every prompt length of the engine phase, and 2048
    cases = [(S, dict(causal=True))
             for S in (37, 200, 511, 512, 1024, 1536, 2048)]
    cases += [(512, dict(causal=True, window=128)),
              (512, dict(causal=False)),
              (512, dict(causal=True, softcap=50.0))]
    worst = 0.0
    row = None
    for S, kw in cases:
        q, k, v = (torch.randn((B, S, n, D), generator=gen, device="cuda",
                               dtype=torch.bfloat16) for n in (H, KV, KV))
        o = fa.flash_attention(q, k, v, **kw)
        ref = fa.plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = max_err(o, ref)
        worst = max(worst, err)
        if not torch.isfinite(o).all() or err > BF16_TOL:
            raise AssertionError(f"flash S={S} {kw}: max_abs_err {err} > "
                                 f"{BF16_TOL}")
        line = f"flash S={S} {kw}: max_abs_err={err:.3e} (tol {BF16_TOL})"
        if S == 1536 and kw == dict(causal=True):
            # the timed shape: the main path's longest prompt
            ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True))
            plain_ms = time_ms(lambda: fa.plain(q, k, v, causal=True),
                               iters=5)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib_ms = time_ms(lambda: torch.nn.functional
                             .scaled_dot_product_attention(
                                 qt, kt, vt, is_causal=True, enable_gqa=True))
            pairs = S * (S + 1) / 2
            flops = 4 * B * H * D * pairs
            nbytes = 2 * B * S * D * (2 * H + 2 * KV)
            bms, by = bound(flops, nbytes)
            row = dict(name="flash_attention", route="cuda",
                       source="src/repro_torch/kernels/csrc/"
                              "flash_attention.cu",
                       replaces="src/repro/kernels/flash_attention.py:89",
                       ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                       library_ms=lib_ms)
            line += (f" | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                     f"sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
                     f"{flops / ms / 1e9:.1f} TFLOP/s")
        log(line)
    row["max_abs_err"] = worst
    return row


def _pools(P, ps, KV, D, gen):
    return (torch.randn((P, ps, KV, D), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))


def check_paged(da, gen) -> dict:
    B, H, KV, D, ps, NP, P = 4, 16, 8, 128, 16, 128, 512
    rng = np.random.default_rng(SEED)
    worst = 0.0
    for name, kw in (("plain", {}), ("window", dict(window=256)),
                     ("softcap", dict(softcap=50.0))):
        q = torch.randn((B, 1, H, D), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        kp, vp = _pools(P, ps, KV, D, gen)
        pt = np.full((B, NP), -1, np.int32)
        pos = np.zeros((B,), np.int32)
        perm = list(rng.permutation(P))
        for b in range(B - 1):               # the last row stays dead
            n = int(rng.integers(1, NP + 1))
            pt[b, :n] = [perm.pop() for _ in range(n)]
            holes = rng.choice(n, size=n // 8, replace=False)
            pt[b, holes[holes > 0]] = -1      # unmapped pages inside
            pos[b] = int(rng.integers(0, n * ps))
        pos[B - 1] = int(rng.integers(0, NP * ps))
        pt_t = torch.from_numpy(pt).cuda()
        pos_t = torch.from_numpy(pos).cuda()
        o = da.paged_decode_attention(q, kp, vp, pt_t, pos_t, **kw)
        ref = da.plain(q, kp, vp, pt_t, pos_t, **kw)
        torch.cuda.synchronize()
        err = max_err(o, ref)
        worst = max(worst, err)
        dead = float(o[B - 1].float().abs().max())
        if not torch.isfinite(o).all() or err > BF16_TOL or dead != 0.0:
            raise AssertionError(f"paged {name}: max_abs_err {err} (tol "
                                 f"{BF16_TOL}), dead row max {dead}")
        log(f"paged_decode {name}: positions {pos.tolist()}, max_abs_err="
            f"{err:.3e} (tol {BF16_TOL}), dead row exactly 0")

    # the timed shape: 4 live rows near position 1000, pools rotated so
    # each call finds its pages cold in the 50 MB L2, as a layer would
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    pools = [tuple(_pools(P, ps, KV, D, gen)) for _ in range(4)]
    pos = torch.tensor([1000, 990, 1010, 1005], dtype=torch.int32,
                       device="cuda")
    pt = torch.from_numpy(np.stack([rng.permutation(P)[:NP]
                                    for _ in range(B)]).astype(np.int32))
    pt = pt.cuda()
    err = max_err(da.paged_decode_attention(q, *pools[0], pt, pos),
                  da.plain(q, *pools[0], pt, pos))
    worst = max(worst, err)
    if err > BF16_TOL:
        raise AssertionError(f"paged timed case: max_abs_err {err}")
    it = iter(range(1 << 30))

    def kern():
        kp, vp = pools[next(it) % len(pools)]
        da.paged_decode_attention(q, kp, vp, pt, pos)

    ms = time_ms(kern, iters=40)
    plain_ms = time_ms(lambda: da.plain(q, *pools[0], pt, pos), iters=10)
    live_pages = int(sum(int(p) // ps + 1 for p in pos.tolist()))
    kv_bytes = 2 * live_pages * ps * KV * D * 2
    nbytes = kv_bytes + 2 * B * H * D * 2 + pt.numel() * 4 + B * 4
    valid = sum(int(p) + 1 for p in pos.tolist())
    flops = 4 * H * D * valid
    bms, by = bound(flops, nbytes)
    log(f"paged_decode timed B={B} positions {pos.tolist()}: max_abs_err="
        f"{err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bms:.4f} ms ({by}, {kv_bytes / 1e6:.1f} MB of K+V), "
        f"{nbytes / ms / 1e6:.1f} GB/s")
    return dict(name="paged_decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/"
                       "paged_decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:180",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


# ---------------------------------------------------------------------------
# phase 4: the engine at full width
# ---------------------------------------------------------------------------

def decode_logits(engine, paged):
    """One decode step's logits on a copy of the engine's pools (the
    engine state is left untouched)."""
    from repro_torch.models.model import forward
    s = engine.state
    caches = [[{"attn": {k: a.clone() for k, a in layer["attn"].items()}}
               for layer in grp] for grp in s.caches]
    pt = torch.where(s.active[:, None], s.page_table,
                     torch.full_like(s.page_table, -1))
    with torch.no_grad():
        logits = forward(engine.params, {"tokens": s.last_token[:, None]},
                         cfg=engine.cfg, mode="decode",
                         caches=paged._weave(caches, pt),
                         positions=s.positions[:, None])
    return logits[:, 0].float()


def profiled(fn, label: str, per: int):
    """Run ``fn`` under torch.profiler; print wall time, device-busy time
    and the kernels that take most device time, per ``per`` units."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in evs)
    log(f"profile {label}: wall {wall * 1e3 / per:.3f} ms, device busy "
        f"{busy_us / 1e3 / per:.3f} ms ({100 * busy_us / 1e6 / wall:.1f}%"
        f" busy, {100 - 100 * busy_us / 1e6 / wall:.1f}% idle) per unit "
        f"over {per}")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"profile {label}:   {e.self_device_time_total / 1e3 / per:8.3f}"
            f" ms x{e.count / per:.0f}  {e.key[:90]}")


def run_engine(fa, da):
    from repro_torch.configs import get
    from repro_torch.kernels import ops
    from repro_torch.models.init import init_params
    from repro_torch.serving import paged
    from repro_torch.serving.engine import Request

    cfg = get("llama-1.5b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED),
                         device="cuda")
    torch.cuda.synchronize()
    log(f"engine: {cfg.name} {cfg.param_count() / 1e9:.3f}B params bf16 "
        f"initialised on the card in {time.perf_counter() - t0:.2f} s")
    # 160 pages (not the default 4 x 128): small enough that the sixth
    # request waits for pages while a row is free
    eng = paged.PagedEngine(cfg, params, page_size=16, rows=4,
                            max_len=2048, pages=160, seed=SEED,
                            device="cuda")
    log(f"engine: rows={eng.rows} page_size={eng.page_size} pages="
        f"{eng.pages} ({eng.pages * eng.page_bytes / 1e9:.3f} GB of KV)")
    rng = np.random.default_rng(SEED)
    lens = (37, 200, 511, 512, 1024, 1536)
    reqs = [Request(f"r{i}", rng.integers(0, cfg.vocab_size, n),
                    max_new_tokens=32,
                    temperature=0.7 if i % 2 else 0.0,
                    top_k=16 if i % 2 else 0)
            for i, n in enumerate(lens)]
    pending = list(reqs)
    prefill_s, prefill_tok, step_s = 0.0, 0, []
    waited_for_pages = []

    fa.flash_attention.launches = 0
    da.paged_decode_attention.launches = 0
    torch.cuda.synchronize()
    while pending or eng.requests:
        while pending:
            r = pending[0]
            need = len(r.prompt) + r.max_new_tokens
            if not eng.can_admit(need):
                if eng.free_slots and r.rid not in waited_for_pages:
                    waited_for_pages.append(r.rid)
                break
            t = time.perf_counter()
            if not eng.add_request(r):
                raise AssertionError(f"{r.rid} refused after can_admit")
            torch.cuda.synchronize()
            prefill_s += time.perf_counter() - t
            prefill_tok += len(r.prompt)
            pending.pop(0)
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        eng.check()
    flash_n = fa.flash_attention.launches
    paged_n = da.paged_decode_attention.launches
    n_steps = len(step_s)

    for r in reqs:
        if len(r.output) != 32 or not all(0 <= t < cfg.vocab_size
                                          for t in r.output):
            raise AssertionError(f"{r.rid}: output {r.output}")
    eng.check()
    if eng.allocator.free_pages != eng.pages or eng.requests:
        raise AssertionError("pages not all free after the last retire")
    if "r5" not in waited_for_pages:
        raise AssertionError(f"r5 never waited for pages with a row free: "
                             f"{waited_for_pages}")
    layers = cfg.num_layers
    if flash_n < layers * len(reqs) or paged_n < layers * n_steps:
        raise AssertionError(f"launch counts flash={flash_n} "
                             f"paged={paged_n} below {layers} per prefill "
                             f"({len(reqs)}) / per step ({n_steps})")
    log(f"engine: 6 requests x 32 tokens done in {n_steps} steps; waited "
        f"for pages with a row free: {waited_for_pages}; ledger conserved, "
        f"{eng.allocator.free_pages}/{eng.pages} pages free")
    log(f"engine: launches on the main path: flash_attention={flash_n} "
        f"({layers} x {len(reqs)} prefills), paged_decode_attention="
        f"{paged_n} ({layers} x {n_steps} steps)")
    med = sorted(step_s)[len(step_s) // 2]
    log(f"engine: prefill {prefill_tok} tokens in {prefill_s:.3f} s = "
        f"{prefill_tok / prefill_s:.1f} tok/s (first prefill includes "
        f"set-up); decode median {med * 1e3:.3f} ms/step over {n_steps} "
        f"steps (host clock, synchronised)")

    # where the time goes: four prefills, then four decode steps
    again = reqs[:4]
    for r in again:
        r.done = False
        r.output.clear()

    def admit():
        for r in again:
            if not eng.add_request(r):
                raise AssertionError("re-admission failed")

    profiled(admit, f"prefill of {[len(r.prompt) for r in again]} tokens",
             len(again))
    profiled(lambda: [eng.step(auto_retire=False) for _ in range(4)],
             "decode step (4 rows)", 4)

    # one decode step's logits, kernels vs plain versions, same state
    out_k = decode_logits(eng, paged)
    ops.set_backend("ref")
    try:
        out_r = decode_logits(eng, paged)
    finally:
        ops.set_backend(None)
    compared = max_err(out_k, out_r)
    scale = float(out_r.abs().max())
    agree = float((out_k.argmax(-1) == out_r.argmax(-1)).float().mean())
    if not torch.isfinite(out_k).all() or compared > LOGIT_REL_TOL * scale:
        raise AssertionError(f"decode logits kernel vs plain: {compared} "
                             f"> {LOGIT_REL_TOL} x {scale}")
    log(f"engine: one decode step's logits, kernels vs plain versions: "
        f"max_abs_err={compared:.3e}, max |logit| {scale:.3f} (tol "
        f"{LOGIT_REL_TOL} x max |logit|), argmax agreement {agree:.2f}")
    for row in list(eng.requests):
        eng.retire(row)
    eng.check()
    return flash_n, paged_n


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    card = gpu_line()
    log(f"device: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.build_all()
    log(f"build: {len(build.KERNELS)} kernels in "
        f"{time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")
    for name, text in build.logs.items():
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"build: {name}: {ln.strip()}")

    gen = torch.Generator("cuda").manual_seed(SEED)
    rows = [check_flash(fa, gen), check_paged(da, gen)]
    flash_n, paged_n = run_engine(fa, da)
    rows[0]["launches"], rows[1]["launches"] = flash_n, paged_n
    log(json.dumps({"kernels": rows}))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
