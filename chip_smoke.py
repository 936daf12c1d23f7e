"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; imports nothing of JAX or ``repro``.
Phases, each printing its own lines (any failure exits non-zero before
the result line):

  1. device  : the card's name and power limit (nvidia-smi)
  2. build   : the six CUDA kernels built from
               ``src/repro_torch/kernels/csrc``, one nvcc each, in parallel
  3. kernels : each kernel against its plain PyTorch version on the card
               at the main path's shapes (paged decode also over pages
               shared across rows), with the tolerance, and its time
               beside the plain version's, the library call's and the bound
               (``int8_matmul``, which no model calls, at rwkv6-7b's
               channel-mix shapes wk and wv at M = 4 and 1536, each on the
               design its shape routes to); times by CUDA events over
               calls queued behind a sleep kernel, and for flash, paged
               and dense decode, rwkv6_scan, int8_matmul and their
               library yardsticks also the profiler's device time
  4. paths   : each path driven with every launch count set to 0 just
               before it and read just after; llama-1.5b at full width
               (bf16, random weights from seeds 0 and 1):
               paged        ``PagedEngine``: six requests, page-gated
                            admission, conservation, a profile, one decode
                            step's logits against the plain versions
               dense        ``Engine(slots=4, max_len=2048)``: four
                            requests, decode_attention launched 24 times a
                            step, a profile, logits against plain
               spec_tier    a draft ``Engine`` (seed 1) proposing to a
                            target ``Engine`` (seed 0) through
                            ``step_probs`` / ``verify_slots_distribution``
                            / ``rollback_slot``; spec_accept launched once
                            a verify call
               one_program  ``Engine(slots=1)``: the stepwise verify
                            accepts 16/16 of its own greedy tokens
               spec_generate ``speculative_generate`` against
                            ``autoregressive_generate``
               self_draft   the tier and ``speculative_generate`` again
                            with the draft on the target's weights:
                            acceptance 1.0, full-accept and short-tail
                            rewinds
               migrate      the migration wire: a sampled 1024-token
                            request leaves a ``PagedEngine`` after 8
                            decode steps (v2, live pages) and a dense
                            ``Engine`` (v1, into another slot index),
                            crosses pack_slot -> compression -> an
                            attested, sealed ``Channel`` -> unpack_slot ->
                            repack_slot -> inject_slot into an engine of
                            another seed that holds a 200-token request,
                            and finishes with the unmigrated run's tokens
                            bit for bit; then a whole ``Engine(slots=2,
                            max_len=1024)`` workspace through ``Migrator``
                            in full and incrementally
               prefix       ``PagedEngine(prefix_cache=True)``: a 448-token
                            shared prompt; a cold donor, a full hit (no
                            flash launch, the donor's tokens bit for bit),
                            a 448-token partial hit whose 40-token suffix
                            runs through paged decode, another tenant's
                            miss, decoding side by side over shared pages
                            held byte-equal; the partial hit against a
                            cold run and a second warm run; pre-warm and
                            the v3 suffix-only hop against v2's bytes
               then rwkv6-7b at full width (bf16, seed 0; llama freed):
               rwkv         ``Engine(slots=4, max_len=2048)``: four
                            requests, rwkv6_scan launched 32 times per
                            chunk run of every prefill, a fifth request in
                            a retired slot equal to a fresh engine's,
                            inactive slots' state untouched, profiles,
                            prefill logits against plain, the chunk-64
                            prefill state against 1536 decode steps, and
                            one slot moved after 8 decode steps into a
                            second engine (seed 9) with the unmigrated
                            run's tokens
  5. the kernels' JSON line, the card line, and the result line
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM data sheet, dense: bf16 tensor cores, fp32 on the CUDA cores
# (no tensor cores), HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BF16_TOL = 2e-2            # kernel vs plain, per element, abs
SPEC_TOL = 1e-6            # spec_accept's dist, kernel vs plain, abs
RWKV_TOL = 5e-4            # rwkv6_scan output and state, abs (JAX suite's)
INT8_REL = 5e-3            # int8_matmul, relative to max |plain| (JAX suite's)
# the kernel no model path calls: held by its kernel phase alone
PHASE_ONLY = ("int8_matmul",)
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
    """Card time per call of ``fn`` run back to back, by CUDA events.  The
    calls are queued behind a sleep kernel that outlasts their enqueueing,
    so the events time the card and not the host, whose Python around a
    short kernel can take longer than the kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    # cycles at up to 2 GHz: 4x the host's enqueue time of the run, 2 ms+
    torch.cuda._sleep(int(2e9 * min(4 * iters * host_s + 2e-3, 1.0)))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, iters=40) -> tuple[float, list[str]]:
    """The profiler's device time per call of ``fn`` over ``iters`` calls:
    the time in which at least one of its kernels ran (the union of the
    kernels' intervals, since a dependent launch overlaps the kernel
    before it), over ``iters``; and those kernels' names."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted((e.time_range.start, e.time_range.end)
                         for e in evs):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    names = sorted({e.name.replace("(anonymous namespace)::", "")
                    .removeprefix("void ").split("<")[0].split("(")[0][:48]
                    for e in evs})
    return busy / 1e3 / iters, names


def bound(flops: float, nbytes: float,
          peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    tf, tb = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (tf, "operations") if tf >= tb else (tb, "bytes")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def row_tol(ref) -> torch.Tensor:
    """Per-row limit for a bf16 attention output (B, 1, H, D): 4 bf16
    ulps of the row's largest |value|, and never above ``BF16_TOL``.  On
    a long row the output averages many V rows and is small, so a fixed
    2e-2 would hide an error such as a dropped slot there."""
    top = ref.float().abs().flatten(1).amax(1).clamp(min=1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return torch.clamp(4 * ulp, max=BF16_TOL)


def row_err(out, ref, rows) -> tuple[float, float]:
    """(max abs error, max error / per-row limit) over ``rows``."""
    e = (out[rows].float() - ref[rows].float()).abs().flatten(1).amax(1)
    return float(e.max()), float((e / row_tol(ref[rows])).max())


def wrappers() -> dict:
    """Every kernel wrapper, by the name of its row in the JSON line."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import rwkv6_scan as rs
    from repro_torch.kernels import spec_verify as sv
    return {"flash_attention": fa.flash_attention,
            "paged_decode_attention": da.paged_decode_attention,
            "decode_attention": da.decode_attention,
            "spec_accept": sv.spec_accept,
            "rwkv6_scan": rs.rwkv6_scan,
            "int8_matmul": im.int8_matmul}


def port_kernels() -> set:
    """The names of the port's own CUDA kernels, read from their sources
    (``__global__`` functions of ``csrc/*.cu``)."""
    from repro_torch.kernels import build
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\("
                     r"(?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")
    return {n for f in build.CSRC.glob("*.cu")
            for n in pat.findall(f.read_text())}


def zero_counts():
    for fn in wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


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
            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)

            lib_ms = time_ms(sdpa)
            dev, names = device_ms(
                lambda: fa.flash_attention(q, k, v, causal=True))
            lib_dev, lib_names = device_ms(sdpa)
            if not torch.equal(o, fa.flash_attention(q, k, v, causal=True)):
                raise AssertionError("flash: a second call gave other bits")
            pairs = S * (S + 1) / 2
            flops = 4 * B * H * D * pairs
            nbytes = 2 * B * S * D * (2 * H + 2 * KV)
            bms, by = bound(flops, nbytes)
            row = dict(name="flash_attention", route="cuda",
                       source="src/repro_torch/kernels/csrc/"
                              "flash_attention.cu",
                       replaces="src/repro/kernels/flash_attention.py:89",
                       ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                       library_ms=lib_ms, device_ms=dev,
                       library_device_ms=lib_dev)
            line += (f" | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                     f"sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
                     f"{flops / ms / 1e9:.1f} TFLOP/s; bit-equal on a "
                     f"second call\nflash S={S} profiler device time per "
                     f"call: kernel {dev:.4f} ms {names}, sdpa {lib_dev:.4f}"
                     f" ms {lib_names}")
        log(line)
    row["max_abs_err"] = worst
    return row


def _pools(P, ps, KV, D, gen):
    return (torch.randn((P, ps, KV, D), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))


def check_paged(da, gen) -> dict:
    """Paged flash-decode at the paged engine's shape (B=4, H=16, KV=8,
    D=128, ps=16, NP=128, bf16): tables with holes, a window, a softcap,
    each live row held to its own limit and the dead row (no page mapped)
    exactly 0; then the timed shape near position 1000, bit-equal on a
    second call, beside SDPA over the same K/V gathered out of the pools
    before timing starts."""
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
        ref = da.paged_plain(q, kp, vp, pt_t, pos_t, **kw)
        torch.cuda.synchronize()
        err, frac = row_err(o, ref, slice(0, B - 1))
        worst = max(worst, err)
        dead = float(o[B - 1].float().abs().max())
        if not torch.isfinite(o).all() or frac > 1.0 or dead != 0.0:
            raise AssertionError(f"paged {name}: max_abs_err {err} at "
                                 f"{frac:.2f} x its row's limit (4 bf16 "
                                 f"ulps of the row's max |ref|, at most "
                                 f"{BF16_TOL}), dead row max {dead}")
        log(f"paged_decode {name} {kw}: positions {pos.tolist()}, "
            f"max_abs_err={err:.3e}, worst row at {frac:.2f} x its limit "
            f"(4 bf16 ulps of the row's max |ref|, at most {BF16_TOL}), "
            f"dead row exactly 0")

    # pages shared across rows, as the prefix cache maps them: every row
    # leads with the same 28 pages, then private ones; then a B=1 row
    # (a suffix-prefill token) mid-page in a copy of a cached tail page
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    kp, vp = _pools(P, ps, KV, D, gen)
    perm = list(rng.permutation(P))
    shared = [perm.pop() for _ in range(28)]
    pt = np.full((B, NP), -1, np.int32)
    pos = np.array([469, 470, 488, 500], np.int32)
    for b in range(B):
        pt[b, :33] = shared + [perm.pop() for _ in range(5)]
    tail, copy = perm.pop(), perm.pop()
    kp[copy] = kp[tail]
    vp[copy] = vp[tail]
    pt1 = np.full((1, NP), -1, np.int32)
    pt1[0, :30] = shared + [copy, perm.pop()]
    q1 = torch.randn((1, 1, H, D), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    for label, qq, tab, at in (("shared pages B=4", q, pt, pos),
                               ("after a copied page B=1", q1, pt1,
                                np.array([28 * ps + 5], np.int32))):
        tab = torch.from_numpy(tab).cuda()
        at = torch.from_numpy(at).cuda()
        o = da.paged_decode_attention(qq, kp, vp, tab, at)
        ref = da.paged_plain(qq, kp, vp, tab, at)
        err, frac = row_err(o, ref, slice(0, qq.shape[0]))
        worst = max(worst, err)
        if not torch.isfinite(o).all() or frac > 1.0:
            raise AssertionError(f"paged {label}: max_abs_err {err} at "
                                 f"{frac:.2f} x its row's limit")
        if not torch.equal(o, da.paged_decode_attention(qq, kp, vp, tab,
                                                        at)):
            raise AssertionError(f"paged {label}: a second call gave "
                                 "other bits")
        log(f"paged_decode {label}: positions {at.tolist()}, 28 leading "
            f"pages shared, max_abs_err={err:.3e}, worst row at "
            f"{frac:.2f} x its limit; bit-equal on a second call")

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
    o = da.paged_decode_attention(q, *pools[0], pt, pos)
    ref = da.paged_plain(q, *pools[0], pt, pos)
    err, frac = row_err(o, ref, slice(0, B))
    worst = max(worst, err)
    if frac > 1.0:
        raise AssertionError(f"paged timed case: max_abs_err {err} at "
                             f"{frac:.2f} x its row's limit")
    if not torch.equal(o, da.paged_decode_attention(q, *pools[0], pt, pos)):
        raise AssertionError("paged: a second call gave other bits")
    it = iter(range(1 << 30))

    def kern():
        kp, vp = pools[next(it) % len(pools)]
        da.paged_decode_attention(q, kp, vp, pt, pos)

    ms = time_ms(kern, iters=40)
    plain_ms = time_ms(lambda: da.paged_plain(q, *pools[0], pt, pos),
                       iters=10)
    # the library yardstick: no PyTorch call reads through a page table,
    # so SDPA runs over each pool's live pages gathered into a dense
    # (B, KV, S, D) cache before timing starts (the gather is not timed),
    # with the validity mask; rotated like the kernel's pools
    S = (int(pos.max()) // ps + 1) * ps
    ids = pt[:, :S // ps].long()
    dense = [tuple(x[ids].reshape(B, S, KV, D).transpose(1, 2).contiguous()
                   for x in pl) for pl in pools]
    qt = q.transpose(1, 2).contiguous()
    mask = (torch.arange(S, device="cuda")[None] <= pos[:, None])[
        :, None, None, :]
    lib_it = iter(range(1 << 30))

    def sdpa():
        kt, vt = dense[next(lib_it) % len(dense)]
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)

    lib_err = max_err(torch.nn.functional.scaled_dot_product_attention(
        qt, *dense[0], attn_mask=mask, enable_gqa=True).transpose(1, 2), ref)
    if lib_err > BF16_TOL:
        raise AssertionError(f"paged yardstick: SDPA over the gathered "
                             f"pages is {lib_err} from plain")
    lib_ms = time_ms(sdpa, iters=40)
    dev, names = device_ms(kern)
    lib_dev, lib_names = device_ms(sdpa)
    live_pages = int(sum(int(p) // ps + 1 for p in pos.tolist()))
    kv_bytes = 2 * live_pages * ps * KV * D * 2
    nbytes = kv_bytes + 2 * B * H * D * 2 + pt.numel() * 4 + B * 4
    valid = sum(int(p) + 1 for p in pos.tolist())
    flops = 4 * H * D * valid
    bms, by = bound(flops, nbytes)
    pages, splits = da.paged_split(NP, ps)
    # every page of the timed table is mapped: a run is live up to pos
    live_ctas = KV * sum(int(p) // (pages * ps) + 1 for p in pos.tolist())
    log(f"paged_decode timed B={B} positions {pos.tolist()}: max_abs_err="
        f"{err:.3e} ({frac:.2f} x its row's limit), kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa over pre-gathered K/V (gather not "
        f"timed) {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}, "
        f"{kv_bytes / 1e6:.1f} MB of K+V), {nbytes / ms / 1e6:.1f} GB/s")
    log(f"paged_decode timed: bit-equal on a second call; split over "
        f"{splits} runs of {pages} pages ({pages * ps} slots), "
        f"{KV * B * splits} CTAs a launch, {live_ctas} with live pages; "
        f"profiler device time per call: kernel {dev:.4f} ms {names}, sdpa "
        f"over pre-gathered K/V {lib_dev:.4f} ms {lib_names}")
    return dict(name="paged_decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/"
                       "paged_decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:180",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms, device_ms=dev,
                library_device_ms=lib_dev)


def _dense_case(B, Sc, KV, D, gen):
    return (torch.randn((B, Sc, KV, D), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))


def check_decode(da, gen) -> dict:
    """Dense flash-decode at the slice's shape (B=4, Sc=2048, H=16, KV=8,
    D=128, bf16): fill levels 37 / 512 / 2048 with rolled-back slots past
    the position, a ring-buffered window, a softcap, and one empty row
    (no valid slot), which must be exactly 0."""
    B, H, KV, D, Sc = 4, 16, 8, 128, 2048
    slot = np.arange(Sc)[None]
    worst = 0.0
    for name, kw in (("fill", {}), ("softcap", dict(softcap=50.0)),
                     ("window", dict(window=256))):
        q = torch.randn((B, 1, H, D), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        if name == "window":
            # local-layer ring buffer of 256 slots: slot s holds the
            # latest position p <= pos with p % 256 == s
            Sw, w = 256, kw["window"]
            pos = np.asarray([700, 1000, 100, 37], np.int32)
            p = pos[:, None] - ((pos[:, None] - slot[:, :Sw]) % Sw)
            ap = np.where(p >= 0, p, -1).astype(np.int32)
            ap[B - 1] = -1                        # the empty row
            kc, vc = _dense_case(B, Sw, KV, D, gen)
            assert w == Sw
        else:
            fill = np.asarray([37, 512, 2048, 0])
            pos = np.maximum(fill - 1, 0).astype(np.int32)
            pos[B - 1] = 100                      # empty row: no slot
            # rows 0 and 1 keep 6 rolled-back slots past their position
            held = np.minimum(fill + np.asarray([6, 6, 0, 0]), Sc)
            ap = np.where(slot < held[:, None], slot, -1).astype(np.int32)
            kc, vc = _dense_case(B, Sc, KV, D, gen)
        ap_t = torch.from_numpy(ap).cuda()
        pos_t = torch.from_numpy(pos).cuda()
        o = da.decode_attention(q, kc, vc, ap_t, pos_t, **kw)
        ref = da.plain(q, kc, vc, ap_t, pos_t, **kw)
        torch.cuda.synchronize()
        err, frac = row_err(o, ref, slice(0, B - 1))
        worst = max(worst, err)
        empty = float(o[B - 1].float().abs().max())
        if not torch.isfinite(o).all() or frac > 1.0 or empty != 0.0:
            raise AssertionError(f"decode {name}: max_abs_err {err} at "
                                 f"{frac:.2f} x its row's limit (4 bf16 "
                                 f"ulps of the row's max |ref|, at most "
                                 f"{BF16_TOL}), empty row max {empty}")
        log(f"decode_attention {name} {kw}: positions {pos.tolist()}, "
            f"max_abs_err={err:.3e}, worst row at {frac:.2f} x its limit "
            f"(4 bf16 ulps of the row's max |ref|, at most {BF16_TOL}), "
            f"empty row exactly 0")

    # the timed shape: 4 rows at the dense engine's mid-run positions,
    # caches rotated so each call finds them cold in the 50 MB L2
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    caches = [tuple(_dense_case(B, Sc, KV, D, gen)) for _ in range(4)]
    pos = torch.tensor([60, 530, 1050, 1560], dtype=torch.int32,
                       device="cuda")
    ap = torch.where(torch.arange(Sc, device="cuda")[None] <= pos[:, None],
                     torch.arange(Sc, device="cuda", dtype=torch.int32)[None],
                     -1).to(torch.int32)
    o = da.decode_attention(q, *caches[0], ap, pos)
    err, frac = row_err(o, da.plain(q, *caches[0], ap, pos), slice(0, B))
    worst = max(worst, err)
    if frac > 1.0:
        raise AssertionError(f"decode timed case: max_abs_err {err} at "
                             f"{frac:.2f} x its row's limit")
    if not torch.equal(o, da.decode_attention(q, *caches[0], ap, pos)):
        raise AssertionError("decode: a second call gave other bits")
    it = iter(range(1 << 30))

    def kern():
        kc, vc = caches[next(it) % len(caches)]
        da.decode_attention(q, kc, vc, ap, pos)

    ms = time_ms(kern, iters=40)
    plain_ms = time_ms(lambda: da.plain(q, *caches[0], ap, pos), iters=10)
    # the library yardstick: one SDPA call with the validity mask, on
    # (B, heads, S, D) copies made outside the timing
    kt, vt = (c.transpose(1, 2).contiguous() for c in caches[0])
    qt = q.transpose(1, 2).contiguous()
    mask = (ap >= 0)[:, None, None, :]
    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)

    lib_ms = time_ms(sdpa, iters=40)
    dev, names = device_ms(kern)
    lib_dev, lib_names = device_ms(sdpa)
    valid = sum(int(p) + 1 for p in pos.tolist())
    kv_bytes = 2 * valid * KV * D * 2
    nbytes = kv_bytes + valid * 4 + 2 * B * H * D * 2 + B * 4
    flops = 4 * H * D * valid
    bms, by = bound(flops, nbytes)
    log(f"decode_attention timed B={B} Sc={Sc} positions {pos.tolist()}: "
        f"max_abs_err={err:.3e} ({frac:.2f} x its row's limit), kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}, "
        f"{kv_bytes / 1e6:.1f} MB of K+V), {nbytes / ms / 1e6:.1f} GB/s")
    log(f"decode_attention timed: bit-equal on a second call; split over "
        f"{(Sc + da.CHUNK - 1) // da.CHUNK} chunks of {da.CHUNK} slots, "
        f"{KV * B * ((Sc + da.CHUNK - 1) // da.CHUNK)} CTAs a launch; profiler "
        f"device "
        f"time per call: kernel {dev:.4f} ms {names}, sdpa {lib_dev:.4f} ms "
        f"{lib_names}")
    return dict(name="decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:81",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms, device_ms=dev,
                library_device_ms=lib_dev)


def _spec_case(kind, g, V, gen):
    """(tokens, q, p, u) on the card: ``random`` draws the drafts from q;
    ``greedy`` is one-hot q and p agreeing on the first g // 2 tokens
    (g = 1: full acceptance); ``q0`` puts q_tok = 0 at the first draft."""
    if kind == "greedy":
        t = torch.randint(0, V, (g + 1,), generator=gen, device="cuda")
        d = t[:g].clone()
        d[g // 2:] = (d[g // 2:] + 1) % V
        if g == 1:
            d[0] = t[0]
        q = torch.nn.functional.one_hot(d, V).float()
        p = torch.nn.functional.one_hot(t, V).float()
        u = torch.rand((g,), generator=gen, device="cuda")
        return d.to(torch.int32), q, p, u
    q = torch.softmax(3 * torch.randn((g, V), generator=gen,
                                      device="cuda"), -1)
    p = torch.softmax(3 * torch.randn((g + 1, V), generator=gen,
                                      device="cuda"), -1)
    d = torch.multinomial(q, 1, generator=gen)[:, 0]
    if kind == "q0":
        q[0, d[0]] = 0.0
    u = torch.rand((g,), generator=gen, device="cuda")
    return d.to(torch.int32), q.contiguous(), p.contiguous(), u


def spec_bytes(g: int, n: int, V: int) -> int:
    """What ``spec_accept``'s inputs need: the tokens, uniforms and both
    token probabilities of the drafts up to the cut (min(n + 1, g) of
    each), row n of p (and of q when n < g), dist written once, and n."""
    return 4 * 4 * min(n + 1, g) + (2 if n < g else 1) * V * 4 + V * 4 + 4


def check_spec(sv, gen) -> dict:
    """spec_accept against its plain version at V = 32768 and 262144
    (gemma3_4b's vocab): n exactly, dist within 1e-6 abs; draft ids out
    of [0, V) rejected where they stand; bit-equal on a second call.  The
    tier's shape, g = 4, timed by events at both V, random drafts (n = 0)
    and greedy ones (n = 2), beside the bound and the back-to-back launch
    floor (an empty kernel timed the same way), with the profiler's
    device time of the V = 32768 row."""
    from repro_torch.kernels import build
    for ln in ptxas_lines(build.logs.get("spec_verify", ""),
                          "spec_accept_kernel",
                          {"Lb1E": "vec4", "Lb0E": "scalar"}):
        log(f"spec_accept build: {ln}")
    # ``gen`` gives the cases at V = 32768 and the timed row's inputs;
    # every other case comes from a generator of this check's own, so the
    # phases after it draw the same inputs whatever is added here
    own = torch.Generator("cuda").manual_seed(SEED)
    worst = 0.0
    for V, gs, g_ in ((32768, (1, 4, 8), gen), (262144, (4,), own)):
        for g in gs:
            for kind in ("random", "greedy", "q0"):
                d, q, p, u = _spec_case(kind, g, V, g_)
                n, dist = sv.spec_accept(d, q, p, u)
                n_ref, dist_ref = sv.plain(d, q, p, u)
                torch.cuda.synchronize()
                err = max_err(dist, dist_ref)
                worst = max(worst, err)
                if int(n) != int(n_ref) or err > SPEC_TOL:
                    raise AssertionError(f"spec_accept g={g} V={V} {kind}: "
                                         f"n {int(n)} vs {int(n_ref)}, dist "
                                         f"err {err}")
                log(f"spec_accept g={g} V={V} {kind}: n={int(n)} (plain "
                    f"{int(n_ref)}), dist max_abs_err={err:.3e} (tol "
                    f"{SPEC_TOL})")
    timed = {(32768, "random"): _spec_case("random", 4, 32768, gen)}
    for V in (32768, 262144):
        # one-hot drafts, all accepted but for an id out of [0, V) at 2
        # (p_2 = q_2: the residual is 0 and dist is p_2)
        d = torch.randint(0, V, (4,), generator=own, device="cuda")
        q = torch.nn.functional.one_hot(d, V).float()
        p, u = torch.cat([q, q[:1]]), torch.zeros(4, device="cuda")
        for bad in (V + 3, -1):
            dd = d.to(torch.int32)
            dd[2] = bad
            n, dist = sv.spec_accept(dd, q, p, u)
            n_ref, dist_ref = sv.plain(dd, q, p, u)
            err = max_err(dist, dist_ref)
            if int(n) != 2 or int(n_ref) != 2 or err > SPEC_TOL:
                raise AssertionError(f"spec_accept V={V} id {bad} at 2: n "
                                     f"{int(n)} (plain {int(n_ref)}), need "
                                     f"2; dist err {err}")
        log(f"spec_accept V={V}: draft ids {V + 3} and -1 at position 2 "
            f"rejected there (n=2, as plain), split {sv.split(V)} "
            f"(CTAs, threads)")
        for kind in ("random", "greedy"):
            if (V, kind) not in timed:
                timed[V, kind] = _spec_case(kind, 4, V, own)
    for (V, kind), (d, q, p, u) in timed.items():
        n1, d1 = sv.spec_accept(d, q, p, u)
        n2, d2 = sv.spec_accept(d, q, p, u)
        if not (torch.equal(n1, n2) and torch.equal(d1, d2)):
            raise AssertionError(f"spec_accept V={V} {kind}: a second call "
                                 "gave other bits")
        n = int(n1)
        ms = time_ms(lambda: sv.spec_accept(d, q, p, u), iters=100)
        nbytes = spec_bytes(4, n, V)
        bms, by = bound(4 * min(n + 1, 4) + 3 * V, nbytes)
        timed[V, kind] = dict(n=n, ms=ms, bound_ms=bms, bound_by=by,
                              nbytes=nbytes, args=(d, q, p, u))
    floor_ms = time_ms(lambda: torch.cuda._sleep(0), iters=100)
    row = timed[32768, "random"]
    d, q, p, u = row["args"]
    plain_ms = time_ms(lambda: sv.plain(d, q, p, u), iters=20)
    dev, names = device_ms(lambda: sv.spec_accept(d, q, p, u), iters=100)
    for (V, kind), t in timed.items():
        log(f"spec_accept timed g=4 V={V} {kind} (n={t['n']}): kernel "
            f"{t['ms']:.4f} ms, bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']}, {t['nbytes']} bytes), launch floor "
            f"{floor_ms:.4f} ms (an empty kernel back to back); split "
            f"{sv.split(V)}; bit-equal on a second call")
    log(f"spec_accept timed g=4 V=32768 random: plain {plain_ms:.4f} ms, "
        f"profiler device time per call {dev:.4f} ms {names}")
    extra = {f"{'v262144' if V == 262144 else 'v32768'}_{kind}": dict(
        n=t["n"], ms=t["ms"], bound_ms=t["bound_ms"])
        for (V, kind), t in timed.items() if (V, kind) != (32768, "random")}
    return dict(name="spec_accept", route="cuda",
                source="src/repro_torch/kernels/csrc/spec_verify.cu",
                replaces="src/repro/kernels/spec_verify.py:53",
                max_abs_err=worst, ms=row["ms"], plain_ms=plain_ms,
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=None, device_ms=dev, launch_floor_ms=floor_ms,
                split=list(sv.split(32768)), **extra)


def rwkv_runs(T: int, chunk: int = 64) -> list[tuple[int, int]]:
    """(chunk, rows) of each ``rwkv6_scan`` call a T-token prefill makes:
    the whole chunks in one call, a ragged tail as one chunk of its own."""
    c = min(chunk, T)
    cut = T // c * c
    return [(c, cut)] + ([(T - cut, T - cut)] if cut < T else [])


def _rwkv_inputs(B, T, H, D, gen):
    """r, k, v, state0 at half the reference suite's unit scale (so that
    at T = 1536 with decays near 1 the output stays near the suite's
    magnitudes, where an absolute 5e-4 measures the kernel rather than
    fp32 rounding), u at unit scale, and w = exp(-exp(ww)) with ww
    uniform in [-6, 1.5]: the whole range ``_projections`` produces, down
    to the exp(-e^1.5) floor."""
    def rnd(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")
    r, k, v = (rnd(B, T, H, D, scale=0.5) for _ in range(3))
    ww = -6.0 + 7.5 * torch.rand((B, T, H, D), generator=gen, device="cuda")
    return (r, k, v, torch.exp(-torch.exp(ww)), rnd(H, D),
            rnd(B, H, D, D, scale=0.5))


def check_rwkv6(rs, gen) -> dict:
    """rwkv6_scan against its plain version at rwkv6-7b's prefill shape
    (B=1, H=64, D=64, chunk 64): T = 1536, and T = 1000 split as
    ``timemix_parallel`` splits it (960 rows, then a 40-row tail carrying
    the state); output and final state within 5e-4 abs.  At T = 1536 also
    bit-equal on a second call, timed by events and by the profiler's
    device time, beside the bound; the 40-row tail call timed alone."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ref import rwkv6_ref
    for ln in ptxas_lines(build.logs.get("rwkv6_scan", ""),
                          "rwkv6_scan_kernel",
                          {"Lb1E": "tma", "Lb0E": "copies"}):
        log(f"rwkv6_scan build: {ln}")
    B, H, D = 1, 64, 64
    worst = 0.0
    for T in (1536, 1000):
        r, k, v, w, u, s0 = _rwkv_inputs(B, T, H, D, gen)
        outs = {}
        for name, fn in (("kernel", rs.rwkv6_scan), ("plain", rs.plain)):
            s, ys, t0 = s0, [], 0
            for c, n in rwkv_runs(T):
                y, s = fn(r[:, t0:t0 + n], k[:, t0:t0 + n], v[:, t0:t0 + n],
                          w[:, t0:t0 + n], u, s, chunk=c)
                ys.append(y)
                t0 += n
            outs[name] = (torch.cat(ys, 1), s)
        torch.cuda.synchronize()
        (o, sT), (o_ref, sT_ref) = outs["kernel"], outs["plain"]
        err = max(max_err(o, o_ref), max_err(sT, sT_ref))
        worst = max(worst, err)
        if not (torch.isfinite(o).all() and torch.isfinite(sT).all()) \
                or err > RWKV_TOL:
            raise AssertionError(f"rwkv6_scan T={T}: max_abs_err {err} > "
                                 f"{RWKV_TOL}")
        log(f"rwkv6_scan T={T} runs {rwkv_runs(T)}: max_abs_err={err:.3e} "
            f"over output and state (tol {RWKV_TOL}), max |out| "
            f"{float(o_ref.abs().max()):.3f}, max |state| "
            f"{float(sT_ref.abs().max()):.3f}")
    # the chunked form against the sequential oracle at the decay floor:
    # a finding (the cumulative decay underflows inside a 64-row chunk)
    r, k, v, w, u, s0 = _rwkv_inputs(B, 1536, H, D, gen)
    o, sT = rs.rwkv6_scan(r, k, v, w, u, s0, chunk=64)
    o_seq, s_seq = rwkv6_ref(r, k, v, w, u, s0)
    log(f"rwkv6_scan finding: chunk 64 vs the sequential oracle at T=1536 "
        f"with decays down to exp(-e^1.5): output max_abs_err="
        f"{max_err(o, o_seq):.3e} (max |out| {float(o_seq.abs().max()):.3f}),"
        f" state max_abs_err={max_err(sT, s_seq):.3e} (max |state| "
        f"{float(s_seq.abs().max()):.3f}); not asserted")

    # the timed shape: the main path's longest prefill, one layer's call
    T = 1536
    r, k, v, w, u, s0 = _rwkv_inputs(B, T, H, D, gen)

    def kern():
        return rs.rwkv6_scan(r, k, v, w, u, s0, chunk=64)
    o1, s1 = kern()
    o2, s2 = kern()
    if not (torch.equal(o1, o2) and torch.equal(s1, s2)):
        raise AssertionError("rwkv6_scan: a second call gave other bits")
    log(f"rwkv6_scan T={T}: bit-equal on a second call (split DV="
        f"{rs.split(B, H, D)}: {B * H * D // rs.split(B, H, D)} CTAs)")
    ms = time_ms(kern)
    dev, names = device_ms(kern)
    plain_ms = time_ms(lambda: rs.plain(r, k, v, w, u, s0, chunk=64),
                       iters=5)
    # fp32 products per chunk of c rows and head: rA S and (kA A_end)^T v
    # (2 c D^2 each) and the strictly lower scores and their product with
    # v (D c (c - 1) each)
    flops = B * H * sum(4 * c * D * D + 2 * D * c * (c - 1)
                        for c in [64] * (T // 64))
    nbytes = 4 * (5 * B * T * H * D + H * D + 2 * B * H * D * D)
    bms, by = bound(flops, nbytes, PEAK_F32_FLOPS)
    log(f"rwkv6_scan timed B={B} T={T} H={H} D={D} chunk 64: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}: "
        f"{flops / 1e9:.2f} GFLOP at the fp32 CUDA-core peak, "
        f"{nbytes / 1e6:.1f} MB), {flops / ms / 1e9:.2f} TFLOP/s, "
        f"{nbytes / ms / 1e6:.1f} GB/s = {bms / ms:.1%} of the bound's rate"
        f"\nrwkv6_scan profiler device time per call: {dev:.4f} ms "
        f"{names}")
    # the 40-row ragged tail of a 1000-token prefill, carrying a state
    rt, kt, vt, wt = (a[:, 960:1000] for a in (r, k, v, w))
    tail_ms = time_ms(lambda: rs.rwkv6_scan(rt, kt, vt, wt, u, s0, chunk=40))
    log(f"rwkv6_scan ragged tail B={B} T=40 H={H} D={D} chunk 40: kernel "
        f"{tail_ms:.4f} ms")
    return dict(name="rwkv6_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                replaces="src/repro/kernels/rwkv6_scan.py:74",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None, device_ms=dev,
                tail_ms=tail_ms)


def _int8_case(M, K, N, dtype, gen):
    x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
    wq = torch.randint(-127, 127, (K, N), generator=gen, device="cuda",
                       dtype=torch.int8)
    ws = 0.001 + 0.009 * torch.rand((N,), generator=gen, device="cuda")
    return x, wq, ws


def ptxas_lines(log_text: str, kernels: str, arg_names: dict) -> list[str]:
    """Registers and spills of each kernel whose name matches the regex
    ``kernels``, from ptxas -v, by kernel and template arguments (e.g.
    ``wgmma_kernel<256>``)."""
    import re
    lines, fn = [], None
    for ln in log_text.splitlines():
        m = re.search(rf"({kernels})I(.*?)EEv", ln)
        if "Compiling entry function" in ln:
            args = [arg_names.get(a, a[2:-1])
                    for a in re.findall(r"13__nv_bfloat16|L[ib]\d+E|f",
                                        m.group(2) + "E")] if m else []
            fn = f"{m.group(1)}<{','.join(args)}>" if m else None
        elif fn and ("registers" in ln or "spill" in ln):
            lines.append(f"{fn}: {ln.strip()}")
    return lines


def check_int8(im, gen) -> dict:
    """int8_matmul against its plain version at rwkv6-7b's channel-mix
    shapes, wk (4096 -> 14336) and wv (14336 -> 4096), at M = 4 (decode,
    the splitk design) and M = 1536 (prefill, the wgmma design), bf16 x,
    plus f32-x cases: within 5e-3 of max |plain|, bit-equal on a second
    call, each on the design its shape routes to.  All four bf16 shapes
    are timed beside the library call the kernel stands for (a bf16
    matmul of the dequantised weights, scaled), with the profiler's
    device time of both."""
    from repro_torch.kernels import build
    for ln in ptxas_lines(build.logs.get("int8_matmul", ""),
                          "wgmma_kernel|splitk_kernel|splitk_combine|"
                          "int8_matmul_kernel",
                          {"13__nv_bfloat16": "bf16", "f": "f32"}):
        log(f"int8_matmul build: {ln}")
    worst = worst_rel = 0.0
    timed, designs = {}, {}
    shapes = {"wk": (4096, 14336), "wv": (14336, 4096)}
    want = {4: "splitk", 1536: "wgmma"}
    cases = [(M, sh, torch.bfloat16) for M in (4, 1536) for sh in shapes]
    cases += [(4, "wk", torch.float32), (1536, "wv", torch.float32)]
    for M, sh, dtype in cases:
        K, N = shapes[sh]
        x, wq, ws = _int8_case(M, K, N, dtype, gen)
        before = dict(im.int8_matmul.routes)
        o = im.int8_matmul(x, wq, ws)
        ran = [r for r, n in im.int8_matmul.routes.items() if n > before[r]]
        ref = im.plain(x, wq, ws)
        torch.cuda.synchronize()
        err = max_err(o, ref)
        rel = err / float(ref.float().abs().max())
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        design = im.route(M, N, K, dtype, True)
        if dtype == torch.bfloat16 and design != want[M]:
            raise AssertionError(f"int8_matmul {sh} M={M}: routed to "
                                 f"{design}, not {want[M]}")
        if ran != [design]:
            raise AssertionError(f"int8_matmul {sh} M={M}: launched {ran}, "
                                 f"route says {design}")
        if not torch.isfinite(o.float()).all() or o.dtype != dtype \
                or rel > INT8_REL:
            raise AssertionError(f"int8_matmul {sh} M={M} {dtype}: "
                                 f"rel err {rel} > {INT8_REL}")
        if not torch.equal(o, im.int8_matmul(x, wq, ws)):
            raise AssertionError(f"int8_matmul {sh} M={M} {dtype} "
                                 f"({design}): a second call gave other "
                                 "bits")
        line = (f"int8_matmul {sh} M={M} K={K} N={N} x {str(dtype)[6:]}: "
                f"design {design}, max_abs_err / max |plain| = {rel:.3e} "
                f"(tol {INT8_REL}), bit-equal on a second call")
        if dtype == torch.bfloat16:
            def kern():
                return im.int8_matmul(x, wq, ws)

            def lib():
                return torch.matmul(x, wq.to(torch.bfloat16)) * ws

            ms = time_ms(kern, iters=20)
            plain_ms = time_ms(lambda: im.plain(x, wq, ws), iters=5)
            lib_ms = time_ms(lib, iters=20)
            dev, names = device_ms(kern)
            lib_dev, lib_names = device_ms(lib)
            flops = 2 * M * K * N
            nbytes = 2 * M * K + K * N + 4 * N + 2 * M * N
            bms, by = bound(flops, nbytes)
            designs[f"{sh}_M{M}"] = design
            timed[f"{sh}_M{M}"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms, device_ms=dev, library_device_ms=lib_dev)
            line += (f" | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                     f"library {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
                     f"{flops / ms / 1e9:.1f} TFLOP/s, "
                     f"{nbytes / ms / 1e6:.1f} GB/s\nint8_matmul {sh} M={M} "
                     f"profiler device time per call: kernel {dev:.4f} ms "
                     f"{names}, library {lib_dev:.4f} ms {lib_names}")
        log(line)
    # the row's own numbers are decode's on wk (M = 4): W8A16 is a
    # decode-bytes trade; the other three timed shapes beside them
    return dict(name="int8_matmul", route="cuda",
                source="src/repro_torch/kernels/csrc/int8_matmul.cu",
                replaces="src/repro/kernels/int8_matmul.py:42",
                max_abs_err=worst, max_rel_err=worst_rel, **timed["wk_M4"],
                designs=designs,
                prefill_M1536=timed["wk_M1536"], wv_M4=timed["wv_M4"],
                wv_M1536=timed["wv_M1536"])


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


def compare_logits(label: str, fn):
    """``fn()``'s logits with the kernels against the plain versions on
    the same state, under the ``LOGIT_REL_TOL`` rule."""
    from repro_torch.kernels import ops
    out_k = fn()
    ops.set_backend("ref")
    try:
        out_r = fn()
    finally:
        ops.set_backend(None)
    compared = max_err(out_k, out_r)
    scale = float(out_r.abs().max())
    agree = float((out_k.argmax(-1) == out_r.argmax(-1)).float().mean())
    if not torch.isfinite(out_k).all() or compared > LOGIT_REL_TOL * scale:
        raise AssertionError(f"{label}: decode logits kernel vs plain: "
                             f"{compared} > {LOGIT_REL_TOL} x {scale}")
    log(f"{label}: one decode step's logits, kernels vs plain versions: "
        f"max_abs_err={compared:.3e}, max |logit| {scale:.3f} (tol "
        f"{LOGIT_REL_TOL} x max |logit|), argmax agreement {agree:.2f}")


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
    # the port's own kernels, whether or not they are among the eight
    # above (each csrc/*.cu keeps its kernels in an anonymous namespace)
    mine, own = port_kernels(), []
    for e in sorted(evs, key=lambda e: -e.self_device_time_total):
        key = e.key.removeprefix("void (anonymous namespace)::")
        name = re.match(r"\w*", key).group()
        if key != e.key and name in mine:
            own.append(f"{name} {e.self_device_time_total / 1e3 / per:.3f}"
                       f" ms x{e.count / per:.0f}")
    log(f"profile {label}: the port's kernels: {', '.join(own) or 'none'}")


def run_engine(cfg, params):
    """The paged phase: ``PagedEngine`` over flash and paged decode."""
    from repro_torch.serving import paged
    from repro_torch.serving.engine import Request

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

    zero_counts()
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
    counts = read_counts()
    flash_n = counts["flash_attention"]
    paged_n = counts["paged_decode_attention"]
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
    compare_logits("engine", lambda: decode_logits(eng, paged))
    for row in list(eng.requests):
        eng.retire(row)
    eng.check()
    return counts


# ---------------------------------------------------------------------------
# phase 5: the dense Engine and speculative decoding at full width
# ---------------------------------------------------------------------------

def _requests(cfg, lens, rng, prefix, max_new=(32, 32, 32, 32)):
    """Greedy and ``temperature=0.7, top_k=16`` requests alternating."""
    from repro_torch.serving.engine import Request
    return [Request(f"{prefix}{i}", rng.integers(0, cfg.vocab_size, n),
                    max_new_tokens=m,
                    temperature=0.7 if i % 2 else 0.0,
                    top_k=16 if i % 2 else 0)
            for i, (n, m) in enumerate(zip(lens, max_new))]


def _check_outputs(cfg, reqs):
    for r in reqs:
        if len(r.output) != r.max_new_tokens or not all(
                0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"{r.rid}: output {r.output}")


def dense_logits(engine):
    """One decode step's logits on a copy of the engine's dense caches
    (the engine state is left untouched)."""
    from repro_torch.models.model import forward
    from repro_torch.serving.engine import _weave_write
    s = engine.state
    caches = [[{"attn": {k: a.clone() for k, a in layer["attn"].items()}}
               for layer in grp] for grp in s.caches]
    with torch.no_grad():
        logits = forward(engine.params, {"tokens": s.last_token[:, None]},
                         cfg=engine.cfg, mode="decode",
                         caches=_weave_write(caches, s.active),
                         positions=s.positions[:, None])
    return logits[:, 0].float()


def run_dense(cfg, params) -> dict:
    """The dense phase: ``Engine(slots=4, max_len=2048)`` serves four
    requests of 37, 512, 1024 and 1536 prompt tokens, 32 new each."""
    from repro_torch.serving.engine import Engine
    eng = Engine(cfg, params, slots=4, max_len=2048, seed=SEED,
                 device="cuda")
    lens = (37, 512, 1024, 1536)
    reqs = _requests(cfg, lens, np.random.default_rng(SEED + 1), "d")
    zero_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for r in reqs:
        if not eng.add_request(r):
            raise AssertionError(f"{r.rid} refused with a slot free")
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    step_s = []
    while eng.requests:
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    counts = read_counts()
    _check_outputs(cfg, reqs)
    n_steps, layers = len(step_s), cfg.num_layers
    if (counts["decode_attention"] != layers * n_steps
            or counts["flash_attention"] < layers * len(reqs)):
        raise AssertionError(f"dense launch counts {counts}: need "
                             f"decode_attention = {layers} x {n_steps} "
                             f"steps, flash >= {layers} x {len(reqs)}")
    med = sorted(step_s)[len(step_s) // 2]
    log(f"dense: 4 requests x 32 tokens done in {n_steps} steps; launches "
        f"flash_attention={counts['flash_attention']} ({layers} x "
        f"{len(reqs)} prefills), decode_attention="
        f"{counts['decode_attention']} ({layers} x {n_steps} steps)")
    log(f"dense: prefill {sum(lens)} tokens in {prefill_s:.3f} s = "
        f"{sum(lens) / prefill_s:.1f} tok/s; decode median "
        f"{med * 1e3:.3f} ms/step over {n_steps} steps (host clock, "
        f"synchronised)")

    again = _requests(cfg, lens, np.random.default_rng(SEED + 1), "e")
    for r in again:
        if not eng.add_request(r):
            raise AssertionError("re-admission failed")
    profiled(lambda: [eng.step(auto_retire=False) for _ in range(4)],
             "dense decode step (4 rows)", 4)
    compare_logits("dense", lambda: dense_logits(eng))
    return counts


def run_spec_tier(cfg, target_params, draft_params, *, label="spec tier",
                  max_new=(32, 32, 32, 32), gamma=4) -> tuple:
    """Distribution-level speculative tier across two dense engines: the
    draft proposes gamma tokens per round with ``step_probs``, the target
    rules on them with ``verify_slots_distribution``, the draft rolls back
    on a correction, or past the tail when a request needed fewer than
    gamma (the round of ``repro/fleet/speculative.py``, without its
    controller).  Draft and target positions must agree after every
    round.  Returns the launch counts, the acceptance rate, and the
    numbers of fully accepted windows and of draft rewinds past a short
    tail."""
    from repro_torch.serving.engine import Engine, Request
    geo = dict(slots=4, max_len=2048, device="cuda")
    target = Engine(cfg, target_params, seed=SEED, **geo)
    draft = Engine(cfg, draft_params, seed=SEED + 1, **geo)
    lens = (37, 512, 1024, 1536)
    dreqs = _requests(cfg, lens, np.random.default_rng(SEED + 2), "s",
                      max_new)
    zero_counts()
    pairs = []
    for d in dreqs:
        t = Request(d.rid, d.prompt, max_new_tokens=d.max_new_tokens,
                    temperature=d.temperature, top_k=d.top_k)
        if not (draft.add_request(d) and target.add_request(t)):
            raise AssertionError(f"{d.rid} refused with a slot free")
        pairs.append((d, t, []))
    gen = torch.Generator().manual_seed(SEED)
    rounds = verify_calls = draft_steps = target_steps = 0
    proposed = accepted = full = short = 0
    t0 = time.perf_counter()
    live = pairs
    while live:
        need = {d.rid: min(gamma, d.max_new_tokens - len(c))
                for d, _, c in live}
        steps = max(need.values())
        qrows = {d.rid: [] for d, _, _ in live}
        for _ in range(steps):
            _, probs = draft.step_probs(auto_retire=False)
            draft_steps += 1
            for d, _, _ in live:
                qrows[d.rid].append(probs[d.slot])
        tails = {t.slot: d.output[len(c):len(c) + need[d.rid]]
                 for d, t, c in live}
        qs = {t.slot: np.stack(qrows[d.rid][:need[d.rid]])
              for d, t, _ in live}
        res = target.verify_slots_distribution(tails, qs, rng=gen)
        rounds += 1
        verify_calls += len(tails)
        target_steps += max(map(len, tails.values())) + 1
        still = []
        for d, t, c in live:
            tail = tails[t.slot]
            n_acc, corr = res[t.slot]
            proposed += len(tail)
            accepted += n_acc
            full += corr is None
            if corr is not None:
                draft.rollback_slot(d.slot, steps, n_acc, corr)
            elif steps > len(tail):
                draft.rollback_slot(d.slot, steps - len(tail), 0, None)
                short += 1
            c.extend(tail[:n_acc] + ([corr] if corr is not None else []))
            d.output[:] = list(c)
            pd = int(draft.state.positions[d.slot])
            pt = int(target.state.positions[t.slot])
            if pd != pt:
                raise AssertionError(f"{label} {d.rid}: draft at {pd}, "
                                     f"target at {pt} after round {rounds}")
            if len(c) >= d.max_new_tokens:
                draft.retire(d.slot)
                target.retire(t.slot)
                continue
            still.append((d, t, c))
        live = still
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    _check_outputs(cfg, dreqs)
    layers = cfg.num_layers
    if (counts["spec_accept"] != verify_calls
            or counts["decode_attention"]
            != layers * (draft_steps + target_steps)):
        raise AssertionError(
            f"{label} launch counts {counts}: need spec_accept = "
            f"{verify_calls} verify calls, decode_attention = {layers} x "
            f"({draft_steps} draft + {target_steps} target steps)")
    rate = accepted / max(proposed, 1)
    log(f"{label}: 4 requests x {list(max_new)} committed tokens in "
        f"{rounds} rounds (gamma {gamma}), {draft_steps} draft steps, "
        f"{target_steps} target scoring steps, {wall:.3f} s; acceptance "
        f"{accepted}/{proposed} = {rate:.4f}; {full} fully accepted "
        f"windows, {short} draft rewinds past a short tail; draft and "
        f"target positions agreed after every round")
    log(f"{label}: launches spec_accept={counts['spec_accept']} (= "
        f"{verify_calls} verify calls), decode_attention="
        f"{counts['decode_attention']} ({layers} x "
        f"{draft_steps + target_steps} steps), flash_attention="
        f"{counts['flash_attention']} ({layers} x 8 prefills)")
    return counts, rate, full, short


def run_one_program(cfg, params) -> dict:
    """The one-program contract on ``Engine(slots=1)``: the stepwise
    verify accepts 16 of the engine geometry's own greedy tokens,
    exactly; the wide verify's agreement is reported (knife-edge logits
    may break differently in its wider shapes)."""
    from repro_torch.serving.engine import Engine, Request
    geo = dict(slots=1, max_len=2048, seed=SEED, device="cuda")
    prompt = np.random.default_rng(SEED + 3).integers(0, cfg.vocab_size, 200)
    zero_counts()
    pure = Engine(cfg, params, **geo)
    r = Request("p", prompt, max_new_tokens=16)
    pure.add_request(r)
    for _ in range(16):
        pure.step(auto_retire=False)
    toks = list(r.output)
    ver = Engine(cfg, params, **geo)
    ver.add_request(Request("p", prompt, max_new_tokens=16))
    res = ver.verify_slots_stepwise({0: toks})
    if res != {0: (16, None)} or not ver.program_cache_hit:
        raise AssertionError(f"stepwise verify of the engine's own greedy "
                             f"tokens: {res} (program cache hit "
                             f"{ver.program_cache_hit})")
    wide = Engine(cfg, params, **geo)
    wide.add_request(Request("p", prompt, max_new_tokens=16))
    agreed = 0
    for i in range(0, 16, 4):
        n, corr = wide.verify_slots({0: toks[i:i + 4]}, width=4)[0]
        agreed += n
        if corr is not None:
            break
    counts = read_counts()
    log(f"one program: stepwise verify accepted 16/16 of Engine(slots=1)'s "
        f"own greedy tokens; wide verify agreed on {agreed}/16 before its "
        f"first correction (not asserted: its shapes differ from decode's)")
    return counts


def run_spec_generate(cfg, target_params, draft_params, *,
                      label="speculative_generate") -> tuple:
    """``speculative_generate`` (200-token prompt, gamma 4, 32 new,
    greedy) against ``autoregressive_generate`` on the target.  Returns
    the launch counts and the acceptance rate."""
    from repro_torch.core.speculation import (autoregressive_generate,
                                              speculative_generate)
    prompt = np.random.default_rng(SEED + 4).integers(0, cfg.vocab_size, 200)
    zero_counts()
    t = time.perf_counter()
    out, st = speculative_generate(draft_params, cfg, target_params, cfg,
                                   prompt, gamma=4, max_new=32,
                                   temperature=0.0, seed=SEED)
    torch.cuda.synchronize()
    spec_s = time.perf_counter() - t
    counts = read_counts()
    t = time.perf_counter()
    ref, steps = autoregressive_generate(target_params, cfg, prompt,
                                         max_new=32)
    torch.cuda.synchronize()
    ar_s = time.perf_counter() - t
    if len(out) != 32 or not all(0 <= x < cfg.vocab_size for x in out):
        raise AssertionError(f"{label} output {out}")
    forwards = st.draft_steps + st.target_steps
    if (counts["spec_accept"] != st.target_steps
            or counts["flash_attention"] != cfg.num_layers * forwards):
        raise AssertionError(f"{label} launch counts {counts}: need "
                             f"spec_accept = {st.target_steps} rounds, "
                             f"flash = {cfg.num_layers} x {forwards}")
    agree = sum(a == b for a, b in zip(out, ref)) / 32
    prefix = next((i for i, (a, b) in enumerate(zip(out, ref)) if a != b),
                  32)
    log(f"{label}: 32 tokens in {st.target_steps} rounds, acceptance "
        f"{st.acceptance_rate:.4f}, {spec_s:.3f} s; agreement with "
        f"autoregressive_generate {agree:.4f} (common prefix {prefix}), "
        f"which took {steps} steps in {ar_s:.3f} s; launches spec_accept="
        f"{counts['spec_accept']}, flash_attention="
        f"{counts['flash_attention']}")
    return counts, st.acceptance_rate


def run_self_draft(cfg, params) -> dict:
    """Both speculative paths with the draft on the target's own weights,
    so every window is accepted whole: the tier's full-accept rewind
    (``rollback_slot(slot, 1, 0, None)``) and the draft's rewind past a
    short tail (two requests stop at 30 tokens), and
    ``speculative_generate``'s rounds with n > 0.  Acceptance must be
    1.0 on both.  Returns the launch counts of both paths, summed."""
    counts, rate, full, short = run_spec_tier(
        cfg, params, params, label="self-draft tier",
        max_new=(32, 30, 32, 30))
    if rate != 1.0 or short == 0 or full == 0:
        raise AssertionError(f"self-draft tier: acceptance {rate}, {full} "
                             f"fully accepted windows, {short} short-tail "
                             f"rewinds; need 1.0 and both above 0")
    gen_counts, gen_rate = run_spec_generate(
        cfg, params, params, label="self-draft speculative_generate")
    if gen_rate != 1.0:
        raise AssertionError(f"self-draft speculative_generate: acceptance "
                             f"{gen_rate}, need 1.0")
    return {k: counts[k] + gen_counts[k] for k in counts}


# ---------------------------------------------------------------------------
# phase 5b: the migration wire at full width
# ---------------------------------------------------------------------------

def _session(cfg):
    """An attested edge -> cloud session over a simulated 1 Gbps
    ``Channel``, both enclaves measuring ``cfg`` on the card."""
    from repro_torch.core.attestation import (Attester, TrustAuthority,
                                              capabilities, measure_config)
    from repro_torch.core.channel import AttestedSession, Channel
    auth, gid = TrustAuthority(), measure_config(cfg)
    caps = capabilities(cfg)
    return AttestedSession(Attester("edge", auth, gid, caps),
                           Attester("cloud", auth, gid, caps), Channel(),
                           {gid}), gid


def slot_hop(label, src, slot, dst, cfg, *, into=None, suffix_only=False):
    """One request's hop: extract_slot -> pack_slot -> compress -> the
    attested, sealed transfer -> decompress -> unpack_slot -> repack_slot
    -> inject_slot.  Prints the bytes and each stage's host seconds on
    the card's machine; returns (the resumed request, the snapshot)."""
    from repro_torch import compression
    from repro_torch.core.migration import pack_slot, repack_slot, unpack_slot
    session, gid = _session(cfg)
    torch.cuda.synchronize()
    t = time.perf_counter()
    snap = (src.extract_slot(slot, suffix_only=True) if suffix_only
            else src.extract_slot(slot))
    blob = pack_slot(snap)
    checkpoint_s = time.perf_counter() - t
    t = time.perf_counter()
    wire = compression.compress(blob)
    compress_s = time.perf_counter() - t
    clock0 = session.channel.clock()
    t = time.perf_counter()
    received = session.transfer(wire, aad=gid.encode())
    seal_s = time.perf_counter() - t
    transfer_s = session.channel.clock() - clock0
    t = time.perf_counter()
    snap2 = unpack_slot(compression.decompress(received), dst.slot_like())
    moved = dst.inject_slot(repack_slot(snap2, dst.max_len), slot=into)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    log(f"{label}: {snap.rid} v{snap.version} raw {len(blob)} bytes, wire "
        f"{len(wire)} bytes ({compression.BACKEND}); checkpoint "
        f"{checkpoint_s:.4f} s, compress {compress_s:.4f} s, seal+open "
        f"{seal_s:.4f} s, transfer {transfer_s:.4f} s (simulated 1 Gbps), "
        f"restore {restore_s:.4f} s (host seconds on the card's machine, "
        f"{gpu_line()})")
    return moved, snap


def _hop_requests(cfg):
    """The hop's three requests: a sampled 1024-token request beside a
    37-token and a 512-token greedy one, 32 new tokens each."""
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(SEED + 7)
    return [Request("m0", rng.integers(0, cfg.vocab_size, 1024),
                    max_new_tokens=32, temperature=0.7, top_k=16),
            Request("m1", rng.integers(0, cfg.vocab_size, 37),
                    max_new_tokens=32),
            Request("m2", rng.integers(0, cfg.vocab_size, 512),
                    max_new_tokens=32)]


def _resident(cfg):
    from repro_torch.serving.engine import Request
    prompt = np.random.default_rng(SEED + 8).integers(0, cfg.vocab_size, 200)
    return Request("d0", prompt, max_new_tokens=32)


class Tally:
    """The prefills and decode forwards a path drives, by engine kind:
    its launches must be exactly 24 flash_attention a cold prefill and 24
    paged / dense decode kernels a decode step, a warm suffix token (one
    batch-1 decode forward each) and a logit probe (``decode_logits``),
    so a hop that re-prefilled, a warm admission that ran flash or a path
    that left the kernels would show."""

    def __init__(self, label: str):
        self.label = label
        self.prefills, self.steps = 0, {"paged": 0, "dense": 0}
        self.suffix, self.probes = 0, 0

    def add(self, eng, *reqs):
        """Admit each request; a cold one is a prefill, a partial hit
        forwards its uncovered suffix token by token, a full hit runs
        nothing."""
        for r in reqs:
            if not eng.add_request(r):
                raise AssertionError(f"{r.rid} refused with a slot free")
            hit = getattr(eng, "last_prefix_hit", 0)
            if hit == 0:
                self.prefills += 1
            else:
                self.suffix += len(r.prompt) - hit

    def probe(self, eng):
        """One decode step's logits on a copy of ``eng``'s pools."""
        from repro_torch.serving import paged
        self.probes += 1
        return decode_logits(eng, paged)

    def step(self, eng) -> dict:
        from repro_torch.serving.paged import PagedEngine
        self.steps["paged" if isinstance(eng, PagedEngine) else "dense"] += 1
        return eng.step()

    def drain(self, eng) -> dict:
        """Steps ``eng`` until it holds no request; returns every live
        request's output by rid."""
        reqs = list(eng.requests.values())
        while eng.requests:
            self.step(eng)
        return {r.rid: list(r.output) for r in reqs}

    def check(self, counts: dict, layers: int):
        paged = self.steps["paged"] + self.suffix + self.probes
        want = {"flash_attention": layers * self.prefills,
                "paged_decode_attention": layers * paged,
                "decode_attention": layers * self.steps["dense"]}
        got = {k: n for k, n in counts.items() if n or k in want}
        if got != want:
            raise AssertionError(
                f"{self.label} launch counts {got}: need {layers} x "
                f"{self.prefills} prefills, {layers} x {self.steps} steps, "
                f"{layers} x {self.suffix} suffix tokens, {layers} x "
                f"{self.probes} logit probes and no other kernel: {want}")


def hop_pair(make, cfg, tally, label, landed, *, into=None):
    """One request's hop between two engines of one kind beside busy
    rows, against unmigrated runs: m0 (sampled) leaves ``make(SEED)``
    after 8 steps and finishes in ``make(9)``, which already serves d0.
    ``landed(src, dst, moved, position, snapshot)`` checks the engines
    just after the hop.  m0's tokens must equal a run without the hop,
    m1's and m2's (left in the source) that run's too, and d0's those of
    a ``make(9)`` that takes no injection.  Returns (src, dst), both
    drained."""
    ref = make(SEED)
    tally.add(ref, *_hop_requests(cfg))
    want = tally.drain(ref)
    del ref
    solo = make(9)
    tally.add(solo, _resident(cfg))
    want.update(tally.drain(solo))
    del solo
    src = make(SEED)
    reqs = _hop_requests(cfg)
    tally.add(src, *reqs)
    for _ in range(8):
        tally.step(src)
    dst = make(9)
    tally.add(dst, _resident(cfg))
    pos = int(src.state.positions[reqs[0].slot])
    moved, snap = slot_hop(label, src, reqs[0].slot, dst, cfg, into=into)
    landed(src, dst, moved, pos, snap)
    got = tally.drain(dst)
    got.update(tally.drain(src))
    if got != want:
        bad = sorted(k for k in want if got.get(k) != want[k])
        raise AssertionError(f"{label}: {bad} differ from the unmigrated "
                             f"runs: {got} != {want}")
    return src, dst


def run_migrate(cfg, params) -> dict:
    """The migration wire on llama-1.5b at full width: the paged (v2)
    and dense (v1) slot hops and the workspace ``Migrator``, each
    resuming with the unmigrated run's tokens bit for bit, the rows
    beside it untouched, and every prefill and step on the kernels."""
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.paged import PagedEngine
    zero_counts()
    torch.cuda.synchronize()
    tally = Tally("migrate")

    # paged (v2): source pages=160, destination pages=256
    geo = dict(rows=4, page_size=16, max_len=2048, device="cuda")
    hop = {}

    def paged_landed(src, dst, moved, pos, snap):
        n_live = snap.arrays.caches[0][0]["attn"]["k"].shape[1]
        left = sum(len(src._row_pages(r)) for r in src.requests)
        if src.allocator.used_pages != left or n_live != -(-pos // 16):
            raise AssertionError(f"paged hop: source holds "
                                 f"{src.allocator.used_pages} pages (its "
                                 f"rows {left}); n_live {n_live} for "
                                 f"position {pos}")
        src.check()
        dst.check()
        hop.update(pos=pos, n_live=n_live)

    src, dst = hop_pair(
        lambda seed: PagedEngine(cfg, params, pages=160 if seed == SEED
                                 else 256, seed=seed, **geo),
        cfg, tally, "migrate paged", paged_landed)
    for eng in (src, dst):
        eng.check()
        if eng.allocator.used_pages:
            raise AssertionError(f"{eng.allocator.used_pages} pages held "
                                 "after every request retired")
    pos, n_live = hop["pos"], hop["n_live"]
    log(f"migrate paged: m0 (1024 prompt tokens, temperature 0.7, top_k 16) "
        f"left PagedEngine(pages=160, seed {SEED}) after 8 steps at "
        f"position {pos} with {n_live} live pages (ceil({pos}/16)), its "
        f"source pages freed, and finished in PagedEngine(pages=256, seed "
        f"9) beside a 200-token request: 32 tokens equal the unmigrated "
        f"run's bit for bit; m1, m2 (left in the source) and d0 equal "
        f"their runs without the hop; check() passed on both engines")
    del src, dst

    # dense (v1): the same hop between two Engine(slots=4), slot 0 -> 2
    dgeo = dict(slots=4, max_len=2048, device="cuda")

    def dense_landed(src, dst, moved, pos, snap):
        if moved.slot != 2 or snap.version != 1:
            raise AssertionError(f"dense hop: v{snap.version} landed in "
                                 f"slot {moved.slot}, not 2")

    src, dst = hop_pair(
        lambda seed: Engine(cfg, params, seed=seed, **dgeo),
        cfg, tally, "migrate dense", dense_landed, into=2)
    log(f"migrate dense: m0 moved from slot 0 of Engine(seed {SEED}) to "
        f"slot 2 of Engine(seed 9) after 8 steps: 32 tokens equal the "
        f"unmigrated run's bit for bit; m1, m2 and d0 equal their runs "
        f"without the hop")
    del src, dst
    run_workspace(cfg, params, tally)
    counts = read_counts()
    tally.check(counts, cfg.num_layers)
    log(f"migrate: launches flash_attention={counts['flash_attention']} "
        f"({cfg.num_layers} x {tally.prefills} prefills), "
        f"paged_decode_attention={counts['paged_decode_attention']}, "
        f"decode_attention={counts['decode_attention']} ({cfg.num_layers} "
        f"x {tally.steps} steps), exactly")
    return counts


def run_workspace(cfg, params, tally):
    """A whole ``Engine(slots=2, max_len=1024)`` workspace through
    ``Migrator``: in full after 6 steps, then incrementally after one
    more; the continuation equals the unmigrated run's."""
    from repro_torch import compression
    from repro_torch.core.migration import Migrator
    from repro_torch.core.workspace import AgentWorkspace
    from repro_torch.serving.engine import Engine, Request

    def start():
        eng = Engine(cfg, params, slots=2, max_len=1024, seed=SEED,
                     device="cuda")
        rng = np.random.default_rng(SEED + 9)
        reqs = [Request("w0", rng.integers(0, cfg.vocab_size, 512),
                        max_new_tokens=24),
                Request("w1", rng.integers(0, cfg.vocab_size, 300),
                        max_new_tokens=24, temperature=0.7, top_k=16)]
        tally.add(eng, *reqs)
        return eng, reqs

    ref, want = start()
    tally.drain(ref)
    del ref
    src, reqs = start()
    for _ in range(6):
        tally.step(src)
    session, gid = _session(cfg)
    mig = Migrator()
    target = Engine(cfg, params, slots=2, max_len=1024, seed=9,
                    device="cuda")
    for incremental in (False, True):
        if incremental:
            tally.step(src)
        _, rep = mig.migrate(AgentWorkspace.from_engine(src, gid), session,
                             target, incremental=incremental)
        torch.cuda.synchronize()
        log(f"migrate workspace ({'incremental' if incremental else 'full'}"
            f"): raw {rep.raw_bytes} bytes, wire {rep.wire_bytes} bytes "
            f"({compression.BACKEND}), delta_fraction "
            f"{rep.delta_fraction:.6f}; checkpoint {rep.checkpoint_s:.4f} "
            f"s, compress {rep.compress_s:.4f} s, transfer "
            f"{rep.transfer_s:.4f} s (simulated 1 Gbps), restore "
            f"{rep.restore_s:.4f} s (host seconds on the card's machine, "
            f"{gpu_line()})")
    outs = {r.rid: list(r.output) for r in target.requests.values()}
    while target.requests:
        for rid, t in tally.step(target).items():
            outs[rid].append(t)
    if outs != {r.rid: r.output for r in want}:
        raise AssertionError(f"workspace continuation {outs} != unmigrated "
                             f"{[r.output for r in want]}")
    log("migrate workspace: Engine(slots=2, max_len=1024) moved in full "
        "after 6 steps and incrementally after 7 into Engine(seed 9); both "
        "requests (greedy and sampled) finished with the unmigrated run's "
        "24 tokens bit for bit")


# ---------------------------------------------------------------------------
# phase 5c: the prefix cache at full width
# ---------------------------------------------------------------------------

def _prefix_prompts(cfg):
    """A 448-token shared system/tool prompt S (28 pages) and two user
    turns: p0 = S + 21 tokens (29 full blocks + a 5-token tail) and
    p2 = S + 40 tokens."""
    rng = np.random.default_rng(SEED + 10)
    S = rng.integers(0, cfg.vocab_size, 448)
    return (np.concatenate([S, rng.integers(0, cfg.vocab_size, 21)]),
            np.concatenate([S, rng.integers(0, cfg.vocab_size, 40)]))


def _page_bytes(eng, pages) -> list:
    """Copies of every layer's K and V at ``pages``."""
    idx = torch.tensor(pages, dtype=torch.long, device="cuda")
    return [layer["attn"][n][:, idx].clone() for grp in eng.state.caches
            for layer in grp for n in ("k_pool", "v_pool")]


def _timed_suffix(eng, spent: list):
    """Wrap ``eng``'s suffix program so each call's synchronised wall
    lands in ``spent``."""
    inner = eng._suffix_fn

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*a, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)
        return out

    eng._suffix_fn = timed


def _prefix_engine(cfg, params, *, pages, seed=SEED, cache=True):
    from repro_torch.serving.paged import PagedEngine
    return PagedEngine(cfg, params, rows=4, page_size=16, max_len=2048,
                       pages=pages, seed=seed, device="cuda",
                       prefix_cache=cache)


def _warm_p2(cfg, params, tally, p0, p2):
    """p2 served warm in an engine of its own: p0 admitted cold and
    retired at once (its blocks stay cached), then p2 as a 448-token
    partial hit.  Returns (engine, p2's request)."""
    from repro_torch.serving.engine import Request
    eng = _prefix_engine(cfg, params, pages=64)
    r0 = Request("p0", p0, max_new_tokens=32, tenant="a")
    tally.add(eng, r0)
    eng.retire(r0.slot)
    r2 = Request("p2", p2, max_new_tokens=32, tenant="a")
    tally.add(eng, r2)
    if eng.last_prefix_hit != 448:
        raise AssertionError(f"warm p2: hit {eng.last_prefix_hit} != 448")
    return eng, r2


def _settled(eng):
    """``check()`` and no page held beyond the cache's."""
    eng.check()
    held = eng.prefix_cache.pages_held if eng.prefix_cache else 0
    if eng.requests or eng.allocator.used_pages != held:
        raise AssertionError(f"{eng.allocator.used_pages} pages used, "
                             f"{held} held by the cache, rows "
                             f"{sorted(eng.requests)}")


def _top2_gap(logits, cfg) -> float:
    from repro_torch.models.model import vocab_mask_logits
    top = vocab_mask_logits(logits, cfg).float().topk(2).values
    return float(top[0] - top[1])


def warm_against_cold(cfg, params, tally, p0, p2):
    """p2 warm (suffix through the decode path) against p2 cold (flash)
    in lockstep: the first decode step's logits within ``LOGIT_REL_TOL``
    of the largest, the greedy agreement rate and both runs' top-2 logit
    gaps at the first divergence; then a second warm run must give the
    first one's tokens bit for bit.  Returns the warm run's tokens."""
    from repro_torch.serving.engine import Request
    ref, warm = _warm_p2(cfg, params, tally, p0, p2)
    cold_eng = _prefix_engine(cfg, params, pages=40, cache=False)
    cold = Request("p2", p2, max_new_tokens=32)
    tally.add(cold_eng, cold)
    first = None
    for i in range(32):
        if first is None:
            lw = tally.probe(ref)[warm.slot]
            lc = tally.probe(cold_eng)[cold.slot]
            if i == 0:
                err, scale = max_err(lw, lc), float(lc.abs().max())
                if not torch.isfinite(lw).all() \
                        or err > LOGIT_REL_TOL * scale:
                    raise AssertionError(
                        f"prefix: p2 warm vs cold first-step logits "
                        f"{err} > {LOGIT_REL_TOL} x {scale}")
        tally.step(ref)
        tally.step(cold_eng)
        if first is None and warm.output[i] != cold.output[i]:
            first = (i, _top2_gap(lc, cfg), _top2_gap(lw, cfg))
    agree = sum(a == b for a, b in zip(warm.output, cold.output))
    where = ("no divergence" if first is None else
             f"first divergence at token {first[0]}: top-2 logit gap "
             f"{first[1]:.4f} cold, {first[2]:.4f} warm")
    log(f"prefix: p2 warm (448 cached + 40-token suffix through "
        f"paged_decode_attention) vs cold (488 tokens through flash): "
        f"first decode step's logits max_abs_err={err:.3e}, max |logit| "
        f"{scale:.3f} (tol {LOGIT_REL_TOL} x max |logit|); greedy "
        f"agreement {agree}/32; {where}")
    again_eng, again = _warm_p2(cfg, params, tally, p0, p2)
    tally.drain(again_eng)
    if again.output != warm.output:
        raise AssertionError(f"prefix: a second warm run of p2 gave "
                             f"{again.output} != {warm.output}")
    for eng in (ref, cold_eng, again_eng):
        _settled(eng)
    log("prefix: a second warm run of p2 (another engine) gave the first "
        "one's 32 tokens bit for bit")
    return list(warm.output)


def run_prefix(cfg, params) -> dict:
    """The prefix cache on llama-1.5b at full width: a cold donor, a full
    hit, a partial hit and another tenant's miss decoding side by side
    over shared pages, copy on write held byte for byte, the warm run
    against a cold one, pre-warm and the v3 suffix-only hop, with every
    launch counted."""
    from repro_torch import compression
    from repro_torch.core.migration import pack_slot
    from repro_torch.serving.engine import Request
    zero_counts()
    torch.cuda.synchronize()
    tally = Tally("prefix")
    layers = cfg.num_layers
    p0, p2 = _prefix_prompts(cfg)
    want_p2 = warm_against_cold(cfg, params, tally, p0, p2)

    eng = _prefix_engine(cfg, params, pages=256)
    spent: list = []
    _timed_suffix(eng, spent)
    reqs = [Request("p0", p0, max_new_tokens=32, tenant="a"),
            Request("p1", p0.copy(), max_new_tokens=32, tenant="a"),
            Request("p2", p2, max_new_tokens=32, tenant="a"),
            Request("p3", p0.copy(), max_new_tokens=32, tenant="b")]
    admit = {}
    for r in reqs:
        before = read_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        tally.add(eng, r)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        after = read_counts()
        admit[r.rid] = (wall, eng.last_prefix_hit,
                        after["flash_attention"] - before["flash_attention"],
                        after["paged_decode_attention"]
                        - before["paged_decode_attention"])
        eng.check()
        if r.rid == "p0":
            cache = eng.prefix_cache
            shared = [n.page for n in cache.nodes.values()] \
                + [n.page for v in cache.tails.values() for n in v]
            if len(shared) != 30:
                raise AssertionError(f"p0 donated {len(shared)} pages, not "
                                     "29 blocks + a tail copy")
            kept = _page_bytes(eng, shared)
    want = {"p0": (0, layers, 0), "p1": (469, 0, 0),
            "p2": (448, 0, layers * 40), "p3": (0, layers, 0)}
    got = {k: v[1:] for k, v in admit.items()}
    if got != want:
        raise AssertionError(f"prefix admissions (hit, flash, paged "
                             f"launches) {got} != {want}")
    stats = eng.prefix_cache.stats.as_dict()
    log(f"prefix: PagedEngine(rows=4, page_size=16, max_len=2048, pages=256,"
        f" prefix_cache=True): p0 (tenant a, 469 tokens) cold, donated 29 "
        f"blocks + a tail copy; p1 (p0's prompt) full hit 469 with no flash "
        f"launch; p2 (S + 40) partial hit 448, its 40-token suffix {layers}"
        f" x 40 paged_decode_attention launches; p3 (tenant b, p0's prompt)"
        f" a miss, cold")
    suffix_ms = sum(spent) / 40 * 1e3
    log(f"prefix: time to first token (admission wall, synchronised): cold "
        f"p0 {admit['p0'][0] * 1e3:.3f} ms, full hit p1 "
        f"{admit['p1'][0] * 1e3:.3f} ms, partial hit p2 "
        f"{admit['p2'][0] * 1e3:.3f} ms of which the suffix prefill "
        f"{sum(spent) * 1e3:.3f} ms = {suffix_ms:.3f} ms per suffix token; "
        f"cold p3 {admit['p3'][0] * 1e3:.3f} ms (host clock); cache stats "
        f"{stats} ({gpu_line()})")

    for _ in range(8):
        tally.step(eng)
    dst = _prefix_engine(cfg, params, pages=256, seed=9)
    report = dst.prewarm_chains(eng)
    if report["skipped"] is not None or not report["pages"]:
        raise AssertionError(f"prewarm: {report}")
    log(f"prefix: PagedEngine(seed 9, pages=256).prewarm_chains(source) "
        f"while p2 is live: {report}")
    slot = reqs[2].slot
    v2 = pack_slot(eng.extract_slot(slot, keep=True))
    v2_wire = len(compression.compress(v2))
    moved, snap = slot_hop("prefix v3 hop", eng, slot, dst, cfg,
                           suffix_only=True)
    v3 = pack_slot(snap)
    v3_wire = len(compression.compress(v3))
    n_ship = snap.arrays.caches[0][0]["attn"]["k"].shape[1]
    if snap.version != 3 or len(v3) >= len(v2):
        raise AssertionError(f"v{snap.version} {len(v3)} bytes vs v2 "
                             f"{len(v2)}")
    log(f"prefix: p2 after 8 steps at position {int(snap.arrays.position)}:"
        f" v3 raw {len(v3)} bytes, wire {v3_wire} bytes "
        f"({len(snap.prefix['chain'])}-block chain as hashes, {n_ship} "
        f"page shipped) against v2 raw {len(v2)} bytes, wire {v2_wire} "
        f"bytes ({compression.BACKEND}) for the same slot")
    out = tally.drain(eng)
    out.update(tally.drain(dst))
    if out["p2"] != want_p2 or moved.output != want_p2:
        raise AssertionError(f"prefix: p2 after the v3 hop {out['p2']} != "
                             f"its unmigrated warm run {want_p2}")
    if out["p1"] != out["p0"] or out["p3"] != out["p0"]:
        raise AssertionError(f"prefix: p1 {out['p1']} / p3 {out['p3']} != "
                             f"p0 {out['p0']}")
    changed = [i for i, (a, b) in enumerate(zip(kept,
                                                _page_bytes(eng, shared)))
               if not torch.equal(a, b)]
    if changed:
        raise AssertionError(f"prefix: shared pages written (layer/kv "
                             f"{changed})")
    for e in (eng, dst):
        _settled(e)
    log("prefix: p1 (full hit, no flash launch) and p3 (tenant b, cold) "
        "gave p0's 32 tokens bit for bit; p2 finished in the second engine "
        "after the v3 hop with its unmigrated warm run's 32 tokens bit for "
        "bit; every layer's K/V of the 30 shared pages byte-equal before "
        "p1 and p2 were admitted and after the engine drained; check() "
        "passed and no page is held beyond the cache's on all five engines")
    counts = read_counts()
    tally.check(counts, layers)
    log(f"prefix: launches flash_attention={counts['flash_attention']} "
        f"({layers} x {tally.prefills} cold prefills), "
        f"paged_decode_attention={counts['paged_decode_attention']} "
        f"({layers} x ({tally.steps['paged']} decode steps + "
        f"{tally.suffix} suffix tokens + {tally.probes} logit probes)), "
        f"exactly")
    return counts


# ---------------------------------------------------------------------------
# phase 6: rwkv6-7b on the dense Engine at full width
# ---------------------------------------------------------------------------

def _rwkv_snapshot(eng, slots):
    return [{k: a[:, slots].clone() for k, a in layer["rwkv"].items()}
            for grp in eng.state.caches for layer in grp]


def _serve(eng, reqs, step_s=None):
    for r in reqs:
        if not eng.add_request(r):
            raise AssertionError(f"{r.rid} refused with a slot free")
    while eng.requests:
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        if step_s is not None:
            step_s.append(time.perf_counter() - t)


def rwkv_logits(cfg, params, prompt):
    """One cache-free prefill's logits (1, T, V_pad) as float32."""
    from repro_torch.models.model import forward
    with torch.no_grad():
        return forward(params, {"tokens": prompt}, cfg=cfg,
                       mode="prefill").float()


def rwkv_state_finding(cfg, params, prompt):
    """How far a chunked prefill's final state (layer 0, chunk 64 as the
    forward modes use, and chunk 8 as train does) lies from stepping the
    recurrence once per token: a finding, not asserted."""
    from repro_torch.models import rwkv6
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.model import embed_tokens
    from repro_torch.models.schema import tree_map
    p = tree_map(lambda a: a[0], params["blocks"][0][0]["rwkv"])
    with torch.no_grad():
        h = rmsnorm(embed_tokens(params, prompt, cfg), p["ln"]["scale"],
                    cfg.norm_eps)
        T = h.shape[1]
        H, D = cfg.rwkv_heads, cfg.rwkv_head_dim
        state = torch.zeros((1, H, D, D), device="cuda")
        x_last = torch.zeros_like(h[:, 0])
        for t in range(T):
            _, state, x_last = rwkv6.timemix_step(p, h[:, t:t + 1], cfg,
                                                  state=state, x_last=x_last)
        top = float(state.abs().max())
        for chunk in (64, 8):
            _, s_par, _ = rwkv6.timemix_parallel(p, h, cfg, chunk=chunk)
            log(f"rwkv finding: layer 0, {T}-token prefill at chunk {chunk} "
                f"vs {T} timemix_steps: final state max_abs_err="
                f"{max_err(s_par, state):.3e}, max |state| {top:.3f} "
                f"(relative {max_err(s_par, state) / top:.3e})")


def rwkv_hop(cfg, params, geo) -> list[int]:
    """One rwkv slot (the O(1) workspace: per layer a (64, 64, 64) fp32
    state, x_tm and x_cm) moved after 8 decode steps into a second
    engine (seed 9), slot 0 -> 3; its tokens must equal the unmigrated
    run's.  Returns the prompt lengths its prefills ran."""
    from repro_torch.serving.engine import Engine, Request

    def reqs():
        rng = np.random.default_rng(SEED + 10)
        return [Request("h0", rng.integers(0, cfg.vocab_size, 512),
                        max_new_tokens=24, temperature=0.7, top_k=16),
                Request("h1", rng.integers(0, cfg.vocab_size, 37),
                        max_new_tokens=24)]

    ref = Engine(cfg, params, **geo)
    want = reqs()
    _serve(ref, want)
    del ref
    src = Engine(cfg, params, **geo)
    mine = reqs()
    for r in mine:
        if not src.add_request(r):
            raise AssertionError(f"{r.rid} refused with a slot free")
    for _ in range(8):
        src.step()
    dst = Engine(cfg, params, **{**geo, "seed": 9})
    moved, snap = slot_hop("rwkv migrate", src, mine[0].slot, dst, cfg,
                           into=3)
    _serve(dst, [])
    _serve(src, [])
    got = [moved.output, mine[1].output]
    if got != [r.output for r in want]:
        raise AssertionError(f"rwkv hop: h0, h1 {got} != unmigrated "
                             f"{[r.output for r in want]}")
    state = snap.arrays.caches[0][0]["rwkv"]["state"]
    log(f"rwkv migrate: h0 (512 prompt tokens, sampled) moved from slot "
        f"{mine[0].slot} to slot 3 of Engine(seed 9) after 8 steps, state "
        f"{tuple(state.shape)} {state.dtype}: 24 tokens equal the "
        f"unmigrated run's bit for bit; h1, left in the source, equals its "
        f"unmigrated run too")
    return [512, 37, 512, 37]


def run_rwkv(cfg, params) -> dict:
    """rwkv6-7b on ``Engine(slots=4, max_len=2048)``: four requests of
    37, 512, 1000 and 1536 prompt tokens, 32 new each, greedy and sampled
    rows alternating; then a fifth (greedy) request in a retired slot,
    which must give what a fresh engine gives it while the other slots'
    recurrent state stays untouched.  rwkv6_scan must launch exactly 32
    times per chunk run of every prefill (two runs for a ragged prompt
    over 64 tokens)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine, Request
    geo = dict(slots=4, max_len=2048, seed=SEED, device="cuda")
    eng = Engine(cfg, params, **geo)
    lens = (37, 512, 1000, 1536)
    reqs = _requests(cfg, lens, np.random.default_rng(SEED + 5), "w")
    rng = np.random.default_rng(SEED + 6)
    fifth = rng.integers(0, cfg.vocab_size, 300)
    zero_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for r in reqs:
        if not eng.add_request(r):
            raise AssertionError(f"{r.rid} refused with a slot free")
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    step_s = []
    _serve(eng, [], step_s)
    _check_outputs(cfg, reqs)
    # the fifth request lands in slot 0, which the 37-token request left
    again = Request("w4", fifth, max_new_tokens=16)
    if not eng.add_request(again) or again.slot != 0:
        raise AssertionError(f"fifth request in slot {again.slot}, not 0")
    idle = _rwkv_snapshot(eng, slice(1, 4))
    _serve(eng, [])
    for a, b in zip(idle, _rwkv_snapshot(eng, slice(1, 4))):
        for k in a:
            if not torch.equal(a[k], b[k]):
                raise AssertionError(f"inactive slots' {k} changed across "
                                     "decode steps")
    fresh = Engine(cfg, params, **geo)
    ref = Request("w4", fifth, max_new_tokens=16)
    _serve(fresh, [ref])
    if again.output != ref.output or len(ref.output) != 16:
        raise AssertionError(f"reused slot {again.output} != fresh engine "
                             f"{ref.output}")
    del fresh
    hop = rwkv_hop(cfg, params, geo)
    counts = read_counts()
    layers = cfg.num_layers
    prefills = list(lens) + [len(fifth), len(fifth)] + hop
    want = layers * sum(len(rwkv_runs(T)) for T in prefills)
    if counts["rwkv6_scan"] != want or any(
            n for k, n in counts.items() if k != "rwkv6_scan"):
        raise AssertionError(f"rwkv launch counts {counts}: need rwkv6_scan "
                             f"= {layers} x the chunk runs of {prefills} = "
                             f"{want}, and no other kernel")
    med = sorted(step_s)[len(step_s) // 2]
    log(f"rwkv: 4 requests x 32 tokens done in {len(step_s)} steps; a fifth "
        f"({len(fifth)} prompt tokens, 16 new) in retired slot 0 gave the "
        f"fresh engine's tokens exactly; slots 1-3 state, x_tm, x_cm "
        f"untouched bit for bit across its 16 decode steps")
    log(f"rwkv: launches rwkv6_scan={counts['rwkv6_scan']} ({layers} x "
        f"{sum(len(rwkv_runs(T)) for T in prefills)} chunk runs of the "
        f"prefills {prefills})")
    log(f"rwkv: prefill {sum(lens)} tokens in {prefill_s:.3f} s = "
        f"{sum(lens) / prefill_s:.1f} tok/s (first prefill includes "
        f"set-up); decode median {med * 1e3:.3f} ms/step over "
        f"{len(step_s)} steps (host clock, synchronised)")

    # where the time goes: one 1536-token prefill, then four decode steps
    long = Request("p0", reqs[3].prompt, max_new_tokens=8)
    profiled(lambda: eng.add_request(long), "rwkv prefill of 1536 tokens", 1)
    for r in _requests(cfg, lens[:3], np.random.default_rng(SEED + 5), "q"):
        eng.add_request(r)
    profiled(lambda: [eng.step(auto_retire=False) for _ in range(4)],
             "rwkv decode step (4 rows)", 4)
    for slot in list(eng.requests):
        eng.retire(slot)

    # one prefill's logits with the kernel against the plain version
    prompt = torch.from_numpy(reqs[2].prompt.astype(np.int64)).cuda()[None]
    out_k = rwkv_logits(cfg, params, prompt)
    ops.set_backend("ref")
    try:
        out_r = rwkv_logits(cfg, params, prompt)
    finally:
        ops.set_backend(None)
    compared, scale = max_err(out_k, out_r), float(out_r.abs().max())
    agree = float((out_k.argmax(-1) == out_r.argmax(-1)).float().mean())
    if not torch.isfinite(out_k).all() or compared > LOGIT_REL_TOL * scale:
        raise AssertionError(f"rwkv prefill logits kernel vs plain: "
                             f"{compared} > {LOGIT_REL_TOL} x {scale}")
    log(f"rwkv: a 1000-token prefill's logits, rwkv6_scan vs plain: "
        f"max_abs_err={compared:.3e}, max |logit| {scale:.3f} (tol "
        f"{LOGIT_REL_TOL} x max |logit|), argmax agreement {agree:.4f}")
    rwkv_state_finding(cfg, params,
                       torch.from_numpy(reqs[3].prompt.astype(np.int64))
                       .cuda()[None])
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import get
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import rwkv6_scan as rs
    from repro_torch.kernels import spec_verify as sv
    from repro_torch.models.init import init_params

    card = gpu_line()
    log(f"device: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.build_all()
    log(f"build: {len(build.KERNELS)} kernels in "
        f"{time.perf_counter() - t0:.2f} s (nvcc, sm_90a, one process each)")
    for name, text in build.logs.items():
        if name in ("int8_matmul", "rwkv6_scan", "spec_verify"):
            continue      # their checks print them, by kernel
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"build: {name}: {ln.strip()}")

    gen = torch.Generator("cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    zero_counts()
    rows = [check_flash(fa, gen), check_paged(da, gen),
            check_decode(da, gen), check_spec(sv, gen),
            check_rwkv6(rs, gen), check_int8(im, gen)]
    phase = read_counts()
    log(f"kernels: phase done in {time.perf_counter() - t0:.1f} s")

    cfg = get("llama-1.5b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED),
                         device="cuda")
    draft = init_params(cfg, torch.Generator("cuda").manual_seed(SEED + 1),
                        device="cuda")
    torch.cuda.synchronize()
    log(f"engine: {cfg.name} {cfg.param_count() / 1e9:.3f}B params bf16, "
        f"target (seed {SEED}) and draft (seed {SEED + 1}) initialised on "
        f"the card in {time.perf_counter() - t0:.2f} s")
    paths, wall = {}, {}

    def drive(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        paths[name] = out[0] if isinstance(out, tuple) else out
        wall[name] = round(time.perf_counter() - t, 1)

    drive("paged", run_engine, cfg, params)
    drive("dense", run_dense, cfg, params)
    drive("spec_tier", run_spec_tier, cfg, params, draft)
    drive("one_program", run_one_program, cfg, params)
    drive("spec_generate", run_spec_generate, cfg, params, draft)
    drive("self_draft", run_self_draft, cfg, params)
    drive("migrate", run_migrate, cfg, params)
    drive("prefix", run_prefix, cfg, params)
    del params, draft
    torch.cuda.empty_cache()
    rcfg = get("rwkv6-7b")
    t0 = time.perf_counter()
    rparams = init_params(rcfg, torch.Generator("cuda").manual_seed(SEED),
                          device="cuda")
    torch.cuda.synchronize()
    log(f"rwkv: {rcfg.name} {rcfg.param_count() / 1e9:.3f}B params bf16 "
        f"(seed {SEED}) initialised on the card in "
        f"{time.perf_counter() - t0:.2f} s; llama-1.5b freed")
    drive("rwkv", run_rwkv, rcfg, rparams)
    log(f"paths: wall seconds {wall}")
    for row in rows:
        name = row["name"]
        by_path = {p: c[name] for p, c in paths.items() if c[name]}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        row["phase_launches"] = phase[name]
        if name in PHASE_ONLY:
            # no model calls it: its kernel phase is its one launcher
            if by_path or phase[name] < 1:
                raise AssertionError(f"{name}: path launches {by_path}, "
                                     f"kernel phase launches {phase[name]}")
        elif not by_path:
            raise AssertionError(f"{name} never launched on a path")
    log(json.dumps({"kernels": rows}))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
