"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; imports nothing of JAX or ``repro``.
Phases, each printing its own lines (any failure exits non-zero before
the result line):

  1. device  : the card's name and power limit (nvidia-smi)
  2. build   : the eight CUDA kernels built from
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
               library yardsticks also the profiler's device time;
               flash, paged and dense decode also at the families' head
               dims 160 and 256 (gemma3-4b's local layer and ring
               buffer, stablelm-12b's layer), flash and dense decode also
               at jamba-v0.1-52b's G 4 / D 128 rows and internvl2-26b's
               G 6, flash in full mode at whisper-base's encoder and
               cross-attention (D 64, Sq 416 over 1536 frames), dense
               decode over its cross cache (position 2^30), paged decode
               at llama-1.5b's page size 8 (fleet_serving's act five, and
               B 4 near position 1000), each case in its kernel's row of
               the JSON line under "cases"; flash's
               backward kernels (``flash_attention_bwd``, the port's own:
               no Pallas counterpart) at llama-1.5b's, whisper-base's
               encoder and cross, gemma3-4b's local (D 256), stablelm-12b's
               (D 160) and gemma2-27b's softcapped layer shapes and at
               llama-1.5b's train batch of 4, each naming its design, each
               gradient element within 4 bf16 ulps of the magnitude of the
               terms it sums (``plain_backward(..., terms=True)``),
               bit-equal on a second call, beside SDPA's backward, with the
               forward's O bit-equal with and without its LSE output; the
               rwkv6 scan's backward (``rwkv6_scan_bwd``, the port's own:
               a dS chain kernel writing checkpoints and a body kernel
               over groups of chunks) at rwkv6-7b's train shape (B 4, T
               1536, H 64, D 64, chunk 8; dS_T zero and nonzero), at chunk
               64 and on a ragged 40-row tail carrying a state, each
               gradient leaf within max(3x the f32 ``plain_backward``'s own
               error, 16 f32 ulps of the leaf's max) of a float64
               ``plain_backward``, the checkpoints within the same rule of
               ``plain_dstate``, bit-equal on a second call, timed by
               kernel beside two bounds, and the scan's forward at chunk 8
               timed at the train shape
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
               fleet        ``FleetController`` (tracer on, host clock)
                            over two ``PagedEngine``s (full tier), a
                            dense lite-tier engine (an int8 round trip of
                            the weights) and a draft (mini tier: half the
                            layers, seed 9) -> verify pair in
                            distribution mode; twelve requests across
                            sensitivities, floors and priorities; a live
                            migration, a failure with exact re-placement
                            from shadows, a lossy hand-off and a refused
                            one, an uplink cut; conservation after every
                            step; moved greedy requests against fresh
                            engines bit for bit; launches against the
                            count from the engines' programs
               replicate    ``ReplicationManager`` over three dense
                            engines (full, lite, mini): synced steps, a
                            failover split into its stages, steps on the
                            lite replica, a merge on reconnect; then the
                            daemon's decisions and its decode roofline
                            against a measured step
               service      the fleet's service mode: a ``ControlPlane``
                            over ``SocketTransport``, a thread per
                            ``PagedEngine`` (a, b, c; the paged geometry,
                            one program set), six requests (the paged
                            prompt lengths, 32 new, greedy and sampled,
                            three sensitivities); b's service
                            killed once it holds a shadowed slot, the
                            heartbeat detector failing it over; every
                            ticket done once, greedy ones against the same
                            request alone bit for bit; frames, retries,
                            injects; then the concurrency ratio: the same
                            requests through one engine in the sync fleet
                            and through the three-engine socket fleet
               autoscale    a sync fleet over one seed ``PagedEngine`` with
                            an ``Autoscaler`` (one warm standby, pool 1-3,
                            spawn at a queue depth of 3): the promotion,
                            spawns served the seed's programs, the spawned
                            engines drained once the queue is empty,
                            conservation every step, greedy requests bit
                            for bit
               cli          ``repro_torch.launch.serve`` and
                            ``repro_torch.launch.fleet --transport socket``
                            in-process at full width
               examples     the six serving examples of
                            ``repro_torch.examples`` through their ``run``
                            at full width on the weights held (quickstart,
                            resilient_failover, validated_medical_agent,
                            speculative_serving with a one-layer draft of
                            seed 1 and its near-tie rule, speculative_fleet,
                            fleet_serving's five acts, act five's paged
                            engines at page size 8), every attention call
                            held to its plain version, each example's own
                            checks; beside them ``train_100m --full
                            --batch 32`` as child processes
                            (``chip_smoke.py --train-100m``, every flash,
                            remat and backward call held as in ``train``,
                            the verdicts read at the end): 120 steps, and
                            a run killed after its step-80 checkpoint line
                            and resumed, the two step-120 checkpoints
                            equal byte for byte, LEARNED printed; the path
                            must launch flash, its backward (D 64), dense
                            and paged decode and spec_accept
               each of the three with its launches equal to the engines'
               own program counts (24 x cold prefills, 24 x decode steps)
               roofline     the dry-run tools' steps
                            (``launch.steps.build(..., concrete=True)``)
                            at llama-1.5b's three cells' own lengths, each
                            global batch cut to one card: train_4k (B 8 of
                            256, microbatches 4, remat), prefill_32k (B 4
                            of 32), decode_32k (B 16 of 128, every cache
                            filled to 32767 tokens); per cell the meta-
                            device dry run of the cut shape, the median
                            step over 3 runs, the profiler's busy time,
                            the peak allocated memory against the dry
                            run's, its roofline terms, model FLOPs and
                            bytes, roofline fraction and mfu; every kernel
                            call held to its plain version (a prefill's
                            last 512 query rows against all 32768 keys);
                            launches exactly 6 runs' worth
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
               then the six other attention-only families at full width
               and one repeat of each block group (17 layers of 242; bf16,
               seed 0; one at a time, rwkv freed):
               families     gemma3-4b, gemma2-27b, stablelm-12b,
                            deepseek-7b, granite-moe-1b-a400m and
                            deepseek-moe-16b, each on a ``PagedEngine``
                            and a dense ``Engine`` (four requests, the
                            longest past the local window); one decode
                            step with every layer's attention held to its
                            plain version on the layer's own inputs, and
                            its logits against the plain versions (an MoE
                            model's plain run replays the kernel run's
                            routes); launches exactly num_layers x
                            prefills and decode forwards; gemma3-4b's
                            slot hops, paged and dense, bit for bit
               then jamba-v0.1-52b at full width, depth cut to 2 of its
               4 repeats (26.054B params: 103.1 GB of bf16 at full depth
               does not fit the card; bf16, seed 0; every other model
               freed):
               jamba        ``Engine(slots=4, max_len=1568)``: four
                            requests (37, 512, 1024, 1536 tokens), the
                            two attention layers' kernel calls held to
                            their plain versions and one decode step's
                            logits against the plain versions (the MoE
                            routes replayed); a fifth request in a
                            retired slot from all-zero mamba state, equal
                            to a fresh engine's, idle slots' ssm and conv
                            untouched; a 100-token prompt refused before
                            anything moved; profiles of a decode step and
                            of a 1536-token prefill split into the mamba
                            mixers and the rest; a sampled 1024-token
                            slot's v1 hop into an engine of seed 9, bit
                            for bit; launches exactly 2 x cold prefills
                            (flash) and 2 x decode forwards
               then the two models no engine serves, at full width and
               depth through ``models.forward`` (train, prefill, decode),
               fed by ``configs.inputs.batch_specs`` (bf16, seed 0; every
               other model freed):
               whisper      whisper-base (6 encoder + 6 decoder layers):
                            4 rows of 1536 frames, a 416-token prefill into
                            ``make_cache(cfg, 4, 448, cross_len=1536)``, 32
                            greedy decode steps; a timed and profiled run,
                            then the same run with every attention call
                            held to its plain version (bit for bit equal);
                            the last prefill row's and one decode step's
                            logits against the plain versions; prefill and
                            decode against one teacher-forced train
                            forward (logits, and the decode steps' argmax
                            over a floor that a forward on the wrong
                            frames stays under); one row of 32768 frames
                            (each encoder layer's flash held on its first
                            512 query rows); launches exactly 18 flash a
                            prefill or train forward, 12 dense decode a
                            decode step
               internvl     internvl2-26b (48 layers, 19.875B params): 4
                            rows of 256 patch embeddings + 1280 tokens, 32
                            greedy decode steps at positions 1536-1567, the
                            same checks (the teacher-forced forward over
                            2048 positions, the prefill domain); launches
                            exactly 48 flash a prefill or train forward,
                            48 dense decode a decode step
               then training through ``training.train`` (remat on; every
               other model freed):
               train        a train step given a mesh refused before
                            anything moves; llama-1.5b at
                            full width and depth (bf16, AdamW moments f32,
                            seed 0), ``Pipeline`` batches of 4 x 1536
                            tokens: ten steps, each finite, a checkpoint
                            saved before step 5 (``checkpoint/disk.py``)
                            and the run from it equal to the uninterrupted
                            one bit for bit; microbatches=2 against 1; a
                            step with every flash call held to its plain
                            version, each remat recompute to its first
                            pass bit for bit and every backward call to
                            ``plain_backward`` (the kernel phase's element
                            rule plus 2 fp32 ulps of the terms of the dot
                            products dP and delta); a profiled step; launches
                            exactly 48 flash and 24 backward a pass
               train_whisper whisper-base at full width and depth, 4 x 1536
                            frames and 416 tokens: two steps, the second
                            checked as above; launches exactly 36 flash
                            and 18 backward a step
               train_rwkv   rwkv6-7b at full width, 8 of its 32 layers
                            (2.307B params: at 16 the functional step's
                            old and new state, 22 bytes a param, need
                            89.5 GB; ``rwkv_train_config``), bf16, seed
                            0, 4 x 1536-token ``Pipeline`` batches, chunk
                            8: three steps, each finite; one batch's
                            gradients twice, bit-equal; a step with
                            every scan held to ``plain``, each remat
                            recompute to its first pass and every
                            backward call to ``plain_backward``; a
                            profiled step and its peak; launches exactly
                            16 rwkv6_scan and 8 rwkv6_scan_bwd a pass
               train_jamba  jamba-v0.1-52b's mamba mixer at full width
                            (d_inner 8192), forward and backward over 4 x
                            1536 tokens in bf16 and in float32, every
                            gradient within max(2^-6, 2x) / max(2^-16,
                            16x) its sensitivity to a one-ulp input
                            nudge of the same call on float64 copies; a
                            whole jamba train step does not fit
                            the card (one repeat: 13.30B params, 160 GB
                            at 12 bytes a param)
  5. the kernels' JSON line, the card line, and the result line

"""

from __future__ import annotations

import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# the kernels' costs and the H100 SXM data sheet's peaks, as the dry-run
# tools take them: every bound below is ``roofline.<kernel>_cost(...)``
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.mesh import HBM_BW, PEAK_BF16_FLOPS  # noqa: E402
BF16_TOL = 2e-2            # kernel vs plain, per element, abs
SPEC_TOL = 1e-6            # spec_accept's dist, kernel vs plain, abs
RWKV_TOL = 5e-4            # rwkv6_scan output and state, abs (JAX suite's)
# int8_matmul, relative to max |plain| (JAX suite's), and never under one
# ulp of the output at max |plain| (``out_ulp``): the kernel and the plain
# version sum exact products in fp32 in different orders and may round an
# element to neighbouring values (``scripts/int8_rule.py``)
INT8_REL = 5e-3
# the kernel no model path calls: held by its kernel phase alone
PHASE_ONLY = ("int8_matmul",)
# One decode step's logits, kernels vs plain versions, relative to the
# largest logit.  The two paths differ by about one bf16 ulp per attention
# output, and the random-init model amplifies that over 24 layers: the
# reference init takes fan-in from the stacked repeat axis (std 24**-0.5),
# so scores reach O(100), the softmax is near one-hot and the residual
# stream grows to O(1000), where a bf16 ulp is 4 to 8.
LOGIT_REL_TOL = 0.1
# the share of greedy decode steps whose argmax a teacher-forced train
# forward on the same tokens must give (whisper, internvl)
TEACHER_ARGMAX = 0.5
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


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def out_ulp(m: float, dtype) -> float:
    """One ulp of ``dtype`` (bf16 or fp32) at magnitude ``m`` > 0."""
    bits = 7 if dtype == torch.bfloat16 else 23
    return math.ldexp(1.0, math.frexp(m)[1] - 1 - bits)


def row_tol(ref) -> torch.Tensor:
    """Per-row limit for a bf16 attention output (..., H, D), one row a
    query: 4 bf16 ulps of the row's largest |value|, and never above
    ``BF16_TOL``.  On a long row the output averages many V rows and is
    small (randn inputs over 1536 keys: about 0.04), so a fixed 2e-2
    would hide an error such as a dropped slot or key block there."""
    top = ref.float().abs().amax((-2, -1)).clamp(min=1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return torch.clamp(4 * ulp, max=BF16_TOL)


def row_err(out, ref, rows) -> tuple[float, float]:
    """(max abs error, max error / per-row limit) over ``rows``."""
    e = (out[rows].float() - ref[rows].float()).abs().amax((-2, -1))
    return float(e.max()), float((e / row_tol(ref[rows])).max())


def wrappers() -> dict:
    """Every kernel wrapper, by the name of its row in the JSON line."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import rwkv6_scan as rs
    from repro_torch.kernels import spec_verify as sv
    return {"flash_attention": fa.flash_attention,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "paged_decode_attention": da.paged_decode_attention,
            "decode_attention": da.decode_attention,
            "spec_accept": sv.spec_accept,
            "rwkv6_scan": rs.rwkv6_scan,
            "rwkv6_scan_bwd": rs.rwkv6_scan_bwd,
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
            cost = roofline.flash_cost(B, S, S, H, KV, D)
            flops = cost.flops
            bms, by = cost.bound()
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




# flash cases beyond the slice's: (label, B, Sq, Skv, H, KV, D, causal,
# window); the families' and jamba's causal layers over S = 1536, then
# whisper-base's encoder and cross-attention (full mode, D 64; Sq = 416
# decoder tokens over 1536 frames) and internvl2-26b's layer (G 6)
FLASH_CASES = (("gemma3-4b local", 1, 1536, 1536, 8, 4, 256, True, 1024),
               ("stablelm-12b", 1, 1536, 1536, 32, 8, 160, True, 0),
               ("jamba-v0.1-52b", 1, 1536, 1536, 32, 8, 128, True, 0),
               ("whisper-base encoder", 4, 1536, 1536, 8, 8, 64, False, 0),
               ("whisper-base cross", 4, 416, 1536, 8, 8, 64, False, 0),
               ("internvl2-26b", 1, 1536, 1536, 48, 8, 128, True, 0))


def wide_flash(fa, gen) -> list:
    """flash at the other models' shapes (``FLASH_CASES``): gemma3-4b's
    local layer (H 8 / KV 4, D 256, window 1024), stablelm-12b's layer
    (H 32 / KV 8, D 160), jamba's (H 32 / KV 8, D 128, G 4),
    whisper-base's encoder and cross-attention (full mode, D 64) and
    internvl2-26b's layer (H 48 / KV 8, D 128, G 6); each query row
    against its plain version within ``row_tol``, bit-equal on a second
    call, and timed beside the plain version, SDPA (a band mask for the
    window) and the bound."""
    out = []
    for label, B, Sq, Skv, H, KV, D, causal, window in FLASH_CASES:
        kw = dict(causal=causal, window=window)
        q = torch.randn((B, Sq, H, D), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        k, v = (torch.randn((B, Skv, KV, D), generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        o = fa.flash_attention(q, k, v, **kw)
        ref = fa.plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err, frac = row_err(o, ref, slice(0, B))
        if not torch.isfinite(o).all() or frac > 1.0:
            raise AssertionError(f"flash {label} D={D}: max_abs_err {err} "
                                 f"at {frac:.2f} x its row's limit")
        if not torch.equal(o, fa.flash_attention(q, k, v, **kw)):
            raise AssertionError(f"flash {label}: a second call gave "
                                 "other bits")
        ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw))
        plain_ms = time_ms(lambda: fa.plain(q, k, v, **kw), iters=5)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        i = torch.arange(Sq, device="cuda")
        band = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)

        def sdpa():
            if window:
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=band, enable_gqa=True)
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)

        lib_err = max_err(sdpa().transpose(1, 2), ref)
        if lib_err > BF16_TOL:
            raise AssertionError(f"flash {label} yardstick: SDPA is "
                                 f"{lib_err} from plain")
        lib_ms = time_ms(sdpa)
        cost = roofline.flash_cost(B, Sq, Skv, H, KV, D, causal=causal,
                                   window=window)
        flops = cost.flops
        bms, by = cost.bound()
        log(f"flash {label} B={B} Sq={Sq} Skv={Skv} H={H} KV={KV} D={D} "
            f"{kw}: max_abs_err={err:.3e} ({frac:.2f} x its row's limit), "
            f"bit-equal on a second call | kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms "
            f"({by}), {flops / ms / 1e9:.1f} TFLOP/s")
        out.append(dict(case=label, B=B, Sq=Sq, Skv=Skv, H=H, KV=KV, D=D,
                        causal=causal, window=window, max_abs_err=err,
                        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                        library_ms=lib_ms))
    return out


# flash backward cases: (label, B, Sq, Skv, H, KV, D, causal, window,
# softcap): llama-1.5b's layer, whisper-base's encoder and cross shape
# (full mode, D 64), gemma3-4b's local layer (D 256, G 2), stablelm-12b's
# (D 160, G 4), gemma2-27b's softcapped one (D 128, G 2) and llama-1.5b's
# layer at the train path's batch of 4
BWD_CASES = (("llama-1.5b", 1, 1536, 1536, 16, 8, 128, True, 0, 0.0),
             ("whisper-base encoder", 4, 1536, 1536, 8, 8, 64, False, 0, 0.0),
             ("whisper-base cross", 4, 416, 1536, 8, 8, 64, False, 0, 0.0),
             ("gemma3-4b local", 1, 1536, 1536, 8, 4, 256, True, 1024, 0.0),
             ("stablelm-12b", 1, 1536, 1536, 32, 8, 160, True, 0, 0.0),
             ("gemma2-27b softcap", 1, 1536, 1536, 32, 16, 128, True, 0,
              50.0),
             ("llama-1.5b train", 4, 1536, 1536, 16, 8, 128, True, 0, 0.0))
# a gradient element's limit: 4 bf16 ulps (4 x 2^-7, relative) of the
# magnitude of the terms it sums (``plain_backward(..., terms=True)``).
# The shadowed train steps add 2 fp32 ulps (2 x 2^-23) of the magnitude
# of the terms of the dot products dP = dO V^T and delta = rowsum(dO o O)
# carried into it: there a trained model's one-hot rows make dO
# orthogonal to O and to V's rows, so those two cancel to their fp32
# rounding in any fp32 implementation, ``plain_backward`` against float64
# included (``scripts/flash_bwd_rule.py``)
BWD_ULPS = 4 * 2.0 ** -7
DOT_ULPS = 2 * 2.0 ** -23


def bwd_err(grads, ref, terms, dots=None) -> tuple[float, float, float,
                                                   float]:
    """(max abs error, worst error over its element's limit, worst error
    over the bf16 rule alone, worst error over the row rule's limit) of
    dQ, dK, dV against ``plain_backward``.  The element's limit is the
    bf16 rule alone, or with ``dots`` (the dot products' magnitudes) that
    plus their ``DOT_ULPS`` part.  The row rule (``row_tol``: 4 ulps of
    the row's max, capped at 2e-2) is reported, not held: a row whose
    terms cancel (a causal row 0, whose dS is 0 in exact arithmetic) has
    no magnitude of its own, and a gradient's rows pass the 2e-2 cap
    (|dV| to 9.5 at these shapes)."""
    err = frac = part = row = 0.0
    for i, (g, r, t) in enumerate(zip(grads, ref, terms)):
        e = (g.float() - r.float()).abs()
        err = max(err, float(e.max()))
        lim = BWD_ULPS * t
        part = max(part, float((e / lim.clamp(min=1e-30)).max()))
        if dots is not None:
            lim = lim + DOT_ULPS * dots[i]
        frac = max(frac, float((e / lim.clamp(min=1e-30)).max()))
        row = max(row, float((e.amax((-2, -1)) / row_tol(r)).max()))
    return err, frac, part, row


def bwd_inputs(B, Sq, Skv, H, KV, D, gen):
    q, do = (torch.randn((B, Sq, H, D), generator=gen, device="cuda",
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, Skv, KV, D), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    return q, k, v, do


def kernel_device_ms(fn, iters=10) -> dict:
    """The profiler's device time per call of ``fn`` by kernel name
    (template arguments dropped), over ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = re.match(r"\w*", e.key.removeprefix(
                "void (anonymous namespace)::")).group()
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3
    return {k: round(v / iters, 4) for k, v in out.items()}


def check_flash_bwd(fa, gen) -> dict:
    """The backward kernels (``csrc/flash_attention_bwd.cu``) at
    ``BWD_CASES``: the forward with and without its LSE output bit-equal
    (and timed at llama's shape), dQ, dK, dV against ``plain_backward``
    on the same inputs by ``bwd_err``'s element rule, bit-equal on a
    second call, and timed (events, and the profiler's device time of
    each kernel) beside the plain version, SDPA's backward (the library
    yardstick, without the softcap SDPA lacks; a band mask for the
    window) and the bound: 2.5x the forward's products, or the bytes of
    q, k, v, O, dO, LSE read and dQ, dK, dV written.  Each case names the
    design it ran (``bwd_design``)."""
    from repro_torch.kernels import build
    for ln in ptxas_lines(build.logs.get("flash_attention_bwd", ""),
                          "dkdv_wgmma|dq_wgmma|dkdv_mma|dq_mma|bwd_delta",
                          {}):
        log(f"flash_attention_bwd build: {ln}")
    cases, row = [], None
    for label, B, Sq, Skv, H, KV, D, causal, window, softcap in BWD_CASES:
        kw = dict(causal=causal, window=window, softcap=softcap)
        design = fa.bwd_design(B, Skv, KV, D)
        q, k, v, do = bwd_inputs(B, Sq, Skv, H, KV, D, gen)
        o, lse = fa.forward_with_lse(q, k, v, **kw)
        if not torch.equal(o, fa.flash_attention(q, k, v, **kw)):
            raise AssertionError(f"flash bwd {label}: O with the LSE output "
                                 "differs from O without it")
        grads = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
        again = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
        *ref, terms, _ = fa.plain_backward(q, k, v, o, do, terms=True,
                                           **kw)
        torch.cuda.synchronize()
        err, frac, _, rowf = bwd_err(grads, ref, terms)
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        if not finite or frac > 1.0:
            raise AssertionError(f"flash bwd {label}: max_abs_err {err} at "
                                 f"{frac:.2f} x its element's limit")
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f"flash bwd {label}: a second call gave "
                                 "other bits")
        del again, ref, terms
        ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, do, lse,
                                                    **kw))
        dev = kernel_device_ms(lambda: fa.flash_attention_bwd(
            q, k, v, o, do, lse, **kw))
        plain_ms = time_ms(lambda: fa.plain_backward(q, k, v, o, do, **kw),
                           iters=3, warmup=1)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        i, j = (torch.arange(n, device="cuda") for n in (Sq, Skv))
        band = (j[None] <= i[:, None]) & (j[None] > i[:, None] - window)
        ot = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=band if window else None,
            is_causal=causal and not window, enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()
        lib_ms = time_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True))
        del qt, kt, vt, ot, dot
        cost = roofline.flash_bwd_cost(B, Sq, Skv, H, KV, D, causal=causal,
                                       window=window)
        flops = cost.flops
        bms, by = cost.bound()
        line = (f"flash bwd {label} B={B} Sq={Sq} Skv={Skv} H={H} KV={KV} "
                f"D={D} {kw} ({design}): max_abs_err={err:.3e} ({frac:.3f} "
                f"x its element's limit; {rowf:.2f} x the row rule's), "
                f"bit-equal on a second call; O bit-equal with and without "
                f"the LSE | kernel {ms:.4f} ms (profiler device ms by "
                f"kernel {dev}), plain {plain_ms:.4f} ms, sdpa backward "
                f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
                f"{flops / ms / 1e9:.1f} TFLOP/s")
        case = dict(case=label, B=B, Sq=Sq, Skv=Skv, H=H, KV=KV, D=D,
                    causal=causal, window=window, softcap=softcap,
                    design=design, max_abs_err=err, limit_frac=frac,
                    row_rule_frac=rowf, ms=ms,
                    device_ms=dev, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, library_ms=lib_ms)
        if row is None:
            # row 1's shape: the forward's time with and without the LSE
            fwd_ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw))
            lse_ms = time_ms(lambda: fa.forward_with_lse(q, k, v, **kw))
            line += (f"\nflash bwd {label}: forward {fwd_ms:.4f} ms without "
                     f"the LSE output, {lse_ms:.4f} ms with it")
            row = dict(name="flash_attention_bwd", route="cuda",
                       source="src/repro_torch/kernels/csrc/"
                              "flash_attention_bwd.cu",
                       replaces="src/repro/models/attention.py:97",
                       **case, forward_ms=fwd_ms, forward_lse_ms=lse_ms)
        else:
            cases.append(case)
        log(line)
    row["max_abs_err"] = max([row["max_abs_err"]]
                             + [c["max_abs_err"] for c in cases])
    row["cases"] = cases
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
    valid = sum(int(p) + 1 for p in pos.tolist())
    cost = roofline.paged_decode_cost(B, H, KV, D, live_pages * ps, valid,
                                      pt.numel())
    nbytes = cost.bytes
    bms, by = cost.bound()
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
    cost = roofline.decode_cost(B, H, KV, D, valid)
    nbytes = cost.bytes
    bms, by = cost.bound()
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


def _live(pos, window: int, slots: int = 1 << 62) -> list[int]:
    """Each row's valid slots at its position (within the window, and
    at most ``slots``: a cross cache's rows sit at position 2^30)."""
    return [min(int(p) + 1, window or slots, slots) for p in pos]


# paged decode cases beyond the slice's: (label, H, KV, D, window, page
# size, table width NP, pool pages P, positions of the rows); the
# families' rows near positions 1000-1500 over 16-slot pages, and
# llama-1.5b at page size 8: fleet_serving's act five (two rows of a
# max_len-64 engine, NP 8, its 16-page pool) and the paged engine's B 4
# near position 1000 (max_len 2048)
PAGED_CASES = (
    ("gemma3-4b local", 8, 4, 256, 1024, 16, 128, 512,
     (1000, 1200, 1350, 1500)),
    ("gemma3-4b global", 8, 4, 256, 0, 16, 128, 512,
     (1000, 1200, 1350, 1500)),
    ("stablelm-12b", 32, 8, 160, 0, 16, 128, 512, (1000, 1200, 1350, 1500)),
    ("llama-1.5b ps 8 act five", 16, 8, 128, 0, 8, 8, 16, (21, 25)),
    ("llama-1.5b ps 8", 16, 8, 128, 0, 8, 256, 1024, (1000, 990, 1010, 1005)))


def wide_paged(da, gen) -> list:
    """paged decode beyond the slice's shape (``PAGED_CASES``): the
    families' wide head dims, gemma3-4b (G 2, D 256) windowed (1024) and
    global, stablelm-12b (G 4, D 160), and llama-1.5b at page size 8;
    each row within its limit against the plain version, bit-equal on a
    second call, and timed (pools rotated, cold in L2) beside the plain
    version, SDPA over pre-gathered K/V and the bound."""
    rng = np.random.default_rng(SEED + 24)
    out = []
    for label, H, KV, D, window, ps, NP, P, at in PAGED_CASES:
        B = len(at)
        pos = torch.tensor(at, dtype=torch.int32, device="cuda")
        q = torch.randn((B, 1, H, D), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        pools = [tuple(_pools(P, ps, KV, D, gen)) for _ in range(4)]
        pt = torch.from_numpy(np.stack([rng.permutation(P)[:NP]
                                        for _ in range(B)]).astype(
                                            np.int32)).cuda()
        o = da.paged_decode_attention(q, *pools[0], pt, pos, window=window)
        ref = da.paged_plain(q, *pools[0], pt, pos, window=window)
        err, frac = row_err(o, ref, slice(0, B))
        if not torch.isfinite(o).all() or frac > 1.0:
            raise AssertionError(f"paged {label} D={D}: max_abs_err {err} "
                                 f"at {frac:.2f} x its row's limit")
        if not torch.equal(o, da.paged_decode_attention(
                q, *pools[0], pt, pos, window=window)):
            raise AssertionError(f"paged {label}: a second call gave "
                                 "other bits")
        it = iter(range(1 << 30))

        def kern():
            kp, vp = pools[next(it) % len(pools)]
            da.paged_decode_attention(q, kp, vp, pt, pos, window=window)

        ms = time_ms(kern, iters=40)
        plain_ms = time_ms(lambda: da.paged_plain(
            q, *pools[0], pt, pos, window=window), iters=10)
        S = (int(pos.max()) // ps + 1) * ps
        ids = pt[:, :S // ps].long()
        dense = [tuple(x[ids].reshape(B, S, KV, D).transpose(1, 2)
                       .contiguous() for x in pl) for pl in pools]
        qt = q.transpose(1, 2).contiguous()
        j = torch.arange(S, device="cuda")[None]
        ok = j <= pos[:, None]
        if window:
            ok &= j > pos[:, None] - window
        mask = ok[:, None, None, :]
        lib_it = iter(range(1 << 30))

        def sdpa():
            kt, vt = dense[next(lib_it) % len(dense)]
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)

        lib_err = max_err(torch.nn.functional.scaled_dot_product_attention(
            qt, *dense[0], attn_mask=mask, enable_gqa=True).transpose(1, 2),
            ref)
        if lib_err > BF16_TOL:
            raise AssertionError(f"paged {label} yardstick: SDPA is "
                                 f"{lib_err} from plain")
        lib_ms = time_ms(sdpa, iters=40)
        valid = sum(_live(pos.tolist(), window))
        cost = roofline.paged_decode_cost(B, H, KV, D, valid, valid,
                                          pt.numel())
        nbytes = cost.bytes
        bms, by = cost.bound()
        log(f"paged_decode {label} B={B} H={H} KV={KV} D={D} ps={ps} "
            f"NP={NP} window {window} positions {pos.tolist()}: "
            f"max_abs_err={err:.3e} "
            f"({frac:.2f} x its row's limit), bit-equal on a second call | "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa over "
            f"pre-gathered K/V {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
            f"{nbytes / ms / 1e6:.1f} GB/s")
        out.append(dict(case=label, B=B, H=H, KV=KV, D=D, window=window,
                        page_size=ps, NP=NP, positions=list(at),
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=lib_ms))
    return out


# dense decode cases beyond the slice's: (label, H, KV, D, Sc, window,
# positions of the 4 rows); the families' and jamba's engines hold
# max_len 1568 rows; internvl2-26b's last decode step (G 6, positions
# 1567), whisper-base's cross-attention (D 64, G 1, 1536 frames, every
# row at 2^30)
DECODE_CASES = (
    ("gemma3-4b local ring", 8, 4, 256, 1024, 1024, (1000, 1200, 1350, 1500)),
    ("stablelm-12b", 32, 8, 160, 1568, 0, (1000, 1200, 1350, 1500)),
    ("jamba-v0.1-52b", 32, 8, 128, 1568, 0, (1000, 1200, 1350, 1500)),
    ("internvl2-26b", 48, 8, 128, 1568, 0, (1567,) * 4),
    ("whisper-base cross", 8, 8, 64, 1536, 0, (1 << 30,) * 4))


def wide_decode(da, gen) -> list:
    """dense decode at the other models' shapes (``DECODE_CASES``):
    gemma3-4b's local layer (a 1024-slot ring buffer, window 1024, H 8 /
    KV 4, D 256), stablelm-12b's layer (H 32 / KV 8, D 160),
    jamba-v0.1-52b's (H 32 / KV 8, D 128: G 4), internvl2-26b's (G 6)
    and whisper-base's cross-attention (D 64, position 2^30), B = 4
    rows; each row within its limit against the plain version, bit-equal
    on a second call, timed (caches rotated) beside the plain version,
    SDPA and the bound."""
    B = 4
    out = []
    for label, H, KV, D, Sc, window, at in DECODE_CASES:
        pos = torch.tensor(at, dtype=torch.int32, device="cuda")
        slot = torch.arange(Sc, device="cuda")[None]
        if window:
            p = pos[:, None] - ((pos[:, None] - slot) % Sc)
            ap = torch.where(p >= 0, p, -1).to(torch.int32)
        else:
            ap = torch.where(slot <= pos[:, None], slot, -1).to(torch.int32)
        q = torch.randn((B, 1, H, D), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        caches = [tuple(_dense_case(B, Sc, KV, D, gen)) for _ in range(4)]
        kw = dict(window=window)
        o = da.decode_attention(q, *caches[0], ap, pos, **kw)
        ref = da.plain(q, *caches[0], ap, pos, **kw)
        err, frac = row_err(o, ref, slice(0, B))
        if not torch.isfinite(o).all() or frac > 1.0:
            raise AssertionError(f"decode {label} D={D}: max_abs_err {err} "
                                 f"at {frac:.2f} x its row's limit")
        if not torch.equal(o, da.decode_attention(q, *caches[0], ap, pos,
                                                  **kw)):
            raise AssertionError(f"decode {label}: a second call gave "
                                 "other bits")
        it = iter(range(1 << 30))

        def kern():
            kc, vc = caches[next(it) % len(caches)]
            da.decode_attention(q, kc, vc, ap, pos, **kw)

        ms = time_ms(kern, iters=40)
        plain_ms = time_ms(lambda: da.plain(q, *caches[0], ap, pos, **kw),
                           iters=10)
        kt, vt = (c.transpose(1, 2).contiguous() for c in caches[0])
        qt = q.transpose(1, 2).contiguous()
        ok = (ap >= 0) & (ap <= pos[:, None])
        if window:
            ok &= ap > pos[:, None] - window
        mask = ok[:, None, None, :]

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)

        lib_err = max_err(sdpa().transpose(1, 2), ref)
        if lib_err > BF16_TOL:
            raise AssertionError(f"decode {label} yardstick: SDPA is "
                                 f"{lib_err} from plain")
        lib_ms = time_ms(sdpa, iters=40)
        valid = sum(_live(at, window, Sc))
        cost = roofline.decode_cost(B, H, KV, D, valid, B * Sc)
        nbytes = cost.bytes
        bms, by = cost.bound()
        log(f"decode_attention {label} B={B} Sc={Sc} H={H} KV={KV} D={D} "
            f"window {window} positions {list(at)}: max_abs_err="
            f"{err:.3e} ({frac:.2f} x its row's limit), bit-equal on a "
            f"second call | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}, "
            f"{2 * valid * KV * D * 2 / 1e6:.1f} MB of K+V), "
            f"{nbytes / ms / 1e6:.1f} GB/s")
        out.append(dict(case=label, B=B, H=H, KV=KV, D=D, window=window,
                        positions=list(at), max_abs_err=err, ms=ms,
                        plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                        library_ms=lib_ms))
    return out


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
        cost = roofline.spec_accept_cost(4, V, n)
        nbytes = cost.bytes
        bms, by = cost.bound()
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
    cost = roofline.rwkv6_scan_cost(B, T, H, D, 64)
    flops, nbytes = cost.flops, cost.bytes
    bms, by = cost.bound()
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


# rwkv6-7b's train shape (B, T, H, D, chunk): 4 x 1536 tokens, chunk 8
RWKV_TRAIN = (4, 1536, 64, 64, 8)


def rwkv_bwd_err(rs, grads, ins, dy, dS, chunk, states=None
                 ) -> tuple[float, float, str]:
    """``rs.backward_error`` (each gradient leaf within max(3x the f32
    ``plain_backward``'s own error against float64, ``rs.BWD_ULPS`` f32
    ulps of the leaf's max |grad|)) on ``ins`` = (r, k, v, w, u, state0),
    raising AssertionError on a non-finite gradient."""
    try:
        return rs.backward_error(grads, *ins, dy, dS, chunk=chunk,
                                 states=states)
    except ValueError as e:
        raise AssertionError(f"rwkv6_scan_bwd: {e}") from None


def _moderate(w, gen):
    """w redrawn in [exp(-e^-1), exp(-e^-4)] = [0.69, 0.98]: past chunk 8
    the decays to exp(-e^1.5) take A_incl to 1e-20 within a chunk, where
    kA / A_incl, the gradient's own term, overflows float32 (the train
    path runs chunk 8)."""
    x = torch.rand(w.shape, generator=gen, device="cuda")
    return torch.exp(-torch.exp(-4.0 + 3.0 * x))


def check_rwkv6_bwd(rs, gen) -> tuple[dict, dict]:
    """The backward (``csrc/rwkv6_scan_bwd.cu``, the port's own: no
    Pallas counterpart; two device kernels a call, the dS chain and the
    body over groups of chunks) at rwkv6-7b's train shape (B=4, T=1536,
    H=64, D=64, chunk 8, state0 zero, decays to exp(-e^1.5)) with dS_T
    zero and nonzero, at chunk 64 (B=1, T=1536) and on a ragged 40-row
    tail carrying a state (B=4), both at w >= 0.69 (``_moderate``): the
    forward's out and final state bit-equal with and without its states
    output, whose first chunk is state0; those chunk-start states within
    ``RWKV_TOL`` x max(1, the chunk's max |plain|) of ``plain_states``,
    per chunk (``rs.states_error``); every gradient leaf within
    ``rwkv_bwd_err``'s rule of ``plain_backward`` on the same chunk-start
    states (the backward kernel's inputs), and within the same rule of
    ``plain_backward`` on its own states (forward and backward kernels
    together); the chain's checkpoints and dstate0 within the same rule
    of ``plain_dstate`` (``rs.dstate_error``); bit-equal on a second
    call, checkpoints too.  At the train shape timed by events and by the
    profiler's device time, in all and by kernel, beside
    ``plain_backward`` and two bounds: the bytes any backward must move
    (r, k, v, w, dy, dS_T in, the gradients out) and the bytes this
    design moves (the states, the checkpoints and the chain's reads
    too); the forward at chunk 8
    timed there too, with and without the states output.  Returns (the
    backward's row, the forward's chunk-8 case for rwkv6_scan's row)."""
    from repro_torch.kernels import build
    for ln in ptxas_lines(build.logs.get("rwkv6_scan_bwd", ""),
                          "rwkv6_bwd_chain|rwkv6_bwd_body", {}):
        log(f"rwkv6_scan_bwd build: {ln}")
    B, T, H, D, C = RWKV_TRAIN
    cases, row = [], None
    for label, (b, t, c, ds_T, moderate, s0) in {
            "train dS_T=0": (B, T, C, False, False, False),
            "train dS_T": (B, T, C, True, False, False),
            "chunk 64": (1, T, 64, True, True, True),
            "ragged 40-row tail": (B, 40, 40, True, True, True)}.items():
        r, k, v, w, u, st0 = _rwkv_inputs(b, t, H, D, gen)
        if moderate:
            w = _moderate(w, gen)
        if not s0:
            st0 = torch.zeros_like(st0)
        dy = torch.randn((b, t, H, D), generator=gen, device="cuda")
        dS = (torch.randn((b, H, D, D), generator=gen, device="cuda")
              if ds_T else None)
        ins = (r, k, v, w, u, st0)
        o, sT, states = rs.forward_with_states(*ins, chunk=c)
        o2, sT2 = rs.rwkv6_scan(*ins, chunk=c)
        if not (torch.equal(o, o2) and torch.equal(sT, sT2)
                and torch.equal(states[:, :, 0], st0)):
            raise AssertionError(f"rwkv6_scan_bwd {label}: the forward with "
                                 "its states output gave other bits, or "
                                 "its first state is not state0")
        del o2, sT2
        s_frac = rs.states_error(states, r, k, v, w, chunk=c, tol=RWKV_TOL)
        if s_frac > 1.0:
            raise AssertionError(f"rwkv6_scan {label}: the chunk-start "
                                 f"states at {s_frac:.2f} x their limit "
                                 f"against plain_states")

        def kern():
            return rs.rwkv6_scan_bwd(r, k, v, w, u, states, dy, dS, chunk=c,
                                     checkpoints=True)
        (*grads, ck), again = kern(), kern()
        torch.cuda.synchronize()
        G, DV = rs.groups(b, H, t // c), rs.chain_split(b, H, D)
        err, frac, worst = rwkv_bwd_err(rs, grads, ins, dy, dS, c, states)
        if frac > 1.0:
            raise AssertionError(f"rwkv6_scan_bwd {label}: {frac:.2f} x "
                                 f"its limit ({worst})")
        # the forward kernel and the backward kernel together, against
        # plain_backward on its own states
        e2e, e2e_frac, e2e_worst = rwkv_bwd_err(rs, grads, ins, dy, dS, c)
        if e2e_frac > 1.0:
            raise AssertionError(f"rwkv6_scan_bwd {label}: on plain's own "
                                 f"states {e2e_frac:.2f} x its limit "
                                 f"({e2e_worst})")
        c_err, c_frac, c_worst = rs.dstate_error(ck, grads[5], r, w, dy, dS,
                                                 chunk=c, group=G)
        if c_frac > 1.0:
            raise AssertionError(f"rwkv6_scan_bwd {label}: the chain's "
                                 f"checkpoints at {c_frac:.2f} x their limit "
                                 f"against plain_dstate ({c_worst})")
        if not all(torch.equal(x, y) for x, y in zip([*grads, ck], again)):
            raise AssertionError(f"rwkv6_scan_bwd {label}: a second call "
                                 "gave other bits")
        del grads, again, ck
        line = (f"rwkv6_scan_bwd {label} B={b} T={t} H={H} D={D} chunk {c}: "
                f"max_abs_err={err:.3e} ({frac:.3f} x its leaf's limit: "
                f"max(3 x the f32 plain_backward's own error against "
                f"float64, {rs.BWD_ULPS} f32 ulps of the leaf's max), on "
                f"the forward kernel's chunk-start states), bit-equal on a "
                f"second call; out and state bit-equal with and without the "
                f"states output; those states at {s_frac:.3f} x their limit "
                f"against plain_states ({RWKV_TOL} x max(1, the chunk's max "
                f"|plain|), per chunk); against plain_backward on its own "
                f"states {e2e:.3e} ({e2e_frac:.3f} x the same rule); group "
                f"{G}, chain split {DV}: the checkpoints and dstate0 against "
                f"plain_dstate {c_err:.3e} ({c_frac:.3f} x the same rule)")
        case = dict(case=label, B=b, T=t, H=H, D=D, chunk=c, group=G,
                    chain_split=DV, max_abs_err=err, limit_frac=frac,
                    states_frac=s_frac, own_states_frac=e2e_frac,
                    checkpoints_frac=c_frac)
        if row is None:
            ms = time_ms(kern, iters=10)
            dev, names = device_ms(kern, iters=10)
            dev_k = kernel_device_ms(kern)
            plain_ms = time_ms(lambda: rs.plain_backward(
                r, k, v, w, u, st0, dy, dS, chunk=c), iters=2, warmup=1)
            cost = roofline.rwkv6_scan_bwd_cost(b, t, H, D, c)
            flops, nbytes = cost.flops, cost.bytes
            bms, by = cost.bound()
            # the bytes this design moves: the chain reads r and w once a
            # column block (D / DV), dy once, and writes the checkpoints
            # and dstate0; the body reads r, k, v, w, dy, u, the states and
            # the checkpoints and writes dr, dk, dv, dw and du's partials
            NC, NG = t // c, -(-(t // c) // G)
            rows_b, ck_b = 4 * b * t * H * D, 4 * b * H * NG * D * D
            design_bytes = ((2 * D // DV + 1) * rows_b + ck_b
                            + 8 * b * H * D * D
                            + 9 * rows_b + 4 * H * D
                            + 4 * b * H * NC * D * D + ck_b
                            + 4 * b * H * NG * D)
            d_bms = design_bytes / HBM_BW * 1e3
            line += (f" | kernel {ms:.4f} ms, plain_backward {plain_ms:.4f} "
                     f"ms, bound {bms:.4f} ms ({by}: {flops / 1e9:.2f} "
                     f"GFLOP at the fp32 CUDA-core peak, {nbytes / 1e6:.1f} "
                     f"MB; the states read besides: "
                     f"{4 * b * H * (t // c) * D * D / 1e6:.1f} MB), "
                     f"{nbytes / ms / 1e6:.1f} GB/s = {bms / ms:.1%} of the "
                     f"bound's rate; the design's bound {d_bms:.4f} ms "
                     f"({design_bytes / 1e6:.1f} MB: the states, checkpoints "
                     f"and chain reads too) = {d_bms / ms:.1%} of its rate"
                     f"\nrwkv6_scan_bwd profiler device time per call: "
                     f"{dev:.4f} ms {names}; by kernel {dev_k}")
            row = dict(name="rwkv6_scan_bwd", route="cuda",
                       source="src/repro_torch/kernels/csrc/"
                              "rwkv6_scan_bwd.cu",
                       replaces="none: JAX differentiates the jnp chunk body "
                                "src/repro/models/rwkv6.py:113-140; no "
                                "Pallas backward exists",
                       **case, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                       bound_by=by, library_ms=None, device_ms=dev,
                       device_kernels=sorted(n for n in dev_k
                                             if n.startswith("rwkv6_bwd")),
                       device_ms_by_kernel=dev_k,
                       design_bound_ms=d_bms, design_bytes=design_bytes)
            # the forward at chunk 8 (what a train step runs, with the
            # states output), timed at the same shape
            def fwd():
                return rs.rwkv6_scan(r, k, v, w, u, st0, chunk=c)
            f_ms = time_ms(fwd, iters=10)
            fs_ms = time_ms(lambda: rs.forward_with_states(
                r, k, v, w, u, st0, chunk=c), iters=10)
            f_dev, f_names = device_ms(fwd, iters=10)
            f_plain = time_ms(lambda: rs.plain(r, k, v, w, u, st0, chunk=c),
                              iters=2, warmup=1)
            f_cost = roofline.rwkv6_scan_cost(b, t, H, D, c)
            f_flops, f_bytes = f_cost.flops, f_cost.bytes
            f_bms, f_by = f_cost.bound()
            line += (f"\nrwkv6_scan forward at the train chunk B={b} T={t} "
                     f"H={H} D={D} chunk {c}: kernel {f_ms:.4f} ms, with the "
                     f"states output {fs_ms:.4f} ms, plain {f_plain:.4f} ms, "
                     f"bound {f_bms:.4f} ms ({f_by}: {f_flops / 1e9:.2f} "
                     f"GFLOP, {f_bytes / 1e6:.1f} MB) = {f_bms / f_ms:.1%} of "
                     f"the bound's rate; profiler device time per call "
                     f"{f_dev:.4f} ms {f_names}")
            fwd_case = dict(case="train chunk 8", B=b, T=t, H=H, D=D, chunk=c,
                            ms=f_ms, states_ms=fs_ms, plain_ms=f_plain,
                            bound_ms=f_bms, bound_by=f_by, library_ms=None,
                            device_ms=f_dev)
        else:
            cases.append(case)
        log(line)
        del r, k, v, w, u, st0, dy, dS, states, o, sT
    row["max_abs_err"] = max([row["max_abs_err"]]
                             + [c["max_abs_err"] for c in cases])
    row["cases"] = cases
    return row, fwd_case


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
    plus f32-x cases: within max(5e-3, one output ulp) of max |plain|,
    bit-equal on a second call, each on the design its shape routes to.
    All four bf16 shapes are timed beside the library call the kernel
    stands for (a bf16 matmul of the dequantised weights, scaled), with
    the profiler's device time of both."""
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
        err, top = max_err(o, ref), float(ref.float().abs().max())
        rel, tol = err / top, max(INT8_REL, out_ulp(top, dtype) / top)
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        design = im.route(M, N, K, dtype, True)
        if dtype == torch.bfloat16 and design != want[M]:
            raise AssertionError(f"int8_matmul {sh} M={M}: routed to "
                                 f"{design}, not {want[M]}")
        if ran != [design]:
            raise AssertionError(f"int8_matmul {sh} M={M}: launched {ran}, "
                                 f"route says {design}")
        if not torch.isfinite(o.float()).all() or o.dtype != dtype \
                or rel > tol:
            raise AssertionError(f"int8_matmul {sh} M={M} {dtype}: "
                                 f"rel err {rel} > {tol}")
        if not torch.equal(o, im.int8_matmul(x, wq, ws)):
            raise AssertionError(f"int8_matmul {sh} M={M} {dtype} "
                                 f"({design}): a second call gave other "
                                 "bits")
        line = (f"int8_matmul {sh} M={M} K={K} N={N} x {str(dtype)[6:]}: "
                f"design {design}, max_abs_err / max |plain| = {rel:.3e} "
                f"(tol {tol:.4e}: max(5e-3, one output ulp at max |plain| "
                f"{top:g}); {err / out_ulp(top, dtype):.2f} of that ulp), "
                f"bit-equal on a second call")
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
            cost = roofline.int8_matmul_cost(M, K, N)
            flops, nbytes = cost.flops, cost.bytes
            bms, by = cost.bound()
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
    and the kernels that take most device time, per ``per`` units, and
    return (wall ms, busy ms) per unit."""
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
    return wall * 1e3 / per, busy_us / 1e3 / per


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
    (attention rows and recurrent state alike; the engine state is left
    untouched)."""
    from repro_torch.models.model import forward
    from repro_torch.serving.engine import _weave_write
    s = engine.state
    caches = [[{kind: {k: a.clone() for k, a in c.items()}
                for kind, c in layer.items()}
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


def _resident(cfg, n=200):
    from repro_torch.serving.engine import Request
    prompt = np.random.default_rng(SEED + 8).integers(0, cfg.vocab_size, n)
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


def hop_pair(make, cfg, tally, label, landed, *, into=None, resident=200):
    """One request's hop between two engines of one kind beside busy
    rows, against unmigrated runs: m0 (sampled) leaves ``make(SEED)``
    after 8 steps and finishes in ``make(9)``, which already serves d0
    (``resident`` prompt tokens).
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
    tally.add(solo, _resident(cfg, resident))
    want.update(tally.drain(solo))
    del solo
    src = make(SEED)
    reqs = _hop_requests(cfg)
    tally.add(src, *reqs)
    for _ in range(8):
        tally.step(src)
    dst = make(9)
    tally.add(dst, _resident(cfg, resident))
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
# the fleet path: the sync-mode fleet, replication and the placement daemon
# ---------------------------------------------------------------------------

def mini_config(cfg):
    """The mini tier: the first half of the model's layers (the JAX
    tests' ``SMALL_CFG``), under its own name."""
    import dataclasses
    block = cfg.blocks[0]
    return cfg.replace(name=cfg.name + "-sm", blocks=(
        dataclasses.replace(block, repeats=block.repeats // 2),))


class Calls:
    """What the fleet's engines ran, counted at the engines' own step
    programs: each successful admission (one prefill: flash once a
    layer), each paged decode forward (paged decode once a layer), each
    dense decode forward, sampled or scoring (dense decode once a layer),
    and each slot a distribution verify call scores (spec_accept once).
    The kernels' launches on the path follow from these and the layer
    counts."""

    def __init__(self):
        self.n = {}
        self.layers = {}

    def _count(self, key, fn, weight=lambda *a, **kw: 1):
        def counted(*a, **kw):
            out = fn(*a, **kw)
            if out is not False:
                self.n[key] = self.n.get(key, 0) + weight(*a, **kw)
            return out
        return counted

    def watch(self, name, eng):
        self.layers[name] = (eng.cfg.num_layers, eng.paged)
        eng.add_request = self._count((name, "prefill"), eng.add_request)
        eng._decode_fn = self._count((name, "decode"), eng._decode_fn)
        if not eng.paged:
            eng._decode_probs = self._count((name, "decode"),
                                            eng._decode_probs)
            eng.verify_slots_distribution = self._count(
                (name, "verified"), eng.verify_slots_distribution,
                lambda drafts, *a, **kw: len(drafts))

    def predict(self) -> dict:
        pred = dict.fromkeys(("flash_attention", "paged_decode_attention",
                              "decode_attention", "spec_accept"), 0)
        for name, (layers, paged) in self.layers.items():
            get = lambda what: self.n.get((name, what), 0)  # noqa: E731
            pred["flash_attention"] += layers * get("prefill")
            pred["paged_decode_attention" if paged else
                 "decode_attention"] += layers * get("decode")
            pred["spec_accept"] += get("verified")
        return pred


class Stages:
    """Host seconds spent in named callables while the context is open
    (each call synchronised with the card): a migration's stages."""

    def __init__(self, **targets):
        self.targets, self.spent, self.saved = targets, {}, []

    def __enter__(self):
        for label, (obj, attr) in self.targets.items():
            fn = getattr(obj, attr)
            self.saved.append((obj, attr, fn, attr in vars(obj)))

            def timed(*a, _fn=fn, _label=label, **kw):
                t = time.perf_counter()
                out = _fn(*a, **kw)
                torch.cuda.synchronize()
                self.spent[_label] = (self.spent.get(_label, 0.0)
                                      + time.perf_counter() - t)
                return out
            setattr(obj, attr, timed)
        return self.spent

    def __exit__(self, *exc):
        for obj, attr, fn, own in reversed(self.saved):
            if own:
                setattr(obj, attr, fn)
            else:
                delattr(obj, attr)


def conserved(fleet):
    """The conservation audit of ``tests/helpers.assert_conserved``, the
    port's copy for engines without a prefix cache: every ticket in
    exactly one place (queued or parked, in flight on a healthy
    registered engine, or terminal), and each healthy engine's admission
    ledger equal to a walk over its rows."""
    from repro_torch.fleet import TERMINAL_STATES
    queued = {it.rid for it in fleet.queue.ordered()}
    inflight = set(fleet.inflight)
    if queued & inflight:
        raise AssertionError(f"fleet: duplicated {queued & inflight}")
    for rid, t in fleet.tickets.items():
        places = ((rid in queued) + (rid in inflight)
                  + (t.state in TERMINAL_STATES))
        if places != 1:
            raise AssertionError(f"fleet: {rid} in {places} places "
                                 f"({t.state.value})")
    for rid, (_, hname, _) in fleet.inflight.items():
        if hname not in fleet.handles or not fleet.handles[hname].healthy:
            raise AssertionError(f"fleet: {rid} on dead {hname}")
    for name, h in fleet.handles.items():
        if not h.healthy:
            continue
        eng = h.engine
        if eng.paged:
            eng.check()
            held = sum(len(eng._row_pages(r)) for r in eng.requests)
            want = (eng.allocator.free_pages * eng.page_size
                    if eng.free_slots else 0)
            if eng.allocator.used_pages != held \
                    or eng.free_token_budget != want:
                raise AssertionError(f"fleet: {name} ledger broken")
        elif eng.free_token_budget != len(eng.free_slots) * eng.max_len:
            raise AssertionError(f"fleet: {name} slot budget broken")


def _fleet_traffic():
    """Two waves of requests, 32 new tokens each: prompts of 37, 200,
    512 and 1024 tokens, greedy alternating with ``temperature=0.7,
    top_k=16``, the three sensitivities, quality floors 0, 0.5 and 1.0,
    one priority-2 request, and one whose deadline passes while it
    waits.  ``(rid, length, sampled, sensitivity, floor, priority,
    seconds to its deadline)``."""
    wave1 = [("x", 200, False, "personal", 1.0, 0, None),
             ("y", 1024, False, "public", 0.0, 0, None),
             ("z", 512, True, "confidential", 0.5, 0, None),
             ("w", 37, True, "public", 0.5, 0, None)]
    wave2 = [("a", 200, False, "personal", 0.5, 2, None),
             ("b", 512, True, "confidential", 0.5, 0, None),
             ("c", 1024, False, "personal", 0.0, 0, None),
             ("d", 200, False, "public", 0.0, 0, None),
             ("e", 37, True, "public", 0.0, 0, None),
             ("f", 37, False, "confidential", 1.0, 0, None),
             ("g", 1024, True, "public", 1.0, 0, 1.0),
             ("h", 512, False, "public", 0.0, 0, None)]
    return wave1, wave2


def run_fleet(cfg, params, lite, mini_cfg, mini):
    """The ``fleet`` path: ``FleetController`` over the port's engines at
    full width, on the host clock, tracer on.  Handles: ``cloud-a`` and
    ``cloud-b`` (``PagedEngine``, full tier, the port's ``CLOUD``),
    ``edge`` (dense ``Engine``, lite tier, ``EDGE``), and a speculative
    pair ``draft`` (dense, mini tier, the unattested ``MCU``) ->
    ``verify`` (dense, full tier), distribution mode, gamma 4.  Mid-run:
    a live migration cloud-a -> cloud-b, the failure of cloud-b, a lossy
    hand-off to edge inside the prefill domain and one outside it, and
    cloud-a's uplink cut while the second wave arrives."""
    from repro_torch.core.attestation import TrustAuthority
    from repro_torch.core.channel import AttestedSession, NetworkCondition
    from repro_torch.core.daemon import CLOUD, EDGE, MCU
    from repro_torch import compression
    from repro_torch.fleet import (EngineHandle, FleetController,
                                   QualityTier, Rebalancer, RequestSpec,
                                   RequestState, TERMINAL_STATES)
    from repro_torch.fleet import balancer as bal
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.serving.paged import PagedEngine

    FULL, LITE = QualityTier("full", 1.0, "bf16"), QualityTier("lite", 0.6,
                                                              "int8")
    MINI = QualityTier("mini", 0.3, "small")
    geo = dict(page_size=16, rows=4, max_len=2048, pages=160,
               device="cuda")
    dense = dict(slots=4, max_len=2048, device="cuda")
    handles = [
        EngineHandle("cloud-a", PagedEngine(cfg, params, seed=0, **geo),
                     CLOUD, tier=FULL),
        EngineHandle("cloud-b", PagedEngine(cfg, params, seed=1, **geo),
                     CLOUD, tier=FULL),
        EngineHandle("edge", Engine(cfg, lite, seed=2, **dense), EDGE,
                     tier=LITE),
        EngineHandle("draft", Engine(mini_cfg, mini, seed=3, **dense), MCU,
                     tier=MINI),
        EngineHandle("verify", Engine(cfg, params, seed=4, **dense), CLOUD,
                     tier=FULL),
    ]
    calls = Calls()
    for h in handles:
        calls.watch(h.name, h.engine)
    # shadow checkpoints every 8 fleet steps: each packs every in-flight
    # slot (a dense slot is 201 MB at max_len 2048)
    fleet = FleetController(handles, authority=TrustAuthority(),
                            balancer=Rebalancer(sync_every=8),
                            spec_tiers={"draft": "verify"},
                            spec_options={"verify_mode": "distribution",
                                          "gamma": 4}, tracer=True)
    H = fleet.handles
    rng = np.random.default_rng(SEED + 22)
    wave1, wave2 = _fleet_traffic()
    prompts = {}

    def submit(wave):
        for rid, n, sampled, sens, floor, prio, within in wave:
            deadline = None if within is None else fleet.clock() + within
            prompts[rid] = rng.integers(0, cfg.vocab_size, n)
            fleet.submit(RequestSpec(
                rid=rid, prompt=prompts[rid], max_new_tokens=32,
                temperature=0.7 if sampled else 0.0,
                top_k=16 if sampled else 0, sensitivity=sens,
                priority=prio, deadline=deadline, quality_floor=floor))

    def stage_targets(*engines):
        t = dict(pack=(bal, "pack_slot"), unpack=(bal, "unpack_slot"),
                 repack=(bal, "repack_slot"),
                 compress=(compression, "compress"),
                 decompress=(compression, "decompress"),
                 seal_open=(AttestedSession, "transfer"))
        for i, e in enumerate(engines):
            t[f"extract{i}"] = (e, "extract_slot")
            t[f"restore{i}"] = (e, "inject_slot")
        return t

    def record(label, before, spent, wire0):
        """Print one action's migration records and its stage seconds."""
        secs = {}
        for k, v in spent.items():
            k = k.rstrip("0123456789")
            secs[k] = round(secs.get(k, 0.0) + v, 4)
        moves = [f"{r.rid} {r.src} -> {r.dst} ({r.reason}, "
                 f"{'lossy' if r.lossy else 'exact'}, {r.wire_bytes} bytes)"
                 for r in fleet.telemetry.migrations[before:]]
        log(f"fleet: {label}: {'; '.join(moves)}; host seconds by stage "
            f"{secs}; simulated transfer {fleet.fabric.clock() - wire0:.4f}"
            f" s ({gpu_line()})")

    zero_counts()
    torch.cuda.synchronize()
    t_path = time.perf_counter()
    submit(wave1)
    step_walls, profile_step, refused, handoff = [], None, None, {}
    for step in range(600):
        if step == 6:
            # 1. a planned live migration of a greedy full-tier slot
            xs = [s for s, r in H["cloud-a"].engine.requests.items()
                  if r.rid == "x"]
            if not xs:
                raise AssertionError(f"fleet: x not on cloud-a: "
                                     f"{fleet.placements}")
            n0, wire0 = len(fleet.telemetry.migrations), fleet.fabric.clock()
            with Stages(**stage_targets(H["cloud-a"].engine,
                                        H["cloud-b"].engine)) as spent:
                rec = fleet.balancer.live_migrate(H["cloud-a"], H["cloud-b"],
                                                  xs[0], fleet)
            fleet.telemetry.record_migration(rec)
            record("live migration", n0, spent, wire0)
        if step == 10:
            # 2. cloud-b fails: its slots resume from shadow checkpoints
            n0, wire0 = len(fleet.telemetry.migrations), fleet.fabric.clock()
            with Stages(**stage_targets(H["cloud-a"].engine)) as spent:
                fleet.fail("cloud-b")
            record("failover", n0, spent, wire0)
        if step == 11:
            # 3. a lossy hand-off to edge inside the prefill domain (w:
            # 37 + committed tokens) and one outside it (z: 512 + 11)
            a = H["cloud-a"].engine
            slot = {r.rid: s for s, r in a.requests.items()}
            handoff["w"] = list(a.requests[slot["w"]].output)
            n0, wire0 = len(fleet.telemetry.migrations), fleet.fabric.clock()
            with Stages(**stage_targets(H["edge"].engine),
                        reprefill=(H["edge"].engine, "add_request")) \
                    as spent:
                rec = fleet.balancer.migrate(H["cloud-a"], H["edge"],
                                             slot["w"], fleet,
                                             reason="cloud-a uplink")
            fleet.telemetry.record_migration(rec)
            record("lossy hand-off", n0, spent, wire0)
            try:
                fleet.balancer.migrate(H["cloud-a"], H["edge"], slot["z"],
                                       fleet, reason="cloud-a uplink")
            except bal.ReprefillRefused as e:
                refused = str(e)
            if refused is None or "z" not in {
                    r.rid for r in a.requests.values()}:
                raise AssertionError("fleet: z's out-of-domain hand-off "
                                     "was not refused in place")
            log(f"fleet: refused before anything moved: {refused}")
            # then cloud-a's uplink goes down as the second wave arrives
            fleet.set_link("cloud-a", NetworkCondition(up=False))
            submit(wave2)
        if step >= 20 and H["cloud-a"].cond is not None \
                and fleet.tickets["g"].done:
            # the uplink returns once g's deadline passed out of reach
            fleet.set_link("cloud-a", None)
        t = time.perf_counter()
        if step == 14:
            profile_step = profiled(fleet.step, "fleet step (cloud-a, edge, "
                                    "draft + verify rounds)", 1)
        else:
            fleet.step()
        torch.cuda.synchronize()
        step_walls.append(time.perf_counter() - t)
        conserved(fleet)
        if all(tk.done for tk in fleet.tickets.values()):
            break
    wall = time.perf_counter() - t_path
    counts = read_counts()
    pred = calls.predict()
    tel = fleet.telemetry
    spec = fleet.spec_controllers["draft"].stats

    # every ticket terminal; the expected outcomes
    states = {rid: t.state for rid, t in fleet.tickets.items()}
    if not all(s in TERMINAL_STATES for s in states.values()):
        raise AssertionError(f"fleet: tickets not terminal {states}")
    want = {rid: RequestState.DONE for rid in states}
    want["g"] = RequestState.EXPIRED
    if states != want:
        raise AssertionError(f"fleet: states {states}")
    out = {rid: list(t.output) for rid, t in fleet.tickets.items()}
    lens = {r: len(o) for r, o in out.items()}
    if any(lens[r] != 32 for r in want if r != "g"):
        raise AssertionError(f"fleet: lengths {lens}")
    # confidential data only on attested profiles, over its history
    for rid, t in fleet.tickets.items():
        if t.spec.sensitivity == "confidential":
            bad = [h for h in fleet.placements.get(rid, [])
                   if not H[h].profile.attested]
            if bad:
                raise AssertionError(f"fleet: confidential {rid} on {bad}")
    # the moves: x exactly a -> b -> a, w lossily to edge with its prefix
    if fleet.placements["x"] != ["cloud-a", "cloud-b", "cloud-a"] or \
            fleet.placements["y"] != ["cloud-b", "cloud-a"]:
        raise AssertionError(f"fleet: placements {fleet.placements}")
    if fleet.placements["w"][-1] != "edge" or \
            out["w"][:len(handoff["w"])] != handoff["w"]:
        raise AssertionError("fleet: w's lossy hand-off lost its prefix")
    if fleet.placements["z"] != ["cloud-a"]:
        raise AssertionError(f"fleet: z moved {fleet.placements['z']}")
    downs = [ev for ev in tel.quality_events() if ev.direction == "down"]
    if not any(ev.reason == "link" and ev.dst_tier == "lite"
               and ev.rid == "a" for ev in downs):
        raise AssertionError(f"fleet: no link downshift of a: {downs}")
    spec_rids = [rid for rid, h in fleet.placements.items()
                 if "verify" in h]
    if not spec_rids or spec.requests != len(spec_rids):
        raise AssertionError(f"fleet: speculative {spec_rids} {spec}")
    if counts != {**counts, **pred}:
        raise AssertionError(f"fleet: launches {counts} != predicted "
                             f"{pred} from {calls.n}")

    # greedy requests that moved exactly, against a fresh engine
    solo = PagedEngine(cfg, params, seed=9, **geo)
    for rid in ("x", "y"):
        ref = Request(rid, prompts[rid], max_new_tokens=32)
        solo.add_request(ref)
        while solo.requests:
            solo.step()
        if ref.output != out[rid]:
            raise AssertionError(f"fleet: {rid} moved {fleet.placements[rid]}"
                                 f" gave {out[rid]} != alone {ref.output}")
    log("fleet: x (live migration cloud-a -> cloud-b, then failover back) "
        "and y (failover cloud-b -> cloud-a) gave the tokens of the same "
        "requests served alone on a fresh PagedEngine, bit for bit; w kept "
        f"its {len(handoff['w'])} committed tokens across the lossy hand-off;"
        " no confidential request touched an unattested engine")
    s = tel.summary()
    per = {n: (e["tokens"], e["tokens_per_s"])
           for n, e in s["engines"].items()}
    log(f"fleet: telemetry: engines {per} (tokens, tokens/s); latency p50 {s['fleet']['p50']} s, p99 "
        f"{s['fleet']['p99']} s; queue wait p50 "
        f"{s['lifecycle']['queue_wait_p50']} s; downshifts "
        f"{s['lifecycle']['downshifts']}, failovers {s['fleet']['failovers']}"
        f", migrations {s['fleet']['migrations']}")
    kinds, dsts = {}, {}
    for ev in tel.events:
        kinds[ev.kind] = kinds.get(ev.kind, 0) + 1
        if ev.kind == "lifecycle":
            dsts[ev.dst] = dsts.get(ev.dst, 0) + 1
    tracer = fleet.tracer
    tracer.close_open(reason="path done")
    jits = sorted(f"{sp.engine}:{sp.name[4:]} "
                  f"{sp.attrs['wall_s']:.3f}s"
                  for sp in tracer.spans if sp.kind == "jit")
    chrome = json.dumps(tracer.chrome_trace())
    log(f"fleet: audit log {len(tel.events)} events {kinds}, lifecycle "
        f"{dsts}; tracer {len(tracer.spans)} spans, {len(jits)} jit "
        f"(first runs, wall) {jits}; Chrome trace {len(chrome)} bytes")
    log(f"fleet: speculative pair draft (mini, 12 layers) -> verify: "
        f"{spec.summary()}; spec_accept launches {counts['spec_accept']} = "
        f"slots scored over {spec.rounds} verify rounds")
    med = sorted(step_walls)[len(step_walls) // 2]
    log(f"fleet: {len(step_walls)} fleet steps in {wall:.1f} s, median "
        f"{med * 1e3:.1f} ms; the profiled step: wall {profile_step[0]:.1f}"
        f" ms against its members' device busy {profile_step[1]:.1f} ms "
        f"({gpu_line()})")
    log(f"fleet: launches flash_attention={counts['flash_attention']}, "
        f"paged_decode_attention={counts['paged_decode_attention']}, "
        f"decode_attention={counts['decode_attention']}, spec_accept="
        f"{counts['spec_accept']}: as predicted from {calls.n} "
        f"(layers {calls.layers}), exactly")
    return counts


def run_replicate(cfg, params, lite, mini_cfg, mini):
    """The ``replicate`` path: ``ReplicationManager`` over three dense
    ``Engine(slots=2, max_len=1024)``s -- cloud (full), edge (lite),
    device (mini) -- as the JAX package's scenario 1: four steps each
    with a sync, the cloud cut and a failover, three steps on edge, a
    merge on reconnect.  Then the daemon's decisions and its roofline
    against a measured decode step."""
    from repro_torch.core.attestation import measure_config
    from repro_torch.core.daemon import CLOUD, PrivacyAwareDaemon
    from repro_torch.core.migration import _pack_workspace
    from repro_torch.core.replication import ReplicaTier, ReplicationManager
    from repro_torch.core.workspace import AgentWorkspace
    from repro_torch.models.init import param_bytes
    from repro_torch.serving.engine import Engine, Request

    mk = lambda c, p, s: Engine(c, p, slots=2, max_len=1024, seed=s,  # noqa
                                device="cuda")
    mgr = ReplicationManager([
        ReplicaTier("cloud", mk(cfg, params, 0), 1.0, 1.0),
        ReplicaTier("edge", mk(cfg, lite, 1), 0.8, 0.85),
        ReplicaTier("device", mk(mini_cfg, mini, 2), 0.5, 0.8)])
    calls = Calls()
    for name, tier in mgr.tiers.items():
        calls.watch(name, tier.engine)
    gid = measure_config(cfg)
    cloud = mgr.tiers["cloud"].engine
    req = Request("draft-post", np.random.default_rng(SEED + 23).integers(
        0, cfg.vocab_size, 200), max_new_tokens=24, sensitivity="personal")
    zero_counts()
    cloud.add_request(req)
    step_prof, ws = None, None
    for i in range(4):
        if i == 2:
            step_prof = profiled(cloud.step, "replicate decode step "
                                 "(dense, 1 of 2 slots live)", 1)
        else:
            cloud.step()
        t = time.perf_counter()
        ws = AgentWorkspace.from_engine(cloud, gid, node="cloud")
        sent = mgr.sync(ws)
        log(f"replicate: sync {i + 1}: wire bytes {sent}, delta fraction "
            f"{mgr.last_delta_fraction:.6f}, {time.perf_counter() - t:.3f} "
            "s (host)")
    before = list(req.output)
    mgr.tiers["cloud"].cond.up = False
    tier, latency = mgr.failover("disconnect")
    st = mgr.last_failover_stages
    log(f"replicate: failover to {tier.name} in {latency:.4f} s: unpack "
        f"{st['unpack']:.4f}, place {st['place']:.4f}, attach "
        f"{st['attach']:.4f} s (host seconds on the card's machine, "
        f"{gpu_line()}; the paper's budget is 0.2 s)")
    if tier.name != "edge" or tier.functionality != 0.85:
        raise AssertionError(f"replicate: failed over to {tier}")
    edge = tier.engine
    (cont,) = edge.requests.values()
    for _ in range(3):
        edge.step()
    if cont.output[:len(before)] != before or \
            len(cont.output) != len(before) + 3:
        raise AssertionError(f"replicate: {cont.output} after {before}")
    mine = AgentWorkspace.from_engine(edge, gid, node="edge")
    merged = mgr.merge_on_reconnect(mine, ws, local_tier="edge",
                                    remote_tier="cloud")
    (got,) = merged.requests
    if got["output"] != before or merged.vclock.clocks != \
            {"cloud": 1, "edge": 1}:
        raise AssertionError(f"replicate: merged {got['output']} "
                             f"{merged.vclock.clocks}")
    log(f"replicate: edge kept the {len(before)} synced tokens and decoded "
        f"3 more on the lite weights; merge on reconnect kept cloud's "
        f"{len(got['output'])} (higher quality), clocks "
        f"{merged.vclock.clocks}")
    counts = read_counts()
    pred = calls.predict()
    if counts != {**counts, **pred}:
        raise AssertionError(f"replicate: launches {counts} != {pred}")
    log(f"replicate: launches flash_attention={counts['flash_attention']}, "
        f"decode_attention={counts['decode_attention']} as predicted from "
        f"{calls.n}, exactly")

    daemon = PrivacyAwareDaemon()
    nbytes = len(_pack_workspace(ws))
    work = dict(cfg=cfg, prefill_tokens=1024, decode_tokens=1024,
                workspace_bytes=nbytes)
    for sens in ("public", "personal", "confidential"):
        d = daemon.decide(sensitivity=sens, **work)
        log(f"daemon: llama-1.5b {sens}, prefill 1024 + decode 1024 tokens, "
            f"workspace {nbytes} bytes: {d.target} ({d.reason}; local "
            f"{d.est_local_s:.4f} s, remote {d.est_remote_s:.4f} s)")
    t_pred = PrivacyAwareDaemon.step_time(cfg, CLOUD, decode_tokens=1)
    log(f"daemon: step_time predicts {t_pred * 1e3:.4f} ms a decode token "
        f"on CLOUD ({param_bytes(cfg)} weight bytes / {CLOUD.hbm_bw:.3g} "
        f"B/s, H100 SXM data sheet); measured on this path: a decode step "
        f"wall {step_prof[0]:.3f} ms, device busy {step_prof[1]:.3f} ms "
        f"({gpu_line()})")
    return counts



# ---------------------------------------------------------------------------
# phase 6: rwkv6-7b on the dense Engine at full width
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# service mode, the autoscaler and the CLIs
# ---------------------------------------------------------------------------

class Programs:
    """The engines' own program counts on a path.  Every prefill and
    decode forward of the port's engines goes through
    ``engine._profiled(key, fn)``; while the context is open this counts
    them by engine and kind, under a lock (service threads run them):
    a cold prefill launches flash_attention once a layer, a decode step
    paged or dense decode once a layer.  A program of another kind
    (a suffix prefill, a verify window) is not on these paths and
    fails the count."""

    def __init__(self):
        import threading
        self.lock = threading.Lock()
        self.n: dict[tuple[str, str], int] = {}
        self.layers: dict[str, tuple[int, bool]] = {}
        self.names: dict[int, str] = {}
        self._keep, self._saved = [], []

    def name(self, eng, label: str):
        with self.lock:
            self.names[id(eng)] = label
            self._keep.append(eng)

    def _label(self, eng) -> str:
        key = id(eng)
        if key not in self.names:
            self.names[key] = f"{type(eng).__name__}#{len(self.names)}"
            self._keep.append(eng)
        label = self.names[key]
        self.layers[label] = (eng.cfg.num_layers, eng.paged)
        return label

    def __enter__(self):
        from repro_torch.serving.engine import Engine
        from repro_torch.serving.paged import PagedEngine
        for cls in (Engine, PagedEngine):
            orig = cls.__dict__["_profiled"]

            def counted(eng, key, fn, _orig=orig):
                out = _orig(eng, key, fn)
                kind = "prefill" if key.startswith("prefill[") else key
                if kind not in ("prefill", "decode"):
                    raise AssertionError(f"program {key!r} is not on this "
                                         "path")
                with self.lock:
                    k = (self._label(eng), kind)
                    self.n[k] = self.n.get(k, 0) + 1
                return out
            self._saved.append((cls, orig))
            cls._profiled = counted
        return self

    def __exit__(self, *exc):
        for cls, orig in self._saved:
            cls._profiled = orig

    def predict(self) -> dict:
        pred = dict.fromkeys(wrappers(), 0)
        for label, (layers, paged) in self.layers.items():
            pred["flash_attention"] += layers * self.n.get((label, "prefill"),
                                                           0)
            pred["paged_decode_attention" if paged else "decode_attention"] \
                += layers * self.n.get((label, "decode"), 0)
        return pred

    def check(self, path: str, counts: dict):
        pred = self.predict()
        if counts != pred:
            raise AssertionError(f"{path}: launches {counts} != predicted "
                                 f"{pred} from {self.n}")
        per = {lab: (self.n.get((lab, "prefill"), 0),
                     self.n.get((lab, "decode"), 0))
               for lab in sorted(self.layers)}
        log(f"{path}: launches flash_attention={counts['flash_attention']}, "
            f"paged_decode_attention={counts['paged_decode_attention']}, "
            f"decode_attention={counts['decode_attention']}: as predicted "
            f"from the engines' programs (engine: cold prefills, decode "
            f"steps) {per}, exactly")


def _service_traffic(cfg):
    """Twelve requests: the paged path's prompt lengths twice, 32 new
    tokens, greedy and ``temperature=0.7, top_k=16`` alternating, the
    three sensitivities in turn."""
    from repro_torch.fleet import RequestSpec
    rng = np.random.default_rng(SEED + 23)
    sens = ("public", "personal", "confidential")
    return [RequestSpec(rid=f"s{i}",
                        prompt=rng.integers(0, cfg.vocab_size, n),
                        max_new_tokens=32,
                        temperature=0.7 if i % 2 else 0.0,
                        top_k=16 if i % 2 else 0, sensitivity=sens[i % 3])
            for i, n in enumerate((37, 200, 511, 512, 1024, 1536) * 2)]


SERVICE_GEO = dict(page_size=16, rows=4, max_len=2048, pages=160,
                   device="cuda")
_SOLO: dict[bytes, list[int]] = {}
_SOLO_S: list = []                 # host seconds of each solo reference


def solo_tokens(cfg, params, spec, eng=None) -> list[int]:
    """The greedy request served alone on an engine of the paged
    geometry (a fresh one unless ``eng`` is given), remembered by
    prompt."""
    from repro_torch.serving.engine import Request
    from repro_torch.serving.paged import PagedEngine
    key = np.asarray(spec.prompt).tobytes()
    if key not in _SOLO:
        t = time.perf_counter()
        eng = eng or PagedEngine(cfg, params, seed=9, **SERVICE_GEO)
        req = Request(spec.rid, spec.prompt, max_new_tokens=32)
        _serve(eng, [req])
        _SOLO[key] = list(req.output)
        _SOLO_S.append(time.perf_counter() - t)
    return _SOLO[key]


def _terminal_once(fleet, rid) -> bool:
    from repro_torch.fleet import TERMINAL_STATES
    ends = {s.value for s in TERMINAL_STATES}
    return [ev.dst for ev in fleet.telemetry.events_of(rid)
            if ev.dst in ends] == ["done"]


def _check_served(label, cfg, params, fleet, specs, solo_eng=None):
    """Every ticket DONE exactly once with 32 in-vocabulary tokens; every
    greedy one equal to the same request served alone."""
    from repro_torch.fleet import RequestState
    for spec in specs:
        t = fleet.tickets[spec.rid]
        out = list(t.output)
        if t.state is not RequestState.DONE or len(out) != 32 \
                or not all(0 <= x < cfg.vocab_size for x in out) \
                or not _terminal_once(fleet, spec.rid):
            raise AssertionError(f"{label}: {spec.rid} {t.state.value} "
                                 f"{out}")
        if spec.temperature == 0.0:
            want = solo_tokens(cfg, params, spec, solo_eng)
            if out != want:
                raise AssertionError(
                    f"{label}: {spec.rid} via {fleet.placements[spec.rid]}"
                    f" gave {out} != alone {want}")


class GpuUtil:
    """The card's busy share while the context is open, from
    ``nvidia-smi``'s ``utilization.gpu`` sampled every 100 ms (the share
    of each sample period in which a kernel ran): it sees every thread's
    kernels and, unlike the profiler, costs the process nothing, so a
    service fleet's heartbeats are not held up when it stops."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=10)
        vals = [float(v) for v in out.split() if v.replace(".", "").isdigit()]
        # the first sample can predate the window
        self.samples = vals[1:] or vals
        self.busy = (sum(self.samples) / len(self.samples) / 100
                     if self.samples else None)

    def line(self) -> str:
        if self.busy is None:
            return "device busy not measured"
        return (f"device busy {100 * self.busy:.1f}% ({100 - 100 * self.busy:.1f}"
                f"% idle; nvidia-smi utilization.gpu, {len(self.samples)} "
                f"samples of 100 ms)")


def _wait_until(pred, timeout_s, what, *, report=None, every_s=30.0):
    t0 = time.perf_counter()
    next_report = t0 + every_s
    while time.perf_counter() - t0 < timeout_s:
        if pred():
            return
        if report is not None and time.perf_counter() > next_report:
            log(f"waiting for {what}, {time.perf_counter() - t0:.0f} s: "
                f"{report()}")
            next_report += every_s
        time.sleep(0.005)
    raise AssertionError(f"timed out after {timeout_s} s waiting for {what}"
                         + (f": {report()}" if report is not None else ""))


def late(cp) -> str:
    """A control plane's acks that landed after their RPC expired."""
    return (f"late acks adopted {cp.late_adopted}, duplicate copies "
            f"cancelled {cp.duplicates} ({cp.wasted_tokens} tokens "
            f"wasted)")


def service_state(cp) -> str:
    """What a service-mode fleet is doing: tickets, queue, RPCs in
    flight, each service's loop, mailbox and rows, the bus counters."""
    fleet = cp.fleet
    with fleet._lock:
        tickets = {r: (t.state.value, len(t.output),
                       fleet.placements.get(r, []))
                   for r, t in sorted(fleet.tickets.items())
                   if not t.done}
        queue = [(it.rid, "parked" if it.parked else "fresh")
                 for it in fleet.queue.ordered()]
        rpcs = [(i, r.msg.type, r.msg.rid, r.msg.dst, r.tries)
                for i, r in cp._rpc.items()]
        disp = {r: d.target for r, d in cp._dispatching.items()}
    svcs = {}
    for n, svc in cp.services.items():
        eng = svc.engine
        svcs[n] = dict(alive=svc.alive(), error=repr(svc.error),
                       mailbox=len(svc.mailbox),
                       healthy=fleet.handles[n].healthy,
                       rows=sorted(r.rid for r in eng.requests.values()),
                       free_pages=getattr(getattr(eng, "allocator", None),
                                          "free_pages", None),
                       last_beat=cp.detector.last_beat(n))
    return (f"open tickets {tickets}; queue {queue}; dispatching {disp}; "
            f"rpcs {rpcs}; services {svcs}; ctl mailbox "
            f"{len(cp.mailbox)}; bus sent {cp.bus.sent}, failures "
            f"{cp.bus.send_failures}, refused {cp.bus.refused}, retried "
            f"{cp.retried}; clock {cp.fleet.clock():.2f}")


def run_service(cfg, params):
    """The ``service`` path: the port's ``ControlPlane`` over
    ``SocketTransport`` with a thread per engine: three ``PagedEngine``s
    a, b, c of the paged geometry (one program set), six requests (two
    an engine), b's service killed once it holds a slot whose shadow
    arrived.  Then
    the same requests without faults through a one-engine sync fleet and
    the three-engine socket fleet: the concurrency ratio."""
    from repro_torch.core.attestation import TrustAuthority
    from repro_torch.core.channel import SocketTransport
    from repro_torch.core.daemon import CLOUD
    from repro_torch.fleet import (ControlPlane, EngineHandle, EngineService,
                                   FleetController, Rebalancer)
    from repro_torch.serving.paged import PagedEngine

    # the first six requests (every prompt length once, greedy and
    # sampled, the three sensitivities): twelve until the examples path
    # took chip_smoke past 1100 s of its 1200 on a slow host, where the
    # fault run's shadow traffic (a 236 MB frame a shadow) took 105 s
    specs = _service_traffic(cfg)[:6]
    progs = Programs()

    def fleet_of(tag, names):
        handles = []
        for i, n in enumerate(names):
            eng = PagedEngine(cfg, params, seed=i, **SERVICE_GEO)
            progs.name(eng, f"{tag}:{n}")
            handles.append(EngineHandle(n, eng, CLOUD))
        return FleetController(handles, authority=TrustAuthority(),
                               balancer=Rebalancer(sync_every=8))

    def tickets_conserved(fleet):
        with fleet._lock:
            queued = {it.rid for it in fleet.queue.ordered()}
            for rid, t in fleet.tickets.items():
                places = ((rid in queued) + (rid in fleet.inflight)
                          + t.done)
                if places != 1:
                    raise AssertionError(f"service: {rid} in {places} "
                                         f"places ({t.state.value})")

    zero_counts()
    torch.cuda.synchronize()
    with progs:
        # 1. faults: b's service dies mid-flight
        # host seconds of each inject RPC's handler on its service thread
        # (peek, unpack_slot, repack_slot, inject_slot, synchronised)
        inject_s = []
        handler = EngineService._on_inject

        def timed_inject(svc, msg):
            t = time.perf_counter()
            out = handler(svc, msg)
            torch.cuda.synchronize()
            inject_s.append((msg.rid, svc.name,
                             round(time.perf_counter() - t, 4)))
            return out
        EngineService._on_inject = timed_inject
        fleet = fleet_of("faults", "abc")
        tp = SocketTransport()
        # the default timers: an RPC waits 0.5 s a try, 5 tries, and a
        # service can be busy longer at full width (a 100 MB inject, a
        # shadow pack), so an ack may land after its RPC expired
        cp = ControlPlane(fleet, transport=tp)
        t0 = time.perf_counter()
        cp.start(threads=True)
        try:
            for s in specs:
                if cp.submit(s) is None:
                    raise AssertionError(f"service: {s.rid} not admitted")

            def b_shadowed():
                with fleet._lock:
                    on_b = {r for r, (_, h, _) in fleet.inflight.items()
                            if h == "b"}
                    return on_b & set(fleet.balancer.shadow.get("b", {}))
            _wait_until(b_shadowed, 240, "b to hold a shadowed slot",
                        report=lambda: service_state(cp))
            with fleet._lock:
                on_b = sorted(r for r, (_, h, _) in fleet.inflight.items()
                              if h == "b")
                shadowed = sorted(fleet.balancer.shadow.get("b", {}))
            t_kill = time.perf_counter() - t0
            cp.kill_service("b")

            log(f"service: b's service killed {time.perf_counter() - t0:.2f}"
                f" s in, holding {on_b}")

            def finished():
                if not cp.thread.is_alive():
                    raise AssertionError("service: the control thread died")
                tickets_conserved(fleet)
                return all(t.done for t in fleet.tickets.values())
            _wait_until(finished, 300, "every ticket to end",
                        report=lambda: service_state(cp))
        finally:
            cp.stop()
            EngineService._on_inject = handler
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        tel = fleet.telemetry
        lost = [ev.engine for ev in tel.heartbeat_events()]
        if lost != ["b"]:
            raise AssertionError(f"service: heartbeat losses {lost}")
        _check_served("service", cfg, params, fleet, specs)
        conserved(fleet)
        moved = {r: fleet.placements[r] for r in on_b}
        fails = [m for m in tel.migrations if m.reason == "failover"]
        log(f"service: b killed {t_kill:.2f} s in, holding {on_b} "
            f"(shadows of {shadowed}); HeartbeatLoss for b only; "
            f"placements of b's requests {moved}; {len(fails)} exact "
            f"re-placements from shadows ({[m.rid for m in fails]}, "
            f"{[m.wire_bytes for m in fails]} bytes); every ticket done "
            f"once, conserved; the greedy ones equal the same requests "
            f"served alone on a fresh PagedEngine, bit for bit; {wall:.1f}"
            f" s ({gpu_line()})")
        bus = cp.bus
        big = {k: v for k, v in bus.largest.items()
               if k in ("shadow", "inject", "ack", "place")}
        log(f"service: frames sent {bus.sent}, send failures "
            f"{bus.send_failures}, dropped {tp.dropped}, refused "
            f"{bus.refused} at the sender and {tp.refused_in} by a reader "
            f"({tp.refusals[:2]}); largest frames by type {big} bytes "
            f"against MAX_FRAME {tp.MAX_FRAME}; RPC retries {cp.retried}, "
            f"{late(cp)}; inject host seconds {inject_s}")
        if bus.refused or tp.refused_in:
            raise AssertionError("service: a frame was refused at full "
                                 "width")

        # 2. the concurrency ratio: one engine in the sync fleet against
        # three services over the socket transport, no faults
        one = fleet_of("sync", "a")
        t = time.perf_counter()
        with GpuUtil() as u1:
            ts = [one.submit(s) for s in specs]
            while not all(tk.done for tk in ts):
                one.step()
            torch.cuda.synchronize()
        w1 = time.perf_counter() - t
        three = fleet_of("socket", "abc")
        cp3 = ControlPlane(three, transport=SocketTransport())
        cp3.start(threads=True)
        try:
            t = time.perf_counter()
            with GpuUtil() as u3:
                out3 = cp3.serve(specs, timeout_s=300.0)
                torch.cuda.synchronize()
            w3 = time.perf_counter() - t
            if len(out3) != len(specs):
                raise AssertionError(f"service: the socket fleet served "
                                     f"{sorted(out3)}: {service_state(cp3)}")
        finally:
            cp3.stop()
        for fl, label in ((one, "sync a"), (three, "socket a, b, c")):
            _check_served(f"service ({label})", cfg, params, fl, specs)
        toks = 32 * len(specs)
        log(f"service: concurrency: one engine (sync FleetController) "
            f"{toks} tokens in {w1:.2f} s = {toks / w1:.1f} tok/s, "
            f"{u1.line()}; three engines (socket ControlPlane, a "
            f"thread each) {toks / w3:.1f} tok/s in {w3:.2f} s, "
            f"{u3.line()}; ratio {w1 / w3:.3f} (RPC retries "
            f"{cp3.retried}, {late(cp3)}, heartbeat losses "
            f"{three.telemetry.heartbeat_losses}) ({gpu_line()})")
    counts = read_counts()
    progs.check("service", counts)
    log(f"service: {len(_SOLO_S)} solo references in {sum(_SOLO_S):.1f} s")
    return counts


def run_autoscale(cfg, params):
    """The ``autoscale`` path: a sync ``FleetController`` over one seed
    ``PagedEngine`` of the paged geometry with an ``Autoscaler``
    (template of the same geometry on ``CLOUD``, pool 1-3, spawn at a
    queue depth of 3, one warm standby, no cooldown); an idle step
    pre-arms the standby, the twelve requests arrive at once, and once
    the queue is empty the spawned engines retire, draining their live
    slots.  Every scale-up there promotes a standby (the pool refills in
    the step of each promotion), so a second fleet over the same seed
    engine, with no standby pool (pool 1-2), takes six of the requests
    (the second to the seventh) as a burst: its scale-up constructs an engine inline, which must
    serve the seed's programs from the program cache."""
    from repro_torch.core.attestation import TrustAuthority
    from repro_torch.core.daemon import CLOUD
    from repro_torch.fleet import (Autoscaler, EngineHandle, EngineTemplate,
                                   FleetController, Rebalancer, ScalePolicy)
    from repro_torch.serving.paged import PagedEngine

    specs = _service_traffic(cfg)
    progs = Programs()
    template = EngineTemplate(name="auto", profile=CLOUD,
                              slots=SERVICE_GEO["rows"],
                              max_len=SERVICE_GEO["max_len"],
                              page_size=SERVICE_GEO["page_size"],
                              pages=SERVICE_GEO["pages"])
    zero_counts()
    torch.cuda.synchronize()
    with progs:
        seed = PagedEngine(cfg, params, seed=0, **SERVICE_GEO)
        progs.name(seed, "seed")
        auto = Autoscaler(
            template,
            ScalePolicy(min_engines=1, max_engines=3,
                        scale_up_queue_depth=3, standby_pool=1,
                        cooldown_s=0))
        fleet = FleetController([EngineHandle("seed", seed, CLOUD)],
                                authority=TrustAuthority(),
                                balancer=Rebalancer(sync_every=8),
                                autoscaler=auto)
        t0 = time.perf_counter()
        fleet.step()                        # idle: pre-arms the standby
        torch.cuda.synchronize()
        if len(auto.standbys) != 1:
            raise AssertionError("autoscale: no standby after the idle "
                                 "step")
        sb = auto.standbys[0]
        for s in specs:
            fleet.submit(s)
        first_on_spawn, drained, drain_recs, steps = None, {}, [], 0
        dispatch = fleet._dispatch

        def dispatch_then_drain():
            # the queue empties in a dispatch pass: scale down right
            # there, while the spawned engines still hold live slots
            nonlocal drain_recs
            dispatch()
            if fleet.queue.depth() or drained or not any(
                    fleet.handles[n].engine.requests for n in auto.spawned):
                return
            for name in auto.spawned:
                drained[name] = sorted(r.rid for r in
                                       fleet.handles[name].engine
                                       .requests.values())
            n0 = len(fleet.telemetry.migrations)
            while auto.spawned:
                auto.scale_down(fleet, reason="queue empty")
                conserved(fleet)
            drain_recs = fleet.telemetry.migrations[n0:]
        fleet._dispatch = dispatch_then_drain
        while not all(t.done for t in fleet.tickets.values()):
            fleet.step()
            torch.cuda.synchronize()
            steps += 1
            conserved(fleet)
            for rid, hist in fleet.placements.items():
                if first_on_spawn is None and hist[0].startswith("auto") \
                        and fleet.tickets[rid].spec.temperature == 0.0:
                    first_on_spawn = (rid, hist[0])
            if steps > 2000:
                raise AssertionError("autoscale: tickets never ended")
        for _ in range(4):                  # parked drains re-place
            fleet.step()
        wall = time.perf_counter() - t0
        _check_served("autoscale", cfg, params, fleet, specs, solo_eng=seed)
        conserved(fleet)
        tel = fleet.telemetry
        evs = tel.scale_events()
        spawns = [e for e in evs if e.action == "spawn"]
        if auto.promotions < 1 or len(spawns) < 2 \
                or not any(drained.values()):
            raise AssertionError(f"autoscale: promotions "
                                 f"{auto.promotions}, spawns {spawns}, "
                                 f"drained {drained}")
        if first_on_spawn is None:
            raise AssertionError("autoscale: no greedy request ran on a "
                                 "spawned engine")
        spans = [sp for sp in fleet.tracer.spans if sp.name == "spawn"]
        if len(spans) != len(spawns) or not all(
                sp.attrs.get("cache_hit") for sp in spans):
            raise AssertionError(f"autoscale: spawn spans "
                                 f"{[sp.attrs for sp in spans]}")
        drain_moves = [m for m in tel.migrations if m.reason == "drain"]
        for rids in drained.values():
            for rid in rids:
                if not any(m.rid == rid for m in drain_moves):
                    raise AssertionError(f"autoscale: {rid} drained "
                                         "without a drain move")
        log(f"autoscale: scale events on the audit log "
            f"{[(e.action, e.engine, e.engines, e.reason) for e in evs]}")
        log(f"autoscale: standby {sb.name} built in {sb.build_s:.4f} s "
            f"(cache hit {sb.cache_hit}); spawn spans "
            + "; ".join(f"{sp.trace_id[7:]}: construct_s "
                        f"{sp.attrs.get('construct_s')}, promoted "
                        f"{sp.attrs.get('promoted', False)}, "
                        f"time_to_useful_s "
                        f"{sp.attrs.get('time_to_useful_s')}, cache_hit "
                        f"{sp.attrs.get('cache_hit')}" for sp in spans)
            + f" (promotion = construct_s of a promoted spawn, "
              f"{1e3 * min(sp.attrs['construct_s'] for sp in spans if sp.attrs.get('promoted')):.3f}"
              f" ms) ({gpu_line()})")
        log(f"autoscale: the first greedy request on a spawned engine "
            f"({first_on_spawn[0]} on {first_on_spawn[1]}) and every "
            f"greedy request equal the same request alone on an engine of"
            f" the seed's geometry, bit for bit; drained {drained}: moves "
            f"{[(m.rid, m.src, m.dst, m.wire_bytes) for m in drain_moves]}"
            f" (rid, from, to, bytes) in the retire step "
            f"{[(m.rid, m.wire_bytes) for m in drain_recs]}; conserved "
            f"every step; {steps} steps, {wall:.1f} s")
        construct_spawn(cfg, params, seed, template)
    counts = read_counts()
    progs.check("autoscale", counts)
    return counts


def construct_spawn(cfg, params, seed, template):
    """The autoscale path's second fleet: ``seed`` alone, an
    ``Autoscaler`` with no standby pool (pool 1-2, spawn at a queue depth
    of 3, no cooldown), six requests as a burst.  The scale-up builds an
    engine inline; it must serve the seed's programs from the program
    cache, the greedy requests bit for bit, and retire once idle."""
    from repro_torch.core.attestation import TrustAuthority
    from repro_torch.core.daemon import CLOUD
    from repro_torch.fleet import (Autoscaler, EngineHandle, FleetController,
                                   Rebalancer, ScalePolicy)
    burst = _service_traffic(cfg)[1:7]    # the spawn takes every other
    auto = Autoscaler(template, ScalePolicy(
        min_engines=1, max_engines=2, scale_up_queue_depth=3,
        standby_pool=0, cooldown_s=0))
    fleet = FleetController([EngineHandle("seed", seed, CLOUD)],
                            authority=TrustAuthority(),
                            balancer=Rebalancer(sync_every=8),
                            autoscaler=auto)
    t0 = time.perf_counter()
    for s in burst:
        fleet.submit(s)
    steps, on_spawn = 0, []
    while not all(t.done for t in fleet.tickets.values()):
        fleet.step()
        torch.cuda.synchronize()
        steps += 1
        conserved(fleet)
        if steps > 2000:
            raise AssertionError("autoscale (construct): tickets never "
                                 "ended")
    wall = time.perf_counter() - t0
    for rid, hist in fleet.placements.items():
        if hist[0].startswith("auto") \
                and fleet.tickets[rid].spec.temperature == 0.0:
            on_spawn.append((rid, hist[0]))
    for _ in range(4):                      # idle: the spawn retires
        fleet.step()
    _check_served("autoscale (construct)", cfg, params, fleet, burst,
                  solo_eng=seed)
    conserved(fleet)
    evs = fleet.telemetry.scale_events()
    spans = [sp for sp in fleet.tracer.spans if sp.name == "spawn"]
    if auto.promotions or len(spans) != 1 or spans[0].attrs.get("promoted") \
            or not spans[0].attrs.get("cache_hit") or not on_spawn \
            or auto.spawned or [e.action for e in evs] != ["spawn",
                                                           "retire"]:
        raise AssertionError(f"autoscale (construct): placements "
                             f"{fleet.placements}, promotions "
                             f"{auto.promotions}, spans "
                             f"{[sp.attrs for sp in spans]}, greedy on the "
                             f"spawn {on_spawn}, events "
                             f"{[(e.action, e.engine) for e in evs]}")
    attrs = spans[0].attrs
    log(f"autoscale: a spawn by construction (no standby pool): "
        f"{evs[0].engine} built inline in construct_s {attrs['construct_s']} "
        f"s, cache_hit {attrs['cache_hit']}, time_to_useful_s "
        f"{attrs.get('time_to_useful_s')}; scale events "
        f"{[(e.action, e.engine, e.reason) for e in evs]}; greedy "
        f"{on_spawn} on it and every greedy request of the burst equal "
        f"the same request alone, bit for bit; conserved every step; "
        f"{steps} steps, {wall:.1f} s ({gpu_line()})")


def run_cli():
    """The ``cli`` path: both CLIs in-process through ``main([...])`` at
    full width on the card (their own weights, seed 0)."""
    import contextlib
    import io

    from repro_torch.launch import fleet as fleet_cli
    from repro_torch.launch import serve as serve_cli
    progs = Programs()
    zero_counts()
    torch.cuda.synchronize()
    # each summary line must count every request's tokens
    runs = [("serve", serve_cli, ["--requests", "4", "--slots", "4",
                                  "--max-len", "2048", "--max-new", "16"],
             "64 tokens in "),
            ("fleet", fleet_cli, ["--requests", "6", "--engines",
                                  "a:cloud:2048,b:cloud:2048,c:edge:2048",
                                  "--transport", "socket", "--max-new",
                                  "8"], "service mode: 6 requests, 48 "
                                        "tokens in ")]
    with progs:
        for name, cli, argv, want in runs:
            buf = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                code = cli.main(argv)
            wall = time.perf_counter() - t
            out = buf.getvalue().splitlines()
            summary = [ln for ln in out if want in ln]
            if code != 0 or not summary:
                raise AssertionError(f"cli {name}: exit {code}, last lines "
                                     f"{out[-5:]}")
            lines = [ln for ln in out if ln.startswith("r")]
            log(f"cli: {name} {' '.join(argv)}: exit {code} in {wall:.1f} "
                f"s; {len(lines)} request lines, e.g. {lines[0][:100]!r}; "
                f"{summary[-1]} ({gpu_line()})")
    counts = read_counts()
    progs.check("cli", counts)
    return counts


def _state_rows(eng, slots, kind):
    """Copies of rows ``slots`` of every ``kind`` ("rwkv" or "mamba")
    recurrent leaf, layer by layer."""
    return [{k: a[:, slots].clone() for k, a in layer[kind].items()}
            for grp in eng.state.caches for layer in grp if kind in layer]


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


# the roofline path: llama-1.5b's three shape cells at their own sequence
# lengths, each global batch cut to one card: (cell, rows, microbatches)
ROOFLINE_CELLS = (("train_4k", 8, 4), ("prefill_32k", 4, 1),
                  ("decode_32k", 16, 1))
ROOFLINE_RUNS = 3         # timed runs a cell, after one warm-up run
ROOFLINE_BAND = 512       # a 32768-token prefill's query rows held to plain


def fill_context(caches, S: int, gen):
    """Every row's dense cache holding tokens 0 .. S-2 (random K and V,
    the slots' positions), so that a decode step at position S-1 attends
    all S slots."""
    for group in caches:
        for layer in group:
            c = layer["attn"]
            c["k"].normal_(generator=gen)
            c["v"].normal_(generator=gen)
            c["abs_pos"].copy_(torch.arange(S, dtype=torch.int32,
                                            device="cuda").expand_as(
                                                c["abs_pos"]))
            c["abs_pos"][..., S - 1] = -1


def roofline_cell(cfg, params, cell, rows, micro, gen) -> dict:
    """One cell of the roofline path: the dry run's record at the cut
    shape (a meta-device analysis, no card), then ``steps.build(...,
    concrete=True)`` on the card with the llama weights already there:
    a warm-up run, ``ROOFLINE_RUNS`` timed runs (the peak of allocated
    memory over them, less what the card held besides the step's
    arguments), a profiled run and a run with every kernel call held to
    its plain version (``Shadowed``: a prefill's last ``ROOFLINE_BAND``
    query rows against every key; ``ShadowedTrain``).  Returns the
    cell's figures."""
    from repro_torch.configs import SHAPES, ShapeSpec
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.op_analysis import tree_bytes
    full = SHAPES[cell]
    shape = ShapeSpec(cell, full.seq_len, rows, full.kind)
    L, S, kind = cfg.num_layers, shape.seq_len, shape.kind
    t0 = time.perf_counter()
    rec = dryrun.run_cell(cfg.name, cell, cfg=cfg, shape=shape, ops_dir=None,
                          microbatches=micro, reckon=False)
    meta_s = time.perf_counter() - t0
    fn, args = steps.build(cfg, shape, concrete=True, microbatches=micro,
                           seed=SEED)
    args = (params, *args[1:])
    release()
    if kind == "decode":
        fill_context(args[2], S, gen)
        args[1]["positions"].fill_(S - 1)
        G = cfg.num_heads // cfg.num_kv_heads
        log(f"roofline {cell}: caches filled to {S - 1} tokens a row, the "
            f"step at position {S - 1}; decode_attention's split partials "
            f"{da._scratch_floats(rows, S, cfg.num_kv_heads, G, cfg.head_dim)}"
            f" floats at B {rows}, Sc {S}")

    def run():
        out = fn(*args)
        torch.cuda.synchronize()
        return out

    def check(out):
        val = out[2] if kind == "train" else out[0]
        want = () if kind == "train" else (rows, cfg.padded_vocab)
        if tuple(val.shape) != want or not bool(torch.isfinite(val).all()):
            raise AssertionError(f"roofline {cell}: output {tuple(val.shape)}"
                                 f" (need {want}) not finite or misshapen")

    out = run()
    check(out)
    out = None
    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated() - tree_bytes(args)
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(ROOFLINE_RUNS):
        out = None
        t = time.perf_counter()
        out = run()
        walls.append(time.perf_counter() - t)
        check(out)
    out = None
    peak = torch.cuda.max_memory_allocated() - other
    wall_p, busy = profiled(run, f"roofline {cell} step (B {rows}, S {S})", 1)
    if kind == "train":
        with ShadowedTrain() as shadow:
            check(run())
        need = (L * micro, 2 * L * micro, L * micro, 0)
        got = (shadow.bwd, shadow.flash, shadow.recomputed,
               len(shadow.pending))
        held = (f"{shadow.flash} flash calls at {shadow.worst:.3f} x their "
                f"limit, {shadow.recomputed} remat recomputes bit-equal, "
                f"{shadow.bwd} backward calls at {shadow.bwd_worst:.3f} x "
                f"theirs")
    else:
        with (Shadowed(rows=ROOFLINE_BAND, last=True) if kind == "prefill"
              else Shadowed()) as shadow:
            check(run())
        need, got = L, shadow.calls
        held = (f"{shadow.calls} {'flash' if kind == 'prefill' else 'decode'}"
                f" calls at {shadow.worst:.3f} x their limit"
                + (f" (the last {ROOFLINE_BAND} query rows against all "
                   f"{S} keys)" if kind == "prefill" else ""))
    if got != need:
        raise AssertionError(f"roofline {cell}: the shadowed run saw {got}, "
                             f"need {need}")
    del fn, args, out
    release()
    med = sorted(walls)[len(walls) // 2]
    mfu = rec["model_flops"] / PEAK_BF16_FLOPS / med
    figures = dict(
        cell=cell, rows=rows, of=full.global_batch, seq_len=S,
        microbatches=micro if kind == "train" else None,
        step_ms=med * 1e3, step_ms_runs=[w * 1e3 for w in walls],
        profiled_ms=wall_p, busy_ms=busy, peak_bytes=peak,
        dryrun_peak_bytes=rec["peak_memory_bytes"],
        peak_ratio=peak / rec["peak_memory_bytes"],
        compute_s=rec["compute_s"], memory_s=rec["memory_s"],
        dominant=rec["dominant"], bound_s=rec["bound_s"],
        model_flops=rec["model_flops"], model_bytes=rec["model_bytes"],
        roofline_fraction=rec["roofline_fraction"], mfu=mfu,
        bound_over_step=rec["bound_s"] / med,
        fits_one_card=rec["fits_one_card"], meta_s=meta_s)
    log(f"roofline {cell}: B {rows} of {full.global_batch}, S {S}"
        + (f", microbatches {micro}" if kind == "train" else "")
        + f": step median {med * 1e3:.1f} ms over {ROOFLINE_RUNS} runs "
        f"({', '.join(f'{w * 1e3:.1f}' for w in walls)}), profiled "
        f"{wall_p:.1f} ms wall, {busy:.1f} ms busy; peak allocated "
        f"{peak / 1e9:.3f} GB against the dry run's "
        f"{rec['peak_memory_bytes'] / 1e9:.3f} GB (ratio "
        f"{figures['peak_ratio']:.3f})")
    log(f"roofline {cell}: at this shape (meta-device analysis, H100 SXM "
        f"sheet; {meta_s:.1f} s of host) compute {rec['compute_s'] * 1e3:.2f}"
        f" ms, memory {rec['memory_s'] * 1e3:.2f} ms, {rec['dominant']}-"
        f"bound; model_flops {rec['model_flops']:.4e}, model_bytes "
        f"{rec['model_bytes']:.4e}; roofline_fraction "
        f"{rec['roofline_fraction']:.3f}; mfu {mfu:.4f} (model FLOPs at the "
        f"bf16 peak over the measured step); the bound over the measured "
        f"step {figures['bound_over_step']:.3f}; fits one card "
        f"{rec['fits_one_card']}")
    log(f"roofline {cell}: every kernel call held to its plain version: "
        f"{held} ({gpu_line()})")
    return figures


def run_roofline(cfg, params) -> tuple:
    """The dry-run tools' steps on the card: llama-1.5b at full width and
    depth through ``launch.steps.build(..., concrete=True)`` at its three
    cells' own sequence lengths, each global batch cut to one card
    (``ROOFLINE_CELLS``), beside the meta-device dry run of the same cut
    shape (``roofline_cell``).  Launches exactly, a run: 2 x 24 x 4 flash
    and 24 x 4 backward (train: a forward and its remat recompute a
    microbatch), 24 flash (prefill), 24 dense decode (decode)."""
    torch.cuda.synchronize()
    log(f"roofline: {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated "
        f"on the card at the start (the llama weights among it)")
    zero_counts()
    gen = torch.Generator("cuda").manual_seed(SEED + 7)
    cells = [roofline_cell(cfg, params, *c, gen) for c in ROOFLINE_CELLS]
    counts = read_counts()
    L, runs = cfg.num_layers, ROOFLINE_RUNS + 3
    micro = ROOFLINE_CELLS[0][2]
    want = {"flash_attention": runs * (2 * L * micro + L),
            "flash_attention_bwd": runs * L * micro,
            "decode_attention": runs * L}
    got = {k: n for k, n in counts.items() if n or k in want}
    if got != want:
        raise AssertionError(f"roofline launch counts {got}: need {want}")
    log(f"roofline: launches {want} ({runs} runs a cell), no other kernel, "
        f"exactly")
    log("roofline: " + json.dumps(cells))
    return counts, cells


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
    idle = _state_rows(eng, slice(1, 4), "rwkv")
    _serve(eng, [])
    for a, b in zip(idle, _state_rows(eng, slice(1, 4), "rwkv")):
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


# ---------------------------------------------------------------------------
# the families path: the six other attention-only configs at full width
# ---------------------------------------------------------------------------

# (config, longest prompt): the longest passes the local window where
# there is one; gemma3-4b first, with its slot hops
FAMILIES = (("gemma3-4b", 1536), ("gemma2-27b", 4608),
            ("stablelm-12b", 1536), ("deepseek-7b", 1536),
            ("granite-moe-1b-a400m", 1536), ("deepseek-moe-16b", 1536))


def family_config(name, share=2):
    """(``name`` at full width with each block group's repeats divided
    by ``share``, rounded up, or with ``share=None`` one repeat of each
    group; the full config): the depth cut of the ``families`` (one
    repeat: 17 layers of the six families' 242, half depth until the
    examples path took chip_smoke past 1100 s of its 1200 on a slow
    host) and ``jamba`` (half) paths, which keeps every layer kind,
    window and block group.  It cuts the host time of each step
    (chip_smoke's time limit) and, for jamba, the weights: 103.1 GB of
    bf16 at full depth does not fit the card's 80 GB."""
    from repro_torch.configs import get
    from repro_torch.configs.base import BlockDef
    full = get(name)
    return full.replace(blocks=tuple(
        BlockDef(b.layers, repeats=1 if share is None
                 else -(-b.repeats // share))
        for b in full.blocks)), full


# the ops that reach flash, by name: the causal flag of each
FLASH_OPS = {"attention_causal": True, "attention_windowed": True,
             "attention_full": False}


class AttentionPatch:
    """Within the block, ``ops.paged_decode_attention`` and
    ``ops.decode_attention`` (what every decode layer calls) and the
    three ops that reach flash (every prefill and train layer) go
    through ``self.call(name, orig, *args, **kw)``; restored on exit."""

    NAMES = ("paged_decode_attention", "decode_attention", *FLASH_OPS)

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops = ops
        self.orig = {n: getattr(ops, n) for n in self.NAMES}
        for n, fn in self.orig.items():
            setattr(ops, n, lambda *a, n=n, fn=fn, **kw: self.call(
                n, fn, *a, **kw))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.ops, n, fn)


class Shadowed(AttentionPatch):
    """Every attention call (the kernels on the card) is also run
    through its plain version on the same inputs: every layer of a
    full-depth model checked on its own inputs, so the chaos a deep
    random model makes of one-ulp differences neither hides nor fakes a
    fault.  Each output element is held to 4 bf16 ulps (4 x 2^-7,
    relative) of sum_i p_i |v_i|, the plain version run on |V|: the
    magnitude of the terms it sums.  Its own value is no yardstick here:
    where the probabilities spread over V rows of both signs the sum
    cancels, and the kernel's p, rounded against its run's max, and the
    plain version's, rounded after normalising (each as its reference
    rounds it), differ by an ulp of the terms, not of the sum
    (deepseek-7b's paged probe on an H100 80GB HBM3: 6.25 x ``row_tol``).
    A dead row must be exactly 0.  A flash call (prefill, train, an
    encoder, cross-attention) is held by the same rule; with ``rows``,
    only its first ``rows`` query rows are (whisper-base's 32768-frame
    encoder: plain scores over all rows would take 34 GB a layer), or
    with ``last`` its last ``rows`` (llama-1.5b's 32768-token prefill:
    the band that attends every key tile), each against the plain version
    over every key it attends.  ``calls``, ``worst`` (error over limit)
    and ``flash`` (the flash calls among them) are kept."""

    calls, worst, flash = 0, 0.0, 0

    def __init__(self, rows=None, last=False):
        self.rows, self.last = rows, last

    def call(self, name, orig, q, k, v, *args, **kw):
        from repro_torch.kernels import decode_attention as da
        from repro_torch.kernels.ref import reference_attention
        whole = out = orig(q, k, v, *args, **kw)
        if name in FLASH_OPS:
            self.flash += 1
            causal = FLASH_OPS[name]
            r = min(q.shape[1], self.rows or q.shape[1])
            off = q.shape[1] - r if self.last else 0
            q, out = q[:, off:off + r], out[:, off:off + r]
            if causal and not self.last:
                k, v = k[:, :r], v[:, :r]

            def plain(q, k, v, **kw):
                return reference_attention(q, k, v, causal=causal,
                                           q_offset=off, **kw)
        elif name == "decode_attention":
            plain = da.plain
        else:
            def plain(q, k, v, pt, pos, page_size, **kw):
                return da.paged_plain(q, k, v, pt, pos, **kw)
        with torch.no_grad():    # a train step's inputs require grad
            ref = plain(q, k, v, *args, **kw).float()
            terms = plain(q, k, v.abs(), *args, **kw).float()
            frac = float(((out.float() - ref).abs()
                          / (4 * 2.0 ** -7 * terms).clamp(min=1e-30)).max())
        self.calls += 1
        self.worst = max(self.worst, frac)
        if not torch.isfinite(out).all() or frac > 1.0:
            raise AssertionError(f"{name} in the model: {frac:.2f} x its "
                                 "limit against the plain version")
        return whole


class RouteReplay:
    """The MoE router's decisions of the first forward (kernels),
    replayed in every later one (plain versions), so that a one-ulp
    difference in an attention output cannot flip a top-k choice between
    the runs: routing is a step function of its input, and a flipped
    expert moves a random model's logits by O(1).  Wraps ``fn``."""

    def __init__(self, fn):
        from repro_torch.models import moe
        self.moe, self.fn, self.rec, self.at = moe, fn, None, 0

    def _route(self, p, x, spec):
        if self.recording:
            out = self.orig(p, x, spec)
            self.rec.append(out)
            return out
        out = self.rec[self.at]
        self.at += 1
        return out

    def __call__(self):
        self.recording = self.rec is None
        if self.recording:
            self.rec = []
        self.at = 0
        self.orig = self.moe._router
        self.moe._router = self._route
        try:
            return self.fn()
        finally:
            self.moe._router = self.orig


class Nudged(AttentionPatch):
    """Within the block (plain versions on: ``ops.set_backend("ref")``),
    every attention output is moved by one bf16 ulp, up or down by
    a seeded coin: the model's own sensitivity to the rounding the
    kernels and the plain versions differ by."""

    def __init__(self, seed=SEED):
        self.gen = torch.Generator("cuda").manual_seed(seed)

    def call(self, name, orig, *args, **kw):
        out = orig(*args, **kw)
        up = torch.rand(out.shape, generator=self.gen,
                        device=out.device) < 0.5
        inf = torch.full_like(out, float("inf"))
        return torch.nextafter(out, torch.where(up, inf, -inf))


def compare_deep(label: str, fn, what="one decode step's logits"):
    """``compare_logits`` for the families' deep random models: the
    kernels' logits against the plain versions', within the larger of
    ``LOGIT_REL_TOL`` x max |logit| and twice what one bf16 ulp on every
    attention output moves the plain run's logits (``Nudged``).
    Thirty to forty-six layers of random weights amplify one-ulp
    differences past llama-1.5b's 0.1 (on an H100 80GB HBM3: deepseek-7b's
    paged probe 0.33 of 4.03; granite-moe-1b-a400m's 0.33 of 0.61, its
    tied embeddings keeping the logits small, with the routes replayed);
    the layer check (``Shadowed``) holds each kernel call itself.
    Returns (the kernels' error, the nudge, the limit)."""
    from repro_torch.kernels import ops
    out_k = fn()
    ops.set_backend("ref")
    try:
        out_r = fn()
        with Nudged():
            out_n = fn()
    finally:
        ops.set_backend(None)
    compared, own = max_err(out_k, out_r), max_err(out_n, out_r)
    scale = float(out_r.abs().max())
    limit = max(LOGIT_REL_TOL * scale, 2 * own)
    agree = float((out_k.argmax(-1) == out_r.argmax(-1)).float().mean())
    if not torch.isfinite(out_k).all() or compared > limit:
        raise AssertionError(f"{label}: decode logits kernel vs plain: "
                             f"{compared} > {limit} (max |logit| {scale}, "
                             f"one-ulp nudge {own})")
    log(f"{label}: {what}, kernels vs plain versions: "
        f"max_abs_err={compared:.3e}, max |logit| {scale:.3f}, one-ulp "
        f"nudge of every attention output moves the plain logits "
        f"{own:.3e} (limit max({LOGIT_REL_TOL} x max |logit|, 2 x nudge) "
        f"= {limit:.3e}), argmax agreement {agree:.2f}")
    return compared, own, limit


def family_engine(cfg, params, kind, tally, long) -> tuple:
    """Four requests (37, 512, 1024 and ``long`` prompt tokens, 32 new
    each, greedy and sampled alternating) on a ``PagedEngine(rows=4,
    page_size=16)`` or a dense ``Engine(slots=4)``: 8 steps, one decode
    step's logits against the plain versions, 4 profiled steps, then to
    the end.  Returns (decode step wall ms, busy ms, prefill s)."""
    from repro_torch.serving import paged
    from repro_torch.serving.engine import Engine
    max_len = -(-(long + 32) // 16) * 16
    if kind == "paged":
        eng = paged.PagedEngine(cfg, params, rows=4, page_size=16,
                                max_len=max_len, seed=SEED, device="cuda")
    else:
        eng = Engine(cfg, params, slots=4, max_len=max_len, seed=SEED,
                     device="cuda")
    reqs = _requests(cfg, (37, 512, 1024, long),
                     np.random.default_rng(SEED + 30), kind[0])
    torch.cuda.synchronize()
    t = time.perf_counter()
    tally.add(eng, *reqs)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    for _ in range(8):
        tally.step(eng)
    label = f"families {cfg.name} {kind}"
    if kind == "paged":
        def probe():
            return decode_logits(eng, paged)
    else:
        def probe():
            return dense_logits(eng)
    with Shadowed() as shadow:
        probe()
    log(f"{label}: every layer's decode attention held to its plain "
        f"version on the layer's own inputs: {shadow.calls} calls, worst "
        f"element at {shadow.worst:.3f} x its limit (4 bf16 ulps of "
        f"sum p|v|)")
    # one decode step end to end; an MoE model's plain runs take the
    # kernel run's routes (RouteReplay)
    compare_deep(label, RouteReplay(probe) if cfg.moe else probe)
    if kind == "paged":
        tally.probes += 2        # the shadowed probe and compare_deep's
    else:
        tally.steps["dense"] += 2
    wall, busy = profiled(lambda: [tally.step(eng) for _ in range(4)],
                          f"{label} decode step (4 rows)", 4)
    tally.drain(eng)
    _check_outputs(cfg, reqs)
    if kind == "paged":
        eng.check()
        if eng.allocator.free_pages != eng.pages:
            raise AssertionError(f"{label}: pages held after the last "
                                 "retire")
    return wall, busy, prefill_s


def family_hops(cfg, params, tally):
    """gemma3-4b's slot hops after 8 steps: paged (v2, live pages) and
    dense (v1: its local leaves are 1024-slot ring buffers, its global
    ones 2048 slots), each into a second engine of seed 9 that serves
    another request; both resume with the unmigrated runs' tokens bit
    for bit (``hop_pair``)."""
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.paged import PagedEngine
    geo = dict(rows=4, page_size=16, max_len=2048, device="cuda")

    def paged_landed(src, dst, moved, pos, snap):
        src.check()
        dst.check()

    hop_pair(lambda seed: PagedEngine(cfg, params, seed=seed, **geo), cfg,
             tally, f"families {cfg.name} paged hop", paged_landed)
    log(f"families {cfg.name} paged hop: m0 (1024 prompt tokens, sampled) "
        f"moved after 8 steps into PagedEngine(seed 9) beside a 200-token "
        f"request: 32 tokens equal the unmigrated run's bit for bit; m1, "
        f"m2 and d0 equal their runs without the hop")
    rings = {}

    def dense_landed(src, dst, moved, pos, snap):
        if moved.slot != 2 or snap.version != 1:
            raise AssertionError(f"dense hop: v{snap.version} landed in "
                                 f"slot {moved.slot}, not 2")
        for block, grp in zip(cfg.blocks, snap.arrays.caches):
            for ls, layer in zip(block.layers, grp):
                rings[ls.mixer] = layer["attn"]["k"].shape[1]
        window = max(ls.window for ls in cfg.layer_specs())
        if rings != {"local": min(window, 2048), "attn": 2048}:
            raise AssertionError(f"dense hop: cache slots {rings}")

    hop_pair(lambda seed: Engine(cfg, params, seed=seed, slots=4,
                                 max_len=2048, device="cuda"),
             cfg, tally, f"families {cfg.name} dense hop", dense_landed,
             into=2)
    log(f"families {cfg.name} dense hop: m0 moved from slot 0 to slot 2 "
        f"of Engine(seed 9) after 8 steps with its local layers' "
        f"{rings['local']}-slot ring buffers (global {rings['attn']} "
        f"slots): 32 tokens equal the unmigrated run's bit for bit; m1, m2 "
        f"and d0 equal their runs without the hop")


def release():
    """Free what the last engines held before the next allocates: an
    engine's cycles (its allocator's auditors, its programs' closures)
    wait for the collector, and the caching allocator keeps freed blocks
    until emptied; gemma2-27b's 56.8 GB of weights need the room."""
    gc.collect()
    torch.cuda.empty_cache()


def run_families() -> dict:
    """The six attention-only families at full width, one repeat of each
    block group (``family_config``), weights from seed 0 made on the
    card, one at a
    time: each on the paged and
    the dense engine (``family_engine``), its launches exactly
    num_layers x cold prefills (flash) and num_layers x decode forwards;
    gemma3-4b also hops a slot on both engines (``family_hops``)."""
    from repro_torch.models.init import init_params
    release()
    zero_counts()
    torch.cuda.synchronize()
    for name, long in FAMILIES:
        t0 = time.perf_counter()
        cfg, full = family_config(name, share=None)
        params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED),
                             device="cuda")
        torch.cuda.synchronize()
        G = cfg.num_heads // cfg.num_kv_heads
        windows = sorted({ls.window for ls in cfg.layer_specs()
                          if ls.mixer == "local"})
        log(f"families {name}: {cfg.param_count() / 1e9:.3f}B params "
            f"({cfg.active_param_count() / 1e9:.3f}B active) bf16, "
            f"{cfg.num_layers} layers (depth cut from {full.num_layers}) in "
            f"{len(cfg.blocks)} block groups, "
            f"head dim {cfg.head_dim}, G {G}, local windows {windows}, "
            f"softcaps {cfg.attn_softcap}/{cfg.logit_softcap}, vocab "
            f"{cfg.padded_vocab}; initialised on the card (seed {SEED}) in "
            f"{time.perf_counter() - t0:.2f} s")
        before = read_counts()
        tally = Tally(f"families {name}")
        steps = {}
        for kind in ("paged", "dense"):
            steps[kind] = family_engine(cfg, params, kind, tally, long)
            release()
        if name == "gemma3-4b":
            family_hops(cfg, params, tally)
            release()
        after = read_counts()
        tally.check({k: after[k] - before[k] for k in after}, cfg.num_layers)
        log(f"families {name}: launches flash_attention="
            f"{after['flash_attention'] - before['flash_attention']} "
            f"({cfg.num_layers} x {tally.prefills} prefills), "
            f"paged_decode_attention="
            f"{after['paged_decode_attention'] - before['paged_decode_attention']}"
            f", decode_attention="
            f"{after['decode_attention'] - before['decode_attention']} "
            f"({cfg.num_layers} x decode forwards {tally.steps}, the paged "
            f"ones + {tally.probes} logit probes), exactly")
        log(f"families {name}: prompts (37, 512, 1024, {long}); decode step "
            f"paged {steps['paged'][0]:.3f} ms wall / {steps['paged'][1]:.3f}"
            f" ms busy, dense {steps['dense'][0]:.3f} / "
            f"{steps['dense'][1]:.3f} ms; 4 prefills paged "
            f"{steps['paged'][2]:.3f} s, dense {steps['dense'][2]:.3f} s; "
            f"family wall {time.perf_counter() - t0:.1f} s ({gpu_line()})")
        del params
        release()
    return read_counts()


# ---------------------------------------------------------------------------
# the jamba path: the hybrid mamba / attention / MoE model at full width
# ---------------------------------------------------------------------------

JAMBA_GEO = dict(slots=4, max_len=1568, device="cuda")


class ScanTimer:
    """Within the block every ``mamba_parallel`` call (a mamba mixer in
    prefill: in_proj, the causal conv, the plain scan, out_proj) is timed
    to its end on the card, a synchronise before and after it."""

    def __enter__(self):
        from repro_torch.models import mamba
        self.mod, self.orig = mamba, mamba.mamba_parallel
        self.s, self.calls = 0.0, 0

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = self.orig(*a, **kw)
            torch.cuda.synchronize()
            self.s += time.perf_counter() - t
            self.calls += 1
            return out

        mamba.mamba_parallel = timed
        return self

    def __exit__(self, *exc):
        self.mod.mamba_parallel = self.orig


class PrefillWatch:
    """Within the block every prefill forward of the dense engine first
    records whether its slot's mamba leaves are all zero."""

    def __enter__(self):
        from repro_torch.serving import engine
        self.mod, self.orig, self.zero = engine, engine.forward, []

        def watched(params, batch, *, mode, caches=None, **kw):
            if mode == "prefill":
                self.zero.append(all(
                    not bool(a.any()) for grp in caches for layer in grp
                    for a in layer.get("mamba", {}).values()))
            return self.orig(params, batch, mode=mode, caches=caches, **kw)

        engine.forward = watched
        return self

    def __exit__(self, *exc):
        self.mod.forward = self.orig


def jamba_reuse(cfg, params, eng, tally):
    """A fifth request (320 prompt tokens, 16 new, greedy) in slot 0,
    which a finished request left: every mamba leaf of the slot is zero
    when its prefill starts, slots 1-3's ssm and conv stay untouched bit
    for bit across its decode steps, and its tokens equal a fresh
    engine's."""
    from repro_torch.serving.engine import Engine, Request
    prompt = np.random.default_rng(SEED + 41).integers(0, cfg.vocab_size, 320)
    again = Request("j4", prompt, max_new_tokens=16)
    with PrefillWatch() as watch:
        tally.add(eng, again)
    if again.slot != 0 or watch.zero != [True]:
        raise AssertionError(f"reused slot {again.slot}: mamba leaves zero "
                             f"at prefill {watch.zero}")
    idle = _state_rows(eng, slice(1, 4), "mamba")
    tally.drain(eng)
    for a, b in zip(idle, _state_rows(eng, slice(1, 4), "mamba")):
        for k in a:
            if not torch.equal(a[k], b[k]):
                raise AssertionError(f"jamba: inactive slots' {k} changed "
                                     "across decode steps")
    fresh = Engine(cfg, params, seed=SEED, **JAMBA_GEO)
    ref = Request("j4", prompt, max_new_tokens=16)
    tally.add(fresh, ref)
    tally.drain(fresh)
    if again.output != ref.output or len(ref.output) != 16:
        raise AssertionError(f"jamba reused slot {again.output} != fresh "
                             f"engine {ref.output}")
    log("jamba: a fifth request (320 prompt tokens, 16 new) in retired slot "
        "0 started from all-zero mamba leaves (14 layers' ssm and conv) and "
        "gave the fresh engine's tokens bit for bit; slots 1-3 ssm and conv "
        "untouched bit for bit across its 16 decode steps")


def jamba_refusal(eng):
    """A 100-token prompt (over 64, not a multiple of 64: outside the
    mamba scan's domain) is refused with ``ValueError`` before any slot
    or cache row moves."""
    from repro_torch.core.tree import leaves
    from repro_torch.serving.engine import Request
    before = [a.clone() for a in leaves(eng.state.caches)]
    free, active = eng.free_slots, eng.state.active.clone()
    try:
        eng.add_request(Request("j100", np.arange(100), max_new_tokens=4))
    except ValueError as e:
        why = str(e)
    else:
        raise AssertionError("jamba: a 100-token prompt was admitted")
    if eng.free_slots != free or not torch.equal(eng.state.active, active) \
            or not all(torch.equal(a, b)
                       for a, b in zip(before, leaves(eng.state.caches))):
        raise AssertionError("jamba: the refused prompt moved state")
    log(f"jamba: a 100-token prompt refused before anything moved: {why}")


def run_jamba() -> dict:
    """jamba-v0.1-52b at full width, 2 of its 4 repeats
    (``family_config``), weights from seed 0 made on the card (every
    other model freed), on
    ``Engine(slots=4, max_len=1568)``: four requests (37, 512, 1024, 1536
    prompt tokens, 32 new, greedy and sampled alternating); one decode
    step with each attention layer's kernel call held to its plain
    version and the logits against the plain versions (``families``'
    rule, the MoE routes replayed); a reused slot and the idle slots'
    state; a 100-token prompt refused; profiles of a decode step and of
    a 1536-token prefill split into the mamba mixers and the rest; a
    sampled 1024-token slot's v1 hop into an engine of seed 9.  Launches
    exactly 2 flash_attention a cold prefill and 2 decode_attention a
    decode forward (the two attention layers), and no other kernel."""
    from repro_torch.models.init import init_params
    from repro_torch.serving.engine import Engine, Request
    release()
    cfg, full = family_config("jamba-v0.1-52b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED),
                         device="cuda")
    torch.cuda.synchronize()
    kinds = [(ls.mixer, ls.ffn) for ls in cfg.layer_specs()]
    n_attn = sum(m == "attn" for m, _ in kinds)
    log(f"jamba: {full.name} at full width (d_model {cfg.d_model}, d_inner "
        f"{cfg.d_inner}, d_state {cfg.mamba_d_state}, d_conv "
        f"{cfg.mamba_d_conv}, GQA {cfg.num_heads} / {cfg.num_kv_heads} "
        f"heads of {cfg.head_dim}, {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.top_k} of {cfg.moe.d_expert}), depth cut to "
        f"{cfg.blocks[0].repeats} of {full.blocks[0].repeats} repeats of its "
        f"8-layer block: {cfg.num_layers} layers ("
        f"{sum(m == 'mamba' for m, _ in kinds)} mamba, {n_attn} attention, "
        f"{sum(f == 'moe' for _, f in kinds)} MoE FFN, "
        f"{sum(f == 'dense' for _, f in kinds)} dense FFN), "
        f"{cfg.param_count() / 1e9:.3f}B params "
        f"({cfg.active_param_count() / 1e9:.3f}B active) of "
        f"{full.param_count() / 1e9:.3f}B "
        f"({2 * full.param_count() / 1e9:.1f} GB bf16 at full depth: "
        f"past the card's 80 GB); bf16 from seed "
        f"{SEED}, initialised on the card in {time.perf_counter() - t0:.2f} s")
    zero_counts()
    torch.cuda.synchronize()
    tally = Tally("jamba")
    eng = Engine(cfg, params, seed=SEED, **JAMBA_GEO)
    lens = (37, 512, 1024, 1536)
    reqs = _requests(cfg, lens, np.random.default_rng(SEED + 40), "j")
    t = time.perf_counter()
    tally.add(eng, *reqs)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    for _ in range(8):
        tally.step(eng)
    with Shadowed() as shadow:
        dense_logits(eng)
    log(f"jamba: each attention layer's decode attention held to its plain "
        f"version on the layer's own inputs: {shadow.calls} calls, worst "
        f"element at {shadow.worst:.3f} x its limit (4 bf16 ulps of sum "
        f"p|v|)")
    compare_deep("jamba dense", RouteReplay(lambda: dense_logits(eng)))
    tally.steps["dense"] += 2        # the shadowed probe and compare_deep's
    step_s = []
    while eng.requests:
        t = time.perf_counter()
        tally.step(eng)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    _check_outputs(cfg, reqs)
    med = sorted(step_s)[len(step_s) // 2]
    log(f"jamba: 4 requests x 32 tokens done; prefill {sum(lens)} tokens in "
        f"{prefill_s:.3f} s = {sum(lens) / prefill_s:.1f} tok/s (the first "
        f"prefill includes set-up); decode median {med * 1e3:.3f} ms/step "
        f"over the last {len(step_s)} steps (host clock, synchronised)")
    jamba_reuse(cfg, params, eng, tally)
    jamba_refusal(eng)

    # where the time goes: a 1536-token prefill split into the mamba
    # mixers and the rest, then four decode steps of four rows
    long = Request("p0", reqs[3].prompt, max_new_tokens=8)
    with ScanTimer() as scan:
        torch.cuda.synchronize()
        t = time.perf_counter()
        tally.add(eng, long)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    log(f"jamba: a 1536-token prefill took {wall * 1e3:.1f} ms wall, "
        f"{scan.s * 1e3:.1f} ms ({100 * scan.s / wall:.1f}%) in its "
        f"{scan.calls} mamba mixers (in_proj, conv, the plain scan: "
        f"{1536 * scan.calls} token steps, out_proj) and "
        f"{(wall - scan.s) * 1e3:.1f} ms in the rest (the two attention "
        f"layers' flash, the MoE and dense FFNs, the head), host clock, "
        f"each mixer synchronised ({gpu_line()})")
    for r in _requests(cfg, lens[:3], np.random.default_rng(SEED + 40), "q"):
        tally.add(eng, r)
    wall, busy = profiled(lambda: [tally.step(eng) for _ in range(4)],
                          "jamba decode step (4 rows)", 4)
    for slot in list(eng.requests):
        eng.retire(slot)
    del eng
    release()

    def landed(src, dst, moved, pos, snap):
        if moved.slot != 2 or snap.version != 1:
            raise AssertionError(f"jamba hop: v{snap.version} landed in "
                                 f"slot {moved.slot}, not 2")

    hop_pair(lambda seed: Engine(cfg, params, seed=seed, **JAMBA_GEO), cfg,
             tally, "jamba migrate", landed, into=2, resident=192)
    log("jamba migrate: m0 (1024 prompt tokens, sampled) moved from slot 0 "
        "to slot 2 of Engine(seed 9) after 8 steps, 14 mamba layers' ssm "
        "(f32) and conv (bf16) and 2 attention layers' rows: 32 tokens "
        "equal the unmigrated run's bit for bit; m1, m2 and d0 (192 "
        "tokens) equal their runs without the hop")
    counts = read_counts()
    tally.check(counts, n_attn)
    log(f"jamba: launches flash_attention={counts['flash_attention']} "
        f"({n_attn} x {tally.prefills} cold prefills), "
        f"decode_attention={counts['decode_attention']} ({n_attn} x "
        f"{tally.steps['dense']} decode forwards, 2 of them logit probes), "
        f"no other kernel, exactly; decode step {wall:.3f} ms wall / "
        f"{busy:.3f} ms busy ({gpu_line()})")
    del params
    release()
    return counts


# ---------------------------------------------------------------------------
# the front-end paths: whisper-base (encoder, cross-attention) and
# internvl2-26b (patch prefix) through models.forward at full width and depth
# ---------------------------------------------------------------------------

FRONT_ROWS, FRONT_STEPS = 4, 32


class FrontTally:
    """The forwards a front-end path runs: a prefill or train forward
    launches flash once an attention call (each encoder layer, each
    decoder layer's self- and cross-attention), a decode forward dense
    decode once a decoder layer's self- and cross-attention; no other
    kernel runs."""

    def __init__(self, label: str, cfg):
        n = cfg.num_layers
        n_enc = sum(len(b.layers) * b.repeats for b in cfg.encoder_blocks)
        cross = n if cfg.cross_attention else 0
        self.label = label
        self.per_full, self.per_decode = n_enc + n + cross, n + cross
        self.full, self.decodes = 0, 0

    def check(self, counts: dict) -> dict:
        want = {"flash_attention": self.per_full * self.full,
                "decode_attention": self.per_decode * self.decodes}
        got = {k: n for k, n in counts.items() if n or k in want}
        if got != want:
            raise AssertionError(
                f"{self.label} launch counts {got}: need {self.per_full} x "
                f"{self.full} prefill and train forwards, {self.per_decode}"
                f" x {self.decodes} decode forwards and no other kernel: "
                f"{want}")
        return want


def front_generate(cfg, params, batch, tally, *, max_len, cross_len=0,
                   steps=FRONT_STEPS, profile=0):
    """``models.forward`` as its user drives it: a prefill of ``batch``
    into fresh caches (``make_cache(..., cross_len=)``), then ``steps``
    greedy decode steps, each feeding back the argmax over the real
    vocabulary at the position after the last.  With ``profile``, the
    last ``profile`` steps run under the profiler.  Returns a dict:
    prefill logits (B, S, V_pad), decode logits (B, steps, V_pad), the
    fed tokens (B, steps), a copy of the caches after the prefill, the
    prefill's wall seconds, each unprofiled step's wall ms and the
    profile's (wall, busy) ms a step."""
    from repro_torch.models.model import (forward, make_cache,
                                          vocab_mask_logits)
    B = batch["tokens"].shape[0]
    caches = make_cache(cfg, B, max_len, "cuda", cross_len=cross_len)
    out = {"fed": [], "steps": [], "step_ms": [], "profile": None}
    with torch.no_grad():
        torch.cuda.synchronize()
        t = time.perf_counter()
        pre = forward(params, batch, cfg=cfg, mode="prefill", caches=caches)
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t
        tally.full += 1
        out["snap"] = [[{kind: {k: a.clone() for k, a in c.items()}
                         for kind, c in layer.items()} for layer in grp]
                       for grp in caches]
        S, last = pre.shape[1], pre[:, -1]

        def step(i):
            nonlocal last
            tok = vocab_mask_logits(last.float(), cfg).argmax(-1)[:, None]
            tok = tok.to(torch.int32)
            pos = torch.full((B, 1), S + i, dtype=torch.int32,
                             device="cuda")
            last = forward(params, {"tokens": tok}, cfg=cfg, mode="decode",
                           caches=caches, positions=pos)[:, 0]
            tally.decodes += 1
            out["fed"].append(tok)
            out["steps"].append(last)

        for i in range(steps - profile):
            t = time.perf_counter()
            step(i)
            torch.cuda.synchronize()
            out["step_ms"].append((time.perf_counter() - t) * 1e3)
        if profile:
            out["profile"] = profiled(
                lambda: [step(i) for i in range(steps - profile, steps)],
                f"{tally.label} decode step ({B} rows)", profile)
    out["prefill"] = pre
    out["steps"] = torch.stack(out["steps"], 1)
    out["fed"] = torch.cat(out["fed"], 1)
    return out


def front_probes(label, cfg, params, batch, run, tally) -> float:
    """``compare_deep`` on the last prefill row's logits (no cache) and
    on one decode step from a copy of the caches after the prefill (the
    first greedy token at the first decode position); returns the decode
    step's nudge (what one bf16 ulp on each of its attention outputs
    moves the plain logits)."""
    from repro_torch.models.model import forward, vocab_mask_logits
    pre = run["prefill"]
    B, S = pre.shape[:2]
    tok = vocab_mask_logits(pre[:, -1].float(), cfg).argmax(-1)[:, None]
    tok, pos = tok.to(torch.int32), torch.full(
        (B, 1), S, dtype=torch.int32, device="cuda")

    def prefill():
        with torch.no_grad():
            return forward(params, batch, cfg=cfg, mode="prefill")[:, -1] \
                .float()

    def decode():
        caches = [[{kind: {k: a.clone() for k, a in c.items()}
                    for kind, c in layer.items()} for layer in grp]
                  for grp in run["snap"]]
        with torch.no_grad():
            return forward(params, {"tokens": tok}, cfg=cfg, mode="decode",
                           caches=caches, positions=pos)[:, 0].float()

    compare_deep(f"{label} prefill", prefill, "the last prefill row's logits")
    nudge = compare_deep(f"{label} decode", decode)[1]
    tally.full += 1
    tally.decodes += 1
    return nudge


def teacher_forced(label, run, forced, nudge, tally):
    """The prefill's and the decode steps' logits against one
    teacher-forced train forward over the same tokens (``forced(0)``: its
    logits at the prefill's and the steps' positions), within the larger
    of ``LOGIT_REL_TOL`` x max |logit| and twice the decode step's nudge:
    the decode kernel and flash sum in other orders, a one-ulp
    difference in the decoder's attention outputs that the random model
    amplifies as it does between kernels and plain versions
    (``compare_deep``).  The prefill's own nudge also moves an encoder's
    outputs, and on whisper it exceeds max |logit| (a limit that holds
    nothing), so the decode step's is the yardstick.  The decode steps'
    argmax must also agree with the forward's on at least
    ``TEACHER_ARGMAX`` of their tokens, and a forward on each row's
    neighbour's frames or patches (``forced(1)``: the front input rolled
    by one row, what a cross cache or prefix read from the wrong place
    would feed) must agree on fewer: the floor tells the right front
    input from a wrong one."""
    with torch.no_grad():
        full = forced(0)
    S = run["prefill"].shape[1]
    errs = [max_err(run["prefill"][b], full[b, :S])
            for b in range(full.shape[0])]
    errs.append(max_err(run["steps"], full[:, S:]))
    err = max(errs)
    scale = float(full.abs().max())
    limit = max(LOGIT_REL_TOL * scale, 2 * nudge)
    got = run["steps"].argmax(-1)
    agree = float((got == full[:, S:].argmax(-1)).float().mean())
    finite = bool(torch.isfinite(full).all())
    del full
    with torch.no_grad():
        wrong = float((got == forced(1)[:, S:].argmax(-1)).float().mean())
    tally.full += 2
    if not finite or err > limit:
        raise AssertionError(f"{label}: prefill + decode logits against the "
                             f"teacher-forced forward: {err} > {limit}")
    if not agree >= TEACHER_ARGMAX > wrong:
        raise AssertionError(f"{label}: the decode steps' argmax agrees with "
                             f"the teacher-forced forward on {agree}, with "
                             f"the one on the neighbour's front input on "
                             f"{wrong} (floor {TEACHER_ARGMAX})")
    log(f"{label}: prefill ({S} positions) + {run['steps'].shape[1]} decode "
        f"steps against one teacher-forced train forward on the same "
        f"tokens: max_abs_err={err:.3e} (prefill {max(errs[:-1]):.3e}, "
        f"decode {errs[-1]:.3e}), max |logit| {scale:.3f}, limit max("
        f"{LOGIT_REL_TOL} x max |logit|, 2 x nudge {nudge:.3e}) = "
        f"{limit:.3e}; the decode steps' argmax agreement {agree:.4f} "
        f"(floor {TEACHER_ARGMAX}), {wrong:.4f} against a forward on each "
        f"row's neighbour's front input")


def front_runs(label, cfg, params, batch, tally, **geo):
    """The timed run (``front_generate``, its last 4 steps profiled),
    then the same run with every attention call held to its plain
    version (``Shadowed``), which must give the timed run's logits and
    tokens bit for bit.  Returns the timed run."""
    run = front_generate(cfg, params, batch, tally, profile=4, **geo)
    with Shadowed() as shadow:
        again = front_generate(cfg, params, batch, tally, **geo)
    for key in ("prefill", "steps", "fed"):
        if not torch.equal(run[key], again[key]):
            raise AssertionError(f"{label}: a second run gave other {key}")
    med = sorted(run["step_ms"])[len(run["step_ms"]) // 2]
    log(f"{label}: every attention call held to its plain version on its "
        f"own inputs: {shadow.calls} calls ({shadow.flash} flash), worst "
        f"element at {shadow.worst:.3f} x its limit (4 bf16 ulps of sum "
        f"p|v|); the second run's logits and tokens equal the first's bit "
        f"for bit")
    log(f"{label}: prefill {run['prefill_s'] * 1e3:.1f} ms wall; decode "
        f"median {med:.3f} ms/step over {len(run['step_ms'])} steps, "
        f"profiled {run['profile'][0]:.3f} ms wall / {run['profile'][1]:.3f}"
        f" ms busy a step (host clock, synchronised; {gpu_line()})")
    return run


def run_whisper() -> dict:
    """whisper-base at full width and depth (6 encoder + 6 decoder
    layers), weights from seed 0 made on the card, through
    ``models.forward``: 4 rows of 1536 frames and 416 decoder tokens
    from ``configs.inputs.batch_specs``, prefilled into
    ``make_cache(cfg, 4, 448, cross_len=1536)``, then 32 greedy decode
    steps to ``decoder_len`` 448 (``front_runs``); the kernels' logits
    against the plain versions' (``front_probes``); prefill and decode
    against one teacher-forced train forward on the 448 tokens; then one
    row of 32768 frames (the config's ``prefill_32k`` length) with 4
    decode steps, each encoder layer's flash held to its plain version on
    its first 512 query rows over all keys.  Launches exactly 18 flash a
    prefill or train forward (6 encoder, 6 causal, 6 cross) and 12
    dense decode a decode forward (6 self, 6 cross)."""
    from repro_torch.configs import ShapeSpec, get
    from repro_torch.configs.inputs import batch_specs
    from repro_torch.models.init import init_params
    from repro_torch.models.model import forward
    release()
    cfg = get("whisper-base")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED),
                         device="cuda")
    torch.cuda.synchronize()
    log(f"whisper: {cfg.name} at full width and depth ("
        f"{cfg.encoder_blocks[0].repeats} encoder + {cfg.num_layers} decoder "
        f"layers, d_model {cfg.d_model}, H {cfg.num_heads} / KV "
        f"{cfg.num_kv_heads}, D {cfg.head_dim}, {cfg.act}, vocab "
        f"{cfg.padded_vocab}), {cfg.param_count() / 1e6:.1f}M params bf16 "
        f"from seed {SEED}, initialised on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    zero_counts()
    torch.cuda.synchronize()
    tally = FrontTally("whisper", cfg)
    frames, plen = 1536, cfg.decoder_len - FRONT_STEPS
    full_in = batch_specs(cfg, ShapeSpec("whisper", frames, FRONT_ROWS,
                                         "prefill"),
                          concrete=True, seed=SEED, device="cuda")
    batch = {"frames": full_in["frames"], "tokens": full_in["tokens"][:, :plen]}
    geo = dict(max_len=cfg.decoder_len, cross_len=frames)
    run = front_runs("whisper", cfg, params, batch, tally, **geo)
    nudge = front_probes("whisper", cfg, params, batch, run, tally)
    tokens = torch.cat([batch["tokens"], run["fed"]], 1)
    teacher_forced("whisper", run, lambda shift: forward(
        params, {"frames": batch["frames"].roll(shift, 0), "tokens": tokens},
        cfg=cfg, mode="train"), nudge, tally)
    del run
    release()

    # the config's own prefill_32k length, one row
    long = batch_specs(cfg, ShapeSpec("prefill_32k", 32768, 1, "prefill"),
                       concrete=True, seed=SEED, device="cuda")
    with Shadowed(rows=512) as shadow:
        run = front_generate(
            cfg, params, {"frames": long["frames"],
                          "tokens": long["tokens"][:, :plen]}, tally,
            max_len=cfg.decoder_len, cross_len=32768, steps=4)
    if not (torch.isfinite(run["prefill"]).all()
            and torch.isfinite(run["steps"]).all()):
        raise AssertionError("whisper 32768 frames: logits not finite")
    cross_bytes = sum(a.numel() * a.element_size() for grp in run["snap"]
                      for layer in grp for k, a in layer["cross"].items()
                      if k in ("k", "v"))
    log(f"whisper: one row of 32768 frames ({plen} decoder tokens, 4 decode "
        f"steps): logits finite; cross caches {cross_bytes / 1e6:.1f} MB over "
        f"{cfg.num_layers} layers; prefill {run['prefill_s'] * 1e3:.1f} ms "
        f"wall; {shadow.calls} attention calls held to their plain "
        f"versions ({shadow.flash} flash, the encoder's on their first 512 "
        f"query rows over all 32768 keys), worst element at "
        f"{shadow.worst:.3f} x its limit")
    counts = read_counts()
    want = tally.check(counts)
    log(f"whisper: launches flash_attention={want['flash_attention']} "
        f"({tally.per_full} x {tally.full} prefill and train forwards), "
        f"decode_attention={want['decode_attention']} ({tally.per_decode} x "
        f"{tally.decodes} decode forwards), no other kernel, exactly")
    del params, run
    release()
    return counts


def run_internvl() -> dict:
    """internvl2-26b at full width and depth (48 layers, 19.875B params,
    39.8 GB of bf16), weights from seed 0 made on the card (every other
    model freed), through ``models.forward``: 4 rows of 256 patch
    embeddings and 1280 text tokens from ``configs.inputs.batch_specs``,
    prefilled into ``make_cache(cfg, 4, 1568)``, then 32 greedy decode
    steps at positions 1536-1567 (``front_runs``); the kernels' logits
    against the plain versions'; prefill and decode against one
    teacher-forced train forward, over 2048 positions (1568 is outside
    the prefill domain; the 480 tokens after the 32 fed ones cannot move
    the earlier logits of a causal model).  Launches exactly 48 flash a
    prefill or train forward and 48 dense decode a decode forward."""
    from repro_torch.configs import ShapeSpec, get
    from repro_torch.configs.inputs import batch_specs
    from repro_torch.models.init import init_params
    from repro_torch.models.model import forward
    release()
    cfg = get("internvl2-26b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED),
                         device="cuda")
    torch.cuda.synchronize()
    log(f"internvl: {cfg.name} at full width and depth ({cfg.num_layers} "
        f"layers, d_model {cfg.d_model}, H {cfg.num_heads} / KV "
        f"{cfg.num_kv_heads} (G {cfg.num_heads // cfg.num_kv_heads}), D "
        f"{cfg.head_dim}, {cfg.num_patches} patches of 1024 through "
        f"patch_proj, vocab {cfg.padded_vocab}), "
        f"{cfg.param_count() / 1e9:.3f}B params bf16 from seed {SEED} "
        f"({torch.cuda.memory_allocated() / 1e9:.1f} GB on the card), "
        f"initialised in {time.perf_counter() - t0:.2f} s")
    zero_counts()
    torch.cuda.synchronize()
    tally = FrontTally("internvl", cfg)
    batch = batch_specs(cfg, ShapeSpec("internvl", 1536, FRONT_ROWS,
                                       "prefill"),
                        concrete=True, seed=SEED, device="cuda")
    text = batch["tokens"]
    S = cfg.num_patches + text.shape[1]
    run = front_runs("internvl", cfg, params, batch, tally,
                     max_len=S + FRONT_STEPS)
    nudge = front_probes("internvl", cfg, params, batch, run, tally)
    # the teacher-forced length: S + FRONT_STEPS, up to the prefill domain
    L = S + FRONT_STEPS
    L = -(-L // 512) * 512 if L > 512 else L
    pad = L - S - FRONT_STEPS
    tokens = torch.cat([text, run["fed"], text[:, :pad]], 1)
    teacher_forced("internvl", run, lambda shift: forward(
        params, {"tokens": tokens,
                 "patch_embeds": batch["patch_embeds"].roll(shift, 0)},
        cfg=cfg, mode="train")[:, :S + FRONT_STEPS], nudge, tally)
    counts = read_counts()
    want = tally.check(counts)
    log(f"internvl: launches flash_attention={want['flash_attention']} "
        f"({tally.per_full} x {tally.full} prefill and train forwards), "
        f"decode_attention={want['decode_attention']} ({tally.per_decode} x "
        f"{tally.decodes} decode forwards), no other kernel, exactly; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB ({gpu_line()})")
    del params, run
    release()
    return counts


# ---------------------------------------------------------------------------
# the train paths: llama-1.5b and whisper-base through the train step
# ---------------------------------------------------------------------------

TRAIN_STEPS, TRAIN_RESTART = 10, 5
TRAIN_ROWS, TRAIN_SEQ = 4, 1536       # llama-1.5b's batch: 4 x 1536 tokens
WHISPER_TOKENS = 416                  # whisper-base: 416 tokens, 1536 frames


class ShadowedTrain(Shadowed):
    """``Shadowed`` over a train step.  Every flash forward call (the
    first pass and each remat recompute) is held to its plain version as
    ``Shadowed`` holds it, and each recompute to the first pass's output
    on the same inputs, bit for bit; every backward call
    (``flash_attention.backward_kernel``, which ``FlashAttention`` looks
    up at each call) is held to ``plain_backward`` on its own inputs by
    ``bwd_err``'s element rule with the dot products' part (``DOT_ULPS``).
    ``bwd`` (backward calls), ``bwd_worst`` (and ``bwd_part``, over the
    bf16 rule alone),
    ``recomputed`` (recomputes matched bit for bit) and ``pending``
    (first-pass calls no recompute matched) are kept."""

    def __init__(self):
        super().__init__()
        self.bwd, self.bwd_worst, self.recomputed = 0, 0.0, 0
        self.bwd_part = 0.0     # the worst over the bf16 rule alone
        self.pending = []       # (q, k, v, O) of first-pass flash calls

    def call(self, name, orig, q, k, v, *args, **kw):
        out = super().call(name, orig, q, k, v, *args, **kw)
        if name not in FLASH_OPS:
            return out
        for i, (fq, fk, fv, fo) in enumerate(self.pending):
            if (fq.shape == q.shape and fk.shape == k.shape
                    and torch.equal(fq, q) and torch.equal(fk, k)
                    and torch.equal(fv, v)):
                if not torch.equal(fo, out):
                    raise AssertionError(f"{name}: the remat recompute gave "
                                         "other bits than the first pass")
                self.recomputed += 1
                del self.pending[i]
                return out
        self.pending.append(tuple(t.detach().clone() for t in (q, k, v, out)))
        return out

    def backward(self, q, k, v, o, do, lse, **kw):
        grads = self.bwd_kernel(q, k, v, o, do, lse, **kw)
        with torch.no_grad():
            *ref, terms, dots = self.fa.plain_backward(
                q, k, v, o, do, terms=True, **kw)
            err, frac, part, _ = bwd_err(grads, ref, terms, dots)
        del ref, terms, dots
        self.bwd += 1
        self.bwd_worst = max(self.bwd_worst, frac)
        self.bwd_part = max(self.bwd_part, part)
        if not all(bool(torch.isfinite(g).all()) for g in grads) \
                or frac > 1.0:
            raise AssertionError(f"flash_attention_bwd in the model: "
                                 f"{frac:.2f} x its limit against "
                                 "plain_backward")
        return grads

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa
        super().__enter__()
        self.fa, self.bwd_kernel = fa, fa.backward_kernel
        fa.backward_kernel = self.backward
        return self

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.fa.backward_kernel = self.bwd_kernel


EXAMPLE_RUNS = ("quickstart", "resilient_failover", "validated_medical_agent",
                "speculative_serving", "speculative_fleet", "fleet_serving")
# train_100m --full: the example's 120 steps (a checkpoint every 40), the
# kill after the step-80 one; 32 rows a batch, where 8 (the example's
# default) leaves the random init short of LEARNED in 120 steps (9.398 ->
# 8.982 on an H100 80GB HBM3, 32 rows: 9.410 -> 7.831)
TRAIN_100M_STEPS, TRAIN_100M_KILL, TRAIN_100M_BATCH = 120, 80, 32


def _figures(got):
    """An example's returned figures without its token lists and trees,
    floats to 4 significant digits, for its ``examples:`` line."""
    skip = {"outputs", "out", "ref", "tokens", "before", "params", "opt",
            "losses", "batch", "chat"}
    if isinstance(got, dict):
        return {k: _figures(v) for k, v in got.items() if k not in skip}
    if isinstance(got, float):
        return float(f"{got:.4g}")
    if isinstance(got, (list, tuple)):
        return [_figures(v) for v in got]
    return got


class DeferredShadowTrain(ShadowedTrain):
    """``ShadowedTrain``'s checks with their verdicts kept on the card and
    read once, by ``verdict()``, so that they add no host sync to a step:
    every flash call against its plain version by ``Shadowed``'s element
    rule, each remat recompute against its first pass bit for bit, every
    backward call against ``plain_backward`` by ``bwd_err``'s element
    rule (the bf16 part plus ``DOT_ULPS`` of the dot products), every
    output finite.  A step's first ``layers`` flash calls are its first
    passes and its next ``layers`` their recomputes, last layer first
    (remat's backward walks the layers from the last), so each recompute
    is compared with the latest pending first pass: a wrong pairing
    shows as a mismatch, never as a pass."""

    def __init__(self, layers):
        super().__init__()
        self.layers = layers
        self._worst = self._bwd_worst = self._mismatch = None

    @staticmethod
    def _fold(acc, x):
        return x if acc is None else torch.maximum(acc, x)

    @staticmethod
    def _finite(out, frac):
        return torch.where(torch.isfinite(out).all(), frac,
                           torch.full_like(frac, float("inf")))

    def call(self, name, orig, q, k, v, *args, **kw):
        from repro_torch.kernels.ref import reference_attention
        out = orig(q, k, v, *args, **kw)
        if name not in FLASH_OPS:
            raise AssertionError(f"{name} called in a train step")
        with torch.no_grad():
            causal = FLASH_OPS[name]
            ref = reference_attention(q, k, v, causal=causal, **kw).float()
            terms = reference_attention(q, k, v.abs(), causal=causal,
                                        **kw).float()
            frac = ((out.float() - ref).abs()
                    / (4 * 2.0 ** -7 * terms).clamp(min=1e-30)).amax()
            self._worst = self._fold(self._worst, self._finite(out, frac))
            if self.flash % (2 * self.layers) < self.layers:
                self.pending.append(tuple(t.detach().clone()
                                          for t in (q, k, v, out)))
            else:
                first = self.pending.pop()
                diff = torch.stack([(a != b).any() for a, b in
                                    zip(first, (q, k, v, out))]).any()
                self._mismatch = self._fold(self._mismatch, diff)
                self.recomputed += 1
        self.flash += 1
        self.calls += 1
        return out

    def backward(self, q, k, v, o, do, lse, **kw):
        grads = self.bwd_kernel(q, k, v, o, do, lse, **kw)
        with torch.no_grad():
            *ref, terms, dots = self.fa.plain_backward(
                q, k, v, o, do, terms=True, **kw)
            for g, r, t, d in zip(grads, ref, terms, dots):
                lim = BWD_ULPS * t + DOT_ULPS * d
                frac = ((g.float() - r.float()).abs()
                        / lim.clamp(min=1e-30)).amax()
                self._bwd_worst = self._fold(self._bwd_worst,
                                             self._finite(g, frac))
        self.bwd += 1
        return grads

    def verdict(self) -> dict:
        """The checks' figures, read once; raises on any failure."""
        self.worst = float(self._worst) if self.calls else 0.0
        self.bwd_worst = float(self._bwd_worst) if self.bwd else 0.0
        mismatch = bool(self._mismatch) if self.recomputed else False
        if self.worst > 1.0 or self.bwd_worst > 1.0 or mismatch \
                or self.pending:
            raise AssertionError(
                f"train_100m: flash at {self.worst:.3f} x its limit, "
                f"backward at {self.bwd_worst:.3f} x, a recompute differs "
                f"from its first pass: {mismatch}, {len(self.pending)} "
                "first passes never recomputed")
        return dict(calls=self.calls, flash=self.flash, worst=self.worst,
                    bwd=self.bwd, bwd_worst=self.bwd_worst,
                    recomputed=self.recomputed, pending=len(self.pending))


def train_100m_child(argv) -> int:
    """``python3 chip_smoke.py --train-100m ARGS``: one run of
    ``repro_torch.examples.train_100m`` on the card with every flash
    call, remat recompute and backward call held
    (``DeferredShadowTrain``); its last line is the launch counts and the
    checks' figures as JSON."""
    if not torch.cuda.is_available():
        print("chip_smoke: the train_100m child needs a CUDA card",
              file=sys.stderr)
        return 1
    from repro_torch.examples import train_100m
    from repro_torch.kernels import build
    build.build_all(("flash_attention", "flash_attention_bwd"))
    zero_counts()
    with DeferredShadowTrain(train_100m.CFG_100M.num_layers) as sh:
        code = train_100m.main(argv)
    torch.cuda.synchronize()
    print("train_100m child: " + json.dumps(dict(
        counts=read_counts(), **sh.verdict())), flush=True)
    return code


class Child:
    """One ``train_100m --full`` child process, its output pumped by a
    thread: its lines, and, once it has ended, the JSON of its last line
    (None when it was killed).  With ``kill_at`` it is killed (SIGKILL)
    as soon as it prints that line, and ``then()`` runs on the pump's
    thread after it is dead."""

    def __init__(self, argv, *, kill_at=None, then=None, timeout_s=600):
        import threading
        self.argv, self.kill_at, self.then = argv, kill_at, then
        self.lines, self.killed, self.wall = [], False, None
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--train-100m",
             "--full", *argv], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            cwd=str(Path(__file__).resolve().parent))
        self.watchdog = threading.Timer(timeout_s, self.proc.kill)
        self.watchdog.start()
        self.thread = threading.Thread(target=self._pump, daemon=True)
        self.thread.start()

    def _pump(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))
            if self.kill_at is not None and self.kill_at in line:
                self.proc.kill()
                self.killed = True
                break
        self.proc.wait()
        self.wall = time.perf_counter() - self.t0
        if self.killed and self.then is not None:
            self.then()

    def result(self) -> tuple:
        self.thread.join()
        self.watchdog.cancel()
        self.proc.stdout.close()
        lines = self.lines
        if self.killed:
            return lines, None, self.wall
        if self.proc.returncode != 0 or not lines or \
                not lines[-1].startswith("train_100m child"):
            raise AssertionError(f"train_100m {' '.join(self.argv)}: exit "
                                 f"{self.proc.returncode}, last lines "
                                 f"{lines[-8:]}")
        return lines, json.loads(lines[-1].split(": ", 1)[1]), self.wall

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.watchdog.cancel()


def check_train_100m_child(label, stats, steps):
    """The child's launches: exactly one flash call a layer and pass (24
    layers) and as many remat recomputes, one backward call a layer and
    pass, no other kernel."""
    from repro_torch.examples.train_100m import CFG_100M
    layers = CFG_100M.num_layers
    want = {"flash_attention": 2 * layers * steps,
            "flash_attention_bwd": layers * steps}
    got = {k: n for k, n in stats["counts"].items() if n or k in want}
    if got != want or stats["recomputed"] != layers * steps:
        raise AssertionError(f"train_100m {label}: launches {got} (need "
                             f"{want}), checks {stats}")
    return got


class Train100m:
    """``train_100m --full`` (CFG_100M: 24 layers, d_model 640, head_dim
    64; ``--batch 32``) on the card as child processes, started together
    and run beside the serving examples (the card idles under each: their
    steps are host-bound): one for 120 steps uninterrupted, one killed
    (SIGKILL) after its step-80 checkpoint line, restarted with
    ``--resume`` as soon as it is dead.  ``finish()`` waits for them: the
    two step-120 checkpoints must be equal file for file, byte for byte,
    and the uninterrupted run must print LEARNED; it returns the launches
    of the two runs that finished."""

    def __init__(self):
        import shutil
        self.base = (Path(__file__).resolve().parent / "build"
                     / "examples_train_100m")
        shutil.rmtree(self.base, ignore_errors=True)
        self.flags = ["--steps", str(TRAIN_100M_STEPS), "--batch",
                      str(TRAIN_100M_BATCH)]
        self.mark = f"checkpointed at {TRAIN_100M_KILL} "
        self.resumed = None
        self.whole = Child([*self.flags, "--ckpt-dir",
                            str(self.base / "whole")])
        self.cut = Child([*self.flags, "--ckpt-dir",
                          str(self.base / "resumed")],
                         kill_at=self.mark, then=self._resume)

    def _resume(self):
        self.resumed = Child([*self.flags, "--ckpt-dir",
                              str(self.base / "resumed"), "--resume"])

    def finish(self) -> dict:
        whole, stats, wall = self.whole.result()
        counts = check_train_100m_child("uninterrupted", stats,
                                        TRAIN_100M_STEPS)
        loss = [ln for ln in whole if ln.startswith("loss:")][-1]
        log(f"examples: train_100m --full uninterrupted: {whole[0]}; "
            f"{loss}; {wall:.1f} s wall (a process, {TRAIN_100M_STEPS} "
            f"steps of {TRAIN_100M_BATCH} x 128 tokens); every flash call "
            f"at {stats['worst']:.3f} x its limit, {stats['recomputed']} "
            f"remat recomputes bit-equal, {stats['bwd']} backward calls at "
            f"{stats['bwd_worst']:.3f} x ({gpu_line()})")
        cut, _, wall_k = self.cut.result()
        if not self.cut.killed or self.resumed is None:
            raise AssertionError(f"train_100m: the run to kill ended "
                                 f"before step {TRAIN_100M_KILL}: {cut[-6:]}")
        again, stats2, wall_r = self.resumed.result()
        if f"resumed at step {TRAIN_100M_KILL}" not in again:
            raise AssertionError(f"train_100m --resume: {again[:4]}")
        more = check_train_100m_child(
            "resumed", stats2, TRAIN_100M_STEPS - TRAIN_100M_KILL)
        step = f"step_{TRAIN_100M_STEPS:08d}"
        a, b = self.base / "whole" / step, self.base / "resumed" / step
        files = sorted(p.name for p in a.iterdir())
        if files != sorted(p.name for p in b.iterdir()) or any(
                (a / f).read_bytes() != (b / f).read_bytes() for f in files):
            raise AssertionError("train_100m: the resumed run's step-120 "
                                 "checkpoint differs from the uninterrupted "
                                 "run's")
        size = sum((a / f).stat().st_size for f in files)
        log(f"examples: train_100m --full killed after its step-"
            f"{TRAIN_100M_KILL} checkpoint line ({wall_k:.1f} s), "
            f"restarted with --resume ({wall_r:.1f} s, {again[-2]}; its "
            f"calls at {stats2['worst']:.3f} / {stats2['bwd_worst']:.3f} x "
            f"their limits): the step-{TRAIN_100M_STEPS} checkpoints "
            f"({len(files)} files, {size} bytes) equal byte for byte")
        if "LEARNED" not in loss:
            raise AssertionError(f"train_100m: {loss}")
        return {k: counts.get(k, 0) + more.get(k, 0)
                for k in set(counts) | set(more)}

    def stop(self):
        import shutil
        for child in (self.whole, self.cut, self.resumed):
            if child is not None:
                child.stop()
        shutil.rmtree(self.base, ignore_errors=True)


def run_examples(cfg, params) -> dict:
    """The ``examples`` path: the six serving examples of
    ``repro_torch.examples`` at full width on the card, each through its
    ``run`` on the llama-1.5b weights already held (speculative_serving's
    draft: the same width at one layer, seed 1), every attention call
    held to its plain version (``Shadowed``), their printed lines and
    figures logged; beside them, ``train_100m --full`` with its restart
    (``Train100m``: child processes).  The path must launch flash, its
    backward, dense and paged decode and spec_accept."""
    zero_counts()
    train = Train100m()
    try:
        with Shadowed() as sh:
            for name in EXAMPLE_RUNS:
                serve_example(name, cfg, params)
        counts = read_counts()
        log(f"examples: {sh.calls} attention calls ({sh.flash} flash) held "
            f"to their plain versions, worst element at {sh.worst:.3f} x "
            f"its limit")
        for k, n in train.finish().items():
            counts[k] += n
    finally:
        train.stop()
    need = ("flash_attention", "flash_attention_bwd", "decode_attention",
            "paged_decode_attention", "spec_accept")
    if any(counts[k] < 1 for k in need):
        raise AssertionError(f"examples: launches {counts}: each of {need} "
                             "must launch")
    return counts


def serve_example(name, cfg, params):
    """One serving example's ``run`` on the card: its printed lines, then
    its figures, launches and wall."""
    import contextlib
    import importlib
    import io

    from repro_torch.models.init import init_params
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    before = read_counts()
    args, kw = (cfg, params), {}
    if name == "speculative_serving":
        dcfg = mod.draft_config(cfg)
        args += (dcfg, init_params(
            dcfg, torch.Generator("cuda").manual_seed(SEED + 1),
            device="cuda"))
        kw["exact"] = False
    buf = io.StringIO()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        got = mod.run(*args, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    for ln in buf.getvalue().splitlines():
        if ln.strip():
            log(f"examples: {name}: {ln}")
    ran = {k: n - before[k] for k, n in read_counts().items()
           if n != before[k]}
    log(f"examples: {name}: {json.dumps(_figures(got), default=str)}; "
        f"launches {ran}; {wall:.1f} s wall ({gpu_line()})")
    del args, got
    release()


def refuse_mesh(tc):
    """A train step given a mesh refused with ``NotImplementedError``
    before anything moves: no launch, no allocation (one card has no
    mesh; ``sharding.py`` is ROADMAP Queue 1 work)."""
    from repro_torch.configs import get
    from repro_torch.training.train import train_step
    zero_counts()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    try:
        train_step({}, {}, {}, cfg=get("llama-1.5b"), tcfg=tc,
                   mesh=object())
    except NotImplementedError as e:
        said = str(e)
    else:
        raise AssertionError("a train step with a mesh was not refused")
    torch.cuda.synchronize()
    if any(read_counts().values()) or \
            torch.cuda.memory_allocated() != before:
        raise AssertionError("a refused train step launched or allocated")
    log(f"train: a mesh refused before anything moved (no launch, no "
        f"allocation): {said}")


def train_batch(pipe, step: int) -> dict:
    return {k: torch.from_numpy(v).to("cuda")
            for k, v in pipe.batch(step).items()}


def train_line(label, i, m, wall, tokens) -> dict:
    vals = {k: float(m[k]) for k in ("loss", "ce", "aux", "grad_norm",
                                      "lr")}
    if not all(np.isfinite(list(vals.values()))):
        raise AssertionError(f"{label} step {i}: not finite {vals}")
    log(f"{label}: step {i} loss {vals['loss']:.4f} ce {vals['ce']:.4f} "
        f"aux {vals['aux']:.4f} gnorm {vals['grad_norm']:.4f} lr "
        f"{vals['lr']:.3e} wall {wall * 1e3:.1f} ms ({tokens / wall:.0f} "
        f"tokens/s)")
    return vals


def timed_step(step, params, opt, batch):
    torch.cuda.synchronize()
    t = time.perf_counter()
    params, opt, m = step(params, opt, batch)
    torch.cuda.synchronize()
    return params, opt, m, time.perf_counter() - t


def check_train_launches(label, counts, layers, passes):
    """Exactly ``layers`` flash launches a forward pass and as many remat
    recomputes, ``layers`` backward launches a pass, no other kernel."""
    want = {"flash_attention": 2 * layers * passes,
            "flash_attention_bwd": layers * passes}
    got = {k: n for k, n in counts.items() if n or k in want}
    if got != want:
        raise AssertionError(f"{label} launch counts {got}: need {want} "
                             f"({layers} attention calls x {passes} forward "
                             "passes)")
    log(f"{label}: launches flash_attention={want['flash_attention']} "
        f"({layers} x {passes} forward passes, each with its remat "
        f"recompute), flash_attention_bwd={want['flash_attention_bwd']} "
        f"({layers} x {passes}), no other kernel, exactly")


def micro_diff(p1, p2, lr) -> float:
    """The largest |p1 - p2| over its element's limit: 2 lr (two Adam
    steps apart at most, |u| ~ 1 each) plus one bf16 ulp of the element
    (the f32 update rounded back to bf16 may land on either side)."""
    from repro_torch.core.tree import leaves
    worst = 0.0
    for a, b in zip(leaves(p1), leaves(p2)):
        top = torch.maximum(a.float().abs(), b.float().abs()).clamp(
            min=2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
        worst = max(worst, float(((a.float() - b.float()).abs()
                                  / (2 * lr + ulp)).max()))
    return worst


def run_train() -> dict:
    """llama-1.5b at full width and depth (24 layers, 1.267B params bf16,
    AdamW moments f32, seed 0) through ``training.train``'s step with
    remat, on ``Pipeline(DataConfig(32000, 1536, 4))`` batches and
    ``AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)``: ten steps,
    each finite, a checkpoint of {params, opt} saved through
    ``checkpoint/disk.py`` before step 5; the run again from it, bit for
    bit; ``microbatches=2`` against 1 on one batch; one step with every
    flash call held to its plain version and every backward call to
    ``plain_backward`` (``ShadowedTrain``); a profiled step; the mesh
    refusal.  Launches exactly 48 flash (24 + 24 recomputed) and 24
    backward a forward pass."""
    import shutil

    from repro_torch.checkpoint import disk
    from repro_torch.configs import get
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.models.init import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.training.train import (TrainConfig, make_train_step,
                                            train_step)
    release()
    tc = TrainConfig(AdamWConfig(lr=1e-3, warmup_steps=2,
                                 total_steps=TRAIN_STEPS))
    refuse_mesh(tc)
    cfg = get("llama-1.5b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED),
                         device="cuda")
    opt = init_opt_state(params)
    torch.cuda.synchronize()
    log(f"train: {cfg.name} at full width and depth ({cfg.num_layers} "
        f"layers, {cfg.param_count() / 1e9:.3f}B params bf16 from seed "
        f"{SEED}, AdamW moments f32; "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB on the card), "
        f"initialised in {time.perf_counter() - t0:.2f} s; batches "
        f"{TRAIN_ROWS} x {TRAIN_SEQ} tokens from Pipeline, remat on ({gpu_line()})")
    zero_counts()
    B, S, L = TRAIN_ROWS, TRAIN_SEQ, cfg.num_layers
    pipe = Pipeline(DataConfig(cfg.vocab_size, S, B))
    step = make_train_step(cfg, tc)
    ckdir = str(Path(__file__).resolve().parent / "build" / "train_ckpt")
    shutil.rmtree(ckdir, ignore_errors=True)
    passes, walls = 0, []
    for i in range(TRAIN_STEPS):
        if i == TRAIN_RESTART:
            t = time.perf_counter()
            disk.save(ckdir, i, {"params": params, "opt": opt})
            nbytes = sum(a.numel() * a.element_size()
                         for a in leaves({"p": params, "o": opt}))
            log(f"train: checkpoint of step {i} saved: {nbytes} bytes in "
                f"{time.perf_counter() - t:.2f} s (host seconds)")
        params, opt, m, wall = timed_step(step, params, opt,
                                          train_batch(pipe, i))
        passes += 1
        walls.append(wall)
        train_line("train", i, m, wall, B * S)
    t = time.perf_counter()
    tree = disk.restore(ckdir, TRAIN_RESTART, {"params": params,
                                               "opt": opt})
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    p, o = tree["params"], tree["opt"]
    del tree
    for i in range(TRAIN_RESTART, TRAIN_STEPS):
        p, o, _ = step(p, o, train_batch(pipe, i))
        passes += 1
    same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
        leaves({"p": params, "o": opt}), leaves({"p": p, "o": o})))
    del p, o
    shutil.rmtree(ckdir, ignore_errors=True)
    if not same:
        raise AssertionError("train: the run from the step-5 checkpoint "
                             "differs from the uninterrupted run")
    log(f"train: restored step {TRAIN_RESTART} in {load_s:.2f} s and ran "
        f"steps {TRAIN_RESTART}-{TRAIN_STEPS - 1} again: params and AdamW "
        f"state equal the uninterrupted run's bit for bit")

    batch = train_batch(pipe, TRAIN_STEPS)
    p1, _, m1 = step(params, opt, batch)
    p2, _, _ = train_step(params, opt, batch, cfg=cfg, tcfg=TrainConfig(
        tc.optimizer, microbatches=2))
    passes += 3
    lr = float(m1["lr"])
    frac = micro_diff(p1, p2, lr)
    equal = sum(int((a == b).sum()) for a, b in zip(leaves(p1), leaves(p2)))
    big = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(leaves(p1), leaves(p2)))
    del p1, p2
    if frac > 1.0:
        raise AssertionError(f"train: microbatches=2 against 1 at {frac:.2f}"
                             " x the limit")
    log(f"train: microbatches=2 against 1 on batch {TRAIN_STEPS} (step "
        f"{TRAIN_STEPS + 1}, lr {lr:.3e}): max |dp| {big:.3e}, worst "
        f"element at {frac:.3f} x its limit (2 lr + one bf16 ulp of the "
        f"element), {equal / cfg.param_count():.4f} of the params equal")

    with ShadowedTrain() as shadow:
        step(params, opt, train_batch(pipe, TRAIN_STEPS + 1))
    passes += 1
    if (shadow.bwd, shadow.flash, shadow.recomputed, len(shadow.pending)) \
            != (L, 2 * L, L, 0):
        raise AssertionError(f"train: shadowed step saw {shadow.bwd} "
                             f"backward, {shadow.flash} flash calls, "
                             f"{shadow.recomputed} recomputes matched, "
                             f"{len(shadow.pending)} unmatched")
    log(f"train: one step with every flash call held to its plain version "
        f"({shadow.flash} calls, worst element at {shadow.worst:.3f} x its "
        f"limit), each of the {shadow.recomputed} remat recomputes equal to "
        f"its first pass bit for bit, and every backward call held to "
        f"plain_backward ({shadow.bwd} calls, worst element at "
        f"{shadow.bwd_worst:.3f} x its limit: 4 bf16 ulps of the terms it "
        f"sums and 2 fp32 ulps of those of the dot products dP and delta "
        f"in it; {shadow.bwd_part:.3f} x the bf16 rule alone)")

    batch = train_batch(pipe, TRAIN_STEPS + 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall, busy = profiled(lambda: step(params, opt, batch),
                          f"train step ({B} x {S} tokens)", 1)
    passes += 1
    peak = torch.cuda.max_memory_allocated()
    med = sorted(walls)[len(walls) // 2]
    log(f"train: step wall median {med * 1e3:.1f} ms over {len(walls)} "
        f"steps ({B * S / med:.0f} tokens/s); profiled {wall:.1f} ms wall, "
        f"{busy:.1f} ms busy ({100 - 100 * busy / wall:.1f}% idle), "
        f"{B * S / wall * 1e3:.0f} tokens/s, peak {peak / 1e9:.1f} GB "
        f"({gpu_line()})")
    counts = read_counts()
    check_train_launches("train", counts, L, passes)
    del params, opt, batch
    release()
    return counts


def run_train_whisper() -> dict:
    """whisper-base at full width and depth (6 encoder + 6 decoder
    layers, seed 0) through the train step: 4 rows of 1536 frames
    (``configs.inputs.batch_specs``) and 416 tokens (``Pipeline``), two
    steps, the second with every flash call and backward call checked
    (``ShadowedTrain``): the encoder's full mode and the cross shape (Sq
    416 over 1536) at D 64.  Launches exactly 36 flash (18 + 18
    recomputed) and 18 backward a step."""
    from repro_torch.configs import ShapeSpec, get
    from repro_torch.configs.inputs import batch_specs
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.models.init import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.training.train import TrainConfig, make_train_step
    release()
    cfg = get("whisper-base")
    params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED),
                         device="cuda")
    opt = init_opt_state(params)
    zero_counts()
    step = make_train_step(cfg, TrainConfig(AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)))
    frames = batch_specs(cfg, ShapeSpec("whisper", 1536, TRAIN_ROWS,
                                        "prefill"), concrete=True,
                         seed=SEED, device="cuda")["frames"]
    pipe = Pipeline(DataConfig(cfg.vocab_size, WHISPER_TOKENS, TRAIN_ROWS))
    layers = FrontTally("whisper", cfg).per_full
    for i in range(2):
        batch = {"frames": frames, **train_batch(pipe, i)}
        if i == 0:
            params, opt, m, wall = timed_step(step, params, opt, batch)
        else:
            with ShadowedTrain() as shadow:
                params, opt, m, wall = timed_step(step, params, opt, batch)
        train_line("train_whisper", i, m, wall,
                   TRAIN_ROWS * (WHISPER_TOKENS + frames.shape[1]))
    if (shadow.bwd, shadow.flash, shadow.recomputed, len(shadow.pending)) \
            != (layers, 2 * layers, layers, 0):
        raise AssertionError(f"train_whisper: shadowed step saw {shadow.bwd}"
                             f" backward, {shadow.flash} flash calls, "
                             f"{shadow.recomputed} recomputes matched, "
                             f"{len(shadow.pending)} unmatched")
    log(f"train_whisper: {cfg.name} ({TRAIN_ROWS} x 1536 frames, "
        f"{WHISPER_TOKENS} tokens): the second step's {shadow.flash} flash "
        f"calls (encoder full mode, causal, cross Sq {WHISPER_TOKENS} over "
        f"1536) at worst {shadow.worst:.3f} x their limit, "
        f"{shadow.recomputed} recomputes bit for bit, {shadow.bwd} backward "
        f"calls at worst {shadow.bwd_worst:.3f} x theirs "
        f"({shadow.bwd_part:.3f} x the bf16 rule alone)")
    counts = read_counts()
    check_train_launches("train_whisper", counts, layers, 2)
    del params, opt
    release()
    return counts


RWKV_TRAIN_LAYERS = 8     # rwkv6-7b's train depth on one card (of 32)
RWKV_TRAIN_STEPS = 3


def rwkv_train_config():
    """(rwkv6-7b at full width and ``RWKV_TRAIN_LAYERS`` of its 32
    layers, the full config).  Depth is what one card sets: the port's
    step is functional (the JAX step donates its state), so at the update
    the old and the new params and AdamW moments are alive together with
    the grads, 22 bytes a parameter (bf16 weights twice, f32 moments
    twice, bf16 grads), and AdamW's f32 temporaries of the largest leaf
    come on top (the stacked channel-mix ``wk``: layers x 4096 x 14336).
    At 16 layers (4.07B params) that is 89.5 GB before activations, at 12
    (3.19B) 70.2 GB plus ~11 GB of temporaries: neither fits the card's
    80 GB under the 72 GB this path allows itself.  8 layers (2.30B) is
    50.7 GB plus ~7 GB."""
    from repro_torch.configs import get
    from repro_torch.configs.base import BlockDef
    full = get("rwkv6-7b")
    return full.replace(blocks=(BlockDef(full.blocks[0].layers,
                                         repeats=RWKV_TRAIN_LAYERS),)), full


class ShadowedRwkv:
    """Within the block, every ``ops.rwkv6_scan`` call of a train step
    (each layer's forward and its remat recompute) is held to ``plain``
    on its own inputs, output and final state within ``RWKV_TOL`` x
    max(1, max |plain|) (the kernel phase's 5e-4 at unit scale, relative
    past it), and each recompute to its first pass bit for bit; every
    backward call (``rwkv6_scan.backward_kernel``, which ``RWKV6Scan``
    looks up at each call) to ``plain_backward`` by ``rwkv_bwd_err``'s
    rule on its own inputs, the forward kernel's chunk-start states
    among them, after those states are held to ``plain_states`` per chunk
    (``rs.states_error``: ``RWKV_TOL`` x max(1, the chunk's max |plain|),
    state0 being the kernel's first state, which the kernel phase holds
    to state0 bit for bit).  ``calls``, ``worst``, ``recomputed``,
    ``pending``, ``bwd``, ``bwd_worst`` and ``states_worst`` are
    kept."""

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.kernels import rwkv6_scan as rs
        self.ops, self.rs = ops, rs
        self.orig, self.bwd_kernel = ops.rwkv6_scan, rs.backward_kernel
        ops.rwkv6_scan, rs.backward_kernel = self.forward, self.backward
        self.calls = self.recomputed = self.bwd = 0
        self.worst = self.bwd_worst = self.states_worst = 0.0
        self.pending = []       # ((r, k, v, w), out) of first-pass calls
        return self

    def __exit__(self, *exc):
        self.ops.rwkv6_scan = self.orig
        self.rs.backward_kernel = self.bwd_kernel

    def forward(self, r, k, v, w, u, state0, *, chunk=64):
        out, sT = self.orig(r, k, v, w, u, state0, chunk=chunk)
        with torch.no_grad():
            ref, s_ref = self.rs.plain(r, k, v, w, u, state0, chunk=chunk)
            top = max(1.0, float(ref.abs().max()), float(s_ref.abs().max()))
            frac = max(max_err(out, ref), max_err(sT, s_ref)) / (
                RWKV_TOL * top)
        del ref, s_ref
        self.calls += 1
        self.worst = max(self.worst, frac)
        if not torch.isfinite(out).all() or frac > 1.0:
            raise AssertionError(f"rwkv6_scan in the train step: {frac:.2f} "
                                 "x its limit against plain")
        ins = (r, k, v, w)
        for i, (fins, fout) in enumerate(self.pending):
            if all(a.shape == b.shape and torch.equal(a, b)
                   for a, b in zip(fins, ins)):
                if not torch.equal(fout, out):
                    raise AssertionError("rwkv6_scan: the remat recompute "
                                         "gave other bits than the first "
                                         "pass")
                self.recomputed += 1
                del self.pending[i]
                return out, sT
        self.pending.append((tuple(t.detach().clone() for t in ins),
                             out.detach().clone()))
        return out, sT

    def backward(self, r, k, v, w, u, states, dy, dS_T, *, chunk):
        with torch.no_grad():
            s_frac = self.rs.states_error(states, r, k, v, w, chunk=chunk,
                                          tol=RWKV_TOL)
        self.states_worst = max(self.states_worst, s_frac)
        if s_frac > 1.0:
            raise AssertionError(f"rwkv6_scan in the train step: the "
                                 f"chunk-start states at {s_frac:.2f} x "
                                 f"their limit against plain_states")
        grads = self.bwd_kernel(r, k, v, w, u, states, dy, dS_T, chunk=chunk)
        with torch.no_grad():
            _, frac, worst = rwkv_bwd_err(
                self.rs, grads, (r, k, v, w, u, states[:, :, 0]), dy, dS_T,
                chunk, states)
        self.bwd += 1
        self.bwd_worst = max(self.bwd_worst, frac)
        if frac > 1.0:
            raise AssertionError(f"rwkv6_scan_bwd in the train step: "
                                 f"{frac:.2f} x its limit against "
                                 f"plain_backward ({worst})")
        return grads


def run_train_rwkv() -> dict:
    """rwkv6-7b at full width (d_model 4096, 64 heads of 64, d_ff 14336,
    V 65536) and ``RWKV_TRAIN_LAYERS`` of its 32 layers
    (``rwkv_train_config`` says why; bf16, seed 0, AdamW moments f32)
    through ``training.train``'s step with remat, chunk 8, on
    ``Pipeline(DataConfig(65536, 1536, 4))`` batches: three steps, each
    finite; one batch's gradients computed twice, bit-equal; one step
    with every scan held to ``plain``, each remat recompute to its first
    pass and every backward call to ``plain_backward``
    (``ShadowedRwkv``); a profiled step with its peak memory.  Launches
    exactly L rwkv6_scan forward + L recomputed and L rwkv6_scan_bwd a
    forward pass, for L layers, and no other kernel."""
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.models.init import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.training.train import (TrainConfig, grads_fn,
                                            make_train_step)
    release()
    cfg, full = rwkv_train_config()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED),
                         device="cuda")
    opt = init_opt_state(params)
    torch.cuda.synchronize()
    log(f"train_rwkv: {cfg.name} at full width, {cfg.num_layers} of "
        f"{full.num_layers} layers ({cfg.param_count() / 1e9:.3f}B params "
        f"bf16 from seed {SEED}, AdamW moments f32; "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB on the card), "
        f"initialised in {time.perf_counter() - t0:.2f} s; batches "
        f"{TRAIN_ROWS} x {TRAIN_SEQ} tokens from Pipeline, chunk 8, remat on "
        f"({gpu_line()})")
    zero_counts()
    B, S, L = TRAIN_ROWS, TRAIN_SEQ, cfg.num_layers
    pipe = Pipeline(DataConfig(cfg.vocab_size, S, B))
    tc = TrainConfig(AdamWConfig(lr=1e-3, warmup_steps=2,
                                 total_steps=TRAIN_STEPS))
    step = make_train_step(cfg, tc)
    passes, walls = 0, []
    for i in range(RWKV_TRAIN_STEPS):
        params, opt, m, wall = timed_step(step, params, opt,
                                          train_batch(pipe, i))
        passes += 1
        walls.append(wall)
        train_line("train_rwkv", i, m, wall, B * S)

    batch = train_batch(pipe, RWKV_TRAIN_STEPS)
    g1, l1, _ = grads_fn(params, batch, cfg, tc)
    g2, l2, _ = grads_fn(params, batch, cfg, tc)
    passes += 2
    finite = all(bool(torch.isfinite(a).all()) for a in leaves(g1))
    same = torch.equal(l1, l2) and all(
        torch.equal(a, b) for a, b in zip(leaves(g1), leaves(g2)))
    del g1, g2
    if not (finite and same):
        raise AssertionError(f"train_rwkv: one batch's gradients twice: "
                             f"finite {finite}, bit-equal {same}")
    log(f"train_rwkv: one batch's gradients computed twice: finite and "
        f"bit-equal (loss {float(l1):.6f} both times)")

    with ShadowedRwkv() as shadow:
        params, opt, m, wall = timed_step(
            step, params, opt, train_batch(pipe, RWKV_TRAIN_STEPS + 1))
    passes += 1
    train_line("train_rwkv", RWKV_TRAIN_STEPS + 1, m, wall, B * S)
    if (shadow.calls, shadow.recomputed, len(shadow.pending), shadow.bwd) \
            != (2 * L, L, 0, L):
        raise AssertionError(f"train_rwkv: shadowed step saw {shadow.calls} "
                             f"scans, {shadow.recomputed} recomputes "
                             f"matched, {len(shadow.pending)} unmatched, "
                             f"{shadow.bwd} backward calls")
    log(f"train_rwkv: one step with every rwkv6_scan call held to plain "
        f"({shadow.calls} calls, worst at {shadow.worst:.3f} x its limit: "
        f"{RWKV_TOL} x max(1, max |plain|)), each of the "
        f"{shadow.recomputed} remat recomputes equal to its first pass bit "
        f"for bit, and every backward call held to plain_backward "
        f"({shadow.bwd} calls, worst leaf at {shadow.bwd_worst:.3f} x its "
        f"limit) on the forward kernel's chunk-start states, each held to "
        f"plain_states first (worst chunk at {shadow.states_worst:.3e} x "
        f"{RWKV_TOL} x max(1, the chunk's max |plain|))")

    batch = train_batch(pipe, RWKV_TRAIN_STEPS + 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall, busy = profiled(lambda: step(params, opt, batch),
                          f"train_rwkv step ({B} x {S} tokens)", 1)
    passes += 1
    peak = torch.cuda.max_memory_allocated()
    med = sorted(walls)[len(walls) // 2]
    log(f"train_rwkv: step wall median {med * 1e3:.1f} ms over {len(walls)} "
        f"steps ({B * S / med:.0f} tokens/s); profiled {wall:.1f} ms wall, "
        f"{busy:.1f} ms busy ({100 - 100 * busy / wall:.1f}% idle), "
        f"{B * S / wall * 1e3:.0f} tokens/s, peak {peak / 1e9:.1f} GB "
        f"({gpu_line()})")
    counts = read_counts()
    want = {"rwkv6_scan": 2 * L * passes, "rwkv6_scan_bwd": L * passes}
    got = {k: n for k, n in counts.items() if n or k in want}
    if got != want:
        raise AssertionError(f"train_rwkv launch counts {got}: need {want} "
                             f"({L} layers x {passes} forward passes)")
    log(f"train_rwkv: launches rwkv6_scan={want['rwkv6_scan']} ({L} x "
        f"{passes} forward passes, each with its remat recompute), "
        f"rwkv6_scan_bwd={want['rwkv6_scan_bwd']} ({L} x {passes}), no "
        f"other kernel, exactly")
    del params, opt, batch
    release()
    return counts


# the float32 mixer gradient leaf's limit against float64 copies,
# relative to its max: max(floor, factor x the float64 call's move under
# a one-ulp float32 input nudge)
JAMBA_GRAD_RULE = (2.0 ** -16, 16)


def run_train_jamba() -> dict:
    """jamba-v0.1-52b's mamba mixer at full width (d_model 4096, d_inner
    8192, d_state 16, d_conv 4; bf16 weights from seed 0) through
    ``mamba_parallel``'s forward and autograd's backward on B=4 x T=1536
    tokens (a unit-normal input rounded to bf16, a unit-normal upstream
    gradient), in bf16 and again on float32 copies, each against the same
    call on float64 copies on the card (which keeps the reference's f32
    casts: dt, B, C and the recurrence).  Every output and gradient of
    each call is finite.  The float32 call's gradients are held, per leaf
    (the weights' and the input's), relative to the float64 call's max
    |grad|: within max(2^-16, 16 x ``sens``) (``JAMBA_GRAD_RULE``), where
    ``sens`` is how far the float64 call's gradient moves when its input
    moves by one float32 ulp (a seeded coin an element).  The bf16
    call's distance from float64, and its ``sens`` under a one-ulp bf16
    nudge, are reported, not held: the random-init mixer is
    ill-conditioned (dt reaches hundreds through softplus), and at full
    width on an H100 a one-ulp bf16 nudge of the input moved the float64
    gradients by 1.0-1.3 of their max, so no rule built on it could tell
    a wrong bf16 gradient from a right one; in float32 the nudge moved
    them by 2.1e-7 to 6.2e-4 of their max.  The float32 call rounds at
    tens of places (the 1536-step recurrence among them), each a
    perturbation like the one nudge, and read 3.4-6.8 x ``sens`` on the
    card: hence 16.  Wall and peak printed.  A whole jamba train step is not run: one repeat
    of its block does not fit the card (the first line says by how
    much).  No kernel launches: the scan is plain torch, as in the
    reference."""
    from repro_torch.configs import get
    from repro_torch.configs.base import BlockDef, LayerSpec
    from repro_torch.models import mamba
    from repro_torch.models.init import init_params
    release()
    zero_counts()
    full = get("jamba-v0.1-52b")
    one = full.replace(blocks=(BlockDef(full.blocks[0].layers, repeats=1),))
    n1 = one.param_count()
    log(f"train_jamba: a full-width {full.name} train step does not fit "
        f"one card: one repeat of its block (8 layers: 4 mamba, 4 MoE of "
        f"{full.moe.num_experts} experts of 4096 x {full.moe.d_expert}, one "
        f"attention) is {n1 / 1e9:.2f}B params, {12 * n1 / 1e9:.0f} GB at "
        f"12 bytes a param (bf16 weights and grads, f32 AdamW moments) "
        f"before activations, against the card's 80 GB; its mamba mixer "
        f"runs here alone, forward and backward")
    cfg = full.replace(blocks=(BlockDef((LayerSpec("mamba", "dense"),),
                                        repeats=1),))
    p = {k: v[0] for k, v in init_params(
        cfg, torch.Generator("cuda").manual_seed(SEED),
        device="cuda")["blocks"][0][0]["mamba"].items() if k != "ln"}
    release()
    gen = torch.Generator("cuda").manual_seed(SEED)
    B, T = TRAIN_ROWS, TRAIN_SEQ
    x = torch.randn((B, T, cfg.d_model), generator=gen,
                    device="cuda").bfloat16()
    g = torch.randn((B, T, cfg.d_model), generator=gen, device="cuda")
    up = torch.rand(x.shape, generator=gen, device="cuda") < 0.5

    def nudged(dtype):
        """x moved by one ulp of ``dtype``, up or down by the coin."""
        xd = x.to(dtype)
        inf = torch.full_like(xd, float("inf"))
        return torch.nextafter(xd, torch.where(up, inf, -inf))

    def run(dtype, xx):
        ps = {k: v.to(dtype).requires_grad_() for k, v in p.items()}
        xs = xx.to(dtype).requires_grad_()
        release()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        out, _, _ = mamba.mamba_parallel(ps, xs, cfg)
        torch.cuda.synchronize()
        fwd = time.perf_counter() - t
        grads = torch.autograd.grad((out.float() * g).sum(),
                                    [*ps.values(), xs])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() - base
        finite = bool(torch.isfinite(out).all()) and all(
            bool(torch.isfinite(a).all()) for a in grads)
        if not finite:
            raise AssertionError(f"train_jamba: a non-finite output or "
                                 f"gradient in the {dtype} call")
        return dict(zip([*ps, "x"], grads)), fwd, wall, peak

    ref, fwd64, wall64, peak64 = run(torch.float64, x)
    lines = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        got, fwd, wall, peak = run(dtype, x)
        moved = run(torch.float64, nudged(dtype))[0]
        worst, parts = 0.0, []
        floor, factor = JAMBA_GRAD_RULE
        for k in ref:
            top = max(float(ref[k].abs().max()), 1e-300)
            err = float((got[k].double() - ref[k]).abs().max()) / top
            sens = float((moved[k] - ref[k]).abs().max()) / top
            worst = max(worst, err / max(floor, factor * sens))
            parts.append(f"{k} {err:.2e} (sens {sens:.2e})")
        del got, moved
        held = dtype == torch.float32
        if held and worst > 1.0:
            raise AssertionError(f"train_jamba: a {name} gradient at "
                                 f"{worst:.2f} x its limit against float64: "
                                 f"{'; '.join(parts)}")
        verdict = (f"within max({floor:.3g}, {factor} x sens) of its leaf's "
                   f"max |grad| of float64 copies, worst at {worst:.3f} x "
                   f"its limit" if held else
                   "against float64 copies reported, not held (a one-ulp "
                   "bf16 nudge moves the float64 gradients by about their "
                   "own size at this init)")
        lines.append(
            f"train_jamba: mamba_parallel at full width (d_inner "
            f"{cfg.d_inner}, d_state {cfg.mamba_d_state}, d_conv "
            f"{cfg.mamba_d_conv}), B={B} T={T}, {name}: forward "
            f"{fwd * 1e3:.1f} ms, forward + backward {wall * 1e3:.1f} ms "
            f"wall, peak {peak / 1e9:.2f} GB above the weights; every grad "
            f"finite; {verdict} (error relative to the leaf's max, and "
            f"sens: the float64 gradient's move under a one-ulp {name} "
            f"input nudge: {'; '.join(parts)})")
    for ln in lines:
        log(ln)
    log(f"train_jamba: the float64 call {wall64 * 1e3:.1f} ms, peak "
        f"{peak64 / 1e9:.2f} GB ({gpu_line()})")
    del ref, p, x, g, up
    release()
    return read_counts()


def main() -> int:
    if sys.argv[1:2] == ["--train-100m"]:
        return train_100m_child(sys.argv[2:])
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
        if name in ("int8_matmul", "rwkv6_scan", "spec_verify",
                    "flash_attention_bwd", "rwkv6_scan_bwd"):
            continue      # their checks print them, by kernel
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"build: {name}: {ln.strip()}")

    gen = torch.Generator("cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    zero_counts()
    rows = [
        check_flash(fa, gen), check_flash_bwd(fa, gen), check_paged(da, gen),
        check_decode(da, gen),
        check_spec(sv, gen), check_rwkv6(rs, gen), check_int8(im, gen)]
    bwd_row, chunk8 = check_rwkv6_bwd(rs, gen)
    rows[5]["cases"] = [chunk8]
    rows.insert(6, bwd_row)
    # the other models' shapes (head dims 160 and 256, G 4 and 6, full
    # mode, D 64, a cross cache): each case in its kernel's row
    for row, wide in zip((rows[0], *rows[2:]), (
            wide_flash(fa, gen), wide_paged(da, gen), wide_decode(da, gen))):
        row["cases"] = wide
        row["max_abs_err"] = max([row["max_abs_err"]]
                                 + [c["max_abs_err"] for c in wide])
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
    t0 = time.perf_counter()
    from repro_torch.optim.compression import int8_round_trip
    lite = int8_round_trip(params)
    mini_cfg = mini_config(cfg)
    mini = init_params(mini_cfg, torch.Generator("cuda").manual_seed(9),
                       device="cuda")
    torch.cuda.synchronize()
    log(f"fleet: lite tier (int8 round trip of seed {SEED}) and mini tier "
        f"({mini_cfg.num_layers} layers, {mini_cfg.param_count() / 1e9:.3f}"
        f"B params, seed 9) built in {time.perf_counter() - t0:.2f} s")
    drive("fleet", run_fleet, cfg, params, lite, mini_cfg, mini)
    drive("replicate", run_replicate, cfg, params, lite, mini_cfg, mini)
    del draft, lite, mini
    torch.cuda.empty_cache()
    drive("service", run_service, cfg, params)
    drive("autoscale", run_autoscale, cfg, params)
    drive("cli", run_cli)
    release()
    drive("examples", run_examples, cfg, params)
    release()
    drive("roofline", run_roofline, cfg, params)
    del params
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
    del rparams
    torch.cuda.empty_cache()
    drive("families", run_families)
    drive("jamba", run_jamba)
    drive("whisper", run_whisper)
    drive("internvl", run_internvl)
    drive("train", run_train)
    drive("train_whisper", run_train_whisper)
    drive("train_rwkv", run_train_rwkv)
    drive("train_jamba", run_train_jamba)
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
