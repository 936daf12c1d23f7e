"""Roofline terms for one H100: the port's counterpart of the JAX
package's ``launch/roofline.py`` (a TPU v5e pod).

    compute term    = FLOPs / peak bf16 FLOP/s
    memory term     = bytes / HBM bandwidth
    collective term = 0 (one card: no interconnect)

FLOPs and bytes come from ``launch/op_analysis.py``: one run of the step
on the ``meta`` device, every aten op counted outside the kernels and
every kernel call counted as one unit by its formula below.  The
constants are the H100 SXM data sheet's (``launch/mesh.py``).

The kernel formulas are the ones ``chip_smoke.py`` bounds each kernel
with: FLOPs, and the bytes of each input read once and each output
written once.  Where the work depends on the data (the live pages of a
paged table, the valid slots of a dense cache, the drafts a verify
reads), the caller passes what its data needs; an op analysis, which
sees shapes only, passes every slot live and every draft read.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

from repro_torch.launch.mesh import (HBM_BW, MESH_NAME, PEAK_BF16_FLOPS,
                                     PEAK_F32_FLOPS)

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops: float                 # counted FLOPs of the step
    hbm_bytes: float             # counted HBM bytes of the step
    coll_bytes: float            # 0: one card
    coll_breakdown: dict
    peak_memory_bytes: float
    model_flops: float           # 6*N*D (train) / 2*N_active*tokens
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0

    def finalize(self) -> "Roofline":
        self.compute_s = self.flops / PEAK_BF16_FLOPS
        self.memory_s = self.hbm_bytes / HBM_BW
        self.collective_s = 0.0
        return self

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    model_bytes: float = 0.0     # analytic minimal HBM stream

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs: remat and padding waste."""
        return self.model_flops / max(self.flops, 1.0)

    @property
    def useful_bytes_ratio(self) -> float:
        return self.model_bytes / max(self.hbm_bytes, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """useful-time / bound-time: the larger of the model FLOPs at
        peak and the minimal HBM stream at full bandwidth, over the
        larger term of the counted step."""
        useful_s = max(self.model_flops / PEAK_BF16_FLOPS,
                       self.model_bytes / HBM_BW)
        return useful_s / max(self.bound_s, 1e-12)

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(dominant=self.dominant,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction,
                 bound_s=self.bound_s)
        return d


def model_flops(cfg, shape, n_params: int, n_active: int) -> float:
    """Useful-work FLOPs for the cell."""
    toks = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                 else 1)
    if shape.kind == "train":
        total = 6.0 * n_active * toks
    else:
        total = 2.0 * n_active * toks
    return total


def model_bytes(cfg, shape, n_params: int, n_active: int,
                chips: int = 1, tp: int = 1) -> float:
    """Analytic minimal per-device HBM stream for the cell (the memory-
    roofline floor), the JAX package's envelope with its tensor-parallel
    degree ``tp`` and device count ``chips`` as parameters (JAX fixes
    ``tp`` at 16; one card is ``tp=1, chips=1``):

      weights : active params, bf16, one read per step, 1/tp of them
      caches  : decode reads its cache shard once; prefill writes it once
      acts    : train/prefill stream each activation slab a handful of
                times (fwd + remat + bwd ~ 3 passes x ~(4d+2ff_eff)
                bytes/token/layer); decode activations are negligible"""
    w = 2.0 * n_active / tp
    mesh_div = chips
    toks_dev = shape.global_batch * shape.seq_len / mesh_div
    L = max(cfg.num_layers, 1)
    if cfg.moe is not None:
        ff_eff = cfg.moe.top_k * cfg.moe.d_expert \
            + cfg.moe.num_shared * cfg.moe.d_expert
    else:
        ff_eff = cfg.d_ff
    act_per_tok_layer = 2.0 * (4 * cfg.d_model + 2 * ff_eff)
    # full-length KV for "attn" layers, window-bounded for "local", O(1)
    # recurrent state for rwkv/mamba
    S, B = shape.seq_len, shape.global_batch
    cache = 0.0
    for ls in cfg.layer_specs():
        if ls.mixer == "attn":
            cache += 2.0 * B * S * cfg.num_kv_heads * cfg.head_dim * 2
        elif ls.mixer == "local":
            cache += 2.0 * B * min(ls.window, S) \
                * cfg.num_kv_heads * cfg.head_dim * 2
        elif ls.mixer == "rwkv":
            cache += 4.0 * B * cfg.rwkv_heads * cfg.rwkv_head_dim ** 2
        elif ls.mixer == "mamba":
            cache += 4.0 * B * cfg.d_inner * (cfg.mamba_d_state
                                              + cfg.mamba_d_conv)
    if cfg.cross_attention:
        cache += 2.0 * B * S * cfg.num_kv_heads * cfg.head_dim * 2 \
            * sum(b.repeats * len(b.layers) for b in cfg.blocks)
    cache /= mesh_div
    if shape.kind == "train":
        return w + 3.0 * toks_dev * L * act_per_tok_layer
    if shape.kind == "prefill":
        return w + toks_dev * L * act_per_tok_layer + cache
    return w + cache


def from_cost(cost, *, arch, shape_name, cfg, shape, n_params,
              n_active) -> Roofline:
    """The roofline of an op analysis' ``Cost`` (the counterpart of the
    JAX ``extract`` over a compiled module)."""
    return Roofline(
        arch=arch, shape=shape_name, mesh=MESH_NAME, flops=cost.flops,
        hbm_bytes=cost.bytes, coll_bytes=0.0,
        coll_breakdown={**dict.fromkeys(COLLECTIVES, 0.0), "total": 0.0},
        peak_memory_bytes=float(cost.peak_bytes),
        model_flops=model_flops(cfg, shape, n_params, n_active),
        model_bytes=model_bytes(cfg, shape, n_params, n_active)).finalize()


# ---------------------------------------------------------------------------
# the kernels' costs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class KernelCost:
    """A kernel call's FLOPs, its bytes (each input read once, each
    output written once) and the peak its operations run at."""
    flops: float
    bytes: float
    peak: float = PEAK_BF16_FLOPS

    def bound(self) -> tuple[float, str]:
        """(the least time in ms the card could take, what bounds it:
        "operations" or "bytes")."""
        tf, tb = self.flops / self.peak * 1e3, self.bytes / HBM_BW * 1e3
        return (tf, "operations") if tf >= tb else (tb, "bytes")


def band_pairs(S: int, window: int) -> int:
    """(query, key) pairs of causal attention over S tokens, within
    ``window`` keys of the query when there is one."""
    if not window:
        return S * (S + 1) // 2
    w = min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def _pairs(Sq, Skv, causal, window) -> int:
    return band_pairs(Sq, window) if causal else Sq * Skv


def flash_cost(B, Sq, Skv, H, KV, D, *, causal=True, window=0) -> KernelCost:
    """The forward: QK^T and PV over the attended pairs; q, k, v read and
    o written in bf16."""
    flops = 4 * B * H * D * _pairs(Sq, Skv, causal, window)
    return KernelCost(flops, 2 * B * D * (2 * Sq * H + 2 * Skv * KV))


def flash_bwd_cost(B, Sq, Skv, H, KV, D, *, causal=True,
                   window=0) -> KernelCost:
    """The backward: 2.5x the forward's products (S, dP, dV, dK, dQ);
    q, k, v, o, dO read, dQ, dK, dV written in bf16, the fp32 LSE read."""
    flops = 2.5 * 4 * B * H * D * _pairs(Sq, Skv, causal, window)
    return KernelCost(flops, 2 * B * D * (4 * Sq * H + 4 * Skv * KV)
                      + 4 * B * H * Sq)


def paged_decode_cost(B, H, KV, D, slots, valid, table) -> KernelCost:
    """One token a row attending ``valid`` slots, reading the bf16 K and V
    of ``slots`` slots (whole live pages, or the window's slots); q read
    and o written, the ``table`` entries and the positions read."""
    return KernelCost(4 * H * D * valid,
                      2 * slots * KV * D * 2 + 2 * B * H * D * 2 + table * 4
                      + B * 4)


def decode_cost(B, H, KV, D, valid, slots=None) -> KernelCost:
    """One token a row over ``valid`` slots of a dense bf16 cache: their
    K and V read, the positions of ``slots`` slots (default ``valid``), q
    read and o written, the row positions read."""
    slots = valid if slots is None else slots
    return KernelCost(4 * H * D * valid,
                      2 * valid * KV * D * 2 + slots * 4 + 2 * B * H * D * 2
                      + B * 4)


def spec_accept_cost(g, V, n=None) -> KernelCost:
    """The acceptance rule over ``g`` drafts and a vocabulary of V: the
    tokens, uniforms and both token probabilities of the drafts up to the
    cut (min(n + 1, g) of each), row n of the target's probabilities (and
    of the draft's when n < g), the distribution written and n.  ``n``
    None: the most any cut reads (n = g - 1)."""
    n = g - 1 if n is None else n
    nbytes = 4 * 4 * min(n + 1, g) + (2 if n < g else 1) * V * 4 + V * 4 + 4
    return KernelCost(4 * min(n + 1, g) + 3 * V, nbytes)


def rwkv6_scan_cost(B, T, H, D, chunk, states=False) -> KernelCost:
    """The chunked scan in fp32 on the CUDA cores: per chunk of c rows
    and head rA S and (kA A_end)^T v (2 c D^2 each) and the strictly lower
    scores and their product with v (D c (c - 1) each); r, k, v, w, the
    state and u read, out and the final state written (and the
    chunk-start states with ``states``)."""
    c = min(chunk, T)
    NC = T // c
    flops = B * H * NC * (4 * c * D * D + 2 * D * c * (c - 1))
    nbytes = 4 * (5 * B * T * H * D + H * D + 2 * B * H * D * D)
    if states:
        nbytes += 4 * B * H * NC * D * D
    return KernelCost(flops, nbytes, PEAK_F32_FLOPS)


def rwkv6_scan_bwd_cost(B, T, H, D, chunk) -> KernelCost:
    """The scan's backward in fp32: per (b, h) chunk of c rows v dS^T,
    (kA E) dS, dy S^T and rA^T dy (c D^2 FMAs each), the five strictly
    lower c x c products (c (c-1) / 2 D each) and dE (D^2 + c D); r, k,
    v, w, dy, u, dS_T read, dr, dk, dv, dw, du, dstate0 written (the
    chunk-start states are read besides: not counted)."""
    c = min(chunk, T)
    fma = 4 * c * D * D + 5 * c * (c - 1) // 2 * D + D * D + c * D
    return KernelCost(2 * fma * B * H * (T // c),
                      4 * (9 * B * T * H * D + 2 * H * D + 2 * B * H * D * D),
                      PEAK_F32_FLOPS)


def int8_matmul_cost(M, K, N, x_bytes=2) -> KernelCost:
    """x (M, K) times int8 w (K, N) with fp32 scales: x, w and the scales
    read, the (M, N) output written in x's type."""
    return KernelCost(2 * M * K * N,
                      x_bytes * M * K + K * N + 4 * N + x_bytes * M * N)


KERNEL_COSTS = {
    "flash_attention": flash_cost,
    "flash_attention_bwd": flash_bwd_cost,
    "paged_decode_attention": paged_decode_cost,
    "decode_attention": decode_cost,
    "spec_accept": spec_accept_cost,
    "rwkv6_scan": rwkv6_scan_cost,
    "rwkv6_scan_bwd": rwkv6_scan_bwd_cost,
    "int8_matmul": int8_matmul_cost,
}


def kernel_cost(name: str, **shape) -> KernelCost:
    """The cost of one call of kernel ``name`` at ``shape``."""
    return KERNEL_COSTS[name](**shape)
