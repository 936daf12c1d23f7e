"""Parameter schema: single source of truth for shapes, logical sharding
axes and initializers.

``model_schema(cfg)`` returns a pytree of ``ParamDef`` mirroring the
runtime parameter pytree exactly.  From it we derive:
  * ``init.init_params``      -- materialized tensors
  * ``init.params_from_numpy`` -- the weight bridge's shape check
so shapes can never drift apart.  The logical sharding axes are kept
verbatim from the JAX package; the single-card port does not read them.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import BlockDef, LayerSpec, ModelConfig
from repro_torch.core.tree import flatten, tree_map  # noqa: F401


@dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]      # logical sharding axis per dim
    init: str = "normal"                 # normal|zeros|ones|mamba_A|uniform
    scale: float = 1.0                   # multiplier on the default stddev
    dtype: str = "bfloat16"

    def stacked(self, n: int) -> "ParamDef":
        return ParamDef((n,) + self.shape, ("stack",) + self.logical,
                        self.init, self.scale, self.dtype)


def _norm(cfg) -> dict:
    return {"scale": ParamDef((cfg.d_model,), ("embed",), "ones",
                              dtype="float32")}


def attention_schema(cfg: ModelConfig, cross: bool = False) -> dict:
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = {
        "ln": _norm(cfg),
        "wq": ParamDef((d, H, Dh), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, KV, Dh), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, KV, Dh), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((H, Dh, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = ParamDef((Dh,), (None,), "ones", dtype="float32")
        s["k_norm"] = ParamDef((Dh,), (None,), "ones", dtype="float32")
    if cross:
        s["ln_kv"] = _norm(cfg)
    return s


def mlp_schema(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {
        "ln": _norm(cfg),
        "w_gate": ParamDef((d, ff), ("embed", "mlp")),
        "w_up": ParamDef((d, ff), ("embed", "mlp")),
        "w_down": ParamDef((ff, d), ("mlp", "embed")),
    }


def moe_schema(cfg: ModelConfig) -> dict:
    d, m = cfg.d_model, cfg.moe
    E, dx = m.num_experts, m.d_expert
    s = {
        "ln": _norm(cfg),
        "router": ParamDef((d, E), ("embed", None), dtype="float32"),
        "w_gate": ParamDef((E, d, dx), ("experts", "embed", "expert_ff")),
        "w_up": ParamDef((E, d, dx), ("experts", "embed", "expert_ff")),
        "w_down": ParamDef((E, dx, d), ("experts", "expert_ff", "embed")),
    }
    if m.num_shared:
        # shared experts fused into one dense MLP of width num_shared*dx,
        # tensor-parallel on "mlp" like a dense FFN
        s["shared"] = {
            "w_gate": ParamDef((d, m.num_shared * dx), ("embed", "mlp")),
            "w_up": ParamDef((d, m.num_shared * dx), ("embed", "mlp")),
            "w_down": ParamDef((m.num_shared * dx, d), ("mlp", "embed")),
        }
    return s


def rwkv_schema(cfg: ModelConfig) -> dict:
    d, H, Dh, L = (cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim,
                   cfg.rwkv_lora)
    return {
        "ln": _norm(cfg),
        # data-dependent lerp (ddlerp): 5 mixes (w,k,v,r,g) = base + LoRA
        "mix_base": ParamDef((5, d), (None, "embed"), "zeros",
                             dtype="float32"),
        "mix_lora_A": ParamDef((d, 5 * L), ("embed", None), scale=0.1),
        "mix_lora_B": ParamDef((5, L, d), (None, "lora", "embed"), "zeros"),
        "mix_first": ParamDef((d,), ("embed",), "zeros", dtype="float32"),
        "wr": ParamDef((d, H, Dh), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, H, Dh), ("embed", "heads", "head_dim")),
        "wv": ParamDef((d, H, Dh), ("embed", "heads", "head_dim")),
        "wg": ParamDef((d, H, Dh), ("embed", "heads", "head_dim")),
        # data-dependent decay w_t: base + LoRA(x); init matches official
        # rwkv6 time_decay speeds (w ~= exp(-exp([-6,-1])) in [0.69, 1))
        "decay_base": ParamDef((H, Dh), ("heads", "head_dim"),
                               "rwkv_decay", dtype="float32"),
        "decay_lora_A": ParamDef((d, L), ("embed", "lora"), scale=0.1),
        "decay_lora_B": ParamDef((L, H, Dh), ("lora", "heads", "head_dim"),
                                 "zeros"),
        "bonus": ParamDef((H, Dh), ("heads", "head_dim"), "uniform",
                          dtype="float32"),
        "ln_x": ParamDef((H, Dh), ("heads", "head_dim"), "ones",
                         dtype="float32"),
        "wo": ParamDef((H, Dh, d), ("heads", "head_dim", "embed")),
    }


def rwkv_cm_schema(cfg: ModelConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "ln": _norm(cfg),
        "mix_k": ParamDef((d,), ("embed",), "zeros", dtype="float32"),
        "mix_r": ParamDef((d,), ("embed",), "zeros", dtype="float32"),
        "wk": ParamDef((d, ff), ("embed", "mlp")),
        "wv": ParamDef((ff, d), ("mlp", "embed")),
        "wr": ParamDef((d, d), ("embed", "inner")),
    }


def mamba_schema(cfg: ModelConfig) -> dict:
    d, di, st, dc = (cfg.d_model, cfg.d_inner, cfg.mamba_d_state,
                     cfg.mamba_d_conv)
    dt_rank = max(1, (d + 15) // 16)
    return {
        "ln": _norm(cfg),
        "in_proj": ParamDef((d, 2, di), ("embed", None, "inner")),
        "conv_w": ParamDef((dc, di), ("conv", "inner")),
        "conv_b": ParamDef((di,), ("inner",), "zeros"),
        "x_proj": ParamDef((di, dt_rank + 2 * st), ("inner", None)),
        "dt_proj": ParamDef((dt_rank, di), (None, "inner"), scale=0.1),
        "dt_bias": ParamDef((di,), ("inner",), "uniform", dtype="float32"),
        "A_log": ParamDef((di, st), ("inner", "state"), "mamba_A",
                          dtype="float32"),
        "D": ParamDef((di,), ("inner",), "ones", dtype="float32"),
        "out_proj": ParamDef((di, d), ("inner", "embed")),
    }


def layer_schema(cfg: ModelConfig, spec: LayerSpec,
                 cross: bool = False) -> dict:
    s: dict = {}
    if spec.mixer in ("attn", "local"):
        s["attn"] = attention_schema(cfg)
    elif spec.mixer == "rwkv":
        s["rwkv"] = rwkv_schema(cfg)
    elif spec.mixer == "mamba":
        s["mamba"] = mamba_schema(cfg)
    if cross:
        s["cross"] = attention_schema(cfg, cross=True)
    if spec.ffn == "dense":
        s["mlp"] = (rwkv_cm_schema(cfg) if spec.mixer == "rwkv"
                    else mlp_schema(cfg))
    elif spec.ffn == "moe":
        s["moe"] = moe_schema(cfg)
    return s


def block_group_schema(cfg: ModelConfig, block: BlockDef,
                       cross: bool = False) -> list:
    """Per-block-position param dicts, each stacked over ``repeats``."""
    def stack(tree):
        return tree_map(lambda pd: pd.stacked(block.repeats), tree)
    return [stack(layer_schema(cfg, ls, cross)) for ls in block.layers]


def model_schema(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    tree: dict = {
        "embed": ParamDef((cfg.padded_vocab, d), ("vocab", "embed"),
                          scale=1.0),
        "blocks": [block_group_schema(cfg, b, cross=cfg.cross_attention
                                      and not cfg.encoder_blocks is None
                                      and cfg.cross_attention)
                   for b in cfg.blocks],
        "final_norm": _norm(cfg),
    }
    # decoder blocks get cross-attention only when enc-dec
    if cfg.cross_attention:
        tree["blocks"] = [block_group_schema(cfg, b, cross=True)
                          for b in cfg.blocks]
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamDef((d, cfg.padded_vocab),
                                   ("embed", "vocab"))
    if cfg.encoder_blocks:
        tree["encoder"] = {
            "blocks": [block_group_schema(cfg, b, cross=False)
                       for b in cfg.encoder_blocks],
            "final_norm": _norm(cfg),
        }
    if cfg.num_patches:
        # VLM stub frontend: projection from precomputed patch embeddings
        tree["patch_proj"] = ParamDef((1024, d), (None, "embed"))
    return tree


def is_def(x) -> bool:
    return isinstance(x, ParamDef)
