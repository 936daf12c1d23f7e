"""Model configuration dataclasses and the arch registry.

A model is a ``ModelConfig`` built from ``BlockDef``s: a block is a short
run of layers that repeats ``repeats`` times.  Parameters and caches are
stacked per block position over ``repeats`` (the layout the JAX package
uses, so parameter trees carry across leaf by leaf); the model runs the
repeats as a Python loop.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

MIXERS = ("attn", "local", "rwkv", "mamba", "none")
FFNS = ("dense", "moe", "none")


@dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_expert: int
    num_shared: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"          # attn | local | rwkv | mamba | none
    ffn: str = "dense"           # dense | moe | none
    window: int = 0              # sliding window size for mixer == "local"

    def __post_init__(self):
        if self.mixer not in MIXERS:
            raise ValueError(f"unknown mixer {self.mixer!r}")
        if self.ffn not in FFNS:
            raise ValueError(f"unknown ffn {self.ffn!r}")


@dataclass(frozen=True)
class BlockDef:
    layers: tuple[LayerSpec, ...]
    repeats: int = 1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | ssm | moe | hybrid | vlm | audio
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    blocks: tuple[BlockDef, ...]
    moe: Optional[MoESpec] = None

    # attention details
    rope_theta: float = 10000.0
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    norm_eps: float = 1e-6
    act: str = "silu"                  # gated-MLP activation: silu | gelu
    qk_norm: bool = False

    # ssm details
    rwkv_head_dim: int = 64
    rwkv_lora: int = 64
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # encoder-decoder
    encoder_blocks: tuple[BlockDef, ...] = ()
    decoder_len: int = 0
    cross_attention: bool = False

    # vlm stub patch positions
    num_patches: int = 0

    # misc
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 1024
    tie_embeddings: bool = False
    max_position: int = 1 << 20
    sharding_overrides: tuple[tuple[str, object], ...] = ()

    @property
    def num_layers(self) -> int:
        return sum(len(b.layers) * b.repeats for b in self.blocks)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def layer_specs(self) -> list[LayerSpec]:
        out = []
        for b in self.blocks:
            out.extend(list(b.layers) * b.repeats)
        return out

    def param_count(self) -> int:
        """Analytic parameter count (excludes any padding)."""
        from repro_torch.models import schema  # lazy: avoids import cycle
        return sum(math.prod(pd.shape)
                   for _, pd in schema.flatten(schema.model_schema(self)))

    def active_param_count(self) -> int:
        """Per-token active params (MoE: routed top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        from repro_torch.models import schema
        total = 0
        for path, pd in schema.flatten(schema.model_schema(self)):
            n = math.prod(pd.shape)
            # routed expert weights live at ...['moe']['w_*'], not shared
            if ("moe" in path and "shared" not in path
                    and path[-1] in ("w_gate", "w_up", "w_down")):
                n = n * self.moe.top_k // self.moe.num_experts
            total += n
        return total

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, "ArchEntry"] = {}


@dataclass(frozen=True)
class ArchEntry:
    config: ModelConfig
    shapes: tuple[str, ...]
    skip_notes: tuple[tuple[str, str], ...] = ()

    @property
    def notes(self) -> dict:
        return dict(self.skip_notes)


def register(config: ModelConfig, shapes: tuple[str, ...],
             skip_notes: tuple[tuple[str, str], ...] = ()) -> ModelConfig:
    _REGISTRY[config.name] = ArchEntry(config, shapes, skip_notes)
    return config


def get(name: str) -> ModelConfig:
    _load_all()
    return _REGISTRY[name].config


def entry(name: str) -> ArchEntry:
    _load_all()
    return _REGISTRY[name]


def names() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


def _load_all():
    # import every ported config module so it registers itself
    import importlib
    for mod in ("llama_1p5b", "rwkv6_7b"):
        importlib.import_module(f"repro_torch.configs.{mod}")
