"""gemma3-4b [dense]: 34L d=2560 8H (GQA kv=4) ff=10240 V=262144.

5:1 local:global attention, window 1024 [hf:google/gemma-3 family].
34 layers = 5 x (5 local + 1 global) + 4 local tail; qk-norm; head dim
256.  RoPE theta unified to one value (the released gemma3 uses 1M
global / 10k local)."""

from repro_torch.configs.base import (BlockDef, LayerSpec, ModelConfig,
                                      register)

_L = LayerSpec("local", "dense", window=1024)
_G = LayerSpec("attn", "dense")

CONFIG = register(
    ModelConfig(
        name="gemma3-4b",
        family="dense",
        d_model=2560,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=10240,
        vocab_size=262144,
        act="gelu",
        qk_norm=True,
        rope_theta=1_000_000.0,
        blocks=(BlockDef((_L, _L, _L, _L, _L, _G), repeats=5),
                BlockDef((_L, _L, _L, _L), repeats=1)),
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
