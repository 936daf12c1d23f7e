"""llama-1.5b: the paper's own evaluation model (section 9.1: "LLM
inference using LLAMA with 1.5B parameters").  Llama architecture,
~1.5B params: 24 global-attention layers, GQA 16 q / 8 kv heads,
head_dim 128, gated silu MLP, vocab 32000 padded to 32768."""

from repro_torch.configs.base import (BlockDef, LayerSpec, ModelConfig,
                                      register)

CONFIG = register(
    ModelConfig(
        name="llama-1.5b",
        family="dense",
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=5632,
        vocab_size=32000,
        blocks=(BlockDef((LayerSpec("attn", "dense"),), repeats=24),),
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_notes=(("long_500k", "pure full attention"),),
)
