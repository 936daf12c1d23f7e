"""stablelm-12b [dense]: 40L d=5120 32H (GQA kv=8) ff=13824 V=100352.

[hf:stabilityai/stablelm-2-1_6b family; hf].  Full attention, qk-norm,
head dim 160."""

from repro_torch.configs.base import (BlockDef, LayerSpec, ModelConfig,
                                      register)

CONFIG = register(
    ModelConfig(
        name="stablelm-12b",
        family="dense",
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=160,
        d_ff=13824,
        vocab_size=100352,
        qk_norm=True,
        blocks=(BlockDef((LayerSpec("attn", "dense"),), repeats=40),),
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_notes=(("long_500k", "pure full attention: 500k decode KV is "
                 "unbounded; sub-quadratic archs only"),),
)
