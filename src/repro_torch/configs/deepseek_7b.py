"""deepseek-7b [dense]: 30L d=4096 32H (MHA kv=32) ff=11008 V=102400.

llama-arch [arXiv:2401.02954; hf].  Full attention."""

from repro_torch.configs.base import (BlockDef, LayerSpec, ModelConfig,
                                      register)

CONFIG = register(
    ModelConfig(
        name="deepseek-7b",
        family="dense",
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        head_dim=128,
        d_ff=11008,
        vocab_size=102400,
        blocks=(BlockDef((LayerSpec("attn", "dense"),), repeats=30),),
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_notes=(("long_500k", "pure full attention"),),
)
