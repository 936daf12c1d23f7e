"""gemma2-27b [dense]: 46L d=4608 32H (GQA kv=16) ff=36864 V=256000.

Local (window 4096) and global attention layers alternating, attention
softcap 50, logit softcap 30, tanh-gelu gated MLP [arXiv:2408.00118;
hf].  On the port's dense engine the 23 local layers keep 4096-slot
ring buffers; the paged engine masks the window instead."""

from repro_torch.configs.base import (BlockDef, LayerSpec, ModelConfig,
                                      register)

CONFIG = register(
    ModelConfig(
        name="gemma2-27b",
        family="dense",
        d_model=4608,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        d_ff=36864,
        vocab_size=256000,
        act="gelu",
        attn_softcap=50.0,
        logit_softcap=30.0,
        blocks=(BlockDef((LayerSpec("local", "dense", window=4096),
                          LayerSpec("attn", "dense")), repeats=23),),
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
