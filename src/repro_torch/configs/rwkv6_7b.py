"""rwkv6-7b [ssm]: 32L d=4096 attention-free, ff=14336 V=65536.

Finch: data-dependent decay [arXiv:2404.05892; hf].  O(1) recurrent
state: a (64, 64) fp32 matrix per head and layer plus the previous
token's activations, in place of a KV cache."""

from repro_torch.configs.base import (BlockDef, LayerSpec, ModelConfig,
                                      register)

CONFIG = register(
    ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        d_model=4096,
        num_heads=64,            # rwkv heads = d_model / rwkv_head_dim
        num_kv_heads=64,
        head_dim=64,
        d_ff=14336,
        vocab_size=65536,
        rwkv_head_dim=64,
        blocks=(BlockDef((LayerSpec("rwkv", "dense"),), repeats=32),),
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
