"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H (GQA kv=8) ff=14336 V=65536.

Mamba+attention 1:7 interleave, MoE 16 experts top-2 on every other
layer [arXiv:2403.19887; hf].  Jamba block = 8 layers with attention at
index 4 and MoE on odd indices; 4 repeats = 32 layers (4 attn, 16 MoE).
Only the attention layers hold KV; the mamba state is O(1): per layer a
(d_inner, d_state) fp32 SSM state and a (d_conv - 1, d_inner) conv
tail."""

from repro_torch.configs.base import (BlockDef, LayerSpec, ModelConfig,
                                      MoESpec, register)

_MD = LayerSpec("mamba", "dense")
_MM = LayerSpec("mamba", "moe")
_AD = LayerSpec("attn", "dense")

CONFIG = register(
    ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        moe=MoESpec(num_experts=16, top_k=2, d_expert=14336),
        blocks=(BlockDef((_MD, _MM, _MD, _MM, _AD, _MM, _MD, _MM),
                         repeats=4),),
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
