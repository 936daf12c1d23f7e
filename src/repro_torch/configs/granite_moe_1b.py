"""granite-moe-1b-a400m [moe]: 24L d=1024 16H (GQA kv=8) V=49155.

32 experts top-8, d_expert=512, tied embeddings
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].  Full attention."""

from repro_torch.configs.base import (BlockDef, LayerSpec, ModelConfig,
                                      MoESpec, register)

CONFIG = register(
    ModelConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        head_dim=64,
        d_ff=512,
        vocab_size=49155,
        tie_embeddings=True,
        moe=MoESpec(num_experts=32, top_k=8, d_expert=512),
        blocks=(BlockDef((LayerSpec("attn", "moe"),), repeats=24),),
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_notes=(("long_500k", "pure full attention"),),
)
