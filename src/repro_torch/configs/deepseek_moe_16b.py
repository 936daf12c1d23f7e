"""deepseek-moe-16b [moe]: 28L d=2048 16H (kv=16) V=102400.

Fine-grained MoE: 2 shared + 64 routed experts top-6, d_expert=1408;
first layer is a dense FFN (width 10944, per the released model)
[arXiv:2401.06066; hf].  Full attention."""

from repro_torch.configs.base import (BlockDef, LayerSpec, ModelConfig,
                                      MoESpec, register)

CONFIG = register(
    ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=10944,                    # layer-0 dense FFN width
        vocab_size=102400,
        moe=MoESpec(num_experts=64, top_k=6, d_expert=1408, num_shared=2),
        blocks=(BlockDef((LayerSpec("attn", "dense"),), repeats=1),
                BlockDef((LayerSpec("attn", "moe"),), repeats=27)),
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_notes=(("long_500k", "pure full attention"),),
)
