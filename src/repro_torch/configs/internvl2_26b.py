"""internvl2-26b [vlm]: 48L d=6144 48H (GQA kv=8) ff=16384 V=92553.

InternViT + InternLM2 [arXiv:2404.16821; hf].  The ViT frontend is a
STUB per the assignment: ``input_specs`` provides 256 precomputed patch
embeddings (dim 1024) which a learned projection maps to d_model and
prepends to the text sequence.  Full attention -> long_500k skipped.
No engine serves it: it runs through ``models.model.forward``, fed by
``configs.inputs``."""

from repro_torch.configs.base import (BlockDef, LayerSpec, ModelConfig,
                                      register)

CONFIG = register(
    ModelConfig(
        name="internvl2-26b",
        family="vlm",
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=92553,
        num_patches=256,
        blocks=(BlockDef((LayerSpec("attn", "dense"),), repeats=48),),
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_notes=(("long_500k", "pure full attention LM backbone"),),
)
