"""whisper-base [audio]: 6L enc + 6L dec, d=512 8H ff=2048 V=51865.

Enc-dec with conv frontend STUB [arXiv:2212.04356]: ``input_specs``
provides post-conv frame embeddings (B, seq, d_model) directly; seq_len
maps to encoder frame positions (stretched beyond whisper's native 1500
to exercise the assigned shapes).  Decoder length fixed at 448.
decode shapes = one decoder token against self-KV + cross-KV over the
seq_len encoder frames.  long_500k skipped (full attention enc-dec).
Positional scheme unified to RoPE (whisper's learned/sinusoidal
embeddings replaced; documented).  No engine serves it: it runs through
``models.model.forward``, fed by ``configs.inputs``."""

from repro_torch.configs.base import (BlockDef, LayerSpec, ModelConfig,
                                      register)

_A = LayerSpec("attn", "dense")

CONFIG = register(
    ModelConfig(
        name="whisper-base",
        family="audio",
        d_model=512,
        num_heads=8,
        num_kv_heads=8,
        head_dim=64,
        d_ff=2048,
        vocab_size=51865,
        act="gelu",
        cross_attention=True,
        decoder_len=448,
        encoder_blocks=(BlockDef((_A,), repeats=6),),
        blocks=(BlockDef((_A,), repeats=6),),
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_notes=(("long_500k", "enc-dec full attention; whisper has no "
                 "500k-context decode"),),
)
