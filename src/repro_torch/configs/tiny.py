"""Reduced-config factory: same family/block structure, tiny dims.

The port's CPU tests build these; the numbers match the JAX package's
``make_tiny`` exactly so the two packages' parameter trees line up."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import BlockDef, ModelConfig, MoESpec


def make_tiny(cfg: ModelConfig, *, d_model=64, repeats_cap=2) -> ModelConfig:
    heads = 4
    head_dim = d_model // heads
    kv = max(1, cfg.num_kv_heads * heads // max(cfg.num_heads, 1))
    kv = min(kv, heads)
    while heads % kv:
        kv += 1
    blocks = tuple(
        BlockDef(tuple(dataclasses.replace(
            ls, window=min(ls.window, 32) if ls.window else 0)
            for ls in b.layers),
            repeats=min(b.repeats, repeats_cap))
        for b in cfg.blocks)
    enc_blocks = tuple(
        BlockDef(b.layers, repeats=min(b.repeats, repeats_cap))
        for b in cfg.encoder_blocks)
    moe = None
    if cfg.moe is not None:
        moe = MoESpec(num_experts=8, top_k=min(cfg.moe.top_k, 2),
                      d_expert=32, num_shared=min(cfg.moe.num_shared, 1),
                      capacity_factor=2.0)
    return cfg.replace(
        name=cfg.name + "-tiny",
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=head_dim,
        d_ff=4 * d_model,
        vocab_size=512,
        vocab_pad_multiple=16,
        blocks=blocks,
        encoder_blocks=enc_blocks,
        moe=moe,
        rwkv_head_dim=16,
        rwkv_lora=8,
        mamba_d_state=4,
        decoder_len=16 if cfg.decoder_len else 0,
        num_patches=8 if cfg.num_patches else 0,
    )
