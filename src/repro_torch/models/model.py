"""Top-level model: embedding, block groups, LM head.

The model is ``repeat(block)`` groups (configs.base.BlockDef); parameters
and caches carry a leading ``repeats`` dim per group, as in the JAX
package, and a Python loop runs groups x repeats x layers where JAX uses
``lax.scan``; a hybrid block (jamba's) runs its mamba, attention and MoE
layers within each repeat.  One ``forward`` serves all three modes:

  train   : full sequence, no cache
  prefill : full sequence, writes the row's KV cache or pages, or its
            recurrent state (rwkv and mamba layers, starting from the
            state the cache holds)
  decode  : one token per row (or a verify window, dense attention
            caches only) against the KV cache or pages, or one step of
            the recurrence
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.init import torch_dtype
from repro_torch.device import resolve
from repro_torch.models.layers import layer_apply, make_layer_cache, rmsnorm
from repro_torch.models.schema import tree_map


def make_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Full dense model cache (attention KV rows, or the recurrent state
    of rwkv and mamba layers; a hybrid group holds both):
    [group][layer_in_block], every leaf stacked over repeats (a leading
    ``repeats`` dim, then batch), as in the JAX package."""
    dev = resolve(device)
    groups = []
    for block in cfg.blocks:
        layers = []
        for ls in block.layers:
            one = make_layer_cache(cfg, ls, batch, max_len, device=dev)
            layers.append(tree_map(
                lambda a, n=block.repeats: a[None].repeat(
                    (n,) + (1,) * a.ndim), one))
        groups.append(layers)
    return groups


def _run_groups(params_blocks, x, *, cfg: ModelConfig, blocks, mode,
                positions, caches):
    for gi, block in enumerate(blocks):
        p_group = params_blocks[gi]
        c_group = caches[gi] if caches is not None else None
        for r in range(block.repeats):
            for li, lspec in enumerate(block.layers):
                p_r = tree_map(lambda a: a[r], p_group[li])
                c_r = (tree_map(lambda a: a[r], c_group[li])
                       if c_group is not None else None)
                x = layer_apply(p_r, x, cfg=cfg, lspec=lspec, mode=mode,
                                positions=positions, cache=c_r)
    return x


def embed_tokens(params, tokens, cfg: ModelConfig):
    return params["embed"][tokens].to(torch_dtype(cfg.dtype))


def lm_logits(params, x, cfg: ModelConfig):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.einsum("btd,dv->btv", x, head)


def forward(params, batch, *, cfg: ModelConfig, mode: str, positions=None,
            caches=None):
    """Returns logits (B, S, V_pad).

    batch: {"tokens": (B, S)}.  ``caches`` is the per-layer tree
    ([group][layer] {"attn": {k, v, abs_pos[, write]}} dense, or
    {"attn": {k_pool, v_pool, page_table}} paged, or {"rwkv": {state,
    x_tm, x_cm[, write]}} or {"mamba": {ssm, conv[, write]}} recurrent,
    every leaf stacked over repeats);
    it is written in place, where the JAX ``forward`` returns new caches
    and an aux loss (the MoE layers' load-balancing loss, which the
    engines drop, as the JAX engines do).
    """
    if cfg.encoder_blocks or cfg.num_patches or cfg.cross_attention:
        raise NotImplementedError(
            f"{cfg.name}: encoder / vision / cross-attention front ends are "
            "not ported yet (ROADMAP Queue 1, other model families)")
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)

    x = _run_groups(params["blocks"], x, cfg=cfg, blocks=cfg.blocks,
                    mode=mode, positions=positions, caches=caches)
    x = rmsnorm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = lm_logits(params, x, cfg)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def vocab_mask_logits(logits, cfg: ModelConfig):
    """-1e30 on padded vocab entries (sampling / eval)."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    mask = torch.arange(logits.shape[-1], device=logits.device) \
        < cfg.vocab_size
    return torch.where(mask, logits, torch.full_like(logits, -1e30))
