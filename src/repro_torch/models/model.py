"""Top-level model: embedding, block groups, LM head.

The model is ``repeat(block)`` groups (configs.base.BlockDef); parameters
and caches carry a leading ``repeats`` dim per group, as in the JAX
package, and a Python loop runs groups x repeats x layers where JAX uses
``lax.scan``; a hybrid block (jamba's) runs its mamba, attention and MoE
layers within each repeat.  One ``forward`` serves all three modes:

  train   : full sequence, no cache (``train_forward`` also returns the
            MoE layers' load-balancing loss, and recomputes each repeat
            of a block in the backward, as the JAX package remats it)
  prefill : full sequence, writes the row's KV cache or pages, or its
            recurrent state (rwkv and mamba layers, starting from the
            state the cache holds)
  decode  : one token per row (or a verify window, dense attention
            caches only) against the KV cache or pages, or one step of
            the recurrence

Encoder-decoder (whisper) runs the encoder inside prefill and train;
VLM (internvl2) prepends projected stub patch embeddings.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.init import torch_dtype
from repro_torch.device import resolve
from repro_torch.models.layers import layer_apply, make_layer_cache, rmsnorm
from repro_torch.models.schema import tree_map


def make_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda",
               cross_len: int = 0):
    """Full dense model cache (attention KV rows, or the recurrent state
    of rwkv and mamba layers; a hybrid group holds both; a decoder with
    cross-attention also a ``cross`` cache of ``cross_len`` frames):
    [group][layer_in_block], every leaf stacked over repeats (a leading
    ``repeats`` dim, then batch), as in the JAX package."""
    dev = resolve(device)
    groups = []
    for block in cfg.blocks:
        layers = []
        for ls in block.layers:
            one = make_layer_cache(cfg, ls, batch, max_len,
                                   cross=cfg.cross_attention,
                                   cross_len=cross_len, device=dev)
            layers.append(tree_map(
                lambda a, n=block.repeats: a[None].repeat(
                    (n,) + (1,) * a.ndim), one))
        groups.append(layers)
    return groups


def _run_groups(params_blocks, x, *, cfg: ModelConfig, blocks, mode,
                positions, caches, enc_out=None, causal=True, remat=False):
    """Returns (x, aux).  ``aux`` sums the MoE layers' load-balancing
    losses in the JAX order (each repeat's layers, then the group's
    repeats, then the groups) in train mode; None for a model without
    MoE layers, and outside train mode (the engines drop it).
    ``remat`` runs each repeat of a block under
    ``torch.utils.checkpoint`` (the JAX ``jax.checkpoint`` with
    ``nothing_saveable`` over the scan body): its activations are
    recomputed in the backward, not kept."""
    aux_total = None
    for gi, block in enumerate(blocks):
        p_group = params_blocks[gi]
        c_group = caches[gi] if caches is not None else None

        def body(x, r, block=block, p_group=p_group, c_group=c_group):
            aux = None
            for li, lspec in enumerate(block.layers):
                p_r = tree_map(lambda a: a[r], p_group[li])
                c_r = (tree_map(lambda a: a[r], c_group[li])
                       if c_group is not None else None)
                x, a = layer_apply(p_r, x, cfg=cfg, lspec=lspec, mode=mode,
                                   positions=positions, cache=c_r,
                                   enc_out=enc_out, causal=causal)
                if a is not None and mode == "train":
                    aux = a if aux is None else aux + a
            return x, aux

        auxes = []
        for r in range(block.repeats):
            if remat:
                x, aux = checkpoint(body, x, r, use_reentrant=False)
            else:
                x, aux = body(x, r)
            if aux is not None:
                auxes.append(aux)
        if auxes:
            s = torch.stack(auxes).sum()
            aux_total = s if aux_total is None else aux_total + s
    return x, aux_total


def embed_tokens(params, tokens, cfg: ModelConfig):
    return params["embed"][tokens].to(torch_dtype(cfg.dtype))


def lm_logits(params, x, cfg: ModelConfig):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.einsum("btd,dv->btv", x, head)


def forward(params, batch, *, cfg: ModelConfig, mode: str, positions=None,
            caches=None):
    """Returns logits (B, S, V_pad).

    batch: {"tokens": (B, S_t)} plus, outside decode,
           "frames": (B, S_f, d_model)   (audio stub front end; or a
                                          precomputed "enc_out")
           "patch_embeds": (B, P, 1024)  (vlm stub front end: the logits
                                          and default positions cover
                                          P + S_t)
    ``caches`` is the per-layer tree
    ([group][layer] {"attn": {k, v, abs_pos[, write]}} dense, or
    {"attn": {k_pool, v_pool, page_table}} paged, or {"rwkv": {state,
    x_tm, x_cm[, write]}} or {"mamba": {ssm, conv[, write]}} recurrent,
    plus {"cross": {k, v, abs_pos}} for an encoder-decoder; every leaf
    stacked over repeats);
    it is written in place, where the JAX ``forward`` returns new caches
    and an aux loss (the MoE layers' load-balancing loss, which the
    engines drop, as the JAX engines do; ``train_forward`` returns it).
    """
    return _forward(params, batch, cfg=cfg, mode=mode, positions=positions,
                    caches=caches)[0]


def train_forward(params, batch, *, cfg: ModelConfig, remat=True):
    """The train-mode forward of the JAX ``forward(..., mode="train",
    remat=)``: (logits (B, S, V_pad), aux), where ``aux`` is the MoE
    layers' load-balancing loss summed over the decoder's layers (f32
    0 for a model without MoE layers; an encoder's is dropped, as JAX
    drops it).  ``remat`` recomputes each repeat of every block, the
    encoder's too, in the backward.  The encoder run and the patch prefix
    are ``forward``'s."""
    logits, aux = _forward(params, batch, cfg=cfg, mode="train",
                           remat=remat)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits, aux


def _forward(params, batch, *, cfg: ModelConfig, mode: str, positions=None,
             caches=None, remat=False):
    tokens = batch["tokens"]
    B = tokens.shape[0]
    dtype = torch_dtype(cfg.dtype)

    enc_out = batch.get("enc_out")       # precomputed at prefill
    if cfg.encoder_blocks and mode != "decode" and enc_out is None:
        frames = batch["frames"].to(dtype)
        if mode == "prefill" and caches is not None:
            _check_cross(caches, frames.shape[1])
        fpos = torch.arange(frames.shape[1], device=frames.device)[
            None].expand(frames.shape[:2])
        enc_p = params["encoder"]
        enc_out = _run_groups(enc_p["blocks"], frames, cfg=cfg,
                              blocks=cfg.encoder_blocks, mode="train",
                              positions=fpos, caches=None, causal=False,
                              remat=remat)[0]
        enc_out = rmsnorm(enc_out, enc_p["final_norm"]["scale"],
                          cfg.norm_eps)
    elif enc_out is not None and mode == "prefill" and caches is not None:
        _check_cross(caches, enc_out.shape[1])

    x = embed_tokens(params, tokens, cfg)
    if cfg.num_patches and mode != "decode":
        pe = torch.einsum("bpk,kd->bpd", batch["patch_embeds"].to(dtype),
                          params["patch_proj"])
        x = torch.cat([pe, x], dim=1)
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)

    x, aux = _run_groups(params["blocks"], x, cfg=cfg, blocks=cfg.blocks,
                         mode=mode, positions=positions, caches=caches,
                         enc_out=enc_out, remat=remat)
    x = rmsnorm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = lm_logits(params, x, cfg)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits, aux


def _check_cross(caches, frames: int):
    """A cross cache must hold every frame.  The reference writes frame p
    at slot min(p, S_c - 1), so a shorter cache piles the extra frames
    into its last slot (one of them survives: the last on the JAX CPU
    scatter, any one on a CUDA ``index_put_``); the port refuses the
    prefill before any layer writes (ROADMAP Queue 3).  A longer cache
    leaves slots at ``abs_pos`` -1, which attention masks."""
    for group in caches:
        for layer in group:
            S_c = layer["cross"]["k"].shape[2] if "cross" in layer else frames
            if frames > S_c:
                raise ValueError(f"a cross-attention cache of {S_c} slots "
                                 f"cannot hold {frames} encoder frames")


def vocab_mask_logits(logits, cfg: ModelConfig):
    """-1e30 on padded vocab entries (sampling / eval)."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    mask = torch.arange(logits.shape[-1], device=logits.device) \
        < cfg.vocab_size
    return torch.where(mask, logits, torch.full_like(logits, -1e30))
