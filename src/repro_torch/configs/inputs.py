"""Model inputs for a shape cell, as concrete tensors.

The concrete half of the reference's ``configs/inputs.py``:
``batch_specs(..., concrete=True)`` and ``input_specs(..., concrete=True)``
draw from ``np.random.default_rng(seed)`` in the reference's order, so the
port's inputs equal the JAX package's bit for bit: tokens (and decode
positions) int32, whisper's ``frames`` and internvl2's ``patch_embeds``
bf16 from the same float64 draws (through float32, as JAX canonicalises
a float64 array without x64), decode caches from the port's
``make_cache(..., cross_len=)``.  Tensors are made on the CPU and moved
to ``device``.

The abstract half (``ShapeDtypeStruct`` stand-ins,
``cache_specs_abstract``) serves the dry-run tools and comes with them
(ROADMAP Queue 1 item 9); ``concrete=False`` raises until then.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.device import resolve
from repro_torch.models.model import make_cache


def _concrete(concrete: bool):
    if not concrete:
        raise NotImplementedError(
            "abstract input specs come with the dry-run tools (ROADMAP "
            "Queue 1 item 9); pass concrete=True")


def _arr(shape, dtype, rng, device, maxval=None):
    if dtype == torch.int32:
        a = rng.integers(0, maxval or 2, size=shape, dtype=np.int32)
        return torch.from_numpy(a).to(device)
    a = torch.from_numpy(rng.standard_normal(shape)).float()
    return a.to(dtype).to(device)


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, *, concrete=False,
                seed=0, device="cuda"):
    """The model-input batch for a shape cell (without caches)."""
    _concrete(concrete)
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    B, S = shape.global_batch, shape.seq_len
    bf16 = torch.bfloat16
    d: dict = {}
    if shape.kind == "decode":
        d["tokens"] = _arr((B, 1), torch.int32, rng, dev, cfg.vocab_size)
        d["positions"] = _arr((B, 1), torch.int32, rng, dev, S)
    elif cfg.encoder_blocks:
        # audio: seq_len = encoder frames (stub embeddings), fixed dec len
        d["frames"] = _arr((B, S, cfg.d_model), bf16, rng, dev)
        d["tokens"] = _arr((B, cfg.decoder_len), torch.int32, rng, dev,
                           cfg.vocab_size)
    elif cfg.num_patches:
        d["patch_embeds"] = _arr((B, cfg.num_patches, 1024), bf16, rng, dev)
        d["tokens"] = _arr((B, S - cfg.num_patches), torch.int32, rng, dev,
                           cfg.vocab_size)
    else:
        d["tokens"] = _arr((B, S), torch.int32, rng, dev, cfg.vocab_size)
    return d


def input_specs(cfg: ModelConfig, shape: ShapeSpec, *, concrete=False,
                seed=0, device="cuda"):
    """Full step-function inputs: the batch, plus caches for decode (an
    encoder-decoder's self caches hold ``decoder_len`` tokens and its
    cross caches ``seq_len`` frames)."""
    d = batch_specs(cfg, shape, concrete=concrete, seed=seed, device=device)
    if shape.kind == "decode":
        B, S = shape.global_batch, shape.seq_len
        cross_len = S if cfg.encoder_blocks else 0
        max_len = cfg.decoder_len if cfg.encoder_blocks else S
        d["caches"] = make_cache(cfg, B, max_len, device, cross_len=cross_len)
    return d

