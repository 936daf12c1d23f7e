"""Model inputs for a shape cell: ``meta`` stand-ins or concrete tensors.

The port's ``configs/inputs.py``.  ``concrete=False`` (the default, as
in JAX) gives ``meta`` tensors of the reference's ``ShapeDtypeStruct``
shapes and dtypes: nothing is allocated, and the dry run
(``launch/dryrun.py``) runs its steps on them.  ``cache_specs_abstract``
is the port's ``make_cache(..., device="meta", cross_len=)`` at the
reference's lengths.  ``concrete=True`` draws from
``np.random.default_rng(seed)`` in the reference's order, so the port's
inputs equal the JAX package's bit for bit: tokens (and decode
positions) int32, whisper's ``frames`` and internvl2's ``patch_embeds``
bf16 from the same float64 draws (through float32, as JAX canonicalises
a float64 array without x64), decode caches from the port's
``make_cache(..., cross_len=)``.  Concrete tensors are made on the CPU
and moved to ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.device import resolve
from repro_torch.models.model import make_cache


def _arr(shape, dtype, rng, device, maxval=None):
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    if dtype == torch.int32:
        a = rng.integers(0, maxval or 2, size=shape, dtype=np.int32)
        return torch.from_numpy(a).to(device)
    a = torch.from_numpy(rng.standard_normal(shape)).float()
    return a.to(dtype).to(device)


def _device(concrete: bool, device) -> torch.device:
    return resolve(device) if concrete else torch.device("meta")


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, *, concrete=False,
                seed=0, device="cuda"):
    """The model-input batch for a shape cell (without caches); ``meta``
    tensors unless ``concrete``."""
    dev = _device(concrete, device)
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


def make_caches(cfg: ModelConfig, shape: ShapeSpec, *, concrete=False,
                device="cuda"):
    """The cache tree of a shape cell (``meta`` unless ``concrete``): an
    encoder-decoder's self caches hold ``decoder_len`` tokens and its
    cross caches ``seq_len`` frames."""
    max_len, cross_len = ((cfg.decoder_len, shape.seq_len)
                          if cfg.encoder_blocks else (shape.seq_len, 0))
    return make_cache(cfg, shape.global_batch, max_len,
                      _device(concrete, device), cross_len=cross_len)


def cache_specs_abstract(cfg: ModelConfig, shape: ShapeSpec):
    """The cache tree of a shape cell as ``meta`` tensors."""
    return make_caches(cfg, shape)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, *, concrete=False,
                seed=0, device="cuda"):
    """Full step-function inputs: the batch, plus caches for decode
    (``meta`` tensors unless ``concrete``)."""
    d = batch_specs(cfg, shape, concrete=concrete, seed=seed, device=device)
    if shape.kind == "decode":
        d["caches"] = make_caches(cfg, shape, concrete=concrete,
                                  device=device)
    return d
