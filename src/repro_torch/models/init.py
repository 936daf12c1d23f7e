"""Materialize parameters from the schema, and the weight bridge.

``init_params`` follows the JAX package's init rules (zeros, ones,
fan-in truncated normal, uniform) but draws from a ``torch.Generator``,
so the numbers differ from JAX's for the same seed.  Tests that compare
the two packages carry the JAX tree across with ``params_from_numpy``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import LeafSpec, from_host, host_array, leaves
from repro_torch.device import resolve
from repro_torch.models.schema import ParamDef, model_schema, tree_map

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def _make(pd: ParamDef, gen: torch.Generator, device) -> torch.Tensor:
    dt = torch_dtype(pd.dtype)
    if pd.init == "zeros":
        return torch.zeros(pd.shape, dtype=dt, device=device)
    if pd.init == "ones":
        return torch.ones(pd.shape, dtype=dt, device=device)
    if pd.init == "mamba_A":
        st = pd.shape[-1]
        a = torch.log(torch.arange(1, st + 1, dtype=torch.float32,
                                   device=device))
        return a.expand(pd.shape).to(dt).contiguous()
    if pd.init in ("uniform", "rwkv_decay"):
        lo, hi = (-0.5, 0.5) if pd.init == "uniform" else (-6.0, -1.0)
        t = torch.empty(pd.shape, dtype=torch.float32, device=device)
        return t.uniform_(lo, hi, generator=gen).to(dt)
    # truncated-normal fan-in init, in [-2, 2] standard deviations
    fan_in = pd.shape[0] if len(pd.shape) == 1 else math.prod(pd.shape[:-1])
    if len(pd.shape) >= 3:  # (in, heads, hd) style: fan-in is dim 0
        fan_in = pd.shape[0]
    std = pd.scale / math.sqrt(max(1, fan_in))
    t = torch.empty(pd.shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(dt)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Materialize a parameter tree on ``device`` from ``generator``
    (which must live on the same device type)."""
    dev = resolve(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    dt = torch_dtype(cfg.dtype)

    def make(pd: ParamDef) -> torch.Tensor:
        a = _make(pd, generator, dev)
        if a.dtype == torch.bfloat16 and dt != torch.bfloat16:
            a = a.to(dt)  # cfg.dtype overrides the compute dtype
        return a

    return tree_map(make, model_schema(cfg))


def abstract_params(cfg: ModelConfig) -> dict:
    """``LeafSpec`` tree of the parameters on the ``meta`` device: shapes
    and dtypes, no allocation (the JAX ``ShapeDtypeStruct`` tree)."""
    meta = torch.device("meta")
    return tree_map(lambda pd: LeafSpec(tuple(pd.shape),
                                        torch_dtype(pd.dtype), meta),
                    model_schema(cfg))


def param_bytes(cfg: ModelConfig) -> int:
    return sum(math.prod(pd.shape) * torch_dtype(pd.dtype).itemsize
               for pd in leaves(model_schema(cfg)))


def count_params(cfg: ModelConfig) -> int:
    return sum(math.prod(pd.shape) for pd in leaves(model_schema(cfg)))


# ---------------------------------------------------------------------------
# weight bridge: the JAX parameter tree as numpy arrays <-> torch
# ---------------------------------------------------------------------------

def params_from_numpy(tree, device="cuda"):
    """The JAX parameter tree (numpy leaves; bf16 as uint16 views) as
    torch tensors on ``device``, with identical shapes and key paths."""
    dev = resolve(device)
    return tree_map(lambda a: from_host(a, dev), tree)


def params_to_numpy(tree):
    """Reverse of ``params_from_numpy``: numpy leaves, bf16 as uint16."""
    return tree_map(host_array, tree)
