"""Trees of registered dataclasses, dicts and lists with tensor leaves,
walked as ``jax.tree_util`` walks the JAX package's pytrees.

The wire and the Merkle tree name every leaf by its key path.  So that a
tree gives the same names in both packages, paths are spelled as
``jax.tree_util.keystr`` spells them: ``.field`` for a node's field
(fields in declaration order), ``['key']`` for a dict key (keys in
sorted order) and ``[i]`` for a list index, e.g.
``.caches[0][0]['attn']['k']``.  Tensors cross as numpy arrays named by
numpy dtype names, bf16 as its uint16 bit pattern under the name
``"bfloat16"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# torch dtype <-> the numpy dtype name the JAX wire tags a leaf with
NP_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
            torch.float16: "float16", torch.float64: "float64",
            torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
            torch.int32: "int32", torch.int64: "int64", torch.bool: "bool"}
TORCH_DTYPES = {v: k for k, v in NP_NAMES.items()}

_NODES: set[type] = set()


def register_node(cls):
    """Make a dataclass a tree node whose fields are its children, in
    declaration order (the port's ``jax.tree_util.register_dataclass``).
    Any other object, a dataclass included, is a leaf."""
    _NODES.add(cls)
    return cls


class Attr(str):
    """A node's field name in a key path (``.name`` in ``keystr``)."""


def flatten(tree, prefix: tuple = ()) -> list[tuple[tuple, object]]:
    """``[(path, leaf)]`` in ``jax.tree_util`` flattening order: a node's
    fields as ``Attr``, dict keys in sorted order, list indices."""
    if type(tree) in _NODES:
        return [item for f in dataclasses.fields(tree)
                for item in flatten(getattr(tree, f.name),
                                    prefix + (Attr(f.name),))]
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in flatten(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in flatten(v, prefix + (i,))]
    return [(prefix, tree)]


def keystr(path: tuple) -> str:
    """A ``flatten`` path spelled as ``jax.tree_util.keystr`` spells it."""
    return "".join(f".{k}" if isinstance(k, Attr) else f"[{k!r}]"
                   for k in path)


def leaves_with_path(tree) -> list[tuple[str, object]]:
    """``[(keystr, leaf)]`` in ``jax.tree_util`` flattening order."""
    return [(keystr(path), leaf) for path, leaf in flatten(tree)]


def map_with_path(fn, tree, prefix: tuple = ()):
    """The tree with every leaf replaced by ``fn(keystr, leaf)``."""
    if type(tree) in _NODES:
        return type(tree)(**{
            f.name: map_with_path(fn, getattr(tree, f.name),
                                  prefix + (Attr(f.name),))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(keystr(prefix), tree)


def host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bf16 as its uint16 bit pattern."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def from_host(a: np.ndarray, device) -> torch.Tensor:
    """Reverse of ``host_array``: a uint16 array (or an ml_dtypes
    bfloat16 one, which ``torch.from_numpy`` refuses) is bf16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    a = np.array(a)              # a writable, contiguous copy for torch
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A tensor as (``host_array``, numpy dtype name)."""
    return host_array(t), NP_NAMES[t.dtype]


def from_bytes(data: bytes, dtype: str, shape, device) -> torch.Tensor:
    """The tensor ``to_numpy`` wrote as bytes, built on ``device``."""
    if dtype not in TORCH_DTYPES:
        raise ValueError(f"leaf dtype {dtype!r} is not one the port carries")
    np_dtype = np.uint16 if dtype == "bfloat16" else np.dtype(dtype)
    return from_host(np.frombuffer(data, np_dtype).reshape(shape), device)


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """A leaf's shape, dtype and device without its data (the port's
    ``jax.ShapeDtypeStruct``): the template a blob is read against."""
    shape: tuple
    dtype: torch.dtype
    device: torch.device


def spec_of(t: torch.Tensor) -> LeafSpec:
    return LeafSpec(tuple(t.shape), t.dtype, t.device)


def leaves(tree) -> list:
    """The leaves of ``tree`` in ``leaves_with_path`` order."""
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn, tree):
    """The tree with every leaf replaced by ``fn(leaf)``."""
    return map_with_path(lambda _, leaf: fn(leaf), tree)


def unflatten_like(tree, values) -> object:
    """``tree``'s structure with its leaves replaced by ``values``, given
    in ``leaves`` order (the port's ``jax.tree.unflatten``)."""
    paths = [path for path, _ in leaves_with_path(tree)]
    if len(paths) != len(values):
        raise ValueError(f"{len(values)} values for {len(paths)} leaves")
    by_path = dict(zip(paths, values))
    return map_with_path(lambda path, _: by_path[path], tree)
