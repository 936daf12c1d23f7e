"""Disk checkpoints with restart: the JAX package's ``checkpoint/disk.py``
on torch trees, in the same layout, so a checkpoint written by either
package restores in the other, leaf for leaf.

Layout (stdlib + numpy):
    <dir>/step_<n:08d>/
        MANIFEST.json      {step, leaves: {key path: {file, shape, dtype}}}
        leaf_<i:05d>.npy   one file per leaf, i in sorted key-path order

Key paths are ``jax.tree_util.keystr`` spellings (``core.tree.keystr``),
e.g. ``['params']['blocks'][0][0]['attn']['wq']``; a bf16 leaf is stored
as its uint16 bit pattern under the dtype string ``"bfloat16"``, and a
leaf is restored by its manifest's dtype string (a ``"uint16"`` leaf as
``torch.uint16``; a dtype the port does not hold is refused).  A save
is atomic (a ``.tmp`` directory renamed into place) and keeps the newest
``keep`` steps.  The JAX ``restore(..., shardings=)`` (restore onto
another mesh) goes with ``sharding.py`` (ROADMAP Queue 1); the port
restores onto the device of each leaf of ``like_tree``.
"""

from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

from repro_torch.core.tree import (from_host, host_array, leaves_with_path,
                                   map_with_path, NP_NAMES)

# the leaf dtypes a checkpoint holds: the wire's, and uint16 (a JAX tree
# may hold one; only the manifest tells it from bf16's uint16 bits)
NAMES = {**NP_NAMES, torch.uint16: "uint16"}
DTYPES = {name: np.dtype(name) for name in NAMES.values()
          if name != "bfloat16"}


def save(directory: str, step: int, tree, *, keep: int = 3) -> str:
    """Atomic checkpoint write (tmp dir + rename)."""
    keyed = dict(leaves_with_path(tree))
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for i, (key, leaf) in enumerate(sorted(keyed.items())):
        arr = host_array(leaf) if torch.is_tensor(leaf) else np.asarray(leaf)
        dtype = NAMES[leaf.dtype] if torch.is_tensor(leaf) \
            else str(arr.dtype)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": dtype}
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep)
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def restore(directory: str, step: int, like_tree):
    """Restore into the structure of ``like_tree``: each leaf (a tensor
    or a ``core.tree.LeafSpec``) names the key path to read and the
    device to put it on; dtype and shape are the checkpoint's."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)

    def one(key, like):
        meta = manifest["leaves"][key]
        arr = np.load(os.path.join(path, meta["file"]))
        device = getattr(like, "device", "cpu")
        if meta["dtype"] == "bfloat16":
            return from_host(arr.view(np.uint16), device)
        if meta["dtype"] not in DTYPES:
            raise ValueError(f"{key}: leaf dtype {meta['dtype']!r} is not "
                             "one the port restores")
        # by the manifest's dtype: a uint16 leaf stays uint16
        return torch.from_numpy(np.array(arr, DTYPES[meta["dtype"]])).to(
            device)
    return map_with_path(one, like_tree)


def _gc(directory: str, keep: int):
    steps = sorted(
        int(m.group(1)) for d in os.listdir(directory)
        if (m := re.fullmatch(r"step_(\d+)", d)))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
