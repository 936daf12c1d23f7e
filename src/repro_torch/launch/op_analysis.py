"""Op-count analysis of one step: the port's counterpart of the JAX
package's ``launch/hlo_analysis.py`` (trip-count-aware cost analysis of
optimized HLO text).

There is no compiled module to read: the step runs once, eagerly, most
usefully on the ``meta`` device (shapes and dtypes, no data, nothing
allocated), under a ``TorchDispatchMode`` that sees every aten op.  A
Python loop is simply run, so a scan's trip count needs no parsing.  It
sums:

  * FLOPs: 2 M N K a product (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
    and ``mv``, ``addmv``, ``dot``; ``einsum`` and ``matmul`` reach
    these), 0 for every other op, as the HLO analyzer counts only dots;
  * bytes: every tensor argument of an op read (at most its storage, so
    an expanded view reads what it holds) and every returned tensor
    written; a view moves nothing, an ``empty`` writes nothing, and an
    in-place write at indices (a cache slot) reads its indices and its
    update and writes the update, not the whole destination;
  * peak live bytes: the argument storages, plus every storage created
    since, minus every one freed (a weak reference on each storage).

**A kernel call is one unit** (``kernels/units.py``): each call site the
card would launch a hand-written kernel from counts once, by that
kernel's formula (``launch/roofline.kernel_cost``), and whatever runs
inside it (the plain version, here) is not counted; only the storages it
returns stay live.  This departs from the HLO analyzer's rule
(``hlo_analysis.py``: elementwise ops inside a loop body are VMEM
resident, and count, only above 128 MB): on the card the plain
attention's S x S scores, the rwkv chunk states and the like never exist
in memory, so nothing of them is counted.  Outside a unit every op counts
in full, the mamba scan's token loop too (no kernel in either package).

``Cost`` keeps the totals and a compact record: (count, FLOPs, bytes) by
op name and by kernel unit, so ``reanalyze`` re-derives a roofline
without running the step again.
"""

from __future__ import annotations

import math
import weakref
from dataclasses import asdict, dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import units
from repro_torch.launch.roofline import kernel_cost

aten = torch.ops.aten

# a view's output shares its input's storage; these too, though their
# schemas do not say so
_ALIASES = {aten._unsafe_view, aten.alias, aten.lift_fresh, aten.detach}
# allocations that write nothing
_EMPTY = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
          aten.new_empty_strided}
# in-place writes at indices: the indices and the update read, the update
# written (not the whole destination: a cache write moves one slot)
_INDEXED = {aten.index_put_, aten._index_put_impl_, aten.index_copy_,
            aten.index_add_, aten.scatter_, aten.scatter_add_,
            aten.scatter_reduce_, aten.masked_scatter_}


def _mm(a, b) -> float:
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]


def _bmm(a, b) -> float:
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


_FLOPS = {
    aten.mm: lambda a, b, *_, **__: _mm(a, b),
    aten.addmm: lambda _c, a, b, *__, **___: _mm(a, b),
    aten.bmm: lambda a, b, *_, **__: _bmm(a, b),
    aten.baddbmm: lambda _c, a, b, *__, **___: _bmm(a, b),
    aten.mv: lambda a, x, *_, **__: 2.0 * a.shape[0] * a.shape[1],
    aten.addmv: lambda _c, a, x, *__, **___: 2.0 * a.shape[0] * a.shape[1],
    aten.dot: lambda a, b, *_, **__: 2.0 * a.shape[0],
}


def _tensor_bytes(t: torch.Tensor) -> int:
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):   # no storage
        return n


def _tensors(tree, out=None) -> list[torch.Tensor]:
    """The tensors of a nest of tuples, lists and dicts."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


class _NotMeta(Exception):
    pass


def _sig(x):
    """An op argument as a hashable key: a tensor by its shape, strides
    and dtype."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _NotMeta
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_sig(y) for y in x))
    return x


def _meta(rec):
    if rec[0] == "t":
        return torch.empty_strided(rec[1], rec[2], dtype=rec[3],
                                   device="meta")
    return rec[0](_meta(r) for r in rec[1])


def _record(out):
    """How to make ``out`` again on meta, or None (a result off the meta
    device, which has values)."""
    if isinstance(out, torch.Tensor):
        if out.device.type != "meta":
            return None
        return ("t", out.shape, out.stride(), out.dtype)
    if isinstance(out, (list, tuple)) and all(
            isinstance(o, torch.Tensor) for o in out):
        made = tuple(_record(o) for o in out)
        return None if None in made else (type(out), made)
    return None


@dataclass
class Cost:
    """What one run of a step counted.  ``ops`` and ``units``: name ->
    [count, FLOPs, bytes]; ``peak_bytes`` includes ``argument_bytes``."""
    flops: float = 0.0
    bytes: float = 0.0
    peak_bytes: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    ops: dict = field(default_factory=dict)
    units: dict = field(default_factory=dict)

    def add(self, table: dict, name: str, flops: float, nbytes: float):
        row = table.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def total(self) -> "Cost":
        """``flops`` and ``bytes`` from the tables (a correctly rounded
        sum, so the same tables always give the same totals)."""
        rows = [*self.ops.values(), *self.units.values()]
        self.flops = math.fsum(r[1] for r in rows)
        self.bytes = math.fsum(r[2] for r in rows)
        return self

    def to_record(self) -> dict:
        return asdict(self)

    @classmethod
    def from_record(cls, rec: dict) -> "Cost":
        """The cost an op record holds, its totals re-derived."""
        return cls(peak_bytes=rec["peak_bytes"],
                   argument_bytes=rec["argument_bytes"],
                   output_bytes=rec["output_bytes"],
                   ops={k: list(v) for k, v in rec["ops"].items()},
                   units={k: list(v) for k, v in rec["units"].items()}
                   ).total()


class OpCounter(TorchDispatchMode):
    """The dispatch mode behind ``analyze``; also the analysis that
    ``kernels.units`` hands each kernel call to (``unit``)."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.live = 0
        self._known: dict[int, weakref.finalize] = {}
        self._inside = 0          # > 0 within a kernel unit
        self._memo: dict = {}     # meta results by call signature

    # -- storages ---------------------------------------------------------
    def track(self, tree):
        for t in _tensors(tree):
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            key = st._cdata
            if key in self._known:
                continue
            n = st.nbytes()
            self.live += n
            self.cost.peak_bytes = max(self.cost.peak_bytes, self.live)
            self._known[key] = weakref.finalize(st, self._free, key, n)

    def _free(self, key, n):
        if self._known.pop(key, None) is not None:
            self.live -= n

    def close(self):
        for f in self._known.values():
            f.detach()
        self._known.clear()

    # -- ops and units ----------------------------------------------------
    def _call(self, func, args, kwargs):
        """``func(*args, **kwargs)``.  On the ``meta`` device the result of
        a functional op depends only on the shapes, strides and dtypes of
        its arguments and on its other arguments, so it is made again from
        the first call's record: many meta kernels are Python reference
        implementations (a fraction of a millisecond an op), and a loop
        (the mamba scan's tokens, the rwkv scan's chunks) repeats one
        signature thousands of times."""
        if func._schema.is_mutable or func.is_view \
                or func.overloadpacket in _ALIASES:
            return func(*args, **kwargs)
        try:
            key = (func, _sig(args), _sig(tuple(sorted(kwargs.items()))))
        except _NotMeta:
            return func(*args, **kwargs)
        made = self._memo.get(key)
        if made is not None:
            return _meta(made)
        out = func(*args, **kwargs)
        made = _record(out)
        if made is not None:
            self._memo[key] = made
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._call(func, args, kwargs)
        if self._inside:
            return out
        packet = func.overloadpacket
        fl = _FLOPS.get(packet)
        flops = fl(*args, **kwargs) if fl else 0.0
        if func.is_view or packet in _ALIASES:
            nbytes = 0
        elif packet in _EMPTY:
            nbytes = 0
        elif packet in _INDEXED:
            rest = _tensors((args[1:], kwargs))
            nbytes = sum(_tensor_bytes(t) for t in rest)
            nbytes += _tensor_bytes(rest[-1])
        else:
            nbytes = sum(_tensor_bytes(t) for t in _tensors((args, kwargs)))
            nbytes += sum(_tensor_bytes(t) for t in _tensors(out))
        self.cost.add(self.cost.ops, str(packet), flops, nbytes)
        self.track(out)
        return out

    def unit(self, name: str, shape: dict, thunk):
        """``thunk()`` as one call of kernel ``name`` at ``shape``."""
        c = kernel_cost(name, **shape)
        self._inside += 1
        try:
            out = thunk()
        finally:
            self._inside -= 1
        self.cost.add(self.cost.units, name, c.flops, c.bytes)
        self.track(out)
        return out


def analyze(fn, *args):
    """Run ``fn(*args)`` once under the op analysis: (``Cost``, result).
    The arguments' storages are live from the start."""
    counter = OpCounter()
    counter.track(args)
    counter.cost.argument_bytes = counter.live
    token = units.ANALYSIS.set(counter)
    try:
        with counter:
            out = fn(*args)
        seen = set()
        counter.cost.output_bytes = 0
        for t in _tensors(out):
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                counter.cost.output_bytes += st.nbytes()
    finally:
        units.ANALYSIS.reset(token)
        counter.close()
    return counter.cost.total(), out


def tree_bytes(tree) -> int:
    """Bytes of a tree's tensors (each storage once)."""
    seen, total = set(), 0
    for t in _tensors(tree):
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total
