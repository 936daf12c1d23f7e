"""Kernel calls as units of an op analysis (``launch/op_analysis.py``).

``ANALYSIS`` is a context variable that holds the running analysis, or
None.  Each kernel call site (``kernels/ops.py`` and the backward of
``FlashAttention`` and ``RWKV6Scan``) goes through ``run``: with no
analysis running it calls its function and nothing else, so launches and
results are the same bits; under an analysis the call is one unit, costed
by the kernel's formula (``launch/roofline.kernel_cost``) from the
``shape`` the call site gives, while whatever runs inside it (the plain
version on the CPU, the wrapper's allocations on the card; on the
``meta`` device the kernel's outputs made from their shapes) goes
uncounted.  A plain version that autograd must
differentiate runs through ``_PlainUnit``, so that its backward is one
unit too (the kernel's backward), as the hand-written backward kernels
are on the card.
"""

from __future__ import annotations

from contextvars import ContextVar
from functools import partial

import torch

ANALYSIS: ContextVar = ContextVar("kernel_units_analysis", default=None)


def needs_grad(args) -> bool:
    return torch.is_grad_enabled() and any(
        torch.is_tensor(a) and a.requires_grad for a in args)


def run(name: str, shape: dict, fn, *args, like=None,
        backward: tuple[str, dict] | None = None, **kw):
    """``fn(*args, **kw)``; under an analysis, one unit ``name`` at
    ``shape``.  ``like(*args, **kw)`` makes the kernel's outputs without
    values: on the ``meta`` device it stands in for ``fn`` (a plain
    version there is only its shapes, and the rwkv scan's chunk loop
    alone would take minutes of Python a train step).  ``backward`` is
    (kernel, shape) of the unit a plain version's gradient is (``fn`` is
    then differentiated inside it)."""
    an = ANALYSIS.get()
    if an is None:
        return fn(*args, **kw)
    if like is not None and args[0].device.type == "meta":
        fn = like
    if backward is not None and needs_grad(args):
        return _PlainUnit.apply(an, name, shape, backward, partial(fn, **kw),
                                *args)
    return an.unit(name, shape, partial(fn, *args, **kw))


def run_in(an, name: str, shape: dict, fn, *args, **kw):
    """``run`` for an analysis captured earlier (a backward, which the
    autograd engine may run on another thread than its forward's)."""
    if an is None:
        return fn(*args, **kw)
    return an.unit(name, shape, partial(fn, *args, **kw))


class _PlainUnit(torch.autograd.Function):
    """A plain version as a unit, differentiated as another unit: the
    forward runs it without autograd; the backward runs it again with
    autograd and takes the gradient, all inside the backward's unit (on
    the ``meta`` device, where there are no values to differentiate, the
    gradients are packed empty tensors of the inputs' shapes, as the
    backward kernels write them)."""

    @staticmethod
    def forward(ctx, an, name, shape, backward, fn, *args):
        ctx.an, ctx.backward, ctx.fn = an, backward, fn
        ctx.save_for_backward(*args)
        return an.unit(name, shape, partial(fn, *args))

    @staticmethod
    def backward(ctx, *grads):
        args = ctx.saved_tensors
        need = ctx.needs_input_grad[5:]

        def vjp():
            if args[0].device.type == "meta":   # no values: shapes alone
                return tuple(torch.empty(a.shape, dtype=a.dtype,
                                         device=a.device) if n else None
                             for a, n in zip(args, need))
            with torch.enable_grad():
                xs = [a.detach().requires_grad_(n) for a, n in zip(args, need)]
                out = ctx.fn(*xs)
                outs = out if isinstance(out, tuple) else (out,)
                pairs = [(o, g) for o, g in zip(outs, grads)
                         if g is not None and o.requires_grad]
                ins = [x for x in xs if x.requires_grad]
                got = iter(torch.autograd.grad(
                    [o for o, _ in pairs], ins, [g for _, g in pairs],
                    allow_unused=True))
            return tuple(next(got) if n else None for n in need)

        return (None,) * 5 + ctx.an.unit(*ctx.backward, vjp)
