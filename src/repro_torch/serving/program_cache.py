"""Process-wide program cache: engines of one geometry share programs.

The JAX package memoizes its jitted step callables here so the second
engine of a geometry skips the XLA compile.  The port keeps the same
registry and key contract; its "programs" are the engine's step
callables (``functools.partial`` over the step functions), and sharing
them per key is what a later CUDA-graph capture per geometry will hang
off.

Key contract (see ROADMAP Contracts): two engines are served the SAME
programs iff they agree on every element of

    (program family,            # "dense" | "paged"
     cfg identity,              # the ModelConfig object (by identity)
     mesh, partition rules,     # by identity (None on one card)
     batch geometry,            # slots/rows, max_len
     page geometry)             # page_size, pool pages (paged only)

Same key => same programs => the one-geometry-one-program contract's
bit-reproducibility carries across engines served from one entry: a
spawned engine decodes token-identically to the donor whose programs it
reuses, because it IS running the donor's programs.  Identity keys are
pinned (the entry holds strong references), so a recycled ``id()`` can
never alias two configs.

Each entry also tracks which program keys (``"decode"``,
``"prefill[plen=N]"``, ...) have already executed once through it, so
an engine can tell a first run of a program (which pays one-time
set-up, such as the kernels' build at first use) from a warm one.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass
class ProgramSet:
    """One cache entry: the shared step callables for one key, plus
    the program keys already executed through them."""
    key: tuple
    fns: dict[str, Any]              # program kind -> step callable
    compiled: set[str] = field(default_factory=set)
    served: int = 0                  # engines constructed from this entry
    pins: tuple = ()                 # strong refs: id()-keyed parts stay alive


_lock = threading.Lock()
_sets: dict[tuple, ProgramSet] = {}


def program_key(family: str, cfg, mesh, rules, *, slots: int,
                max_len: int, page_size: int = 0, pages: int = 0) -> tuple:
    """The full sharing key.  ``cfg``/``mesh``/``rules`` key by identity
    (entries pin them, so ids stay unambiguous); the config name rides
    along for readable stats."""
    return (family, getattr(cfg, "name", None), id(cfg), id(mesh),
            id(rules), slots, max_len, page_size, pages)


def get_programs(family: str, cfg, mesh, rules, *, slots: int,
                 max_len: int, page_size: int = 0, pages: int = 0,
                 build: Callable[[], dict]) -> tuple[ProgramSet, bool]:
    """Fetch (or build-and-register) the program set for a key.

    Returns ``(set, cache_hit)``: ``cache_hit`` is True when an earlier
    engine already registered this key -- the caller reuses programs
    whose first runs (tracked in ``set.compiled``) are already paid."""
    key = program_key(family, cfg, mesh, rules, slots=slots,
                      max_len=max_len, page_size=page_size, pages=pages)
    with _lock:
        ps = _sets.get(key)
        if ps is not None:
            ps.served += 1
            return ps, True
        ps = ProgramSet(key=key, fns=build(), pins=(cfg, mesh, rules))
        _sets[key] = ps
        return ps, False


def clear():
    """Drop every entry (tests/benches: force the next engine of any
    geometry to rebuild its programs).  Live engines
    keep the program sets they already hold."""
    with _lock:
        _sets.clear()


def stats() -> dict:
    """Registry digest: entries, engines served beyond the first, and
    program keys executed."""
    with _lock:
        entries = list(_sets.values())
    return {
        "entries": len(entries),
        "cache_hits": sum(ps.served for ps in entries),
        "programs_compiled": sum(len(ps.compiled) for ps in entries),
    }
