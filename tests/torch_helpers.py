"""Shared pieces of the tests that hold the PyTorch port against the JAX
package: the JAX parameter tree as numpy (bf16 as uint16 bits), and the
tiny llama both packages build."""

import jax
import jax.numpy as jnp
import numpy as np


def to_numpy(tree):
    """A JAX tree as numpy leaves; bf16 leaves as their uint16 bits."""
    def one(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a
    return jax.tree.map(one, tree)


def configs(dtype="bfloat16"):
    """The tiny llama-1.5b of both packages: (jax cfg, torch cfg)."""
    from repro.configs import get as jget
    from repro.configs.tiny import make_tiny as jtiny
    from repro_torch.configs import get as tget
    from repro_torch.configs.tiny import make_tiny as ttiny
    return (jtiny(jget("llama-1.5b")).replace(dtype=dtype),
            ttiny(tget("llama-1.5b")).replace(dtype=dtype))


def bridged_params(jcfg, seed=0):
    """JAX ``init_params`` and the same weights carried into torch."""
    from repro.models.init import init_params
    from repro_torch.models.init import params_from_numpy
    jp = init_params(jcfg, jax.random.key(seed))
    return jp, params_from_numpy(to_numpy(jp), device="cpu")


def as_f32(x) -> np.ndarray:
    """A JAX array or torch tensor as float32 numpy."""
    if hasattr(x, "detach"):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# the fleet layer: both packages behind one namespace
# ---------------------------------------------------------------------------

def assert_conserved(fleet):
    """The port's copy of ``tests/helpers.assert_conserved``: every
    ticketed request lives in exactly one place (pending work, in flight
    on a registered healthy engine, or a terminal state), and each
    healthy engine's admission ledger agrees with a walk over its rows."""
    from repro_torch.fleet import TERMINAL_STATES
    queued = {it.rid for it in fleet.queue.ordered()}
    inflight = set(fleet.inflight)
    assert not queued & inflight, f"duplicated: {queued & inflight}"
    for rid, ticket in fleet.tickets.items():
        places = ((rid in queued) + (rid in inflight)
                  + (ticket.state in TERMINAL_STATES))
        assert places == 1, \
            f"{rid} in {places} places (state {ticket.state.value})"
    for rid, (req, hname, _) in fleet.inflight.items():
        assert hname in fleet.handles, f"{rid} on deregistered {hname}"
        assert fleet.handles[hname].healthy, f"{rid} on dead {hname}"
    for name, handle in fleet.handles.items():
        if not handle.healthy:
            continue
        eng = handle.engine
        if getattr(eng, "paged", False):
            eng.check()
            cache = getattr(eng, "prefix_cache", None)
            cached = cache.pages_held if cache is not None else 0
            shared = getattr(eng, "_shared", {})
            held = sum(len(eng._row_pages(row)) - len(shared.get(row, ()))
                       for row in eng.requests)
            assert eng.allocator.used_pages == held + cached, \
                (name, eng.allocator.used_pages, held, cached)
            evictable = cache.evictable_pages() if cache is not None else 0
            want = ((eng.allocator.free_pages + evictable) * eng.page_size
                    if eng.free_slots else 0)
            assert eng.free_token_budget == want, (name,)
        elif hasattr(eng, "free_token_budget"):
            assert len(eng.free_slots) == eng.slots - len(eng.requests)
            assert eng.free_token_budget \
                == len(eng.free_slots) * eng.max_len, (name,)


def jax_int8_round_trip(jparams):
    """The lite tier's weights on the JAX side: the JAX per-tensor
    symmetric int8 round trip of every floating leaf (as
    ``tests/test_fleet_quality.py``).  The port's side is
    ``repro_torch.optim.compression.int8_round_trip``."""
    from repro.optim.compression import dequantize_int8, quantize_int8

    def f(w):
        if hasattr(w, "dtype") and jnp.issubdtype(w.dtype, jnp.floating):
            q, s = quantize_int8(w)
            return dequantize_int8(q, s).astype(w.dtype)
        return w
    return jax.tree.map(f, jparams)


_FLEET_WEIGHTS = {}


def fleet_weights(dtype="bfloat16"):
    """The fleet tests' three tiers on both packages: the tiny llama's
    seed-0 weights (``full``), their int8 round trip (``lite``, by each
    package's own quantizer) and a half-depth config from seed 9
    (``mini``).  Returns ``{side: {tier: (cfg, params)}}`` with side
    ``"jax"`` or ``"torch"``; the torch ``full`` and ``mini`` params are
    the JAX ones bridged."""
    if dtype in _FLEET_WEIGHTS:
        return _FLEET_WEIGHTS[dtype]
    from repro.models.init import init_params
    from repro_torch.models.init import params_from_numpy
    jcfg, tcfg = configs(dtype)
    half = max(len(jcfg.blocks) // 2, 1)
    jsm = jcfg.replace(name=jcfg.name + "-sm", blocks=jcfg.blocks[:half])
    tsm = tcfg.replace(name=tcfg.name + "-sm", blocks=tcfg.blocks[:half])
    jfull = init_params(jcfg, jax.random.key(0))
    from repro_torch.optim.compression import int8_round_trip
    jlite = jax_int8_round_trip(jfull)
    jmini = init_params(jsm, jax.random.key(9))
    bridge = lambda p: params_from_numpy(to_numpy(p), device="cpu")  # noqa
    tfull = bridge(jfull)
    # each package's own quantizer: bit-equal leaf for leaf
    # (tests/test_torch_fleet_autoscale.py holds them so)
    out = {"jax": {"full": (jcfg, jfull), "lite": (jcfg, jlite),
                   "mini": (jsm, jmini)},
           "torch": {"full": (tcfg, tfull),
                     "lite": (tcfg, int8_round_trip(tfull)),
                     "mini": (tsm, bridge(jmini))}}
    _FLEET_WEIGHTS[dtype] = out
    return out


def fleet_side(side: str, dtype="bfloat16"):
    """One package's fleet surface as a namespace, so one scenario runs
    on both: ``side`` is ``"jax"`` (``repro``) or ``"torch"``
    (``repro_torch``).  Device profiles are the JAX package's constants
    on both sides (the port's own ``CLOUD`` is the H100's, so parity
    tests hand both the same explicit profiles); ``engine`` and
    ``paged`` build CPU engines of a tier."""
    import dataclasses
    import importlib
    from types import SimpleNamespace

    from repro.core import daemon as jdaemon
    pkg = {"jax": "repro", "torch": "repro_torch"}[side]
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa
    fleet, daemon = mod("fleet"), mod("core.daemon")
    channel, engine, paged = (mod("core.channel"), mod("serving.engine"),
                              mod("serving.paged"))
    weights = fleet_weights(dtype)[side]
    dev = {} if side == "jax" else {"device": "cpu"}
    prof = {n: daemon.DeviceProfile(**dataclasses.asdict(
        getattr(jdaemon, n))) for n in ("CLOUD", "EDGE", "MCU")}

    def mk_engine(tier="full", **kw):
        cfg, params = weights[tier]
        return engine.Engine(cfg, params, **kw, **dev)

    def mk_paged(tier="full", **kw):
        cfg, params = weights[tier]
        return paged.PagedEngine(cfg, params, **kw, **dev)

    ns = SimpleNamespace(
        side=side, cfg=weights["full"][0], weights=weights,
        engine=mk_engine, paged=mk_paged, Request=engine.Request,
        SimClock=channel.SimClock, NetworkCondition=channel.NetworkCondition,
        TrustAuthority=mod("core.attestation").TrustAuthority,
        DeviceProfile=daemon.DeviceProfile,
        Daemon=daemon.PrivacyAwareDaemon,
        replication=mod("core.replication"),
        workspace=mod("core.workspace"),
        FULL=fleet.QualityTier("full", 1.0, "bf16"),
        LITE=fleet.QualityTier("lite", 0.6, "int8"),
        MINI=fleet.QualityTier("mini", 0.3, "small"), **prof)
    for name in fleet.__all__:
        setattr(ns, name, getattr(fleet, name))
    return ns


def fleet_record(fleet, outputs=True) -> dict:
    """What a fleet run decided, in plain values both packages can be
    compared on: each request's engines and final tier, each ticket's
    state sequence, the audit log's event kinds in order, the migration
    records, the integer telemetry counters, the tracer's span tree
    shape, and (``outputs``) every ticket's committed tokens."""
    tel = fleet.telemetry
    s = tel.summary()
    engines = {n: {k: v for k, v in e.items() if k != "tokens_per_s"}
               for n, e in s["engines"].items()}
    rec = {
        "placements": {r: list(h) for r, h in fleet.placements.items()},
        "tiers": {r: fleet.handles[h[-1]].tier.name
                  if h and h[-1] in fleet.handles else None
                  for r, h in fleet.placements.items()},
        "states": {r: [ev.dst for ev in t.events]
                   for r, t in fleet.tickets.items()},
        "audit": [(ev.kind, getattr(ev, "rid", None),
                   getattr(ev, "dst", getattr(ev, "direction",
                                              getattr(ev, "action", None))))
                  for ev in tel.events],
        "migrations": [(m.rid, m.src, m.dst, m.lossy, m.reason)
                       for m in tel.migrations],
        "counters": {
            "fleet": {k: s["fleet"][k] for k in
                      ("tokens", "rejected", "failovers", "migrations")},
            "lifecycle": {k: v for k, v in s["lifecycle"].items()
                          if not k.endswith("_p50")},
            "engines": engines, "prefix": s["prefix"]},
    }
    if fleet.tracer is not None:
        spans = fleet.tracer.spans
        by_id = {sp.span_id: sp for sp in spans}
        rec["spans"] = [(sp.trace_id, sp.kind, sp.name,
                         by_id[sp.parent_id].name
                         if sp.parent_id in by_id else None)
                        for sp in spans]
    if outputs:
        rec["outputs"] = {r: list(t.output)
                          for r, t in fleet.tickets.items()}
    return rec


def jax_top2_gap(jcfg, jparams, tokens) -> float:
    """The JAX model's top-2 logit gap for the token after ``tokens``
    (a plain forward over the whole stream)."""
    from repro.models.model import forward, vocab_mask_logits
    lg, _, _ = forward(jparams, {"tokens": jnp.asarray(tokens,
                                                       jnp.int32)[None]},
                       cfg=jcfg, mode="train")
    top2 = jax.lax.top_k(vocab_mask_logits(lg[0, -1], jcfg)
                         .astype(jnp.float32), 2)[0]
    return float(top2[0] - top2[1])


def greedy_agreement(jouts: dict, touts: dict, prompts: dict, jcfg,
                     jparams) -> tuple[float, dict]:
    """Token agreement of two packages' greedy outputs and, per request
    that diverged, the JAX top-2 logit gap at its first divergence."""
    matched = total = 0
    gaps = {}
    for rid, jo in jouts.items():
        to = touts[rid]
        assert len(jo) == len(to), (rid, jo, to)
        total += len(jo)
        for i, (a, b) in enumerate(zip(jo, to)):
            if a != b:
                gaps[rid] = jax_top2_gap(
                    jcfg, jparams, list(prompts[rid]) + list(jo[:i]))
                break
            matched += 1
    return matched / max(total, 1), gaps


# ---------------------------------------------------------------------------
# the examples: the JAX example and the port's scenario, printed lines
# ---------------------------------------------------------------------------

def jax_example(name: str):
    """The JAX package's ``examples/<name>.py``, loaded from its file as
    it stands (it is not a package)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def captured(fn, *args, **kw) -> tuple:
    """``fn(*args, **kw)``'s result and the lines it printed."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue().splitlines()


def jax_profiles() -> dict:
    """The JAX package's device profiles as the port's ``DeviceProfile``
    (the port's own ``CLOUD`` is the H100's): ``mcu``, ``edge``,
    ``cloud``."""
    import dataclasses

    from repro.core import daemon as jdaemon
    from repro_torch.core.daemon import DeviceProfile
    return {n.lower(): DeviceProfile(**dataclasses.asdict(
        getattr(jdaemon, n))) for n in ("MCU", "EDGE", "CLOUD")}


def masked(lines, masks) -> list:
    """``lines`` with every mask's pattern replaced.  A mask is
    ``(pattern, replacement, reason)``; the replacement may be a
    function of the match (a canonical form, as for a dict whose order
    is a set's)."""
    import re
    out = []
    for line in lines:
        for pattern, repl, _ in masks:
            line = re.sub(pattern, repl, line)
        out.append(line)
    return out


def assert_same_lines(jax_lines, port_lines, masks):
    """The port's printed lines equal the JAX example's, line for line,
    after ``masks``; each mask must match in the JAX output (a mask that
    covers nothing is a mistake in the test)."""
    import re
    for pattern, _, reason in masks:
        assert any(re.search(pattern, ln) for ln in jax_lines), \
            f"mask {pattern!r} ({reason}) matches no JAX line"
    j, t = masked(jax_lines, masks), masked(port_lines, masks)
    assert len(j) == len(t), (j, t)
    for a, b in zip(j, t):
        assert a == b, f"\nJAX : {a}\nport: {b}"
