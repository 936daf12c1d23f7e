"""The rwkv6 scan's backward on the CPU: ``rwkv6_scan.plain_backward``
(the formulas the CUDA kernel ``csrc/rwkv6_scan_bwd.cu`` computes)
against autograd of ``plain`` and against ``jax.vjp`` of the JAX
package's sequential oracle ``repro.kernels.ref.rwkv6_ref``; the
dispatch of ``ops.rwkv6_scan`` under autograd; the wrappers' refusals.

Tolerances, each relative to the leaf's max |grad|:
  * ``plain_backward`` against autograd of ``plain`` on the same inputs:
    1e-12 in float64, 2e-5 in float32 (the two sum the same terms in
    other orders; measured: at most 1.4e-6, on dw at chunk 8);
  * against ``jax.vjp`` of ``rwkv6_ref`` (f32, the sequential
    recurrence, no clamp) at moderate decays, w in [exp(-e^-1),
    exp(-e^-4)] = [0.69, 0.98], where the chunked form needs no clamp
    even at chunk 64: ``plain_backward`` in float64 within 1e-4 (the
    oracle's own f32 rounding over T = 64 steps; measured: at most
    1.7e-6);
  * at decays down to exp(-e^1.5), where A_incl underflows within a
    chunk and the clamp max(A_incl, 1e-24) binds, against autograd of
    ``plain`` only: the oracle has no clamp, and the clamped chunked
    function is another function there.
"""

import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import rwkv6_ref  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rs  # noqa: E402

LEAVES = ("r", "k", "v", "w", "u", "state0")
AUTOGRAD_REL = {torch.float64: 1e-12, torch.float32: 2e-5}
ORACLE_REL = 1e-4


def _inputs(B, T, H, D, seed, decay=(-6.0, 1.5), dtype=np.float64):
    """r, k, v, state0 at half scale, u at unit scale, w = exp(-exp(ww))
    with ww uniform in ``decay``, and the cotangents dy and dS_T: numpy,
    from one seed."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, T, H, D)) for _ in range(3))
    w = np.exp(-np.exp(rng.uniform(*decay, (B, T, H, D))))
    u = rng.standard_normal((H, D))
    s0 = 0.5 * rng.standard_normal((B, H, D, D))
    dy = rng.standard_normal((B, T, H, D))
    dS = rng.standard_normal((B, H, D, D))
    return [a.astype(dtype) for a in (r, k, v, w, u, s0, dy, dS)]


def _autograd(xs, dy, dS, chunk):
    """Gradients of ``plain`` by autograd for cotangents (dy, dS)."""
    ts = [torch.from_numpy(a).requires_grad_() for a in xs]
    y, S = rs.plain(*ts, chunk=chunk)
    loss = (y * torch.from_numpy(dy)).sum()
    if dS is not None:
        loss = loss + (S * torch.from_numpy(dS)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, ts)]


def _mine(xs, dy, dS, chunk):
    return [g.numpy() for g in rs.plain_backward(
        *(torch.from_numpy(a) for a in xs), torch.from_numpy(dy),
        None if dS is None else torch.from_numpy(dS), chunk=chunk)]


def _close(got, want, rel, what):
    for name, g, w in zip(LEAVES, got, want):
        assert g.shape == w.shape, (what, name)
        top = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(np.asarray(g, np.float64) - w).max()) / top
        assert err <= rel, (what, name, err)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("T,chunk", [(32, 8), (128, 64), (40, 40)])
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("ds_T", [False, True])
def test_plain_backward_matches_autograd_of_plain(dtype, T, chunk, D, ds_T):
    """At the train chunk 8, chunk 64 and a 40-row ragged tail carrying
    a state (``timemix_parallel``'s split), head dims 16 and 64, with
    dS_T None and nonzero: every leaf equal to autograd's within
    ``AUTOGRAD_REL``.  Decays reach exp(-e^1.5) except in float32 past
    chunk 8: there A_incl falls to 1e-20 within a chunk and kA / A_incl,
    the gradient's own term, overflows float32 (autograd of ``plain``
    gives inf and nan alike), which is why training runs chunk 8; those
    cases take w >= 0.69."""
    npd = np.float64 if dtype == torch.float64 else np.float32
    decay = (-6.0, 1.5) if dtype == torch.float64 or chunk == 8 \
        else (-4.0, -1.0)
    *xs, dy, dS = _inputs(2, T, 2, D, seed=T + D, decay=decay, dtype=npd)
    dS = dS if ds_T else None
    got = _mine(xs, dy, dS, chunk)
    assert all(g.dtype == npd for g in got)
    _close(got, _autograd(xs, dy, dS, chunk), AUTOGRAD_REL[dtype],
           (T, chunk, D))


@pytest.mark.parametrize("chunk", [8, 64])
@pytest.mark.parametrize("D", [16, 64])
def test_plain_backward_matches_jax_vjp_of_the_sequential_oracle(chunk, D):
    """``plain_backward`` (float64) against ``jax.vjp`` of ``rwkv6_ref``
    (f32) at moderate decays: the chunked form's gradient is the
    recurrence's."""
    *xs, dy, dS = _inputs(2, 64, 2, D, seed=chunk + D, decay=(-4.0, -1.0))
    got = _mine(xs, dy, dS, chunk)
    f32 = [jnp.asarray(a, jnp.float32) for a in xs]
    _, vjp = jax.vjp(rwkv6_ref, *f32)
    want = vjp((jnp.asarray(dy, jnp.float32), jnp.asarray(dS, jnp.float32)))
    _close(got, [np.asarray(g, np.float64) for g in want], ORACLE_REL,
           (chunk, D))


@pytest.mark.parametrize("chunk", [8, 64])
def test_plain_backward_where_the_clamp_binds(chunk):
    """Decays near exp(-e^1.5) ~ 0.011: A_incl falls under 1e-24 within
    a 64-row chunk (in float64 too), so kA's divisor is clamped and
    passes no gradient; ``plain_backward`` equals autograd of ``plain``
    there (float64: in float32 the unclamped rows' kA / A_incl overflows
    at chunk 64, for autograd as for ``plain_backward``).  At chunk 8
    the clamp never binds (0.011^8 ~ 2e-16), in float64 and float32."""
    for dtype in (np.float64,) + ((np.float32,) if chunk == 8 else ()):
        *xs, dy, dS = _inputs(1, 64, 2, 16, seed=5, decay=(1.3, 1.5),
                              dtype=dtype)
        w = xs[3]
        cum = np.cumsum(np.log(w.reshape(1, -1, chunk, 2, 16)), axis=2)
        assert (chunk == 8) != bool((np.exp(cum) < rs.EPS).any())
        tdt = torch.float64 if dtype == np.float64 else torch.float32
        _close(_mine(xs, dy, dS, chunk), _autograd(xs, dy, dS, chunk),
               AUTOGRAD_REL[tdt], (chunk, dtype))


def test_plain_backward_on_given_states():
    """``states=`` (the chunk-start states the backward kernel reads from
    the forward kernel) replaces the forward sweep: given the sweep's own
    states the result is the same bits; given other states only the
    terms that read S move (du and dstate0 do not)."""
    *xs, dy, dS = _inputs(2, 32, 2, 16, seed=7)
    t = [torch.from_numpy(a) for a in xs]
    S, starts = t[5], []
    for c0 in range(0, 32, 8):
        starts.append(S)
        _, _, E, _, kA = rs._chunk_terms(*(a[:, c0:c0 + 8] for a in
                                           (t[0], t[1], t[3])))
        S = E[..., None] * S + torch.einsum(
            "bshk,bshv->bhkv", kA * E[:, None], t[2][:, c0:c0 + 8])
    states = torch.stack(starts, 2)
    assert torch.equal(rs.plain_states(*t[:4], t[5], chunk=8), states)
    base = rs.plain_backward(*t, torch.from_numpy(dy), torch.from_numpy(dS),
                             chunk=8)
    same = rs.plain_backward(*t, torch.from_numpy(dy), torch.from_numpy(dS),
                             chunk=8, states=states)
    assert all(torch.equal(a, b) for a, b in zip(base, same))
    moved = rs.plain_backward(*t, torch.from_numpy(dy), torch.from_numpy(dS),
                              chunk=8, states=states * 1.5)
    assert not torch.equal(moved[0], base[0])
    assert torch.equal(moved[4], base[4]) and torch.equal(moved[5], base[5])


def _states_case(case):
    *xs, _, _ = _inputs(2, 32, 2, 16, seed=11, dtype=np.float32)
    t = [torch.from_numpy(a) for a in xs]
    states = rs.plain_states(*t[:4], t[5], chunk=8)
    if case == "rounded":          # every state off by 1e-6 of its size
        states = states * (1 + 1e-6)
    elif case == "stale chunk":    # chunk 2 given chunk 1's start state
        states[:, :, 2] = states[:, :, 1]
    elif case == "one element":    # one element of chunk 3 off by 1e-2
        states[1, 1, 3, 4, 5] += 1e-2 * float(states[:, :, 3].abs().max())
    elif case == "not finite":
        states[0, 0, 1, 0, 0] = float("nan")
    return rs.states_error(states, *t[:4], chunk=8, tol=5e-4)


@pytest.mark.parametrize("case,held", [
    ("exact", True), ("rounded", True), ("stale chunk", False),
    ("one element", False), ("not finite", False)])
def test_states_error_holds_every_chunk(case, held):
    """``states_error`` (the rule that holds the forward kernel's
    chunk-start states to ``plain_states``, 5e-4 x max(1, the chunk's max
    |plain|) per chunk) passes states within rounding of plain's and
    fails a stale chunk, one wrong element past chunk 0 and a NaN."""
    assert (_states_case(case) <= 1.0) is held


@pytest.mark.parametrize("case,held", [
    ("plain fp32", True), ("zero dr", False), ("flipped dw", False),
    ("dk for dv", False), ("states moved", False)])
def test_backward_error_tells_a_wrong_gradient(case, held):
    """``backward_error`` (the rule that holds the backward kernel to
    ``plain_backward``) passes the fp32 ``plain_backward``'s own result
    (at most a third of its limit) and fails a zeroed or sign-flipped
    leaf, two leaves swapped, and gradients computed on other
    chunk-start states than the ones it is given."""
    *xs, dy, dS = _inputs(2, 32, 2, 16, seed=13, dtype=np.float32)
    t = [torch.from_numpy(a) for a in xs]
    dy, dS = torch.from_numpy(dy), torch.from_numpy(dS)
    states = rs.plain_states(*t[:4], t[5], chunk=8)
    g = list(rs.plain_backward(*t, dy, dS, chunk=8, states=states))
    if case == "zero dr":
        g[0] = torch.zeros_like(g[0])
    elif case == "flipped dw":
        g[3] = -g[3]
    elif case == "dk for dv":
        g[1], g[2] = g[2], g[1]
    elif case == "states moved":
        g = list(rs.plain_backward(*t, dy, dS, chunk=8, states=states * 1.01))
    _, frac, _ = rs.backward_error(g, *t, dy, dS, chunk=8, states=states)
    assert (frac <= 1.0) is held, frac
    if held:
        assert frac <= 1 / 3


def test_backward_error_refuses_a_malformed_gradient():
    """A non-finite leaf, or one in another type than fp32, raises."""
    *xs, dy, _ = _inputs(1, 16, 2, 16, seed=17, dtype=np.float32)
    t = [torch.from_numpy(a) for a in xs]
    dy = torch.from_numpy(dy)
    g = list(rs.plain_backward(*t, dy, chunk=8))
    bad = [g[0].double(), *g[1:]]
    with pytest.raises(ValueError, match="dr: torch.float64"):
        rs.backward_error(bad, *t, dy, chunk=8)
    g[4] = g[4].clone()
    g[4][0, 0] = float("inf")
    with pytest.raises(ValueError, match="a non-finite du"):
        rs.backward_error(g, *t, dy, chunk=8)


def test_ops_rwkv6_scan_differentiates_plain_on_the_cpu():
    """On CPU tensors ``ops.rwkv6_scan`` under grad is ``plain``, which
    autograd differentiates: its gradients equal ``plain_backward``'s,
    and no kernel launches."""
    *xs, dy, dS = _inputs(2, 24, 2, 16, seed=3, dtype=np.float32)
    ts = [torch.from_numpy(a).requires_grad_() for a in xs]
    f0, b0 = rs.rwkv6_scan.launches, rs.rwkv6_scan_bwd.launches
    y, S = ops.rwkv6_scan(*ts, chunk=8)
    assert y.grad_fn is not None and S.grad_fn is not None
    torch.autograd.backward((y, S), (torch.from_numpy(dy),
                                     torch.from_numpy(dS)))
    assert (rs.rwkv6_scan.launches, rs.rwkv6_scan_bwd.launches) == (f0, b0)
    _close([t.grad.numpy() for t in ts], _mine(xs, dy, dS, 8),
           AUTOGRAD_REL[torch.float32], "ops")


def test_the_kernel_paths_refuse_cpu_tensors():
    """``RWKV6Scan`` (the autograd path of the kernel wrapper) and the
    backward kernel's wrapper raise on CPU tensors, naming the kernel:
    never a quiet switch to a plain version."""
    *xs, dy, dS = (torch.from_numpy(a) for a in
                   _inputs(1, 16, 2, 16, seed=1, dtype=np.float32))
    grad = [t.clone().requires_grad_() for t in xs]
    with pytest.raises(ValueError, match="^rwkv6_scan kernel needs CUDA"):
        rs.RWKV6Scan.apply(*grad, 8)
    with pytest.raises(ValueError, match="^rwkv6_scan kernel needs CUDA"):
        rs.rwkv6_scan(*grad, chunk=8)
    states = torch.zeros((1, 2, 2, 16, 16))
    with pytest.raises(ValueError, match="^rwkv6_scan_bwd kernel needs "
                                         "CUDA"):
        rs.rwkv6_scan_bwd(*xs[:5], states, dy, dS, chunk=8)


def test_backward_kernel_source_covers_the_head_dims():
    """The head dims ``csrc/rwkv6_scan_bwd.cu`` instantiates are the
    forward's, its chain instances are ``CHAIN_SPLITS``, and the build
    lists the source."""
    src = (pathlib.Path(rs.__file__).parent / "csrc" / "rwkv6_scan_bwd.cu"
           ).read_text()
    dims = {int(d) for d in re.findall(r"^\s*RWKV6_BWD_CASE\((\d+)\)$", src,
                                       re.M)}
    assert dims == set(rs.HEAD_DIMS)
    chains = set(re.findall(r"^\s*RWKV6_BWD_CHAIN\((\d+), (\d+)\)$", src,
                            re.M))
    assert chains == {(str(d), str(dv)) for d, dvs in rs.CHAIN_SPLITS.items()
                      for dv in dvs}
    assert "rwkv6_scan_bwd" in build.KERNELS
    assert rs.backward_kernel is rs.rwkv6_scan_bwd


def _suffix_dstate0(xs, dy, dS, chunk, c0):
    """The gradient of the state at the start of chunk ``c0``: dstate0 of
    ``plain_backward`` on the rows from chunk ``c0`` on, started from the
    forward's state there (dS_T itself past the last chunk)."""
    t = [torch.from_numpy(a) for a in xs]
    T = t[0].shape[1]
    if c0 * chunk == T:
        return torch.from_numpy(dS) if dS is not None else torch.zeros_like(
            t[5])
    states = rs.plain_states(*t[:4], t[5], chunk=chunk)
    sl = slice(c0 * chunk, T)
    return rs.plain_backward(*(a[:, sl] for a in t[:4]), t[4],
                             states[:, :, c0], torch.from_numpy(dy)[:, sl],
                             None if dS is None else torch.from_numpy(dS),
                             chunk=chunk)[5]


@pytest.mark.parametrize("D", [16, 32, 64])
@pytest.mark.parametrize("T,chunk", [(32, 4), (64, 8), (256, 64)])
@pytest.mark.parametrize("ds_T", [False, True])
def test_plain_dstate_is_the_gradient_plain_backward_carries(D, T, chunk,
                                                            ds_T):
    """``plain_dstate`` (the backward chain's plain version) in float64:
    checkpoint g equals the gradient of the end state of chunk min((g + 1)
    group, NC) - 1 that ``plain_backward`` carries there (its dstate0 on
    the rows after that chunk), and dstate0 its dstate0, within 1e-12 of
    the leaf's max; group 3 leaves a ragged last group."""
    *xs, dy, dS = _inputs(1, T, 2, D, seed=T + D)
    dS = dS if ds_T else None
    NC, group = T // chunk, 3
    ck, ds0 = rs.plain_dstate(*(torch.from_numpy(a) for a in
                                (xs[0], xs[3], dy)),
                              None if dS is None else torch.from_numpy(dS),
                              chunk=chunk, group=group)
    assert ck.shape == (1, 2, -(-NC // group), D, D)
    want = [_suffix_dstate0(xs, dy, dS, chunk, min((g + 1) * group, NC))
            for g in range(ck.shape[2])]
    for got, ref in [*zip(ck.unbind(2), want),
                     (ds0, _suffix_dstate0(xs, dy, dS, chunk, 0))]:
        top = max(float(ref.abs().max()), 1e-30)
        assert float((got - ref).abs().max()) <= 1e-12 * top


@pytest.mark.parametrize("case,held", [
    ("plain fp32", True), ("zero checkpoint", False),
    ("other group", False), ("dstate0 moved", False)])
def test_dstate_error_tells_a_wrong_checkpoint(case, held):
    """``dstate_error`` (``backward_error``'s rule for the chain's
    checkpoints and dstate0) passes the fp32 ``plain_dstate``'s own
    result and fails a zeroed checkpoint, checkpoints of another group
    size and a moved dstate0."""
    *xs, dy, dS = _inputs(2, 64, 2, 16, seed=19, dtype=np.float32)
    r, w, dy, dS = (torch.from_numpy(a) for a in (xs[0], xs[3], dy, dS))
    ck, ds0 = rs.plain_dstate(r, w, dy, dS, chunk=8, group=3)
    if case == "zero checkpoint":
        ck = ck.clone()
        ck[1, 0, 1] = 0
    elif case == "other group":
        ck = rs.plain_dstate(r, w, dy, dS, chunk=8, group=2)[0][:, :, :3]
    elif case == "dstate0 moved":
        ds0 = ds0 * 1.01
    _, frac, _ = rs.dstate_error(ck, ds0, r, w, dy, dS, chunk=8, group=3)
    assert (frac <= 1.0) is held, frac


def test_group_and_chain_split_rules():
    """The backward's two rules at rwkv6-7b's train shape (B 4, H 64, D
    64, 192 chunks of 8), at its prefill chunk 64 (B 1, 24 chunks), on a
    ragged last group, with fewer chunks than a group and with one chunk;
    and the refusals."""
    G = rs.groups(4, 64, 192)
    assert G == 8 and 192 % G == 0
    assert 4 * 64 * (192 // G) >= rs.BODY_WAVES * 2 * rs.SMS
    assert 4 * 64 * -(-192 // (2 * G)) < rs.BODY_WAVES * 2 * rs.SMS
    assert rs.groups(1, 64, 24) == 1                  # chunk 64, B 1
    assert rs.groups(4, 64, 150) == 8 and 150 % 8 == 6  # 19 groups, ragged
    assert rs.groups(128, 64, 3) == rs.MAX_GROUP > 3  # fewer chunks than G
    assert rs.groups(2, 3, 1) == 1                    # one chunk
    assert rs.chain_split(4, 64, 64) == 64            # 256 CTAs
    assert rs.chain_split(1, 64, 64) == 16            # 256 CTAs
    assert rs.chain_split(1, 64, 32) == 16
    assert rs.chain_split(2, 3, 16) == 16
    for bad in ((0, 64, 192), (4, 64, 0)):
        with pytest.raises(ValueError):
            rs.groups(*bad)
    with pytest.raises(ValueError):
        rs.chain_split(1, 1, 48)
