"""Chunked RWKV6 linear attention: the CUDA kernel's wrapper and its plain
version.

``rwkv6_scan`` launches ``csrc/rwkv6_scan.cu`` (the Hopper counterpart of
the Pallas ``repro/kernels/rwkv6_scan.py``) on CUDA tensors and refuses
anything else; ``plain`` is the same function in plain PyTorch: a loop
over chunks with the formulas of the chunk body of
``repro/models/rwkv6.py::timemix_parallel``, which the CPU path and the
on-card comparison use.

The kernel splits each head over blocks of DV value columns, one CTA a
(batch, head, block); ``split`` picks DV by a pure rule of the shape,
never from a failed build or launch.  ``aligned`` picks how the
kernel loads: by TMA where every row of r, k, v and w starts on a
16-byte boundary, else by 4-byte copies, with the same result.

Where autograd needs the gradient (grad mode on and an input that
requires it) the call goes through ``RWKV6Scan``: its forward launches
the same kernel with the chunk-start states as a third output
(``forward_with_states``), and its backward launches
``csrc/rwkv6_scan_bwd.cu`` (``rwkv6_scan_bwd``), a kernel of the port's
own: the JAX package differentiates the jnp chunk body
(``repro/models/rwkv6.py::timemix_parallel``) and has no Pallas
backward.  ``plain_backward`` is that backward in plain PyTorch, written
out as its formulas (no autograd), against which the tests and
``chip_smoke.py`` hold the backward kernel by one rule
(``backward_error``), and ``plain_states`` the forward's chunk-start
states, against which they hold the kernel's (``states_error``).

The backward runs as two device kernels a call: a chain that carries
only the gradient of the state through the chunks and writes it every
``groups(...)`` chunks as a checkpoint (its columns split by
``chain_split``), and a body that walks the groups of chunks in parallel
from those checkpoints.  ``plain_dstate`` is the chain in plain PyTorch,
against which ``dstate_error`` holds the checkpoints.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, units

NAME = "rwkv6_scan"
BWD_NAME = "rwkv6_scan_bwd"
HEAD_DIMS = (16, 32, 64)
MAX_CHUNK = 64
EPS = 1e-24                 # the clamp of kA's divisor, max(A_incl, EPS)
# value columns a CTA owns (the kernel's DV), by head dim: at D = 64, 32
# (B = 1, H = 64: 128 CTAs of 16 warps, one an SM); below it, 16
SPLIT = {16: 16, 32: 16, 64: 32}
# the backward's rules (``groups``, ``chain_split``): the card's SMs, the
# waves of body CTAs a group size must fill (two CTAs an SM), the largest
# group, and the value-column blocks the chain kernel has instances for
SMS = 132
BODY_WAVES = 16
MAX_GROUP = 32
CHAIN_SPLITS = {16: (16,), 32: (16, 32), 64: (16, 32, 64)}


def split(B: int, H: int, D: int) -> int:
    """DV, the value columns one CTA owns, for (B, H, D): one per head
    dim, ``SPLIT[D]``; the kernel source has an instance for each."""
    if D not in SPLIT or B < 1 or H < 1:
        raise ValueError(f"no split for B={B} H={H} D={D}")
    return SPLIT[D]


def groups(B: int, H: int, NC: int) -> int:
    """G, the chunks one CTA of the backward's body walks from its
    checkpoint: the largest power of two up to ``MAX_GROUP`` whose CTAs,
    B H ceil(NC / G), fill ``BODY_WAVES`` waves of two CTAs an SM; 1 where
    none does.  A ragged last group (NC not a multiple of G) and G > NC
    are both taken."""
    if B < 1 or H < 1 or NC < 1:
        raise ValueError(f"no group size for B={B} H={H} NC={NC}")
    want, G = BODY_WAVES * 2 * SMS, 1
    while 2 * G <= MAX_GROUP and B * H * -(-NC // (2 * G)) >= want:
        G *= 2
    return G


def chain_split(B: int, H: int, D: int) -> int:
    """DV, the value columns one CTA of the backward's chain owns: the
    widest of ``CHAIN_SPLITS[D]`` whose CTAs, (D / DV) B H, give every SM
    one; else the narrowest.  Each CTA of a head forms that head's decays
    again, so the widest that fills the card does the least work."""
    if D not in CHAIN_SPLITS or B < 1 or H < 1:
        raise ValueError(f"no chain split for B={B} H={H} D={D}")
    for dv in reversed(CHAIN_SPLITS[D]):
        if D // dv * B * H >= SMS:
            return dv
    return CHAIN_SPLITS[D][0]


def aligned(r, k, v, w) -> bool:
    """Whether the kernel may load r, k, v, w by TMA: every pointer
    16-byte aligned and every (batch, time, head) stride a multiple of 4
    elements (a size-1 dim's stride is never stepped)."""
    for t in (r, k, v, w):
        if t.data_ptr() % 16:
            return False
        if any(t.stride(i) % 4 for i in range(3) if t.shape[i] > 1):
            return False
    return True


_fns: dict = {}


def _bind():
    fn = _fns.get(NAME)
    if fn is None:
        fn = build.load(NAME).rwkv6_scan_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, P, P, P]
        fn.restype = I
        _fns[NAME] = fn
    return fn


def _bind_bwd():
    fn = _fns.get(BWD_NAME)
    if fn is None:
        fn = build.load(BWD_NAME).rwkv6_scan_bwd_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 15 + [I] * 8 + [P]
        fn.restype = I
        _fns[BWD_NAME] = fn
    return fn


def _chunk(T: int, chunk: int) -> int:
    chunk = min(chunk, T)
    if chunk < 1 or T % chunk:
        raise ValueError(f"T={T} is not a multiple of chunk={chunk}: split "
                         "off the ragged tail first (as timemix_parallel "
                         "does)")
    return chunk


def _check(r, k, v, w, u, state0, chunk, kernel=NAME):
    tensors = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
               ("state0", state0))
    for name, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{kernel} kernel needs CUDA tensors; {name} "
                             f"is on {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{kernel} kernel takes float32; {name} is "
                             f"{t.dtype}")
    if len({t.device for _, t in tensors}) != 1:
        raise ValueError("inputs on different devices")
    if r.ndim != 4:
        raise ValueError(f"r must be (B, T, H, D), got {tuple(r.shape)}")
    B, T, H, D = r.shape
    for name, t in tensors[1:4]:
        if t.shape != r.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != r {tuple(r.shape)}")
    if u.shape != (H, D) or state0.shape != (B, H, D, D):
        raise ValueError(f"u {tuple(u.shape)} / state0 "
                         f"{tuple(state0.shape)}: need ({H}, {D}) / "
                         f"({B}, {H}, {D}, {D})")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk} > {MAX_CHUNK}")
    # r/k/v/w are read in place through their (B, T, H) strides
    for name, t in tensors[:4]:
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a unit-stride head dim; strides "
                             f"{t.stride()}")
    for name, t in tensors[4:]:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(r, k, v, w, u, state0, chunk, with_states):
    """One launch of the forward kernel: (out, final state), and with
    ``with_states`` also the state at the start of every chunk, (B, H,
    T / chunk, D, D) fp32, which the backward reads."""
    chunk = _chunk(r.shape[1], chunk)
    _check(r, k, v, w, u, state0, chunk)
    fn = _bind()
    B, T, H, D = r.shape
    dv = split(B, H, D)
    out = torch.empty((B, T, H, D), dtype=torch.float32, device=r.device)
    stateT = torch.empty_like(state0)
    states = (torch.empty((B, H, T // chunk, D, D), dtype=torch.float32,
                          device=r.device) if with_states else None)
    strides = (ctypes.c_longlong * 12)(*r.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *w.stride()[:3])
    with build.on_device(r):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), state0.data_ptr(), out.data_ptr(),
                 stateT.data_ptr(), B, T, H, D, chunk, dv,
                 int(aligned(r, k, v, w)),
                 ctypes.cast(strides, ctypes.c_void_p), stream,
                 states.data_ptr() if with_states else None)
    if err != 0:
        what = {-1: "shape refused", -2: "tensor map not encoded"}.get(
            err, f"cudaError {err}")
        raise RuntimeError(f"rwkv6_scan launch failed (split {dv}): {what}")
    build.count_launch(rwkv6_scan)
    return out, stateT, states


def rwkv6_scan(r, k, v, w, u, state0, *, chunk=64):
    """r,k,v,w: (B,T,H,D) fp32 on the card (w = per-step decay in (0,1));
    u: (H,D); state0: (B,H,D,D) fp32.  Returns (out (B,T,H,D) fp32,
    final state (B,H,D,D)).  Same signature as the Pallas kernel; T must
    be a multiple of ``min(chunk, T)``.  Where autograd needs the
    gradient, through ``RWKV6Scan``."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u, state0)):
        return RWKV6Scan.apply(r, k, v, w, u, state0, chunk)
    return _launch(r, k, v, w, u, state0, chunk, False)[:2]


rwkv6_scan.launches = 0


def forward_with_states(r, k, v, w, u, state0, *, chunk=64):
    """The forward kernel with its third output: (out, final state, the
    state at the start of each chunk (B, H, T / chunk, D, D)).  out and
    the final state are the same bits as ``rwkv6_scan``'s."""
    return _launch(r, k, v, w, u, state0, chunk, True)


def rwkv6_scan_bwd(r, k, v, w, u, states, dy, dS_T=None, *, chunk=64,
                   group=None, dv=None, checkpoints=False):
    """dr, dk, dv, dw (B, T, H, D), du (H, D) and dstate0 (B, H, D, D)
    of ``rwkv6_scan`` at ``chunk`` from its inputs, the chunk-start
    states of ``forward_with_states``, the output's gradient ``dy`` and
    the final state's ``dS_T`` (None: zeros), all fp32.  Two device
    kernels, counted as one launch: the chain (grid (D / dv, H, B)) writes
    the state's gradient at the end of every ``group``-th chunk, and the
    body (grid (ceil(T / chunk / group), H, B)) walks each group from its
    checkpoint.  ``group`` and ``dv`` default to ``groups`` and
    ``chain_split``; the result is the same bits whatever they are.  The
    body's du partials (B, H, groups, D) are summed over the groups, then
    the batch, here.  With ``checkpoints`` the chain's checkpoints (B, H,
    groups, D, D) come last."""
    chunk = _chunk(r.shape[1], chunk)
    B, T, H, D = r.shape
    # the kernels read packed rows; a strided input is packed here first
    r, k, v, w, u, states, dy = (t.contiguous() for t in (r, k, v, w, u,
                                                          states, dy))
    dS = (torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
          if dS_T is None else dS_T.contiguous())
    _check(r, k, v, w, u, dS, chunk, BWD_NAME)
    NC = T // chunk
    for name, t, shape in (("dy", dy, (B, T, H, D)),
                           ("states", states, (B, H, NC, D, D))):
        if t.shape != shape or t.dtype != torch.float32 \
                or t.device != r.device:
            raise ValueError(f"{BWD_NAME}: {name} must be fp32 {shape} on "
                             f"{r.device}; got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if states.data_ptr() % 16:   # the body reads its rows as 16-byte vectors
        raise ValueError(f"{BWD_NAME}: states must start on 16 bytes")
    G = groups(B, H, NC) if group is None else group
    DV = chain_split(B, H, D) if dv is None else dv
    if G < 1 or DV not in CHAIN_SPLITS[D]:
        raise ValueError(f"{BWD_NAME}: group {G} / dv {DV}: need group >= 1 "
                         f"and dv in {CHAIN_SPLITS[D]}")
    NG = -(-NC // G)
    fn = _bind_bwd()
    dr, dk, dv_, dw = (torch.empty_like(r) for _ in range(4))
    du_part = torch.empty((B, H, NG, D), dtype=torch.float32,
                          device=r.device)
    ds0 = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    ckpt = torch.empty((B, H, NG, D, D), dtype=torch.float32,
                       device=r.device)
    tma = aligned(r, k, v, w) and dy.data_ptr() % 16 == 0
    with build.on_device(r):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), states.data_ptr(), dy.data_ptr(),
                 dS.data_ptr(), dr.data_ptr(), dk.data_ptr(), dv_.data_ptr(),
                 dw.data_ptr(), du_part.data_ptr(), ds0.data_ptr(),
                 ckpt.data_ptr(), B, T, H, D, chunk, G, DV, int(tma), stream)
    if err != 0:
        what = {-1: "shape refused", -2: "tensor map not encoded"}.get(
            err, f"cudaError {err}")
        raise RuntimeError(f"{BWD_NAME} launch failed (group {G}, dv "
                           f"{DV}): {what}")
    build.count_launch(rwkv6_scan_bwd)
    out = (dr, dk, dv_, dw, du_part.sum(2).sum(0), ds0)
    return (*out, ckpt) if checkpoints else out


rwkv6_scan_bwd.launches = 0
# what ``RWKV6Scan.backward`` calls, looked up at each call:
# ``chip_smoke.py`` wraps it to hold every backward call of a train step
# to ``plain_backward`` on its own inputs
backward_kernel = rwkv6_scan_bwd


class RWKV6Scan(torch.autograd.Function):
    """``rwkv6_scan`` with its gradient: the forward kernel with the
    chunk-start states, the backward kernel for every input's gradient.
    A backward that fails to build or launch raises; it never gives way
    to autograd of ``plain``."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0, chunk):
        out, stateT, states = _launch(r, k, v, w, u, state0, chunk, True)
        ctx.save_for_backward(r, k, v, w, u, states)
        ctx.chunk = chunk
        # an op analysis running now costs the backward as one unit
        ctx.analysis = units.ANALYSIS.get()
        return out, stateT

    @staticmethod
    def backward(ctx, dy, dS_T):
        r, k, v, w, u, states = ctx.saved_tensors
        B, T, H, D = r.shape
        shape = dict(B=B, T=T, H=H, D=D, chunk=_chunk(T, ctx.chunk))
        grads = units.run_in(ctx.analysis, BWD_NAME, shape, backward_kernel,
                             r, k, v, w, u, states, dy, dS_T,
                             chunk=ctx.chunk)
        return (*grads, None)


def _dtype(r) -> torch.dtype:
    """The plain versions' working type: fp32, or fp64 for fp64 inputs
    (the tests' yardstick)."""
    return torch.float64 if r.dtype == torch.float64 else torch.float32


def _chunk_terms(rb, kb, wb):
    """One chunk's decays and scaled inputs, as ``plain`` forms them:
    (A_excl, A_incl, A_end, rA, kA)."""
    logw = torch.log(wb)
    cum = torch.cumsum(logw, dim=1)
    A_excl = torch.exp(cum - logw)           # prod_{s<=t-1}
    A_incl = torch.exp(cum)                  # prod_{s<=t}
    kA = kb / torch.clamp(A_incl, min=EPS)
    return A_excl, A_incl, A_incl[:, -1], rb * A_excl, kA


def plain(r, k, v, w, u, state0, *, chunk=64):
    """The plain PyTorch version of ``rwkv6_scan``: per chunk, the
    cumulative per-channel decay, the strictly lower intra-chunk
    attention, the bonus term and the state update, in fp32 (fp64 for
    fp64 inputs)."""
    B, T, H, D = r.shape
    chunk = _chunk(T, chunk)
    dt = _dtype(r)
    r, k, v, w, u, S = (a.to(dt) for a in (r, k, v, w, u, state0))
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=r.device), -1)
    ys = []
    for c0 in range(0, T, chunk):
        rb, kb, vb, wb = (a[:, c0:c0 + chunk] for a in (r, k, v, w))
        _, _, A_end, rA, kA = _chunk_terms(rb, kb, wb)
        y = torch.einsum("bthk,bhkv->bthv", rA, S)
        att = torch.einsum("bthk,bshk->bhts", rA, kA)
        att = torch.where(causal[None, None], att, torch.zeros_like(att))
        y = y + torch.einsum("bhts,bshv->bthv", att, vb)
        y = y + torch.einsum("bthk,bthk->bth", rb, u * kb)[..., None] * vb
        S = A_end[..., None] * S + torch.einsum(
            "bshk,bshv->bhkv", kA * A_end[:, None], vb)
        ys.append(y)
    return torch.cat(ys, 1), S


def plain_states(r, k, v, w, state0, *, chunk=64):
    """The state at the start of every chunk, (B, H, T / chunk, D, D),
    by ``plain``'s forward sweep: what ``forward_with_states`` gives as
    its third output, in fp32 (fp64 for fp64 inputs)."""
    T = r.shape[1]
    chunk = _chunk(T, chunk)
    dt = _dtype(r)
    r, k, v, w, S = (a.to(dt) for a in (r, k, v, w, state0))
    starts = []
    for c0 in range(0, T, chunk):
        starts.append(S)
        kb, vb, wb = (a[:, c0:c0 + chunk] for a in (k, v, w))
        _, _, A_end, _, kA = _chunk_terms(r[:, c0:c0 + chunk], kb, wb)
        S = A_end[..., None] * S + torch.einsum(
            "bshk,bshv->bhkv", kA * A_end[:, None], vb)
    return torch.stack(starts, 2)


def states_error(states, r, k, v, w, *, chunk, tol) -> float:
    """The chunk-start ``states`` (the forward kernel's third output)
    against ``plain_states`` on the same inputs, state0 being
    ``states[:, :, 0]``: the worst over the chunks of the chunk's max
    abs error over ``tol`` x max(1, the chunk's max |plain|).  inf where
    a state is not finite."""
    if not torch.isfinite(states).all():
        return float("inf")
    ref = plain_states(r, k, v, w, states[:, :, 0], chunk=chunk)
    err = (states - ref).abs().amax((0, 1, 3, 4))
    top = ref.abs().amax((0, 1, 3, 4)).clamp(min=1.0)
    return float((err / (tol * top)).max())


# a backward gradient leaf's limit (``backward_error``): 3x the fp32
# ``plain_backward``'s own error against the fp64 one, or this many fp32
# ulps of the leaf's max |grad|, whichever is larger
BWD_ULPS = 16


def _leaf_error(name, g, a, b) -> tuple[float, float, str]:
    """(max abs error, error over its limit, figures) of the leaf ``g``
    against the fp64 reference ``b``, the fp32 plain version giving
    ``a``: within max(3x ``a``'s own error, ``BWD_ULPS`` fp32 ulps of
    max |b|).  Raises ValueError on a non-finite leaf or one of another
    shape or type than ``a``."""
    if g.shape != a.shape or g.dtype != a.dtype:
        raise ValueError(f"{name}: {g.dtype} {tuple(g.shape)}, need "
                         f"{a.dtype} {tuple(a.shape)}")
    if not torch.isfinite(g).all():
        raise ValueError(f"{BWD_NAME}: a non-finite {name}")
    top = float(b.abs().max())
    ulp = 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 23)
    own = float((a.double() - b).abs().max())
    e = float((g.double() - b).abs().max())
    return e, e / max(3 * own, BWD_ULPS * ulp), (
        f"{name}: error {e:.3e}, the fp32 plain version's own {own:.3e}, "
        f"max |{name}| {top:.3e}")


def _worst(named) -> tuple[float, float, str]:
    err, frac, worst = 0.0, 0.0, ""
    for name, g, a, b in named:
        e, f, what = _leaf_error(name, g, a, b)
        err = max(err, e)
        if f >= frac:
            frac, worst = f, what
    return err, frac, worst


def backward_error(grads, r, k, v, w, u, state0, dy, dS_T=None, *, chunk,
                   states=None) -> tuple[float, float, str]:
    """(max abs error, worst leaf's error over its limit, that leaf's
    figures) of ``grads`` = (dr, dk, dv, dw, du, dstate0) against
    ``plain_backward`` in fp64 on the same inputs, and on the chunk-start
    ``states`` where given: each leaf within max(3x the fp32
    ``plain_backward``'s own error there, ``BWD_ULPS`` fp32 ulps of the
    leaf's max |grad|).  Raises ValueError on a non-finite gradient or
    one of another shape or type than fp32 ``plain_backward``'s."""
    ins = (r, k, v, w, u, state0)
    ref32 = plain_backward(*ins, dy, dS_T, chunk=chunk, states=states)
    ref64 = plain_backward(
        *(t.double() for t in ins), dy.double(),
        None if dS_T is None else dS_T.double(), chunk=chunk,
        states=None if states is None else states.double())
    return _worst(zip(("dr", "dk", "dv", "dw", "du", "dstate0"), grads,
                      ref32, ref64))


def dstate_error(ckpt, ds0, r, w, dy, dS_T=None, *, chunk, group
                 ) -> tuple[float, float, str]:
    """``backward_error``'s rule for the chain's output: the checkpoints
    (B, H, ceil(NC / group), D, D) and dstate0 against ``plain_dstate``
    in fp64, each within max(3x the fp32 ``plain_dstate``'s own error,
    ``BWD_ULPS`` fp32 ulps of its max |value|)."""
    ref32 = plain_dstate(r, w, dy, dS_T, chunk=chunk, group=group)
    ref64 = plain_dstate(r.double(), w.double(), dy.double(),
                         None if dS_T is None else dS_T.double(),
                         chunk=chunk, group=group)
    return _worst(zip(("checkpoints", "dstate0"), (ckpt, ds0), ref32,
                      ref64))


def plain_dstate(r, w, dy, dS_T=None, *, chunk=64, group=1):
    """The plain PyTorch version of the backward's chain: (checkpoints
    (B, H, ceil(NC / group), D, D), dstate0 (B, H, D, D)).  Checkpoint g
    is the gradient of the end state of chunk min((g + 1) group, NC) - 1
    (dS_T, or zeros, for the last group), carried as ``plain_backward``
    carries it, dS <- rA^T dy + A_end * dS per chunk in reverse, in fp32
    (fp64 for fp64 inputs)."""
    B, T, H, D = r.shape
    chunk = _chunk(T, chunk)
    NC = T // chunk
    dt = _dtype(r)
    r, w, dy = (a.to(dt) for a in (r, w, dy))
    dS = (torch.zeros((B, H, D, D), dtype=dt, device=r.device)
          if dS_T is None else dS_T.to(dt))
    ckpts = [None] * -(-NC // group)
    for c in reversed(range(NC)):
        if c == NC - 1 or c % group == group - 1:
            ckpts[c // group] = dS
        sl = slice(c * chunk, (c + 1) * chunk)
        _, _, E, rA, _ = _chunk_terms(r[:, sl], r[:, sl], w[:, sl])
        dS = torch.einsum("bthk,bthv->bhkv", rA, dy[:, sl]) \
            + E[..., None] * dS
    return torch.stack(ckpts, 2), dS


def plain_backward(r, k, v, w, u, state0, dy, dS_T=None, *, chunk=64,
                   states=None):
    """The plain PyTorch version of ``rwkv6_scan_bwd``: (dr, dk, dv, dw,
    du, dstate0) of ``plain`` at ``chunk`` for the output's gradient
    ``dy`` and the final state's ``dS_T`` (None: zeros), written out as
    its formulas (no autograd) in fp32 (fp64 for fp64 inputs).  The
    chunk-start states come from a forward sweep, or from ``states``
    (B, H, T / chunk, D, D) where given, as the kernel takes them from
    the forward kernel; then, per chunk in reverse with dS (the gradient
    of the chunk's end state) carried, and with P = tril_{-1}(rA kA^T),
    bonus_t = r_t . (u * k_t), E = A_end:

        dv   = P^T dy + bonus * dy + (kA * E) dS
        dP   = tril_{-1}(dy v^T)
        drA  = dy S^T + dP kA,      dkA = dP^T rA + E * (v dS^T)
        dE   = rowsum(S * dS) + sum_s kA_s * (v dS^T)_s
        dr   = drA * A_excl + (dy . v) u * k,
        dk   = (dy . v) r * u + dkA / max(A_incl, EPS),
        du  += sum_t (dy . v) r * k
        dcum = drA r A_excl + [A_incl >= EPS] (-dkA kA / A_incl) A_incl
               + [last row] dE * E
        dw   = (revcumsum(dcum) - drA r A_excl) / w
        dS  <- rA^T dy + E * dS

    (the clamp passes no gradient where it binds, as ``torch.clamp``
    and JAX's ``jnp.maximum`` give it)."""
    B, T, H, D = r.shape
    chunk = _chunk(T, chunk)
    dt = _dtype(r)
    r, k, v, w, u, S, dy = (a.to(dt) for a in (r, k, v, w, u, state0, dy))
    dS = (torch.zeros((B, H, D, D), dtype=dt, device=r.device)
          if dS_T is None else dS_T.to(dt))
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=r.device), -1)[None, None]
    if states is None:
        states = plain_states(r, k, v, w, S, chunk=chunk)
    starts = list(states.to(dt).unbind(2))
    grads = {n: torch.empty_like(r) for n in ("r", "k", "v", "w")}
    du = torch.zeros_like(u)
    for c0, S in reversed(list(zip(range(0, T, chunk), starts))):
        sl = slice(c0, c0 + chunk)
        rb, kb, vb, wb, dyb = (a[:, sl] for a in (r, k, v, w, dy))
        A_excl, A_incl, E, rA, kA = _chunk_terms(rb, kb, wb)
        P = torch.where(causal, torch.einsum("bthk,bshk->bhts", rA, kA), 0)
        dP = torch.where(causal, torch.einsum("bthv,bshv->bhts", dyb, vb),
                         0)
        bonus = torch.einsum("bthk,bthk->bth", rb, u * kb)[..., None]
        dbonus = (dyb * vb).sum(-1, keepdim=True)              # (b,t,h,1)
        vdS = torch.einsum("bshv,bhkv->bshk", vb, dS)
        grads["v"][:, sl] = (torch.einsum("bhts,bthv->bshv", P, dyb)
                             + bonus * dyb + torch.einsum(
                                 "bshk,bhkv->bshv", kA * E[:, None], dS))
        drA = (torch.einsum("bthv,bhkv->bthk", dyb, S)
               + torch.einsum("bhts,bshk->bthk", dP, kA))
        dkA = torch.einsum("bhts,bthk->bshk", dP, rA) + E[:, None] * vdS
        dE = (S * dS).sum(-1) + (kA * vdS).sum(1)
        m = torch.clamp(A_incl, min=EPS)
        grads["r"][:, sl] = drA * A_excl + dbonus * (u * kb)
        grads["k"][:, sl] = dbonus * rb * u + dkA / m
        du = du + (dbonus * rb * kb).sum((0, 1))
        dAe = drA * rb * A_excl
        dcum = dAe + torch.where(A_incl >= EPS, -dkA * (kA / m), 0) * A_incl
        dcum[:, -1] += dE * E
        dlogw = dcum.flip(1).cumsum(1).flip(1) - dAe
        grads["w"][:, sl] = dlogw / wb
        dS = torch.einsum("bthk,bthv->bhkv", rA, dyb) + E[..., None] * dS
    return grads["r"], grads["k"], grads["v"], grads["w"], du, dS
