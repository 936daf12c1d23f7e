"""Speculative-decoding acceptance: the CUDA kernel's wrapper, its plain
version, and the sampling around them.

``spec_accept`` launches ``csrc/spec_verify.cu`` (the Hopper counterpart
of the Pallas ``repro/kernels/spec_verify.py::spec_accept``) on CUDA
tensors and refuses anything else; ``plain`` is the same function in
plain PyTorch (``ref.spec_accept``).  ``verify`` wraps either one
(passed as ``accept``) with the randomness the rule needs, drawn from
an explicit CPU ``torch.Generator``: the g uniforms first, then
Gumbel noise over the vocabulary to sample the next token from ``dist``
(Gumbel-max over ``log(dist + 1e-30)``, the categorical draw of the JAX
package).  Drawing on the CPU makes one generator state give the same
draws on either device.

The kernel is one launch of a thread-block cluster split over the
vocabulary; ``split`` is its pure rule of V, the same one the kernel
source states (``csrc/spec_verify.cu``'s ``split``), never chosen from a
failed launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

NAME = "spec_verify"
QUAD = 4            # floats per 16-byte load
MAX_CLUSTER = 8     # CTAs of a cluster: the portable limit
MAX_THREADS = 1024  # threads of a CTA
REG_QUADS = 4       # quads of each row a thread holds in registers a pass


def split(V: int) -> tuple[int, int]:
    """(C, threads): the cluster of C CTAs of ``threads`` threads the
    kernel launches for a vocabulary of V.  V is cut into quads of 4
    floats; C grows to 8 as the quads fill CTAs of 1024 threads (V =
    32768: 8 CTAs with one 16-byte load of each row a thread), each CTA
    owns a contiguous run of ceil(quads / C) quads, and its threads are
    that run rounded up to a warp, at most 1024."""
    if V < 1:
        raise ValueError(f"no split for V={V}")
    quads = -(-V // QUAD)
    C = min(MAX_CLUSTER, -(-quads // MAX_THREADS))
    per = -(-quads // C)
    return C, min(MAX_THREADS, -(-per // 32) * 32)


def _bind():
    lib = build.load(NAME)
    fn = lib.spec_accept_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, I, I, P]
        fn.restype = I
    return fn


def _check(draft_tokens, draft_probs, target_probs, u):
    tensors = (("draft_tokens", draft_tokens), ("draft_probs", draft_probs),
               ("target_probs", target_probs), ("u", u))
    for name, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"spec_accept kernel needs CUDA tensors; {name} "
                             f"is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len({t.device for _, t in tensors}) != 1:
        raise ValueError("inputs on different devices")
    if draft_tokens.dtype != torch.int32:
        raise ValueError(f"draft_tokens must be int32, got "
                         f"{draft_tokens.dtype}")
    for name, t in tensors[1:]:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if draft_probs.ndim != 2 or draft_probs.shape[0] < 1:
        raise ValueError(f"draft_probs must be (g >= 1, V), got "
                         f"{tuple(draft_probs.shape)}")
    g, V = draft_probs.shape
    if (draft_tokens.shape != (g,) or u.shape != (g,)
            or target_probs.shape != (g + 1, V)):
        raise ValueError(
            f"shapes draft_tokens {tuple(draft_tokens.shape)} draft_probs "
            f"{tuple(draft_probs.shape)} target_probs "
            f"{tuple(target_probs.shape)} u {tuple(u.shape)}: need (g,), "
            "(g, V), (g+1, V), (g,)")


def spec_accept(draft_tokens, draft_probs, target_probs, u):
    """draft_tokens: (g,) int32; draft_probs: (g, V) float32;
    target_probs: (g+1, V) float32; u: (g,) float32.  Returns (n (),
    int32; dist (V,) float32).  Same signature as the Pallas kernel."""
    build.refuse_grad("spec_accept", draft_probs, target_probs, u)
    _check(draft_tokens, draft_probs, target_probs, u)
    fn = _bind()
    g, V = draft_probs.shape
    n = torch.empty((), dtype=torch.int32, device=u.device)
    dist = torch.empty((V,), dtype=torch.float32, device=u.device)
    with build.on_device(u):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(draft_tokens.data_ptr(), draft_probs.data_ptr(),
                 target_probs.data_ptr(), u.data_ptr(), n.data_ptr(),
                 dist.data_ptr(), g, V, stream)
    if err != 0:
        C, threads = split(V)
        what = {-1: "shape refused",
                -2: "the card cannot place the cluster"}.get(
                    err, f"cudaError {err}")
        raise RuntimeError(f"spec_accept launch failed (cluster of {C} "
                           f"CTAs of {threads} threads): {what}")
    build.count_launch(spec_accept)
    return n, dist


spec_accept.launches = 0


def plain(draft_tokens, draft_probs, target_probs, u):
    """The plain PyTorch version of ``spec_accept``."""
    return ref.spec_accept(draft_tokens, draft_probs, target_probs, u)


def verify(accept, draft_tokens, draft_probs, target_probs, generator):
    """Token-level acceptance through ``accept`` (``spec_accept`` or
    ``plain``): (n_accepted (), next_token ()), int32 on the device of
    ``target_probs``.  ``generator`` is a CPU ``torch.Generator``."""
    dev = target_probs.device
    g, V = draft_probs.shape
    u = torch.rand(g, generator=generator, dtype=torch.float32).to(dev)
    n, dist = accept(draft_tokens.to(dev, torch.int32).contiguous(),
                     draft_probs.to(dev, torch.float32).contiguous(),
                     target_probs.float().contiguous(), u)
    e = torch.rand(V, generator=generator, dtype=torch.float32)
    e = e.clamp(min=torch.finfo(torch.float32).tiny)
    gumbel = (-torch.log(-torch.log(e))).to(dev)
    nxt = torch.argmax(torch.log(dist + 1e-30) + gumbel).to(torch.int32)
    return n, nxt
