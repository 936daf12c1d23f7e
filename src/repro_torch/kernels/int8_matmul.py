"""W8A16 matrix product: the CUDA kernel's wrapper and its plain version.

``int8_matmul`` launches ``csrc/int8_matmul.cu`` (the Hopper counterpart
of the Pallas ``repro/kernels/int8_matmul.py``) on CUDA tensors and
refuses anything else; ``plain`` is the same function in plain PyTorch,
which the CPU path and the on-card comparison use.  Both follow the
Pallas body, which rounds x to bf16 before the product; the oracle
``ref.int8_matmul_ref`` keeps x as given.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "int8_matmul"
X_DTYPES = (torch.bfloat16, torch.float32)


def _bind():
    lib = build.load(NAME)
    fn = lib.int8_matmul_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, I, P]
        fn.restype = I
    return fn


def _check(x, w_q, w_scale):
    tensors = (("x", x), ("w_q", w_q), ("w_scale", w_scale))
    for name, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"int8_matmul kernel needs CUDA tensors; {name} "
                             f"is on {t.device}")
    if len({t.device for _, t in tensors}) != 1:
        raise ValueError("inputs on different devices")
    if x.dtype not in X_DTYPES:
        raise ValueError(f"int8_matmul kernel takes x in {X_DTYPES}, got "
                         f"{x.dtype}")
    if w_q.dtype != torch.int8 or w_scale.dtype != torch.float32:
        raise ValueError(f"w_q must be int8 and w_scale float32, got "
                         f"{w_q.dtype} / {w_scale.dtype}")
    if w_q.ndim != 2 or x.ndim < 1 or x.shape[-1] != w_q.shape[0] \
            or w_scale.shape != (w_q.shape[1],):
        raise ValueError(f"shapes x {tuple(x.shape)} w_q {tuple(w_q.shape)} "
                         f"w_scale {tuple(w_scale.shape)}: need (..., K), "
                         "(K, N), (N,)")
    if not (w_q.is_contiguous() and w_scale.is_contiguous()):
        raise ValueError("w_q and w_scale must be contiguous")


def int8_matmul(x, w_q, w_scale):
    """x: (..., K) bf16/f32; w_q: (K, N) int8; w_scale: (N,) f32, on the
    card.  Returns (..., N) in x's dtype.  Same signature as the Pallas
    kernel (its block sizes are the kernel's own here)."""
    _check(x, w_q, w_scale)
    fn = _bind()
    K, N = w_q.shape
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M:
        with build.on_device(x):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(x2.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
                     out.data_ptr(), M, N, K,
                     int(x.dtype == torch.bfloat16), stream)
        if err != 0:
            raise RuntimeError(f"int8_matmul launch failed: cudaError {err}")
        int8_matmul.launches += 1
    return out.reshape(*x.shape[:-1], N)


int8_matmul.launches = 0


def plain(x, w_q, w_scale):
    """The plain PyTorch version of ``int8_matmul``: x rounded to bf16 and
    the int8 weights widened, multiplied in fp32, scaled once, cast to
    x's dtype."""
    y = torch.matmul(x.to(torch.bfloat16).float(), w_q.float())
    return (y * w_scale.float()).to(x.dtype)
