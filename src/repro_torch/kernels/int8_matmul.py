"""W8A16 matrix product: the CUDA kernel's wrapper and its plain version.

``int8_matmul`` launches ``csrc/int8_matmul.cu`` (the Hopper counterpart
of the Pallas ``repro/kernels/int8_matmul.py``) on CUDA tensors and
refuses anything else; ``plain`` is the same function in plain PyTorch,
which the CPU path and the on-card comparison use.  Both follow the
Pallas body, which rounds x to bf16 before the product; the oracle
``ref.int8_matmul_ref`` keeps x as given.

The source holds three designs; ``route`` picks one from the shape, x's
dtype and the pointers' alignment alone (never from a failed build or
launch): ``wgmma`` for prefill M (TMA + wgmma, bf16 x), ``splitk`` for
decode M (a split-K weight stream, its splits summed in order by a
second kernel; ``split_plan`` sizes it) and ``general`` for the rest.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "int8_matmul"
X_DTYPES = (torch.bfloat16, torch.float32)
ROUTES = ("general", "wgmma", "splitk")
SPLITK_MAX_M = 32        # rows up to which decode's split-K route runs
SM_COUNT = 132           # H100 SXM: split_plan fills one wave of CTAs
# split-K geometry, as in csrc/int8_matmul.cu (SK_*)
SK_BN, SK_BK, SK_X_BYTES, SK_XPAD, SK_CTAS_PER_SM = 128, 64, 22528, 32, 4
WG_BN = 128              # wgmma: weight columns per CTA
WG_TILES = (192, 256)    # wgmma: x rows per CTA, the kernel's two instances


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def route(M: int, N: int, K: int, x_dtype, aligned: bool) -> str:
    """The design that computes an (M, K) x (K, N) product: ``splitk`` up
    to ``SPLITK_MAX_M`` rows, ``wgmma`` above it for bf16 x with K % 8 ==
    0, ``general`` otherwise.  Both fast routes read the weights by TMA,
    so they need N % 16 == 0 and ``aligned`` (x and w_q 16-byte aligned)."""
    if not aligned or N % 16:
        return "general"
    if M <= SPLITK_MAX_M:
        return "splitk"
    if x_dtype == torch.bfloat16 and K % 8 == 0:
        return "wgmma"
    return "general"


def wgmma_tile(M: int, N: int) -> int:
    """x rows per CTA for the ``wgmma`` route: the tile that needs the
    fewest waves of one CTA a SM, the smaller on a tie (a partial last
    wave costs as much as a whole one)."""
    def waves(bx):
        return _cdiv(_cdiv(M, bx) * _cdiv(N, WG_BN), SM_COUNT)
    return min(WG_TILES, key=lambda bx: (waves(bx), bx))


def split_plan(M: int, N: int, K: int) -> tuple[int, int]:
    """(splits, chunk) for the ``splitk`` route: split s takes K rows
    [s chunk, min(K, (s + 1) chunk)), so the splits cover K once, in
    order.  As many splits as keep the CTAs (column blocks x splits) in
    one wave at four a SM; chunk is a multiple of the 64-row stage and
    small enough for x's slice (rows padded to 8, 16 or 32) to fit the
    shared memory set aside for it."""
    rows = 8 if M <= 8 else 16 if M <= 16 else 32
    want = max(1, SK_CTAS_PER_SM * SM_COUNT // _cdiv(N, SK_BN))
    most = max(SK_BK, (SK_X_BYTES // rows - SK_XPAD) // 2 // SK_BK * SK_BK)
    chunk = min(most, _cdiv(_cdiv(K, want), SK_BK) * SK_BK)
    return _cdiv(K, chunk), chunk


def _bind():
    lib = build.load(NAME)
    fn = lib.int8_matmul_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, I, P]
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
        aligned = x2.data_ptr() % 16 == 0 and w_q.data_ptr() % 16 == 0
        r = route(M, N, K, x.dtype, aligned)
        tile = wgmma_tile(M, N) if r == "wgmma" else 0
        splits, chunk = split_plan(M, N, K) if r == "splitk" else (0, 0)
        work = torch.empty((splits, M, N), dtype=torch.float32,
                           device=x.device) if splits else None
        with build.on_device(x):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(x2.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
                     out.data_ptr(), 0 if work is None else work.data_ptr(),
                     M, N, K, int(x.dtype == torch.bfloat16),
                     ROUTES.index(r), tile, splits, chunk, stream)
        if err != 0:
            raise RuntimeError(f"int8_matmul launch failed ({r} route): "
                               f"cudaError {err}")
        build.count_launch(int8_matmul, r)
    return out.reshape(*x.shape[:-1], N)


int8_matmul.launches = 0
int8_matmul.routes = dict.fromkeys(ROUTES, 0)   # launches by route


def plain(x, w_q, w_scale):
    """The plain PyTorch version of ``int8_matmul``: x rounded to bf16 and
    the int8 weights widened, multiplied in fp32, scaled once, cast to
    x's dtype."""
    y = torch.matmul(x.to(torch.bfloat16).float(), w_q.float())
    return (y * w_scale.float()).to(x.dtype)
