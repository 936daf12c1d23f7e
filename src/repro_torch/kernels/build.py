"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface (``extern "C"`` launchers
that return the ``cudaError_t``), is compiled for ``sm_90a`` into its own
shared library and bound with ``ctypes``.  Libraries land in
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the source and the flags, so a
changed source rebuilds and an unchanged one loads at once.  Nothing here
runs at import time: the CPU tests import every module on machines that
have no ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("flash_attention", "paged_decode_attention", "decode_attention",
           "spec_verify", "rwkv6_scan", "int8_matmul")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
logs: dict[str, str] = {}       # kernel name -> nvcc/ptxas output of its build


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(PATH, CUDA_HOME and /usr/local/cuda searched)")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str) -> tuple[Path, subprocess.Popen | None]:
    out = _target(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: Path, proc: subprocess.Popen | None):
    if proc is not None:
        log, _ = proc.communicate()
        logs[name] = log
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)       # atomic: a racing build sees all or none
    _libs[name] = ctypes.CDLL(str(out))


def build_all(names=KERNELS) -> dict[str, ctypes.CDLL]:
    """Build every named kernel that is not built yet, one ``nvcc`` per
    source, all started together; load them all."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        started = [(n, *_start(n)) for n in todo]
        try:
            for name, out, proc in started:
                _finish(name, out, proc)
        finally:
            for _, _, proc in started:   # after a failure: stop the rest
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return {n: _libs[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _libs.get(name)
    return lib if lib is not None else build_all((name,))[name]


_launch_lock = threading.Lock()


def count_launch(fn, route: str | None = None) -> None:
    """Add one to ``fn.launches`` (and to ``fn.routes[route]``) under one
    lock.  ``+=`` on an attribute is a read, an add and a write, which
    two threads can interleave and lose a count: in the fleet's service
    mode every engine launches kernels from its own thread."""
    with _launch_lock:
        fn.launches += 1
        if route is not None:
            fn.routes[route] += 1


def on_device(t):
    """The context to launch a kernel on ``t``'s card in: none when that
    card is already current (the wrapper's per-call host cost)."""
    import torch
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)
