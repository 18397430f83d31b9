"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, under the package's
gitignored ``build/`` directory.  Nothing is built when a module is
imported: the first CUDA call of any wrapper builds every source at once,
one ``nvcc`` process per source started together, and later calls reuse the
loaded libraries.  A library's file name carries a hash of its sources and
flags, so an edited source is rebuilt and an unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_FUNCS: Dict[str, object] = {}   # loaded C entry points by symbol


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.read_bytes())
    return BUILD / f"{src.stem}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, float]:
    """Compile every source whose library is missing, all in parallel.
    Returns {name: seconds} for what was compiled; raises with nvcc's output
    on failure.  ``-Xptxas -v`` (registers, shared memory, spills) goes to
    ``build/<lib>.log``."""
    BUILD.mkdir(parents=True, exist_ok=True)
    todo = {n: s for n, s in sources().items() if not _target(s).exists()}
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, src in todo.items():
        tmp = _target(src).with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    times, failed = {}, []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        target = _target(todo[name])
        target.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return times


def build_log(name: str) -> str:
    """nvcc's ``-Xptxas -v`` report for one source's library."""
    return _target(sources()[name]).with_suffix(".log").read_text()


def function(name: str, argtypes, symbol: str = ""):
    """The C entry point ``int <symbol>(...)`` (default ``<name>``) of
    ``csrc/<name>.cu`` with its ctypes signature (``c_void_p`` for every
    pointer and the stream), building every source on first use."""
    symbol = symbol or name
    fn = _FUNCS.get(symbol)
    if fn is None:
        build_all()
        fn = getattr(ctypes.CDLL(str(_target(sources()[name]))), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _FUNCS[symbol] = fn
    return fn


def check(rc: int, name: str) -> None:
    """Raise on the ``cudaGetLastError()`` code a C entry point returned."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


def forward_only(name: str, *tensors) -> None:
    """Raise where a CUDA kernel would drop a gradient: under grad mode with
    an operand that requires grad.  The kernels are forward-only (as the
    TPU kernels are); the CPU branch of each wrapper stays differentiable."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel is forward-only and would drop the gradient "
            "of an operand that requires grad; run it under torch.no_grad() or "
            "detach the operands")
