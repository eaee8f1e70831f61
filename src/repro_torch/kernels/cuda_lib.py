"""Build and bind the port's hand-written CUDA kernels.

Each source under ``repro_torch/csrc`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds.  Libraries land
in ``build/repro_torch_kernels/`` at the repository root, named by a hash
of the source and the flags: a checkout builds what it needs at first use,
and an edited source never loads a stale library.

Nothing here runs at import time: the CPU-only test environment imports
every module and has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BuildResult", "build", "build_all", "library"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: <repo>/build/repro_torch_kernels (this file is <repo>/src/repro_torch/kernels/)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
#: library name -> (source file, {C function: (argtypes, restype)})
KERNELS = {
    "spmm_sell": ("spmm_sell.cu", {
        # cols, vals, rows, x, y, n_slices, width, c, ld, k_tile, threads,
        # is_double, stream
        "repro_spmm_sell_bucket": (
            [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I, _I, _I, _P],
            _I),
        "repro_cuda_error_string": ([_I], ctypes.c_char_p),
    }),
}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    seconds: float          # 0.0 when the library was already built
    log: str                # nvcc / ptxas output (registers, spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of repro_torch build on a machine "
        "with the CUDA toolkit (PATH or /usr/local/cuda/bin)")


def _target(name: str) -> tuple[Path, Path]:
    source = CSRC / KERNELS[name][0]
    h = hashlib.blake2b(digest_size=8)
    h.update(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return source, BUILD_DIR / f"lib{name}-{h.hexdigest()}.so"


def build_all(names=None) -> list[BuildResult]:
    """Compile every named kernel library that is not built yet, one
    ``nvcc`` per source, all started together.  Raises on any failure."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, results = [], []
    t0 = time.perf_counter()
    for name in names:
        source, out = _target(name)
        if out.exists():
            results.append(BuildResult(name, out, 0.0, ""))
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n{log}")
        os.replace(tmp, out)      # atomic: a concurrent loader never sees half a file
        results.append(BuildResult(name, out, time.perf_counter() - t0, log))
    return results


def build(name: str) -> BuildResult:
    return build_all([name])[0]


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    lib = ctypes.CDLL(str(build(name).path))
    for fn, (argtypes, restype) in KERNELS[name][1].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib
