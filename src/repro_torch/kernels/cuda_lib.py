"""Build and bind the port's hand-written CUDA kernels.

Each source under ``repro_torch/csrc`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds.  Libraries land
in ``build/repro_torch_kernels/`` at the repository root, named by a hash
of the source, the headers of ``csrc/`` and the flags: a checkout builds
what it needs at first use, and an edited source or header never loads a
stale library.

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
        # parts, is_double, stream
        "repro_spmm_sell_bucket": (
            [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I, _I, _I, _I, _P],
            _I),
        "repro_cuda_error_string": ([_I], ctypes.c_char_p),
    }),
    "spmm_sell_stream": ("spmm_sell_stream.cu", {
        # lcols, vals, rows, lane_end, block_ptr, block_cols, x, y, n_slices,
        # width, c, ld, k_tile, chunk_rows, block_rows, is_double, stream
        "repro_spmm_sell_stream_bucket": (
            [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I, _I,
             _I, _I, _P], _I),
        "repro_stream_cuda_error_string": ([_I], ctypes.c_char_p),
    }),
    "graph_step": ("graph_step.cu", {
        # adj, nodes, dist, out, level, n_slices, width, c, ld, k_tile,
        # n_nodes, threads, parts, stream
        "repro_bfs_sell_bucket": (
            [_P, _P, _P, _P, _I, _I64, _I64, _I64, _I64, _I, _I64, _I, _I,
             _P], _I),
        # adj, nodes, contrib, consts, out, n_slices, width, c, ld, k_tile,
        # n_nodes, threads, parts, is_double, stream
        "repro_pagerank_sell_bucket": (
            [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I, _I64, _I, _I,
             _I, _P], _I),
        # dist, frontier, level, n_nodes, threads, stream
        "repro_bfs_frontier": ([_P, _P, _I, _I64, _I, _P], _I),
        # adj, live, frontier, dist, out, level, n_nodes, width, threads,
        # stream
        "repro_bfs_ell_step": ([_P, _P, _P, _P, _P, _I, _I64, _I64, _I, _P],
                               _I),
        # adj, live, contrib, consts, out, n_nodes, width, threads,
        # is_double, stream
        "repro_pagerank_ell_step": (
            [_P, _P, _P, _P, _P, _I64, _I64, _I, _I, _P], _I),
        "repro_graph_cuda_error_string": ([_I], ctypes.c_char_p),
    }),
    "spmv_ell": ("spmv_ell.cu", {
        # cols, vals, x, y, live, n_slices, width, c, threads, is_double,
        # stream
        "repro_spmv_ell": (
            [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I, _P], _I),
        # cols, vals, X, Y, live, n_slices, width, c, ld, k0, kt, group,
        # vec, threads, is_double, stream
        "repro_spmm_ell": (
            [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I, _I, _I, _I, _I,
             _I, _P], _I),
        "repro_spmv_ell_cuda_error_string": ([_I], ctypes.c_char_p),
    }),
    "fft_stockham": ("fft_stockham.cu", {
        # re, im, wre, wim, out_re, out_im, batch, n, log2n, signals,
        # is_double, stream
        "repro_fft_stockham_block": (
            [_P, _P, _P, _P, _P, _P, _I64, _I64, _I, _I, _I, _P], _I),
        # cols, xr, xi, wre, wim, yr, yi, batch, n, log2n, log2n1, log2tile,
        # threads, is_double, stream
        "repro_fft_pass": (
            [_I, _P, _P, _P, _P, _P, _P, _I64, _I64, _I, _I, _I, _I, _I, _P],
            _I),
        "repro_fft_cuda_error_string": ([_I], ctypes.c_char_p),
    }),
    # B8's entries take a dtype code: 0 float32, 1 float64, 2 the bf16
    # form (xd / B / C / y and their gradients bf16, the rest float32)
    "ssd_fused": ("ssd_fused.cu", {
        # xd, ad, B, cum, states, b, l, h, p, g, n, chunk, dtype, stream
        "repro_ssd_chunk_state": (
            [_P, _P, _P, _P, _P, _I64, _I64, _I, _I, _I, _I, _I, _I, _P], _I),
        # states, entering, cum, init (nullable), fstate, b, l, h, p, n,
        # chunk, dtype, stream
        "repro_ssd_state_pass": (
            [_P, _P, _P, _P, _P, _I64, _I64, _I, _I, _I, _I, _I, _P], _I),
        # xd, B, C, cum, states, has_init, y, yacc (nullable), b, l, h, p,
        # g, n, chunk, dtype, stream
        "repro_ssd_chunk_output": (
            [_P, _P, _P, _P, _P, _I, _P, _P, _I64, _I64, _I, _I, _I, _I, _I,
             _I, _P], _I),
        "repro_ssd_cuda_error_string": ([_I], ctypes.c_char_p),
    }),
    "ssd_bwd": ("ssd_bwd.cu", {
        # dy, C, cum, local, b, l, h, p, g, n, chunk, dtype, stream
        "repro_ssd_bwd_local": (
            [_P, _P, _P, _P, _I64, _I64, _I, _I, _I, _I, _I, _I, _P], _I),
        # local, dso, cum, dfinal (nullable), dinit (nullable), b, l, h, p,
        # n, chunk, dtype, stream
        "repro_ssd_bwd_state_pass": (
            [_P, _P, _P, _P, _P, _I64, _I64, _I, _I, _I, _I, _I, _P], _I),
        # xd, dy, B, C, cum, entering, fstate, dso, has_dfinal, dbh, dx,
        # dck, mh, gh, rh, b, l, h, p, g, n, chunk, dtype, stream
        "repro_ssd_bwd_key": (
            [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I64,
             _I64, _I, _I, _I, _I, _I, _I, _P], _I),
        # dy, B, C, cum, entering, has_init, mh, rh, dch, dcq, b, l, h, p,
        # g, n, chunk, dtype, stream
        "repro_ssd_bwd_query": (
            [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I64, _I64, _I, _I, _I,
             _I, _I, _I, _P], _I),
        # dcq, dck, dad, dbh, dch, dB, dC, b, l, h, g, n, chunk, dtype,
        # stream
        "repro_ssd_bwd_finish": (
            [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I, _I, _I, _I, _I, _P],
            _I),
        "repro_ssd_bwd_cuda_error_string": ([_I], ctypes.c_char_p),
    }),
    "embedding_gather": ("embedding_gather.cu", {
        # table, n_rows, ids, out, n_ids, row_bytes, id_bytes, chunks,
        # threads, stream
        "repro_embedding_gather": (
            [_P, _I64, _P, _P, _I64, _I64, _I, _I, _I, _P], _I),
        # table, shard_rows, lo, vocab, ids, out, n_ids, row_bytes,
        # id_bytes, chunks, threads, stream
        "repro_embedding_gather_shard": (
            [_P, _I64, _I64, _I64, _P, _P, _I64, _I64, _I, _I, _I, _P], _I),
        # ids, id_bytes, dout, dtable, carry (nullable), n_rows, n_ids, d,
        # dout_type, table_type (0 float32, 1 float64, 2 bfloat16),
        # vec_bytes, stripe, chunks, threads, stream
        "repro_embedding_gather_bwd": (
            [_P, _I, _P, _P, _P, _I64, _I64, _I64, _I, _I, _I, _I, _I, _I, _P],
            _I),
        # ids, id_bytes, dout, dtable, carry (nullable), shard_rows, lo,
        # vocab, n_ids, d, dout_type, table_type, vec_bytes, stripe, chunks,
        # threads, stream
        "repro_embedding_gather_shard_bwd": (
            [_P, _I, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I, _I, _I, _I,
             _I, _I, _P], _I),
        "repro_gather_cuda_error_string": ([_I], ctypes.c_char_p),
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
    """The source of kernel ``name`` and its library's path, named by a
    hash of the source, every header of ``csrc/`` (a source may include
    any of them) and the flags."""
    source = CSRC / KERNELS[name][0]
    h = hashlib.blake2b(digest_size=8)
    h.update(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
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
