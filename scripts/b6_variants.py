"""Variants of kernel B6 timed in one process on the card.

Builds copies of ``src/repro_torch/csrc/spmv_ell.cu`` with the unroll
depth of both forms set to 4, 8 or 16 and the slab loads as ``__ldg`` or
``__ldcs`` (evict-first), then times each at block sizes 128, 256 and
512 on the 2,097,152-row uniform ELLPACK operand of ``chip_smoke.py``
(fp64, k = 1 and k = 32 as one k-form launch), twice in turns, beside
``torch.sparse.mm``.  Every variant's result is checked ``torch.equal``
to the committed kernel's.  Run from the repository root on a machine
with an NVIDIA GPU:

    python3 scripts/b6_variants.py

The variant sources and libraries go to the git-ignored ``build/``.
"""
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import cuda_lib, spmv  # noqa: E402
from repro_torch.sparse import formats as F  # noqa: E402

K = 32


def variant_source(src: str, unroll: int, load: str) -> str:
    s = re.sub(r"constexpr int UNROLL_(1|K) = \d+;",
               lambda m: f"constexpr int UNROLL_{m.group(1)} = {unroll};", src)
    if load == "ldg":
        for name in ("cols", "vals"):
            s = s.replace(f"__ldcs({name} + base", f"__ldg({name} + base")
    return s


def build_variants() -> dict:
    """{name: loaded library} for every (unroll, load), built in parallel."""
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    src = (ROOT / "src/repro_torch/csrc/spmv_ell.cu").read_text()
    jobs = {}
    for unroll in (4, 8, 16):
        for load in ("ldg", "ldcs"):
            name = f"u{unroll}_{load}"
            cu, so = build / f"var_{name}.cu", build / f"libvar_{name}.so"
            cu.write_text(variant_source(src, unroll, load))
            jobs[name] = (so, subprocess.Popen(
                [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print(name, [ln.strip() for ln in log.splitlines() if "registers" in ln])
        lib = ctypes.CDLL(str(so))
        for fn, (args, res) in cuda_lib.KERNELS["spmv_ell"][1].items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = res
        libs[name] = lib
    return libs


def main() -> int:
    libs = build_variants()
    flush = torch.empty(25_000_000, dtype=torch.float32, device="cuda")
    csr = F.random_csr(**cs.ELL_BIG)
    cols, vals = F.csr_to_ellpack(csr, c=cs.ELL_C).to_device("cuda")
    live = spmv.live_widths(cols)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal(csr.n_cols)).cuda()
    X = torch.from_numpy(rng.standard_normal((csr.n_cols, K))).cuda()
    s, w, c = cols.shape
    y = torch.empty(s * c, dtype=torch.float64, device="cuda")
    Y = torch.empty((s * c, K), dtype=torch.float64, device="cuda")
    want1 = spmv.spmv_ell(cols, vals, x, live_width=live)
    wantk = spmv.spmm_ell(cols, vals, X, live_width=live)
    a_lib = torch.sparse_csr_tensor(
        torch.from_numpy(csr.indptr), torch.from_numpy(csr.indices.astype(np.int64)),
        torch.from_numpy(csr.data), size=(csr.n_rows, csr.n_cols)).cuda()
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (cols.data_ptr(), vals.data_ptr())
    for rnd in range(2):
        for name, lib in libs.items():
            for threads in (128, 256, 512):
                def one():
                    return lib.repro_spmv_ell(*ptrs, x.data_ptr(), y.data_ptr(),
                                              live.data_ptr(), s, w, c, threads, 1, stream)

                def many():
                    return lib.repro_spmm_ell(*ptrs, X.data_ptr(), Y.data_ptr(),
                                              live.data_ptr(), s, w, c, K, 0, K, 16, 2,
                                              threads, 1, stream)

                one()
                many()
                torch.cuda.synchronize()
                if not (torch.equal(y, want1) and torch.equal(Y, wantk)):
                    raise AssertionError(f"{name} at {threads} threads differs")
                print(f"round {rnd} {name} threads {threads}: k1 "
                      f"{cs.time_ms(torch, one, flush):.4f} ms  k{K} "
                      f"{cs.time_ms(torch, many, flush):.4f} ms", flush=True)
        lib_ms = cs.time_ms(torch, lambda: torch.sparse.mm(a_lib, x[:, None]), flush)
        print(f"round {rnd} sparse.mm k1 {lib_ms:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
