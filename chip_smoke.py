#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed as it completes; any failure exits non-zero before the
result line is printed:

1. device   — the card's name and power limit (``nvidia-smi``);
2. build    — every CUDA kernel of the main path, built from ``src/`` with
              ``nvcc`` (one process per source, started together);
3. compare  — kernel B1 (``spmm_sell``) against its plain PyTorch version
              on the card, over C x k x dtype on two operands;
4. main     — the port's main path as a user drives it: a ``KernelRegistry``
              on the card registers cage10 and a 2,097,152-row operand, a
              ``KernelService(n_slots=32)`` serves 64 SpMV requests, every
              result is checked; kernel launch counts are read around it;
5. timing   — B1 at the main path's shapes, CUDA events, beside its
              bytes bound (the function's least traffic: stored entries,
              row ids, X and Y once each), the same figure over the padded
              slabs, the plain version and ``torch.sparse.mm``.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
one JSON object with a record per kernel.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

#: H100 SXM data sheet: HBM3 bandwidth and fp64 (non-tensor) peak
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12
BIG = dict(n_rows=2_097_152, n_cols=2_097_152, avg_nnz_row=16.0, seed=0,
           skew=1.0)
N_SLOTS = 32
REQUESTS_PER_OPERAND = 32


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def max_err(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def compare_kernel(torch, np, sell_core, F) -> float:
    """Phase 3: B1 vs spmm_sell_ref on the card; returns the fp64 max error."""
    operands = {
        "cage10": lambda dt: F.cage10_like(seed=0, dtype=dt),
        "rand4096": lambda dt: F.random_csr(4096, 4096, 8.0, seed=3,
                                            skew=1.2, dtype=dt),
    }
    rng = np.random.default_rng(1)
    worst64 = 0.0
    n_cases = 0
    for dt in (np.float64, np.float32):
        for name, make in operands.items():
            csr = make(dt)
            for c in (8, 32, 128, 256):
                slabs = F.csr_to_sell_slabs(csr, c=c)
                cols, vals, rows = slabs.to_device("cuda")
                # k_block 32: k_tile = pow2_ceil(k); the extra k=32 cases
                # reach every k_tile instantiation (1 .. 32)
                cases = [(1, 32), (8, 32), (32, 32), (32, 2), (32, 4),
                         (32, 16)]
                for k, kb in cases:
                    x = torch.from_numpy(
                        rng.standard_normal((csr.n_cols, k)).astype(dt)).cuda()
                    got = sell_core.spmm_sell(cols, vals, rows, x,
                                              n_rows=csr.n_rows, k_block=kb)
                    torch.cuda.synchronize()
                    want = sell_core.spmm_sell_ref(cols, vals, rows, x,
                                                   n_rows=csr.n_rows)
                    err = max_err(got, want)
                    if dt == np.float64:
                        tol = 1e-10
                        worst64 = max(worst64, err)
                    else:
                        tol = 1e-4 * float(want.abs().max())
                    if not err <= tol:
                        raise AssertionError(
                            f"B1 vs plain: {name} {np.dtype(dt).name} C={c} "
                            f"k={k} k_block={kb}: max abs err {err} > {tol}")
                    n_cases += 1
            phase("compare", f"{name} {np.dtype(dt).name}: C in (8, 32, 128, "
                  f"256) x (k, k_block) in {cases} within tolerance")
    phase("compare", f"{n_cases} cases ok; fp64 max abs err {worst64:.3e} "
          "(tol 1e-10), fp32 tol 1e-4 * max|y|")
    return worst64


def time_ms(torch, fn, flush, runs: int = 10, warmup: int = 2) -> float:
    """Median ms of ``fn`` over ``runs`` CUDA-event-timed calls, each after
    the L2 is flushed by overwriting a buffer twice its size."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bucket_ms(torch, sell_core, cols, vals, rows, x, n_rows, k_block, flush,
              runs: int = 5) -> list[float]:
    """Median ms of each bucket's launch alone (the per-bucket breakdown of
    one spmm_sell call; X's k is already a whole number of k tiles)."""
    kt = sell_core.k_tile_for(x.shape[1], k_block)
    y = torch.zeros((n_rows + 1, x.shape[1]), dtype=x.dtype, device=x.device)
    out = []
    for c, v, r in zip(cols, vals, rows):
        out.append(time_ms(torch, lambda: sell_core._launch_bucket(
            c, v, r, x, y, kt), flush, runs=runs, warmup=1))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.kernels import cuda_lib, sell_core
    from repro_torch.service import KernelRegistry, KernelService
    from repro_torch.sparse import formats as F

    # -- 1. device -----------------------------------------------------------
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = cuda_lib.build_all()
    for b in built:
        regs = [ln.strip() for ln in b.log.splitlines()
                if "registers" in ln or "spill" in ln]
        phase("build", f"{b.name}: {b.path.name} in {b.seconds:.1f} s")
        for ln in regs:
            phase("build", f"  {ln}")
    phase("build", f"all kernels built in {time.perf_counter() - t0:.1f} s")

    # -- 3. kernel vs plain ------------------------------------------------
    compare_kernel(torch, np, sell_core, F)

    # -- 4. main path --------------------------------------------------------
    t0 = time.perf_counter()
    cage = F.cage10_like(seed=0)
    big = F.random_csr(**BIG)
    phase("main", f"operands generated in {time.perf_counter() - t0:.1f} s: "
          f"cage10 {cage.n_rows}x{cage.n_cols} nnz {cage.nnz}; big "
          f"{big.n_rows}x{big.n_cols} nnz {big.nnz}")
    reg = KernelRegistry(device="cuda")
    operands = {"cage10": cage, "big": big}
    for name, csr in operands.items():
        op = reg.register_matrix(name, csr)
        t = op.tuned
        phase("main", f"registered {name}: C={t.c} sigma={t.sigma} "
              f"k_block={t.k_block} pad={op.pad_factor:.4f} buckets="
              f"{list(op.slabs.widths)} in {op.register_us / 1e6:.1f} s")
    svc = KernelService(reg, n_slots=N_SLOTS)
    rng = np.random.default_rng(0)
    xs = {name: [rng.standard_normal(csr.n_cols)
                 for _ in range(REQUESTS_PER_OPERAND)]
          for name, csr in operands.items()}
    torch.cuda.synchronize()
    sell_core.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    rids = {name: [svc.submit("spmv", name, x) for x in xs[name]]
            for name in operands}
    svc.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sell_core.KERNEL_LAUNCHES
    n_req = sum(len(v) for v in rids.values())
    stats = dict(svc.stats)
    phase("main", f"stats {json.dumps(stats)}")
    launch_wall = svc.metrics.get("launch_wall_us_spmv")
    phase("main", f"KERNEL_LAUNCHES={launches}; {n_req} requests in "
          f"{wall:.4f} s = {n_req / wall:.1f} requests/s; batched core calls "
          f"(kernels + sync) {launch_wall.total / 1e3:.3f} ms of it over "
          f"{launch_wall.count} groups")
    if launches <= 0:
        raise AssertionError("the main path launched kernel B1 no time")
    expected = sum(reg.get(n).launches * reg.get(n).slabs.n_buckets
                   for n in operands)
    if launches != expected:
        raise AssertionError(
            f"{launches} launches != one per bucket per group ({expected})")
    if stats["served"] != n_req or stats["failed"]:
        raise AssertionError(f"not every request was served: {stats}")
    for name, csr in operands.items():
        op = reg.get(name)
        arrs = op.device_arrays
        got = torch.stack([svc.poll(r) for r in rids[name]], dim=1)
        if tuple(got.shape) != (csr.n_rows, len(rids[name])) \
                or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: bad result shape/values")
        x_stack = torch.from_numpy(np.stack(xs[name], axis=1)).cuda()
        want = sell_core.spmm_sell_ref(arrs["cols"], arrs["vals"],
                                       arrs["rows"], x_stack, n_rows=csr.n_rows)
        err_ref = max_err(got, want)
        err_host = 0.0
        for i in range(4):
            host = torch.from_numpy(csr.matvec(xs[name][i]))
            err_host = max(err_host, max_err(got[:, i].cpu(), host))
        phase("main", f"{name}: {len(rids[name])} results vs plain on card "
              f"max abs err {err_ref:.3e}; 4 vs host CSR matvec "
              f"{err_host:.3e} (tol 1e-10)")
        if not (err_ref <= 1e-10 and err_host <= 1e-10):
            raise AssertionError(f"{name}: results disagree with references")

    # -- 5. timing at the main path's shapes --------------------------------
    op = reg.get("big")
    cols, vals, rows = (op.device_arrays[k] for k in ("cols", "vals", "rows"))
    # bytes the padded SELL slabs hold (the layout's cost, printed beside
    # the bound); the bound itself counts only what Y = A @ X must move
    slab_bytes = sum(t.numel() * t.element_size()
                     for t in (*cols, *vals, *rows))
    elem = vals[0].element_size()
    a_lib = torch.sparse_csr_tensor(
        torch.from_numpy(big.indptr), torch.from_numpy(big.indices.astype(np.int64)),
        torch.from_numpy(big.data), size=(big.n_rows, big.n_cols)).cuda()
    flush = torch.empty(2 * 50 * 1000 * 1000 // 4, dtype=torch.float32,
                        device="cuda")
    records = {}
    for k in (1, REQUESTS_PER_OPERAND):
        x = torch.from_numpy(rng.standard_normal((big.n_cols, k))).cuda()
        kb = op.tuned.k_block

        def kernel():
            return sell_core.spmm_sell(cols, vals, rows, x, n_rows=big.n_rows,
                                       k_block=kb)

        def plain():
            return sell_core.spmm_sell_ref(cols, vals, rows, x,
                                           n_rows=big.n_rows)

        def library():
            return torch.sparse.mm(a_lib, x)

        y_k, y_p, y_l = kernel(), plain(), library()
        torch.cuda.synchronize()
        err = max_err(y_k, y_p)
        err_lib = max_err(y_k, y_l)
        if not (err <= 1e-10 and err_lib <= 1e-10):
            raise AssertionError(f"k={k}: kernel vs plain {err}, vs library "
                                 f"{err_lib}")
        ms = time_ms(torch, kernel, flush)
        plain_ms = time_ms(torch, plain, flush)
        lib_ms = time_ms(torch, library, flush)
        xy_bytes = elem * k * (big.n_cols + big.n_rows)
        # each stored entry (int32 column + value) once, each row's id
        # once, X read once, Y written once
        bytes_ms = (big.nnz * (4 + elem) + 4 * big.n_rows + xy_bytes) \
            / HBM_BYTES_PER_S * 1e3
        padded_ms = (slab_bytes + xy_bytes) / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * big.nnz * k / FP64_FLOPS * 1e3
        records[k] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=max(bytes_ms, ops_ms),
                          bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                          padded_slab_bound_ms=padded_ms,
                          max_abs_err=err)
        phase("timing", f"big k={k} per bucket (W: slices, ms): " + ", ".join(
            f"{c.shape[1]}: {c.shape[0]}, {t:.4f}"
            for c, t in zip(cols, bucket_ms(torch, sell_core, cols, vals, rows,
                                            x, big.n_rows, kb, flush))))
        phase("timing", f"big k={k}: B1 {ms:.4f} ms | bound {bytes_ms:.4f} ms "
              f"(bytes; ops {ops_ms:.4f}) | padded-slab bytes bound "
              f"{padded_ms:.4f} ms | plain {plain_ms:.4f} ms | "
              f"torch.sparse.mm {lib_ms:.4f} ms | max abs err vs plain "
              f"{err:.3e}, vs sparse.mm {err_lib:.3e} | slab bytes "
              f"{slab_bytes}")

    main_k = REQUESTS_PER_OPERAND
    rec = records[main_k]
    kernels = {"kernels": [{
        "name": "spmm_sell",
        "route": "cuda",
        "source": "src/repro_torch/csrc/spmm_sell.cu",
        "replaces": "src/repro/kernels/sell_core.py:93",
        "launches": launches,
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"],
        "shape": f"{big.n_rows}x{big.n_cols} nnz {big.nnz} fp64, k={main_k}",
        "k1": records[1],
    }]}
    print(smi_line(), flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
