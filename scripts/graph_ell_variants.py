"""Variants of kernels B4 (ELLPACK BFS level) and B5 (ELLPACK PageRank
step) timed in one process on the card.

Builds copies of ``src/repro_torch/csrc/graph_step.cu`` with the walks'
unroll depth (``UNROLL_ELL``) set to 4, 8 or 16 and, for
B4, its walk's L1 carve-out at the default or at its largest
(``cudaFuncAttributePreferredSharedMemoryCarveout`` 0: the walk uses no
shared memory), then times each at 128 and 256 threads a block on
``chip_smoke.py``'s uniform21 reverse adjacency (2,097,152 nodes), twice
in turns: B4's walk at level 1 from the main path's first source (its
frontier pass, the same for every variant, timed on its own) and B5 at the
first power step.  Every variant's result is ``torch.equal`` to the
committed kernel's.  Then B5's id-free reading: the committed B5 on the
same adjacency with every id ``u`` replaced by ``u % 2048``, so the walk
is the same and its gathers hit a 16 KB range; read in turns with B5, the
gap is the time B5's gathers take through the L2.  Last, the host time a
call of the B4 / B5 wrappers beside their kernels launched raw.

With a checkout of the parent commit as its argument, it also builds that
checkout's ``graph_step.cu`` (B4 / B5 walking to the live widths as they
are handed in, without the kernel's bound to ``[0, width]``) and times it
in turns with the committed kernels, parent, new, new, parent: B4 (its
frontier pass and walk) at every level of uniform21's drive from the same
source (summed: the drive's kernel time) and B5.  Run from the repository root on
a machine with an NVIDIA GPU:

    python3 scripts/graph_ell_variants.py [PARENT_CHECKOUT]

The variant sources and libraries go to the git-ignored ``build/``.
"""
import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.graphs import gen as G  # noqa: E402
from repro_torch.kernels import bfs, cuda_lib, pagerank  # noqa: E402

UNROLLS = (4, 8, 16)
THREADS = (128, 256)
WALK = "  bfs_ell_kernel<UNROLL_ELL><<<"
CARVEOUT = ("  cudaFuncSetAttribute(bfs_ell_kernel<UNROLL_ELL>, "
            "cudaFuncAttributePreferredSharedMemoryCarveout, 0);\n")
_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
#: the parent's B4 / B5 entry points: (adj, live, frontier, dist, out,
#: level, n, threads, stream) and (adj, live, contrib, consts, out, n,
#: threads, stream), the live widths walked unbounded; its frontier pass
#: is the committed one's
PARENT_FNS = {"repro_bfs_frontier": [_P, _P, _I, _I64, _I, _P],
              "repro_bfs_ell_step": [_P, _P, _P, _P, _P, _I, _I64, _I, _P],
              "repro_pagerank_ell_step": [_P, _P, _P, _P, _P, _I64, _I, _P]}
PARENT_THREADS = bfs.ELL_NODE_BLOCK_THREADS


def variant_source(src: str, unroll: int, carveout: bool) -> str:
    s = re.sub(r"constexpr int UNROLL_ELL = \d+;", f"constexpr int UNROLL_ELL = {unroll};",
               src)
    if carveout:
        if WALK not in s:
            raise RuntimeError("B4's walk launch not found in graph_step.cu")
        s = s.replace(WALK, CARVEOUT + WALK)
    return s


def nvcc(cu: Path, so: Path) -> subprocess.Popen:
    return subprocess.Popen([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(so), str(cu)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load(so: Path, fns: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    for fn, args in fns.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = _I
    return lib


def ell_registers(log: str) -> list[str]:
    """ptxas's register lines for the B4 / B5 kernels of one build."""
    out, fn = [], ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif "registers" in ln and ("ell_kernel" in fn or "frontier" in fn):
            out.append(f"{fn}: {ln.split(':', 1)[-1].strip()}")
    return out


def build(parent: Path | None) -> tuple[dict, ctypes.CDLL | None]:
    """{(unroll, carveout): library} and the parent's library, all built in
    parallel."""
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    src = (ROOT / "src/repro_torch/csrc/graph_step.cu").read_text()
    jobs = {}
    for unroll in UNROLLS:
        for carveout in (False, True):
            name = f"u{unroll}{'_l1' if carveout else ''}"
            cu, so = out / f"var_graph_{name}.cu", out / f"libvar_graph_{name}.so"
            cu.write_text(variant_source(src, unroll, carveout))
            jobs[unroll, carveout] = (so, nvcc(cu, so))
    if parent is not None:
        so = out / "libparent_graph_step.so"
        jobs["parent"] = (so, nvcc(parent / "src/repro_torch/csrc/graph_step.cu", so))
    fns = {fn: args for fn, (args, _) in cuda_lib.KERNELS["graph_step"][1].items()}
    libs = {}
    for key, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        print(key, ell_registers(log), flush=True)
        libs[key] = load(so, PARENT_FNS if key == "parent" else fns)
    return libs, libs.pop("parent", None)


def host_us(fn, calls: int = 50) -> float:
    """Host µs a call of ``fn`` over ``calls`` calls enqueued back to back,
    few enough that the card's launch queue never makes the host wait
    (synchronized before and after)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def main_source(n_nodes: int) -> int:
    """The first uniform21 source of chip_smoke.py's graph main path (its
    rng draws rmat15's sources first)."""
    rng = np.random.default_rng(0)
    rng.integers(0, cs.GRAPHS["rmat15"][1]["n_nodes"], cs.REQUESTS_PER_OPERAND)
    return int(rng.integers(0, n_nodes, cs.REQUESTS_PER_OPERAND)[0])


def main() -> int:
    parent = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else None
    libs, old = build(parent)
    print(cs.smi_line(), flush=True)
    flush = torch.empty(25_000_000, dtype=torch.float32, device="cuda")
    make, kw = cs.GRAPHS["uniform21"]
    g = getattr(G, make)(**kw)
    n = g.n_nodes
    radj = g.transpose().to_device("cuda")              # (n, width) view
    store = radj.t()                                     # (width, n) storage
    width = store.shape[0]
    live = bfs.ell_live_widths(radj)
    deg = torch.from_numpy(g.out_degree.astype(np.float64)).cuda()
    src = main_source(n)
    dist = torch.full((n,), G.INF, dtype=torch.int32, device="cuda")
    dist[src] = 0
    front = bfs.bfs_frontier(dist, 1)
    contrib = torch.where(deg > 0, (1.0 / n) / torch.clamp(deg, min=1), 0.0)
    dang = float(torch.where(deg == 0, 1.0 / n, 0.0).sum()) / n
    consts = torch.tensor([(1.0 - cs.DAMPINGS[0]) / n, cs.DAMPINGS[0], dang],
                          dtype=torch.float64, device="cuda")
    want_b4 = bfs.bfs_step(radj, dist, 1, live_width=live)
    want_b5 = pagerank.pagerank_step(radj, contrib, consts, live_width=live)
    out4 = torch.empty_like(dist)
    out5 = torch.empty_like(contrib)
    stream = torch.cuda.current_stream().cuda_stream
    print(f"uniform21: {n} nodes, width {width}, source {src}", flush=True)
    front_ms = cs.time_ms(torch, lambda: bfs.bfs_frontier(dist, 1), flush)
    print(f"frontier pass (committed, {bfs.ELL_NODE_BLOCK_THREADS} threads): "
          f"{front_ms:.4f} ms", flush=True)
    for rnd in range(2):
        for (unroll, carveout), lib in libs.items():
            for threads in THREADS:
                def walk():
                    return lib.repro_bfs_ell_step(
                        store.data_ptr(), live.data_ptr(), front.data_ptr(),
                        dist.data_ptr(), out4.data_ptr(), 1, n, width, threads, stream)

                def step():
                    return lib.repro_pagerank_ell_step(
                        store.data_ptr(), live.data_ptr(), contrib.data_ptr(),
                        consts.data_ptr(), out5.data_ptr(), n, width, threads, 1, stream)

                if walk() or step():
                    raise RuntimeError(f"u{unroll} at {threads} threads: launch refused")
                torch.cuda.synchronize()
                if not (torch.equal(out4, want_b4) and torch.equal(out5, want_b5)):
                    raise AssertionError(f"u{unroll} carveout {carveout} at "
                                         f"{threads} threads differs")
                line = (f"round {rnd} U {unroll} carveout "
                        f"{'0 (max L1)' if carveout else 'default'} threads "
                        f"{threads}: B4 walk {cs.time_ms(torch, walk, flush):.4f} ms")
                if not carveout:
                    line += f"  B5 {cs.time_ms(torch, step, flush):.4f} ms"
                print(line, flush=True)
    # B5's id-free reading, in turns with B5 (B5, id-free, id-free, B5)
    near = torch.where(store != G.PAD, store % 2048, store).t()

    def b5(adj):
        return lambda: pagerank.pagerank_step(adj, contrib, consts, live_width=live)

    reads = [(name, cs.time_ms(torch, b5(adj), flush)) for name, adj in (
        ("B5", radj), ("id-free", near), ("id-free", near), ("B5", radj))]
    print("B5 id-free reading (ids mod 2048), in turns: " + ", ".join(
        f"{name} {ms:.4f} ms" for name, ms in reads), flush=True)
    # the host's share of a wrapper call, beside the committed kernels
    # launched raw
    committed = cuda_lib.library("graph_step")
    threads = bfs.ELL_NODE_BLOCK_THREADS

    def raw_b4():
        committed.repro_bfs_frontier(dist.data_ptr(), front.data_ptr(), 1, n, threads, stream)
        committed.repro_bfs_ell_step(store.data_ptr(), live.data_ptr(), front.data_ptr(),
                                     dist.data_ptr(), out4.data_ptr(), 1, n, width, threads,
                                     stream)

    def raw_b5():
        committed.repro_pagerank_ell_step(store.data_ptr(), live.data_ptr(), contrib.data_ptr(),
                                          consts.data_ptr(), out5.data_ptr(), n, width, threads,
                                          1, stream)

    print("through the wrappers, L2 flushed: bfs_step "
          f"{cs.time_ms(torch, lambda: bfs.bfs_step(radj, dist, 1, live_width=live), flush):.4f}"
          f" ms, raw frontier + walk {cs.time_ms(torch, raw_b4, flush):.4f} ms, "
          f"pagerank_step {cs.time_ms(torch, b5(radj), flush):.4f} ms, raw B5 "
          f"{cs.time_ms(torch, raw_b5, flush):.4f} ms", flush=True)
    print("host time a call (50 calls enqueued): " + ", ".join(
        f"{name} {host_us(fn):.1f} us" for name, fn in (
            ("bfs_step", lambda: bfs.bfs_step(radj, dist, 1, live_width=live)),
            ("bfs_frontier", lambda: bfs.bfs_frontier(dist, 1)),
            ("raw frontier + walk", raw_b4),
            ("pagerank_step", b5(radj)), ("raw B5", raw_b5))), flush=True)
    if old is None:
        return 0
    # the parent's B4 / B5 in turns with the committed kernels, all as raw
    # launches (the new B4: its frontier pass, then its walk)
    levels, d = [], dist
    for level in range(1, n + 1):
        new = bfs.bfs_step(radj, d, level, live_width=live)
        levels.append((level, d))
        if torch.equal(new, d):
            break
        d = new

    words = torch.empty_like(front)

    def old_b4(d, level):
        def run():
            old.repro_bfs_frontier(d.data_ptr(), words.data_ptr(), level, n,
                                   PARENT_THREADS, stream)
            return old.repro_bfs_ell_step(
                store.data_ptr(), live.data_ptr(), words.data_ptr(), d.data_ptr(),
                out4.data_ptr(), level, n, PARENT_THREADS, stream)
        return run

    def new_b4(d, level):
        def run():
            committed.repro_bfs_frontier(d.data_ptr(), words.data_ptr(), level, n,
                                         bfs.ELL_NODE_BLOCK_THREADS, stream)
            return committed.repro_bfs_ell_step(
                store.data_ptr(), live.data_ptr(), words.data_ptr(), d.data_ptr(),
                out4.data_ptr(), level, n, width, bfs.ELL_NODE_BLOCK_THREADS, stream)
        return run

    def old_b5():
        return old.repro_pagerank_ell_step(store.data_ptr(), live.data_ptr(),
                                           contrib.data_ptr(), consts.data_ptr(),
                                           out5.data_ptr(), n, PARENT_THREADS, stream)

    old_b4(dist, 1)()
    old_b5()
    torch.cuda.synchronize()
    if not (torch.equal(out4, want_b4) and torch.equal(out5, want_b5)):
        raise AssertionError("the parent's B4 / B5 differ from the committed kernels")
    for turn in ("parent", "new", "new", "parent"):
        b4 = old_b4 if turn == "parent" else new_b4
        per = [cs.time_ms(torch, b4(d, level), flush) for level, d in levels]
        b5_ms = cs.time_ms(torch, old_b5 if turn == "parent" else raw_b5, flush)
        print(f"turn {turn}: B4 by level " + ", ".join(
            f"{lv}: {t:.4f}" for (lv, _), t in zip(levels, per))
            + f"; drive sum {sum(per):.4f} ms over {len(per)} levels; "
            f"B5 {b5_ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
