"""Kernels B4, B5, B6 and B9 of two checkouts, in turns on one card: what
bounding the live widths (B4 / B5 / B6) and the ids (B9) inside the
kernels costs.

Builds the older checkout's ``graph_step.cu``, ``spmv_ell.cu`` and
``embedding_gather.cu`` beside this checkout's (one ``nvcc`` each, all
started together, into the git-ignored ``build/``), checks that both give
``torch.equal`` results at the main paths' shapes, then times each raw
launch (``ctypes``, no wrapper) with CUDA events, L2 flushed, median of
10 (``chip_smoke.time_ms``), in the order old, new, new, old:

* B4's walk at level 1 and B5 at one power step on uniform21's reverse
  adjacency (2,097,152 nodes, the live widths ``ops`` caches);
* B6 at k = 1 and its k-column form at k = 32 on uniform2m (2,097,152
  rows, C = 256, fp64);
* B9 at T = 512 int64 ids on the card from mamba2's (50,280, 2560) fp32
  table, 16 id sets in turn (so each launch reads other rows).

The older checkout is one whose kernels read the widths and ids unbounded
(the C entry points without ``width`` / ``n_rows``).  Run from the
repository root on a machine with an NVIDIA GPU, the older commit
unpacked with ``git archive`` into a git-ignored directory:

    python3 scripts/bounds_turns.py build/parent
"""
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core.autotune import gather_grid  # noqa: E402
from repro_torch.graphs import gen as G  # noqa: E402
from repro_torch.kernels import bfs, cuda_lib, ops, spmv  # noqa: E402
from repro_torch.sparse import formats as F  # noqa: E402

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
#: the older checkout's entry points (the kernels' C interfaces before the
#: bounds): (argtypes) of each
OLD_FNS = {
    "graph_step": {
        "repro_bfs_frontier": [_P, _P, _I, _I64, _I, _P],
        "repro_bfs_ell_step": [_P, _P, _P, _P, _P, _I, _I64, _I, _P],
        "repro_pagerank_ell_step": [_P, _P, _P, _P, _P, _I64, _I, _P]},
    "spmv_ell": {name: args for name, (args, _) in
                 cuda_lib.KERNELS["spmv_ell"][1].items()},
    "embedding_gather": {
        "repro_embedding_gather": [_P, _P, _P, _I64, _I64, _I, _I, _I, _P]},
}


def build_old(old: Path) -> dict:
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    jobs = {}
    for name in OLD_FNS:
        src = old / "src/repro_torch/csrc" / cuda_lib.KERNELS[name][0]
        so = out / f"libold_{name}.so"
        jobs[name] = (so, subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the older {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, args in OLD_FNS[name].items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = _I
        libs[name] = lib
    return libs


def turns(label: str, old_fn, new_fn, flush) -> None:
    reads = [cs.time_ms(torch, fn, flush) for fn in (old_fn, new_fn, new_fn, old_fn)]
    print(f"{label}: old {reads[0]:.4f} / new {reads[1]:.4f} / new {reads[2]:.4f}"
          f" / old {reads[3]:.4f} ms", flush=True)


def main() -> int:
    old = build_old(Path(sys.argv[1]).resolve())
    cuda_lib.build_all(list(OLD_FNS))
    new = {name: cuda_lib.library(name) for name in OLD_FNS}
    print(cs.smi_line(), flush=True)
    flush = torch.empty(25_000_000, dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    threads = bfs.ELL_NODE_BLOCK_THREADS

    # B4 / B5: uniform21
    make, kw = cs.GRAPHS["uniform21"]
    g = getattr(G, make)(**kw)
    n = g.n_nodes
    radj = g.transpose().to_device("cuda")
    store = radj.t()
    width = store.shape[0]
    live = bfs.ell_live_widths(radj)
    src = int(np.random.default_rng(0).integers(0, n))
    dist = torch.full((n,), G.INF, dtype=torch.int32, device="cuda")
    dist[src] = 0
    front = bfs.bfs_frontier(dist, 1)
    deg = torch.from_numpy(g.out_degree.astype(np.float64)).cuda()
    contrib = torch.where(deg > 0, (1.0 / n) / torch.clamp(deg, min=1), 0.0)
    consts = torch.tensor([0.15 / n, 0.85, 1e-7], dtype=torch.float64, device="cuda")
    outs = {k: (torch.empty_like(dist), torch.empty_like(contrib)) for k in ("old", "new")}
    g_old, g_new = old["graph_step"], new["graph_step"]

    def b4(which):
        o4 = outs[which][0]
        if which == "old":
            return lambda: g_old.repro_bfs_ell_step(
                store.data_ptr(), live.data_ptr(), front.data_ptr(), dist.data_ptr(),
                o4.data_ptr(), 1, n, threads, stream)
        return lambda: g_new.repro_bfs_ell_step(
            store.data_ptr(), live.data_ptr(), front.data_ptr(), dist.data_ptr(),
            o4.data_ptr(), 1, n, width, threads, stream)

    def b5(which):
        o5 = outs[which][1]
        if which == "old":
            return lambda: g_old.repro_pagerank_ell_step(
                store.data_ptr(), live.data_ptr(), contrib.data_ptr(), consts.data_ptr(),
                o5.data_ptr(), n, threads, stream)
        return lambda: g_new.repro_pagerank_ell_step(
            store.data_ptr(), live.data_ptr(), contrib.data_ptr(), consts.data_ptr(),
            o5.data_ptr(), n, width, threads, 1, stream)

    # B6: uniform2m, C = 256, fp64
    ell = F.csr_to_ellpack(F.random_csr(**cs.ELL_BIG), c=cs.ELL_C)
    cols, vals, slive = ops._prepared(ell, torch.device("cuda"))[1]
    s, w, c = cols.shape
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal(ell.n_cols)).cuda()
    X = torch.from_numpy(rng.standard_normal((ell.n_cols, cs.ELL_K))).cuda()
    ys = {k: (torch.empty(s * c, dtype=torch.float64, device="cuda"),
              torch.empty((s * c, cs.ELL_K), dtype=torch.float64, device="cuda"))
          for k in ("old", "new")}
    vec = spmv.ell_vec(cs.ELL_K, 8, True)
    tiles = spmv.ell_k_tiles(cs.ELL_K, vec)

    def b6(which, k):
        lib = old["spmv_ell"] if which == "old" else new["spmv_ell"]
        y, Y = ys[which]
        if k == 1:
            return lambda: lib.repro_spmv_ell(
                cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(),
                slive.data_ptr(), s, w, c, spmv.ELL_BLOCK_THREADS, 1, stream)

        def run():
            for k0, kt, group in tiles:
                lib.repro_spmm_ell(cols.data_ptr(), vals.data_ptr(), X.data_ptr(),
                                   Y.data_ptr(), slive.data_ptr(), s, w, c, cs.ELL_K,
                                   k0, kt, group, vec, spmv.ELL_BLOCK_THREADS, 1, stream)
        return run

    # B9: T = 512 int64 ids on the card, mamba2's table
    v, d = 50_280, 2560
    table = torch.randn((v, d), dtype=torch.float32, device="cuda")
    ids = [torch.from_numpy(np.random.default_rng(t).integers(0, v, cs.LM_PROMPT))
           .cuda() for t in range(cs.GATHER_ID_SETS)]
    chunks, gthreads = gather_grid(cs.LM_PROMPT, d * 4)
    gout = {k: torch.empty((cs.LM_PROMPT, d), device="cuda") for k in ("old", "new")}

    def b9(which):
        turn = [0]
        o = gout[which]

        def run():
            i = ids[turn[0] % len(ids)]
            turn[0] += 1
            if which == "old":
                return old["embedding_gather"].repro_embedding_gather(
                    table.data_ptr(), i.data_ptr(), o.data_ptr(), i.shape[0], d * 4, 8,
                    chunks, gthreads, stream)
            return new["embedding_gather"].repro_embedding_gather(
                table.data_ptr(), v, i.data_ptr(), o.data_ptr(), i.shape[0], d * 4, 8,
                chunks, gthreads, stream)
        return run

    cases = (("B4 walk, uniform21 level 1", b4), ("B5, uniform21", b5),
             ("B6 k=1, uniform2m", lambda wh: b6(wh, 1)),
             (f"B6 k={cs.ELL_K}, uniform2m", lambda wh: b6(wh, cs.ELL_K)),
             (f"B9 T={cs.LM_PROMPT} int64 ids, ({v}, {d}) fp32", b9))
    for label, make_fn in cases:
        if make_fn("old")() or make_fn("new")():
            raise RuntimeError(f"{label}: a launch was refused")
    torch.cuda.synchronize()
    same = [torch.equal(outs["old"][0], outs["new"][0]),
            torch.equal(outs["old"][1], outs["new"][1]),
            torch.equal(ys["old"][0], ys["new"][0]),
            torch.equal(ys["old"][1], ys["new"][1]),
            torch.equal(gout["old"], gout["new"])]
    if not all(same):
        raise AssertionError(f"old and new kernels differ: {same}")
    print("old and new results torch.equal at every case", flush=True)
    for label, make_fn in cases:
        turns(label, make_fn("old"), make_fn("new"), flush)
    return 0


if __name__ == "__main__":
    sys.exit(main())
