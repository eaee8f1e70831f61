"""The B4 / B5 / B6 wrappers of two checkouts of this repository, in turns
on one card: the host time a call and the time the kernel table reads.

Each checkout runs in its own process, in the order old, new, new, old,
building its own ``graph_step.cu`` and ``spmv_ell.cu`` into its own
``build/``.  Each times, through its own wrappers and with the live widths
handed in as ``ops`` hands them:

* ``bfs.bfs_step`` at level 1 and ``pagerank.pagerank_step`` at one power
  step on uniform21's reverse adjacency (2,097,152 nodes);
* ``spmv.spmv_ell`` at k = 1 on uniform2m (2,097,152 rows, C = 256, fp64).

For each: ``ms``, as ``chip_smoke.py``'s kernel table reads it
(``chip_smoke.time_ms``: median of 10 CUDA-event pairs, L2 flushed, the
pair opened before the wrapper's host work), and ``host_us``, HOST_CALLS
calls back to back on the host clock with no synchronize inside the loop,
over the count: what the wrapper spends on the host before its launches
return.  Prints the card's name and power limit, then each run's lines
under a header naming the checkout.  Run from the repository root on a
machine with an NVIDIA GPU, the older commit unpacked with ``git archive``
into a git-ignored directory:

    python3 scripts/wrapper_turns.py build/parent .
"""
import subprocess
import sys
from pathlib import Path

CHILD = """
import sys, time
sys.path[:0] = ["src", "."]
import numpy as np
import torch
import chip_smoke as cs
from repro_torch.graphs import gen as G
from repro_torch.kernels import bfs, cuda_lib, ops, pagerank, spmv
from repro_torch.sparse import formats as F
HOST_CALLS = 200
cuda_lib.build_all(["graph_step", "spmv_ell"])
flush = torch.empty(25_000_000, dtype=torch.float32, device="cuda")
make, kw = cs.GRAPHS["uniform21"]
g = getattr(G, make)(**kw)
n = g.n_nodes
radj = g.transpose().to_device("cuda")
live = bfs.ell_live_widths(radj)
dist = torch.full((n,), G.INF, dtype=torch.int32, device="cuda")
dist[int(np.random.default_rng(0).integers(0, n))] = 0
deg = torch.from_numpy(g.out_degree.astype(np.float64)).cuda()
contrib = torch.where(deg > 0, (1.0 / n) / torch.clamp(deg, min=1), 0.0)
consts = torch.tensor([0.15 / n, 0.85, 1e-7], dtype=torch.float64,
                      device="cuda")
ell = F.csr_to_ellpack(F.random_csr(**cs.ELL_BIG), c=cs.ELL_C)
cols, vals, slive = ops._prepared(ell, torch.device("cuda"))[1]
x = torch.from_numpy(np.random.default_rng(9).standard_normal(
    ell.n_cols)).cuda()
cases = (
    ("B4 bfs_step, uniform21 level 1",
     lambda: bfs.bfs_step(radj, dist, 1, live_width=live)),
    ("B5 pagerank_step, uniform21",
     lambda: pagerank.pagerank_step(radj, contrib, consts, live_width=live)),
    ("B6 spmv_ell k=1, uniform2m",
     lambda: spmv.spmv_ell(cols, vals, x, live_width=slive)))
for label, fn in cases:
    ms = cs.time_ms(torch, fn, flush)
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    host_us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    torch.cuda.synchronize()
    print(f"[wrapper] {label}: ms {ms:.4f} | host_us {host_us:.2f}",
          flush=True)
"""


def main() -> int:
    old, new = (Path(a).resolve() for a in sys.argv[1:3])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    rc = 0
    for name, root in (("old", old), ("new", new), ("new", new), ("old", old)):
        print(f"=== {name}: {root}", flush=True)
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                              capture_output=True, text=True, timeout=600)
        for line in proc.stdout.splitlines():
            if line.startswith("[wrapper]"):
                print(line, flush=True)
        if proc.returncode:
            print(proc.stderr[-3000:], flush=True)
            rc = proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
