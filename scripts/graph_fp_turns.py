"""B3's PageRank kernels and B5 before and after they were templated on
the rank type, in turns on one card: the float64 forms must stay
bit-equal, and no slower.

Builds the older checkout's ``graph_step.cu`` (its PageRank C entries take
no ``is_double``) beside this checkout's, then

* runs ``tests/test_torch_cuda.py::pagerank_fp64_cases`` (B3 on unsplit and
  split buckets at k = 1 / 3 / 32 and one configuration, B5) through both
  libraries, checks every output ``torch.equal`` and prints the outputs'
  digests as the test's ``PAGERANK_FP64_DIGESTS``;
* at the main paths' shapes (uniform21, rmat15: B3 at k = 1 and 32, B5 on
  uniform21) checks both ``torch.equal`` and times each wrapper call with
  CUDA events, L2 flushed, median of 10 (``chip_smoke.time_ms``), in the
  order old, new, new, old.

Run from the repository root on a machine with an NVIDIA GPU, the older
commit unpacked with ``git archive`` into a git-ignored directory:

    python3 scripts/graph_fp_turns.py build/parent
"""
import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.graphs import gen as G  # noqa: E402
from repro_torch.kernels import bfs, cuda_lib, pagerank  # noqa: E402

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
#: the older checkout's PageRank entry points (no is_double)
OLD_FNS = {
    "repro_pagerank_sell_bucket": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                                   _I, _I64, _I, _I, _P],
    "repro_pagerank_ell_step": [_P, _P, _P, _P, _P, _I64, _I64, _I, _P],
}


class OldGraphLib:
    """The older library behind the current C signatures: each call drops
    the ``is_double`` argument (the older kernels are float64 only)."""

    def __init__(self, lib):
        self.lib = lib

    def repro_pagerank_sell_bucket(self, *args):
        assert args[13] == 1
        return self.lib.repro_pagerank_sell_bucket(*args[:13], args[14])

    def repro_pagerank_ell_step(self, *args):
        assert args[8] == 1
        return self.lib.repro_pagerank_ell_step(*args[:8], args[9])

    def repro_graph_cuda_error_string(self, code):
        return self.lib.repro_graph_cuda_error_string(code)


def build_old(old: Path) -> OldGraphLib:
    so = ROOT / "build" / "libold_graph_step.so"
    so.parent.mkdir(exist_ok=True)
    src = old / "src/repro_torch/csrc/graph_step.cu"
    proc = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(so),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the older graph_step.cu:\n"
                           f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn, args in OLD_FNS.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = _I
    lib.repro_graph_cuda_error_string.argtypes = [_I]
    lib.repro_graph_cuda_error_string.restype = ctypes.c_char_p
    return OldGraphLib(lib)


def with_lib(lib, fn):
    """``fn`` run with the PageRank wrappers launching from ``lib``."""
    def run(*args, **kw):
        real = pagerank._graph_lib
        pagerank._graph_lib = lambda: lib
        try:
            return fn(*args, **kw)
        finally:
            pagerank._graph_lib = real
    return run


def main() -> int:
    old = build_old(Path(sys.argv[1]).resolve())
    new = cuda_lib.library("graph_step")
    print(cs.smi_line(), flush=True)
    spec = importlib.util.spec_from_file_location(
        "test_torch_cuda", ROOT / "tests" / "test_torch_cuda.py")
    tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tests)
    dev = torch.device("cuda")

    def ell(radj, live, contrib, consts):
        return pagerank.pagerank_step(radj, contrib, consts, live_width=live)

    outs = {which: tests.pagerank_fp64_cases(
        G, with_lib(lib, pagerank.pagerank_step_sell), with_lib(lib, ell), dev)
        for which, lib in (("old", old), ("new", new))}
    for name in outs["old"]:
        if not torch.equal(outs["old"][name], outs["new"][name]):
            raise AssertionError(f"{name}: the float64 form differs from the "
                                 "older kernel's")
    print(f"{len(outs['old'])} fp64 cases torch.equal to the older kernels",
          flush=True)
    print("PAGERANK_FP64_DIGESTS = {")
    for name, t in outs["new"].items():
        print(f"    {name!r}: {tests._digest(t)!r},")
    print("}", flush=True)

    flush = torch.empty(25_000_000, dtype=torch.float32, device=dev)
    for gname in ("uniform21", "rmat15"):
        make, kw = cs.GRAPHS[gname]
        g = getattr(G, make)(**kw)
        n = g.n_nodes
        rg = g.transpose()
        adj, nodes = G.graph_to_sell_slabs(rg, c=32).to_device(dev)
        deg = torch.from_numpy(g.out_degree.astype(np.float64)).to(dev)
        c1 = torch.where(deg > 0, (1.0 / n) / torch.clamp(deg, min=1), 0.0)
        for k in (1, 32):
            contrib = torch.cat([c1, c1.new_zeros(1)])
            consts = torch.tensor([0.15 / n, 0.85, 1e-7], dtype=torch.float64,
                                  device=dev)
            if k > 1:
                contrib = contrib[:, None].expand(n + 1, k).contiguous()
                consts = consts[:, None].expand(3, k).contiguous()
            fns = {which: (lambda lib=lib: with_lib(lib, pagerank.pagerank_step_sell)(
                adj, nodes, contrib, consts)) for which, lib in
                (("old", old), ("new", new))}
            if not torch.equal(fns["old"](), fns["new"]()):
                raise AssertionError(f"{gname} k={k}: B3 fp64 differs")
            reads = [cs.time_ms(torch, fns[w], flush)
                     for w in ("old", "new", "new", "old")]
            print(f"{gname} k={k} B3 PageRank fp64 (C = 32): old {reads[0]:.4f}"
                  f" / new {reads[1]:.4f} / new {reads[2]:.4f} / old "
                  f"{reads[3]:.4f} ms", flush=True)
        if gname == "uniform21":
            radj = rg.to_device(dev)
            live = bfs.ell_live_widths(radj)
            consts = torch.tensor([0.15 / n, 0.85, 1e-7], dtype=torch.float64,
                                  device=dev)
            fns = {which: (lambda lib=lib: with_lib(lib, ell)(radj, live, c1,
                                                              consts))
                   for which, lib in (("old", old), ("new", new))}
            if not torch.equal(fns["old"](), fns["new"]()):
                raise AssertionError("uniform21: B5 fp64 differs")
            reads = [cs.time_ms(torch, fns[w], flush)
                     for w in ("old", "new", "new", "old")]
            print(f"uniform21 B5 fp64: old {reads[0]:.4f} / new {reads[1]:.4f}"
                  f" / new {reads[2]:.4f} / old {reads[3]:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
