"""Count the rows whose split walk differs between a SELL operand and its
row-sharded layout: why the sharded drives are bit-identical to their
serial fold but not to the unsharded port wherever kernel B1 or B3 splits
a bucket.

B1 (:func:`repro_torch.core.autotune.spmm_split`) and B3
(:func:`~repro_torch.core.autotune.node_split`) let ``parts`` threads share
a row of a wide bucket and add their partial sums in a fixed order;
``parts`` follows the bucket's width and slice count.  A shard packs its
rows at the same (C, sigma) but sorts them in its own sigma windows, so a
row can land in a slice of another width, and a shard's bucket has fewer
slices than the whole operand's.  For every row (node) this prints how
many sit in a split bucket of either layout, how many change width, how
many get other ``parts`` as the port chooses them (from the shard's own
slice count), and how many would still differ if a shard chose from its
union bucket's slice count summed over the shards.

    PYTHONPATH=src python scripts/shard_split_rows.py            # big, rmat15
    PYTHONPATH=src python scripts/shard_split_rows.py --rows 262144

Host-only numpy (no card); big at its full 2,097,152 rows packs about
2 GB of slabs twice, so run the full size on a machine with the memory.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.core.autotune import node_split, spmm_split
from repro_torch.graphs import gen as G
from repro_torch.sparse import formats as F


def _walks(arrays, ids, shape_of, split, n_shards: int, shard=None):
    """Per bucket of a layout (one shard's of a sharded layout): its row
    ids, width, parts from its own slice count and parts from the slice
    count summed over ``n_shards`` shards."""
    for a, r in zip(arrays, ids):
        if shard is not None:
            a, r = a[shard], r[shard]
        s, w, c = shape_of(a)
        yield (r.reshape(-1), w, split(w, c, s).parts,
               split(w, c, s * n_shards).parts)


def _fill(tables, walks, limit: int, offset: int = 0) -> None:
    """Write each row's (width, parts, union parts) into ``tables``; ids
    from ``limit`` on are padding."""
    for r, *vals in walks:
        live = r[r < limit] + offset
        for table, v in zip(tables, vals):
            table[live] = v


def compare(n: int, whole, shards, lengths) -> dict:
    """``whole``: the unsharded layout's walks; ``shards``: (walks, limit,
    offset) a shard.  Rows of one entry sum alike in any grouping."""
    w0, p0, _ = tables0 = tuple(np.zeros(n, np.int64) for _ in range(3))
    _fill(tables0, whole, n)
    ws, ps, pu = tables = tuple(np.zeros(n, np.int64) for _ in range(3))
    for walks, limit, offset in shards:
        _fill(tables, walks, limit, offset)
    many = np.asarray(lengths) > 1
    return {
        "rows": int(n),
        "in a split bucket of either layout": int(((p0 > 1) | (ps > 1)).sum()),
        "width differs": int((w0 != ws).sum()),
        "parts differ (the shard's slices)": int(((p0 != ps) & many).sum()),
        "parts differ (the union's slices summed)":
            int(((p0 != pu) & many).sum()),
    }


def matrix(rows: int, n_shards: int, c: int, sigma: int, k_tiles) -> dict:
    """B1 on big's law (``random_csr(rows, rows, 16, seed=0, skew=1.0)``)
    at each RHS tile."""
    csr = F.random_csr(rows, rows, 16.0, seed=0, skew=1.0)
    slabs = F.csr_to_sell_slabs(csr, c=c, sigma=sigma)
    sh = F.shard_slabs(slabs, n_shards)
    out = {}
    for kt in k_tiles:
        def split(w, c_, s, kt=kt):
            return spmm_split(w, c_, s, kt, 8)

        out[f"k_tile {kt}"] = compare(
            rows,
            _walks(slabs.bucket_cols, slabs.bucket_rows, np.shape, split, 1),
            [(_walks(sh.bucket_cols, sh.bucket_rows, np.shape, split,
                     n_shards, d), int(sh.row_counts[d]),
              int(sh.row_starts[d])) for d in range(n_shards)],
            np.diff(csr.indptr))
    return out


def graph(n_shards: int, c: int, sigma: int) -> dict:
    """B3's PageRank combine on rmat15's reverse graph at k_tile 32 (graph
    slabs are (S, C, W); node maps hold global ids)."""
    g = G.rmat_graph(1 << 15, 16, seed=0)
    rg = g.transpose()
    n = g.n_nodes
    slabs = G.graph_to_sell_slabs(rg, c=c, sigma=sigma)
    sg = G.shard_graph_slabs(rg, c=c, n_shards=n_shards, sigma=sigma)

    def shape_of(a):
        return a.shape[0], a.shape[2], a.shape[1]

    out = {}
    for itemsize, dtype in ((8, "float64"), (4, "float32")):
        def split(w, c_, s, itemsize=itemsize):
            return node_split(w, c_, s, 32, itemsize, "pagerank")

        out[f"PageRank {dtype} k_tile 32"] = compare(
            n, _walks(slabs.bucket_adj, slabs.bucket_nodes, shape_of, split,
                      1),
            [(_walks(sg.bucket_adj, sg.bucket_nodes, shape_of, split,
                     n_shards, d), n, 0) for d in range(n_shards)],
            (rg.adj != G.PAD).sum(axis=1))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=2_097_152,
                    help="rows of the skewed matrix (big: 2,097,152)")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--c", type=int, default=32)
    ap.add_argument("--sigma", type=int, default=1024)
    args = ap.parse_args(argv)
    res = {
        "shards": args.shards, "c": args.c, "sigma": args.sigma,
        f"random_csr({args.rows}, skew=1.0) B1":
            matrix(args.rows, args.shards, args.c, args.sigma, (1, 8, 32)),
        "rmat15 B3": graph(args.shards, args.c, args.sigma),
    }
    print(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
