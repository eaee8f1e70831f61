"""Graph substrate of the port: generators, SELL slab packing, the upload
to the card and host references for BFS / PageRank."""
from repro_torch.graphs.gen import (
    INF,
    PAD,
    EllpackGraph,
    SellGraphSlabs,
    ShardedGraphSlabs,
    bfs_reference,
    graph_to_sell_slabs,
    pagerank_reference,
    random_graph,
    rmat_graph,
    shard_graph_slabs,
)

__all__ = [
    "INF",
    "PAD",
    "EllpackGraph",
    "SellGraphSlabs",
    "ShardedGraphSlabs",
    "bfs_reference",
    "graph_to_sell_slabs",
    "pagerank_reference",
    "random_graph",
    "rmat_graph",
    "shard_graph_slabs",
]
