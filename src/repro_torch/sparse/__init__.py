"""Sparse-matrix substrate of the port: CSR / ELLPACK / SELL-C-sigma
containers, the device slab layout :class:`SellSlabs`, packers and
generators."""
from repro_torch.sparse.formats import (
    PAD,
    CSRMatrix,
    EllpackMatrix,
    SellCSigmaMatrix,
    SellSlabs,
    StreamColumnMap,
    cage10_like,
    csr_to_ellpack,
    csr_to_sell,
    csr_to_sell_slabs,
    ellpack_to_csr,
    random_csr,
    sell_slabs_to_csr,
    sell_to_slabs,
    slabs_from_arrays,
    stream_column_map,
    to_csr,
)

__all__ = [
    "PAD",
    "CSRMatrix",
    "EllpackMatrix",
    "SellCSigmaMatrix",
    "SellSlabs",
    "StreamColumnMap",
    "cage10_like",
    "csr_to_ellpack",
    "csr_to_sell",
    "csr_to_sell_slabs",
    "ellpack_to_csr",
    "random_csr",
    "sell_slabs_to_csr",
    "sell_to_slabs",
    "slabs_from_arrays",
    "stream_column_map",
    "to_csr",
]
