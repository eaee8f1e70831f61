"""Sparse-matrix substrate of the port: CSR / SELL-C-sigma containers, the
device slab layout :class:`SellSlabs`, packers and generators."""
from repro_torch.sparse.formats import (
    PAD,
    CSRMatrix,
    SellCSigmaMatrix,
    SellSlabs,
    cage10_like,
    csr_to_sell,
    csr_to_sell_slabs,
    random_csr,
    sell_slabs_to_csr,
    sell_to_slabs,
    slabs_from_arrays,
    to_csr,
)

__all__ = [
    "PAD",
    "CSRMatrix",
    "SellCSigmaMatrix",
    "SellSlabs",
    "cage10_like",
    "csr_to_sell",
    "csr_to_sell_slabs",
    "random_csr",
    "sell_slabs_to_csr",
    "sell_to_slabs",
    "slabs_from_arrays",
    "to_csr",
]
