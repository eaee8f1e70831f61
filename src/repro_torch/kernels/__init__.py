"""Kernels of the port: the SELL SpMM core (CUDA kernel B1 + its plain
PyTorch version) and the ``ops`` entry points."""
