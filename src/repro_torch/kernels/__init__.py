"""Kernels of the port: each hand-written CUDA kernel's wrapper beside its
plain PyTorch version (``sell_core``: B1 and the B3 bucket loop; ``bfs`` /
``pagerank``: B3, B4, B5; ``spmv``: B6; ``fft``: B7), their build
(``cuda_lib``), the sharded drives over a mesh (``sell_shard``), the one
memo of an operand's scans and uploads (``uploads``) and the ``ops`` entry
points."""
