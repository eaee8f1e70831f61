"""PyTorch/CUDA port of the ``repro`` SELL sparse-kernel system for one
NVIDIA H100.

The JAX package ``repro`` is the reference and is never imported here.
Module names mirror ``repro`` so each counterpart is easy to find:
``sparse.formats`` (host packing), ``core`` (SDV model + Hopper tuner),
``analysis`` (launch preflight), ``kernels`` (``sell_core`` with the
hand-written CUDA kernel under ``csrc/``, ``ops`` entry points),
``obs``, ``serve.slots`` and ``service`` (registry, tune cache, kernel
service).  Entry points run on the card unless the caller passes
``device="cpu"``; with no GPU a CUDA request raises.
"""
