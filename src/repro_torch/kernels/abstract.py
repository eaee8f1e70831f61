"""The LM kernels' abstract forms: what a wrapper does with fake tensors.

The dry run (:mod:`repro_torch.launch.dryrun`) drives the model on fake
tensors (``torch._subclasses.fake_tensor``): shapes, dtypes and devices,
no values, no storage.  Such a tensor must not reach a kernel's
``data_ptr()`` or a host scan of ids, so the wrappers of kernels B8 and B9
(:mod:`repro_torch.kernels.ssd`, :mod:`repro_torch.kernels.gather`: the
forwards, the backwards, the shard and bf16 forms) send fake inputs down
the card's path whatever the fake device: its checks, plan, copies and
allocations (outputs and scratch, so that the dry run's peak counts
them), up to the launch function, which charges the work and returns
before it loads a kernel.  That branch is the abstract form; a real
tensor never takes it, so it is no fallback.

The abstract form charges :func:`charge` with the work the kernel does,
by the formulas the kernel table's bounds use
(:mod:`repro_torch.core.autotune`: ``ssd_flops``, ``gather_bytes`` ...),
so that the dry run and the bound share one formula.  :data:`CHARGE` is
None unless a dry run is recording.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

__all__ = ["CHARGE", "charge", "is_fake", "tracing"]

#: The dry run's recorder, ``CHARGE(name, device, flops, nbytes)``, or None.
CHARGE = None


def is_fake(*tensors) -> bool:
    """True when any of ``tensors`` (None entries skipped) is a fake
    tensor."""
    return any(isinstance(t, FakeTensor) for t in tensors)


def tracing() -> bool:
    """True while a fake-tensor mode is active: the dry run's counterpart of
    a JAX trace, where no value can be read back to the host."""
    return any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack())


def charge(name: str, device: torch.device, flops: int, nbytes: int) -> None:
    """Record one abstract launch of kernel ``name`` on ``device``: its
    operations and the bytes it must move (a no-op outside a dry run)."""
    if CHARGE is not None:
        CHARGE(name, device, int(flops), int(nbytes))
