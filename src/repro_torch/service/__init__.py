"""Sparse-kernel serving subsystem of the port: registry -> tune cache ->
request engine, on one device."""
from repro_torch.service.registry import KernelRegistry, RegisteredOperand
from repro_torch.service.service import (
    STATS_KEYS,
    KernelRequest,
    KernelService,
    QueueFull,
    SubmitRequest,
)
from repro_torch.service.tunecache import (
    OperandSignature,
    SchemaVersionError,
    TuneCache,
    operand_signature,
)

__all__ = [
    "KernelRegistry",
    "KernelRequest",
    "KernelService",
    "OperandSignature",
    "QueueFull",
    "RegisteredOperand",
    "STATS_KEYS",
    "SchemaVersionError",
    "SubmitRequest",
    "TuneCache",
    "operand_signature",
]
