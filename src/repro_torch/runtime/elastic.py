"""Elastic re-mesh planning: choose a new (pod, data, model) mesh after node
loss or growth (a stdlib copy of ``repro.runtime.elastic``; a plan's shape
and axes build the mesh through
:func:`repro_torch.launch.mesh.make_mesh_from_plan`).

Policy: preserve the model (TP) axis if the surviving device count allows —
params reshard along data only, which is cheap (pure replication change) —
else fall back to the largest valid TP that divides both the device count
and the model's head/ff dims.  The data axis absorbs the remainder; the
global batch keeps its size by raising grad-accumulation (per-device batch
must stay an integer).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    accum_steps: int
    global_batch: int
    note: str = ""

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def plan_mesh(
    n_devices: int,
    *,
    preferred_model: int = 16,
    model_divisors: tuple[int, ...] = (256, 128, 64, 32, 16, 8, 4, 2, 1),
    global_batch: int = 256,
    max_accum: int = 64,
) -> MeshPlan:
    """Largest usable mesh for ``n_devices``.

    Keeps every healthy device: if the surviving data-axis width does not
    divide the global batch under any accumulation factor, the plan adjusts
    the global batch to the nearest data-divisible value (elastic restarts
    routinely rescale batch; the LR schedule consumes the new batch size).
    """
    if n_devices < 1:
        raise ValueError("need at least one device")
    for model in (preferred_model,) + tuple(
        d for d in model_divisors if d != preferred_model
    ):
        if model > n_devices or n_devices % model:
            continue
        data = n_devices // model
        note = (
            f"model axis kept at {model}"
            if model == preferred_model
            else f"model axis downgraded to {model}"
        )
        # (a) keep the global batch if some accumulation factor divides it
        for accum in range(1, max_accum + 1):
            if global_batch % accum:
                continue
            if (global_batch // accum) % data == 0:
                return MeshPlan(
                    shape=(data, model), axis_names=("data", "model"),
                    accum_steps=accum, global_batch=global_batch, note=note,
                )
        # (b) adjust the batch to the nearest multiple of the data width
        adjusted = max(data, round(global_batch / data) * data)
        return MeshPlan(
            shape=(data, model), axis_names=("data", "model"),
            accum_steps=1, global_batch=adjusted,
            note=note + f"; global batch adjusted {global_batch} -> {adjusted}",
        )
    return MeshPlan(shape=(1, 1), axis_names=("data", "model"), accum_steps=1,
                    global_batch=global_batch, note="degenerate single-device mesh")
