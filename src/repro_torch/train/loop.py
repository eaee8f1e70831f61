"""Training loop with checkpoint/restart, straggler monitoring and exact
data resume — port of ``repro.train.loop``, the single-process core that
:mod:`repro_torch.launch.train` wraps.

Fault-tolerance contract (``tests/test_torch_checkpoint.py``):

* checkpoint every ``ckpt_every`` steps (async, atomic);
* on (re)start, restore the latest checkpoint if one exists and continue
  from its step with the identical data stream (the batch is a pure
  function of the step);
* per-step wall times feed the :class:`~repro_torch.runtime.StepMonitor`;
  stragglers are logged and counted.

The state runs on ``device`` (``None``: the card, raising without one;
the CPU only when asked), or on ``mesh`` (a ``(data, model)`` or ``(pod,
data, model)`` :class:`~repro_torch.compat.Mesh`, one process driving
every device): there the state is born sharded (the parameters drawn and
placed block by block, no device ever holding the whole model; the
moments by ZeRO-1, :func:`repro_torch.launch.specs.state_shardings`), each
batch is split over the data replicas with its labels on their leads
(:func:`~repro_torch.models.sharding.place_batch`), and a restore places
the checkpoint's arrays by the state's specs.  Checkpoints keep the
reference's on-disk format whatever the placement (every placed leaf
gathered to the host whole), so a checkpoint written on a mesh restores
on one device and the other way round.  A step's wall time is read with
the port's :class:`~repro_torch.obs.Stopwatch` after every device of the
mesh (or the one device) is synchronized, so it covers the step's
completion and not only its launches.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, latest_step, restore_checkpoint
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels.execspec import resolve_device
from repro_torch.models import model as M
from repro_torch.models import sharding as shrd
from repro_torch.models.config import ModelConfig
from repro_torch.obs import Stopwatch
from repro_torch.runtime.heartbeat import StepMonitor
from repro_torch.train.step import TrainConfig, TrainState, init_train_state, make_train_step

__all__ = ["TrainLoopConfig", "train_loop"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str | None = None
    log_every: int = 10
    seed: int = 0


def _state_tree(state: TrainState) -> dict:
    """The checkpointed tree of a state: ``params`` (name -> tensor),
    ``opt`` (``m``, ``v``, ``step`` and any ``master``), ``comp`` (the
    compression residuals, or None) and ``step``."""
    params = state.params
    return {"params": dict(params.items() if isinstance(params, shrd.PlacedParams)
                           else params.named_parameters()),
            "opt": state.opt,
            "comp": None if state.comp is None else {"error": state.comp.error},
            "step": state.step}


@torch.no_grad()
def _load(state: TrainState, restored: dict) -> TrainState:
    """Copy a restored tree (numpy leaves) into the state's tensors."""
    live = _state_tree(state)

    def fill(dst, src):
        for k, v in dst.items():
            if isinstance(v, dict):
                fill(v, src[k])
            elif isinstance(v, torch.Tensor):
                v.copy_(torch.from_numpy(np.asarray(src[k])))
            elif isinstance(v, shrd.Sharded):     # placed by its spec
                arr = torch.from_numpy(np.asarray(src[k]))
                for coord in np.ndindex(v.pieces.shape):
                    v.pieces[coord].copy_(arr[v.region(coord)])
    fill({k: live[k] for k in ("params", "opt", "comp") if live[k] is not None},
         restored)
    state.opt["step"] = int(restored["opt"]["step"])
    return state._replace(step=int(restored["step"]))


def _sync(devices) -> None:
    """Wait for every CUDA device among ``devices``."""
    for dev in {torch.device(d) for d in devices}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def train_loop(cfg: ModelConfig, tcfg: TrainConfig, dcfg: DataConfig,
               lcfg: TrainLoopConfig, log: Callable[[str], None] = print,
               fail_at_step: int | None = None, mesh=None, device=None
               ) -> tuple[TrainState, list[dict]]:
    """Run (or resume) training on ``device`` or on ``mesh`` (a Mesh or
    MeshContext, or the ambient :func:`~repro_torch.compat.use_mesh`
    scope), the parameters drawn from ``lcfg.seed`` (on a mesh, on its
    first device).  ``fail_at_step`` injects a crash for the
    fault-tolerance tests.  Returns (final state, metric history of
    ``{loss, aux, grad_norm, lr, step, wall_s}``)."""
    mesh = M.resolve_mesh(mesh)
    if mesh is None:
        dev = resolve_device(device)
        devices = [dev]
    else:
        dev = mesh.devices.flat[0]
        devices = list(mesh.devices.flat)
    state = init_train_state(M.make_generator(lcfg.seed, dev), cfg, tcfg,
                             mesh=mesh)
    start_step = 0
    manager = CheckpointManager(lcfg.ckpt_dir) if lcfg.ckpt_dir else None
    if lcfg.ckpt_dir and latest_step(lcfg.ckpt_dir) is not None:
        restored, _, step = restore_checkpoint(lcfg.ckpt_dir, _state_tree(state))
        state = _load(state, restored)
        start_step = step
        log(f"[resume] restored checkpoint at step {step}")

    step_fn = make_train_step(cfg, tcfg)
    data = SyntheticLM(dcfg)
    monitor = StepMonitor()
    history: list[dict] = []
    for step in range(start_step, lcfg.total_steps):
        if fail_at_step is not None and step == fail_at_step:
            if manager:
                manager.wait()
            raise RuntimeError(f"injected failure at step {step}")
        tokens, labels = data.batch_for(step)
        if mesh is None:
            batch = {"tokens": tokens, "labels": torch.from_numpy(labels).to(dev)}
        else:
            batch = shrd.place_batch({"tokens": tokens, "labels": labels}, mesh)
        with Stopwatch() as sw:
            state, metrics = step_fn(state, batch)
            _sync(devices)
            metrics = {k: float(v) for k, v in metrics.items()}
        dt = sw.elapsed_s
        monitor.record(step, dt)
        metrics["step"] = step
        metrics["wall_s"] = dt
        history.append(metrics)
        if step % lcfg.log_every == 0:
            log(f"[train] step {step} loss {metrics['loss']:.4f} "
                f"gnorm {metrics['grad_norm']:.3f} {dt * 1e3:.0f} ms")
        if manager and (step + 1) % lcfg.ckpt_every == 0:
            manager.save_async(step + 1, _state_tree(state),
                               extra={"data": {"step": step + 1}})
    if manager:
        manager.wait()
    if monitor.straggler_events:
        log(f"[monitor] {len(monitor.straggler_events)} straggler step(s) flagged")
    return state, history
