"""Fault tolerance of the port's training path (``repro_torch.checkpoint``,
``repro_torch.runtime``, ``repro_torch.train.loop``): the reference's
``tests/test_fault_tolerance.py`` cases run on the port — checkpoint
integrity, crash/restart resume, restart supervision, straggler detection,
elastic re-mesh planning — plus the on-disk format shared with the
reference: a flat tree written by either package restores in the other.
Everything runs on the CPU; the resume bound is the reference's 1e-6.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.checkpoint import restore_checkpoint as ref_restore
from repro.checkpoint import save_checkpoint as ref_save
from repro.runtime import plan_mesh as ref_plan_mesh
from repro_torch import configs
from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.data import DataConfig
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import StepMonitor, plan_mesh, run_with_restarts
from repro_torch.runtime.supervisor import RestartBudgetExceeded
from repro_torch.train import TrainConfig, TrainLoopConfig, train_loop

RNG = np.random.default_rng(5)


def _tree():
    return {
        "params": {"w": torch.from_numpy(RNG.standard_normal((8, 4)).astype(np.float32))},
        "opt": {"m": torch.zeros((8, 4)), "step": torch.tensor(3, dtype=torch.int32)},
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield np.asarray(tree)


def test_checkpoint_roundtrip_exact(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 7, tree, extra={"data": {"step": 7}})
    got, extra, step = restore_checkpoint(str(tmp_path), tree)
    assert step == 7 and extra == {"data": {"step": 7}}
    for a, b in zip(_leaves(got), _leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert got["opt"]["step"].dtype == np.int32


def test_checkpoint_latest_selection(tmp_path):
    tree = _tree()
    for s in (5, 20, 10):
        save_checkpoint(str(tmp_path), s, tree)
    assert latest_step(str(tmp_path)) == 20
    assert sorted(os.listdir(tmp_path)) == [f"step_{s:010d}" for s in (5, 10, 20)]
    _, _, step = restore_checkpoint(str(tmp_path), tree)
    assert step == 20
    assert latest_step(str(tmp_path / "none")) is None


def test_checkpoint_detects_corruption(tmp_path):
    tree = _tree()
    path = save_checkpoint(str(tmp_path), 1, tree)
    arrs = os.path.join(path, "arrays.npz")
    blob = bytearray(open(arrs, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(arrs, "wb").write(bytes(blob))
    with pytest.raises(Exception):
        restore_checkpoint(str(tmp_path), tree)


def test_checkpoint_manager_async_and_gc(tmp_path):
    """Four async saves keep the last two; each is a snapshot taken when
    it was asked for, whatever the tensors hold later."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    snaps = []
    for s in (1, 2, 3, 4):
        mgr.save_async(s, tree)
        snaps.append(tree["params"]["w"].clone())
        tree["params"]["w"].add_(1.0)                 # an in-place update
    mgr.wait()
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)
                   if n.startswith("step_"))
    assert steps == [3, 4]
    got, _, _ = restore_checkpoint(str(tmp_path), tree, step=3)
    np.testing.assert_array_equal(got["params"]["w"], snaps[2].numpy())


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_flat_tree_restores_in_the_other_package(tmp_path, writer):
    """The on-disk format is the reference's: ``step_%010d``, one
    ``arrays.npz``, ``manifest.json`` with shape, dtype and crc32 a leaf."""
    flat = {"tok_embed": RNG.standard_normal((6, 4)).astype(np.float32),
            "blocks": {"ln1": RNG.standard_normal((2, 4)).astype(np.float32)},
            "step": np.asarray(9, np.int32)}
    if writer == "reference":
        ref_save(str(tmp_path), 9, {k: (jnp.asarray(v) if not isinstance(v, dict)
                                       else {kk: jnp.asarray(vv) for kk, vv in v.items()})
                                   for k, v in flat.items()}, extra={"x": 1})
        got, extra, step = restore_checkpoint(str(tmp_path), flat)
    else:
        save_checkpoint(str(tmp_path), 9, {k: (torch.from_numpy(v) if not isinstance(v, dict)
                                               else {kk: torch.from_numpy(vv)
                                                     for kk, vv in v.items()})
                                           for k, v in flat.items()}, extra={"x": 1})
        got, extra, step = ref_restore(str(tmp_path), flat)
    assert step == 9 and extra == {"x": 1}
    assert os.path.isdir(tmp_path / "step_0000000009")
    for a, b in zip(_leaves(got), _leaves(flat)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


# ---------------------------------------------------------------------------
# Crash / restart end-to-end
# ---------------------------------------------------------------------------


def _loop_cfgs(tmp_path, total=12):
    cfg = configs.reduced_config("qwen2-1.5b")
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3), remat=None)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    lcfg = TrainLoopConfig(total_steps=total, ckpt_every=4,
                           ckpt_dir=str(tmp_path), log_every=100)
    return cfg, tcfg, dcfg, lcfg


def test_crash_restart_resumes_identically(tmp_path):
    """Crash at step 9, restart from the step-8 checkpoint, and the final
    state equals an uninterrupted run's (checkpoint + deterministic data)."""
    quiet = lambda s: None  # noqa: E731
    ref_state, _ = train_loop(*_loop_cfgs(tmp_path / "a"), log=quiet, device="cpu")
    cfgs = _loop_cfgs(tmp_path / "b")
    with pytest.raises(RuntimeError, match="injected failure"):
        train_loop(*cfgs, log=quiet, fail_at_step=9, device="cpu")
    assert latest_step(str(tmp_path / "b")) == 8
    logs = []
    resumed, hist = train_loop(*cfgs, log=logs.append, device="cpu")
    assert logs[0] == "[resume] restored checkpoint at step 8"
    assert [h["step"] for h in hist] == [8, 9, 10, 11]
    assert resumed.step == ref_state.step == 12
    assert resumed.opt["step"] == 12
    worst = max(float((a - b).detach().abs().max()) for a, b in
                zip(ref_state.params.parameters(), resumed.params.parameters()))
    assert worst < 1e-6, f"resume diverged by {worst}"


def test_supervisor_restarts_until_success(tmp_path):
    cfgs = _loop_cfgs(tmp_path, total=8)
    quiet = lambda s: None  # noqa: E731
    attempts = {"n": 0}

    def job():
        attempts["n"] += 1
        fail = 6 if attempts["n"] == 1 else None
        return train_loop(*cfgs, log=quiet, fail_at_step=fail, device="cpu")

    (state, hist), restarts = run_with_restarts(job, max_restarts=2)
    assert restarts == 1
    assert state.step == 8


def test_supervisor_gives_up():
    def job():
        raise RuntimeError("always broken")

    with pytest.raises(RestartBudgetExceeded):
        run_with_restarts(job, max_restarts=2)


def test_loop_refuses_a_mesh(tmp_path):
    """The loop trains every family it makes batches for on a mesh
    (``tests/test_torch_mesh_train.py``, ``tests/test_torch_mesh_families.py``);
    it refuses a mesh with an axis the model does not run on.  The hybrid
    family, refused on a mesh until ROADMAP A10c's port, trains there and
    checkpoints: a (1, 2) run's checkpoint restores on one device, equal."""
    from repro_torch.compat import make_mesh

    with pytest.raises(ValueError, match="the mesh has"):
        train_loop(*_loop_cfgs("unused"), device="cpu",
                   mesh=make_mesh((1, 2), ("shard", "model"), ("cpu",) * 2))
    _, tcfg, dcfg, lcfg = _loop_cfgs(tmp_path, total=4)
    cfg = configs.reduced_config("hymba-1.5b")
    quiet = lambda s: None  # noqa: E731
    on_mesh, hist = train_loop(cfg, tcfg, dcfg, lcfg, log=quiet,
                               mesh=make_mesh((1, 2), ("data", "model"),
                                              ("cpu",) * 2))
    assert [h["step"] for h in hist] == [0, 1, 2, 3]
    one, hist = train_loop(cfg, tcfg, dcfg, lcfg, log=quiet, device="cpu")
    assert hist == [] and one.step == 4
    for k, p in one.params.named_parameters():
        assert torch.equal(p.detach(), on_mesh.params[k].full()), k


# ---------------------------------------------------------------------------
# Straggler detection, elastic re-mesh
# ---------------------------------------------------------------------------


def test_straggler_detection():
    mon = StepMonitor(threshold=3.0, warmup=2)
    for step in range(20):
        mon.record(step, 0.1)
    ev = mon.record(20, 0.9)
    assert ev is not None and ev.slowdown == pytest.approx(9.0, rel=0.01)
    assert len(mon.straggler_events) == 1
    assert mon.record(21, 0.1) is None


def test_straggler_warmup_excluded():
    mon = StepMonitor(threshold=3.0, warmup=3)
    assert mon.record(0, 60.0) is None
    assert mon.record(1, 50.0) is None


@pytest.mark.parametrize("n,model,batch", [(256, 16, 256), (240, 16, 256),
                                           (24, 16, 256), (1024, 16, 256),
                                           (7, 4, 100)])
def test_plan_mesh_equals_reference(n, model, batch):
    got = plan_mesh(n, preferred_model=model, global_batch=batch)
    want = ref_plan_mesh(n, preferred_model=model, global_batch=batch)
    assert (got.shape, got.axis_names, got.accum_steps, got.global_batch,
            got.note) == (want.shape, want.axis_names, want.accum_steps,
                          want.global_batch, want.note)
    assert got.n_devices == n or got.shape == (1, 1)


def test_plan_mesh_cases():
    assert plan_mesh(256, preferred_model=16, global_batch=256).shape == (16, 16)
    plan = plan_mesh(240, preferred_model=16, global_batch=256)
    assert plan.shape[1] == 16 and plan.shape[0] * plan.shape[1] == 240
    assert (plan.global_batch // plan.accum_steps) % plan.shape[0] == 0
    plan = plan_mesh(24, preferred_model=16, global_batch=256)
    assert plan.n_devices == 24 and plan.shape[1] in (8, 4, 2, 1)
    with pytest.raises(ValueError):
        plan_mesh(0)
