"""Replay of the SpMV serving scenarios of ``tests/test_service.py`` on the
reference ``repro.service`` and the port's ``repro_torch.service``.

Both services see the same numpy-seeded operand and request vectors; the
reference runs in Pallas interpret mode, the port on the CPU
(``KernelRegistry(device="cpu")``).  Results agree at 1e-10, and the
frozen ``stats`` counters and launch counts agree exactly.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.core.autotune as autotune
from repro.service import KernelRegistry as RefRegistry
from repro.service import KernelService as RefService
from repro.service import QueueFull as RefQueueFull
from repro.service import service as ref_service_mod
from repro.service.tunecache import TuneCache as RefTuneCache
from repro.sparse import formats as RF
from repro_torch.analysis import LaunchPlanError
from repro_torch.core.sdv import tpu_v5e_machine
from repro_torch.kernels import sell_core
from repro_torch.kernels.ops import device_tag
from repro_torch.obs import Tracer
from repro_torch.service import (
    STATS_KEYS,
    KernelRegistry,
    KernelService,
    QueueFull,
    TuneCache,
)
from repro_torch.service import service as service_mod
from repro_torch.sparse import formats as F

TOL = 1e-10
N = 200


@pytest.fixture
def world():
    ref = RF.random_csr(N, N, 6.0, seed=0, skew=1.0)
    port = F.CSRMatrix(indptr=ref.indptr, indices=ref.indices, data=ref.data,
                       n_cols=ref.n_cols)
    return ref, port


def _services(world, n_slots=4, **kw):
    ref, port = world
    ref_reg = RefRegistry()
    ref_reg.register_matrix("mat", ref)
    reg = KernelRegistry(device="cpu")
    reg.register_matrix("mat", port)
    return RefService(ref_reg, n_slots=n_slots, **kw), \
        KernelService(reg, n_slots=n_slots, **kw)


def _xs(n, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(N) for _ in range(n)]


def _result(svc, rid):
    y = svc.poll(rid)
    return y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def _replay(world, payloads, n_slots=4, **kw):
    """Submit the same payloads to both services, drain, return both."""
    ref_svc, svc = _services(world, n_slots=n_slots, **kw)
    rids = []
    for p in payloads:
        rids.append((ref_svc.submit("spmv", "mat", p),
                     svc.submit("spmv", "mat", p)))
    ref_svc.drain()
    svc.drain()
    return ref_svc, svc, rids


# ---------------------------------------------------------------------------
# Copied contracts
# ---------------------------------------------------------------------------


def test_stats_keys_and_pow2_pad_match_reference():
    assert STATS_KEYS == ref_service_mod.STATS_KEYS
    for n in range(1, 40):
        items = list(range(n))
        assert service_mod._pow2_pad(items) == ref_service_mod._pow2_pad(items)
    assert service_mod.OPS == ("spmv",)


# ---------------------------------------------------------------------------
# Scenario replay
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_req,n_slots", [(1, 4), (5, 8), (7, 2), (32, 32)])
def test_results_stats_and_launches_match_reference(world, n_req, n_slots):
    xs = _xs(n_req)
    ref_svc, svc, rids = _replay(world, xs, n_slots=n_slots)
    _, port = world
    for (r_ref, r_port), x in zip(rids, xs):
        got = _result(svc, r_port)
        np.testing.assert_allclose(got, _result(ref_svc, r_ref),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got, port.matvec(x), rtol=TOL, atol=TOL)
    assert dict(svc.stats) == dict(ref_svc.stats)
    assert svc.registry.get("mat").launches == \
        ref_svc.registry.get("mat").launches
    assert len(svc.completed) == len(ref_svc.completed) == n_req


def test_five_requests_are_one_spmm_call(world, monkeypatch):
    calls = {"n": 0}
    real = sell_core.spmm_sell

    def counting(*args, **kwargs):
        calls["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(sell_core, "spmm_sell", counting)
    ref_svc, svc, _ = _replay(world, _xs(5), n_slots=8)
    assert calls["n"] == 1
    assert svc.stats["launches"] == ref_svc.stats["launches"] == 1
    assert svc.stats["max_group"] == 5 and svc.stats["coalesced"] == 5


@pytest.mark.parametrize("bad", [None, "short"], ids=["none", "wrong-size"])
def test_bad_payload_fails_alone(world, bad):
    x = _xs(1)[0]
    payload = np.ones(N - 7) if bad == "short" else None
    ref_svc, svc, ((rb_ref, rb), (rg_ref, rg)) = _replay(world, [payload, x])
    for service, rid in ((ref_svc, rb_ref), (svc, rb)):
        with pytest.raises(RuntimeError, match="failed"):
            service.poll(rid)
    if bad == "short":
        with pytest.raises(RuntimeError, match="must have shape"):
            svc.poll(rb)
    np.testing.assert_allclose(_result(svc, rg), world[1].matvec(x),
                               rtol=TOL, atol=TOL)
    assert dict(svc.stats) == dict(ref_svc.stats)
    assert svc.stats["failed"] == 1 and svc.stats["served"] == 1


def test_bounded_queue_rejects_like_the_reference(world):
    ref_svc, svc = _services(world, n_slots=2, max_queue=3)
    xs = _xs(3)
    rids = {}
    for name, service, exc in (("ref", ref_svc, RefQueueFull),
                               ("port", svc, QueueFull)):
        rids[name] = [service.submit("spmv", "mat", x) for x in xs]
        with pytest.raises(exc, match="admission queue is full"):
            service.submit("spmv", "mat", xs[0])
        service.step()
        rids[name].append(service.submit("spmv", "mat", xs[0]))
        service.drain()
    assert dict(svc.stats) == dict(ref_svc.stats)
    assert svc.stats["rejected"] == 1 and svc.stats["served"] == 4
    for rid, x in zip(rids["port"], xs + [xs[0]]):
        np.testing.assert_allclose(_result(svc, rid), world[1].matvec(x),
                                   rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="max_queue must be >= 1"):
        KernelService(svc.registry, n_slots=2, max_queue=0)


def test_preflight_rejects_a_drifted_tune_at_admission(world):
    """A tune that drifts out of the kernel's envelope after registration
    is refused at submit, before anything is queued or launched."""
    ref_svc, svc = _services(world)
    for service in (ref_svc, svc):
        record = service.registry.get("mat")
        good = record.tuned
        record.tuned = dataclasses.replace(good, k_block=1 << 24)
        with pytest.raises(Exception, match="preflight failed"):
            service.submit("spmv", "mat", np.ones(N))
        record.tuned = good
        rid = service.submit("spmv", "mat", np.ones(N))
        service.drain()
        assert service.poll(rid) is not None
    with pytest.raises(LaunchPlanError):
        record = svc.registry.get("mat")
        record.tuned = dataclasses.replace(record.tuned, k_block=64)
        svc.submit("spmv", "mat", np.ones(N))
    assert dict(svc.stats)["preflight_rejected"] == 2
    assert ref_svc.stats["preflight_rejected"] == 1
    assert svc.stats["launches"] == ref_svc.stats["launches"] == 1


def test_submit_errors_travel_to_the_caller(world):
    _, svc = _services(world)
    with pytest.raises(ValueError, match="unknown op"):
        svc.submit("bfs", "mat", None)
    with pytest.raises(KeyError, match="not registered"):
        svc.submit("spmv", "nope", None)
    with pytest.raises(TypeError, match="ExecSpec"):
        svc.submit("spmv", "mat", np.ones(N), spec="fast")


def test_release_and_latency_percentiles(world):
    _, svc = _services(world, n_slots=2)
    rid = svc.submit("spmv", "mat", np.ones(N))
    assert svc.step() and svc.poll(rid) is not None
    svc.release(rid)
    svc.step()
    assert svc.completed == [] and svc.stats["served"] == 1
    assert set(svc.latency_percentiles()) == {"p50_us", "p95_us", "p99_us"}
    assert svc.latency_percentiles()["p50_us"] > 0


def test_every_submit_closes_one_root_span(world):
    ref, port = world
    reg = KernelRegistry(device="cpu")
    reg.register_matrix("mat", port)
    tracer = Tracer()
    svc = KernelService(reg, n_slots=2, max_queue=1, tracer=tracer)
    attempts = 0
    for payload in (np.ones(N), np.ones(N), None):
        attempts += 1
        try:
            svc.submit("spmv", "mat", payload)
        except QueueFull:
            svc.drain()
    svc.drain()
    assert len(tracer.closed_roots("request")) == attempts
    assert tracer.open_count == 0
    assert svc.plans()["mat"]["spmv"]["kernel"] == "spmm_sell"


# ---------------------------------------------------------------------------
# Registry: tune state carried across from the reference
# ---------------------------------------------------------------------------


def test_reference_written_tune_cache_serves_the_port(world, tmp_path,
                                                      monkeypatch):
    """A cache file the JAX registry wrote answers the port's registration
    with zero measurements and the identical layout."""
    ref, port = world
    path = str(tmp_path / "tunes.json")
    ref_cache = RefTuneCache(path)
    ref_reg = RefRegistry(cache=ref_cache)
    ref_op = ref_reg.register_matrix("mat", ref)
    ref_cache.save()

    calls = {"n": 0}
    real = autotune.measured_pad_factor

    def counting(*args, **kwargs):
        calls["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(autotune, "measured_pad_factor", counting)
    reg = KernelRegistry(cache=TuneCache(path), machine=tpu_v5e_machine(),
                         device="cpu")
    op = reg.register_matrix("mat", port)
    assert calls["n"] == 0 and op.tune_was_cached
    t, rt = op.tuned, ref_op.tuned
    assert (t.c, t.sigma, t.w_block, t.k_block) == \
        (rt.c, rt.sigma, rt.w_block, rt.k_block)
    for a, b in zip(op.slabs.bucket_cols, ref_op.slabs.bucket_cols):
        assert a.tobytes() == b.tobytes()
    svc = KernelService(reg)
    x = _xs(1)[0]
    rid = svc.submit("spmv", "mat", x)
    svc.drain()
    np.testing.assert_allclose(_result(svc, rid), port.matvec(x),
                               rtol=TOL, atol=TOL)


def test_registry_rejects_a_poisoned_cached_tune(world):
    _, port = world
    reg = KernelRegistry(device="cpu")
    key = reg.cache.sell_key("spmv", port, device=device_tag("cpu"),
                             dtype="float64", machine=reg.machine)
    reg.cache.put_sell(key, autotune.SellTuneResult(
        c=32, sigma=64, w_block=8, cycles=1.0, pad_factor=1.0,
        table=((32, 64, 1.0, 1.0),), k_block=64))
    with pytest.raises(LaunchPlanError, match="register budget"):
        reg.register_matrix("poisoned", port)
    assert "poisoned" not in reg


def test_registry_keeps_operands_on_its_device(world):
    _, port = world
    reg = KernelRegistry(device="cpu")
    op = reg.register_matrix("mat", port)
    assert reg.device == torch.device("cpu")
    assert all(t.device.type == "cpu" for ts in op.device_arrays.values()
               for t in ts)
    assert op.plans["spmv"].ok and op.slab_meta.idx_max < port.n_cols
    assert reg.summary()["operands"]["mat"]["kind"] == "matrix"
    with pytest.raises(KeyError, match="not registered"):
        reg.get("missing")


def test_default_registry_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        KernelRegistry()


# ---------------------------------------------------------------------------
# Package boundary
# ---------------------------------------------------------------------------


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import sys, importlib, pkgutil\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env = {**os.environ, "PYTHONPATH": src}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
