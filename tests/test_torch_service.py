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
from repro.graphs import gen as RG
from repro.service.tunecache import TuneCache as RefTuneCache
from repro.service.tunecache import operand_signature as ref_signature
from repro.sparse import formats as RF
from repro_torch.analysis import LaunchPlanError
from repro_torch.core.sdv import tpu_v5e_machine
from repro_torch.graphs import gen as G
from repro_torch.kernels import bfs as bfs_k
from repro_torch.kernels import pagerank as pr_k
from repro_torch.kernels import sell_core
from repro_torch.kernels.ops import device_tag
from repro_torch.obs import Tracer
from repro_torch.service import (
    STATS_KEYS,
    KernelRegistry,
    KernelService,
    QueueFull,
    TuneCache,
    operand_signature,
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
    assert service_mod.OPS == ref_service_mod.OPS
    assert service_mod.OP_CLASS == ref_service_mod.OP_CLASS


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
        svc.submit("spmm_dense", "mat", None)
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
# Graph operands: BFS and PageRank traffic
# ---------------------------------------------------------------------------

N_NODES = 263                   # prime: no slice or block divides it


@pytest.fixture
def graphs():
    ref = RG.rmat_graph(N_NODES, 8, seed=21)
    return ref, G.EllpackGraph(adj=ref.adj, n_nodes=ref.n_nodes)


def _graph_services(graphs, n_slots=4, **kw):
    ref, port = graphs
    ref_reg = RefRegistry()
    ref_reg.register_graph("g", ref)
    reg = KernelRegistry(device="cpu", machine=tpu_v5e_machine())
    reg.register_graph("g", port)
    return RefService(ref_reg, n_slots=n_slots, **kw), \
        KernelService(reg, n_slots=n_slots, **kw)


def _graph_replay(graphs, reqs, n_slots=4):
    """Submit the same (op, params) requests to both services, drain."""
    ref_svc, svc = _graph_services(graphs, n_slots=n_slots)
    rids = [(ref_svc.submit(op, "g", None, **params),
             svc.submit(op, "g", None, **params)) for op, params in reqs]
    ref_svc.drain()
    svc.drain()
    return ref_svc, svc, rids


def test_register_graph_tune_key_and_layout_match_reference(graphs, tmp_path,
                                                           monkeypatch):
    """The graph tune key reads the same in both packages, so a cache file
    the JAX registry wrote answers the port's registration with zero
    measurements and the identical reverse-graph slabs."""
    ref, port = graphs
    assert operand_signature(port).key == ref_signature(ref).key
    rslabs = RG.graph_to_sell_slabs(ref.transpose(), c=8)
    pslabs = G.graph_to_sell_slabs(port.transpose(), c=8)
    assert operand_signature(pslabs).key == ref_signature(rslabs).key
    machine = tpu_v5e_machine()
    assert TuneCache.sell_key("graph", port, device="cpu", machine=machine) \
        == RefTuneCache.sell_key("graph", ref, device="cpu", machine=machine)

    path = str(tmp_path / "tunes.json")
    ref_cache = RefTuneCache(path)
    ref_op = RefRegistry(cache=ref_cache).register_graph("g", ref)
    ref_cache.save()
    calls = {"n": 0}
    real = autotune.measured_pad_factor

    def counting(*args, **kwargs):
        calls["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(autotune, "measured_pad_factor", counting)
    reg = KernelRegistry(cache=TuneCache(path), machine=machine, device="cpu")
    op = reg.register_graph("g", port)
    assert calls["n"] == 0 and op.tune_was_cached
    assert (op.tuned.c, op.tuned.sigma) == (ref_op.tuned.c, ref_op.tuned.sigma)
    for a, b in zip(op.slabs.bucket_adj + op.slabs.bucket_nodes,
                    ref_op.slabs.bucket_adj + ref_op.slabs.bucket_nodes):
        assert a.tobytes() == b.tobytes()
    assert op.kind == "graph" and op.n == N_NODES
    assert op.plans["bfs"].ok and op.plans["pagerank"].ok
    assert op.slab_meta.idx_max < N_NODES
    arrs = op.device_arrays
    assert all(a.transpose(1, 2).is_contiguous() for a in arrs["adj"])
    assert arrs["out_degree"].dtype == torch.float64


@pytest.mark.parametrize("n_req,n_slots", [(1, 4), (5, 8), (7, 2)])
def test_graph_results_stats_and_launches_match_reference(graphs, n_req,
                                                          n_slots):
    ref, port = graphs
    rng = np.random.default_rng(n_req)
    reqs = [("bfs", {"source": int(s)})
            for s in rng.integers(0, N_NODES, n_req)]
    reqs += [("pagerank", {"damping": d, "iters": it}) for d, it in
             zip([0.85, 0.9, 0.8, 0.95] * 2, [5, 3, 4, 6, 2, 5, 1])][:n_req]
    ref_svc, svc, rids = _graph_replay(graphs, reqs, n_slots=n_slots)
    for (op, params), (r_ref, r_port) in zip(reqs, rids):
        got, want = _result(svc, r_port), _result(ref_svc, r_ref)
        assert got.shape == (N_NODES,)
        if op == "bfs":
            assert got.dtype == np.int32 and np.array_equal(got, want)
            assert np.array_equal(got, G.bfs_reference(port, params["source"]))
        else:
            np.testing.assert_allclose(got, want, rtol=TOL, atol=0)
            np.testing.assert_allclose(
                got, G.pagerank_reference(port, params["damping"],
                                          params["iters"]), rtol=TOL)
    assert dict(svc.stats) == dict(ref_svc.stats)
    assert svc.registry.get("g").launches == ref_svc.registry.get("g").launches


def test_graph_groups_are_one_drive_each(graphs, monkeypatch):
    calls = {"bfs": 0, "pagerank": 0}
    real_b, real_p = bfs_k.bfs_sell, pr_k.pagerank_sell

    def bfs_counting(*args, **kwargs):
        calls["bfs"] += 1
        return real_b(*args, **kwargs)

    def pr_counting(*args, **kwargs):
        calls["pagerank"] += 1
        return real_p(*args, **kwargs)

    monkeypatch.setattr(bfs_k, "bfs_sell", bfs_counting)
    monkeypatch.setattr(pr_k, "pagerank_sell", pr_counting)
    reqs = [("bfs", {"source": s}) for s in (0, 9, 77, 100, 262)]
    reqs += [("pagerank", {"damping": 0.85, "iters": it}) for it in (4, 2, 3)]
    ref_svc, svc, _ = _graph_replay(graphs, reqs, n_slots=8)
    assert calls == {"bfs": 1, "pagerank": 1}
    assert svc.stats["launches"] == ref_svc.stats["launches"] == 2
    assert svc.stats["max_group"] == 5 and svc.stats["coalesced"] == 8
    plans = svc.plans()["g"]
    assert plans["bfs"]["kernel"] == "bfs_sell" and plans["bfs"]["ok"]
    assert plans["pagerank"]["kernel"] == "pagerank_sell"


@pytest.mark.parametrize("bad", [N_NODES, -1, "x"], ids=["n", "neg", "nan"])
def test_bad_source_fails_alone(graphs, bad):
    _, port = graphs
    reqs = [("bfs", {"source": bad}), ("bfs", {"source": 3}),
            ("bfs", {"source": 50})]
    ref_svc, svc, rids = _graph_replay(graphs, reqs)
    for service, rid in ((ref_svc, rids[0][0]), (svc, rids[0][1])):
        with pytest.raises(RuntimeError, match="failed"):
            service.poll(rid)
    for (_, params), (_, rid) in zip(reqs[1:], rids[1:]):
        assert np.array_equal(_result(svc, rid),
                              G.bfs_reference(port, params["source"]))
    assert dict(svc.stats) == dict(ref_svc.stats)
    assert svc.stats["failed"] == 1 and svc.stats["served"] == 2
    with pytest.raises(RuntimeError, match="not a graph"):
        ref_svc2, svc2 = _services((RF.random_csr(20, 20, 3.0, seed=0),
                                    F.random_csr(20, 20, 3.0, seed=0)))
        rid = svc2.submit("bfs", "mat", None, source=0)
        svc2.drain()
        svc2.poll(rid)


def test_registry_refuses_a_graph_with_out_of_range_ids(graphs):
    _, port = graphs
    adj = port.adj.copy()
    adj[7, 0] = N_NODES + 3
    reg = KernelRegistry(device="cpu")
    with pytest.raises(LaunchPlanError, match="out of bounds"):
        reg.register_graph("bad", G.EllpackGraph(adj=adj, n_nodes=N_NODES))
    assert "bad" not in reg


# ---------------------------------------------------------------------------
# Package boundary
# ---------------------------------------------------------------------------


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import sys, importlib, pkgutil\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "for m in ('repro_torch.graphs.gen', 'repro_torch.kernels.bfs',\n"
        "          'repro_torch.kernels.pagerank', 'repro_torch.kernels.fft',\n"
        "          'repro_torch.kernels.spmv', 'repro_torch.optim.adamw',\n"
        "          'repro_torch.data.pipeline', 'repro_torch.checkpoint.store',\n"
        "          'repro_torch.runtime.supervisor', 'repro_torch.train.loop',\n"
        "          'repro_torch.launch.train', 'repro_torch.compat.meshctx',\n"
        "          'repro_torch.launch.mesh', 'repro_torch.launch.specs',\n"
        "          'repro_torch.models.sharding'):\n"
        "    assert m in sys.modules, m\n"
        "print('ok', len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    root = os.path.dirname(os.path.dirname(__file__))
    src = os.path.join(root, "src")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([src, root])}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_names_neither_jax_nor_the_reference():
    """``chip_smoke.py`` imports its kernels inside ``main``; every import
    statement in it, at any depth, stays clear of jax and ``repro``."""
    import ast

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "chip_smoke.py")
    tree = ast.parse(open(path).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "repro_torch.kernels" in names
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


# ---------------------------------------------------------------------------
# FFT plans: the fft op (kernel B7)
# ---------------------------------------------------------------------------

FFT_N = 128


def _fft_services(n_slots=8):
    """Both packages' services with one FFT plan of length FFT_N, the
    SpMV operand of ``world`` and the graph of ``graphs`` registered."""
    ref_reg = RefRegistry()
    reg = KernelRegistry(device="cpu", machine=tpu_v5e_machine())
    ref_csr = RF.random_csr(N, N, 6.0, seed=0, skew=1.0)
    ref_g = RG.rmat_graph(N_NODES, 8, seed=21)
    for r, csr, g in ((ref_reg, ref_csr, ref_g),
                      (reg, F.CSRMatrix(indptr=ref_csr.indptr,
                                        indices=ref_csr.indices,
                                        data=ref_csr.data, n_cols=N),
                       G.EllpackGraph(adj=ref_g.adj, n_nodes=N_NODES))):
        r.register_fft("fft", FFT_N)
        r.register_matrix("mat", csr)
        r.register_graph("g", g)
    return RefService(ref_reg, n_slots=n_slots), \
        KernelService(reg, n_slots=n_slots)


def _spectrum(svc, rid):
    return [p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
            for p in svc.poll(rid)]


def test_register_fft_mirrors_the_reference():
    ref_reg, reg = RefRegistry(), KernelRegistry(device="cpu")
    ref_op, op = ref_reg.register_fft("f", 256), reg.register_fft("f", 256)
    assert op.kind == ref_op.kind == "fft" and op.n == 256
    for name in ("wre", "wim"):
        got = op.device_arrays[name]
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(ref_op.device_arrays[name]))
    assert op.plans["fft"].ok and op.plans["fft"].kernel == "fft_stockham"
    for bad in (1000, 1, 0):
        with pytest.raises(ValueError, match="power of two"):
            reg.register_fft("bad", bad)
        with pytest.raises(ValueError, match="power of two"):
            ref_reg.register_fft("bad", bad)
    assert "bad" not in reg


def test_mixed_drain_with_fft_matches_reference():
    """SpMV, BFS, PageRank and FFT requests in one drain, as
    ``examples/serve_kernels.py`` mixes them: every result agrees with the
    reference service's and with numpy / the host references."""
    ref_svc, svc = _fft_services(n_slots=4)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(N)
    sig = rng.standard_normal((2, FFT_N))
    reqs = [("spmv", x, {}), ("fft", sig, {}), ("bfs", None, {"source": 3}),
            ("pagerank", None, {"iters": 4}), ("fft", sig[0], {})]
    rids = []
    for op, payload, params in reqs:
        operand = {"spmv": "mat", "fft": "fft"}.get(op, "g")
        rids.append((ref_svc.submit(op, operand, payload, **params),
                     svc.submit(op, operand, payload, **params)))
    assert svc.poll(rids[0][1]) is None            # async: nothing ran yet
    ref_svc.drain()
    svc.drain()
    for (op, payload, _), (r_ref, r_port) in zip(reqs, rids):
        if op == "fft":
            got, want = _spectrum(svc, r_port), _spectrum(ref_svc, r_ref)
            spec = np.fft.fft(np.atleast_2d(payload), axis=-1)
            for g, w, s in zip(got, want, (spec.real, spec.imag)):
                assert g.shape == np.atleast_2d(payload).shape
                np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9 * FFT_N)
                np.testing.assert_allclose(g, s, rtol=1e-9, atol=1e-9 * FFT_N)
        else:
            np.testing.assert_allclose(_result(svc, r_port),
                                       _result(ref_svc, r_ref),
                                       rtol=TOL, atol=TOL)
    assert dict(svc.stats) == dict(ref_svc.stats)
    assert svc.stats["served"] == 5 and svc.stats["failed"] == 0
    assert svc.registry.get("fft").launches == \
        ref_svc.registry.get("fft").launches
    plans = svc.plans()["fft"]
    assert plans["fft"]["kernel"] == "fft_stockham" and plans["fft"]["ok"]


def test_five_fft_requests_are_one_fft_stockham_call(monkeypatch):
    from repro_torch.kernels import fft as fft_k

    calls = {"n": 0, "rows": 0}
    real = fft_k.fft_stockham

    def counting(re, *args, **kwargs):
        calls["n"] += 1
        calls["rows"] += re.shape[0]
        return real(re, *args, **kwargs)

    monkeypatch.setattr(fft_k, "fft_stockham", counting)
    ref_svc, svc = _fft_services(n_slots=8)
    rng = np.random.default_rng(5)
    sigs = [rng.standard_normal((i % 3 + 1, FFT_N)) for i in range(5)]
    rids = [(ref_svc.submit("fft", "fft", s), svc.submit("fft", "fft", s))
            for s in sigs]
    ref_svc.drain()
    svc.drain()
    assert calls == {"n": 1, "rows": sum(s.shape[0] for s in sigs)}
    assert svc.stats["launches"] == ref_svc.stats["launches"] == 1
    assert svc.stats["max_group"] == 5 and svc.stats["coalesced"] == 5
    for s, (r_ref, r_port) in zip(sigs, rids):
        got = _spectrum(svc, r_port)
        for g, w in zip(got, _spectrum(ref_svc, r_ref)):
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9 * FFT_N)
        np.testing.assert_allclose(got[0], np.fft.fft(s, axis=-1).real,
                                   rtol=1e-9, atol=1e-9 * FFT_N)


@pytest.mark.parametrize("bad", ["complex", "length", "empty", "3d"])
def test_bad_fft_payload_fails_alone(bad):
    rng = np.random.default_rng(9)
    good = rng.standard_normal((2, FFT_N))
    payload = {
        "complex": good + 1j * good,
        "length": np.ones((2, FFT_N - 1)),
        "empty": np.ones((0, FFT_N)),
        "3d": np.ones((1, 2, FFT_N)),
    }[bad]
    ref_svc, svc = _fft_services()
    rids = [(ref_svc.submit("fft", "fft", p), svc.submit("fft", "fft", p))
            for p in (payload, good)]
    ref_svc.drain()
    svc.drain()
    match = {"complex": "complex signals", "length": "signal length",
             "empty": "empty signal batch", "3d": "1-D or 2-D"}[bad]
    for service, rid in ((ref_svc, rids[0][0]), (svc, rids[0][1])):
        with pytest.raises(RuntimeError, match=match):
            service.poll(rid)
    got = _spectrum(svc, rids[1][1])
    np.testing.assert_allclose(got[0], np.fft.fft(good, axis=-1).real,
                               rtol=1e-9, atol=1e-9 * FFT_N)
    assert dict(svc.stats) == dict(ref_svc.stats)
    assert svc.stats["failed"] == 1 and svc.stats["served"] == 1
    # a torch payload is checked the same way
    _, svc2 = _fft_services()
    rid = svc2.submit("fft", "fft", torch.from_numpy(good + 1j * good))
    svc2.drain()
    with pytest.raises(RuntimeError, match="complex signals"):
        svc2.poll(rid)


def test_fft_op_on_a_matrix_operand_fails_like_the_reference():
    ref_svc, svc = _fft_services()
    for service in (ref_svc, svc):
        rid = service.submit("fft", "mat", np.ones((1, FFT_N)))
        service.drain()
        with pytest.raises(RuntimeError, match="not an fft plan"):
            service.poll(rid)
