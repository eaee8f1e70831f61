"""The paper's sweep study in the port (``repro_torch.core.{vconfig, sdv,
traffic, sweep, campaign}``, ``tune_vl``, ``TuneCache.warm_from_sweeps``
and the ``repro_torch.launch.campaign`` CLI) against the reference's
``repro.core`` on the same inputs.

The cycle model is numpy in both packages with the same arithmetic in the
same order, so traces, runs and cubes compare ``==`` (``np.array_equal``),
never at a tolerance.  The measured half (``measure_cuda``) runs the
port's plain versions here (``device="cpu"``) on the reference's
interpret-mode problem sizes, and its results are held against the
reference's ``ops`` at 1e-10 (fp64 SpMV), exactly (BFS), rtol 1e-10
(PageRank) and rtol 1e-9 / atol 1e-9 x n (FFT).
"""
import dataclasses
import json
import subprocess
import sys
import os

import numpy as np
import pytest
import torch

import repro_torch.core as port_core
import repro_torch.core.autotune as autotune
from repro.core import autotune as RA
from repro.core import campaign as RC
from repro.core import sdv as RSDV
from repro.core import sweep as RS
from repro.core import traffic as RT
from repro.core import vconfig as RV
from repro.core.jsonstore import SchemaVersionError as RefSchemaVersionError
from repro.graphs import gen as RG
from repro.kernels import ops as rops
from repro.kernels.execspec import ExecSpec as RefExecSpec
from repro.service.tunecache import TuneCache as RefTuneCache
from repro.sparse import formats as RF
from repro_torch.core import campaign as PC
from repro_torch.core import sdv as PSDV
from repro_torch.core import sweep as PS
from repro_torch.core import traffic as PT
from repro_torch.core import vconfig as PV
from repro_torch.core.jsonstore import SchemaVersionError
from repro_torch.graphs import gen as G
from repro_torch.launch import campaign as cli
from repro_torch.service import KernelRegistry, TuneCache
from repro_torch.sparse import formats as F

SERIES = (PV.SCALAR_VL,) + PV.PAPER_VLS
KERNELS = ("spmv", "bfs", "pagerank", "fft")
NAMED = ("paper-fig3", "paper-fig4", "paper-fig5", "machine-compare")


def ref_machine(m: PSDV.MachineParams) -> RSDV.MachineParams:
    """The reference's MachineParams with the same fields as ``m``."""
    return RSDV.MachineParams(**dataclasses.asdict(m))


@pytest.fixture(scope="module")
def cubes():
    """Every named campaign, evaluated once by each package."""
    return {n: (RC.run_campaign(n), PC.run_campaign(n)) for n in NAMED}


# ---------------------------------------------------------------------------
# VectorConfig, traces, SDVMachine.run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vl", SERIES)
def test_vector_config_matches_reference(vl):
    ref, port = RV.VectorConfig(vl=vl), PV.VectorConfig(vl=vl)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    for attr in ("is_scalar", "register_bits"):
        assert getattr(ref, attr) == getattr(port, attr)
    assert ref.alu_cycles(3) == port.alu_cycles(3)
    assert ref.n_instructions(11_397) == port.n_instructions(11_397)
    assert dataclasses.asdict(ref.with_vl(2 * vl)) == \
        dataclasses.asdict(port.with_vl(2 * vl))
    assert RV.series_label(vl) == PV.series_label(vl)
    assert [dataclasses.asdict(c) for c in RV.sweep_configs(lanes=32)] == \
        [dataclasses.asdict(c) for c in PV.sweep_configs(lanes=32)]
    assert (RV.PAPER_VLS, RV.SCALAR_VL) == (PV.PAPER_VLS, PV.SCALAR_VL)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("vl", SERIES)
def test_trace_builders_and_run_match_reference(kernel, vl):
    """Phases and ops field by field, then the run on three machines."""
    ref = RT.TRACE_BUILDERS[kernel](RV.VectorConfig(vl=vl))
    port = PT.TRACE_BUILDERS[kernel](PV.VectorConfig(vl=vl))
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    for m in (PSDV.MachineParams(), PSDV.fpga_sdv_machine(extra_latency=128),
              PSDV.h100_machine()):
        want = RSDV.SDVMachine(ref_machine(m)).run(ref)
        got = PSDV.SDVMachine(m).run(port)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.breakdown() == want.breakdown()
        assert (got.dram_bytes, got.mem_instructions) == \
            (want.dram_bytes, want.mem_instructions)


def test_problems_and_sweep_constants_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in RT.PAPER_PROBLEMS.items()} \
        == {k: dataclasses.asdict(v) for k, v in PT.PAPER_PROBLEMS.items()}
    for name in ("ell_width", "avg_nnz_row"):
        assert getattr(RT.PAPER_PROBLEMS["spmv"], name) == \
            getattr(PT.PAPER_PROBLEMS["spmv"], name)
    assert (RSDV.PAPER_LATENCIES, RSDV.PAPER_BANDWIDTHS) == \
        (PSDV.PAPER_LATENCIES, PSDV.PAPER_BANDWIDTHS)
    assert np.array_equal(RT.poisson_arrivals(50.0, 32, seed=3),
                          PT.poisson_arrivals(50.0, 32, seed=3))
    with pytest.raises(ValueError, match="rate_rps"):
        PT.poisson_arrivals(0.0, 4)
    m = PSDV.MachineParams()
    assert m.with_bandwidth_fraction(1, 3) == PSDV.MachineParams(
        **dataclasses.asdict(ref_machine(m).with_bandwidth_fraction(1, 3)))
    assert (m.mem_latency, m.eff_bw) == (ref_machine(m).mem_latency,
                                         ref_machine(m).eff_bw)


def test_latency_and_bandwidth_sweep_entry_points_match_reference():
    trace = PT.spmv_trace(PT.SpMVProblem(), PV.VectorConfig(vl=64))
    rtrace = RT.spmv_trace(RT.SpMVProblem(), RV.VectorConfig(vl=64))
    base = PSDV.fpga_sdv_machine()
    for port_fn, ref_fn in ((PSDV.run_latency_sweep, RSDV.run_latency_sweep),
                            (PSDV.run_bandwidth_sweep, RSDV.run_bandwidth_sweep)):
        got = {k: r.cycles for k, r in port_fn(base, trace).items()}
        want = {k: r.cycles for k, r in ref_fn(ref_machine(base), rtrace).items()}
        assert got == want


# ---------------------------------------------------------------------------
# Cubes, records, curves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMED)
def test_named_campaign_cubes_are_the_reference_cubes(cubes, name):
    ref, port = cubes[name]
    assert port.spec.to_json() == ref.spec.to_json()
    assert port.cycles.dtype == ref.cycles.dtype
    assert np.array_equal(port.cycles, ref.cycles)        # ==, not approx


def test_user_cube_over_h100_and_fpga_machines():
    machines = (PSDV.h100_machine(), PSDV.fpga_sdv_machine())
    kw = dict(name="h100-study", vls=SERIES, latencies=(0, 128, 512),
              bandwidths=(PC.BW_UNLIMITED, 8.0))
    port = PC.run_campaign(PC.CampaignSpec(machines=machines, **kw))
    ref = RC.run_campaign(RC.CampaignSpec(
        machines=tuple(ref_machine(m) for m in machines), **kw))
    assert port.cycles.shape == (2, 4, 7, 3, 2)
    assert np.array_equal(port.cycles, ref.cycles)
    # the vectorized cube is the per-point model, exactly, on the card's
    # constants too
    traces = PT.build_trace_grid(KERNELS, SERIES)
    h100 = machines[0]
    for i, trace in enumerate(traces):
        for li, lat in enumerate(kw["latencies"]):
            point = PSDV.SDVMachine(h100.with_latency(lat)).run(trace).cycles
            assert port.cycles[0].reshape(len(traces), 3, 2)[i, li, 0] == point


def test_evaluate_cube_matches_reference_on_an_empty_grid():
    got = PSDV.evaluate_cube([], PSDV.h100_machine(), (0, 64), (8.0,))
    want = RSDV.evaluate_cube([], ref_machine(PSDV.h100_machine()), (0, 64), (8.0,))
    assert got.shape == want.shape == (0, 2, 1)


@pytest.mark.parametrize("name", ("paper-fig3", "machine-compare"))
def test_records_and_curves_match_reference(cubes, name):
    ref, port = cubes[name]
    assert list(port.records()) == list(ref.records())
    for mi in range(len(ref.spec.machines)):
        assert port.curves(machine=mi) == ref.curves(machine=mi)


def test_bandwidth_curves_and_spec_errors_match_reference(cubes):
    ref, port = cubes["paper-fig5"]
    assert port.curves(knob="bw_limit") == ref.curves(knob="bw_limit")
    for knob in ("extra_latency", "nope"):
        with pytest.raises(ValueError) as rexc:
            ref.curves(knob=knob)
        with pytest.raises(ValueError) as pexc:
            port.curves(knob=knob)
        assert str(pexc.value) == str(rexc.value)
    for kw in (dict(kernels=("nope",)), dict(vls=())):
        with pytest.raises(ValueError) as rexc:
            RC.CampaignSpec(name="bad", **kw)
        with pytest.raises(ValueError) as pexc:
            PC.CampaignSpec(name="bad", **kw)
        assert str(pexc.value) == str(rexc.value)
    assert PC.campaign_names() == RC.campaign_names()
    with pytest.raises(KeyError, match="unknown campaign"):
        PC.get_campaign("paper-fig99")
    assert PC.measure_vls(SERIES) == RC.measure_vls(SERIES) == (8, 256)
    assert PC.measure_vls((PV.SCALAR_VL,)) == RC.measure_vls((PV.SCALAR_VL,))
    for m in (PSDV.MachineParams(), PC.hbm_like_machine()):
        for bw in (PC.BW_UNLIMITED, 8):
            assert PC.resolve_bandwidth(m, bw) == \
                RC.resolve_bandwidth(ref_machine(m), bw)


def test_named_machines_match_reference():
    for name in ("ddr_like_machine", "hbm_like_machine", "sve_like_machine",
                 "avx512_like_machine"):
        assert dataclasses.asdict(getattr(PC, name)()) == \
            dataclasses.asdict(getattr(RC, name)())
    assert dataclasses.asdict(PSDV.tpu_v5e_machine()) == \
        dataclasses.asdict(RSDV.tpu_v5e_machine())
    assert dataclasses.asdict(PSDV.fpga_sdv_machine()) == \
        dataclasses.asdict(RSDV.fpga_sdv_machine())
    for vl in (1, 8, 64):
        assert PC.sve_like_machine().supports_vl(vl) == \
            RC.sve_like_machine().supports_vl(vl)


@pytest.mark.parametrize("latencies", [(16, 64, 256), (0, 64)])
def test_normalized_matches_reference_and_warns_alike(latencies):
    kw = dict(kernels=("spmv", "fft"), vls=(1, 64), latencies=latencies)
    ref, port = RS.latency_sweep(**kw), PS.latency_sweep(**kw)
    assert port.data == ref.data
    if 0 in latencies:
        assert port.normalized(anchor=0) == ref.normalized(anchor=0)
        return
    with pytest.warns(RuntimeWarning) as rw:
        want = ref.normalized(anchor=0)
    with pytest.warns(RuntimeWarning,
                      match="anchor 0 .*minimum knob value 16") as pw:
        got = port.normalized(anchor=0)
    assert got == want
    assert [str(w.message) for w in pw] == [str(w.message) for w in rw]
    assert list(port.rows()) == list(ref.rows())


# ---------------------------------------------------------------------------
# The store, across the packages
# ---------------------------------------------------------------------------


def _measured_record(source):
    return {"campaign": "paper-fig3", "machine": "NVIDIA H100 80GB HBM3",
            "kernel": "spmv", "vl": 256, "extra_latency": 0,
            "bw_limit": PC.BW_UNLIMITED, "us_per_call": 12.5,
            "problem": "cage10", "source": source}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_store_roundtrips_across_packages(tmp_path, cubes, writer):
    path = str(tmp_path / "BENCH_sweeps.json")
    mods = {"port": PC, "reference": RC}
    reader = "reference" if writer == "port" else "port"
    store = mods[writer].SweepStore(path)
    for name in NAMED:
        result = cubes[name][0 if writer == "reference" else 1]
        store.put(result)
    fig3 = store.get("paper-fig3")
    fig3.measured = [_measured_record("measured-cuda"),
                     _measured_record("measured-interpret")]
    store.save()
    got = mods[reader].SweepStore(path, strict=True)
    assert got.names() == sorted(NAMED)
    for name in NAMED:
        ref, port = cubes[name]
        back = got.get(name)
        assert back.spec.to_json() == ref.spec.to_json()
        assert np.array_equal(back.cycles, ref.cycles)    # exact
        assert np.array_equal(back.cycles, port.cycles)
    assert got.get("paper-fig3").measured == fig3.measured
    assert json.load(open(path))["schema_version"] == PC.SCHEMA_VERSION == \
        RC.SCHEMA_VERSION


def test_store_discard_and_strict_refusal_match_reference(tmp_path):
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({"schema_version": 999,
                                 "campaigns": {"ghost": {}}}))
    with pytest.warns(RuntimeWarning, match="schema_version 999"):
        assert PC.SweepStore(str(stale)).names() == []
    with pytest.warns(RuntimeWarning):
        assert RC.SweepStore(str(stale)).names() == []
    future = tmp_path / "future.json"
    future.write_text(json.dumps({"schema_version": PC.SCHEMA_VERSION + 1,
                                  "campaigns": {"ghost": {}}}))
    with pytest.raises(RefSchemaVersionError) as rexc:
        RC.SweepStore(str(future), strict=True)
    with pytest.raises(SchemaVersionError, match="newer version") as pexc:
        PC.SweepStore(str(future), strict=True)
    assert str(pexc.value) == str(rexc.value)
    with pytest.raises(KeyError, match="not in store"):
        PC.SweepStore(str(tmp_path / "none.json")).get("paper-fig3")


def test_crosscheck_joins_card_timings_only(cubes):
    ref, _ = cubes["paper-fig3"]
    result = PC.run_campaign("paper-fig3")
    result.measured = [_measured_record(s) for s in (
        "measured-cuda", "measured-interpret", "measured-cpu")]
    rows = PC.crosscheck_measured(result)
    assert len(rows) == 1
    ki, vi = result.spec.kernels.index("spmv"), result.spec.vls.index(256)
    assert rows[0]["modeled_cycles"] == ref.cycles[0, ki, vi, 0, 0]
    assert rows[0]["measured_us"] == 12.5
    assert rows[0]["cycles_per_us"] == ref.cycles[0, ki, vi, 0, 0] / 12.5
    # the reference joins its own interpret-mode record from the same list
    ref_rows = RC.crosscheck_measured(dataclasses.replace(
        ref, measured=result.measured))
    assert [r["modeled_cycles"] for r in ref_rows] == \
        [r["modeled_cycles"] for r in rows]


# ---------------------------------------------------------------------------
# Claim checks
# ---------------------------------------------------------------------------


def test_claim_checks_match_reference(cubes):
    (r3, p3), (r5, p5) = cubes["paper-fig3"], cubes["paper-fig5"]
    rt = RS.slowdown_tables(RS.sweep_result_from_campaign(r3))
    pt = PS.slowdown_tables(PS.sweep_result_from_campaign(p3))
    assert pt == rt
    assert PS.check_latency_claim(pt) == RS.check_latency_claim(rt) == []
    rb, pb = (RS.sweep_result_from_campaign(r5),
              PS.sweep_result_from_campaign(p5))
    assert pb.knob == rb.knob == "bw_limit" and pb.data == rb.data
    assert PS.check_bandwidth_claim(pb) == RS.check_bandwidth_claim(rb) == []
    for kernel, per_vl in pb.data.items():
        for vl, curve in per_vl.items():
            assert PS.plateau_bandwidth(curve) == RS.plateau_bandwidth(
                rb.data[kernel][vl])
    assert PS.spmv_anchor_errors(pt) == RS.spmv_anchor_errors(rt)
    assert PS.PAPER_SPMV_ANCHORS == RS.PAPER_SPMV_ANCHORS


def test_tight_claim_tolerances_give_the_reference_violations(cubes):
    (r3, p3), (r5, p5) = cubes["paper-fig3"], cubes["paper-fig5"]
    rt = RS.slowdown_tables(RS.sweep_result_from_campaign(r3))
    pt = PS.slowdown_tables(PS.sweep_result_from_campaign(p3))
    assert PS.check_latency_claim(pt, tol=0.5) == \
        RS.check_latency_claim(rt, tol=0.5) != []
    assert PS.check_bandwidth_claim(PS.sweep_result_from_campaign(p5), 0.9) \
        == RS.check_bandwidth_claim(RS.sweep_result_from_campaign(r5), 0.9) \
        != []


def test_short_vector_presets_give_the_reference_violations(cubes):
    ref, port = cubes["machine-compare"]

    def claim(mod, result, mi):
        m = result.spec.machines[mi]
        tables = mod.slowdown_tables(mod.sweep_result_from_campaign(
            result, knob="extra_latency", machine=mi))
        usable = {k: {vl: c for vl, c in per.items()
                      if vl == PV.SCALAR_VL or m.supports_vl(vl)}
                  for k, per in tables.items()}
        return mod.check_latency_claim(usable)

    names = [m.name for m in port.spec.machines]
    got = {n: claim(PS, port, mi) for mi, n in enumerate(names)}
    want = {n: claim(RS, ref, mi) for mi, n in enumerate(names)}
    assert got == want
    assert got["avx512-like"] != []
    assert got["ddr-like"] == got["hbm-like"] == got["sve-like"] == []


# ---------------------------------------------------------------------------
# tune_vl
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("row_bytes", [0.0, 4096.0])
def test_tune_vl_matches_reference_under_explicit_arguments(kernel, row_bytes):
    cands = [8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096]
    budget = 1 << 20
    for m in (PSDV.tpu_v5e_machine(), PSDV.h100_machine()):
        got = autotune.tune_vl(PT.TRACE_BUILDERS[kernel], machine=m,
                               candidates=cands, bytes_per_vl_row=row_bytes,
                               smem_budget=budget)
        want = RA.tune_vl(RT.TRACE_BUILDERS[kernel], machine=ref_machine(m),
                          candidates=cands, bytes_per_vl_row=row_bytes,
                          vmem_budget=budget)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.speedup_over_worst() == want.speedup_over_worst()


def test_tune_vl_defaults_to_the_card_and_its_budget():
    got = autotune.tune_vl(PT.TRACE_BUILDERS["spmv"])
    want = autotune.tune_vl(PT.TRACE_BUILDERS["spmv"],
                            machine=PSDV.h100_machine(),
                            candidates=autotune.candidate_vls())
    assert got == want
    assert [vl for vl, _ in got.table] == autotune.candidate_vls()
    # a row of 1 KB a vl: 227 KB of shared memory holds vl <= 128
    fit = autotune.tune_vl(PT.TRACE_BUILDERS["spmv"], bytes_per_vl_row=1024)
    assert max(vl for vl, _ in fit.table) == 128
    with pytest.raises(ValueError, match="shared-memory budget"):
        autotune.tune_vl(PT.TRACE_BUILDERS["spmv"],
                         bytes_per_vl_row=autotune.SMEM_PER_BLOCK)


# ---------------------------------------------------------------------------
# The warm start
# ---------------------------------------------------------------------------


@pytest.fixture
def study_store(tmp_path):
    """A store of machine-compare and a cube over the card's constants."""
    store = PC.SweepStore(str(tmp_path / "sweeps.json"))
    store.put(PC.run_campaign("machine-compare"))
    store.put(PC.run_campaign(PC.CampaignSpec(
        name="h100-study", vls=SERIES, latencies=(0, 128, 512),
        machines=(PSDV.h100_machine(),))))
    store.save()
    return store


def test_warm_from_sweeps_seeds_the_reference_hints(study_store):
    port, ref = TuneCache(), RefTuneCache()
    n = port.warm_from_sweeps(study_store.path)
    assert n == ref.warm_from_sweeps(study_store.path) == 5 * 4 + 4
    for name in study_store.names():
        for m in study_store.get(name).spec.machines:
            for kernel in KERNELS:
                assert port.hint_vl(kernel, m.name) == \
                    ref.hint_vl(kernel, m.name) is not None
                assert port.candidate_vls_for(kernel, m.name) == \
                    ref.candidate_vls_for(kernel, m.name)
    # the card's hint: VL 256 for every kernel at +512 cycles
    assert {port.hint_vl(k, "h100-sxm") for k in KERNELS} == {256}
    assert port.candidate_vls_for("spmv", "h100-sxm") == [128, 256, 512]
    # a store object seeds the same as its path
    again = TuneCache()
    assert again.warm_from_sweeps(study_store) == n
    with pytest.raises(FileNotFoundError,
                       match="no campaign store.*repro_torch.launch.campaign"):
        TuneCache().warm_from_sweeps(study_store.path + ".typo")


def test_warm_from_sweeps_refuses_a_future_store(tmp_path):
    path = tmp_path / "future.json"
    path.write_text(json.dumps({"schema_version": PC.SCHEMA_VERSION + 1,
                                "campaigns": {}}))
    with pytest.raises(SchemaVersionError):
        TuneCache().warm_from_sweeps(str(path))


@pytest.fixture
def count_measures(monkeypatch):
    """Counts pad factors the SELL tuner measures."""
    calls = {"n": 0}
    real = autotune.measured_pad_factor

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(autotune, "measured_pad_factor", counted)
    return calls


def test_warm_start_narrows_the_registry_tune(study_store, count_measures):
    csr = F.random_csr(3000, 3000, 8.0, seed=0, skew=1.2)
    graph = G.rmat_graph(2048, 8, seed=1)
    cold = KernelRegistry(device="cpu", cache=TuneCache())
    cold_ops = [cold.register_matrix("m", csr), cold.register_graph("g", graph)]
    full_sweep = count_measures["n"]
    cold_cs = {row[0] for row in cold_ops[0].tuned.table}
    assert cold_cs == {32, 64, 128, 256, 512, 1024}

    cache = TuneCache()
    cache.warm_from_sweeps(study_store.path)
    count_measures["n"] = 0
    warm = KernelRegistry(device="cpu", cache=cache)
    ops = [warm.register_matrix("m", csr), warm.register_graph("g", graph)]
    assert 0 < count_measures["n"] < full_sweep
    for op in ops:
        assert {row[0] for row in op.tuned.table} == {128, 256, 512}
        assert op.tuned.c in cache.candidate_vls_for("spmv", "h100-sxm")
    # an operand with a full-grid entry is not re-measured because hints
    # appeared afterwards: the hinted miss falls back to the full key
    full = TuneCache()
    KernelRegistry(device="cpu", cache=full).register_matrix("m", csr)
    full.warm_from_sweeps(study_store.path)
    count_measures["n"] = 0
    again = KernelRegistry(device="cpu", cache=full).register_matrix("m2", csr)
    assert count_measures["n"] == 0 and again.tune_was_cached


# ---------------------------------------------------------------------------
# measure_cuda
# ---------------------------------------------------------------------------

N_SMALL = 512


@pytest.fixture
def small_problems(monkeypatch):
    """The reference's interpret-mode problems (``measure_interpret``), in
    the port's and the reference's formats."""
    rcsr = RF.random_csr(N_SMALL, N_SMALL, 8.0, seed=0)
    csr = F.random_csr(N_SMALL, N_SMALL, 8.0, seed=0)
    x = np.random.default_rng(0).standard_normal(N_SMALL)
    sig = np.random.default_rng(1).standard_normal((4, N_SMALL))
    rgraph = RG.random_graph(n_nodes=N_SMALL, avg_degree=8, seed=2)
    graph = G.random_graph(n_nodes=N_SMALL, avg_degree=8, seed=2)

    def graph_problem():
        return "random_graph(512, 8, seed=2)", graph

    monkeypatch.setitem(PC.MEASURE_PROBLEMS, "spmv",
                        lambda: ("random_csr(512, 512, 8.0, seed=0)", (csr, x)))
    monkeypatch.setitem(PC.MEASURE_PROBLEMS, "bfs", graph_problem)
    monkeypatch.setitem(PC.MEASURE_PROBLEMS, "pagerank", graph_problem)
    monkeypatch.setitem(PC.MEASURE_PROBLEMS, "fft",
                        lambda: ("(4, 512) signal", sig))
    return {"csr": rcsr, "x": x, "graph": rgraph, "sig": sig}


def test_measure_cpu_records_and_results_match_reference(small_problems):
    vls = (16, 256)
    outputs = {}
    recs = PC.measure_cuda(KERNELS, vls=vls, reps=1,
                           campaign="study", device="cpu", outputs=outputs)
    assert [(r["kernel"], r["vl"]) for r in recs] == \
        [(k, v) for k in KERNELS for v in vls]
    for r in recs:
        assert set(r) == {"campaign", "machine", "kernel", "vl",
                          "extra_latency", "bw_limit", "us_per_call",
                          "problem", "source"}
        assert (r["campaign"], r["machine"], r["source"]) == \
            ("study", "cpu", "measured-cpu")
        assert (r["extra_latency"], r["bw_limit"]) == (0, PC.BW_UNLIMITED)
        assert r["us_per_call"] > 0 and "perf_counter" in r["problem"]
    p = small_problems
    iters = PT.PAPER_PROBLEMS["pagerank"].pr_iters
    for vl in vls:
        spec = RefExecSpec(vl=vl)
        want = np.asarray(rops.spmv(RF.csr_to_ellpack(p["csr"], c=vl), p["x"],
                                    spec=spec))
        got = outputs["spmv", vl].numpy()
        assert np.max(np.abs(got - want)) <= 1e-10
        want = np.asarray(rops.bfs(p["graph"], 0, spec=spec))
        assert np.array_equal(outputs["bfs", vl].numpy(), want)
        want = np.asarray(rops.pagerank(p["graph"], iters=iters, spec=spec))
        np.testing.assert_allclose(outputs["pagerank", vl].numpy(), want,
                                   rtol=1e-10, atol=0)
        wre, wim = (np.asarray(a) for a in rops.fft(p["sig"]))
        gre, gim = (t.numpy() for t in outputs["fft", vl])
        for g, w in ((gre, wre), (gim, wim)):
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9 * N_SMALL)


def test_measure_problems_are_the_traced_problems():
    label, (csr, x) = PC.MEASURE_PROBLEMS["spmv"]()
    prob = PT.PAPER_PROBLEMS["spmv"]
    assert (csr.n_rows, csr.n_cols) == (prob.n_rows, prob.n_cols)
    assert abs(csr.nnz - prob.nnz) <= 0.01 * prob.nnz
    assert x.shape == (csr.n_cols,) and "cage10_like(seed=0)" in label
    label, sig = PC.MEASURE_PROBLEMS["fft"]()
    assert sig.shape == (1, 2048) and sig.dtype == np.float64
    assert PC.MEASURE_PROBLEMS["bfs"] is PC.MEASURE_PROBLEMS["pagerank"]
    assert PT.PAPER_PROBLEMS["bfs"].n_nodes == 1 << 15


def test_measure_problems_builds_a_shared_graph_once(monkeypatch):
    made = []

    def graph_problem():
        made.append(1)
        return "g", G.random_graph(64, 4, seed=0)

    monkeypatch.setitem(PC.MEASURE_PROBLEMS, "bfs", graph_problem)
    monkeypatch.setitem(PC.MEASURE_PROBLEMS, "pagerank", graph_problem)
    probs = PC.measure_problems(("bfs", "pagerank"))
    assert len(made) == 1 and probs["bfs"] is probs["pagerank"]


def test_measure_on_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: measure_cuda() would run on it")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        PC.measure_cuda(("fft",), vls=(8,))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        PC.run_campaign("paper-fig5", measure=True)


# ---------------------------------------------------------------------------
# The CLI and the package surface
# ---------------------------------------------------------------------------


def test_cli_check_claims_passes_and_writes_a_schema_1_store(tmp_path, capsys):
    path = str(tmp_path / "BENCH_sweeps.json")
    rc = cli.main(["--campaign", "machine-compare", "--check-claims",
                   "--sweeps-json", path])
    out = capsys.readouterr().out
    assert rc == 0
    assert "latency-tolerance HOLDS, bandwidth-exploitation HOLDS" in out
    assert "# table: campaign machine-compare" in out
    doc = json.load(open(path))
    assert doc["schema_version"] == 1
    assert sorted(doc["campaigns"]) == ["machine-compare", "paper-fig3",
                                        "paper-fig5"]
    # the reference reads what the CLI wrote, with the reference's cubes
    ref = RC.SweepStore(path, strict=True)
    for name in ref.names():
        assert np.array_equal(ref.get(name).cycles,
                              RC.run_campaign(name).cycles)


def test_cli_exits_1_on_a_claim_violation(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(cli, "check_bandwidth_claim",
                        lambda r: ["fft: made up"])
    rc = cli.main(["--check-claims", "--sweeps-json",
                   str(tmp_path / "s.json")])
    assert rc == 1 and "PAPER CLAIM VIOLATIONS" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main(["--sweeps-json", str(tmp_path / "s.json")])


def test_cli_runs_as_a_module(tmp_path):
    root = os.path.dirname(os.path.dirname(__file__))
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.campaign", "--campaign",
         "paper-fig3", "--campaign", "paper-fig5", "--check-claims",
         "--sweeps-json", str(tmp_path / "s.json")],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "paper claims: latency-tolerance HOLDS" in out.stdout


def test_core_exports_what_the_reference_exports():
    import repro.core as ref_core

    assert set(ref_core.__all__) <= set(port_core.__all__)
    for name in port_core.__all__:
        assert getattr(port_core, name) is not None
