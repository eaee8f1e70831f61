"""Sweep campaigns — the paper's evaluation grid as a first-class batch job.

The port of ``repro.core.campaign``.  The paper's contribution *is* a grid:
four kernels swept over vector length x memory latency x bandwidth (Figs
3-5).  A :class:`CampaignSpec` names one such cube — kernels, VLs, the two
SDV knobs, and one or more machines — and :func:`run_campaign` evaluates
the whole thing in a single broadcasted call per machine
(:func:`repro_torch.core.sdv.evaluate_cube`).  Results persist in the
reference's schema-versioned JSON store (``BENCH_sweeps.json``,
:class:`SweepStore`): a document written by either package is read by the
other, and a reloaded cube compares ``==`` to the stored one.

The store's flat record schema also carries measured timings, so modeled
and measured numbers live side by side.  The reference times its Pallas
kernels in interpret mode (``source="measured-interpret"``); the port
times its CUDA kernels on the card (:func:`measure_cuda`,
``source="measured-cuda"``), through ``ops`` at each requested VL, on the
problems the traces model (:data:`MEASURE_PROBLEMS`).

Named campaigns (the reference's, unchanged, so their cubes compare ``==``):

* ``paper-fig3`` / ``paper-fig4`` — latency sweep of §4.1 (fig4 is the same
  cube, normalized at presentation time)
* ``paper-fig5``                  — bandwidth sweep of §4.2
* ``machine-compare``             — the Lee-et-al-style cross-machine run:
  DDR-like vs HBM-like vs TPU-v5e vs short-vector parameter sets over the
  same kernel grid

plus arbitrary user-defined cubes via :class:`CampaignSpec` directly (e.g.
over :func:`repro_torch.core.sdv.h100_machine`).
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import time
from typing import Any, Callable, Iterator, Mapping, Sequence

import numpy as np

from repro_torch.core.jsonstore import (
    atomic_write_json,
    check_schema_version,
    load_json,
)
from repro_torch.core.sdv import (
    PAPER_BANDWIDTHS,
    PAPER_LATENCIES,
    MachineParams,
    evaluate_cube,
    tpu_v5e_machine,
)
from repro_torch.core.traffic import PAPER_PROBLEMS, TRACE_BUILDERS, build_trace_grid
from repro_torch.core.vconfig import PAPER_VLS, SCALAR_VL

#: Version stamp of the ``BENCH_sweeps.json`` document layout (the
#: reference's).  Bump on any backwards-incompatible change to the
#: spec/cube/record encoding.
SCHEMA_VERSION = 1

#: Bandwidth sentinel: "leave this machine's own Bandwidth Limiter setting
#: alone" (i.e. run at whatever ``bw_limit_bytes_per_cycle`` the machine
#: already has — its peak, unless the caller throttled it).  Lets one
#: campaign span machines with very different absolute peak bandwidths.
BW_UNLIMITED = 0.0

#: The paper's series: scalar baseline + the studied vector lengths.
PAPER_SERIES: tuple[int, ...] = (SCALAR_VL,) + PAPER_VLS

KERNELS: tuple[str, ...] = tuple(TRACE_BUILDERS)

#: Record ``source`` of the port's timings on the card; the only measured
#: records :func:`crosscheck_measured` joins with the model.
MEASURED_CUDA = "measured-cuda"
#: Record ``source`` of the plain versions timed on the CPU (tests).
MEASURED_CPU = "measured-cpu"

#: Bytes written before each timed call on the card: twice the H100's
#: 50 MB L2, so every call finds its inputs in device memory, as the
#: paper's memory-bound regime does (the paper's problems all fit the L2).
L2_FLUSH_BYTES = 2 * 50 * 1000 * 1000
#: Untimed calls before :func:`measure_cuda` times a (kernel, vl): the
#: first uploads the operand and computes its live widths (``ops`` caches
#: both), and both warm the allocator.
MEASURE_WARMUP = 2


# ---------------------------------------------------------------------------
# Campaign specification
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    """One named evaluation cube: kernels x VLs x latencies x bandwidths x
    machines.  Axis order in the result cube is (machine, kernel, vl,
    latency, bandwidth)."""

    name: str
    kernels: tuple[str, ...] = KERNELS
    vls: tuple[int, ...] = PAPER_SERIES
    latencies: tuple[int, ...] = PAPER_LATENCIES
    bandwidths: tuple[float, ...] = (BW_UNLIMITED,)
    machines: tuple[MachineParams, ...] = (MachineParams(),)
    description: str = ""

    def __post_init__(self) -> None:
        unknown = [k for k in self.kernels if k not in TRACE_BUILDERS]
        if unknown:
            raise ValueError(f"unknown kernels {unknown}; have {sorted(TRACE_BUILDERS)}")
        for axis in ("kernels", "vls", "latencies", "bandwidths", "machines"):
            if not getattr(self, axis):
                raise ValueError(f"campaign {self.name!r}: axis {axis!r} is empty")

    @property
    def shape(self) -> tuple[int, int, int, int, int]:
        return (len(self.machines), len(self.kernels), len(self.vls),
                len(self.latencies), len(self.bandwidths))

    @property
    def n_points(self) -> int:
        return int(np.prod(self.shape))

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["machines"] = [dataclasses.asdict(m) for m in self.machines]
        return d

    @classmethod
    def from_json(cls, d: Mapping) -> "CampaignSpec":
        d = dict(d)
        d["machines"] = tuple(MachineParams(**m) for m in d["machines"])
        for axis in ("kernels", "vls", "latencies", "bandwidths"):
            d[axis] = tuple(d[axis])
        return cls(**d)


def resolve_bandwidth(machine: MachineParams, bw: float) -> float:
    """Map the :data:`BW_UNLIMITED` sentinel to the machine's own limiter."""
    return float(machine.bw_limit_bytes_per_cycle) if bw <= 0 else float(bw)


# ---------------------------------------------------------------------------
# Campaign result
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CampaignResult:
    """The evaluated cube plus optional measured timings."""

    spec: CampaignSpec
    cycles: np.ndarray                      # (machine, kernel, vl, lat, bw)
    measured: list[dict] = dataclasses.field(default_factory=list)

    def curves(self, knob: str = "extra_latency", machine: int = 0
               ) -> dict[str, dict[int, dict[int, float]]]:
        """Nested ``kernel -> vl -> knob_value -> cycles`` dict, the layout
        :class:`repro_torch.core.sweep.SweepResult` and the claim checkers
        consume.  Requires the *other* knob axis to be a singleton."""
        s = self.spec
        if knob == "extra_latency":
            if len(s.bandwidths) != 1:
                raise ValueError(
                    f"{s.name}: latency curves need a singleton bandwidth axis, "
                    f"got {len(s.bandwidths)}")
            values, pick = s.latencies, lambda ki, vi, ni: self.cycles[machine, ki, vi, ni, 0]
        elif knob == "bw_limit":
            if len(s.latencies) != 1:
                raise ValueError(
                    f"{s.name}: bandwidth curves need a singleton latency axis, "
                    f"got {len(s.latencies)}")
            values, pick = s.bandwidths, lambda ki, vi, ni: self.cycles[machine, ki, vi, 0, ni]
        else:
            raise ValueError(f"unknown knob {knob!r}")
        return {
            kernel: {
                vl: {val: float(pick(ki, vi, ni)) for ni, val in enumerate(values)}
                for vi, vl in enumerate(s.vls)
            }
            for ki, kernel in enumerate(s.kernels)
        }

    def records(self) -> Iterator[dict]:
        """Flat modeled records + the measured records, one schema."""
        s = self.spec
        for mi, m in enumerate(s.machines):
            for ki, kernel in enumerate(s.kernels):
                for vi, vl in enumerate(s.vls):
                    for li, lat in enumerate(s.latencies):
                        for bi, bw in enumerate(s.bandwidths):
                            yield {
                                "campaign": s.name,
                                "machine": m.name,
                                "kernel": kernel,
                                "vl": vl,
                                "extra_latency": lat,
                                "bw_limit": resolve_bandwidth(m, bw),
                                "cycles": float(self.cycles[mi, ki, vi, li, bi]),
                                "source": "modeled",
                            }
        yield from self.measured

    def to_json(self) -> dict:
        return {
            "spec": self.spec.to_json(),
            "cycles": self.cycles.tolist(),
            "measured": self.measured,
        }

    @classmethod
    def from_json(cls, d: Mapping) -> "CampaignResult":
        spec = CampaignSpec.from_json(d["spec"])
        cycles = np.asarray(d["cycles"], dtype=np.float64).reshape(spec.shape)
        return cls(spec=spec, cycles=cycles, measured=list(d.get("measured", [])))


def run_campaign(
    spec: CampaignSpec | str,
    measure: bool = False,
    measure_reps: int = 10,
) -> CampaignResult:
    """Evaluate a campaign cube — one vectorized call per machine.

    ``measure=True`` additionally times the port's kernels on the card
    (:func:`measure_cuda`) at the reference's shortlist of the campaign's
    VLs (:func:`measure_vls`) and attaches the timings as
    ``source="measured-cuda"`` records in the same store schema.  It needs
    a GPU and raises without one.
    """
    if isinstance(spec, str):
        spec = get_campaign(spec)
    traces = build_trace_grid(spec.kernels, spec.vls)
    per_machine = []
    for m in spec.machines:
        bws = [resolve_bandwidth(m, b) for b in spec.bandwidths]
        cube = evaluate_cube(traces, m, spec.latencies, bws)
        per_machine.append(cube.reshape(
            len(spec.kernels), len(spec.vls),
            len(spec.latencies), len(spec.bandwidths)))
    result = CampaignResult(spec=spec, cycles=np.stack(per_machine))
    if measure:
        result.measured = measure_cuda(
            spec.kernels, vls=measure_vls(spec.vls), reps=measure_reps,
            campaign=spec.name)
    return result


# ---------------------------------------------------------------------------
# Measured cross-check (the port's kernels on the card)
# ---------------------------------------------------------------------------


def measure_vls(vls: Sequence[int], cap: int = 2) -> tuple[int, ...]:
    """The reference's shortlist of vector VLs to time: the shortest and
    the longest of the campaign's."""
    vec = sorted(v for v in vls if v != SCALAR_VL)
    if not vec:
        return ()
    picks = {vec[0], vec[-1]}
    return tuple(sorted(picks))[:cap]


def _spmv_problem():
    from repro_torch.sparse import formats as F

    csr = F.cage10_like(seed=0)
    x = np.random.default_rng(0).standard_normal(csr.n_cols)
    return (f"cage10_like(seed=0) {csr.n_rows}x{csr.n_cols} nnz {csr.nnz} "
            "fp64 as ELLPACK at C = vl"), (csr, x)


def _graph_problem():
    from repro_torch.graphs import gen as G

    p = PAPER_PROBLEMS["bfs"]
    graph = G.rmat_graph(p.n_nodes, p.avg_degree, seed=0)
    return (f"rmat_graph({p.n_nodes}, {p.avg_degree}, seed=0) ELLPACK, "
            "a host loop with one sync a step"), graph


def _fft_problem():
    p = PAPER_PROBLEMS["fft"]
    signal = np.random.default_rng(1).standard_normal((p.batch, p.n))
    return f"({p.batch}, {p.n}) fp64 signal", signal


#: The problems :func:`measure_cuda` times, by kernel: a maker returning
#: ``(label, inputs)`` on the host — ``(csr, x)`` for spmv, an
#: ``EllpackGraph`` for bfs / pagerank (one graph: the maker is shared), a
#: (batch, n) real signal for fft.  The defaults are the problems the
#: traces model (:data:`repro_torch.core.traffic.PAPER_PROBLEMS`), so
#: modeled cycles and measured µs describe the same work; tests shrink
#: them by replacing entries.
MEASURE_PROBLEMS: dict[str, Callable[[], tuple[str, Any]]] = {
    "spmv": _spmv_problem,
    "bfs": _graph_problem,
    "pagerank": _graph_problem,
    "fft": _fft_problem,
}


def measure_problems(kernels: Sequence[str] = KERNELS) -> dict[str, tuple[str, Any]]:
    """``kernel -> (label, inputs)`` for the measured kernels, each maker
    of :data:`MEASURE_PROBLEMS` called once (bfs and pagerank share a
    graph)."""
    built: dict[Callable, tuple[str, Any]] = {}
    out = {}
    for kernel in kernels:
        make = MEASURE_PROBLEMS.get(kernel)
        if make is None:
            continue
        if make not in built:
            built[make] = make()
        out[kernel] = built[make]
    return out


def measure_runner(kernel: str, vl: int, inputs, device) -> Callable[[], Any]:
    """The call :func:`measure_cuda` times for ``kernel`` at ``vl``: ``ops``
    on ``inputs`` with ``ExecSpec(vl=vl, device=device)``.  Inputs are
    packed and uploaded here, outside the timed call (``ops`` uploads a
    matrix or graph, and computes its live widths, at its first call, a
    warm-up)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.execspec import ExecSpec
    from repro_torch.sparse import formats as F

    spec = ExecSpec(vl=int(vl), device=device)
    if kernel == "spmv":
        csr, x = inputs
        ell = F.csr_to_ellpack(csr, c=int(vl))        # C = vl: kernel B6
        xd = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        return lambda: ops.spmv(ell, xd, spec=spec)
    if kernel == "bfs":
        return lambda: ops.bfs(inputs, 0, spec=spec)               # B4
    if kernel == "pagerank":
        iters = PAPER_PROBLEMS["pagerank"].pr_iters
        return lambda: ops.pagerank(inputs, iters=iters, spec=spec)  # B5
    if kernel == "fft":
        sig = torch.from_numpy(np.ascontiguousarray(inputs)).to(device)
        return lambda: ops.fft(sig, spec=spec)                     # B7
    raise ValueError(f"no measured runner for kernel {kernel!r}")


def _median_us_cuda(torch, fn, reps: int, flush):
    """Median µs of ``fn`` over ``reps`` CUDA-event-timed calls, each after
    the L2 is flushed; returns (µs, the last call's output)."""
    for _ in range(MEASURE_WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    out = None
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return statistics.median(times), out


def _median_us_cpu(fn, reps: int):
    for _ in range(MEASURE_WARMUP):
        fn()
    times = []
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(times), out


def measure_cuda(
    kernels: Sequence[str] = KERNELS,
    vls: Sequence[int] = PAPER_VLS,
    reps: int = 10,
    campaign: str = "",
    device=None,
    problems: Mapping[str, tuple[str, Any]] | None = None,
    outputs: dict | None = None,
) -> list[dict]:
    """Time the port's kernels through ``ops`` at each VL, in the store's
    flat record schema — the counterpart of the reference's
    ``measure_interpret``.

    Per (kernel, vl): spmv is ``ops.spmv`` on cage10 as ELLPACK at C = vl
    (kernel B6), bfs ``ops.bfs`` from node 0 (B4), pagerank
    ``ops.pagerank`` for ``GraphProblem.pr_iters`` steps (B5) on the
    2^15-node R-MAT graph, fft ``ops.fft`` of one 2048-point fp64 signal
    (B7); ``problems`` (``kernel -> (label, inputs)``, default
    :func:`measure_problems`) replaces them.  Kernels without a problem
    are skipped, as the reference skips kernels it has no runner for.

    ``device=None`` is the card and raises on a machine without one.  On
    the card each timing is the median of ``reps`` calls between CUDA
    events after :data:`MEASURE_WARMUP` calls, with the L2 flushed before each call;
    ``machine`` is the card's name and ``source`` ``"measured-cuda"``.  The
    graph kernels are host loops with a sync a step, so their µs include
    host time.  ``device="cpu"`` runs the plain versions, timed with
    ``perf_counter`` (``machine: "cpu"``, ``source: "measured-cpu"``);
    :func:`crosscheck_measured` skips those.  There is no fallback from
    the card to the CPU.

    ``outputs``, when given, receives ``(kernel, vl) -> result`` of the
    last timed call, for holding it against a plain version.
    """
    import torch

    from repro_torch.kernels.execspec import resolve_device

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if problems is None:
        problems = measure_problems(kernels)
    if on_card:
        machine = torch.cuda.get_device_name(dev)
        flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
        how = "; CUDA events, L2 flushed"
    else:
        machine, how = "cpu", "; plain versions, perf_counter"
    records = []
    for kernel in kernels:
        if kernel not in problems:
            continue
        label, inputs = problems[kernel]
        for vl in vls:
            fn = measure_runner(kernel, vl, inputs, dev)
            if on_card:
                us, out = _median_us_cuda(torch, fn, reps, flush)
            else:
                us, out = _median_us_cpu(fn, reps)
            if outputs is not None:
                outputs[kernel, int(vl)] = out
            records.append({
                "campaign": campaign,
                "machine": machine,
                "kernel": kernel,
                "vl": int(vl),
                "extra_latency": 0,
                "bw_limit": BW_UNLIMITED,
                "us_per_call": float(us),
                "problem": label + how,
                "source": MEASURED_CUDA if on_card else MEASURED_CPU,
            })
    return records


def crosscheck_measured(result: CampaignResult) -> list[dict]:
    """Join modeled cycles with the card's timings per (kernel, vl).

    Emits one row per ``"measured-cuda"`` record that has a modeled
    counterpart in the cube (machine 0, +0-latency / first-bandwidth
    corner), carrying both numbers and their ratio so drift between model
    and kernels is a diffable artifact rather than a judgment call.
    Records of other sources (the reference's interpret-mode timings, the
    CPU's) stay in the store untouched and are not joined.
    """
    s = result.spec
    rows = []
    for rec in result.measured:
        if rec.get("source") != MEASURED_CUDA:
            continue
        k, vl = rec["kernel"], rec["vl"]
        if k not in s.kernels or vl not in s.vls:
            continue
        ki, vi = s.kernels.index(k), s.vls.index(vl)
        modeled = float(result.cycles[0, ki, vi, 0, 0])
        measured = float(rec["us_per_call"])
        rows.append({
            "kernel": k,
            "vl": vl,
            # keeps rows apart when several benchmarks share (kernel, vl)
            "problem": rec.get("problem", ""),
            "modeled_cycles": modeled,
            "measured_us": measured,
            "cycles_per_us": modeled / measured if measured else float("inf"),
        })
    return rows


# ---------------------------------------------------------------------------
# Named machines for cross-machine campaigns
# ---------------------------------------------------------------------------


def ddr_like_machine(**kw) -> MachineParams:
    """The paper's FPGA-SDV memory system: DDR latency/bandwidth class."""
    kw.setdefault("name", "ddr-like")
    return MachineParams(**kw)


def hbm_like_machine(**kw) -> MachineParams:
    """Same core, HBM-class memory: ~4x the round-trip, 4x the bandwidth and
    a deeper outstanding-request pool — the machine the paper argues long
    vectors are really for."""
    defaults = dict(
        name="hbm-like",
        base_mem_latency=200,
        peak_bw_bytes_per_cycle=256.0,
        bw_limit_bytes_per_cycle=256.0,
        vector_mlp=12,
        mshr=288,
    )
    defaults.update(kw)
    return MachineParams(**defaults)


def sve_like_machine(**kw) -> MachineParams:
    """A64FX-class SVE-512 core: vectors cap at 8 f64 elements (``max_vl=8``)
    while the memory system is HBM2-class — the short-vector counterexample
    the paper argues against (plenty of bandwidth, not enough elements per
    instruction to amortize the round-trip)."""
    defaults = dict(
        name="sve-like",
        lanes=8,                       # 512-bit datapath
        max_vl=8,
        base_mem_latency=130,
        peak_bw_bytes_per_cycle=128.0,
        bw_limit_bytes_per_cycle=128.0,
        vector_mlp=4,
        mshr=64,
    )
    defaults.update(kw)
    return MachineParams(**defaults)


def avx512_like_machine(**kw) -> MachineParams:
    """Server-class AVX-512 core: the same 8-element f64 cap, DDR-class
    latency/bandwidth per core and weak gather throughput — short vectors on
    a commodity memory system."""
    defaults = dict(
        name="avx512-like",
        lanes=8,
        max_vl=8,
        base_mem_latency=90,
        peak_bw_bytes_per_cycle=16.0,
        bw_limit_bytes_per_cycle=16.0,
        vector_mlp=2,
        mshr=48,
        gather_ports=2,
    )
    defaults.update(kw)
    return MachineParams(**defaults)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], CampaignSpec]] = {}


def register_campaign(builder: Callable[[], CampaignSpec], name: str | None = None) -> None:
    spec_name = name if name is not None else builder().name
    _REGISTRY[spec_name] = builder


def campaign_names() -> list[str]:
    return sorted(_REGISTRY)


def get_campaign(name: str) -> CampaignSpec:
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(
            f"unknown campaign {name!r}; available: {campaign_names()}") from None


def _paper_fig3() -> CampaignSpec:
    return CampaignSpec(
        name="paper-fig3",
        description="Fig 3: execution time vs added memory latency, "
                    "scalar + VL series, FPGA-SDV machine.",
    )


def _paper_fig4() -> CampaignSpec:
    return dataclasses.replace(
        _paper_fig3(), name="paper-fig4",
        description="Fig 4: the fig3 cube normalized to the +0-latency run "
                    "of each series (slowdown tables).")


def _paper_fig5() -> CampaignSpec:
    return CampaignSpec(
        name="paper-fig5",
        latencies=(0,),
        bandwidths=tuple(PAPER_BANDWIDTHS),   # ints kept as-is: they are the
                                              # table keys of the fig5 series
        description="Fig 5: execution time vs Bandwidth Limiter setting, "
                    "scalar + VL series, FPGA-SDV machine.",
    )


def _machine_compare() -> CampaignSpec:
    return CampaignSpec(
        name="machine-compare",
        vls=(SCALAR_VL, 8, 64, 256),
        latencies=(0, 128, 512),
        bandwidths=(BW_UNLIMITED,),
        machines=(ddr_like_machine(), hbm_like_machine(), tpu_v5e_machine(),
                  sve_like_machine(), avx512_like_machine()),
        description="Cross-machine run (Lee et al. style): DDR-like vs "
                    "HBM-like vs TPU-v5e vs short-vector SVE/AVX-512-like "
                    "parameter sets over the same kernel grid (VL=8 is the "
                    "longest series the short-vector machines can execute).",
    )


for _builder in (_paper_fig3, _paper_fig4, _paper_fig5, _machine_compare):
    register_campaign(_builder)


# ---------------------------------------------------------------------------
# Persistence: the schema-versioned BENCH_sweeps.json store
# ---------------------------------------------------------------------------


class SweepStore:
    """Schema-versioned persistence for campaign results.

    Document layout (``schema_version`` gates every reader)::

        {"schema_version": 1,
         "campaigns": {name: {"spec": {...}, "cycles": [...], "measured": [...]}}}

    ``cycles`` round-trips through JSON exactly (repr-based float encoding),
    so a reloaded cube compares ``==`` to the one that was stored.
    """

    def __init__(self, path: str = "BENCH_sweeps.json", strict: bool = False):
        """``strict=False`` (default) keeps the writer-friendly behavior: an
        incompatible document is warned about and ignored (the store is a
        regenerable artifact and must not wedge the writer that would
        replace it).  ``strict=True`` raises
        :class:`repro_torch.core.jsonstore.SchemaVersionError` instead — the
        mode for readers that must not silently drop data (the warm start,
        a store produced by a newer build)."""
        self.path = path
        self._campaigns: dict[str, CampaignResult] = {}
        if os.path.exists(path):
            self._load(strict)

    def _load(self, strict: bool) -> None:
        doc = load_json(self.path)
        if not check_schema_version(doc, SCHEMA_VERSION, self.path, strict):
            self._campaigns = {}
            return
        self._campaigns = {
            name: CampaignResult.from_json(entry)
            for name, entry in doc.get("campaigns", {}).items()
        }

    def names(self) -> list[str]:
        return sorted(self._campaigns)

    def put(self, result: CampaignResult) -> None:
        self._campaigns[result.spec.name] = result

    def get(self, name: str) -> CampaignResult:
        try:
            return self._campaigns[name]
        except KeyError:
            raise KeyError(
                f"campaign {name!r} not in store {self.path}; "
                f"have {self.names()}") from None

    def save(self) -> str:
        doc = {
            "schema_version": SCHEMA_VERSION,
            "campaigns": {n: r.to_json() for n, r in sorted(self._campaigns.items())},
        }
        return atomic_write_json(self.path, doc)
