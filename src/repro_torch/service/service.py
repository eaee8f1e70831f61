"""Request-driven execution engine for the port's kernels.

The port of ``repro.service.service`` for SpMV, BFS, PageRank, FFT and MoE
dispatch traffic (``OPS``, the reference's tuple).  :class:`KernelService`
has the reference's async submit/poll shape: ``submit`` preflights and
enqueues and returns a request id, ``poll`` reports a result when one
exists, and ``step``/``run``/``drain`` advance the scheduler — the
slot-based admission loop of :class:`repro_torch.serve.slots.SlotLoop`.

Coalescing: all active requests against the same registered operand (and
the same spec) form one group per scheduling round, and the group runs as
ONE batched drive.  SpMV x vectors become the RHS columns of one
:func:`repro_torch.kernels.sell_core.spmm_sell` call (one launch of kernel
B1 per width bucket); BFS sources and PageRank (damping, iters)
configurations become the state columns of one
:func:`repro_torch.kernels.bfs.bfs_sell` or
:func:`repro_torch.kernels.pagerank.pagerank_sell` drive (one launch of
kernel B3 per width bucket per level or power step); FFT requests' signal
rows are stacked into one :func:`repro_torch.kernels.fft.fft_stockham`
batch (kernel B7); MoE dispatch requests' routing matrices become the
blocks of one block-diagonal operand whose expert-output stacks
concatenate into one RHS, one :func:`repro_torch.kernels.ops.moe_dispatch`
call (kernel B1).  A singleton graph group keeps the 1-D state; larger
groups are pow2-padded.  Results stay on the registry's device.

Operands a registry with a ``mesh`` registered (``mode == "sharded"``)
run on the sharded drives of :mod:`repro_torch.kernels.sell_shard` (the
SpMV group row-sharded, BFS and PageRank node-partitioned), each group
counted once in ``stats["sharded_launches"]``.  A PageRank request's
``dtype`` (``"float64"``, the default, or ``"float32"``) joins its
coalescing key, so the two never share a drive.

``max_queue`` bounds the admission queue (:class:`QueueFull`).  ``stats``
is the frozen-key view over the service's metrics registry, and an
optional tracer records one span tree per request, as in the reference.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.analysis.launchplan import LaunchPlan, LaunchPlanError
from repro_torch.analysis.preflight import (
    plan_bfs_sell,
    plan_fft_stockham,
    plan_moe_dispatch,
    plan_pagerank_sell,
)
from repro_torch.kernels import bfs as bfs_k
from repro_torch.kernels import fft as fft_k
from repro_torch.kernels import ops
from repro_torch.kernels import pagerank as pr_k
from repro_torch.kernels import sell_core, sell_shard
from repro_torch.kernels.execspec import ExecSpec
from repro_torch.obs import (
    CounterDict,
    LaunchProfiler,
    MetricsRegistry,
    Span,
    Stopwatch,
    Tracer,
    timer,
)
from repro_torch.serve.slots import SlotLoop
from repro_torch.service.registry import (
    KernelRegistry,
    RegisteredOperand,
    moe_k_block,
)
from repro_torch.sparse.formats import CSRMatrix, pow2_ceil

OPS = ("spmv", "bfs", "pagerank", "fft", "moe_dispatch")

#: request class of each op for the per-class latency histograms:
#: ``moe_dispatch`` is LM dispatch traffic, everything else kernel traffic
OP_CLASS = {op: ("moe_dispatch" if op == "moe_dispatch" else "kernel")
            for op in OPS}

#: FROZEN contract: the exact key set of ``KernelService.stats`` — the
#: reference's, key for key (``sharded_launches`` counts the groups a
#: registry with a mesh runs on the sharded drives).  These
#: names are observability API — dashboards and the bench gate
#: (``scripts/bench_compare.py`` zero-base counters) key on them, so
#: renaming or removing one is a breaking change; additions append here.
#: The SOURCE OF TRUTH is the service's metrics registry: each key is a
#: live :class:`repro_torch.obs.Counter` under the same name, and ``stats`` is
#: the :class:`repro_torch.obs.CounterDict` view over them — the dict spelling
#: and ``registry.snapshot()`` agree by construction.
STATS_KEYS = (
    "submitted",            # requests admitted (post-preflight)
    "served",               # requests retired with a result
    "failed",               # requests retired with an error
    "rejected",             # submits refused by QueueFull backpressure
    "steps",                # scheduler rounds executed
    "groups",               # coalesced (op, operand, spec) groups formed
    "coalesced",            # requests that shared a group with >= 1 other
    "max_group",            # largest group size seen
    "launches",             # batched core launches (one per group)
    "preflight_rejected",   # submits refused by a LaunchPlan violation
    "streamed_launches",    # launches on the out-of-VMEM streaming path
    "sharded_launches",     # launches on the multi-device sharded path
    "moe_dispatch_launches",  # batched MoE combine launches (LM serving)
)


class QueueFull(RuntimeError):
    """The service's admission queue is at ``max_queue``; retry after a
    ``step`` (or shed the request upstream)."""


def _pow2_pad(items: list) -> list:
    """Pad a request-column list to the next power of two by repeating the
    last element.  The padding columns compute throwaway results; what they
    buy is a bounded set of RHS shapes (k in {1, 2, 4, ...}) across
    arbitrary coalesced group sizes, each a whole number of k tiles.

    Single k-padding policy: this is the ONLY padding the service applies,
    and a power-of-two k is a fixpoint of the core's
    :func:`repro_torch.kernels.sell_core.padded_k` — so the group's columns are
    never padded a second time inside ``spmm_sell`` (asserted at the ops
    boundary, ``ops._spmm_slabs``)."""
    return items + [items[-1]] * (pow2_ceil(len(items)) - len(items))


@dataclasses.dataclass
class SubmitRequest:
    """Typed submission: the one structure admission reads end to end.

    ``KernelService.submit`` accepts this in place of the positional
    ``(op, operand, payload, **params)`` spelling; the attached
    :class:`~repro_torch.kernels.execspec.ExecSpec` feeds preflight-at-admission,
    the coalescing key (requests only coalesce when their specs agree),
    and the mesh placement — one structure instead of loose strings.
    """

    op: str                     # one of OPS
    operand: str                # registry name
    payload: Any = None         # x vector / signal rows; None for graphs
    params: dict = dataclasses.field(default_factory=dict)  # source / damping, iters
    spec: ExecSpec | None = None


@dataclasses.dataclass
class KernelRequest:
    rid: int
    op: str                     # one of OPS
    operand: str                # registry name
    payload: Any = None         # x vector / signal rows (numpy or torch)
    params: dict = dataclasses.field(default_factory=dict)
    spec: ExecSpec | None = None
    result: Any = None
    error: str | None = None
    submit_t: float = 0.0       # obs timer.now_s() at submit
    done_t: float = 0.0         # obs timer.now_s() when the result landed
    # trace spans (None when the service runs without a tracer): the
    # request root, its queued-stage child, its execute-stage child
    span: Span | None = None
    queued_span: Span | None = None
    exec_span: Span | None = None

    @property
    def done(self) -> bool:
        return self.result is not None or self.error is not None

    @property
    def group_key(self) -> tuple:
        """Coalescing identity: requests collapse into one launch only when
        op, operand AND execution spec agree (a spec-less request uses the
        default-spec key, so legacy submits coalesce exactly as before),
        and for PageRank the rank dtype too."""
        spec = self.spec if self.spec is not None else _DEFAULT_SPEC
        key = (self.op, self.operand, spec.coalesce_key())
        if self.op == "pagerank":
            key += (_rank_dtype(self.params),)
        return key


def _rank_dtype(params: dict) -> str:
    """A PageRank request's rank dtype as a string (default float64)."""
    return str(params.get("dtype", "float64")).removeprefix("torch.")


_DEFAULT_SPEC = ExecSpec()


class KernelService(SlotLoop[KernelRequest]):
    """Micro-batching scheduler over a :class:`KernelRegistry`."""

    def __init__(self, registry: KernelRegistry, n_slots: int = 8,
                 max_queue: int | None = None,
                 metrics: MetricsRegistry | None = None,
                 tracer: Tracer | None = None):
        super().__init__(n_slots)
        if max_queue is not None and max_queue < 1:
            raise ValueError(
                f"max_queue must be >= 1 (or None for unbounded), got "
                f"{max_queue}: a zero-capacity queue rejects every submit "
                "and the reject-then-step retry pattern would spin forever")
        self.registry = registry
        self.max_queue = max_queue
        self._next_rid = 0
        self._by_rid: dict[int, KernelRequest] = {}
        # bounded window: percentiles describe recent traffic
        self._latencies_us: deque[float] = deque(maxlen=8192)
        # the metrics registry is the source of truth for every counter;
        # ``stats`` is the frozen-contract dict view over it
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.stats = CounterDict(self.metrics, STATS_KEYS)
        self.tracer = tracer
        self.profiler = LaunchProfiler()
        self._g_queue = self.metrics.gauge(
            "queue_depth", "admission queue length after slot fill")
        self._g_inflight = self.metrics.gauge(
            "in_flight", "occupied slots this scheduling round")

    # -- async API ---------------------------------------------------------
    def submit(self, op: str | SubmitRequest, operand: str | None = None,
               payload: Any = None, *, spec: ExecSpec | None = None,
               **params) -> int:
        """Enqueue one kernel request; returns its request id immediately.

        Two spellings are admitted.  The typed form passes a
        :class:`SubmitRequest` as the sole positional argument — its
        :class:`~repro_torch.kernels.execspec.ExecSpec` rides along into
        admission preflight and the coalescing key.  The positional form
        ``submit(op, operand, payload, **params)`` is unchanged (an
        optional ``spec=`` keyword attaches a spec there too).

        Raises :class:`QueueFull` (and counts the rejection) when
        ``max_queue`` requests are already waiting — backpressure belongs
        to the caller, not to an unbounded buffer.
        """
        if isinstance(op, SubmitRequest):
            if operand is not None or payload is not None or params or \
                    spec is not None:
                raise TypeError(
                    "submit(SubmitRequest) takes no other arguments; put "
                    "operand/payload/params/spec on the request object")
            treq = op
            op, operand, payload = treq.op, treq.operand, treq.payload
            params, spec = dict(treq.params), treq.spec
        # trace completeness invariant: EVERY submit attempt — including
        # validation failures, preflight rejections and QueueFull — retires
        # exactly one closed root span, so the root starts before any check
        # can raise and every exit path below closes it.
        root = self._t_start("request", op=str(op), operand=str(operand))
        try:
            if op not in OPS:
                raise ValueError(f"unknown op {op!r}: expected one of {OPS}")
            if spec is not None and not isinstance(spec, ExecSpec):
                raise TypeError(
                    f"spec must be an ExecSpec, got {type(spec).__name__}")
            record = self.registry.get(operand)  # fail fast: unknown operand
            pre = self._t_start("preflight", parent=root)
            try:
                self._preflight(op, record, params)  # ... infeasible launches
            except LaunchPlanError:
                self._t_end(pre, status="rejected")
                raise
            self._t_end(pre)
            if self.max_queue is not None and \
                    len(self.queue) >= self.max_queue:
                self.stats["rejected"] += 1
                raise QueueFull(
                    f"admission queue is full ({self.max_queue} waiting); "
                    "step() the service or shed load")
        except QueueFull:
            self._t_end(root, status="rejected", reason="queue_full")
            raise
        except LaunchPlanError:
            self._t_end(root, status="rejected", reason="preflight")
            raise
        except BaseException:
            self._t_end(root, status="error")
            raise
        rid = self._next_rid
        self._next_rid += 1
        req = KernelRequest(rid=rid, op=op, operand=operand,
                            payload=payload, params=dict(params), spec=spec,
                            submit_t=timer.now_s(), span=root)
        if root is not None:
            root.attrs["rid"] = rid
            req.queued_span = self._t_start("queued", parent=root)
        self._by_rid[rid] = req
        super().submit(req)
        self.stats["submitted"] += 1
        return rid

    # -- tracing helpers (no-ops when the service has no tracer) -----------
    def _t_start(self, name: str, parent: Span | None = None,
                 links=(), **attrs) -> Span | None:
        if self.tracer is None:
            return None
        return self.tracer.start(name, parent=parent, links=links, **attrs)

    def _t_end(self, span: Span | None, status: str = "ok", **attrs) -> None:
        if self.tracer is not None:
            self.tracer.end(span, status=status, **attrs)

    def poll(self, rid: int) -> Any | None:
        """Result of request ``rid`` if it finished, else None.  Raises on a
        failed request (the error travels to the caller, not the log)."""
        req = self._by_rid[rid]
        if req.error is not None:
            raise RuntimeError(f"request {rid} ({req.op}) failed: {req.error}")
        return req.result

    def release(self, rid: int) -> None:
        """Drop a delivered request and its result.  Long-running servers
        call this after ``poll`` shows the request finished — without it
        every request's result array is retained for the life of the
        service.  Releasing an unfinished request is refused (it would
        complete later and land in ``completed`` with no handle left to
        remove it — the exact leak this method exists to prevent)."""
        req = self._by_rid.get(rid)
        if req is None:
            return
        if not req.done:
            raise ValueError(
                f"request {rid} has not finished; poll() until it completes "
                "before releasing it")
        self._by_rid.pop(rid)
        # a finished request may still be sitting in its slot (released
        # between execute and the next eviction round): clear the slot so
        # _evict_done cannot resurrect it into `completed` later
        for i, occupant in enumerate(self.slots):
            if occupant is req:
                self.retire(req)           # keep served/failed stats honest
                self.slots[i] = None
                return
        try:
            self.completed.remove(req)
        except ValueError:
            pass

    def drain(self, max_steps: int = 10_000) -> list[KernelRequest]:
        """Run the loop until every submitted request completes."""
        return self.run(max_steps=max_steps)

    def latency_percentiles(self) -> dict[str, float]:
        """p50/p95/p99 of request latency (submit -> result landed), in us,
        over the most recent 8192 retired requests (bounded window).
        Empty service reports zeros."""
        if not self._latencies_us:
            return {"p50_us": 0.0, "p95_us": 0.0, "p99_us": 0.0}
        lat = np.asarray(self._latencies_us)
        p50, p95, p99 = np.percentile(lat, [50, 95, 99])
        return {
            "p50_us": round(float(p50), 1),
            "p95_us": round(float(p95), 1),
            "p99_us": round(float(p99), 1),
        }

    # -- launch preflight --------------------------------------------------
    def _operand_plans(self, record: RegisteredOperand,
                       params: dict | None = None) -> dict[str, LaunchPlan]:
        """Live launch plans for every op this operand can serve, derived
        from the *current* tuned tiles: a tune that drifts out of the
        kernel's envelope after registration is caught at the next submit.
        A PageRank plan is made at the request's rank dtype (``params``)."""
        plans: dict[str, LaunchPlan] = {}
        if record.kind == "matrix" and record.slab_meta is not None:
            plans["spmv"] = self.registry.spmv_plan(
                record, max(1, record.tuned.k_block))
        elif record.kind == "graph" and record.slab_meta is not None:
            # worst case: a full coalesced group, pow2-padded
            k = pow2_ceil(max(1, self.n_slots))
            plans["bfs"] = plan_bfs_sell(record.slab_meta, k=k)
            plans["pagerank"] = plan_pagerank_sell(
                record.slab_meta, k=k, dtype=_rank_dtype(params or {}))
        elif record.kind == "fft":
            plans["fft"] = plan_fft_stockham(record.n, batch=8)
        elif record.kind == "moe" and record.slab_meta is not None:
            m = record.moe
            plans["moe_dispatch"] = plan_moe_dispatch(
                record.slab_meta, k=m["d_model"], x_dtype=m["dtype"],
                top_k=m["top_k"], k_block=moe_k_block(m["d_model"],
                                                      m["dtype"]))
        return plans

    def _preflight(self, op: str, record: RegisteredOperand,
                   params: dict | None = None) -> None:
        """Admission-time launch-contract check: an operand whose plan
        violates a contract (a PageRank rank dtype no kernel form takes
        among them) is rejected HERE with a structured
        :class:`LaunchPlanError` — no kernel launch, nothing queued."""
        plan = self._operand_plans(record, params).get(op)
        if plan is None:                # op/kind mismatch: fails at execute
            return
        try:
            plan.raise_if_invalid()
        except LaunchPlanError:
            self.stats["preflight_rejected"] += 1
            raise

    def plans(self) -> dict[str, dict[str, dict]]:
        """Observability: the current launch-plan summary for every
        registered operand — ``{name: {op: LaunchPlan.summary()}}``."""
        return {
            name: {op: plan.summary()
                   for op, plan in
                   self._operand_plans(self.registry.get(name)).items()}
            for name in self.registry.names()
        }

    # -- SlotLoop hooks ----------------------------------------------------
    def done(self, req: KernelRequest) -> bool:
        return req.done

    def admit(self, slot: int, req: KernelRequest) -> None:
        # queue residency ends, slot residency begins
        self._t_end(req.queued_span)
        if req.span is not None:
            req.exec_span = self._t_start("execute", parent=req.span,
                                          slot=slot)

    def observe_step(self, queued: int, in_flight: int) -> None:
        self._g_queue.set(queued)
        self._g_inflight.set(in_flight)

    def retire(self, req: KernelRequest) -> None:
        ok = req.error is None
        self.stats["served" if ok else "failed"] += 1
        if req.done_t:
            lat_us = (req.done_t - req.submit_t) * 1e6
            self._latencies_us.append(lat_us)
            self.metrics.histogram(
                f"latency_us_{req.op}",
                f"submit->result latency of {req.op} requests").observe(lat_us)
            cls = OP_CLASS.get(req.op, "kernel")
            self.metrics.histogram(
                f"latency_us_class_{cls}",
                f"submit->result latency of the {cls} request "
                "class").observe(lat_us)
        status = "ok" if ok else "error"
        self._t_end(req.queued_span)   # idempotent: usually closed at admit
        self._t_end(req.exec_span, status=status)
        if ok:
            self._t_end(req.span)
        else:
            self._t_end(req.span, status="error", error=req.error)

    def execute(self, active: Sequence[tuple[int, KernelRequest]]) -> None:
        self.stats["steps"] += 1
        groups: dict[tuple, list[KernelRequest]] = {}
        for _, req in active:
            if not req.done:
                groups.setdefault(req.group_key, []).append(req)
        for (op, operand, *_), reqs in groups.items():
            self.stats["groups"] += 1
            self.stats["max_group"] = max(self.stats["max_group"], len(reqs))
            if len(reqs) > 1:
                self.stats["coalesced"] += len(reqs)
            self.metrics.histogram(
                "group_size", "requests per coalesced launch group"
            ).observe(len(reqs))
            # the fan-in point: ONE launch span, linked to the root span of
            # every request it serves (N request trees -> one batched call)
            launch = self._t_start(
                "launch", op=op, operand=operand, group_size=len(reqs),
                links=[r.span for r in reqs if r.span is not None])
            try:
                self._run_group(op, self.registry.get(operand), reqs)
            except Exception as exc:  # noqa: BLE001 - errors belong to requests
                for req in reqs:
                    if not req.done:
                        req.error = f"{type(exc).__name__}: {exc}"
                self._t_end(launch, status="error")
            else:
                self._t_end(launch)
        now = timer.now_s()
        for _, req in active:
            if req.done and not req.done_t:
                req.done_t = now

    # -- kernel dispatch ---------------------------------------------------
    def _run_group(self, op: str, operand: RegisteredOperand,
                   reqs: list[KernelRequest]) -> None:
        runner = getattr(self, f"_run_{op}")
        runner(operand, reqs)

    def _count_launch(self, operand: RegisteredOperand, *,
                      op: str | None = None,
                      wall_us: float | None = None) -> None:
        """The launch-counter hook: one batched core call per coalesced
        group, visible in ``stats['launches']`` and per operand.  When the
        caller measured the call (``op`` + ``wall_us``), the launch also
        lands in the wall-time histogram and the launch profiler — paired
        with the operand's static preflight plan so planned-vs-measured
        residuals are queryable (:meth:`repro_torch.obs.LaunchProfiler.residuals`)."""
        self.stats["launches"] += 1
        operand.launches += 1
        if op is not None and wall_us is not None:
            self.metrics.histogram(
                f"launch_wall_us_{op}",
                f"measured wall time of batched {op} launches").observe(wall_us)
            self.profiler.record(
                op=op, operand=operand.name, wall_us=wall_us,
                plan=operand.plans.get(op))

    @staticmethod
    def _validated(reqs: list[KernelRequest], check) -> tuple[list, list]:
        """Validate each request's payload BEFORE stacking the group: a
        malformed request fails alone, never its coalesced groupmates.
        Returns (good requests, their checked payloads)."""
        good, payloads = [], []
        for req in reqs:
            try:
                payloads.append(check(req))
            except Exception as exc:  # noqa: BLE001 - belongs to the request
                req.error = f"{type(exc).__name__}: {exc}"
                continue
            good.append(req)
        return good, payloads

    def _run_spmv(self, operand, reqs):
        """The whole group is ONE batched core call: request vectors become
        RHS columns of a single ``spmm_sell`` (one kernel launch per width
        bucket)."""
        if operand.kind != "matrix":
            raise TypeError(f"operand {operand.name!r} is not a matrix")
        arrs, tuned = operand.device_arrays, operand.tuned
        n_cols = operand.n_cols
        device = self.registry.device
        dtype = arrs["vals"][0].dtype
        np_dtype = np.dtype(str(dtype).removeprefix("torch."))

        def check(req):
            # the CUDA kernel gathers X[col] for every stored col < n_cols:
            # a short x would be read past its end (JAX would clamp), so
            # every payload's shape is checked before it joins the stack
            p = req.payload
            if not isinstance(p, torch.Tensor):
                p = torch.from_numpy(np.asarray(p, np_dtype))
            if tuple(p.shape) != (n_cols,):
                raise ValueError(
                    f"x must have shape ({n_cols},), got {tuple(p.shape)}")
            return p.to(device=device, dtype=dtype)

        good, xs = self._validated(reqs, check)
        if not good:
            return
        # pow2-pad the RHS stack: group sizes 1..n_slots share log2 shapes,
        # each a whole number of k tiles (see _pow2_pad)
        x_stack = torch.stack(_pow2_pad(xs), dim=1)
        sw = Stopwatch().start()
        if operand.mode == "sharded":
            y = sell_shard.spmm_sell_sharded(
                operand.sharded, x_stack, mesh=self.registry.mesh,
                k_block=tuned.k_block)
            self.stats["sharded_launches"] += 1
        else:
            y = sell_core.spmm_sell(
                arrs["cols"], arrs["vals"], arrs["rows"], x_stack,
                n_rows=operand.n, k_block=tuned.k_block,
            )
        if device.type == "cuda":
            torch.cuda.synchronize(device)   # the wall time covers the kernels
        sw.stop()
        self._count_launch(operand, op="spmv", wall_us=sw.elapsed_us)
        for i, req in enumerate(good):
            req.result = y[:, i]

    def _run_bfs(self, operand, reqs):
        """The whole group is one batched drive: sources become frontier
        columns, every level is a single launch set."""
        if operand.kind != "graph":
            raise TypeError(f"operand {operand.name!r} is not a graph")
        arrs = operand.device_arrays

        def check(req):
            source = int(req.params.get("source", 0))
            if not 0 <= source < operand.n:
                raise ValueError(f"source {source} out of range [0, {operand.n})")
            return source

        good, sources = self._validated(reqs, check)
        if not good:
            return
        # a singleton group keeps the 1-D fast path (no state-column axis);
        # larger groups batch sources as columns, padded to a power of two
        # (repeat the last source) so group sizes share log2 state shapes
        batch = sources[0] if len(good) == 1 else _pow2_pad(sources)
        device = self.registry.device
        sw = Stopwatch().start()
        if operand.mode == "sharded":
            dist = sell_shard.bfs_sell_sharded(
                operand.sharded, batch, mesh=self.registry.mesh)
            self.stats["sharded_launches"] += 1
        else:
            dist = bfs_k.bfs_sell(arrs["adj"], arrs["nodes"], operand.n,
                                  batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)   # the wall time covers the kernels
        sw.stop()
        self._count_launch(operand, op="bfs", wall_us=sw.elapsed_us)
        if len(good) == 1:
            good[0].result = dist
        else:
            for i, req in enumerate(good):
                req.result = dist[:, i]

    def _run_pagerank(self, operand, reqs):
        """The whole group is one batched drive: (damping, iters) configs
        become iterate columns, every power step is a single launch set, in
        the group's rank dtype (one per group: it is part of the key)."""
        if operand.kind != "graph":
            raise TypeError(f"operand {operand.name!r} is not a graph")
        arrs = operand.device_arrays

        def check(req):
            return (float(req.params.get("damping", 0.85)),
                    int(req.params.get("iters", 20)))

        good, configs = self._validated(reqs, check)
        if not good:
            return
        if len(good) == 1:                     # 1-D fast path (see _run_bfs)
            damping, iters = configs[0]
        else:                                  # pow2-padded columns, ditto
            configs = _pow2_pad(configs)
            damping = [d for d, _ in configs]
            iters = [i for _, i in configs]
        device = self.registry.device
        dtype = getattr(torch, _rank_dtype(good[0].params))
        sw = Stopwatch().start()
        if operand.mode == "sharded":
            rank = sell_shard.pagerank_sell_sharded(
                operand.sharded, arrs["out_degree"], mesh=self.registry.mesh,
                damping=damping, iters=iters, dtype=dtype)
            self.stats["sharded_launches"] += 1
        else:
            rank = pr_k.pagerank_sell(arrs["adj"], arrs["nodes"],
                                      arrs["out_degree"], operand.n,
                                      damping=damping, iters=iters,
                                      dtype=dtype)
        if device.type == "cuda":
            torch.cuda.synchronize(device)   # the wall time covers the kernels
        sw.stop()
        self._count_launch(operand, op="pagerank", wall_us=sw.elapsed_us)
        if len(good) == 1:
            good[0].result = rank
        else:
            for i, req in enumerate(good):
                req.result = rank[:, i]

    def _run_fft(self, operand, reqs):
        """True micro-batch: stack every request's signal rows into one
        batched Stockham call (kernel B7) against the operand's
        precomputed float64 twiddles."""
        if operand.kind != "fft":
            raise TypeError(f"operand {operand.name!r} is not an fft plan")
        n = operand.n
        device = self.registry.device

        def check(req):
            p = req.payload
            if p.is_complex() if isinstance(p, torch.Tensor) \
                    else np.iscomplexobj(p):
                # float64 casting would silently drop the imaginary plane
                raise TypeError("complex signals are not supported; "
                                "pass split re/im planes")
            if not isinstance(p, torch.Tensor):
                p = torch.from_numpy(np.asarray(p, np.float64))
            sig = torch.atleast_2d(p.to(dtype=torch.float64))
            if sig.ndim != 2:
                raise ValueError(f"signal must be 1-D or 2-D (batch, n), "
                                 f"got shape {tuple(sig.shape)}")
            if sig.shape[0] == 0:
                raise ValueError("empty signal batch (0 rows)")
            if sig.shape[-1] != n:
                raise ValueError(f"signal length {sig.shape[-1]} != "
                                 f"registered fft length {n}")
            return sig.to(device)

        good, sigs = self._validated(reqs, check)
        if not good:
            return
        spans, lo = [], 0
        for sig in sigs:
            spans.append((lo, lo + sig.shape[0]))
            lo += sig.shape[0]
        batch = torch.cat(sigs)
        arrs = operand.device_arrays
        sw = Stopwatch().start()
        re, im = fft_k.fft_stockham(
            batch, torch.zeros_like(batch), arrs["wre"], arrs["wim"],
            b_block=min(8, batch.shape[0]))
        if device.type == "cuda":
            torch.cuda.synchronize(device)   # the wall time covers the kernels
        sw.stop()
        self._count_launch(operand, op="fft", wall_us=sw.elapsed_us)
        for req, (lo, hi) in zip(good, spans):
            req.result = (re[lo:hi], im[lo:hi])

    def _run_moe_dispatch(self, operand, reqs):
        """The whole group is ONE batched combine SpMM: each request's
        routing matrix becomes a block of a block-diagonal operand, the
        expert-output stacks concatenate as its RHS rows, and one SELL
        launch set (kernel B1) produces every request's combined
        activations, split back by each request's row span.  A malformed
        payload fails its own request alone."""
        if operand.kind != "moe":
            raise TypeError(f"operand {operand.name!r} is not a moe envelope")
        m = operand.moe
        d, top_k = m["d_model"], m["top_k"]
        np_dtype = np.dtype(m["dtype"])
        dtype = getattr(torch, m["dtype"])
        device = self.registry.device

        def check(req):
            p = req.payload
            if not isinstance(p, dict):
                raise TypeError("moe_dispatch payload must be a dict with "
                                "indptr/indices/data/x")
            indptr = np.asarray(p["indptr"], np.int64)
            indices = np.asarray(p["indices"], np.int32)
            data = np.asarray(p["data"], np_dtype)
            x = p["x"]
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.asarray(x, np_dtype))
            if x.ndim != 2 or x.shape[1] != d:
                raise ValueError(
                    f"x must have shape (n_slots, {d}), got {tuple(x.shape)}")
            n_tok = indptr.shape[0] - 1
            if n_tok < 1 or n_tok > operand.n:
                raise ValueError(
                    f"routing rows {n_tok} outside the registered envelope "
                    f"(0, {operand.n}]")
            widths = np.diff(indptr)
            if indptr[0] != 0 or widths.min(initial=0) < 0 \
                    or len(indices) != indptr[-1] or len(data) != indptr[-1]:
                raise ValueError("malformed routing CSR")
            if widths.max(initial=0) > top_k:
                raise ValueError(
                    f"routing row carries {int(widths.max())} entries, "
                    f"envelope top_k is {top_k}")
            if indices.size and (indices.min() < 0
                                 or indices.max() >= x.shape[0]):
                raise ValueError("routing column index out of range")
            return indptr, indices, data, x.to(device=device, dtype=dtype)

        good, payloads = self._validated(reqs, check)
        if not good:
            return
        # block-diagonal stack: request i's tokens occupy rows
        # [row_off_i, row_off_i + n_tok_i), its slots the matching column
        # band — one operand, one launch set, per-request row spans
        indptrs, indices_all, data_all, xs, spans = \
            [np.zeros(1, np.int64)], [], [], [], []
        row_off = col_off = nnz_off = 0
        for indptr, indices, data, x in payloads:
            n_tok = indptr.shape[0] - 1
            spans.append((row_off, row_off + n_tok))
            indptrs.append(indptr[1:] + nnz_off)
            indices_all.append(indices + col_off)
            data_all.append(data)
            xs.append(x)
            row_off += n_tok
            col_off += x.shape[0]
            nnz_off += int(indptr[-1])
        csr = CSRMatrix(indptr=np.concatenate(indptrs),
                        indices=np.concatenate(indices_all).astype(np.int32),
                        data=np.concatenate(data_all), n_cols=col_off)
        spec = ExecSpec(dispatch="sell", vl=m["c"],
                        k_block=moe_k_block(d, m["dtype"]), device=device)
        sw = Stopwatch().start()
        y = ops.moe_dispatch(csr, torch.cat(xs), spec=spec, top_k=top_k)
        if device.type == "cuda":
            torch.cuda.synchronize(device)   # the wall time covers the kernels
        sw.stop()
        self.stats["moe_dispatch_launches"] += 1
        self._count_launch(operand, op="moe_dispatch", wall_us=sw.elapsed_us)
        for req, (lo, hi) in zip(good, spans):
            req.result = y[lo:hi]
