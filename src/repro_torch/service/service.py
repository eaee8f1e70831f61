"""Request-driven execution engine for the port's sparse kernels.

The port of ``repro.service.service`` for SpMV traffic
(``OPS = ("spmv",)``; BFS, PageRank, FFT and MoE dispatch follow with
their kernels).  :class:`KernelService` has the reference's async
submit/poll shape: ``submit`` preflights and enqueues and returns a request
id, ``poll`` reports a result when one exists, and ``step``/``run``/
``drain`` advance the scheduler — the slot-based admission loop of
:class:`repro_torch.serve.slots.SlotLoop`.

Coalescing: all active requests against the same registered operand (and
the same spec) form one group per scheduling round, and the group's x
vectors become the RHS columns of ONE
:func:`repro_torch.kernels.sell_core.spmm_sell` call — one launch of the
CUDA kernel per width bucket.  Results stay on the registry's device.

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
from repro_torch.analysis.preflight import plan_spmm_sell
from repro_torch.kernels import sell_core
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
from repro_torch.service.registry import KernelRegistry, RegisteredOperand
from repro_torch.sparse.formats import pow2_ceil

OPS = ("spmv",)

#: request class of each op for the per-class latency histograms
OP_CLASS = {op: "kernel" for op in OPS}

#: FROZEN contract: the exact key set of ``KernelService.stats`` — the
#: reference's, key for key (counters of paths the port does not run yet
#: stay 0).  These
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
    payload: Any = None         # x vector (numpy or torch)
    params: dict = dataclasses.field(default_factory=dict)
    spec: ExecSpec | None = None


@dataclasses.dataclass
class KernelRequest:
    rid: int
    op: str                     # one of OPS
    operand: str                # registry name
    payload: Any = None         # x vector (numpy or torch)
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
        default-spec key, so legacy submits coalesce exactly as before)."""
        spec = self.spec if self.spec is not None else _DEFAULT_SPEC
        return (self.op, self.operand, spec.coalesce_key())


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
                self._preflight(op, record)      # ... infeasible launches
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
    def _operand_plans(self, record: RegisteredOperand) -> dict[str, LaunchPlan]:
        """Live launch plans for every op this operand can serve, derived
        from the *current* tuned tiles: a tune that drifts out of the
        kernel's envelope after registration is caught at the next submit."""
        plans: dict[str, LaunchPlan] = {}
        if record.kind == "matrix" and record.slab_meta is not None:
            tuned = record.tuned
            plans["spmv"] = plan_spmm_sell(
                record.slab_meta, k=max(1, tuned.k_block),
                x_dtype=record.slab_meta.val_dtype, k_block=tuned.k_block)
        return plans

    def _preflight(self, op: str, record: RegisteredOperand) -> None:
        """Admission-time launch-contract check: an operand whose plan
        violates a contract is rejected HERE with a structured
        :class:`LaunchPlanError` — no kernel launch, nothing queued."""
        plan = self._operand_plans(record).get(op)
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
        for (op, operand, _speckey), reqs in groups.items():
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
