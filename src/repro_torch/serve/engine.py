"""Generation engine: prefill + decode loop over the model's cache API —
port of ``repro.serve.engine``.

The model's parameters fix the device: a prompt batch (numpy, host) is
range-checked and uploaded by the first prefill's embedding gather (kernel
B9), a mamba2 chunk-multiple prefill runs the fused scan (kernel B8), an
attention model fills its KV caches, and each decode step feeds the
previous step's argmax, still on the device, back through B9.  PyTorch
runs eagerly, so there is no compiled step to reuse (ROADMAP A20).  Every
family of the model is served; ``generate(extras={"ctx_embeds": ...})``
hands the vision and enc-dec families their stub frontend's output, which
the prefill uploads to the parameters' device and stores in the caches.

**Fused kernel-service mode.**  Constructed with a
:class:`repro_torch.service.service.KernelService` and a registered MoE
dispatch envelope (``moe_operand``), the engine reroutes every MoE combine
through the service's slot loop: each per-step routing matrix is submitted
as a ``moe_dispatch`` request (kernel B1 on the card), with the
expert-output tensor as it is on its device, and the service coalesces
those launches with whatever SpMV / BFS / PageRank / FFT traffic shares the
loop.  The wall time of each generated token, the card synchronized first,
lands in the service metrics registry as the ``latency_us_class_lm_token``
histogram, next to the service's own ``moe_dispatch`` / ``kernel`` request
classes.  :func:`retrieve_context` is the graph-retrieval scenario on the
same loop.

**On a mesh** (``mesh=``, as in the reference) the engine serves every
family tensor-, expert- and data-parallel (``extras={"ctx_embeds": ...}``
split over the data replicas with the prompts): the parameters
must be placed on the mesh (:func:`repro_torch.models.model.init_params`
with ``mesh=``, or :func:`repro_torch.models.sharding.place_params`), the
caches are placed by :func:`repro_torch.launch.specs.cache_shardings`, and
every prefill and decode step runs on the mesh
(:mod:`repro_torch.models.model`), its logits on the mesh's first device.
In fused mode each data replica's MoE combines go to the service from the
replica's lead device, so the service's registry must live there: a
registry on another device is refused with ``ValueError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models import moe as moe_mod
from repro_torch.models import sharding as shrd
from repro_torch.models.config import ModelConfig
from repro_torch.obs import Stopwatch

__all__ = ["GenerationConfig", "ServeEngine", "retrieve_context",
           "sample_token"]


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0      # 0 = greedy
    top_k: int = 0                # 0 = no truncation
    eos_id: int = -1              # -1 = never stop early
    cache_len: int = 4096
    dtype: Any = torch.float32


def sample_token(logits: torch.Tensor, gen: torch.Generator | None,
                 gcfg: GenerationConfig) -> torch.Tensor:
    """logits: (B, V) -> (B,) int64 on the logits' device.  Greedy at
    temperature 0; otherwise a categorical draw from ``gen`` (on the
    logits' device) over the temperature-scaled, top-k-truncated logits."""
    if gcfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / gcfg.temperature
    if gcfg.top_k:
        kth = torch.topk(logits, gcfg.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: M.LM, gcfg: GenerationConfig,
                 mesh=None, kernel_service=None, moe_operand: str | None = None,
                 dispatch_spec=None):
        """``mesh`` (a :class:`~repro_torch.compat.Mesh` or MeshContext,
        optional) is the mesh every prefill and decode step runs on; the
        parameters must be placed on it.

        ``kernel_service`` + ``moe_operand`` (a name registered via
        :meth:`repro_torch.service.registry.KernelRegistry.register_moe`)
        switch the engine into fused mode: MoE combines ride the service's
        slot loop as ``moe_dispatch`` requests instead of launching inline.
        ``dispatch_spec`` (an :class:`~repro_torch.kernels.execspec.ExecSpec`)
        attaches to those submissions — requests only coalesce when their
        specs agree — and selects the dispatch path (``None``: ``"auto"``).
        """
        if kernel_service is not None and moe_operand is None:
            raise ValueError(
                "fused mode needs moe_operand: the registered dispatch "
                "envelope the MoE submissions execute against")
        self.mesh = M.params_mesh(params, cfg, mesh)
        if self.mesh is not None:
            if kernel_service is not None:
                _check_service_device(kernel_service, self.mesh)
        self.cfg = cfg
        self.params = params
        self.gcfg = gcfg
        self.kernel_service = kernel_service
        self.moe_operand = moe_operand
        self.dispatch_spec = dispatch_spec

    @property
    def fused(self) -> bool:
        return self.kernel_service is not None

    def _submit_moe(self, csr, x: torch.Tensor) -> torch.Tensor:
        """The :func:`repro_torch.models.moe.sell_dispatch` submit hook: one
        per-step routing matrix and the expert-output tensor (on its
        device, not copied to the host) in, the combined activations out.
        Submits to the shared service and steps the loop until the result
        lands — each step is a coalescing round where this request can
        share a launch with queued kernel traffic."""
        from repro_torch.service.service import SubmitRequest

        return _serve_one(self.kernel_service, SubmitRequest(
            op="moe_dispatch", operand=self.moe_operand,
            payload={"indptr": csr.indptr, "indices": csr.indices,
                     "data": csr.data, "x": x},
            spec=self.dispatch_spec))

    def generate(self, prompts: np.ndarray, extras: dict | None = None,
                 seed: int = 0) -> np.ndarray:
        """Greedy/sampled continuation for a (B, S) prompt batch; returns
        (B, n_new) int32 on the host.  ``extras`` joins the prefill's batch
        (``{"ctx_embeds": (B, T, d_ctx)}`` for the vision and enc-dec
        families).  In fused mode every MoE combine of the generation rides
        the kernel service's slot loop."""
        if self.fused:
            with moe_mod.sell_dispatch(spec=self.dispatch_spec,
                                       submit=self._submit_moe):
                return self._generate(prompts, extras, seed)
        return self._generate(prompts, extras, seed)

    def _generate(self, prompts: np.ndarray, extras: dict | None,
                  seed: int) -> np.ndarray:
        cfg, gcfg = self.cfg, self.gcfg
        dev = self.params.device
        b = prompts.shape[0]
        tok_hist = None
        if self.fused:
            tok_hist = self.kernel_service.metrics.histogram(
                "latency_us_class_lm_token",
                "wall time per generated token (LM serving class)")

        def observe(sw: Stopwatch) -> None:
            if tok_hist is not None:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)   # the token is computed
                tok_hist.observe(sw.stop().elapsed_us)

        caches = M.init_caches(cfg, b, max_len=gcfg.cache_len, dtype=gcfg.dtype,
                               device=dev, mesh=self.mesh)
        batch = {"tokens": np.asarray(prompts)}
        if extras:
            batch.update(extras)
        sw = Stopwatch().start()
        logits, caches = M.prefill(self.params, cfg, batch, caches,
                                   dtype=gcfg.dtype, mesh=self.mesh)
        gen = torch.Generator(device=dev).manual_seed(seed)
        tok = sample_token(logits[:, -1], gen, gcfg)
        observe(sw)
        out = [tok]
        done = tok == gcfg.eos_id
        for _ in range(1, gcfg.max_new_tokens):
            sw = Stopwatch().start()
            logits, caches = M.decode_step(self.params, cfg, tok[:, None], caches,
                                           dtype=gcfg.dtype, mesh=self.mesh)
            tok = sample_token(logits, gen, gcfg)
            observe(sw)
            tok = torch.where(done, gcfg.eos_id, tok)
            out.append(tok)
            done = done | (tok == gcfg.eos_id)
            if gcfg.eos_id >= 0 and bool(done.all()):
                break
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()


def _check_service_device(service, mesh) -> None:
    """A fused engine on a mesh: every data replica's lead device (where
    its MoE combines run) must be the service's registry device."""
    dev = service.registry.device
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    leads = {row.lead for row in shrd.rows(mesh)}
    if leads != {dev}:
        raise ValueError(
            f"a fused engine on a mesh needs the service's registry on the "
            f"replicas' lead device; the registry is on {dev}, the leads are "
            f"{sorted(str(d) for d in leads)}")


def retrieve_context(service, operand: str, n_ctx: int, *,
                     damping: float = 0.85, iters: int = 8) -> np.ndarray:
    """Graph-retrieval scenario: PageRank over a registered user graph,
    returning the ``n_ctx`` highest-ranked node ids (int64, on the host) —
    the per-request context a caller prepends to its ``generate`` prompts.
    The PageRank request rides the same service loop as the MoE and kernel
    traffic, so retrieval coalesces with everything else in flight."""
    from repro_torch.service.service import SubmitRequest

    rank = _serve_one(service, SubmitRequest(
        op="pagerank", operand=operand,
        params={"damping": damping, "iters": iters}))
    return np.argsort(rank.cpu().numpy())[::-1][:n_ctx].copy()


def _serve_one(service, req):
    """Submit ``req`` (stepping the loop while the queue is full), step
    until its result lands, release it and return the result."""
    # the service imports the serving package's slot loop: import it here
    from repro_torch.service.service import QueueFull

    while True:
        try:
            rid = service.submit(req)
            break
        except QueueFull:
            service.step()              # drain one round, then retry
    while (result := service.poll(rid)) is None:
        service.step()
    service.release(rid)
    return result
