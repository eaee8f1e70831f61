"""Mixture-of-Experts: token-choice top-k routing with capacity dispatch —
port of ``repro.models.moe``.

Tokens are routed within fixed-size groups: router logits, a float32
softmax, the top-k experts of each token in descending probability, their
weights renormalized; each assignment's rank within its expert comes from
a cumulative sum over the group's flattened (token, k) order, and an
assignment past the expert's capacity ``int(g * k / e * capacity_factor)
+ 1`` is dropped.  DeepSeekMoE-style shared experts (an always-on SwiGLU
of width ``n_shared * d_ff``) and the load-balance aux loss come with it.

Two execution paths share the routing math, as in the reference:

* **dense** — the one-hot dispatch and combine einsums, then the experts'
  SwiGLU over all E x cap slots (batched ``torch.einsum`` products; the
  reference computes them outside any Pallas kernel too);
* **SELL** — the combine ``out = C @ eout`` is an SpMM with at most
  ``top_k`` entries a row: the routing is packed on the host into the
  (tokens x slots) CSR :func:`_sell_routing` builds, the slot gather is an
  exact ``index_select``, and the combine runs through
  :func:`repro_torch.kernels.ops.moe_dispatch` (kernel B1) or through the
  ``submit`` hook :func:`sell_dispatch` scopes (the fused engine's kernel
  service).  On a CUDA tensor the combine launches B1 or raises.

``ExecSpec.dispatch`` selects the path (``"dense"`` / ``"sell"`` /
``"auto"``).  The host pack needs concrete activations: the reference
keeps ``"auto"`` dense under a JAX tracer.  PyTorch runs eagerly, so its
counterpart of a tracer is CUDA-graph capture or ``torch.compile``
(:func:`_under_capture`): there ``"auto"`` runs dense and ``"sell"``
raises; everywhere else ``"auto"`` runs SELL.  A forward that records a
graph (a train step) is treated as capture too, as the reference's jitted
train step is: kernel B1 has no backward in either package, so ``"auto"``
runs dense and ``"sell"`` raises.  ``spec=None`` outside a
:func:`sell_dispatch` scope is dense.

Each SELL combine reads the routing back from the device once
(:func:`_routing_to_host`, counted in :data:`ROUTING_READS`): the
reference's design, a host-side pack.

On a mesh (:func:`moe_forward_tp`) the router, the routing and the
capacity run on the data replica's lead device (one host read of the
routing a layer and replica, as without a mesh), and so do the dispatch
and the combine: the dense einsums, or kernel B1 through
``ops.moe_dispatch`` or the fused engine's ``submit``, unchanged.  The
experts run over the replica's model devices as the reference's partition
rules place them (:func:`_ep_ok`): expert-parallel where the model axis
divides E (each device its slice of E on its slice of the slot
activations, the slices joined on the lead), else tensor-parallel inside
each expert (``experts_gate`` / ``experts_up`` split along f,
``experts_down`` along f, the partial expert outputs summed on the lead).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch
from torch import nn
from torch.nn import functional as Fn

from repro_torch.compat import MeshContext, current_mesh_context
from repro_torch.kernels import ops
from repro_torch.kernels.execspec import ExecSpec
from repro_torch.models import sharding as shrd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, he_init, param, swiglu, swiglu_tp
from repro_torch.sparse.formats import CSRMatrix

__all__ = ["DISPATCH_MODES", "GROUP", "MoE", "SELL_SPEC", "init_moe_params",
           "moe_forward", "moe_forward_tp", "sell_dispatch"]

#: tokens per routing group (memory knob for the dispatch one-hots)
GROUP = 2048

#: legal values of ``ExecSpec.dispatch`` for the MoE combine
DISPATCH_MODES = ("dense", "sell", "auto")

#: default spec of the SELL dispatch path: C=32 keeps slice padding low for
#: decode-sized routing groups
SELL_SPEC = ExecSpec(dispatch="auto", vl=32)

#: scoped dispatch override installed by :func:`sell_dispatch` — ``spec``
#: selects the path, ``submit`` (optional) routes the combine SpMM through a
#: serving layer (the :class:`repro_torch.service.service.KernelService`
#: hookup)
_ACTIVE: dict = {"spec": None, "submit": None}

#: host reads of the routing, one a SELL combine (the host-side pack)
ROUTING_READS = 0


@contextlib.contextmanager
def sell_dispatch(spec: ExecSpec | None = None, submit=None):
    """Route MoE combines in this scope through the SELL dispatch path.

    ``spec`` defaults to :data:`SELL_SPEC` (``dispatch="auto"``).
    ``submit``, when given, is called as ``submit(routing_csr, x_stack)``
    with the packed routing (:class:`~repro_torch.sparse.formats.CSRMatrix`)
    and the ``(slots, d)`` expert-output tensor as it is, on its device,
    and must return the ``(tokens, d)`` combine result — the hook
    :class:`repro_torch.serve.engine.ServeEngine` uses to coalesce MoE
    launches with kernel traffic on the shared service loop.
    """
    prev = dict(_ACTIVE)
    _ACTIVE["spec"] = spec if spec is not None else SELL_SPEC
    _ACTIVE["submit"] = submit
    try:
        yield
    finally:
        _ACTIVE.clear()
        _ACTIVE.update(prev)


def _under_capture() -> bool:
    """PyTorch's counterpart of a JAX tracer: a CUDA-graph capture or a
    ``torch.compile`` trace, where no value may be read back to the host."""
    if torch.compiler.is_compiling():
        return True
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _dispatch_mode(spec: ExecSpec | None, graph: bool = False) -> str:
    """Resolve the effective path ("dense" | "sell"); ``graph``: the
    forward records a graph for a gradient."""
    if spec is None:
        return "dense"
    mode = spec.dispatch
    if mode not in DISPATCH_MODES:
        raise ValueError(
            f"unknown dispatch {mode!r}: expected one of {DISPATCH_MODES}")
    if mode == "dense":
        return "dense"
    if graph:
        if mode == "sell":
            raise ValueError(
                "dispatch='sell' under a gradient: kernel B1 (the SELL "
                "combine) has no backward; use dispatch='auto', which runs "
                "the dense path when the forward records a graph")
        return "dense"           # auto: dense under a gradient
    if _under_capture():
        if mode == "sell":
            raise ValueError(
                "dispatch='sell' needs concrete activations: host-side SELL "
                "packing cannot run under CUDA-graph capture or "
                "torch.compile; use dispatch='auto' to fall back to the "
                "dense path there")
        return "dense"           # auto: dense under capture
    return "sell"


class MoE(nn.Module):
    """One MoE layer's weights, the reference's names and layouts:
    ``router`` (d, E), ``experts_gate`` / ``experts_up`` (E, d, f),
    ``experts_down`` (E, f, d) and, where the config has shared experts,
    ``shared`` (an :class:`MLP` of width ``n_shared * f``)."""

    def __init__(self, router: torch.Tensor, experts_gate: torch.Tensor,
                 experts_up: torch.Tensor, experts_down: torch.Tensor,
                 shared: MLP | None = None):
        super().__init__()
        self.router = param(router)
        self.experts_gate = param(experts_gate)
        self.experts_up = param(experts_up)
        self.experts_down = param(experts_down)
        self.shared = shared


def init_moe_params(gen: torch.Generator, cfg: ModelConfig) -> MoE:
    """Random init on the generator's device, the reference's scheme."""
    m = cfg.moe
    d, f = cfg.d_model, cfg.d_ff
    router = he_init(gen, (d, m.n_experts))
    gate = he_init(gen, (m.n_experts, d, f))
    up = he_init(gen, (m.n_experts, d, f))
    down = he_init(gen, (m.n_experts, f, d), fan_in=f)
    shared = None
    if m.n_shared:
        fs = m.n_shared * f
        shared = MLP(he_init(gen, (d, fs)), he_init(gen, (d, fs)),
                     he_init(gen, (fs, d), fan_in=fs))
    return MoE(router, gate, up, down, shared)


def router_probs(router: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
    """Router logits in the activations' dtype, softmax in float32:
    (b, ng, g, d) -> (b, ng, g, E)."""
    logits = torch.einsum("bngd,de->bnge", xg, router.float().to(xg.dtype))
    return torch.softmax(logits.float(), dim=-1)


def _experts(ein: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
             down: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU over their slots: (b, ng, e, cap, d) ->
    (b, ng, e, cap, d)."""
    dt = ein.dtype
    h_gate = torch.einsum("bnecd,edf->bnecf", ein, gate.to(dt))
    h_up = torch.einsum("bnecd,edf->bnecf", ein, up.to(dt))
    h = Fn.silu(h_gate) * h_up
    return torch.einsum("bnecf,efd->bnecd", h, down.to(dt))


def moe_forward(p: MoE, cfg: ModelConfig, x: torch.Tensor, *,
                spec: ExecSpec | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d).  Returns (out, aux_loss).

    ``spec`` selects the dispatch path (see the module docstring); when
    omitted the :func:`sell_dispatch` scope applies, and with neither the
    dense path runs.
    """
    shared = None
    if cfg.moe.n_shared:
        sh = p.shared
        shared = lambda xg: swiglu(xg, sh.w_gate.to(x.dtype), sh.w_up.to(x.dtype),
                                   sh.w_down.to(x.dtype))
    graph = torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in p.parameters()))
    experts = functools.partial(_experts, gate=p.experts_gate,
                                up=p.experts_up, down=p.experts_down)
    return _moe(p.router, experts, shared, cfg, x, spec, graph)


def _ep_ok(n_experts: int, ctx=None) -> bool:
    """Expert-parallel iff the model axis divides the expert count."""
    ctx = current_mesh_context() if ctx is None else MeshContext.of(ctx)
    if not ctx.has_axis(shrd.TP):
        return True
    return n_experts % ctx.axis_size(shrd.TP) == 0


def _experts_tp(p: shrd.PlacedParams, row: shrd.Row,
                ein: torch.Tensor) -> torch.Tensor:
    """:func:`_experts` over a data replica's model devices, as the
    partition rules placed the expert weights: expert-parallel (each device
    its slice of E and of ``ein``, joined on the lead), in-expert
    tensor-parallel (f split, partial outputs summed on the lead), or
    replicated (on the lead)."""
    names = ("experts_gate", "experts_up", "experts_down")
    split = p["experts_gate"].tp_dim()
    pieces = list(zip(row.devices, *(row.pieces(p[n]) for n in names)))
    if split is None:
        return _experts(ein, *pieces[0][1:])
    if _ep_ok(p["experts_gate"].shape[0], p.mesh):
        e_dev = p["experts_gate"].shape[0] // row.size
        parts = [_experts(ein[:, :, m * e_dev:(m + 1) * e_dev].to(dev), *w)
                 for m, (dev, *w) in enumerate(pieces)]
        return shrd.cat_on(parts, ein.device, dim=2)
    parts = [_experts(ein.to(dev), *w) for dev, *w in pieces]
    return shrd.sum_on(parts, ein.device)


def moe_forward_tp(p: shrd.PlacedParams, cfg: ModelConfig, x: torch.Tensor,
                   row: shrd.Row, *, spec: ExecSpec | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_forward` over the model devices of a data replica
    (``row``; ``p``: the layer's placed weights; ``x`` on the replica's
    lead, where the routing, dispatch and combine run)."""
    shared = None
    if cfg.moe.n_shared:
        shared = functools.partial(swiglu_tp, p=p.sub("shared"), row=row)
    # under a gradient the combine runs dense, as off the mesh
    graph = torch.is_grad_enabled() and (x.requires_grad or any(
        t.requires_grad for _, leaf in p.named_leaves() for t in leaf.pieces.flat))
    return _moe(row.pieces(p["router"])[0],
                functools.partial(_experts_tp, p, row), shared, cfg, x, spec,
                graph)


def _moe(router: torch.Tensor, experts, shared, cfg: ModelConfig,
         x: torch.Tensor, spec: ExecSpec | None, graph: bool
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The routing, dispatch, ``experts(ein) -> eout``, combine and
    ``shared(xg)`` of one MoE layer; ``graph``: the forward records a
    graph for a gradient."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    g = min(GROUP, s)
    ng = s // g if s % g == 0 else 1
    if s % g != 0:
        g = s
    xg = x.reshape(b, ng, g, d)

    probs = router_probs(router, xg)                                  # (b,ng,g,e)
    top_w, top_i = torch.topk(probs, k, dim=-1, sorted=True)          # descending
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # capacity positions: rank of each assignment within its expert
    onehot = Fn.one_hot(top_i, e).float()                             # (b,ng,g,k,e)
    flat = onehot.reshape(b, ng, g * k, e)
    pos = (torch.cumsum(flat, dim=2) - flat).reshape(b, ng, g, k, e)
    cap = int(g * k / e * m.capacity_factor) + 1
    keep = (pos < cap) & (onehot > 0)
    slot = torch.where(keep, pos, 0).to(torch.int32)

    spec = spec if spec is not None else _ACTIVE["spec"]
    if _dispatch_mode(spec, graph) == "sell":
        ein, combine_csr = _sell_routing(
            xg, *_routing_to_host(top_i, top_w, keep, slot), cap=cap, e=e)
    else:
        combine_csr = None
        # dispatch/combine one-hots: (b, ng, g, e, cap)
        slot_oh = Fn.one_hot(slot.long(), cap).to(x.dtype) \
            * keep[..., None].to(x.dtype)
        dispatch = slot_oh.sum(dim=3)                                 # over k
        combine = torch.einsum("bngke,bngkec,bngk->bngec", onehot.to(x.dtype),
                               slot_oh, top_w.to(x.dtype))
        ein = torch.einsum("bngec,bngd->bnecd", dispatch, xg)         # (b,ng,e,cap,d)

    eout = experts(ein)

    if combine_csr is not None:
        out = _sell_combine(combine_csr, eout, spec, top_k=k)
        out = out.reshape(b, ng, g, d)
    else:
        out = torch.einsum("bngec,bnecd->bngd", combine, eout)

    if shared is not None:
        out = out + shared(xg)

    # load-balance aux: E * sum_e(frac_tokens_e * mean_prob_e) over the
    # kept (token, k) assignments of each (b, ng, e)
    frac = keep.sum(dim=(2, 3)).to(x.dtype) / (g * k)                 # (b,ng,e)
    mean_p = probs.mean(dim=2)                                        # (b,ng,e)
    aux = e * torch.mean(torch.sum(frac.float() * mean_p, dim=-1))
    return out.reshape(b, s, d), aux


def _routing_to_host(top_i, top_w, keep, slot):
    """The routing the host pack needs, in one read back from the device:
    per (b, ng, g, k) assignment its expert, renormalized weight (float32
    values, exact in float64), keep flag and capacity slot.  ``keep`` and
    ``slot`` are (b, ng, g, k, e) with at most one live expert per
    assignment (its top-k expert), so each reduces over e exactly."""
    global ROUTING_READS
    packed = torch.stack([top_i.double(), top_w.double(),
                          keep.any(dim=-1).double(),
                          slot.sum(dim=-1).double()]).cpu().numpy()
    ROUTING_READS += 1
    return (packed[0].astype(np.int64), packed[1], packed[2] > 0,
            packed[3].astype(np.int64))


#: the activation dtypes the SELL combine takes, as the routing CSR's values
_ROUTING_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _routing_dtype(dtype: torch.dtype):
    """The numpy dtype of the combine CSR's values for ``dtype``
    activations; any dtype but float32 / float64 is refused."""
    if dtype not in _ROUTING_DTYPES:
        raise ValueError(f"the SELL combine takes float32 or float64 "
                         f"activations, got {dtype}")
    return _ROUTING_DTYPES[dtype]


def _sell_routing(xg: torch.Tensor, top_i: np.ndarray, top_w: np.ndarray,
                  kept: np.ndarray, slot: np.ndarray, *, cap: int, e: int):
    """Host-side routing pack: exact slot gather + combine CSR.

    ``top_i`` / ``top_w`` / ``kept`` / ``slot`` are the (b, ng, g, k)
    assignments on the host (:func:`_routing_to_host`).  Returns ``(ein,
    combine_csr)``: ``ein`` the ``(b, ng, e, cap, d)`` slot activations
    on ``xg``'s device — each capacity slot holds its token's row of ``xg``
    verbatim (an index gather, the empty slots zero) — and ``combine_csr``
    the (tokens x slots) routing matrix with the renormalized router
    weights as values, rows in token order and each row's entries in (k)
    order, ready for the SELL SpMM combine.
    """
    vals_dtype = _routing_dtype(xg.dtype)
    b, ng, g, d = xg.shape
    n_tok = b * ng * g
    n_slots = b * ng * e * cap
    bi, ni, gi, ki = np.nonzero(kept)
    ei = top_i[bi, ni, gi, ki]
    sv = slot[bi, ni, gi, ki]
    tok = (bi * ng + ni) * g + gi
    slot_flat = ((bi * ng + ni) * e + ei) * cap + sv
    w = top_w[bi, ni, gi, ki]

    # gather direction: slot -> token index (each slot filled at most once)
    slot_tok = np.full(n_slots, -1, np.int64)
    slot_tok[slot_flat] = tok
    st = torch.from_numpy(slot_tok).to(xg.device)
    gathered = xg.reshape(n_tok, d).index_select(0, st.clamp(min=0))
    ein = torch.where((st >= 0)[:, None], gathered, 0).reshape(b, ng, e, cap, d)

    # combine direction: token rows, slot columns, top-k weights as values
    order = np.argsort(tok, kind="stable")
    counts = np.bincount(tok, minlength=n_tok)
    indptr = np.concatenate(([0], np.cumsum(counts))).astype(np.int64)
    csr = CSRMatrix(
        indptr=indptr,
        indices=slot_flat[order].astype(np.int32),
        data=w[order].astype(vals_dtype),
        n_cols=n_slots,
    )
    return ein, csr


def _sell_combine(csr: CSRMatrix, eout: torch.Tensor, spec: ExecSpec, *,
                  top_k: int) -> torch.Tensor:
    """Run the combine SpMM ``out = C @ eout`` on the SELL core — directly
    through :func:`repro_torch.kernels.ops.moe_dispatch` on ``eout``'s
    device, or through the scoped ``submit`` hook when a serving layer owns
    the launch.  A ``spec`` naming another device than the activations'
    is refused."""
    x = eout.reshape(-1, eout.shape[-1])
    submit = _ACTIVE["submit"]
    if submit is not None:
        return torch.as_tensor(submit(csr, x), device=x.device)
    if spec.device is None:
        spec = dataclasses.replace(spec, device=str(x.device))
    elif torch.device(spec.device).type != x.device.type:
        raise ValueError(f"spec.device {spec.device!r} is not the "
                         f"activations' device {x.device}")
    return ops.moe_dispatch(csr, x, spec=spec, top_k=top_k)
