"""Placement specs for a model's batch, parameters and decode caches on a
mesh — the placement half of ``repro.launch.specs``.

Each ``*_shardings`` function returns the tree of its input with a spec at
every leaf (a tuple of axis names or ``None``, one entry a dim: see
:mod:`repro_torch.models.sharding`); the leaves may be tensors or anything
with a ``shape``.

The dry run's stand-ins (:mod:`repro_torch.launch.dryrun`), the
counterparts of the reference's ``ShapeDtypeStruct`` trees and
``jax.eval_shape``: :func:`input_specs` / :func:`input_specs_for` give a
cell's batch, :func:`abstract_params`, :func:`abstract_train_state` and
:func:`abstract_caches` run the port's own ``init_params``,
``init_train_state`` and ``init_caches``, all as fake tensors
(``torch._subclasses.fake_tensor``: shapes, dtypes and devices, no
storage; the active fake mode's, else a fresh one's).  The random draws
come from a CPU generator (no card is touched); with ``mesh`` every leaf
is placed by :func:`param_shardings` / :func:`state_shardings` /
:func:`cache_shardings` on the mesh's devices, without one on ``device``.
The batch lies on the host, as the port's entry points take it.

The reference's two opt-in flags, off by default as there:
:data:`KV_SEQ_SHARD` puts a KV cache's context axis over ``model`` where
the kv heads do not divide it (each device then holds C / model of the
ring's slots, :func:`repro_torch.models.attention.attention_tp`);
:data:`FSDP_PARAMS` adds ZeRO-1's split over ``data`` to the parameters'
specs (each device then holds 1 / data of its model block, gathered
before each use, :meth:`repro_torch.models.sharding.Sharded.local`).
Placement reads them too: :func:`param_shardings` is what
:func:`repro_torch.models.sharding.place_params` and
:func:`repro_torch.models.model.init_params` place by.

:func:`state_shardings` is the reference's rule on the port's leaves:
parameters tensor-parallel, the moments (and any master copy and
compression residual) tensor-parallel plus ZeRO-1 over ``data``.  The
reference stacks a block's layers into one leaf, so its ZeRO-1 takes the
layer axis where ``data`` divides it; the port's layers are leaves of
their own, so the same rule takes each layer's first dim.
"""
from __future__ import annotations

import contextlib

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from repro_torch import configs
from repro_torch.compat import MeshContext
from repro_torch.models import sharding as shrd
from repro_torch.models.config import ModelConfig

__all__ = ["FSDP_PARAMS", "KV_SEQ_SHARD", "PLACEHOLDER", "abstract_caches",
           "abstract_params", "abstract_train_state", "batch_shardings",
           "cache_shardings", "convert_params", "fake_mode", "input_specs", "input_specs_for",
           "moment_shardings", "param_shardings", "state_shardings"]

#: The device an unsharded abstract tree lies on: one placeholder host
#: device.
PLACEHOLDER = torch.device("cpu", 0)

#: Shard the KV cache's context axis over the model axis where the kv heads
#: do not divide it (flash-decode style).  Off by default.
KV_SEQ_SHARD: bool = False

#: Shard the parameters over the data axis too, by ZeRO-1's rule
#: (:func:`~repro_torch.models.sharding.zero1_specs`).  Off by default.
FSDP_PARAMS: bool = False


def _dp_axes(mesh) -> tuple[str, ...]:
    ctx = MeshContext.of(mesh)
    return tuple(a for a in shrd.DATA if ctx.has_axis(a))


def _dp_size(mesh) -> int:
    return MeshContext.of(mesh).axis_size(_dp_axes(mesh))


def batch_shardings(mesh, batch: dict, batch_size: int) -> dict:
    """Batch dim over (pod, data) when divisible, else replicated."""
    dp = _dp_axes(mesh)
    dp = dp if batch_size % max(_dp_size(mesh), 1) == 0 else ()

    def spec(leaf):
        return shrd.canonical((dp,) + (None,) * (len(leaf.shape) - 1))
    return {k: spec(v) for k, v in batch.items()}


def param_shardings(mesh, cfg: ModelConfig, params) -> dict[str, tuple]:
    """Parameter name -> spec: the TP / EP partition rules, plus ZeRO-1's
    split over ``data`` under :data:`FSDP_PARAMS` where the mesh has that
    axis."""
    ctx = MeshContext.of(mesh)
    specs = shrd.model_param_specs(cfg, params, mesh)
    if FSDP_PARAMS and ctx.has_axis("data"):
        specs = shrd.zero1_specs(params, specs, ctx.axis_size("data"))
    return specs


def moment_shardings(mesh, cfg: ModelConfig, params,
                     zero1: bool = True) -> dict[str, tuple]:
    """Parameter name -> the spec of its optimizer state (moments, master,
    compression residual): :func:`param_shardings` plus ZeRO-1 over
    ``data`` (:func:`~repro_torch.models.sharding.zero1_specs`) where the
    mesh has that axis and ``zero1``."""
    ctx = MeshContext.of(mesh)
    specs = param_shardings(mesh, cfg, params)
    if zero1 and ctx.has_axis("data"):
        specs = shrd.zero1_specs(params, specs, ctx.axis_size("data"))
    return specs


def state_shardings(mesh, cfg: ModelConfig, state, zero1: bool = True):
    """The train state's specs, a state of the same type (``params``,
    ``opt``, ``comp``, ``step``): parameters by :func:`param_shardings`;
    ``m``, ``v``, any ``master`` and the compression ``error`` by
    :func:`moment_shardings`; the step counts replicated.  ``state``'s
    parameters may be an LM, placed parameters or a mapping of names to
    shaped values."""
    p_specs = param_shardings(mesh, cfg, state.params)
    m_specs = moment_shardings(mesh, cfg, state.params, zero1)
    opt = {"m": m_specs, "v": m_specs, "step": ()}
    if "master" in state.opt:
        opt["master"] = m_specs
    comp = None if state.comp is None else type(state.comp)(error=m_specs)
    return type(state)(params=p_specs, opt=opt, comp=comp, step=())


def cache_shardings(mesh, cfg: ModelConfig, caches, batch_size: int):
    """Decode caches: batch over (pod, data) when divisible; kv heads / ssm
    channels over model (under :data:`KV_SEQ_SHARD`, where the kv heads do
    not divide it, the context axis instead); ring ``pos`` / scalars
    replicated."""
    ctx = MeshContext.of(mesh)
    dp = _dp_axes(mesh)
    dp = dp if batch_size % max(_dp_size(mesh), 1) == 0 else ()
    dp_or_none = dp if dp else None
    model = "model" if ctx.has_axis("model") else None

    def spec_for(leaf) -> tuple:
        shape = tuple(leaf.shape)
        nd = len(shape)
        # KV k/v: (..., B, C, Hkv, dh) ; ssm state: (..., B, h, p, n)
        # conv ring: (..., B, k-1, channels) ; pos: (..., C) ; length: (...)
        if nd >= 4 and shape[-1] > 1 and shape[-2] > 1:
            lead = nd - 4
            if shape[-2] == cfg.n_kv_heads and cfg.n_kv_heads:
                heads_ok = cfg.n_kv_heads % max(ctx.axis_size("model"), 1) == 0
                if KV_SEQ_SHARD and not heads_ok:
                    return (None,) * lead + (dp_or_none, model, None, None)
                head_ax = model if heads_ok else None
                return (None,) * lead + (dp_or_none, None, head_ax, None)
            if cfg.ssm and shape[-1] == cfg.ssm.d_state and shape[-2] == cfg.ssm.head_dim:
                return (None,) * lead + (dp_or_none, model, None, None)
        if nd >= 3 and cfg.ssm and shape[-1] == cfg.d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.d_state:
            return (None,) * (nd - 3) + (dp_or_none, None, model)
        if nd >= 3 and shape[-1] == cfg.d_model:     # memory/ctx (B, T, d)
            return (None,) * (nd - 3) + (dp_or_none, None, None)
        return ()

    def checked(leaf) -> tuple:
        spec = spec_for(leaf)
        parts = spec + (None,) * (len(leaf.shape) - len(spec))
        return shrd.canonical(
            a if a and leaf.shape[i] % ctx.axis_size(a) == 0 else None
            for i, a in enumerate(parts))

    return shrd.tree_map(checked, caches)


# ---------------------------------------------------------------------------
# The dry run's stand-ins (fake tensors: no storage)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_mode():
    """The active fake-tensor mode, else a fresh one entered for the
    block (host data may meet its fake tensors)."""
    active = [m for m in _get_current_dispatch_mode_stack()
              if isinstance(m, FakeTensorMode)]
    if active:
        yield active[-1]
        return
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        yield mode


def _ctx_spec(cfg: ModelConfig, batch: int) -> tuple | None:
    """(shape, dtype) of the stub frontend's context: vision patch
    embeddings (B, n_ctx_tokens, d_ctx) or enc-dec frames (B,
    n_ctx_tokens, d_model), bf16; None for the other families."""
    if cfg.cross_attn is not None and cfg.cross_attn.every:
        d_ctx = cfg.cross_attn.d_ctx or cfg.d_model
        return (batch, cfg.cross_attn.n_ctx_tokens, d_ctx), torch.bfloat16
    if cfg.encdec is not None:
        return (batch, cfg.encdec.n_ctx_tokens, cfg.d_model), torch.bfloat16
    return None


def input_specs(arch: str, shape_name: str) -> dict:
    """The batch of one cell (tokens / labels / ctx_embeds) as fake host
    tensors."""
    return input_specs_for(configs.get_config(arch), shape_name)


def input_specs_for(cfg: ModelConfig, shape_name: str) -> dict:
    """``tokens`` (and ``labels`` for train) int32 (b, s), (b, 1) for
    decode; ``ctx_embeds`` for the vision and enc-dec families except at
    decode: fake tensors on the host."""
    sh = configs.SHAPES[shape_name]
    b = sh.global_batch
    s = 1 if sh.kind == "decode" else sh.seq_len
    with fake_mode():
        batch = {"tokens": torch.empty((b, s), dtype=torch.int32)}
        if sh.kind == "train":
            batch["labels"] = torch.empty((b, s), dtype=torch.int32)
        ctx = _ctx_spec(cfg, b)
        if ctx is not None and sh.kind != "decode":
            batch["ctx_embeds"] = torch.empty(ctx[0], dtype=ctx[1])
    return batch


def abstract_params(cfg: ModelConfig, mesh=None, *, device=PLACEHOLDER,
                    trainable: bool = False):
    """``init_params`` as fake tensors: an LM on ``device``, or born sharded
    on ``mesh`` (:func:`param_shardings`)."""
    from repro_torch.models import model as M   # the model imports this module

    gen = torch.Generator(device="cpu")            # fake draws: no value
    with fake_mode():
        if mesh is not None:
            return M.init_params(gen, cfg, trainable=trainable, mesh=mesh)
        return convert_params(M.init_params(gen, cfg, trainable=trainable),
                              device=device)


def convert_params(params, **to):
    """``params`` cast (``dtype=``) or moved (``device=``, an LM only), real
    or fake: a placed tree piece by piece, an LM's parameters each replaced
    by its ``.to(**to)``, keeping whether it requires grad (``Module.to``
    swaps a fake parameter's body, which its fake mode's weak references
    refuse)."""
    if isinstance(params, shrd.PlacedParams):
        return params.to(**to)
    for mod in params.modules():
        for name, t in mod._parameters.items():
            if t is not None:
                mod._parameters[name] = torch.nn.Parameter(
                    t.detach().to(**to), requires_grad=t.requires_grad)
    return params


def abstract_train_state(cfg: ModelConfig, tcfg, mesh=None, *,
                         device=PLACEHOLDER, zero1: bool = True):
    """``init_train_state`` as fake tensors: on ``device``, or on ``mesh``
    with the optimizer state placed by :func:`state_shardings`' rule (the
    ZeRO-1 split over ``data`` unless ``zero1`` is False)."""
    from repro_torch.train.step import init_train_state

    with fake_mode():
        params = abstract_params(cfg, mesh, device=device, trainable=True)
        return init_train_state(None, cfg, tcfg, params, zero1=zero1)


def abstract_caches(cfg: ModelConfig, batch: int, max_len: int,
                    dtype=torch.bfloat16, mesh=None, *, device=PLACEHOLDER):
    """``init_caches`` as fake tensors: on ``device``, or placed on ``mesh``
    by :func:`cache_shardings`."""
    from repro_torch.models import model as M

    with fake_mode():
        return M.init_caches(cfg, batch, max_len, dtype=dtype, device=device,
                             mesh=mesh)
