"""Parity of the port's training over a (data, model) mesh and of the SSM
family on a mesh (``repro_torch.models.sharding``, ``.models.ssm``
``ssm_forward_tp``, ``.launch.specs.state_shardings``, ``.optim`` and
``.train`` on placed state, ``.launch.train --mesh``) with the JAX
reference, on the CPU.

The port runs on meshes naming the CPU N times (``("cpu",) * N``), every
kernel through its plain version.  The reference's GSPMD never changes a
result, so its step without a mesh is the oracle of the port's step with
one.  Tolerances:

* against the reference (its weights moved over, float32 in both):
  ``tests/test_torch_train.py``'s: the loss 1e-5 relative, each gradient
  1e-4 x max|g| of its leaf, the grad norm 1e-5 relative;
* against the port unsharded: float64 for the dense and MoE families,
  gradients 1e-10 x max|g| with one data replica; with several, 1e-6: the
  loss and its softmax are float32 in both packages
  (``softmax_cross_entropy``), and the mesh's token-weighted sum of the
  replicas' means rounds there in another order.  mamba2 in float32: its
  scan takes float32 B / C whatever the parameters' dtype, so 1e-5 x
  max|g|.  AdamW on the mesh applied to the unsharded step's gradients
  1e-6 x max|p| of the unsharded update; the parameters after whole
  float64 steps 1e-6 x max(1, max|p|) (AdamW's moments and update are
  float32 in both packages).  (A float32 step's parameters are not held
  to each other: AdamW's first step is g / (|g| + eps), so a gradient
  element near 0 whose sign the rounding turns moves its parameter by 2
  lr.);
* every piece of a block ``torch.equal`` to the block's first after a
  step; a mesh checkpoint restored on one device (and the other way round)
  ``torch.equal``.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.launch import specs as ref_specs
from repro.models import layers as ref_layers
from repro.models import model as RM
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import CompressionState as RefCompressionState
from repro.optim.adamw import global_norm as ref_global_norm
from repro.train import TrainConfig as RefTrainConfig
from repro.train import init_train_state as ref_init_train_state
from repro.train.step import TrainState as RefTrainState
from repro_torch import configs
from repro_torch.compat import make_mesh
from repro_torch.data import DataConfig
from repro_torch.kernels import gather
from repro_torch.launch import specs
from repro_torch.launch import train as cli
from repro_torch.models import convert, sharding, ssm
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_reference
from repro_torch.optim import (AdamWConfig, CompressionState, adamw_init,
                               adamw_update, compress_tree, decay_mask,
                               decompress_tree, global_norm)
from repro_torch.serve import Batcher, GenerationConfig, Request, ServeEngine
from repro_torch.train import (TrainConfig, TrainLoopConfig, TrainState,
                               init_train_state, make_train_step, train_loop)
from repro_torch.train.step import loss_and_grads

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
TOL64 = 1e-10
#: several data replicas: the float32 loss weighting's rounding
TOL_DATA = 1e-6
#: mamba2 against the port unsharded (float32 scan inputs)
TOL_SSM = 1e-5
PARAM_TOL = 1e-6
LOGIT_TOL = 1e-5
MESHES = ((1, 2), (2, 1), (2, 2), (1, 4))
#: (arch, meshes): mixtral's 4 experts on an 8-way model axis are split
#: inside each expert (in-expert tensor parallel), on 2 and 4 devices
#: expert-parallel
STEP_CASES = [(a, m) for a in ("mamba2-2.7b", "qwen2-1.5b", "llama3.2-3b",
                               "deepseek-moe-16b", "mixtral-8x7b")
              for m in MESHES] + [("mixtral-8x7b", (1, 8))]
#: the families a mesh admits
MESH_ARCHS = ("llama3.2-3b", "qwen2-1.5b", "qwen3-14b", "minicpm-2b",
              "mixtral-8x7b", "deepseek-moe-16b", "mamba2-2.7b")
SEQ = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tiny tensors (the workers of
    a parallel test run share the cores), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(shape, axes=("data", "model")):
    return make_mesh(shape, axes, ("cpu",) * math.prod(shape))


def _ref_leaf(tree, name):
    keys, idx = convert.reference_path(name)
    for k in keys:
        tree = tree[k]
    return np.asarray(tree)[idx] if idx else np.asarray(tree)


def _batch(vocab, b=4, s=SEQ, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[:, -1] = -1
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": labels}


def _blocks_agree(x: sharding.Sharded) -> bool:
    return all(torch.equal(x.pieces[g[0]], x.pieces[c])
               for g in sharding.groups(x) for c in g)


def _rel(a, b, floor: float = 1e-30) -> float:
    """max|a - b| over max(``floor``, max|b|)."""
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max()) / max(float(b.abs().max()), floor)


# ---------------------------------------------------------------------------
# The reference's step and the port's unsharded one, once an arch
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stepped():
    """``stepped(arch)``: the reduced arch's reference weights (float32
    numpy), the batch, the reference's loss, gradients and their global
    norm (the grad norm its ``make_train_step`` reports), and the port's
    unsharded gradients, their norm and the parameters AdamW makes of
    them (float64 for the dense and MoE families, float32 for mamba2)."""
    built = {}

    def get(arch):
        if arch not in built:
            cfg, tcfg = ref_configs.reduced_config(arch), configs.reduced_config(arch)
            jp = RM.init_params(jax.random.PRNGKey(1), cfg)
            tree = jax.tree_util.tree_map(np.asarray, jp)
            batch = _batch(cfg.vocab_size)
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            ref_tc = RefTrainConfig(optimizer=RefAdamWConfig(lr=1e-3), remat=None,
                                    dtype=jnp.float32)

            def ref_loss(params):
                logits, aux = RM.forward(params, cfg, jb, dtype=jnp.float32)
                loss, _ = ref_layers.softmax_cross_entropy(logits, jb["labels"])
                return loss + ref_tc.aux_weight * aux, loss
            (_, loss), grads = jax.jit(jax.value_and_grad(ref_loss,
                                                          has_aux=True))(jp)
            dt = torch.float32 if cfg.family == "ssm" else torch.float64
            tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3), remat=None, dtype=dt)
            lm = params_from_reference(tree, tcfg, "cpu", trainable=True).to(dt)
            g_one, l_one, _ = loss_and_grads(lm, tcfg, tc, batch)
            # the unsharded update of exactly these gradients
            named = {k: p.detach().clone() for k, p in lm.named_parameters()}
            om = adamw_update(g_one, adamw_init(named), named, tc.optimizer,
                              decay=decay_mask(named))[2]
            built[arch] = dict(
                cfg=tcfg, tree=tree, batch=batch, dt=dt, tc=tc,
                ref_loss=float(loss),
                ref_norm=float(ref_global_norm(grads)),
                ref_grads=jax.tree_util.tree_map(np.asarray, grads),
                grads=g_one, loss=float(l_one), norm=float(om["grad_norm"]),
                params=named)
        return built[arch]
    return get


@pytest.mark.parametrize("arch,shape", STEP_CASES)
def test_mesh_step_matches_reference_and_unsharded(stepped, arch, shape):
    """One step on a mesh, the reference's weights placed by the partition
    rules: float32 loss, gradients and grad norm (the global norm a train
    step reports, each block once) against the reference's
    ``value_and_grad``; then, in the unsharded run's dtype, the gradients
    and their norm against the port unsharded, and AdamW on the mesh's
    ZeRO-1 blocks given the unsharded gradients against the unsharded
    update, every block's pieces equal after it."""
    s = stepped(arch)
    cfg, mesh = s["cfg"], _cpu_mesh(shape)
    tc32 = TrainConfig(optimizer=AdamWConfig(lr=1e-3), remat=None)
    placed = sharding.place_params(params_from_reference(
        s["tree"], cfg, "cpu", trainable=True), cfg, mesh)
    grads, loss, _ = loss_and_grads(placed, cfg, tc32, s["batch"])
    assert float(loss) == pytest.approx(s["ref_loss"], rel=LOSS_RTOL)
    for k, g in grads.items():
        want = _ref_leaf(s["ref_grads"], k)
        tol = GRAD_TOL * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g.full().numpy(), want, rtol=0, atol=tol,
                                   err_msg=k)
    assert float(global_norm(grads)) == pytest.approx(s["ref_norm"], rel=LOSS_RTOL)

    lm = params_from_reference(s["tree"], cfg, "cpu", trainable=True).to(s["dt"])
    placed = sharding.place_params(lm, cfg, mesh)
    grads, loss, _ = loss_and_grads(placed, cfg, s["tc"], s["batch"])
    tol = TOL_SSM if cfg.family == "ssm" else TOL64 if shape[0] == 1 else TOL_DATA
    for k, g in grads.items():
        assert _rel(g.full(), s["grads"][k]) <= tol, k
    assert float(global_norm(grads)) == pytest.approx(s["norm"], rel=LOSS_RTOL)
    state = init_train_state(None, cfg, s["tc"], params=placed)
    grads = {k: sharding.place(s["grads"][k], state.opt["m"][k].spec, mesh)
             for k in s["grads"]}
    adamw_update(grads, state.opt, placed, s["tc"].optimizer)
    for k, leaf in placed.items():
        assert _rel(leaf.full(), s["params"][k]) <= PARAM_TOL, k
        assert _blocks_agree(leaf), k
    for name in ("m", "v"):
        assert all(_blocks_agree(x) for x in state.opt[name].values())


def test_remat_on_a_mesh_changes_no_gradient(stepped):
    """``remat`` wraps each placed block (``run_blocks_tp``): "full" and
    "dots" give the gradients of None, and "dots" hands the forward's
    un-batched products back to the recompute instead of running them
    again."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Products(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in (torch.ops.aten.mm.default,
                               torch.ops.aten.addmm.default)
            return func(*args, **(kwargs or {}))

    s = stepped("deepseek-moe-16b")
    cfg, mesh = s["cfg"], _cpu_mesh((2, 2))
    placed = sharding.place_params(params_from_reference(
        s["tree"], cfg, "cpu", trainable=True).double(), cfg, mesh)
    base, _, _ = loss_and_grads(placed, cfg, s["tc"], s["batch"])
    ran = {}
    for remat in ("full", "dots"):
        tc = TrainConfig(remat=remat, dtype=torch.float64)
        with Products() as count:
            got, _, _ = loss_and_grads(placed, cfg, tc, s["batch"])
        ran[remat] = count.n
        for k in base:
            assert _rel(got[k].full(), base[k].full()) <= 1e-12, (remat, k)
    assert 0 < ran["dots"] < ran["full"], ran


@pytest.mark.parametrize("compress", [False, True])
def test_loss_and_grads_then_adamw_update_on_zero1_state(stepped, compress):
    """A step composed of the public pieces on a (2, 2) mesh:
    ``loss_and_grads`` reduces each gradient by its parameter's spec, and
    ``adamw_update`` (after ``compress_tree`` / ``decompress_tree``) cuts
    it to the moments' ZeRO-1 blocks; the parameters, moments and
    residuals ``torch.equal`` to ``make_train_step``'s (its reduce-scatter
    sums the same rows in the same order).  Without clipping: the float32
    global norm sums the blocks of each spec in its own order, so a
    clipped step differs in the last bits of its scale."""
    s = stepped("qwen2-1.5b")
    cfg, mesh = s["cfg"], _cpu_mesh((2, 2))
    tc = dataclasses.replace(
        s["tc"], compress_grads=compress,
        optimizer=dataclasses.replace(s["tc"].optimizer, clip_norm=0.0))

    def fresh():
        placed = sharding.place_params(params_from_reference(
            s["tree"], cfg, "cpu", trainable=True).to(s["dt"]), cfg, mesh)
        return init_train_state(None, cfg, tc, params=placed)

    hand, want = fresh(), fresh()
    want, _ = make_train_step(cfg, tc)(want, s["batch"])
    grads, _, _ = loss_and_grads(hand.params, cfg, tc, s["batch"])
    assert any(grads[k].spec != hand.opt["m"][k].spec for k in grads)
    comp = None
    if compress:
        q, scales, comp = compress_tree(grads, hand.comp)
        grads = decompress_tree(q, scales, n_replicas=1)
    adamw_update(grads, hand.opt, hand.params, tc.optimizer)
    for k, leaf in hand.params.items():
        assert torch.equal(leaf.full(), want.params[k].full()), k
        assert _blocks_agree(leaf), k
        for name in ("m", "v"):
            assert torch.equal(hand.opt[name][k].full(),
                               want.opt[name][k].full()), (name, k)
        if compress:
            assert torch.equal(comp.error[k].full(), want.comp.error[k].full()), k


# ---------------------------------------------------------------------------
# State placement: state_shardings and ZeRO-1
# ---------------------------------------------------------------------------


class _Spec:
    """The reference's NamedSharding stood in by its PartitionSpec."""

    def __init__(self, mesh, spec):
        self.spec = spec


class _Duck:
    empty = False

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


def _meta_randn(shape, generator=None, dtype=None, device=None, **kw):
    return torch.empty(shape, dtype=dtype or torch.float32, device="meta")


def _node(tree, name):
    for k in name.split("."):
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def full_states():
    """``full_states(arch)``: at the published widths, the port's LM (meta
    tensors for every draw), the reference's state of the same per-layer
    leaves, and the reference's own abstract state (bf16 parameters with a
    master, int8 compression), built once an arch."""
    built = {}

    def get(arch):
        if arch not in built:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(torch, "randn", _meta_randn)
                port = M.init_params(M.make_generator(0, "cpu"),
                                     configs.get_config(arch))
            tree = {}
            for name, p in port.named_parameters():
                node, parts = tree, name.split(".")
                for k in parts[:-1]:
                    node = node.setdefault(k, {})
                node[parts[-1]] = jax.ShapeDtypeStruct(tuple(p.shape), jnp.float32)
            sds = jax.ShapeDtypeStruct((), jnp.int32)
            per_layer = RefTrainState(tree, {"m": tree, "v": tree, "step": sds,
                                             "master": tree},
                                      RefCompressionState(error=tree), sds)
            abstract = jax.eval_shape(lambda k: ref_init_train_state(
                k, ref_configs.get_config(arch),
                RefTrainConfig(param_dtype=jnp.bfloat16, compress_grads=True)),
                jax.random.PRNGKey(0))
            built[arch] = (port, per_layer, abstract)
        return built[arch]
    return get


@pytest.mark.parametrize("data,model", [(2, 4), (4, 2), (1, 8)])
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_state_shardings_match_reference(full_states, arch, data, model,
                                         monkeypatch):
    """The port's ``state_shardings`` at the published widths (params,
    ``m``, ``v``, ``master``, the compression ``error``, the steps) equal
    the reference's ``state_shardings`` leaf by leaf on the same leaves
    (the port's per-layer tree); on the reference's own abstract state
    (its layers stacked) the unstacked leaves and the steps agree too."""
    monkeypatch.setattr(ref_specs, "NamedSharding", _Spec)
    port, ref_state, abstract = full_states(arch)
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    duck = _Duck({"data": data, "model": model})
    state = TrainState(port, {"m": {}, "v": {}, "step": 0, "master": {}},
                       CompressionState(error={}), 0)
    got = specs.state_shardings(_cpu_mesh((data, model)), cfg, state)
    want = ref_specs.state_shardings(duck, ref_cfg, ref_state)
    assert tuple(want.step.spec) == got.step == () == got.opt["step"]
    for name, _ in port.named_parameters():
        assert got.params[name] == tuple(_node(want.params, name).spec), name
        for part in ("m", "v", "master"):
            assert got.opt[part][name] == tuple(_node(want.opt[part], name).spec), \
                (part, name)
        assert got.comp.error[name] == tuple(_node(want.comp.error, name).spec)
    stacked = ref_specs.state_shardings(duck, ref_cfg, abstract)
    for name, _ in port.named_parameters():
        if convert.reference_path(name)[1]:
            continue                     # a stacked layer: its own rule there
        for ref, port_spec in ((stacked.params, got.params),
                               (stacked.opt["m"], got.opt["m"]),
                               (stacked.opt["master"], got.opt["master"]),
                               (stacked.comp.error, got.comp.error)):
            assert port_spec[name] == tuple(_node(ref, name).spec), name


@pytest.mark.parametrize("shape", [(2, 1), (2, 2), (4, 2)])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "qwen2-1.5b"])
def test_zero1_moments_follow_zero1_specs(arch, shape):
    """Born-sharded state on a mesh: each moment (and master) piece is the
    block ``zero1_specs`` gives its device; a device holds 1 / data of the
    moment bytes it would hold without ZeRO-1 on every leaf ZeRO-1 splits
    (and the same bytes on the others); after a step every block's pieces
    are equal in the parameters, moments and master."""
    cfg = configs.reduced_config(arch)
    mesh = _cpu_mesh(shape)
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3), remat=None,
                     param_dtype=torch.bfloat16)
    state = init_train_state(M.make_generator(0, "cpu"), cfg, tc, mesh=mesh)
    p_specs = specs.param_shardings(mesh, cfg, state.params)
    z_specs = sharding.zero1_specs(state.params, p_specs, shape[0])
    split = 0
    for coord in np.ndindex(shape):
        held = without = 0
        for k, leaf in state.params.items():
            m = state.opt["m"][k]
            assert m.spec == sharding.canonical(z_specs[k] + (None,) * (
                len(leaf.shape) - len(z_specs[k]))), k
            region = m.region(coord)
            want = tuple(r.stop - r.start for r in region)
            for part in (m, state.opt["v"][k], state.opt["master"][k]):
                assert tuple(part.pieces[coord].shape) == want, k
                assert part.pieces[coord].dtype == torch.float32
            assert leaf.pieces[coord].dtype == torch.bfloat16
            n_dp = shape[0] if "data" in sharding._used(m.spec) else 1
            split += n_dp > 1
            held += m.pieces[coord].numel() * 4
            without += leaf.pieces[coord].numel() * 4 // n_dp
        assert held == without
    assert split > 0
    state, _ = make_train_step(cfg, tc)(state, _batch(cfg.vocab_size, b=8))
    for k, leaf in state.params.items():
        for x in (leaf, state.opt["m"][k], state.opt["v"][k],
                  state.opt["master"][k]):
            assert _blocks_agree(x), k


def test_born_sharded_trainable_init(arch="mamba2-2.7b"):
    """``init_params(mesh=, trainable=True)``: every piece a leaf that
    requires grad, ``torch.equal`` to ``place_params`` of the unsharded
    init; the reduced mamba2's in_proj (280 columns) and conv (144
    channels) split over 4 devices across the z / x / B / C / dt
    boundaries."""
    cfg = configs.reduced_config(arch)
    mesh = _cpu_mesh((2, 4))
    born = M.init_params(M.make_generator(3, "cpu"), cfg, mesh=mesh, trainable=True)
    want = sharding.place_params(M.init_params(M.make_generator(3, "cpu"), cfg),
                                 cfg, mesh)
    assert sorted(dict(born.items())) == sorted(dict(want.items()))
    for k, a in born.items():
        b = want[k]
        assert a.spec == b.spec, k
        for pa, pb in zip(a.pieces.flat, b.pieces.flat):
            assert pa.is_leaf and pa.requires_grad and torch.equal(pa, pb), k
    assert born["blocks.0.ssm.in_proj"].pieces[0, 1].shape == (64, 70)
    assert born["blocks.0.ssm.conv_w"].pieces[0, 3].shape == (36, 4)


# ---------------------------------------------------------------------------
# The loss across replicas, training modes, the loop and the CLI
# ---------------------------------------------------------------------------


def test_loss_weights_replicas_by_their_token_counts():
    """Replicas with uneven valid-label counts (one with none at all): the
    mesh's loss and gradients are the unsharded token mean's, not the mean
    of the replicas' means."""
    cfg = configs.reduced_config("qwen2-1.5b")
    lm = M.init_params(M.make_generator(0, "cpu"), cfg, trainable=True).double()
    tc = TrainConfig(remat=None, dtype=torch.float64)
    batch = _batch(cfg.vocab_size, b=6)
    batch["labels"][2:4, :12] = -1           # replica 1 of 3: 6 labels
    batch["labels"][4:] = -1                 # replica 2: none
    want, wl, _ = loss_and_grads(lm, cfg, tc, batch)
    mesh = _cpu_mesh((3, 1))
    got, gl, _ = loss_and_grads(sharding.place_params(lm, cfg, mesh), cfg, tc,
                                batch)
    assert float(gl) == pytest.approx(float(wl), rel=1e-6)
    means = [float(loss_and_grads(lm, cfg, tc, {k: v[r:r + 2] for k, v in
                                                batch.items()})[1])
             for r in (0, 2, 4)]
    assert abs(np.mean(means) - float(wl)) > 1e-2
    for k in want:
        assert _rel(got[k].full(), want[k]) <= TOL_DATA, k


@pytest.mark.parametrize("mode,shape", [("accum", (2, 2)), ("compress", (1, 2)),
                                        ("bf16", (1, 2))])
def test_training_modes_on_a_mesh(mode, shape):
    """``accum_steps = 2`` (each replica's share split: one step against
    the unsharded step on the batch's rows reordered so that its leading
    split gives the same microbatches), ``compress_grads`` (the int8 scale
    over all of a leaf's blocks, two steps: the residuals carry) and bf16
    parameters over a float32 master, float64 activations: the loss, grad
    norm, the parameters and the compression residuals against the
    unsharded step.  bf16: a weight that several model devices read whole
    (llama's one kv head on two devices) has its gradient rounded to bf16
    once a read, so the grad norm agrees to 1e-4; AdamW's first step is g
    / (|g| + eps), so where such a rounding turns a small g's sign the
    master moves by 2 lr: it agrees to 1e-6 x max(1, max|p|) on 99% of
    each leaf and within 2 lr (and the decay) everywhere, and every
    parameter piece is its master's bf16 cast."""
    cfg = configs.reduced_config("llama3.2-3b")
    kw = {"accum": dict(accum_steps=2), "compress": dict(compress_grads=True),
          "bf16": dict(param_dtype=torch.bfloat16)}[mode]
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3), remat=None,
                     dtype=torch.float64, **kw)
    mesh = _cpu_mesh(shape)
    lm = M.init_params(M.make_generator(0, "cpu"), cfg, trainable=True)
    if mode != "bf16":
        lm = lm.double()
    placed = init_train_state(None, cfg, tc,
                              params=sharding.place_params(lm, cfg, mesh))
    one = init_train_state(None, cfg, tc, params=lm)
    step = make_train_step(cfg, tc)
    # replica r's share is rows [4 r, 4 r + 4), microbatch i its rows
    # [4 r + 2 i, 4 r + 2 i + 2): the unsharded leading split of this order
    order = [0, 1, 4, 5, 2, 3, 6, 7] if mode == "accum" else list(range(8))
    for i in range(2 if mode == "compress" else 1):
        batch = _batch(cfg.vocab_size, b=8, seed=i)
        one, m1 = step(one, {k: v[order] for k, v in batch.items()})
        placed, m2 = step(placed, batch)
        assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
        assert float(m2["grad_norm"]) == pytest.approx(
            float(m1["grad_norm"]), rel=1e-4 if mode == "bf16" else 1e-6)
    for k, p in one.params.named_parameters():
        got = placed.params[k].full()
        if mode == "bf16":
            master, want = placed.opt["master"][k], one.opt["master"][k]
            diff = (master.full() - want).abs()
            scale = max(1.0, float(want.abs().max()))
            assert float((diff > PARAM_TOL * scale).float().mean()) <= 0.01, k
            assert float(diff.max()) <= 2.1e-3, k
            for c in np.ndindex(shape):
                rel = sharding.refine_slices(master, placed.params[k], c)
                assert torch.equal(placed.params[k].pieces[c][rel],
                                   master.pieces[c].to(torch.bfloat16)), k
        else:
            assert _rel(got, p, 1.0) <= PARAM_TOL, k
        if mode == "compress":
            assert _rel(placed.comp.error[k].full(), one.comp.error[k]) <= 1e-6, k
            assert _blocks_agree(placed.comp.error[k])


def _loop(tmp_path, name, mesh=None, steps=4, **kw):
    cfg = configs.reduced_config("mamba2-2.7b")
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3), remat=None)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=4)
    lc = TrainLoopConfig(total_steps=steps, ckpt_every=2, log_every=100,
                         ckpt_dir=str(tmp_path / name))
    return train_loop(cfg, tc, dc, lc, mesh=mesh, device="cpu",
                      log=lambda s: None, **kw)


def test_loop_resumes_on_a_mesh_and_across_placements(tmp_path):
    """``train_loop(mesh=)``: a run crashed at step 3 resumes from its
    step-2 checkpoint and ends equal to the uninterrupted run; the mesh
    checkpoint at step 4 restores on one device (an unsharded loop asked
    for 4 steps ends where it starts) equal to the mesh's parameters and
    moments; a one-device checkpoint restores on the mesh, equal."""
    mesh = _cpu_mesh((2, 2))
    whole, hist = _loop(tmp_path, "mesh", mesh)
    assert [h["step"] for h in hist] == list(range(4))
    assert all(np.isfinite(h["loss"]) for h in hist)
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        _loop(tmp_path, "crash", mesh, fail_at_step=3)
    resumed, hist = _loop(tmp_path, "crash", mesh)
    assert [h["step"] for h in hist] == [2, 3]
    for (k, a), (_, b) in zip(whole.params.items(), resumed.params.items()):
        assert torch.equal(a.full(), b.full()), k
    one, hist = _loop(tmp_path, "mesh", None)
    assert hist == [] and one.step == 4
    for k, p in one.params.named_parameters():
        assert torch.equal(p.detach(), whole.params[k].full()), k
        assert torch.equal(one.opt["v"][k], whole.opt["v"][k].full()), k
    ref_one, _ = _loop(tmp_path, "one", None, steps=2)
    back, hist = _loop(tmp_path, "one", mesh, steps=2)
    assert hist == []
    for k, p in ref_one.params.named_parameters():
        assert torch.equal(back.params[k].full(), p.detach()), k
        assert _blocks_agree(back.params[k]) and _blocks_agree(back.opt["m"][k])


def test_cli_mesh_needs_the_production_mesh_and_other_families_refuse():
    """``launch.train --mesh`` wants the production mesh's 256 / 512 cards
    (``ValueError`` naming the count).  The hybrid, vision and enc-dec
    families, which refused a mesh until ROADMAP A10c's port, are born
    sharded and trainable on one, and the loop trains hymba there (the
    others need ``ctx_embeds``, which the loop's synthetic stream does not
    make; their mesh steps are ``tests/test_torch_mesh_families.py``'s)."""
    for flag, n in (("single", 256), ("multi", 512)):
        with pytest.raises(ValueError, match=f"needs {n} devices"):
            cli.main(["--device", "cpu", "--mesh", flag])
    for arch in ("hymba-1.5b", "llama-3.2-vision-11b", "seamless-m4t-medium"):
        cfg = configs.reduced_config(arch)
        placed = M.init_params(M.make_generator(0, "cpu"), cfg,
                               mesh=_cpu_mesh((1, 2)), trainable=True)
        assert all(t.requires_grad and t.is_leaf for t in placed.pieces())
        if cfg.hybrid:
            state, hist = train_loop(
                cfg, TrainConfig(remat=None),
                DataConfig(vocab_size=256, seq_len=8, global_batch=2),
                TrainLoopConfig(total_steps=1), mesh=_cpu_mesh((1, 2)),
                log=lambda s: None)
            assert state.step == 1 and np.isfinite(hist[0]["loss"])


# ---------------------------------------------------------------------------
# mamba2 served on a mesh
# ---------------------------------------------------------------------------


N_NEW = 4
CACHE_LEN = 32


@pytest.fixture(scope="module")
def mamba():
    """The reduced mamba2 on the reference's weights: the reference's
    prefill logits of (4, 16) prompts (two chunks) and of their first 13
    tokens (a ragged prefill), its greedy tokens and top-2 margins after
    the 16, and the port's unsharded run."""
    arch = "mamba2-2.7b"
    cfg, tcfg = ref_configs.reduced_config(arch), configs.reduced_config(arch)
    jp = RM.init_params(jax.random.PRNGKey(4), cfg)
    tp = params_from_reference(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                                (4, 16)).astype(np.int32)
    pre = jax.jit(lambda p, b, c: RM.prefill(p, cfg, b, c))
    step = jax.jit(lambda p, t, c: RM.decode_step(p, cfg, t, c))
    out = {}
    for s in (16, 13):
        caches = RM.init_caches(cfg, 4, CACHE_LEN, dtype=jnp.float32)
        logits, caches = pre(jp, {"tokens": jnp.asarray(prompts[:, :s])}, caches)
        last, toks, margins = logits[:, -1], [], []
        for _ in range(N_NEW):
            top2 = np.sort(np.asarray(last), axis=-1)[:, -2:]
            margins.append(top2[:, 1] - top2[:, 0])
            toks.append(np.asarray(jnp.argmax(last, -1)).astype(np.int32))
            last, caches = step(jp, jnp.asarray(toks[-1][:, None]), caches)
        out[s] = (np.asarray(logits), np.stack(toks, 1), np.stack(margins, 1))
    return dict(cfg=tcfg, tp=tp, prompts=prompts, ref=out,
                scale=float(np.abs(out[16][0]).max()))


def _tokens_agree(got, want, margins, scale):
    tol = LOGIT_TOL * max(1.0, scale)
    for r in range(want.shape[0]):
        for c in range(want.shape[1]):
            if margins[r, c] <= tol:
                if got[r, c] != want[r, c]:
                    break
                continue
            assert got[r, c] == want[r, c], (r, c, got[r], want[r])


@pytest.mark.parametrize("shape,scan", [((1, 2), "heads"), ((2, 2), "heads"),
                                        ((1, 4), "heads"), ((1, 8), "heads"),
                                        ((1, 3), "lead")])
def test_mamba2_served_on_a_mesh(mamba, shape, scan):
    """Prefill (a chunk multiple: B8's plain version a head shard; and a
    ragged 13: the recurrence) and decode steps on a mesh: logits against
    the reference's and the port's unsharded caches (gathered); engine and
    batcher tokens (every admission a b = 1 prefill on the replica owning
    its slot, the others copying) against the reference's.  A 3-way model
    axis divides neither the heads nor the projection: the scan runs on
    the lead."""
    cfg, mesh = mamba["cfg"], _cpu_mesh(shape)
    assert (ssm.head_split(cfg, shape[1]) is None) == (scan == "lead")
    placed = sharding.place_params(mamba["tp"], cfg, mesh)
    for s in (16, 13):
        logits_ref, toks_ref, margins = mamba["ref"][s]
        caches = M.init_caches(cfg, 4, CACHE_LEN, dtype=torch.float32, mesh=mesh)
        one = M.init_caches(cfg, 4, CACHE_LEN, dtype=torch.float32, device="cpu")
        logits, caches = M.prefill(placed, cfg, {"tokens": mamba["prompts"][:, :s]},
                                   caches, mesh=mesh)
        _, one = M.prefill(mamba["tp"], cfg, {"tokens": mamba["prompts"][:, :s]},
                           one)
        np.testing.assert_allclose(logits.numpy(), logits_ref, rtol=0,
                                   atol=LOGIT_TOL * max(1.0, mamba["scale"]))
        for g, w in zip(caches["layers"].ssm, one["layers"].ssm):
            np.testing.assert_allclose(g.full().numpy(), w.numpy(), rtol=0,
                                       atol=1e-5 * max(1.0, float(w.abs().max())))
        got = [torch.argmax(logits[:, -1], -1)]
        for _ in range(N_NEW - 1):
            last, caches = M.decode_step(placed, cfg, got[-1][:, None], caches,
                                         mesh=mesh)
            got.append(torch.argmax(last, -1))
        _tokens_agree(torch.stack(got, 1).numpy(), toks_ref, margins,
                      mamba["scale"])
    _, toks_ref, margins = mamba["ref"][16]
    gcfg = GenerationConfig(max_new_tokens=N_NEW, cache_len=CACHE_LEN)
    got = ServeEngine(cfg, placed, gcfg, mesh=mesh).generate(mamba["prompts"])
    _tokens_agree(got, toks_ref, margins, mamba["scale"])
    b = Batcher(cfg, placed, n_slots=4, gcfg=gcfg, mesh=mesh)
    for rid in range(6):
        b.submit(Request(rid=rid, prompt=mamba["prompts"][rid % 4],
                         max_new_tokens=N_NEW))
    done = {r.rid: r.generated for r in b.run()}
    assert sorted(done) == list(range(6))
    for rid, toks in done.items():
        r = rid % 4
        _tokens_agree(np.asarray([toks]), toks_ref[r:r + 1], margins[r:r + 1],
                      mamba["scale"])


@pytest.mark.parametrize("d_model,groups,shape,scan", [
    (64, 2, (1, 2), "heads"), (64, 2, (1, 4), "heads"), (64, 4, (1, 8), "heads"),
    (96, 3, (1, 2), "lead")])
def test_ssm_head_shards_with_several_groups(d_model, groups, shape, scan):
    """B / C groups per head shard: a device's heads holding whole groups
    or lying inside one; 12 heads in 3 groups on 2 devices cut each other,
    so the scan runs on the lead over the gathered state pieces.  The
    gradients, and the logits and states of a prefill and a decode step,
    against the port unsharded (float32 scan inputs)."""
    import dataclasses

    base = configs.reduced_config("mamba2-2.7b")
    cfg = dataclasses.replace(base, d_model=d_model, ssm=dataclasses.replace(
        base.ssm, n_groups=groups))
    lm = M.init_params(M.make_generator(2, "cpu"), cfg, trainable=True)
    mesh = _cpu_mesh(shape)
    tc = TrainConfig(remat=None)
    batch = _batch(cfg.vocab_size)
    want, wl, _ = loss_and_grads(lm, cfg, tc, batch)
    placed = sharding.place_params(lm, cfg, mesh)
    got, gl, _ = loss_and_grads(placed, cfg, tc, batch)
    assert (ssm.head_split(cfg, shape[1]) is None) == (scan == "lead")
    assert float(gl) == pytest.approx(float(wl), rel=1e-6)
    for k in want:
        assert _rel(got[k].full(), want[k]) <= TOL_SSM, k
    one = M.init_caches(cfg, 4, CACHE_LEN, dtype=torch.float32, device="cpu")
    caches = M.init_caches(cfg, 4, CACHE_LEN, dtype=torch.float32, mesh=mesh)
    with torch.no_grad():
        for tokens in (batch["tokens"], batch["tokens"][:, :1]):
            w, one = M.prefill(lm, cfg, {"tokens": tokens}, one)
            g, caches = M.prefill(placed, cfg, {"tokens": tokens}, caches,
                                  mesh=mesh)
            assert _rel(g, w) <= TOL_SSM
            for a, b in zip(caches["layers"].ssm, one["layers"].ssm):
                assert _rel(a.full(), b) <= TOL_SSM


# ---------------------------------------------------------------------------
# Kernel B9's shard backward (its plain version; the kernel in
# tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n_shards", [1, 2, 4, 5])
def test_gather_shard_backward_matches_reference_grad(n_shards, id_dtype):
    """The shard backward's plain version against ``jax.grad`` of the
    reference's gather masked to the shard, ids outside ``[0, V)`` as a
    card holds them and repeated ids among them; the shards' gradients
    stacked in model order equal the whole-table backward; the autograd
    Function gives the shard's ``.grad``."""
    v, d = 40, 6
    rng = np.random.default_rng(n_shards)
    ids_np = np.concatenate([rng.integers(0, v, 30), [0, 0, v - 1, v, v + 9, -1,
                                                      -v, -v - 4, 7, 7]])
    ids = torch.tensor(ids_np, dtype=id_dtype)
    dout = torch.from_numpy(rng.standard_normal((len(ids_np), d)))
    table = jnp.asarray(rng.standard_normal((v, d)))
    rows_jax = jnp.asarray(gather.clamp_ids(ids, v).numpy())
    want = np.asarray(jax.grad(lambda t: jnp.sum(t[rows_jax] * jnp.asarray(
        dout.numpy())))(table))
    rows = v // n_shards
    parts = [gather.embedding_gather_shard_bwd(dout, ids, k * rows, rows, v)
             for k in range(n_shards)]
    for k, part in enumerate(parts):
        np.testing.assert_allclose(part.numpy(), want[k * rows:(k + 1) * rows],
                                   rtol=0, atol=1e-12)
    assert torch.equal(torch.cat(parts), gather.embedding_gather_bwd(dout, ids, v))
    shard = torch.tensor(np.asarray(table)[rows:2 * rows] if n_shards > 1
                         else np.asarray(table)).requires_grad_(True)
    lo = rows if n_shards > 1 else 0
    host = torch.from_numpy(rng.integers(0, v, 12))
    out = gather.embedding_gather_shard(shard, host, lo, v)
    (out * dout[:12]).sum().backward()
    assert torch.equal(shard.grad, gather.embedding_gather_shard_bwd_ref(
        dout[:12], host, lo, shard.shape[0], v))


def test_gather_shard_backward_plan_and_refusals():
    """One launch over the shard's stripes; a window outside the
    vocabulary refused by the plan, before any launch."""
    plan = gather._bwd_plan(50280, 2560, 1024, torch.float32, torch.int64,
                            (12570, 12570))[0]
    assert plan.ok and plan.kernel == "embedding_gather_shard_bwd"
    assert plan.n_launches == 1
    assert plan.blocks[0].operands[2] == ("dtable", (12570, 2560), "float32")
    bad = gather._bwd_plan(100, 8, 4, torch.float32, torch.int32, (90, 20))[0]
    assert not bad.ok and "outside the vocabulary" in bad.violations[0]
