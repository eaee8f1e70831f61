"""Parity of the port's model half of multi-device (``repro_torch.compat``,
``repro_torch.launch.mesh``, ``repro_torch.launch.specs``,
``repro_torch.models.sharding`` and the mesh path of the models, the
engine and the batcher) with the JAX reference, on the CPU.

The port runs on meshes naming the CPU N times (``("cpu",) * N``, the
counterpart of the reference's forced host device count), where kernel
B9's vocab-shard form and every other kernel take their plain versions.
The reference's GSPMD never changes a result, so the reference run
without a mesh is the oracle of the port run with one.  Tolerances:

* specs: equal, entry for entry (the reference's ``param_specs`` /
  ``cache_shardings`` take a duck-typed mesh of the same axis sizes);
* the port on a mesh against the port unsharded, float64: 1e-10 x max(1,
  |logit|) (the partial products summed in another order);
* against the reference without a mesh: ``LOGIT_TOL`` x max(1,
  max|reference|), as ``tests/test_torch_lm.py``; greedy tokens equal
  wherever the reference's top-2 margin exceeds that
  (``tests/test_torch_families.py``'s rule);
* B9's shard form: the sum over the shards ``torch.equal`` to the
  whole-table plain gather.
"""
import dataclasses
import math
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.launch import specs as ref_specs
from repro.models import model as RM
from repro.models import sharding as ref_sharding
from repro_torch import configs
from repro_torch.analysis import LaunchPlanError
from repro_torch.compat import (
    NULL_MESH_CONTEXT,
    MeshContext,
    concrete_mesh,
    current_mesh_context,
    make_mesh,
    use_mesh,
)
from repro_torch.kernels import gather
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs
from repro_torch.models import attention, blocks, convert, sharding, ssm
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models.convert import params_from_reference
from repro_torch.runtime.elastic import plan_mesh
from repro_torch.serve import Batcher, GenerationConfig, Request, ServeEngine
from repro_torch.service import KernelRegistry, KernelService

LOGIT_TOL = 1e-5
TOL64 = 1e-10
#: the dense and MoE archs served on a mesh (reduced)
MESH_ARCHS = ("llama3.2-3b", "qwen2-1.5b", "mixtral-8x7b", "deepseek-moe-16b")
#: (data, model) meshes: tensor / expert parallel, data parallel, and a
#: model axis past the reduced heads and experts (in-expert TP, the
#: attention whole on the lead)
MESHES = ((1, 2), (1, 4), (2, 2), (1, 8))
MODEL_SIZES = (1, 2, 4, 8)
CACHE_LEN = 64


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


class _Duck:
    """A mesh the reference's spec functions read: axis names and sizes."""

    empty = False

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


def _axes(model: int, data: int | None) -> dict:
    return {"model": model} if data is None else {"data": data, "model": model}


# ---------------------------------------------------------------------------
# Mesh handles (the reference's tests/test_compat.py cases)
# ---------------------------------------------------------------------------


def test_make_mesh_single_device():
    mesh = make_mesh((1,), ("model",), ("cpu",))
    assert mesh.axis_names == ("model",)
    assert mesh.shape == {"model": 1} and mesh.size == 1
    assert not mesh.empty and mesh.devices.shape == (1,)


def test_mesh_context_queries():
    mesh = _cpu_mesh((1, 1))
    ctx = MeshContext.of(mesh)
    assert not ctx.empty
    assert ctx.axis_names == ("data", "model")
    assert ctx.shape == {"data": 1, "model": 1}
    assert ctx.has_axis("model") and not ctx.has_axis("pod")
    assert ctx.axis_size("model") == 1
    assert ctx.axis_size(None) == 1
    assert ctx.axis_size(("data", "model")) == 1
    assert ctx.axis_size("absent") == 1
    assert MeshContext.of(ctx) is ctx
    big = MeshContext(_cpu_mesh((2, 4)))
    assert big.axis_size(("data", "model")) == 8 and big.axis_size("data") == 2


def test_null_mesh_context():
    ctx = MeshContext(None)
    assert ctx.empty and NULL_MESH_CONTEXT.empty
    assert ctx.axis_names == ()
    assert ctx.shape == {}
    assert ctx.axis_size("model") == 1


def test_use_mesh_scopes_discovery():
    mesh = make_mesh((1,), ("model",), ("cpu",))
    assert current_mesh_context().empty
    with use_mesh(mesh):
        assert current_mesh_context().axis_names == ("model",)
        inner = _cpu_mesh((1, 1))
        with use_mesh(inner):
            assert current_mesh_context().axis_names == ("data", "model")
        assert current_mesh_context().axis_names == ("model",)
    assert current_mesh_context().empty


def test_use_mesh_none_is_inert():
    mesh = make_mesh((1,), ("model",), ("cpu",))
    with use_mesh(mesh):
        with use_mesh(None):  # model-entry default must inherit, not shadow
            assert current_mesh_context().axis_names == ("model",)


def test_use_mesh_survives_exceptions():
    mesh = make_mesh((1,), ("model",), ("cpu",))
    with pytest.raises(RuntimeError, match="boom"):
        with use_mesh(mesh):
            raise RuntimeError("boom")
    assert current_mesh_context().empty


def test_concrete_mesh_is_the_multi_device_mesh():
    one, two = make_mesh((1,), ("model",), ("cpu",)), _cpu_mesh((1, 2))
    assert concrete_mesh(None) is None and concrete_mesh(one) is None
    assert concrete_mesh(two) is two and concrete_mesh(MeshContext(two)) is two


def test_make_mesh_takes_visible_cards_or_refuses(monkeypatch):
    """No fallback: without named devices a mesh takes that many visible
    cards and raises with fewer; named devices may repeat, of one type."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="needs 4 devices but only 0"):
        make_mesh((1, 4), ("data", "model"))
    with pytest.raises(ValueError, match="no CUDA device"):
        make_mesh((2,), ("model",), ("cpu", "cuda:0"))
    with pytest.raises(ValueError, match="needs 4 devices, got 3"):
        make_mesh((2, 2), ("data", "model"), ("cpu",) * 3)
    with pytest.raises(ValueError, match="differ in length"):
        make_mesh((2, 2), ("model",), ("cpu",) * 4)
    mesh = _cpu_mesh((2, 2))
    assert mesh == _cpu_mesh((2, 2)) and mesh != _cpu_mesh((1, 4))
    assert {str(d) for d in mesh.devices.flat} == {"cpu"}


def test_production_mesh_geometry_and_refusal():
    with pytest.raises(ValueError, match="needs 256 devices"):
        mesh_mod.make_production_mesh()
    single = mesh_mod.make_production_mesh(devices=("cpu",) * 256)
    assert single.shape == {"data": 16, "model": 16}
    multi = mesh_mod.make_production_mesh(multi_pod=True, devices=("cpu",) * 512)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    plan = plan_mesh(8)
    m = mesh_mod.make_mesh_from_plan(plan.shape, plan.axis_names, ("cpu",) * 8)
    assert m.shape == dict(zip(plan.axis_names, plan.shape))


# ---------------------------------------------------------------------------
# Specs against the reference's, every arch at its published widths
# ---------------------------------------------------------------------------


def _meta_randn(shape, generator=None, dtype=None, device=None, **kw):
    return torch.empty(shape, dtype=dtype or torch.float32, device="meta")


@pytest.fixture(scope="module")
def full_params():
    """``full_params(arch)``: (reference abstract params, the port's LM with
    meta tensors for every random draw) at the published widths."""
    built = {}

    def get(arch):
        if arch not in built:
            ref = jax.eval_shape(
                lambda k: RM.init_params(k, ref_configs.get_config(arch)),
                jax.random.PRNGKey(0))
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(torch, "randn", _meta_randn)
                port = M.init_params(M.make_generator(0, "cpu"),
                                     configs.get_config(arch))
            built[arch] = (ref, port)
        return built[arch]
    return get


def _ref_leaf(tree, name):
    keys, idx = convert.reference_path(name)
    for k in keys:
        tree = tree[k]
    return tree, len(idx)


@pytest.mark.parametrize("data", [None, 2])
@pytest.mark.parametrize("model", MODEL_SIZES)
@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_param_specs_match_reference(full_params, arch, model, data):
    """Every parameter's spec is the reference's over the leaf's own dims
    (its stacked-layer dims replicated there)."""
    ref_tree, port = full_params(arch)
    cfg = configs.get_config(arch)
    n_exp = cfg.moe.n_experts if cfg.moe else 0
    want = ref_sharding.param_specs(ref_tree, n_experts=n_exp,
                                    model_axis_size=model,
                                    mesh=_Duck(_axes(model, data)))
    mesh = _cpu_mesh(tuple(_axes(model, data).values()),
                     tuple(_axes(model, data)))
    got = sharding.param_specs(port, n_experts=n_exp, model_axis_size=model,
                               mesh=mesh)
    assert list(got) == [n for n, _ in port.named_parameters()]
    for name, spec in got.items():
        ref, n_stacked = _ref_leaf(want, name)
        ref = tuple(ref)
        assert ref[:n_stacked] == (None,) * n_stacked, name
        assert spec == ref[n_stacked:], (name, spec, ref)
    if data is not None and arch in MESH_ARCHS:
        assert specs.param_shardings(mesh, cfg, port) == got


def _per_layer_tree(port):
    """The port's parameters as a reference-style tree of its own shapes
    (one subtree a layer): what the reference's rules see of them."""
    tree = {}
    for name, p in port.named_parameters():
        node, parts = tree, name.split(".")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = jax.ShapeDtypeStruct(tuple(p.shape), jnp.float32)
    return tree


@pytest.mark.parametrize("data", [2, 4])
@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_zero1_specs_match_reference(full_params, arch, data):
    """ZeRO-1 over the data axis: the reference's rule on the same leaves."""
    _, port = full_params(arch)
    cfg = configs.get_config(arch)
    n_exp = cfg.moe.n_experts if cfg.moe else 0
    duck = _Duck({"data": data, "model": 4})
    tree = _per_layer_tree(port)
    ref_p = ref_sharding.param_specs(tree, n_experts=n_exp, model_axis_size=4,
                                     mesh=duck)
    want = ref_sharding.zero1_specs(tree, ref_p, data)
    mesh = _cpu_mesh((data, 4))
    got_p = sharding.param_specs(port, n_experts=n_exp, model_axis_size=4,
                                 mesh=mesh)
    got = sharding.zero1_specs(port, got_p, data)
    for name, spec in got.items():
        node = want
        for k in name.split("."):
            node = node[k]
        assert spec == tuple(node), (name, spec, tuple(node))
        node = ref_p
        for k in name.split("."):
            node = node[k]
        assert got_p[name] == tuple(node), name


class _Spec:
    """The reference's NamedSharding stood in by its spec."""

    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


def _meta_device(device=None):
    return torch.device("meta")


def _cache_pairs(got, want):
    """(port leaf, reference leaf) by cache entry and field."""
    assert sorted(got) == sorted(want)
    out = []
    for key in got:
        g = sharding.tree_leaves(got[key])
        w = jax.tree_util.tree_leaves(want[key],
                                      is_leaf=lambda x: isinstance(x, _Spec))
        assert len(g) == len(w), key
        out += list(zip(g, w))
    return out


@pytest.mark.parametrize("data", [None, 2])
@pytest.mark.parametrize("model", MODEL_SIZES)
@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_cache_shardings_match_reference(arch, model, data, monkeypatch):
    """Every cache leaf's spec is the reference's, at a batch the data axis
    divides (8) and one it does not (1); the ring ``pos`` / ``length``
    replicated."""
    monkeypatch.setattr(ref_specs, "NamedSharding", _Spec)
    for mod in (M, blocks, attention, ssm):
        monkeypatch.setattr(mod, "resolve_device", _meta_device)
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    axes = _axes(model, data)
    mesh = _cpu_mesh(tuple(axes.values()), tuple(axes))
    for batch in (1, 8):
        caches = M.init_caches(cfg, batch, 16)
        want = ref_specs.cache_shardings(
            _Duck(axes), ref_cfg,
            jax.eval_shape(lambda: RM.init_caches(ref_cfg, batch, 16)), batch)
        got = specs.cache_shardings(mesh, cfg, caches, batch)
        for g, w in _cache_pairs(got, want):
            assert g == w.spec, (arch, batch, g, w.spec)


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("axes", [{"model": 4}, {"data": 2, "model": 2},
                                  {"pod": 2, "data": 2, "model": 2}])
def test_batch_shardings_match_reference(axes, batch, monkeypatch):
    monkeypatch.setattr(ref_specs, "NamedSharding", _Spec)
    shapes = {"tokens": (batch, 16), "labels": (batch, 16),
              "ctx_embeds": (batch, 8, 64)}
    want = ref_specs.batch_shardings(
        _Duck(axes), {k: jax.ShapeDtypeStruct(v, jnp.int32)
                      for k, v in shapes.items()}, batch)
    mesh = _cpu_mesh(tuple(axes.values()), tuple(axes))
    got = specs.batch_shardings(
        mesh, {k: types.SimpleNamespace(shape=v) for k, v in shapes.items()},
        batch)
    assert got == {k: w.spec for k, w in want.items()}


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


def test_shard_places_and_gathers_back():
    x = torch.arange(8 * 6, dtype=torch.float64).reshape(8, 6)
    assert sharding.shard(x, "data", "model") is x          # no mesh
    mesh = _cpu_mesh((2, 3))
    with use_mesh(mesh):
        s = sharding.shard(x, ("pod", "data"), "model")
        assert s.spec == ("data", "model")
        assert s.pieces.shape == (2, 3) and s.pieces[1, 2].shape == (4, 2)
        assert torch.equal(s.pieces[1, 2], x[4:, 4:])
        assert torch.equal(s.full(), x)
        # 4 rows on a 3-way axis: dropped, that dim replicates
        y = sharding.shard(x[:, :4], "model", "data")
        assert y.spec == (None, "data") and torch.equal(y.full(), x[:, :4])
        assert sharding.logical("data", ("pod", "model"), None) == \
            ("data", "model", None)
        assert sharding.logical(("data", "model")) == (("data", "model"),)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_born_sharded_init_equals_place_params(arch, shape):
    """``init_params(mesh=)`` draws block after block and places each:
    every piece ``torch.equal`` to ``place_params`` of the whole model, at
    its spec's local shape, with storage of its own."""
    cfg = configs.reduced_config(arch)
    mesh = _cpu_mesh(shape)
    born = M.init_params(M.make_generator(3, "cpu"), cfg, mesh=mesh)
    lm = M.init_params(M.make_generator(3, "cpu"), cfg)
    placed = sharding.place_params(lm, cfg, mesh)
    assert dict(born.named_leaves()).keys() == dict(placed.named_leaves()).keys()
    ptrs = set()
    for name, leaf in born.named_leaves():
        want = placed[name]
        assert leaf.spec == want.spec == specs.param_shardings(mesh, cfg, lm)[name]
        for coord in np.ndindex(mesh.devices.shape):
            got = leaf.pieces[coord]
            local = tuple(d // leaf.block(coord, i)[1]
                          for i, d in enumerate(leaf.shape))
            assert tuple(got.shape) == local, name
            assert got.device == mesh.devices[coord]
            assert torch.equal(got, want.pieces[coord]), (name, coord)
            ptrs.add(got.untyped_storage().data_ptr())
        assert torch.equal(leaf.full(), dict(lm.named_parameters())[name])
    assert len(ptrs) == sum(1 for _ in born.named_leaves()) * mesh.size


# ---------------------------------------------------------------------------
# The mesh path against the port unsharded and the reference
# ---------------------------------------------------------------------------


def _jitted(cfg):
    return (jax.jit(lambda p, b, c: RM.prefill(p, cfg, b, c)),
            jax.jit(lambda p, t, c: RM.decode_step(p, cfg, t, c)))


@pytest.fixture(scope="module")
def served():
    """``served(arch)``: the reduced arch in both packages on the
    reference's weights, and the reference's prefill logits of
    ``prompts`` (4, 12), its decode logits of the greedy token, its greedy
    tokens (``N_NEW`` a prompt) and top-2 margins, built once."""
    built = {}

    def get(arch):
        if arch not in built:
            cfg, tcfg = ref_configs.reduced_config(arch), configs.reduced_config(arch)
            jp = RM.init_params(jax.random.PRNGKey(1), cfg)
            tp = params_from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                       tcfg, "cpu")
            prompts = np.random.default_rng(2).integers(
                0, cfg.vocab_size, (4, 12)).astype(np.int32)
            pre, step = _jitted(cfg)
            caches = RM.init_caches(cfg, 4, CACHE_LEN, dtype=jnp.float32)
            logits, caches = pre(jp, {"tokens": jnp.asarray(prompts)}, caches)
            last, toks, margins = logits[:, -1], [], []
            for i in range(N_NEW):
                top2 = np.sort(np.asarray(last), axis=-1)[:, -2:]
                margins.append(top2[:, 1] - top2[:, 0])
                toks.append(np.asarray(jnp.argmax(last, -1)).astype(np.int32))
                last, caches = step(jp, jnp.asarray(toks[-1][:, None]), caches)
                if i == 0:
                    step1 = np.asarray(last)
            built[arch] = types.SimpleNamespace(
                cfg=tcfg, tp=tp, prompts=prompts, logits=np.asarray(logits),
                step1=step1, tokens=np.stack(toks, 1),
                margins=np.stack(margins, 1),
                scale=float(np.abs(np.asarray(logits)).max()))
        return built[arch]
    return get


N_NEW = 4


def _run(params, cfg, prompts, dtype, mesh=None):
    """Prefill logits and the first decode step's logits (the greedy
    token fed back)."""
    caches = M.init_caches(cfg, prompts.shape[0], CACHE_LEN, dtype=dtype,
                           device="cpu", mesh=mesh)
    logits, caches = M.prefill(params, cfg, {"tokens": prompts}, caches,
                               dtype=dtype, mesh=mesh)
    step, caches = M.decode_step(params, cfg,
                                 torch.argmax(logits[:, -1], -1)[:, None],
                                 caches, dtype=dtype, mesh=mesh)
    return logits, step, caches


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_mesh_logits_match_unsharded_and_reference(served, arch, shape):
    """Prefill and decode logits on a mesh: against the port unsharded in
    float64 (and its caches, gathered), and in float32 against the
    reference without a mesh."""
    s = served(arch)
    mesh = _cpu_mesh(shape)
    lm64 = s.tp.double()
    want_l, want_s, want_c = _run(lm64, s.cfg, s.prompts, torch.float64)
    got_l, got_s, got_c = _run(sharding.place_params(lm64, s.cfg, mesh), s.cfg,
                               s.prompts, torch.float64, mesh)
    _close(got_l, want_l, TOL64)
    _close(got_s, want_s, TOL64)
    for name in want_c:
        for g, w in zip(got_c[name].kv, want_c[name].kv):
            _close(g.full(), w, TOL64)
    lm32 = s.tp.float()
    got_l, got_s, _ = _run(sharding.place_params(lm32, s.cfg, mesh), s.cfg,
                           s.prompts, torch.float32, mesh)
    assert got_l.device == mesh.devices.flat[0] and got_l.dtype == torch.float32
    _close(got_l, s.logits, LOGIT_TOL)
    if np.array_equal(torch.argmax(got_l[:, -1], -1).numpy(), s.tokens[:, 0]):
        _close(got_s, s.step1, LOGIT_TOL)      # the same token fed back
    logits, aux = M.forward(sharding.place_params(lm32, s.cfg, mesh), s.cfg,
                            {"tokens": s.prompts}, mesh=mesh)
    _close(logits, s.logits, LOGIT_TOL)
    assert aux.shape == ()


def _storages(caches) -> list[int]:
    return [piece.untyped_storage().data_ptr()
            for leaf in sharding.tree_leaves(caches) for piece in leaf.pieces.flat]


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-moe-16b"])
def test_cache_pieces_own_their_storage(served, arch, shape):
    """On a mesh naming one device four times no two cache pieces share
    storage (the batcher writes them in place): zero caches, a batch the
    data replicas split, a b = 1 prefill on replica 1 (copied to replica
    0) and the decode step after it."""
    s = served(arch)
    mesh = _cpu_mesh(shape)
    placed = sharding.place_params(s.tp, s.cfg, mesh)
    for b, replica in ((4, 0), (1, shape[0] - 1)):
        caches = M.init_caches(s.cfg, b, CACHE_LEN, dtype=torch.float32,
                               mesh=mesh)
        ptrs = _storages(caches)
        assert len(set(ptrs)) == len(ptrs)
        logits, caches = M.prefill(placed, s.cfg, {"tokens": s.prompts[:b]},
                                   caches, mesh=mesh, replica=replica)
        ptrs = _storages(caches)
        assert len(set(ptrs)) == len(ptrs)
        _, caches = M.decode_step(placed, s.cfg,
                                  torch.argmax(logits[:, -1], -1)[:, None],
                                  caches, mesh=mesh, replica=replica)
        ptrs = _storages(caches)
        assert len(set(ptrs)) == len(ptrs)
        for leaf in sharding.tree_leaves(caches):   # data replicas agree
            if "data" not in leaf.spec:
                for coord in np.ndindex(mesh.devices.shape):
                    assert torch.equal(leaf.pieces[coord],
                                       leaf.pieces[(0,) + coord[1:]])


def _assert_tokens_agree(got, want, margins, scale, what):
    tol = LOGIT_TOL * max(1.0, scale)
    for r in range(want.shape[0]):
        for c in range(want.shape[1]):
            if margins[r, c] <= tol:
                if got[r, c] != want[r, c]:
                    break               # prefixes differ from here on
                continue
            assert got[r, c] == want[r, c], (what, r, c, got[r], want[r])


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_mesh_engine_and_batcher_tokens_match_reference(served, arch, shape):
    """``ServeEngine(mesh=)`` on the (4, 12) prompts and ``Batcher(mesh=,
    n_slots=4)`` on the same prompts twice over (8 requests, two waves;
    each admission a b = 1 prefill on the replica owning its slot): greedy
    tokens against the reference's."""
    s = served(arch)
    mesh = _cpu_mesh(shape)
    placed = sharding.place_params(s.tp, s.cfg, mesh)
    gcfg = GenerationConfig(max_new_tokens=N_NEW, cache_len=CACHE_LEN)
    got = ServeEngine(s.cfg, placed, gcfg, mesh=mesh).generate(s.prompts)
    assert got.shape == (4, N_NEW) and got.dtype == np.int32
    _assert_tokens_agree(got, s.tokens, s.margins, s.scale, "engine")
    b = Batcher(s.cfg, placed, n_slots=4, gcfg=gcfg, mesh=mesh)
    for rid in range(8):
        b.submit(Request(rid=rid, prompt=s.prompts[rid % 4],
                         max_new_tokens=N_NEW))
    done = {r.rid: r.generated for r in b.run()}
    assert sorted(done) == list(range(8))
    for rid, toks in done.items():
        r = rid % 4
        _assert_tokens_agree(np.asarray([toks]), s.tokens[r:r + 1],
                             s.margins[r:r + 1], s.scale, f"batcher {rid}")


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_mesh_fused_engine_matches_plain_engine(served, shape):
    """mixtral's fused engine on a mesh (its combines through a CPU
    service on the replicas' lead device) gives the plain mesh engine's
    tokens, one ``moe_dispatch`` launch a MoE layer, replica and step."""
    s = served("mixtral-8x7b")
    mesh = _cpu_mesh(shape)
    placed = sharding.place_params(s.tp, s.cfg, mesh)
    gcfg = GenerationConfig(max_new_tokens=N_NEW, cache_len=CACHE_LEN)
    plain = ServeEngine(s.cfg, placed, gcfg, mesh=mesh).generate(s.prompts)
    m, (b, t) = s.cfg.moe, s.prompts.shape
    replicas = shape[0]
    cap = int(t * m.top_k / m.n_experts * m.capacity_factor) + 1
    reg = KernelRegistry(device="cpu")
    reg.register_moe("moe", n_tokens=b * t // replicas,
                     n_slots=b // replicas * m.n_experts * cap,
                     d_model=s.cfg.d_model, top_k=m.top_k, dtype="float32")
    svc = KernelService(reg, n_slots=4)
    reads = MOE.ROUTING_READS
    fused = ServeEngine(s.cfg, placed, gcfg, mesh=mesh, kernel_service=svc,
                        moe_operand="moe").generate(s.prompts)
    np.testing.assert_array_equal(fused, plain)
    launches = s.cfg.n_layers * replicas * N_NEW
    assert svc.stats["moe_dispatch_launches"] == launches
    assert MOE.ROUTING_READS == reads + launches
    far = types.SimpleNamespace(registry=types.SimpleNamespace(
        device=torch.device("cuda", 3)))
    with pytest.raises(ValueError, match="lead device"):
        ServeEngine(s.cfg, placed, gcfg, mesh=mesh, kernel_service=far,
                    moe_operand="moe")


def test_mesh_entry_points_refuse_unplaced_and_foreign_parameters(served):
    s = served("llama3.2-3b")
    mesh, other = _cpu_mesh((1, 2)), _cpu_mesh((2, 1))
    with pytest.raises(ValueError, match="placed on it"):
        M.forward(s.tp, s.cfg, {"tokens": s.prompts}, mesh=mesh)
    placed = sharding.place_params(s.tp, s.cfg, mesh)
    with pytest.raises(ValueError, match="placed on"):
        M.forward(placed, s.cfg, {"tokens": s.prompts}, mesh=other)
    with pytest.raises(ValueError, match="axes"):
        M.forward(placed, s.cfg, {"tokens": s.prompts},
                  mesh=_cpu_mesh((1, 2), ("shard", "model")))
    # the ambient scope and placed parameters alone both name the mesh
    with use_mesh(mesh):
        a, _ = M.forward(placed, s.cfg, {"tokens": s.prompts})
    b, _ = M.forward(placed, s.cfg, {"tokens": s.prompts})
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "llama-3.2-vision-11b",
                                  "seamless-m4t-medium"])
def test_other_families_on_a_mesh_are_a10c(arch):
    """The families ROADMAP A10c brought to a mesh (hybrid, vision,
    enc-dec) run there through every entry point: born-sharded init, placed
    zero caches, a prefill with ``ctx_embeds`` equal to the unsharded
    model's to rounding, and a batcher request (the zero context).  Their
    parity with the reference is ``tests/test_torch_mesh_families.py``."""
    cfg = configs.reduced_config(arch)
    mesh = _cpu_mesh((1, 2))
    born = M.init_params(M.make_generator(0, "cpu"), cfg, mesh=mesh)
    caches = M.init_caches(cfg, 2, 16, dtype=torch.float32, mesh=mesh)
    assert all(isinstance(leaf, sharding.Sharded)
               for leaf in sharding.tree_leaves(caches))
    lm = M.init_params(M.make_generator(0, "cpu"), cfg)
    placed = sharding.place_params(lm, cfg, mesh)     # the rules place any arch
    for name, leaf in born.named_leaves():
        assert torch.equal(leaf.full(), placed[name].full()), name
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)}
    if cfg.encdec is not None:
        batch["ctx_embeds"] = rng.standard_normal((2, 8, cfg.d_model))
    elif cfg.cross_attn is not None:
        batch["ctx_embeds"] = rng.standard_normal((2, 8, cfg.cross_attn.d_ctx))
    got, _ = M.prefill(placed, cfg, batch, caches, mesh=mesh)
    want, _ = M.prefill(lm, cfg, batch, M.init_caches(
        cfg, 2, 16, dtype=torch.float32, device="cpu"))
    _close(got, want, LOGIT_TOL)
    b = Batcher(cfg, placed, mesh=mesh, n_slots=2,
                gcfg=GenerationConfig(cache_len=16))
    b.submit(Request(rid=0, prompt=batch["tokens"][0], max_new_tokens=2))
    assert len(b.run()[0].generated) == 2


# ---------------------------------------------------------------------------
# Kernel B9's vocab-shard form (its plain version; the kernel in
# tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n_shards", [1, 2, 4, 5])
def test_gather_shards_sum_to_the_whole_gather(n_shards, id_dtype):
    """Every boundary id of every shard, the first and last rows, and ids
    outside ``[0, V)`` as a card holds them (negative ids wrap once, ids
    past V read row V - 1 from the last shard alone)."""
    v, d = 40, 12
    table = torch.from_numpy(np.random.default_rng(0).standard_normal((v, d)))
    rows = v // n_shards
    edges = [e for k in range(n_shards) for e in (k * rows, (k + 1) * rows - 1)]
    ids = torch.tensor(edges + [0, v - 1, -1, -v, -v - 3, v, v + 7, 2**31 - 1],
                       dtype=id_dtype)
    want = gather.embedding_gather_ref(table, ids)
    parts = [gather.embedding_gather_shard_ref(table[k * rows:(k + 1) * rows],
                                               ids, k * rows, v)
             for k in range(n_shards)]
    assert torch.equal(sum(parts[1:], parts[0]), want)
    for k, part in enumerate(parts):
        own = (gather.clamp_ids(ids, v) // rows) == k
        assert torch.equal(part[~own], torch.zeros_like(part[~own]))
    # the wrapper on the CPU is the plain version; host ids are checked
    # against the whole vocabulary (in range: ids 0 .. V - 1)
    host = np.arange(v, dtype=np.int32)
    got = gather.embedding_gather_shard(table[rows:2 * rows] if n_shards > 1
                                        else table, host,
                                        rows if n_shards > 1 else 0, v)
    lo = rows if n_shards > 1 else 0
    assert torch.equal(got, gather.embedding_gather_shard_ref(
        table[lo:lo + rows], torch.from_numpy(host), lo, v))


def test_gather_shard_refuses_host_ids_and_bad_windows():
    table = torch.zeros((10, 4))
    with pytest.raises(LaunchPlanError, match=r"outside \[0, 40\)"):
        gather.embedding_gather_shard(table, np.array([0, 40]), 30, 40)
    with pytest.raises(LaunchPlanError, match=r"outside \[0, 40\)"):
        gather.embedding_gather_shard(table, torch.tensor([-1]), 0, 40)
    with pytest.raises(LaunchPlanError, match="shard rows"):
        gather.embedding_gather_shard(table, np.array([0]), 35, 40)
    # card-style ids (not on the host) are bounded, never refused
    on_card = torch.empty((3,), dtype=torch.int64, device="meta")
    plan = gather._plan(40, 4, on_card, "float32", 256, (30, 10))
    assert plan.ok and plan.kernel == "embedding_gather_shard"
    assert plan.blocks[0].operands[1] == ("table", (10, 4), "float32")


def test_mesh_embedding_runs_the_shard_form_or_the_whole_table(served,
                                                               monkeypatch):
    """A vocabulary the model axis divides: one shard-form call a model
    device; one that it does not: the whole-table B9 on the lead."""
    s = served("llama3.2-3b")
    calls = []
    for name in ("embedding_gather", "embedding_gather_shard"):
        fn = getattr(gather, name)
        monkeypatch.setattr(gather, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    mesh = _cpu_mesh((2, 4))
    x, _ = M.forward(sharding.place_params(s.tp, s.cfg, mesh), s.cfg,
                     {"tokens": s.prompts}, mesh=mesh)
    assert calls == ["embedding_gather_shard"] * 8       # 2 replicas x 4
    calls.clear()
    cfg = dataclasses.replace(s.cfg, vocab_size=255)
    lm = M.init_params(M.make_generator(0, "cpu"), cfg)
    placed = sharding.place_params(lm, cfg, mesh)
    assert placed["tok_embed"].spec == (None, None)
    want, _ = M.forward(lm, cfg, {"tokens": s.prompts % 255})
    calls.clear()
    got, _ = M.forward(placed, cfg, {"tokens": s.prompts % 255}, mesh=mesh)
    assert calls == ["embedding_gather"] * 2
    _close(got, want, LOGIT_TOL)
