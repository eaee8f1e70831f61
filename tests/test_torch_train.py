"""Parity of the port's training path (``repro_torch.optim``,
``repro_torch.data``, ``repro_torch.train``, ``repro_torch.launch.train``)
with the JAX reference.

The same numpy-seeded inputs, and the reference's weights moved over by
``params_from_reference(..., trainable=True)``, go through both packages
on the CPU in float32 (the reference with x64 on, as every test here runs
it).  The port takes the plain versions of kernels B8 and B9 and of their
backward kernels there.  Tolerances: schedules and AdamW 1e-6 (float32
arithmetic in the same order); the loss 1e-5 relative, each gradient 1e-4
x max|g| of its leaf, the grad norm 1e-5 relative (float32 rounding in
another summation order through a whole model); data tokens exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro.models import layers as ref_layers
from repro.models import model as RM
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import compress_tree as ref_compress
from repro.optim import compression_init as ref_compression_init
from repro.optim import cosine_schedule as ref_cosine
from repro.optim import decompress_tree as ref_decompress
from repro.optim import wsd_schedule as ref_wsd
from repro.optim.adamw import clip_by_global_norm as ref_clip
from repro.train import TrainConfig as RefTrainConfig
from repro.train import make_train_step as ref_make_train_step
from repro.train.step import TrainState as RefTrainState
from repro_torch import configs
from repro_torch.data import DataConfig, SyntheticLM, make_global_batch
from repro_torch.kernels.execspec import ExecSpec
from repro_torch.launch import train as cli
from repro_torch.models import moe
from repro_torch.models.convert import params_from_reference, reference_path
from repro_torch.models.layers import softmax_cross_entropy
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    compress_tree,
    compression_init,
    cosine_schedule,
    decay_mask,
    decompress_tree,
    wsd_schedule,
)
from repro_torch.train import TrainConfig, init_train_state, make_train_step
from repro_torch.train.step import loss_and_grads

FAMILIES = ("qwen2-1.5b", "mamba2-2.7b", "deepseek-moe-16b", "hymba-1.5b",
            "llama-3.2-vision-11b", "seamless-m4t-medium")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tiny tensors (the workers of
    a parallel test run share the cores), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_leaf(tree, name):
    """The reference value of the port's parameter ``name``."""
    keys, idx = reference_path(name)
    for k in keys:
        tree = tree[k]
    return np.asarray(tree)[idx] if idx else np.asarray(tree)


def _ref_tree(arch, seed=0):
    cfg = ref_configs.reduced_config(arch)
    jp = RM.init_params(jax.random.PRNGKey(seed), cfg)
    return cfg, jp, jax.tree_util.tree_map(np.asarray, jp)


def _batch(cfg, b=2, s=16, seed=0):
    """tokens / labels (labels' last position ignored) and, for the vision
    and enc-dec families, stub ``ctx_embeds``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.encdec is not None:
        batch["ctx_embeds"] = rng.standard_normal(
            (b, cfg.encdec.n_ctx_tokens, cfg.d_model)).astype(np.float32)
    elif cfg.cross_attn is not None:
        batch["ctx_embeds"] = rng.standard_normal(
            (b, cfg.cross_attn.n_ctx_tokens,
             cfg.cross_attn.d_ctx or cfg.d_model)).astype(np.float32)
    return batch


# ---------------------------------------------------------------------------
# Schedules, AdamW, clipping, compression, the loss, the data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make,ref", [
    (lambda: cosine_schedule(1e-3, 10, 100), lambda: ref_cosine(1e-3, 10, 100)),
    (lambda: wsd_schedule(2e-3, 10, 70, 20), lambda: ref_wsd(2e-3, 10, 70, 20)),
])
def test_schedules_equal_reference(make, ref):
    f, g = make(), ref()
    for step in (0, 1, 5, 10, 11, 50, 80, 81, 90, 100, 150):
        want = float(g(jnp.asarray(step, jnp.int32)))
        assert float(f(step)) == pytest.approx(want, rel=1e-6, abs=1e-12)
        assert float(f(torch.tensor(step))) == float(f(step))


def test_decay_mask_follows_the_reference_leaf_rank():
    """The reference decays a leaf of rank >= 2, its stacked layer axes
    counted: every parameter of a stacked block, DeepSeek's unstacked
    ``dense0`` only where its own rank is 2, 1-D top-level norms never."""
    for arch in ("mamba2-2.7b", "deepseek-moe-16b", "llama-3.2-vision-11b",
                 "seamless-m4t-medium"):
        cfg, _, tree = _ref_tree(arch)
        lm = params_from_reference(tree, configs.reduced_config(arch), "cpu")
        mask = decay_mask(lm.named_parameters())
        for name, p in lm.named_parameters():
            assert mask[name] == (np.ndim(_ref_leaf_root(tree, name)) >= 2), name
        assert not mask["final_norm"]
        if arch == "mamba2-2.7b":
            assert mask["blocks.0.ssm.A_log"] and mask["blocks.1.ln1"]
        if arch == "deepseek-moe-16b":
            assert not mask["dense0.ln1"] and mask["dense0.attn.wq"]


def _ref_leaf_root(tree, name):
    keys, _ = reference_path(name)
    for k in keys:
        tree = tree[k]
    return tree


def test_adamw_update_equals_reference_on_a_converted_model():
    """Three updates of a reduced mamba2 (cosine schedule, clipping active)
    from the same parameters and gradients: every parameter at 1e-6."""
    arch = "mamba2-2.7b"
    cfg, jp, tree = _ref_tree(arch, seed=4)
    lm = params_from_reference(tree, configs.reduced_config(arch), "cpu",
                               trainable=True)
    named = dict(lm.named_parameters())
    rng = np.random.default_rng(9)
    ref_cfg = RefAdamWConfig(lr=ref_cosine(1e-2, 1, 10), clip_norm=0.5)
    cfg_t = AdamWConfig(lr=cosine_schedule(1e-2, 1, 10), clip_norm=0.5)
    ref_state, state = ref_adamw_init(jp), adamw_init(named)
    for _ in range(3):
        grads_np = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
        jp, ref_state, rm = ref_adamw_update(
            jax.tree_util.tree_map(jnp.asarray, grads_np), ref_state, jp, ref_cfg)
        grads = {k: torch.from_numpy(np.ascontiguousarray(_ref_leaf(grads_np, k)))
                 for k in named}
        _, state, m = adamw_update(grads, state, named, cfg_t)
        assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=1e-6)
        assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    new_tree = jax.tree_util.tree_map(np.asarray, jp)
    for k, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), _ref_leaf(new_tree, k),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert state["step"] == 3


def test_adamw_with_a_master_copy_keeps_bf16_parameters():
    p = {"w": torch.randn(8, 4).to(torch.bfloat16), "b": torch.zeros(4, dtype=torch.bfloat16)}
    state = adamw_init(p, keep_master=True)
    assert state["master"]["w"].dtype == torch.float32
    g = {"w": torch.ones(8, 4, dtype=torch.bfloat16), "b": torch.ones(4, dtype=torch.bfloat16)}
    before = state["master"]["w"].clone()
    adamw_update(g, state, p, AdamWConfig(lr=1e-2))
    assert p["w"].dtype == torch.bfloat16
    assert torch.equal(p["w"], state["master"]["w"].to(torch.bfloat16))
    assert not torch.equal(before, state["master"]["w"])


def test_clip_by_global_norm_equals_reference():
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32)}
    for max_norm in (0.5, 100.0):
        want, wn = ref_clip(jax.tree_util.tree_map(jnp.asarray, tree), max_norm)
        got, n = clip_by_global_norm({k: torch.from_numpy(v) for k, v in tree.items()},
                                     max_norm)
        assert float(n) == pytest.approx(float(wn), rel=1e-6)
        for k in tree:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)


def test_compression_round_trip_and_error_feedback_equal_reference():
    rng = np.random.default_rng(3)
    shapes = {"w": (16, 8), "v": (33,)}
    ref_state = ref_compression_init({k: jnp.zeros(s) for k, s in shapes.items()})
    state = compression_init({k: torch.zeros(s) for k, s in shapes.items()})
    applied, true_sum = {k: 0.0 for k in shapes}, {k: 0.0 for k in shapes}
    for _ in range(20):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        carried = {k: e.clone() for k, e in state.error.items()}
        rq, rs, ref_state = ref_compress(jax.tree_util.tree_map(jnp.asarray, g), ref_state)
        q, s, state = compress_tree({k: torch.from_numpy(v) for k, v in g.items()}, state)
        deq = decompress_tree(q, s)
        rdeq = ref_decompress(rq, rs)
        for k in shapes:
            np.testing.assert_array_equal(q[k].numpy(), np.asarray(rq[k]))
            assert float(s[k]) == pytest.approx(float(rs[k]), rel=1e-6)
            np.testing.assert_allclose(deq[k].numpy(), np.asarray(rdeq[k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(state.error[k].numpy(),
                                       np.asarray(ref_state.error[k]), atol=1e-6)
            # a round trip of the gradient plus the carried residual errs
            # by at most half a quantum
            err = deq[k] - (torch.from_numpy(g[k]) + carried[k])
            assert float(err.abs().max()) <= float(s[k]) * 0.5 * (1 + 1e-5)
            applied[k] = applied[k] + deq[k].numpy()
            true_sum[k] = true_sum[k] + g[k]
    # error feedback: the applied sum trails the true one by one residual
    for k in shapes:
        np.testing.assert_allclose(applied[k] + state.error[k].numpy(),
                                   true_sum[k], atol=1e-4)


def test_softmax_cross_entropy_equals_reference():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 9, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 9)).astype(np.int32)
    labels[:, -1] = -1
    labels[1, :4] = -1
    want, wn = ref_layers.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got, n = softmax_cross_entropy(torch.from_numpy(logits), labels)
    assert int(n) == int(wn)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    all_masked, n0 = softmax_cross_entropy(torch.from_numpy(logits), np.full((3, 9), -1))
    assert float(all_masked) == 0.0 and int(n0) == 1


@pytest.mark.parametrize("seed,vocab,seq,batch,shards", [
    (0, 256, 32, 4, 1), (7, 50280, 64, 8, 2), (3, 1000, 17, 6, 3)])
def test_data_tokens_equal_reference(seed, vocab, seq, batch, shards):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed)
    ref, port = RefSyntheticLM(RefDataConfig(**kw)), SyntheticLM(DataConfig(**kw))
    for step in (0, 1, 5, 1000):
        for shard in range(shards):
            for a, b in zip(ref.batch_for(step, shard, shards),
                            port.batch_for(step, shard, shards)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(make_global_batch(DataConfig(**kw), 2)[0],
                                  ref.batch_for(2)[0])


# ---------------------------------------------------------------------------
# The train step, family by family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_reference(arch):
    """Loss, every gradient and the grad norm of one step of a reduced
    model with the reference's weights (the mamba2 and hymba scans a
    chunk multiple, so B8's Function and its backward run)."""
    cfg, jp, tree = _ref_tree(arch, seed=1)
    tcfg = configs.reduced_config(arch)
    batch = _batch(cfg, s=16)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref_tc = RefTrainConfig(optimizer=RefAdamWConfig(lr=1e-3), remat=None,
                            dtype=jnp.float32)

    def ref_loss(params):
        logits, aux = RM.forward(params, cfg, jbatch, dtype=jnp.float32, remat=None)
        loss, _ = ref_layers.softmax_cross_entropy(logits, jbatch["labels"])
        return loss + ref_tc.aux_weight * aux, loss
    (_, ref_l), ref_g = jax.value_and_grad(ref_loss, has_aux=True)(jp)
    ref_g = jax.tree_util.tree_map(np.asarray, ref_g)

    lm = params_from_reference(tree, tcfg, "cpu", trainable=True)
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3), remat=None)
    grads, loss, _ = loss_and_grads(lm, tcfg, tc, batch)
    assert float(loss) == pytest.approx(float(ref_l), rel=1e-5)
    for k, g in grads.items():
        want = _ref_leaf(ref_g, k)
        tol = 1e-4 * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=tol, err_msg=k)

    ref_state = RefTrainState(jp, ref_adamw_init(jp), None, jnp.zeros((), jnp.int32))
    _, rm = ref_make_train_step(cfg, ref_tc)(ref_state, jbatch)
    state = init_train_state(None, tcfg, tc, params=lm)
    _, m = make_train_step(tcfg, tc)(state, batch)
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=1e-5)
    assert float(m["aux"]) == pytest.approx(float(rm["aux"]), rel=1e-5, abs=1e-7)


def _tiny(accum=1, compress=False, param_dtype=None):
    cfg = configs.reduced_config("qwen2-1.5b")
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3), remat=None,
                     accum_steps=accum, compress_grads=compress,
                     param_dtype=param_dtype)
    state = init_train_state(torch.Generator().manual_seed(0), cfg, tc)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=4))
    return cfg, state, make_train_step(cfg, tc), data


def _learn(state, step, data, n=30):
    losses = []
    for i in range(n):
        tokens, labels = data.batch_for(i)
        state, m = step(state, {"tokens": tokens, "labels": labels})
        losses.append(float(m["loss"]))
    return losses


def test_grad_accumulation_matches_big_batch():
    """accum=2 over a batch == accum=1 over the same batch (the reference's
    5e-5 on the updated parameters)."""
    _, s1, step1, data = _tiny(accum=1)
    _, s2, step2, _ = _tiny(accum=2)
    tokens, labels = data.batch_for(0)
    a, _ = step1(s1, {"tokens": tokens, "labels": labels})
    b, _ = step2(s2, {"tokens": tokens, "labels": labels})
    for (k, p), (_, q) in zip(a.params.named_parameters(), b.params.named_parameters()):
        assert float((p - q).detach().abs().max()) < 5e-5, k


@pytest.mark.parametrize("kw", [{}, {"compress": True},
                                {"param_dtype": torch.bfloat16}])
def test_training_learns(kw):
    """30 steps lower the loss by 0.2 (the reference's bound), also with
    int8 compression and with bf16 parameters over a float32 master (the
    bf16 table cast to float32 before B9)."""
    _, state, step, data = _tiny(**kw)
    if "param_dtype" in kw:
        assert all(p.dtype == torch.bfloat16 for p in state.params.parameters())
        assert "master" in state.opt
    losses = _learn(state, step, data)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def test_sell_dispatch_raises_under_a_gradient_and_auto_runs_dense():
    arch = "deepseek-moe-16b"
    _, _, tree = _ref_tree(arch)
    cfg = configs.reduced_config(arch)
    lm = params_from_reference(tree, cfg, "cpu", trainable=True)
    batch = _batch(cfg)
    tc = TrainConfig(remat=None)
    want, _, _ = loss_and_grads(lm, cfg, tc, batch)
    with moe.sell_dispatch(ExecSpec(dispatch="sell", device="cpu")):
        with pytest.raises(ValueError, match="no backward"):
            loss_and_grads(lm, cfg, tc, batch)
    reads = moe.ROUTING_READS
    with moe.sell_dispatch(ExecSpec(dispatch="auto", device="cpu")):
        got, _, _ = loss_and_grads(lm, cfg, tc, batch)
    assert moe.ROUTING_READS == reads                 # no SELL pack: dense
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_cli_trains_on_the_cpu_and_refuses_a_mesh():
    lines = []
    state, hist = cli.main(["--device", "cpu", "--arch", "mamba2-2.7b", "--steps",
                            "3", "--batch", "2", "--seq-len", "16", "--remat",
                            "full"], log=lines.append)
    assert len(hist) == 3 and state.step == 3
    assert lines[0].startswith("[train] step 0 loss ")
    assert lines[-1].startswith("[done] arch=mamba2-2.7b-smoke on cpu steps=3")
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist)
    assert set(hist[0]) == {"loss", "aux", "grad_norm", "lr", "step", "wall_s"}
    with pytest.raises(ValueError, match="needs 256 devices"):
        cli.main(["--device", "cpu", "--mesh", "single"])


def test_cli_without_a_device_trains_on_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main(["--steps", "1", "--batch", "2", "--seq-len", "8"])
