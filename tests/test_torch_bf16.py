"""The bf16 paths of the port against the JAX reference, on the CPU: the
reference model's ``SSD_BF16`` scan (``repro.models.ssm``, set in both
packages by monkeypatch, never edited) and bf16 parameters
(``param_dtype=torch.bfloat16``), whose embedding table kernel B9 gathers
as it is.

Under ``SSD_BF16`` both packages hand the chunked scan bf16 xd / B / C
beside float32 ad.  The reference runs ``ssd_chunked``'s bf16 einsums
(``ssm.py:81-142``: bf16 products and sums, bf16 y); the port runs kernel
B8's bf16 form (here its plain version), which sums in float32 and rounds
y once.  Tolerances:

* ``BF16_TOL`` = 1e-2 x max|reference| for what passes a chunked scan
  (mixer outputs, logits): the reference's bf16 sums over a chunk's rows
  and state lose ~2^-8 relative each; the gap seen is 3.4e-3 (a mixer) and
  7.7e-4 (logits) of max, so 1e-2 holds it with a 3x margin.  It cannot
  tell the bf16 scan from the float32 one (3.3e-3 of max apart), so
* ``LOGIT_TOL`` = 1e-5 x max|reference| with the reference's
  ``ssd_chunked`` monkeypatched to its own ``ssd_fused`` (float32 sums,
  y rounded once: B8's contract) names the einsum gap and holds the dtype
  flow (2e-6 of max seen; the float32 scan is 300x that away); also for
  the per-token recurrence (ragged tails, decode steps), which both
  packages run on the same dtypes;
* the bf16 parameters' train step ``torch.equal`` to the same step with
  the table copied to float32 before B9 (the port's expression before B9
  had its bf16 form): the rows are the same, and the backward sums the
  same float32 gradients and rounds once.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.kernels.ssd import ssd_fused as ref_ssd_fused
from repro.models import model as RM
from repro.models import ssm as ref_ssm
from repro_torch import configs
from repro_torch.compat import make_mesh
from repro_torch.kernels import gather
from repro_torch.models import model as M
from repro_torch.models import sharding, ssm
from repro_torch.models.convert import params_from_reference
from repro_torch.train import TrainConfig
from repro_torch.train.step import loss_and_grads

BF16_TOL = 1e-2
LOGIT_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tiny tensors (the workers of
    a parallel test run share the cores), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mamba():
    cfg = ref_configs.reduced_config("mamba2-2.7b")
    jp = RM.init_params(jax.random.PRNGKey(1), cfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tcfg = configs.reduced_config("mamba2-2.7b")
    return cfg, jp, tcfg, params_from_reference(tree, tcfg, "cpu"), tree


@pytest.fixture
def bf16_scan(monkeypatch):
    monkeypatch.setattr(ref_ssm, "SSD_BF16", True)
    monkeypatch.setattr(ssm, "SSD_BF16", True)


def _close(got, want, rtol):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


def _fused_chunked(xd, ad, B, C, chunk, init_state=None):
    """The reference's ``ssd_chunked`` contract through its own Pallas
    ``ssd_fused`` (interpret mode): float32 sums, y in xd's dtype."""
    assert init_state is None
    return ref_ssd_fused(xd, ad, B, C, chunk=chunk)


@pytest.mark.parametrize("length", [64, 13, 1])
def test_ssm_forward_under_ssd_bf16_matches_reference(mamba, bf16_scan, length):
    """A mixer from a random state: the chunked branch (B8's bf16 form
    against the reference's bf16 einsums, ``BF16_TOL``), a ragged length
    and a decode step (the per-token recurrence on the same dtypes in both:
    the float32 state rounded to bf16, then promoted by exp(ad);
    ``LOGIT_TOL``).  The new state is float32 in both."""
    cfg, _, tcfg, tp, tree = mamba
    rng = np.random.default_rng(length)
    s = cfg.ssm
    x = rng.standard_normal((2, length, cfg.d_model)).astype(np.float32)
    st = ref_ssm.SSMState(
        state=rng.standard_normal((2, cfg.n_ssm_heads, s.head_dim,
                                   s.d_state)).astype(np.float32),
        conv=rng.standard_normal((2, s.d_conv - 1, cfg.d_inner
                                  + 2 * s.n_groups * s.d_state)).astype(np.float32))
    layer0 = jax.tree_util.tree_map(lambda a: a[0], tree["blocks"]["ssm"])
    y0, new0 = ref_ssm.ssm_forward(layer0, cfg, jnp.asarray(x),
                                   jax.tree_util.tree_map(jnp.asarray, st))
    y1, new1 = ssm.ssm_forward(tp.blocks[0].ssm, tcfg, torch.from_numpy(x),
                               ssm.SSMState(*(torch.from_numpy(a) for a in st)))
    tol = BF16_TOL if length % s.chunk == 0 else LOGIT_TOL
    _close(y1, y0, tol)
    _close(new1.state, new0.state, tol)
    assert new1.state.dtype == torch.float32 and new0.state.dtype == jnp.float32
    _close(new1.conv, new0.conv, LOGIT_TOL)


def test_forward_under_ssd_bf16_matches_reference(mamba, bf16_scan, monkeypatch):
    """Logits of a (2, 64) batch (eight chunks a layer): within
    ``BF16_TOL`` of the reference's bf16 einsums, within ``LOGIT_TOL`` of
    the reference with its chunked scan on its own ``ssd_fused``; and apart
    from the float32 scan's (the switch changes the computation)."""
    cfg, jp, tcfg, tp, _ = mamba
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    got, _ = M.forward(tp, tcfg, {"tokens": toks})
    want, _ = RM.forward(jp, cfg, {"tokens": jnp.asarray(toks)})
    _close(got, want, BF16_TOL)
    monkeypatch.setattr(ref_ssm, "ssd_chunked", _fused_chunked)
    fused, _ = RM.forward(jp, cfg, {"tokens": jnp.asarray(toks)})
    _close(got, fused, LOGIT_TOL)
    monkeypatch.setattr(ssm, "SSD_BF16", False)
    f32, _ = M.forward(tp, tcfg, {"tokens": toks})
    assert float((f32 - got).abs().max()) > LOGIT_TOL * float(f32.abs().max())


def test_prefill_and_decode_under_ssd_bf16_match_reference(mamba, bf16_scan):
    """A chunk-multiple prefill (B8's bf16 form) and four greedy decode
    steps (the recurrence from the float32 state), logits within
    ``BF16_TOL`` of the reference's and the same greedy tokens."""
    cfg, jp, tcfg, tp, _ = mamba
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    cj = RM.init_caches(cfg, 2, 32, dtype=jnp.float32)
    ct = M.init_caches(tcfg, 2, 32, dtype=torch.float32, device="cpu")
    lj, cj = RM.prefill(jp, cfg, {"tokens": jnp.asarray(toks)}, cj)
    lt, ct = M.prefill(tp, tcfg, {"tokens": toks}, ct)
    _close(lt, lj, BF16_TOL)
    last_j, last_t = lj[:, -1], lt[:, -1]
    for _ in range(4):
        tok = np.asarray(jnp.argmax(last_j, axis=-1)).astype(np.int32)
        assert np.array_equal(torch.argmax(last_t, dim=-1).numpy(), tok)
        last_j, cj = RM.decode_step(jp, cfg, jnp.asarray(tok[:, None]), cj)
        last_t, ct = M.decode_step(tp, tcfg, tok[:, None], ct)
        last_j, last_t = last_j.reshape(2, -1), last_t.reshape(2, -1)
        _close(last_t, last_j, BF16_TOL)
    assert ct["layers"].ssm.state.dtype == torch.float32


def test_hybrid_forward_under_ssd_bf16_matches_reference(bf16_scan):
    """hymba's hybrid blocks (attention beside the mamba2 mixer) under
    ``SSD_BF16``: logits within ``BF16_TOL`` of the reference's."""
    cfg = ref_configs.reduced_config("hymba-1.5b")
    jp = RM.init_params(jax.random.PRNGKey(2), cfg)
    tcfg = configs.reduced_config("hymba-1.5b")
    tp = params_from_reference(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    got, _ = M.forward(tp, tcfg, {"tokens": toks})
    want, _ = RM.forward(jp, cfg, {"tokens": jnp.asarray(toks)})
    _close(got, want, BF16_TOL)


def _copy_then_gather(p, cfg, tokens, dtype):
    """The embedding before B9's bf16 form: a bf16 table copied to float32,
    then gathered (the copy's backward casts the float32 sums to bf16)."""
    b, s = tokens.shape
    table = p.tok_embed
    if table.dtype not in (torch.float32, torch.float64):
        table = table.float()
    x = gather.embedding_gather(table, tokens.reshape(-1))
    return x.reshape(b, s, cfg.d_model).to(dtype)


def _copy_then_gather_tp(p, cfg, tokens, row, dtype):
    """The mesh embedding before B9's bf16 form: every piece copied to
    float32, then the whole-table or vocab-shard gather."""
    b, s = tokens.shape
    ids = tokens.reshape(-1)
    table = p["tok_embed"]
    pieces = [t if t.dtype in (torch.float32, torch.float64) else t.float()
              for t in row.pieces(table)]
    rows = table.shape[0] // row.size
    x = sharding.sum_on([gather.embedding_gather_shard(
        t, ids, m * rows, cfg.vocab_size)
        for m, (dev, t) in enumerate(zip(row.devices, pieces))], row.lead)
    return x.reshape(b, s, cfg.d_model).to(dtype)


def _bf16_step(placed: bool, monkeypatch, old: bool):
    cfg = configs.reduced_config("mamba2-2.7b")
    lm = M.init_params(M.make_generator(0, "cpu"), cfg, trainable=True)
    lm.to(torch.bfloat16)
    params = lm
    if placed:
        params = sharding.place_params(lm, cfg, make_mesh((1, 2), ("data", "model"),
                                                          ("cpu",) * 2))
        assert params["tok_embed"].tp_dim() is not None      # vocab-sharded
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    with monkeypatch.context() as m:
        if old:
            m.setattr(M, "_embed", _copy_then_gather)
            m.setattr(M, "_embed_tp", _copy_then_gather_tp)
        grads, loss, _ = loss_and_grads(params, cfg, TrainConfig(remat=None), batch)
    if placed:
        grads = {k: g.full() for k, g in grads.items()}
    return grads, loss


@pytest.mark.parametrize("placed,scan", [(False, "f32"), (False, "bf16"),
                                         (True, "f32")])
def test_bf16_params_step_equals_copy_then_gather(placed, scan, monkeypatch):
    """bf16 parameters (float32 activations), unsharded and on a (1, 2)
    CPU mesh (the table vocab-sharded, B9's shard form): B9 gathers the bf16
    table as it is and its backward sums the float32 gradients and rounds
    once, so the loss and every gradient are ``torch.equal`` to the step
    that copies the table to float32 first; with ``SSD_BF16`` too."""
    if scan == "bf16":
        monkeypatch.setattr(ssm, "SSD_BF16", True)
    g_new, l_new = _bf16_step(placed, monkeypatch, old=False)
    g_old, l_old = _bf16_step(placed, monkeypatch, old=True)
    assert torch.equal(l_new, l_old)
    assert g_new["tok_embed"].dtype == torch.bfloat16
    for k, g in g_new.items():
        assert torch.equal(g, g_old[k]), k
