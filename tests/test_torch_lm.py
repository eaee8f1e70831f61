"""Parity of the port's LM serving path (``repro_torch.models``,
``repro_torch.serve``, ``repro_torch.launch.serve``) with the JAX reference,
on reduced mamba2 with the reference's weights moved over by
``repro_torch.models.convert.params_from_reference``.

Both packages run on the CPU in float32 (the reference with x64 on, as
every test here runs it; its mamba2 parameters and activations are float32
all the same).  The port takes the plain versions of kernels B8 and B9
there.  Tolerances:

* mixer outputs, logits and states: ``LOGIT_TOL`` x max|reference| (1e-5:
  float32 rounding in another summation order, ~20x the largest difference
  seen, 5e-7 relative);
* greedy tokens: equal at every position where the reference's top-2 logit
  margin exceeds that tolerance (a closer margin could flip the argmax
  without a fault; such positions are reported and end the row's check).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.models import blocks as ref_blocks
from repro.models import model as RM
from repro.models import ssm as ref_ssm
from repro.serve import Batcher as RefBatcher
from repro.serve import GenerationConfig as RefGenerationConfig
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch import configs
from repro_torch.compat import make_mesh
from repro_torch.launch import serve as cli
from repro_torch.models import blocks
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.models.convert import params_from_reference
from repro_torch.serve import Batcher, GenerationConfig, Request, ServeEngine
from repro_torch.serve.engine import sample_token

LOGIT_TOL = 1e-5
ARCH = "mamba2-2.7b"


@pytest.fixture(scope="module")
def lm():
    cfg = ref_configs.reduced_config(ARCH)
    jp = RM.init_params(jax.random.PRNGKey(1), cfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tcfg = configs.reduced_config(ARCH)
    return cfg, jp, tcfg, params_from_reference(tree, tcfg, "cpu"), tree


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    tol = LOGIT_TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# Configs (copies)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_config_copy_matches_reference_field_by_field(arch, reduced):
    get = "reduced_config" if reduced else "get_config"
    want = getattr(ref_configs, get)(arch)
    got = getattr(configs, get)(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("d_head", "attention_free", "subquadratic", "d_inner",
                 "n_ssm_heads"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.n_params() == want.n_params()
    assert got.active_params_per_token() == want.active_params_per_token()


def test_arch_registry_copy_matches_reference():
    assert configs.ARCHS == ref_configs.ARCHS
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}
    assert list(configs.all_cells(True)) == list(ref_configs.all_cells(True))
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")


# ---------------------------------------------------------------------------
# Mixer, forward, prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("branch,length", [("chunked", 16), ("ragged", 13),
                                           ("decode", 1)])
def test_ssm_forward_branches_match_reference(lm, branch, length):
    """The chunk-multiple branch (B8's plain version), a ragged length and
    a decode step (the per-token recurrence), each from a random state."""
    cfg, _, tcfg, tp, tree = lm
    rng = np.random.default_rng(length)
    x = rng.standard_normal((2, length, cfg.d_model)).astype(np.float32)
    s = cfg.ssm
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
    _close(y1, y0)
    _close(new1.state, new0.state)
    _close(new1.conv, new0.conv)
    assert new1.state.dtype == torch.float32
    # no state in, none out (the training-style pass)
    y2, none = ssm.ssm_forward(tp.blocks[0].ssm, tcfg, torch.from_numpy(x))
    assert none is None
    _close(y2, ref_ssm.ssm_forward(layer0, cfg, jnp.asarray(x))[0])


@pytest.mark.parametrize("length", [16, 13])
def test_forward_prefill_and_decode_logits_match_reference(lm, length):
    cfg, jp, tcfg, tp, _ = lm
    toks = np.random.default_rng(length).integers(
        0, cfg.vocab_size, (2, length)).astype(np.int32)
    lj, aux = RM.forward(jp, cfg, {"tokens": jnp.asarray(toks)})
    lt, aux_t = M.forward(tp, tcfg, {"tokens": toks})
    _close(lt, lj)
    assert float(aux_t) == float(aux) == 0.0
    cj = RM.init_caches(cfg, 2, 64, dtype=jnp.float32)
    ct = M.init_caches(tcfg, 2, 64, dtype=torch.float32, device="cpu")
    lj, cj = RM.prefill(jp, cfg, {"tokens": jnp.asarray(toks)}, cj)
    lt, ct = M.prefill(tp, tcfg, {"tokens": toks}, ct)
    _close(lt, lj)
    tok = toks[:, -1:]
    for _ in range(3):
        lj, cj = RM.decode_step(jp, cfg, jnp.asarray(tok), cj)
        lt, ct = M.decode_step(tp, tcfg, tok, ct)
        _close(lt, lj)
        _close(ct["layers"].ssm.state, cj["layers"].ssm.state)
        _close(ct["layers"].ssm.conv, cj["layers"].ssm.conv)
        tok = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)


def _reference_steps(cfg, jp, prompts, n_new):
    """The reference's greedy tokens and, per position, its top-2 margin."""
    caches = RM.init_caches(cfg, prompts.shape[0], 64, dtype=jnp.float32)
    logits, caches = RM.prefill(jp, cfg, {"tokens": jnp.asarray(prompts)}, caches)
    last = logits[:, -1]
    toks, margins = [], []
    for i in range(n_new):
        top2 = np.sort(np.asarray(last), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tok = np.asarray(jnp.argmax(last, -1)).astype(np.int32)
        toks.append(tok)
        if i + 1 < n_new:
            last, caches = RM.decode_step(jp, cfg, jnp.asarray(tok[:, None]), caches)
    return np.stack(toks, 1), np.stack(margins, 1), float(np.abs(logits).max())


def _assert_tokens_agree(got, want, margins, scale, what):
    tol = LOGIT_TOL * max(1.0, scale)
    close = []
    for r in range(want.shape[0]):
        for c in range(want.shape[1]):
            if margins[r, c] <= tol:
                close.append((r, c, float(margins[r, c])))
                if got[r, c] != want[r, c]:
                    break               # prefixes differ from here on
                continue
            assert got[r, c] == want[r, c], (what, r, c, got[r], want[r])
    if close:
        print(f"{what}: positions with a top-2 margin <= {tol:.2e}: {close}")


def test_engine_greedy_tokens_match_reference(lm):
    cfg, jp, tcfg, tp, _ = lm
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                                (3, 16)).astype(np.int32)
    want, margins, scale = _reference_steps(cfg, jp, prompts, 6)
    ref = RefEngine(cfg, jp, RefGenerationConfig(max_new_tokens=6,
                                                 cache_len=64)).generate(prompts)
    np.testing.assert_array_equal(ref, want)
    got = ServeEngine(tcfg, tp, GenerationConfig(max_new_tokens=6,
                                                 cache_len=64)).generate(prompts)
    assert got.dtype == np.int32 and got.shape == (3, 6)
    _assert_tokens_agree(got, want, margins, scale, "engine")


def test_batcher_greedy_tokens_match_reference(lm):
    """Five requests through two slots: admission refills a slot by a
    single-row prefill written into its row; ragged and chunk-multiple
    prompts."""
    cfg, jp, tcfg, tp, _ = lm
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, (ln,)).astype(np.int32)
               for ln in (16, 16, 11, 8, 16)]

    def serve(batcher_cls, request_cls, c, p, gcfg):
        b = batcher_cls(c, p, n_slots=2, gcfg=gcfg)
        for i, pr in enumerate(prompts):
            b.submit(request_cls(rid=i, prompt=pr, max_new_tokens=4 + i % 2))
        return {r.rid: r.generated for r in b.run()}

    want = serve(RefBatcher, RefRequest, cfg, jp, RefGenerationConfig(cache_len=64))
    got = serve(Batcher, Request, tcfg, tp, GenerationConfig(cache_len=64))
    assert sorted(got) == sorted(want)
    # the margins of each request's own greedy continuation, one reference
    # run per prompt length
    for ln in sorted({len(pr) for pr in prompts}):
        rids = [i for i, pr in enumerate(prompts) if len(pr) == ln]
        _, margins, scale = _reference_steps(
            cfg, jp, np.stack([prompts[i] for i in rids]), 5)
        for row, rid in enumerate(rids):
            k = len(want[rid])
            _assert_tokens_agree(np.asarray([got[rid]]), np.asarray([want[rid]]),
                                 margins[row:row + 1, :k], scale,
                                 f"batcher request {rid}")


def test_batcher_writes_slots_by_name_with_one_layer_and_one_slot(lm):
    """One layer and one slot: the shapes the reference's splice cannot
    tell apart.  Each request's tokens equal its own engine run."""
    _, _, tcfg, _, _ = lm
    cfg1 = dataclasses.replace(tcfg, n_layers=1)
    p1 = M.init_params(M.make_generator(5, "cpu"), cfg1)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg1.vocab_size, (16,)).astype(np.int32)
               for _ in range(3)]
    b = Batcher(cfg1, p1, n_slots=1, gcfg=GenerationConfig(cache_len=64))
    for i, pr in enumerate(prompts):
        b.submit(Request(rid=i, prompt=pr, max_new_tokens=3))
    done = {r.rid: r.generated for r in b.run()}
    eng = ServeEngine(cfg1, p1, GenerationConfig(max_new_tokens=3, cache_len=64))
    for i, pr in enumerate(prompts):
        assert done[i] == eng.generate(pr[None])[0].tolist()


def test_params_from_reference_copies_every_leaf(lm):
    cfg, _, tcfg, tp, tree = lm
    assert torch.equal(tp.tok_embed, torch.from_numpy(np.array(tree["tok_embed"])))
    assert torch.equal(tp.lm_head, torch.from_numpy(np.array(tree["lm_head"])))
    for i, block in enumerate(tp.blocks):
        assert torch.equal(block.ln1, torch.from_numpy(np.array(tree["blocks"]["ln1"][i])))
        for name, arr in tree["blocks"]["ssm"].items():
            assert torch.equal(getattr(block.ssm, name), torch.from_numpy(np.array(arr[i])))
    assert not any(p.requires_grad for p in tp.parameters())
    with pytest.raises(ValueError, match="stacks 2 blocks"):
        params_from_reference(tree, dataclasses.replace(tcfg, n_layers=3), "cpu")


def test_sample_token_greedy_and_top_k():
    logits = torch.tensor([[1.0, 5.0, 2.0, 0.0]])
    gen = torch.Generator().manual_seed(0)
    assert int(sample_token(logits, gen, GenerationConfig(temperature=0.0))[0]) == 1
    top1 = sample_token(logits, gen, GenerationConfig(temperature=5.0, top_k=1))
    assert int(top1[0]) == 1
    draws = {int(sample_token(logits, gen, GenerationConfig(temperature=50.0))[0])
             for _ in range(64)}
    assert len(draws) > 1


# ---------------------------------------------------------------------------
# The CLI and what is not ported
# ---------------------------------------------------------------------------


def test_cli_serves_reduced_mamba2_on_the_cpu(capsys):
    cli.main(["--arch", ARCH, "--device", "cpu", "--requests", "3", "--slots",
              "2", "--prompt-len", "16", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "on cpu" in out
    assert out.count("  req ") == 3


def test_cli_refuses_mesh_other_archs_and_a_missing_gpu(monkeypatch):
    """A production mesh on too few cards and a card that is not there are
    refused (every arch of the registry is served: no arch is refused any
    more; ``--mesh single`` needs 256 cards, as the reference's)."""
    with pytest.raises(ValueError, match="needs 256 devices"):
        cli.main(["--device", "cpu", "--mesh", "single"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main(["--requests", "1"])                      # default: cuda


#: the archs of the families served last (the hybrid, vision and enc-dec
#: families), each with its block kinds
UNPORTED = {"hymba-1.5b": ("hybrid",), "llama-3.2-vision-11b": ("dense", "cross"),
            "seamless-m4t-medium": ("dense", "cross")}


def test_unported_archs_are_the_registry_less_the_served_families():
    """No arch is left unported: the families served since the dense,
    MoE and SSM ones (``UNPORTED``) and those make up the registry."""
    first = {a for a in ref_configs.ARCHS
             if ref_configs.get_config(a).family in ("dense", "moe", "ssm")
             and not ref_configs.get_config(a).hybrid}
    assert set(UNPORTED) == set(ref_configs.ARCHS) - first
    assert ARCH in first and len(first) == 7 and len(configs.ARCHS) == 10


@pytest.mark.parametrize("arch", sorted(UNPORTED))
def test_other_families_raise_not_implemented(arch):
    """Every arch of the registry now inits and sizes its caches on the
    CPU (these three raised before they were served): the parameters hold
    their block kinds, and the zero caches the reference's entries."""
    cfg = configs.reduced_config(arch)
    tp = M.init_params(M.make_generator(0, "cpu"), cfg)
    names = {n.split(".")[0] for n, _ in tp.named_parameters()}
    if cfg.encdec is not None:
        assert {"encoder", "enc_norm", "decoder"} <= names
    elif cfg.cross_attn is not None:
        assert {"self_blocks", "cross_blocks", "ctx_proj"} <= names
    else:
        assert all(b.attn is not None and b.ssm is not None for b in tp.blocks)
    caches = M.init_caches(cfg, 1, 8, device="cpu")
    want = RM.init_caches(ref_configs.reduced_config(arch), 1, 8)
    assert sorted(caches) == sorted(want)
    assert caches["layers"].kv.k.dtype == torch.bfloat16
    assert (caches["layers"].ssm is None) == (want["layers"].ssm is None)
    assert tuple(caches["layers"].kv.k.shape) == want["layers"].kv.k.shape
    assert UNPORTED[arch] == (("hybrid",) if cfg.hybrid else ("dense", "cross"))


def test_fused_mode_mesh_and_bf16_scan_raise(lm, monkeypatch):
    _, _, tcfg, tp, _ = lm
    gcfg = GenerationConfig()
    # the reference's refusal of a fused engine without its envelope
    with pytest.raises(ValueError, match="fused mode needs moe_operand"):
        ServeEngine(tcfg, tp, gcfg, kernel_service=object())
    # mamba2 runs on a mesh (tests/test_torch_mesh_train.py) once its
    # parameters are placed there: unplaced ones are refused
    mesh = make_mesh((1, 2), ("data", "model"), ("cpu",) * 2)
    with pytest.raises(ValueError, match="placed on it"):
        ServeEngine(tcfg, tp, gcfg, mesh=mesh)
    with pytest.raises(ValueError, match="placed on it"):
        Batcher(tcfg, tp, mesh=mesh)
    with pytest.raises(ValueError, match="placed on it"):
        M.forward(tp, tcfg, {"tokens": np.zeros((1, 8), np.int32)}, mesh=mesh)
    # the reference's bf16 scan runs (kernel B8's bf16 form; its parity in
    # tests/test_torch_bf16.py): bf16 y, finite logits of the full shape
    monkeypatch.setattr(ssm, "SSD_BF16", True)
    logits, _ = M.forward(tp, tcfg, {"tokens": np.zeros((1, 8), np.int32)})
    assert logits.shape == (1, 8, tcfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


def test_device_none_is_the_card_and_raises_without_one(lm, monkeypatch):
    _, _, tcfg, tp, _ = lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        M.init_caches(tcfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        M.make_generator(0)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        params_from_reference(lm[4], tcfg)


def test_cache_inits_without_a_device_are_the_card_and_raise_without_one(
        lm, monkeypatch):
    """``init_ssm_state`` and ``init_layer_caches`` resolve ``device=None``
    to the card, as every entry point of the port does: with no GPU they
    raise instead of placing their zeros on the CPU."""
    _, _, tcfg, _, _ = lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ssm.init_ssm_state(tcfg, 2)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        blocks.init_layer_caches(tcfg, tcfg.n_layers, "ssm", 2, 8)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cache_inits_on_the_cpu_match_reference_zeros_and_shapes(lm, dtype):
    cfg, _, tcfg, _, _ = lm
    one = ssm.init_ssm_state(tcfg, 3, getattr(torch, dtype), device="cpu")
    want = ref_ssm.init_ssm_state(cfg, 3, getattr(jnp, dtype))
    caches = blocks.init_layer_caches(tcfg, tcfg.n_layers, "ssm", 3, 8,
                                      getattr(torch, dtype), device="cpu")
    ref = ref_blocks.init_layer_caches(cfg, cfg.n_layers, "ssm", 3, 8,
                                       getattr(jnp, dtype))
    assert caches.kv is None and ref.kv is None
    for got, exp in ((one.state, want.state), (one.conv, want.conv),
                     (caches.ssm.state, ref.ssm.state),
                     (caches.ssm.conv, ref.ssm.conv)):
        assert got.device.type == "cpu"
        assert tuple(got.shape) == tuple(exp.shape)
        assert str(got.dtype).removeprefix("torch.") == str(exp.dtype)
        assert not got.any()


def test_prompt_ids_out_of_range_are_refused_before_upload(lm):
    from repro_torch.analysis import LaunchPlanError

    _, _, tcfg, tp, _ = lm
    bad = np.array([[1, 2, tcfg.vocab_size]], np.int32)
    with pytest.raises(LaunchPlanError, match="out of bounds"):
        M.forward(tp, tcfg, {"tokens": bad})
