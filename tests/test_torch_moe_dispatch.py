"""Parity of the port's MoE expert dispatch (``repro_torch.kernels.ops
.moe_dispatch``, ``KernelRegistry.register_moe`` and the service op
``moe_dispatch``) with the reference's, on the CPU.

Both packages see the same numpy-seeded routing matrices and expert-output
stacks; the reference runs its Pallas kernels in interpret mode, the port
its plain versions because the spec or registry asks for the CPU.
Tolerance 1e-10 at fp64, the reference's own
(``tests/test_moe_dispatch.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.analysis.preflight import SlabMeta as RefSlabMeta
from repro.analysis.preflight import plan_moe_dispatch as ref_plan_moe
from repro.kernels import ops as ref_ops
from repro.kernels.execspec import ExecSpec as RefExecSpec
from repro.service import KernelRegistry as RefRegistry
from repro.service import KernelService as RefService
from repro.sparse import formats as RF
from repro_torch.analysis import LaunchPlanError, SlabMeta, plan_moe_dispatch
from repro_torch.graphs import gen as G
from repro_torch.kernels import ops, sell_core
from repro_torch.kernels.execspec import ExecSpec
from repro_torch.service import KernelRegistry, KernelService
from repro_torch.service.registry import moe_k_block
from repro_torch.sparse import formats as F

TOL = dict(rtol=1e-10, atol=1e-10)
SELL = ExecSpec(dispatch="sell", vl=32, device="cpu")
DENSE = ExecSpec(dispatch="dense", device="cpu")
REF_SELL = RefExecSpec(dispatch="sell", vl=32, interpret=True)
REF_DENSE = RefExecSpec(dispatch="dense", interpret=True)


def routing(n_tok, n_slots, top_k, rng, dtype=np.float64):
    """Random routing matrix as (reference CSR, port CSR): <= top_k entries
    a row, some rows short (dropped assignments leave gaps in real routing
    too)."""
    indptr, indices, data = [0], [], []
    for _ in range(n_tok):
        w = int(rng.integers(0, top_k + 1))
        cols = np.sort(rng.choice(n_slots, size=w, replace=False))
        indices.extend(int(c) for c in cols)
        data.extend(rng.random(w).tolist())
        indptr.append(len(indices))
    arrays = dict(indptr=np.asarray(indptr, np.int64),
                  indices=np.asarray(indices, np.int32),
                  data=np.asarray(data, dtype), n_cols=n_slots)
    return RF.CSRMatrix(**arrays), F.CSRMatrix(**arrays)


# ---------------------------------------------------------------------------
# ops.moe_dispatch against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_tok,n_slots,top_k,d", [
    (64, 96, 2, 16),       # mixtral-shaped top-2
    (33, 200, 4, 64),      # ragged token count, serving-tile d
    (128, 64, 6, 48),      # deepseek-shaped top-6, non-pow2 d
])
def test_ops_moe_dispatch_matches_reference(n_tok, n_slots, top_k, d):
    ref, port = routing(n_tok, n_slots, top_k, np.random.default_rng(n_tok))
    x = np.random.default_rng(11).standard_normal((n_slots, d))
    want = np.asarray(ref_ops.moe_dispatch(ref, jnp.asarray(x),
                                           spec=REF_SELL, top_k=top_k))
    want_dense = np.asarray(ref_ops.moe_dispatch(ref, jnp.asarray(x),
                                                 spec=REF_DENSE, top_k=top_k))
    got = ops.moe_dispatch(port, x, spec=SELL, top_k=top_k)
    dense = ops.moe_dispatch(port, x, spec=DENSE, top_k=top_k)
    streamed = ops.moe_dispatch(port, torch.from_numpy(x), top_k=top_k,
                                spec=dataclasses.replace(SELL, mode="stream"))
    assert tuple(got.shape) == (n_tok, d) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(dense.numpy(), want_dense, **TOL)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **TOL)
    assert torch.equal(streamed, got)
    # pre-packed slabs and the auto dispatch take the same path
    slabs = F.csr_to_sell_slabs(port, c=32)
    again = ops.moe_dispatch(slabs, x, spec=dataclasses.replace(
        SELL, dispatch="auto"), top_k=top_k)
    assert torch.equal(again, got)


def test_ops_moe_dispatch_refusals():
    ref, port = routing(32, 64, 16, np.random.default_rng(3))
    x = np.random.default_rng(4).standard_normal((64, 16))
    # a 16-wide row against top_k = 2 fails the launch preflight, not math
    with pytest.raises(LaunchPlanError, match="top_k"):
        ops.moe_dispatch(port, x, spec=SELL, top_k=2)
    # the streaming plan keeps the routing contract (it plans on top of it)
    before = sell_core.STREAM_LAUNCHES
    with pytest.raises(LaunchPlanError, match="top_k"):
        ops.moe_dispatch(port, x, spec=dataclasses.replace(
            SELL, mode="stream"), top_k=2)
    assert sell_core.STREAM_LAUNCHES == before
    with pytest.raises(ValueError, match="unknown dispatch"):
        ops.moe_dispatch(port, x, spec=dataclasses.replace(
            SELL, dispatch="sparse"), top_k=16)
    with pytest.raises(TypeError, match="CSR"):
        ops.moe_dispatch(F.csr_to_sell_slabs(port, c=32), x, spec=DENSE,
                         top_k=16)
    with pytest.raises(TypeError, match="routing must be"):
        ops.moe_dispatch(object(), x, spec=SELL, top_k=16)
    with pytest.raises(ValueError, match=r"\(n_slots, d\)"):
        ops.moe_dispatch(port, x[:, 0], spec=SELL, top_k=16)


def test_plan_moe_dispatch_matches_the_references_verdicts():
    """The routing contract: a general sparse matrix (bucket wider than
    pow2_ceil(top_k)) is not a dispatch operand though it would SpMM, a
    graph pack is not one either, and top_k must be positive."""
    wide_ref = RF.random_csr(128, 128, 12.0, seed=2)
    wide = F.CSRMatrix(indptr=wide_ref.indptr, indices=wide_ref.indices,
                       data=wide_ref.data, n_cols=128)
    narrow_ref, narrow = routing(128, 128, 2, np.random.default_rng(4))
    for ref_csr, csr, top_k, ok in ((wide_ref, wide, 2, False),
                                    (narrow_ref, narrow, 2, True),
                                    (narrow_ref, narrow, 0, False)):
        ref_plan = ref_plan_moe(
            RefSlabMeta.from_slabs(RF.csr_to_sell_slabs(ref_csr, c=32)),
            k=64, x_dtype="float64", top_k=top_k)
        plan = plan_moe_dispatch(
            SlabMeta.from_slabs(F.csr_to_sell_slabs(csr, c=32)),
            k=64, x_dtype="float64", top_k=top_k)
        assert plan.ok == ref_plan.ok == ok
        assert plan.kernel == "moe_dispatch"
        if not ok:
            assert any("top_k" in v for v in plan.violations)
    graph = SlabMeta.from_slabs(G.graph_to_sell_slabs(
        G.random_graph(64, 2, seed=1), c=8))
    plan = plan_moe_dispatch(graph, k=8, top_k=8)
    assert not plan.ok and any("'matrix'" in v for v in plan.violations)


# ---------------------------------------------------------------------------
# The service: register_moe envelope + coalesced moe_dispatch launches
# ---------------------------------------------------------------------------


def _services(n_tokens=64, n_slots=96, d_model=16, top_k=2, n_slots_svc=4):
    ref_reg, reg = RefRegistry(), KernelRegistry(device="cpu")
    for r in (ref_reg, reg):
        r.register_moe("moe", n_tokens=n_tokens, n_slots=n_slots,
                       d_model=d_model, top_k=top_k)
    return (RefService(ref_reg, n_slots=n_slots_svc),
            KernelService(reg, n_slots=n_slots_svc))


def _payload(csr, x):
    return {"indptr": csr.indptr, "indices": csr.indices, "data": csr.data,
            "x": x}


def _result(svc, rid):
    y = svc.poll(rid)
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def test_service_coalesces_moe_dispatch_like_the_reference(monkeypatch):
    """Three requests in one round are ONE block-diagonal dispatch call on
    both services, each caller getting exactly its own rows back."""
    ref_svc, svc = _services()
    calls = []
    real = ops.moe_dispatch

    def counting(routing, x, **kw):
        calls.append((routing.n_rows, routing.n_cols, tuple(x.shape)))
        return real(routing, x, **kw)

    monkeypatch.setattr(ops, "moe_dispatch", counting)
    rng = np.random.default_rng(5)
    reqs = []
    for i in range(3):
        ref, port = routing(16 + 4 * i, 32, 2, rng)
        x = rng.standard_normal((32, 16))
        reqs.append((ref_svc.submit("moe_dispatch", "moe", _payload(ref, x)),
                     svc.submit("moe_dispatch", "moe", _payload(port, x)),
                     port, x))
    ref_svc.drain()
    svc.drain()
    assert calls == [(16 + 20 + 24, 96, (96, 16))]
    for key in ("moe_dispatch_launches", "launches", "served", "groups",
                "coalesced", "max_group"):
        assert svc.stats[key] == ref_svc.stats[key], key
    assert svc.stats["moe_dispatch_launches"] == 1
    for r_ref, r_port, port, x in reqs:
        got = _result(svc, r_port)
        np.testing.assert_allclose(got, _result(ref_svc, r_ref), **TOL)
        np.testing.assert_allclose(
            got, ops.moe_dispatch(port, x, spec=DENSE, top_k=2).numpy(),
            **TOL)
    assert svc.metrics.get("latency_us_class_moe_dispatch").count == 3
    assert svc.registry.get("moe").launches == 1


def test_service_validates_moe_payload_against_envelope():
    """Bad payloads fail their own request with the reference's message and
    spare their coalesced groupmates."""
    ref_svc, svc = _services(d_model=16, top_k=2, n_tokens=64)
    rng = np.random.default_rng(6)
    ok_ref, ok = routing(16, 32, 2, rng)
    ok_x = rng.standard_normal((32, 16))
    wide_ref, wide = routing(16, 32, 5, rng)
    while np.diff(wide.indptr).max() <= 2:              # ensure a wide row
        wide_ref, wide = routing(16, 32, 5, rng)
    oob_ref, oob = routing(16, 32, 2, rng)
    oob.indices[0] = 99                                 # beyond x's rows
    many_ref, many = routing(128, 32, 2, rng)           # beyond the envelope
    bad_x = rng.standard_normal((32, 7))
    cases = [((wide_ref, ok_x), (wide, ok_x), "top_k"),
             ((ok_ref, bad_x), (ok, bad_x), "must have shape"),
             ((oob_ref, ok_x), (oob, ok_x), "out of range"),
             ((many_ref, rng.standard_normal((32, 16))),
              (many, rng.standard_normal((32, 16))), "envelope")]
    rids = [(ref_svc.submit("moe_dispatch", "moe", _payload(*r)),
             svc.submit("moe_dispatch", "moe", _payload(*p)), match)
            for r, p, match in cases]
    rids.append((ref_svc.submit("moe_dispatch", "moe", _payload(ok_ref, ok_x)),
                 svc.submit("moe_dispatch", "moe", _payload(ok, ok_x)), None))
    bad_type = svc.submit("moe_dispatch", "moe", [1, 2, 3])
    ref_svc.drain()
    svc.drain()
    for r_ref, r_port, match in rids:
        if match is None:
            np.testing.assert_allclose(_result(svc, r_port),
                                       _result(ref_svc, r_ref), **TOL)
            continue
        for s, rid in ((ref_svc, r_ref), (svc, r_port)):
            with pytest.raises(RuntimeError, match=match):
                s.poll(rid)
    with pytest.raises(RuntimeError, match="payload must be a dict"):
        svc.poll(bad_type)
    assert svc.stats["failed"] == 5 and svc.stats["served"] == 1


def test_register_moe_mirrors_the_reference_and_refuses_bad_envelopes():
    ref_reg, reg = RefRegistry(), KernelRegistry(device="cpu")
    for r in (ref_reg, reg):
        with pytest.raises(ValueError, match="top_k"):
            r.register_moe("moe", n_tokens=64, n_slots=96, d_model=16,
                           top_k=0)
    ref_op = ref_reg.register_moe("moe", n_tokens=64, n_slots=96, d_model=16,
                                  top_k=2)
    op = reg.register_moe("moe", n_tokens=64, n_slots=96, d_model=16,
                          top_k=2)
    assert op.kind == ref_op.kind == "moe" and op.moe == ref_op.moe
    assert op.plans["moe_dispatch"].ok
    assert (op.slab_meta.widths, op.slab_meta.n_slices) == \
        (ref_op.slab_meta.widths, ref_op.slab_meta.n_slices)
    # an envelope the kernel cannot run is refused at registration
    with pytest.raises(LaunchPlanError, match="float16"):
        reg.register_moe("half", n_tokens=64, n_slots=96, d_model=16,
                         top_k=2, dtype="float16")
    assert "half" not in reg
    # and a plan that drifts out of the kernel's envelope at submit
    svc = KernelService(reg, n_slots=2)
    op.slab_meta = dataclasses.replace(op.slab_meta, widths=(64,))
    with pytest.raises(LaunchPlanError, match="top_k"):
        svc.submit("moe_dispatch", "moe", {})
    assert svc.stats["preflight_rejected"] == 1


def test_moe_k_block_is_the_register_fitted_tile():
    assert moe_k_block(4096) == 32 and moe_k_block(2048, "float32") == 32
    assert moe_k_block(16) == 16 and moe_k_block(3) == 4
