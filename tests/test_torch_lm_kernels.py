"""Parity of the port's LM kernels — the embedding gather (kernel B9,
``repro_torch.kernels.gather``) and the fused SSD scan (kernel B8,
``repro_torch.kernels.ssd``) — and their preflight with the JAX reference.

The same numpy-seeded inputs go through both packages.  The reference's
Pallas kernels run in interpret mode with x64 on, as
``tests/test_kernels.py`` runs them; the port runs on the CPU, where each
wrapper takes its plain PyTorch path because its tensors lie there.
Tolerances, the reference's own (``tests/test_kernels.py``): the gather
exactly (a copy); the scan 2e-4 at fp32 and 1e-10 at fp64, and 3e-4 in the
Hypothesis property.  Against the reference's ``ssd_chunked``, whose
inter-chunk carry is float32 whatever the inputs (``ssm.py:118-119, 142``),
the fp64 scan agrees only to fp32 rounding (2e-4).  The kernels themselves
are held against the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch
from _hypothesis_fallback import given, settings, st

import jax.numpy as jnp

from repro.kernels.gather import embedding_gather as ref_gather
from repro.kernels.ssd import ssd_fused as ref_ssd_fused
from repro.models.ssm import ssd_chunked as ref_ssd_chunked
from repro.models.ssm import ssd_reference as ref_ssd_reference
from repro_torch.analysis import LaunchPlanError, plan_embedding_gather, plan_ssd_fused
from repro_torch.core import autotune
from repro_torch.kernels import gather, ssd

RNG = np.random.default_rng(21)
TOLS = {np.float32: 2e-4, np.float64: 1e-10}


# ---------------------------------------------------------------------------
# Embedding gather (B9)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vl", [8, 64, 256])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_embedding_gather_equals_reference(vl, dtype):
    table = RNG.standard_normal((500, 32)).astype(dtype)
    ids = RNG.integers(0, 500, (300,)).astype(np.int32)
    want = np.asarray(ref_gather(jnp.asarray(table), jnp.asarray(ids), vl=vl))
    got = gather.embedding_gather(torch.from_numpy(table), ids, vl=vl)
    assert got.dtype == torch.from_numpy(table).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    # int64 tokens (the model's) and a CPU tensor give the same rows
    again = gather.embedding_gather(torch.from_numpy(table),
                                    torch.from_numpy(ids.astype(np.int64)))
    assert torch.equal(again, got)


@given(
    t=st.integers(min_value=1, max_value=200),
    v=st.integers(min_value=2, max_value=300),
    vl=st.sampled_from([8, 32]),
    seed=st.integers(0, 2**16),
)
@settings(max_examples=10, deadline=None)
def test_embedding_gather_property(t, v, vl, seed):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, 16))
    ids = rng.integers(0, v, (t,)).astype(np.int32)
    got = gather.embedding_gather(torch.from_numpy(table), ids, vl=vl)
    np.testing.assert_array_equal(got.numpy(), table[ids])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_gather(jnp.asarray(table), jnp.asarray(ids),
                                           vl=vl)))


@pytest.mark.parametrize("ids,match", [
    (np.array([0, 7, 10]), "out of bounds"),                 # id == V
    (np.array([3, -1]), "out of bounds"),                    # would wrap in torch
    (np.array([1.0, 2.0]), "not an integer"),
    (np.array([[1, 2]]), "one axis"),
])
def test_gather_preflight_refuses_before_any_launch(ids, match):
    """JAX clamps an out-of-range gather; a CUDA kernel would read out of
    bounds.  The plan scans host ids and raises before upload or launch,
    on the CPU as on the card."""
    table = torch.zeros((10, 4))
    before = gather.KERNEL_LAUNCHES
    with pytest.raises(LaunchPlanError, match=match):
        gather.embedding_gather(table, ids)
    with pytest.raises(LaunchPlanError, match=match):
        gather.embedding_gather(table, torch.from_numpy(ids))
    assert gather.KERNEL_LAUNCHES == before


def test_gather_plan_shape_and_wrapper_contract():
    plan = plan_embedding_gather(50_280, 2560, np.arange(513), vl=256)
    assert plan.ok and plan.n_launches == 1
    (blk,) = plan.blocks
    # one 160-thread block a row: 5 warps x 64 B a thread = 10,240 B
    assert blk.grid == (513, 1) and blk.block == (160,)
    assert ("ids", (513,), "int64") in blk.operands
    assert ("out", (513, 2560), "float32") in blk.operands
    # vl only names the reference's grid step: the CUDA grid ignores it
    assert plan_embedding_gather(50_280, 2560, np.arange(513), vl=8).blocks == plan.blocks
    assert "table dtype" in plan_embedding_gather(
        10, 4, np.arange(3), dtype="float16").violations[0]
    with pytest.raises(TypeError, match="float32 or float64"):
        gather.embedding_gather(torch.zeros((10, 4), dtype=torch.float16),
                                np.arange(3))
    with pytest.raises(ValueError, match=r"\(V, d\)"):
        gather.embedding_gather(torch.zeros(10), np.arange(3))
    empty = gather.embedding_gather(torch.zeros((10, 4)), np.zeros(0, np.int32))
    assert empty.shape == (0, 4)


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("vl", [8, 64, 256])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_embedding_gather_id_types_equal_reference(dtype, vl, id_dtype,
                                                   as_tensor):
    """int32 and int64 ids, as numpy arrays or CPU tensors: the same rows
    as the reference's gather, exactly."""
    rng = np.random.default_rng(vl)
    table = rng.standard_normal((700, 24)).astype(dtype)
    ids = rng.integers(0, 700, (257,)).astype(id_dtype)
    want = np.asarray(ref_gather(jnp.asarray(table), jnp.asarray(ids), vl=vl))
    got = gather.embedding_gather(torch.from_numpy(table),
                                  torch.from_numpy(ids) if as_tensor else ids,
                                  vl=vl)
    assert torch.equal(got, torch.from_numpy(np.array(want)))


@pytest.mark.parametrize("t", [1, 4, 512, 2048])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_gather_cached_device_ids_plan_equals_a_fresh_one(t, id_dtype):
    """Ids on a device (a meta tensor stands in for the card here) are
    never read back, so their plan is built once per (V, d, T, id dtype,
    table dtype) and reused: the cached plan is the plan built afresh, and
    the plan of in-range host ids of the same shape, which reuse it."""
    on_device = torch.empty((t,), dtype=id_dtype, device="meta")
    cached = gather._plan(50_280, 2560, on_device, "float32", 256)
    assert gather._plan(50_280, 2560, on_device, "float32", 256) is cached
    fresh = plan_embedding_gather(50_280, 2560, on_device, dtype="float32")
    assert cached == fresh and cached.ok
    host = torch.arange(t, dtype=id_dtype)
    assert plan_embedding_gather(50_280, 2560, host, dtype="float32") == cached
    assert gather._plan(50_280, 2560, host, "float32", 256) is cached


def test_gather_host_ids_are_scanned_on_every_call():
    """A cached plan of the same shape never lets host ids through
    unscanned: out-of-range host ids are refused before any upload on every
    call, before and after in-range ones and a cached device-ids plan."""
    table = torch.zeros((10, 4))
    gather._plan(10, 4, torch.empty((3,), dtype=torch.int64, device="meta"),
                 "float32", 256)
    bad = np.array([0, 7, 10])
    before = gather.KERNEL_LAUNCHES
    for ids in (bad, np.array([0, 7, 9]), bad, torch.from_numpy(bad)):
        if int(ids.max()) < 10:
            assert gather.embedding_gather(table, ids).shape == (3, 4)
            continue
        with pytest.raises(LaunchPlanError, match="out of bounds"):
            gather.embedding_gather(table, ids)
    assert gather.KERNEL_LAUNCHES == before


@pytest.mark.parametrize("v", [10, 500])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_card_ids_out_of_range_read_the_reference_rows(v, dtype):
    """Ids as they may lie on the card, outside ``[0, V)`` (V, V + 7, -1,
    -V - 3, 2^31 - 1, int32): the rows :func:`gather.clamp_ids` picks,
    the rule the kernel applies on the card, are the rows the reference's
    gather returns for the same ids; the plain version reads them."""
    table = RNG.standard_normal((v, 8)).astype(dtype)
    ids = np.array([v, v + 7, -1, -v - 3, 2**31 - 1, 3, -v, -2 * v, 0],
                   np.int32)
    want = np.asarray(ref_gather(jnp.asarray(table), jnp.asarray(ids), vl=8))
    rows = gather.clamp_ids(torch.from_numpy(ids), v)
    assert rows.dtype == torch.int64
    assert int(rows.min()) >= 0 and int(rows.max()) <= v - 1
    np.testing.assert_array_equal(table[rows.numpy()], want)
    got = gather.embedding_gather_ref(torch.from_numpy(table),
                                      torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    # int64 ids are bounded as they are: past int32 they read the last or
    # the first row, never outside the table
    big = torch.tensor([2**31, 2**40, -2**31 - 5, v - 1], dtype=torch.int64)
    assert gather.clamp_ids(big, v).tolist() == [v - 1, v - 1, 0, v - 1]


def _grid_cover(t, row_bytes, vec_bytes):
    """Python mirror of the kernel's grid: every (row, vector) that block
    (row, c), thread x, load k copies, for vectors of ``vec_bytes``."""
    chunks, threads = autotune.gather_grid(t, row_bytes)
    loads = autotune.GATHER_THREAD_BYTES // vec_bytes
    row_vecs = row_bytes // vec_bytes
    seen = []
    for c in range(chunks):
        begin = c * loads * threads
        for x in range(threads):
            for k in range(loads):
                i = begin + x + k * threads
                if i < row_vecs:
                    seen.append(i)
    return chunks, threads, seen


@pytest.mark.parametrize("t,d,itemsize", [(512, 2560, 4), (4, 2560, 4),
                                          (1, 2560, 8), (2048, 2560, 4),
                                          (7, 66, 4), (3, 3, 4), (1000, 1, 8),
                                          (1, 4100, 8)])
def test_gather_grid_covers_every_vector_once(t, d, itemsize):
    """Each vector of a row (16, 8 or 4 B, as the pointers allow) is copied
    by exactly one (block, thread, load): the chunks cover the row and no
    chunk starts past its end; whole warps, at most 256 threads; and at T =
    512, d = 2560 fp32 the grid has at least two blocks for each of 132
    SMs."""
    row_bytes = d * itemsize
    for vec in (16, 8, 4):
        if row_bytes % vec:
            continue
        chunks, threads, seen = _grid_cover(t, row_bytes, vec)
        assert sorted(seen) == list(range(row_bytes // vec))
        chunk_bytes = autotune.GATHER_THREAD_BYTES * threads
        assert (chunks - 1) * chunk_bytes < row_bytes <= chunks * chunk_bytes
        assert threads % autotune.WARP == 0
        assert threads <= autotune.GATHER_MAX_THREADS
    plan = plan_embedding_gather(50_000, d, np.zeros(t, np.int32),
                                 dtype="float32" if itemsize == 4 else "float64")
    assert plan.blocks[0].grid == (t, chunks)
    if (t, d, itemsize) == (512, 2560, 4):
        assert t * chunks >= 2 * autotune.SM_COUNT


# ---------------------------------------------------------------------------
# Fused SSD scan (B8)
# ---------------------------------------------------------------------------


def _ssd_inputs(rng, b, l, h, p, g, n, dtype, scale=0.3):
    return (rng.standard_normal((b, l, h, p)).astype(dtype),
            (-np.abs(rng.standard_normal((b, l, h))) * scale).astype(dtype),
            rng.standard_normal((b, l, g, n)).astype(dtype),
            rng.standard_normal((b, l, g, n)).astype(dtype))


def _port(arrs, **kw):
    return ssd.ssd_fused(*(torch.from_numpy(a) for a in arrs), **kw)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("chunk", [8, 16, 64])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ssd_fused_matches_reference(chunk, g, dtype):
    rng = np.random.default_rng(chunk + g)
    arrs = _ssd_inputs(rng, 2, 64, 4, 8, g, 16, dtype)
    y0, f0 = ref_ssd_fused(*(jnp.asarray(a) for a in arrs), chunk=chunk)
    y1, f1 = _port(arrs, chunk=chunk)
    assert y1.dtype == torch.from_numpy(arrs[0]).dtype and f1.dtype == y1.dtype
    tol = TOLS[dtype]
    np.testing.assert_allclose(y1.numpy(), np.asarray(y0), atol=tol, rtol=tol)
    np.testing.assert_allclose(f1.numpy(), np.asarray(f0), atol=tol, rtol=tol)


@given(
    logl=st.integers(min_value=3, max_value=6),
    chunk=st.sampled_from([4, 8]),
    seed=st.integers(0, 2**16),
)
@settings(max_examples=8, deadline=None)
def test_ssd_fused_property(logl, chunk, seed):
    rng = np.random.default_rng(seed)
    arrs = _ssd_inputs(rng, 1, 1 << logl, 2, 4, 1, 8, np.float32, scale=0.5)
    y0, f0 = ref_ssd_reference(*(jnp.asarray(a) for a in arrs))
    y1, f1 = _port(arrs, chunk=chunk)
    np.testing.assert_allclose(y1.numpy(), np.asarray(y0), atol=3e-4)
    np.testing.assert_allclose(f1.numpy(), np.asarray(f0), atol=3e-4)
    y2, f2 = ref_ssd_fused(*(jnp.asarray(a) for a in arrs), chunk=chunk)
    np.testing.assert_allclose(y1.numpy(), np.asarray(y2), atol=3e-4)
    np.testing.assert_allclose(f1.numpy(), np.asarray(f2), atol=3e-4)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ssd_with_init_state_matches_chunked_and_recurrence(dtype):
    """With an initial state the scan meets ``ssd_chunked``'s contract (the
    one the model calls) and the per-token recurrence's."""
    rng = np.random.default_rng(5)
    arrs = _ssd_inputs(rng, 2, 48, 4, 8, 2, 16, dtype)
    init = rng.standard_normal((2, 4, 8, 16)).astype(dtype)
    y1, f1 = _port(arrs, chunk=16, init_state=torch.from_numpy(init))
    tol = TOLS[dtype]
    y0, f0 = ref_ssd_reference(*(jnp.asarray(a) for a in arrs), jnp.asarray(init))
    np.testing.assert_allclose(y1.numpy(), np.asarray(y0), atol=tol, rtol=tol)
    np.testing.assert_allclose(f1.numpy(), np.asarray(f0), atol=tol, rtol=tol)
    # the reference's chunked scan carries its state in float32; with f64
    # ``ad`` it does not trace under x64 at all, so it is fed ad in float32
    # (the model's dtype; these values are f32-exact after the cast)
    xd, ad, B, C = arrs
    ad32 = ad.astype(np.float32)
    y2, f2 = ref_ssd_chunked(jnp.asarray(xd), jnp.asarray(ad32), jnp.asarray(B),
                             jnp.asarray(C), 16, jnp.asarray(init))
    y3, f3 = _port((xd, ad32.astype(dtype), B, C), chunk=16,
                   init_state=torch.from_numpy(init))
    np.testing.assert_allclose(y3.numpy(), np.asarray(y2), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(f3.numpy(), np.asarray(f2), atol=2e-4, rtol=2e-4)
    # init_state=None is the zero state, ssd_fused's own contract
    y4, f4 = _port(arrs, chunk=16)
    y5, f5 = _port(arrs, chunk=16, init_state=torch.zeros((2, 4, 8, 16),
                                                          dtype=y4.dtype))
    assert torch.equal(y4, y5) and torch.equal(f4, f5)


@pytest.mark.parametrize("shape,chunk,dtype,match", [
    ((1, 60, 4, 8, 1, 16), 16, "float32", "multiple of the chunk"),
    ((1, 8, 4, 8, 1, 16), 16, "float32", "multiple of the chunk"),
    ((1, 64, 4, 8, 3, 16), 16, "float32", "not a multiple of 3 groups"),
    ((1, 64, 4, 8, 1, 16), 0, "float64", "chunk must be >= 1"),
])
def test_ssd_plan_refusals_raise_before_any_launch(shape, chunk, dtype, match):
    b, l, h, p, g, n = shape
    plan = plan_ssd_fused(b, l, h, p, g, n, chunk=chunk, dtype=dtype)
    assert any(match in v for v in plan.violations), plan.violations
    arrs = _ssd_inputs(np.random.default_rng(0), *shape, np.dtype(dtype).type)
    before = ssd.KERNEL_LAUNCHES
    with pytest.raises(LaunchPlanError, match=match):
        _port(arrs, chunk=chunk)
    assert ssd.KERNEL_LAUNCHES == before


def test_ssd_wrapper_refuses_mixed_dtypes_and_shapes():
    arrs = _ssd_inputs(np.random.default_rng(0), 1, 16, 2, 4, 1, 8, np.float32)
    xd, ad, B, C = (torch.from_numpy(a) for a in arrs)
    with pytest.raises(TypeError, match="ad dtype"):
        ssd.ssd_fused(xd, ad.double(), B, C, chunk=8)
    with pytest.raises(TypeError, match="float32 or float64"):
        ssd.ssd_fused(xd.half(), ad.half(), B.half(), C.half(), chunk=8)
    with pytest.raises(ValueError, match="init_state"):
        ssd.ssd_fused(xd, ad, B, C, chunk=8, init_state=torch.zeros(1, 2, 4, 9))
    with pytest.raises(ValueError, match=r"\(b, l, g, n\)"):
        ssd.ssd_fused(xd, ad, B[:, :8], C, chunk=8)


def test_ssd_plan_at_mamba2_widths():
    """mamba2-2.7b's prefill: h 80, p 64, n 128, chunk 256.  Three
    launches: chunk states (a block per (b, h, chunk) and 64 x 64 state
    tile), the state pass, chunk outputs (a block per (b, h, chunk) and
    64-row query tile).  At b = 1 both tiled launches give every SM 16
    warps; shared memory is fixed, so both dtypes fit."""
    one = plan_ssd_fused(1, 512, 80, 64, 1, 128, chunk=256)
    four = plan_ssd_fused(4, 512, 80, 64, 1, 128, chunk=256, dtype="float64")
    assert one.ok and four.ok
    assert one.n_launches == four.n_launches == ssd.LAUNCHES_PER_CALL == 3
    assert [b.grid for b in one.blocks] == [(160, 1, 2), (80, 32), (160, 4)]
    assert four.blocks[2].grid == (640, 4)
    assert autotune.ssd_grids(1, 512, 80, 64, 128, 256)["chunk_output"] \
        == (160, 4)
    assert one.blocks[2].smem_bytes == autotune.ssd_smem_bytes(
        "chunk_output", 4)
    assert four.blocks[2].smem_bytes <= autotune.SMEM_PER_BLOCK
    for blk in (one.blocks[0], one.blocks[2]):
        assert autotune.ssd_warps_per_sm(blk.grid, blk.smem_bytes) >= 16
    assert autotune.ssd_grids(2, 64, 4, 8, 16, 16)["chunk_state"] == (32, 1, 1)


def test_ssd_sizing_functions():
    """The fixed shared memory of B8's launches, the flops they execute
    against the function's, and the warps an SM holds."""
    lds = autotune.SSD_TILE + 4
    kc, t = autotune.SSD_K_CHUNK, autotune.SSD_TILE
    assert autotune.ssd_smem_bytes("chunk_output", 8) == \
        (4 * kc * lds + t * lds + 2 * t) * 8
    # fp32 runs the tensor-core form: row-major (64, 36) operand stages
    assert autotune.ssd_smem_bytes("chunk_output", 4) == \
        (4 * t * (kc + 4) + t * lds + 2 * t) * 4
    assert autotune.ssd_smem_bytes("state_pass", 8) == 0
    assert autotune.ssd_smem_bytes("chunk_state", 8) < \
        autotune.ssd_smem_bytes("chunk_output", 8) < autotune.SMEM_PER_BLOCK
    assert autotune.ssd_flops(1, 512, 80, 64, 128, 256) == 3_363_307_520
    ex = autotune.ssd_flops_executed(1, 512, 80, 64, 128, 256)
    assert ex == {"chunk_state": 671_088_640, "state_term": 335_544_320,
                  "cb": 1_677_721_600, "gx": 838_860_800}
    # with an initial state the first chunk's carried term runs too
    assert autotune.ssd_flops_executed(1, 512, 80, 64, 128, 256,
                                       init=True)["state_term"] == 671_088_640
    # tiles padded to 64 on the diagonal: never less than the function
    for shape in ((1, 512, 80, 64, 128, 256), (2, 64, 4, 8, 16, 16),
                  (1, 192, 4, 32, 16, 64)):
        b, _, h, p, n, q = shape        # less only the skipped zero state
        assert sum(autotune.ssd_flops_executed(*shape).values()) >= \
            autotune.ssd_flops(*shape) - 2 * b * h * q * n * p
    # a grid of fewer blocks than SMs guarantees none
    assert autotune.ssd_warps_per_sm((64, 1), 35_000) == 0
    assert autotune.ssd_warps_per_sm((640, 4), 70_656) == 16


@pytest.mark.parametrize("chunk,l", [(16, 48), (64, 192), (128, 256), (96, 192)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ssd_chunk_parallel_model_matches_reference(chunk, l, dtype):
    """B8's decomposition as a plain torch model (segmented cum, chunk
    states, the carry, query tiles over the key tiles on and below the
    diagonal) against the reference's kernel in interpret mode and the
    plain chunk loop, from a zero and a random initial state."""
    rng = np.random.default_rng(chunk + l)
    arrs = _ssd_inputs(rng, 1, l, 4, 8, 2, 16, dtype)
    tol = TOLS[dtype]
    y0, f0 = ref_ssd_fused(*(jnp.asarray(a) for a in arrs), chunk=chunk)
    tens = [torch.from_numpy(a) for a in arrs]
    y1, f1 = ssd.ssd_chunk_parallel_model(*tens, chunk=chunk)
    assert y1.dtype == tens[0].dtype and f1.shape == (1, 4, 8, 16)
    np.testing.assert_allclose(y1.numpy(), np.asarray(y0), atol=tol, rtol=tol)
    np.testing.assert_allclose(f1.numpy(), np.asarray(f0), atol=tol, rtol=tol)
    init = torch.from_numpy(rng.standard_normal((1, 4, 8, 16)).astype(dtype))
    y2, f2 = ssd.ssd_chunk_parallel_model(*tens, chunk=chunk, init_state=init)
    y3, f3 = ssd.ssd_fused_ref(*tens, chunk=chunk, init_state=init)
    torch.testing.assert_close(y2, y3, atol=tol, rtol=tol)
    torch.testing.assert_close(f2, f3, atol=tol, rtol=tol)


def test_segsum_matches_reference():
    """The decay matrix of B8's plain version: the reference's ``_segsum``
    (``-inf`` above the diagonal, so its exp is exactly 0 there)."""
    from repro.models.ssm import _segsum as ref_segsum

    a = (-np.abs(np.random.default_rng(9).standard_normal((2, 3, 16)))).astype(np.float64)
    got = ssd.segsum(torch.from_numpy(a)).numpy()
    want = np.asarray(ref_segsum(jnp.asarray(a)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert np.all(np.exp(got)[..., ~np.tri(16, dtype=bool)] == 0.0)


# ---------------------------------------------------------------------------
# bf16 forms: B8 on the reference model's SSD_BF16 mix (bf16 xd / B / C,
# float32 ad), B9 on a bf16 table
# ---------------------------------------------------------------------------


def _bf16(a):
    """A float32 array rounded to bf16 once: (the torch tensor, its values
    as float32 numpy), so that both packages see the same bf16 values."""
    t = torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
    return t, t.float().numpy()


def _jbf16(v):
    return jnp.asarray(v).astype(jnp.bfloat16)


def _within_one_ulp(got, want):
    """|got - want| <= one bf16 ulp of max(|got|, |want|) + 1e-6 x
    max|want|, elementwise: two float32 sums of different order, each
    rounded once to bf16.  The float32 sums themselves differ at fp32's
    level of the terms (~1e-7 x max|y|), which near y = 0 exceeds a bf16
    ulp of y: the second term covers that with a 10x margin."""
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    bound = ulp + 1e-6 * float(np.abs(want).max())
    worst = float(np.max(np.abs(got - want) / bound))
    assert worst <= 1.0, f"{worst} x (one bf16 ulp + 1e-6 max|y|)"


@pytest.mark.parametrize("form", ["chunk_loop", "chunk_parallel"])
@pytest.mark.parametrize("g,chunk", [(1, 16), (2, 8)])
def test_ssd_bf16_matches_reference_and_the_fp32_scan_rounded(form, g, chunk):
    """The bf16 mix through B8's plain versions (the chunk loop and the
    kernel's chunk-parallel decomposition): y in bf16 within one bf16 ulp
    of the reference's ``ssd_fused`` on the same bf16 inputs in interpret
    mode, the float32 state at its fp32 tolerance; and each equal to its
    own float32 run on the upcast inputs, y rounded once (the kernel's
    contract on the card), from a zero and a random initial state."""
    rng = np.random.default_rng(40 + g + chunk)
    x, ad, b_, c_ = _ssd_inputs(rng, 2, 64, 4, 8, g, 16, np.float32)
    (xt, xv), (bt, bv), (ct, cv) = _bf16(x), _bf16(b_), _bf16(c_)
    adt = torch.from_numpy(ad)
    fn = ssd.ssd_fused_ref if form == "chunk_loop" else ssd.ssd_chunk_parallel_model
    y, f = fn(xt, adt, bt, ct, chunk=chunk)
    assert y.dtype == torch.bfloat16 and f.dtype == torch.float32
    y0, f0 = ref_ssd_fused(_jbf16(xv), jnp.asarray(ad), _jbf16(bv), _jbf16(cv),
                           chunk=chunk)
    assert y0.dtype == jnp.bfloat16 and f0.dtype == jnp.float32
    _within_one_ulp(y.float().numpy(), np.asarray(y0.astype(jnp.float32)))
    np.testing.assert_allclose(f.numpy(), np.asarray(f0), atol=2e-4, rtol=2e-4)
    up = [torch.from_numpy(a) for a in (xv, ad, bv, cv)]
    init = torch.from_numpy(rng.standard_normal((2, 4, 8, 16)).astype(np.float32))
    for s0 in (None, init):
        y1, f1 = fn(xt, adt, bt, ct, chunk=chunk, init_state=s0)
        y32, f32 = fn(*up, chunk=chunk, init_state=s0)
        assert torch.equal(y1, y32.bfloat16()) and torch.equal(f1, f32)
    # the wrapper on CPU tensors is the chunk loop
    yw, fw = ssd.ssd_fused(xt, adt, bt, ct, chunk=chunk)
    y2, f2 = ssd.ssd_fused_ref(xt, adt, bt, ct, chunk=chunk)
    assert torch.equal(yw, y2) and torch.equal(fw, f2)


def test_ssd_bf16_takes_exactly_the_reference_mix():
    """bf16 xd / B / C with float32 ad and a float32 initial state; any
    other mix is refused before the plan, float16 included (the
    float32 / float64 refusals above stay)."""
    arrs = _ssd_inputs(np.random.default_rng(1), 1, 16, 2, 4, 1, 8, np.float32)
    xd, ad, B, C = (torch.from_numpy(a) for a in arrs)
    xb, bb, cb = xd.bfloat16(), B.bfloat16(), C.bfloat16()
    before = ssd.KERNEL_LAUNCHES
    with pytest.raises(TypeError, match="ad dtype"):
        ssd.ssd_fused(xb, ad.bfloat16(), bb, cb, chunk=8)
    with pytest.raises(TypeError, match="B dtype"):
        ssd.ssd_fused(xb, ad, B, cb, chunk=8)
    with pytest.raises(TypeError, match="init_state dtype"):
        ssd.ssd_fused(xb, ad, bb, cb, chunk=8,
                      init_state=torch.zeros((1, 2, 4, 8), dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="ad dtype"):
        ssd.ssd_fused(xd, ad.bfloat16(), B, C, chunk=8)
    with pytest.raises(TypeError, match="not bfloat16, float32 or float64"):
        ssd.ssd_fused(xd.half(), ad, B.half(), C.half(), chunk=8)
    assert ssd.KERNEL_LAUNCHES == before
    y, f = ssd.ssd_fused(xb, ad, bb, cb, chunk=8,
                         init_state=torch.zeros((1, 2, 4, 8)))
    assert y.dtype == torch.bfloat16 and f.dtype == torch.float32


@pytest.mark.parametrize("p", [64, 80])
def test_ssd_bf16_plan_at_mamba2_widths(p):
    """The bf16 form's plan: the fp32 form's launches and shared memory, its
    operands bf16 (xd, B, C, y) beside float32 (ad, cum, the states); a
    float32 scratch for y's partial sums only where p takes more than one
    64-column slice."""
    fp32 = plan_ssd_fused(1, 512, 80, p, 1, 128, chunk=256)
    bf16 = plan_ssd_fused(1, 512, 80, p, 1, 128, chunk=256, dtype="bfloat16")
    assert bf16.ok and [b.grid for b in bf16.blocks] == [b.grid for b in fp32.blocks]
    assert [b.smem_bytes for b in bf16.blocks] == [b.smem_bytes for b in fp32.blocks]
    ops = {o[0]: o[2] for blk in bf16.blocks for o in blk.operands}
    assert {k: ops[k] for k in ("xd", "B", "C", "y")} == dict.fromkeys(
        ("xd", "B", "C", "y"), "bfloat16")
    assert {ops[k] for k in ("ad", "cum", "states", "entering", "state")} == {"float32"}
    assert ("yacc" in ops) == (p > 64)
    assert "float16" in plan_ssd_fused(1, 512, 80, p, 1, 128, chunk=256,
                                       dtype="float16").violations[0]


@pytest.mark.parametrize("d", [32, 7])
def test_embedding_gather_bf16_equals_reference(d):
    """A bf16 table's rows come back in bf16, exactly: ``table[ids]`` and
    the reference's gather of the same bf16 table (odd d too, which the
    card copies in 2 B vectors); ``out_dtype=torch.float32`` widens them;
    the vocab-shard form's rows are the masked ones, the shards summing to
    the whole-table gather."""
    rng = np.random.default_rng(d)
    tt, tv = _bf16(rng.standard_normal((300, d)))
    ids = rng.integers(0, 300, (200,)).astype(np.int32)
    got = gather.embedding_gather(tt, ids)
    assert got.dtype == torch.bfloat16 and torch.equal(got, tt[ids])
    want = ref_gather(_jbf16(tv), jnp.asarray(ids), vl=64)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    wide = gather.embedding_gather(tt, torch.from_numpy(ids.astype(np.int64)),
                                   out_dtype=torch.float32)
    assert wide.dtype == torch.float32 and torch.equal(wide, got.float())
    parts = [gather.embedding_gather_shard(tt[k * 100:(k + 1) * 100], ids,
                                           k * 100, 300) for k in range(3)]
    for k, part in enumerate(parts):
        assert part.dtype == torch.bfloat16
        assert torch.equal(part, gather.embedding_gather_shard_ref(
            tt[k * 100:(k + 1) * 100], ids, k * 100, 300))
    assert torch.equal(parts[0] + parts[1] + parts[2], got)
    plan = plan_embedding_gather(300, d, ids, dtype="bfloat16")
    assert plan.ok and ("out", (200, d), "bfloat16") in plan.blocks[0].operands
    with pytest.raises(ValueError, match="out_dtype"):
        gather.embedding_gather(tt.float(), ids, out_dtype=torch.bfloat16)
