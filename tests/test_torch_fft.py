"""Parity of the port's FFT path (``repro_torch.kernels.fft``, ``ops.fft``
and its preflight) with the JAX reference.

The same numpy-seeded signals go through both packages.  The reference's
Pallas kernel runs in interpret mode with x64 on (as
``tests/test_kernels.py`` runs it); the port runs on the CPU because the
spec asks for it, where :func:`fft_stockham` takes its plain PyTorch path.
Tolerance, the reference's own against numpy (``tests/test_kernels.py``):
fp64 rtol 1e-9 / atol 1e-9 * n, fp32 rtol 1e-3 / atol 1e-3 * n.  Kernel B7
itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.analysis.preflight import plan_fft_stockham as ref_plan
from repro.kernels import fft as ref_fft
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels.execspec import ExecSpec as RefExecSpec
from repro_torch.analysis import LaunchPlanError, plan_fft_stockham
from repro_torch.core import autotune
from repro_torch.kernels import fft, ops
from repro_torch.kernels.execspec import ExecSpec

CPU = ExecSpec(device="cpu")
TOLS = {np.float64: 1e-9, np.float32: 1e-3}


def _signal(batch, n, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n)).astype(dtype),
            rng.standard_normal((batch, n)).astype(dtype))


def _both(re, im, b_block=8):
    """The reference's and the port's ``ops.fft`` on the same planes."""
    want = ref_ops.fft(re, im, spec=RefExecSpec(b_block=b_block,
                                                interpret=True))
    got = ops.fft(re, im, spec=dataclasses.replace(CPU, b_block=b_block))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _close(got, want, n, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * n)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [2, 8, 64, 512, 2048])
def test_fft_matches_reference_and_numpy(n, dtype):
    re, im = _signal(4, n, seed=n, dtype=dtype)
    want, got = _both(re, im, b_block=2)
    tol = TOLS[dtype]
    assert got[0].shape == (4, n) and got[0].dtype == dtype
    _close(got, want, n, tol)
    spec = np.fft.fft(re.astype(np.float64) + 1j * im.astype(np.float64))
    _close(got, (spec.real, spec.imag), n, tol)


@pytest.mark.parametrize("batch,b_block", [(1, 8), (3, 2), (8, 8), (13, 4)])
def test_fft_batch_tails(batch, b_block):
    n = 128
    re, im = _signal(batch, n, seed=batch)
    want, got = _both(re, im, b_block=b_block)
    assert got[0].shape == (batch, n)
    _close(got, want, n, 1e-9)


def test_fft_one_d_input_and_no_imaginary_plane():
    n = 256
    re, _ = _signal(1, n, seed=3)
    want = ref_ops.fft(re[0], spec=RefExecSpec(interpret=True))
    got = ops.fft(re[0], spec=CPU)
    assert tuple(got[0].shape) == (1, n)
    _close([g.numpy() for g in got], [np.asarray(w) for w in want], n, 1e-9)
    spec = np.fft.fft(re[0])
    _close([g.numpy()[0] for g in got], (spec.real, spec.imag), n, 1e-9)
    # a torch tensor signal is accepted as it is
    got_t = ops.fft(torch.from_numpy(re), spec=CPU)
    torch.testing.assert_close(got_t[0], got[0], rtol=0, atol=0)


def test_fft_result_does_not_depend_on_b_block():
    re, im = _signal(13, 64, seed=5)
    base = ops.fft(re, im, spec=dataclasses.replace(CPU, b_block=1))
    for bb in (2, 3, 8, 64):
        got = ops.fft(re, im, spec=dataclasses.replace(CPU, b_block=bb))
        for g, b in zip(got, base):
            torch.testing.assert_close(g, b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [2, 8, 1024, 1 << 12])
def test_fft_twiddles_match_reference(n, dtype):
    want = ref_ref.fft_twiddles(n, dtype)
    got = fft.fft_twiddles(n, dtype)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (int(math.log2(n)), n // 2)
        np.testing.assert_array_equal(g, np.asarray(w))


def test_fft_stockham_ref_matches_reference_plain_version():
    n = 512
    re, im = _signal(3, n, seed=11)
    wre, wim = fft.fft_twiddles(n)
    want = ref_ref.fft_stockham_ref(*(jnp.asarray(a) for a in (re, im, wre,
                                                               wim)))
    got = fft.fft_stockham_ref(*(torch.from_numpy(a) for a in (re, im, wre,
                                                               wim)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12 * n)


# ---------------------------------------------------------------------------
# Preflight
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("b_block", [1, 8])
def test_plan_accepts_whatever_the_reference_accepts(b_block, dtype):
    """Every (n, batch, dtype) the reference's VMEM-budgeted plan accepts,
    the Hopper plan accepts too (the two-pass form reaches n = 2^24 in
    fp64, far past the reference's VMEM)."""
    accepted = 0
    for logn in range(1, 20):
        n = 1 << logn
        for batch in (1, 8, 13):
            want = ref_plan(n, batch, b_block=b_block, dtype=dtype)
            got = plan_fft_stockham(n, batch, b_block=b_block, dtype=dtype)
            if want.ok:
                accepted += 1
                assert got.ok, (n, batch, got.violations)
    assert accepted >= 3 * 16
    for plan in (ref_plan(1000, 8, b_block=b_block, dtype=dtype),
                 plan_fft_stockham(1000, 8, b_block=b_block, dtype=dtype)):
        assert not plan.ok and "power of two" in plan.violations[0]


def test_plan_chooses_the_form_by_shared_memory():
    # fp64 n = 2048: one signal a block (128 threads of 16 values), its two
    # padded planes and the 128 twiddle bases in shared memory
    p = plan_fft_stockham(2048, 8192, b_block=8, dtype="float64")
    (blk,) = p.blocks
    assert p.n_launches == 1 and blk.label == "in_block[signals=1, radix=16]"
    assert blk.smem_bytes == (2 * (2048 + 128) + 2 * 128) * 8 \
        <= autotune.SMEM_PER_BLOCK
    assert blk.grid == (8192,) and blk.block == (128,)
    assert plan_fft_stockham(4096, 5, dtype="float64").n_launches == 1
    # past it, the two-pass form: 8192 = 64 x 128, 8 columns / 4 rows a
    # block; each block also stages its sub-FFT's half-circle table
    big = plan_fft_stockham(8192, 5, dtype="float64")
    assert big.ok and big.n_launches == 2
    a, b = big.blocks
    assert a.label == "pass_a[n1=64, n2=128, tile=8]"
    assert b.label == "pass_b[n1=64, n2=128, tile=4]"
    assert a.smem_bytes == (4 * 8 * 64 + 64) * 8           # 8 columns
    assert b.smem_bytes == (4 * 4 * (128 + 4) + 128) * 8   # rows padded
    assert a.grid == (5 * 128 // 8,) and b.grid == (5 * 64 // 4,)
    # one thread per radix-4 butterfly of a stage
    assert a.block == (8 * 64 // 4,) and b.block == (4 * 128 // 4,)
    # fp32 fits twice the length in one block
    assert plan_fft_stockham(8192, 5, dtype="float32").n_launches == 1
    # the FFT drain's long plan: 2^17 = 256 x 512
    long = plan_fft_stockham(1 << 17, 256, dtype="float64")
    assert long.ok and long.n_launches == 2
    assert [blk.label for blk in long.blocks] == [
        "pass_a[n1=256, n2=512, tile=8]", "pass_b[n1=256, n2=512, tile=4]"]
    assert long.blocks[0].smem_bytes == (4 * 8 * 256 + 256) * 8 \
        <= autotune.SMEM_PER_BLOCK
    assert long.blocks[0].grid == (256 * 512 // 8,)
    assert long.blocks[1].grid == (256 * 256 // 4,)
    assert long.blocks[0].block == (512,) and long.blocks[1].block == (512,)
    # small signals: b_block signals a block, n / radix threads each
    small = plan_fft_stockham(8, 13, b_block=8, dtype="float64").blocks[0]
    assert small.grid == (2,) and small.block == (8,)
    assert autotune.fft_block_signals(512, 8, 8) == 4      # 4 x 32 threads
    assert autotune.fft_block_signals(2048, 8, 8) == 1
    assert autotune.fft_block_signals(8192, 8, 8) == 0


@pytest.mark.parametrize("dtype,side", [("float64", 4096), ("float32", 8192)])
def test_plan_refuses_lengths_beyond_the_two_pass_reach(dtype, side):
    """n1 and n2 each fit one block: 4096 x 4096 in fp64, 8192 x 8192 in
    fp32 (twice that would put n2 past a block).  The longest length is
    planned with tiles of one sub-signal; twice it is a violation naming
    the limit."""
    itemsize = np.dtype(dtype).itemsize
    assert autotune.fft_block_limit(itemsize) == side
    limit = side * side
    edge = plan_fft_stockham(limit, 1, dtype=dtype)
    assert edge.ok and edge.n_launches == 2
    assert all(b.smem_bytes <= autotune.SMEM_PER_BLOCK for b in edge.blocks)
    assert autotune.fft_two_pass(limit, itemsize)[2:] == (1, 1)
    past = plan_fft_stockham(2 * limit, 1, dtype=dtype)
    assert not past.ok and not past.blocks
    assert "two-pass form's reach" in past.violations[0]
    assert f"n <= {limit}" in past.violations[0]
    assert autotune.fft_two_pass(2 * limit, itemsize) is None


# ---------------------------------------------------------------------------
# The two-pass form's index and twiddle arithmetic (kernel B7, n past a block)
# ---------------------------------------------------------------------------


def _stockham_rows(x, tw):
    """Stockham FFTs along the last axis of complex ``x`` (length m) as the
    kernel's ``sub_fft`` runs them: one radix-2 stage first when log2 m is
    odd, then radix-4 stages (each the pair of radix-2 stages it replaces);
    ``tw[q] = w_m^q`` for q < m / 2, and w_m^(q + m/2) = -w_m^q."""
    m = x.shape[-1]
    log2m = int(math.log2(m))

    def w(e):
        return torch.where(e < m // 2, tw[e % (m // 2)], -tw[e % (m // 2)])

    log2s = 0
    if log2m % 2:
        j = torch.arange(m // 2)
        a, b = x[..., :m // 2], x[..., m // 2:]
        y = torch.empty_like(x)
        y[..., 2 * j] = a + b
        y[..., 2 * j + 1] = (a - b) * w(j)
        x, log2s = y, 1
    while log2s < log2m:
        stride = 1 << log2s
        jj = torch.arange(m // 4)
        q, p = jj >> log2s, jj & (stride - 1)
        a0, a1, a2, a3 = (x[..., i * (m // 4):(i + 1) * (m // 4)]
                          for i in range(4))
        big_a, big_b, big_c, big_d = a0 + a2, a1 + a3, a0 - a2, a1 - a3
        o = 4 * q * stride + p
        y = torch.empty_like(x)
        y[..., o] = big_a + big_b
        y[..., o + stride] = (big_c - 1j * big_d) * w(q * stride)
        y[..., o + 2 * stride] = (big_a - big_b) * w(2 * q * stride)
        y[..., o + 3 * stride] = (big_c + 1j * big_d) * w(3 * q * stride)
        x, log2s = y, log2s + 2
    return x


def _two_pass_model(re, im, wre, wim):
    """Kernel B7's two-pass form in plain torch: the tuner's split and
    tiles, block by block, reading only row 0 of ``fft_twiddles`` (each
    pass's sub-FFT table is gathered from it, as the kernel stages it in
    shared memory).  Pass A:
    ``tile_a`` adjacent columns j2 of each (n1, n2) signal view, length-n1
    FFTs down them, entry (k1, j2) times w_n^(j2 k1), into scratch A[k1,
    j2]; pass B: ``tile_b`` adjacent rows k1 of A, length-n2 FFTs along
    them, written to X[k1 + n1 k2]."""
    batch, n = re.shape
    n1, n2, tile_a, tile_b = autotune.fft_two_pass(n, re.element_size())
    row0 = torch.complex(wre[0], wim[0])            # w_n^e for e < n / 2
    wn = torch.cat([row0, -row0])                   # w_n^(e + n/2) = -w_n^e
    x = torch.complex(re, im).reshape(batch, n1, n2)
    scratch = torch.empty_like(x)
    k1 = torch.arange(n1)
    tw_a = row0[torch.arange(n1 // 2) * n2]         # w_n1^q = w_n^(q n2)
    tw_b = row0[torch.arange(n2 // 2) * n1]         # w_n2^q = w_n^(q n1)
    for j2_0 in range(0, n2, tile_a):
        j2 = torch.arange(j2_0, j2_0 + tile_a)
        cols = x[:, :, j2_0:j2_0 + tile_a].transpose(1, 2)   # (batch, t, n1)
        f = _stockham_rows(cols, tw_a)
        f = f * wn[j2[:, None] * k1[None, :]]
        scratch[:, :, j2_0:j2_0 + tile_a] = f.transpose(1, 2)
    out = torch.empty((batch, n2, n1), dtype=x.dtype)
    for k1_0 in range(0, n1, tile_b):
        g = _stockham_rows(scratch[:, k1_0:k1_0 + tile_b, :], tw_b)
        out[:, :, k1_0:k1_0 + tile_b] = g.transpose(1, 2)
    out = out.reshape(batch, n)
    return out.real.contiguous(), out.imag.contiguous()


@pytest.mark.parametrize("m", [2, 4, 8, 32, 128, 512, 1024])
def test_sub_fft_stages_match_torch_fft(m):
    """The radix-2-then-radix-4 stage sequence of one sub-FFT, from its
    half-circle twiddle table, is the DFT (odd and even log2 m)."""
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.standard_normal((3, m))
                         + 1j * rng.standard_normal((3, m)))
    tw = torch.exp(-2j * math.pi * torch.arange(m // 2, dtype=torch.float64)
                   / m)
    torch.testing.assert_close(_stockham_rows(x, tw), torch.fft.fft(x),
                               rtol=1e-12, atol=1e-12 * m)


@pytest.mark.parametrize("dtype,n", [(np.float64, 1 << e) for e in range(13, 19)]
                         + [(np.float32, 1 << e) for e in range(14, 19)])
def test_two_pass_model_matches_reference_and_numpy(dtype, n):
    """The index and twiddle arithmetic of the two-pass form (split, tiles,
    cross twiddles from row 0, the k1 + n1 k2 store) against the
    reference's Pallas FFT (interpret mode) and ``numpy.fft.fft``, at the
    FFT tolerance (fp64 rtol 1e-9 / atol 1e-9 n; fp32 rtol 1e-3 / atol
    1e-5 x max|spectrum|, since its error grows with the spectrum)."""
    re, im = _signal(2, n, seed=n % 977, dtype=dtype)
    wre, wim = fft.fft_twiddles(n, dtype)
    itemsize = np.dtype(dtype).itemsize
    assert autotune.fft_block_signals(n, 8, itemsize) == 0   # past a block
    n1, n2, tile_a, tile_b = autotune.fft_two_pass(n, itemsize)
    assert n1 * n2 == n and n1 <= n2 <= 2 * n1
    if dtype == np.float64:
        assert tile_a >= 4                          # a 32 B sector a segment
    got = _two_pass_model(*(torch.from_numpy(a) for a in (re, im, wre, wim)))
    want = ref_fft.fft_stockham(*(jnp.asarray(a) for a in (re, im, wre, wim)),
                                b_block=2, interpret=True)
    tol = TOLS[dtype]
    want = [np.asarray(w) for w in want]
    spec = np.fft.fft(re.astype(np.float64) + 1j * im.astype(np.float64))
    for w in (want, (spec.real, spec.imag)):
        atol = (tol * n if dtype == np.float64
                else 1e-5 * max(float(np.abs(p).max()) for p in w))
        for g, p in zip(got, w):
            np.testing.assert_allclose(g.numpy(), p, rtol=tol, atol=atol)


# ---------------------------------------------------------------------------
# The in-block form's register passes (kernel B7, n up to a block)
# ---------------------------------------------------------------------------

#: |cos(2 pi b / 16)| for b = 0 .. 4, the constants of ``cos16`` in the .cu
_C16 = (1.0, 0.92387953251128675613, 0.70710678118654752440,
        0.38268343236508977173, 0.0)


def _cos16(k):
    m = k & 15
    a = m if m <= 8 else 16 - m
    b = a if a <= 4 else 8 - a
    return _C16[b] if a <= 4 else -_C16[b]


def _bitrev(j, bits):
    return sum(((j >> b) & 1) << (bits - 1 - b) for b in range(bits))


def _dft_dif(v):
    """``dft_dif`` of the .cu over the last axis (length r): radix-2
    decimation in frequency, w_2h^i = w_16^(8 i / h) as the same constants,
    outputs in bit-reversed positions."""
    v = v.clone()
    r = v.shape[-1]
    for lh in range(r.bit_length() - 2, -1, -1):
        h = 1 << lh
        for b in range(0, r, 2 * h):
            for i in range(h):
                a, c = v[..., b + i].clone(), v[..., b + i + h].clone()
                v[..., b + i] = a + c
                d = a - c
                k = i * (8 // h)
                if k == 0:
                    v[..., b + i + h] = d
                elif k == 4:                                  # times -i
                    v[..., b + i + h] = torch.complex(d.imag, -d.real)
                else:
                    cs, sn = _cos16(k), _cos16(k - 4)
                    v[..., b + i + h] = torch.complex(d.real * cs + d.imag * sn,
                                                      d.imag * cs - d.real * sn)
    return v


def _padded(i, itemsize):
    """Element i of a plane in shared memory: one pad after every 128 B."""
    return i + (i >> (4 if itemsize == 8 else 5))


def _block_model(re, im, wre, wim):
    """Kernel B7's in-block form in plain torch, thread by thread as the
    .cu runs it: n / E threads a signal (E the tuner's radix) each holding
    E values; radix-E passes (DFT in registers,
    twiddle (w_n^(u - p))^j powered up from one base read of the staged
    row-0 prefix, write to r (u - p) + p + j S of the padded exchange
    buffer), then a radix-2^rest pass writing to the output; the first
    pass reads device memory, the last writes it."""
    batch, n = re.shape
    itemsize = re.element_size()
    e = autotune.fft_block_radix(n)
    log2e, log2n = e.bit_length() - 1, n.bit_length() - 1
    ts = n // e
    full, rest = divmod(log2n, log2e)
    tw = torch.complex(wre[0, :ts], wim[0, :ts])    # the staged bases, e < n/E
    x = torch.complex(re, im)
    out = torch.empty_like(x)
    buf = torch.zeros((batch, _padded(n, itemsize)), dtype=x.dtype)
    t, jj = torch.arange(ts), torch.arange(e)
    brev = [_bitrev(j, log2e) for j in range(e)]
    v = x[:, t[:, None] + ts * jj[None, :]]          # (batch, ts, E)
    log2s = 0
    for p in range(full):
        a = _dft_dif(v)[..., brev]                    # A_j
        if p == full - 1 and rest == 0:
            out[:, t[:, None] + ts * jj[None, :]] = a
            return out.real.contiguous(), out.imag.contiguous()
        s = 1 << log2s
        pp = t & (s - 1)
        base = t - pp
        w1 = tw[base]
        pw = w1.clone()
        for j in range(1, e):
            a[..., j] = a[..., j] * pw
            pw = pw * w1
        idx = e * base[:, None] + pp[:, None] + jj[None, :] * s
        buf[:, _padded(idx, itemsize)] = a
        log2s += log2e
        if p + 1 < full:
            v = buf[:, _padded(t[:, None] + ts * jj[None, :], itemsize)]
    r = 1 << rest
    m = n // r
    u = t[:, None] + ts * torch.arange(e // r)[None, :]         # (ts, E / r)
    kk = torch.arange(r)
    v = buf[:, _padded(u[..., None] + m * kk, itemsize)]        # (b, ts, E/r, r)
    a = _dft_dif(v)[..., [_bitrev(j, rest) for j in range(r)]]
    out[:, u[..., None] + m * kk] = a
    return out.real.contiguous(), out.imag.contiguous()


@pytest.mark.parametrize("dtype,n",
                         [(np.float64, 1 << e) for e in range(1, 14)]
                         + [(np.float32, 1 << e) for e in range(1, 14)])
def test_in_block_model_matches_reference_and_numpy(dtype, n):
    """The register passes of the in-block form (radix-16 passes, then a
    radix-2 / 4 / 8 pass where log2 n is not a multiple of 4; twiddles from
    the first n / 16 entries of row 0; the padded exchange buffer) against
    the reference's Pallas FFT (interpret mode) and ``numpy.fft.fft`` for
    every n = 2 .. 8192, at the FFT tolerance (fp64 rtol 1e-9 / atol
    1e-9 n; fp32 rtol 1e-3 / atol 1e-5 x max|spectrum|)."""
    re, im = _signal(3, n, seed=n + 7, dtype=dtype)
    wre, wim = fft.fft_twiddles(n, dtype)
    got = _block_model(*(torch.from_numpy(a) for a in (re, im, wre, wim)))
    want = ref_fft.fft_stockham(*(jnp.asarray(a) for a in (re, im, wre, wim)),
                                b_block=2, interpret=True)
    tol = TOLS[dtype]
    spec = np.fft.fft(re.astype(np.float64) + 1j * im.astype(np.float64))
    for w in ([np.asarray(a) for a in want], (spec.real, spec.imag)):
        atol = (tol * n if dtype == np.float64
                else 1e-5 * max(float(np.abs(p).max()) for p in w))
        for g, p in zip(got, w):
            np.testing.assert_allclose(g.numpy(), p, rtol=tol, atol=atol)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_in_block_tuner_fits_the_card(dtype):
    """Signals a block, threads and shared memory of the in-block form for
    every n up to the limit: within ``b_block``, at most 512 threads (the
    kernel's launch bound), shared memory within a block's 227 KB, and at
    n = 2048 in fp64 at least four blocks resident on an SM's 228 KB
    (1 KB of it reserved a block); the plan prices what the launch claims
    (the .cu's ``block_smem``)."""
    itemsize = np.dtype(dtype).itemsize
    limit = autotune.fft_block_limit(itemsize)
    for log2n in range(1, limit.bit_length()):
        n = 1 << log2n
        radix = autotune.fft_block_radix(n)
        for b_block in (1, 3, 8):
            signals = autotune.fft_block_signals(n, b_block, itemsize)
            assert 1 <= signals <= b_block
            threads = autotune.fft_block_threads(n, signals)
            assert threads == signals * n // radix
            assert threads <= autotune.FFT_BLOCK_MAX_THREADS
            smem = autotune.fft_block_smem_bytes(n, signals, itemsize)
            plane = n + (n >> (4 if itemsize == 8 else 5))
            assert smem == itemsize * (2 * signals * plane + 2 * (n // radix))
            assert smem <= autotune.SMEM_PER_BLOCK
            (blk,) = plan_fft_stockham(n, 13, b_block=b_block, dtype=dtype).blocks
            assert blk.smem_bytes == smem and blk.block == (threads,)
            assert blk.grid == (-(-13 // signals),)
    assert autotune.fft_block_signals(2 * limit, 8, itemsize) == 0
    if dtype == "float64":
        smem = autotune.fft_block_smem_bytes(2048, 1, 8)
        assert 233_472 // (smem + 1024) >= 4


def _bank_ways(addrs, itemsize):
    """Most distinct addresses one bank serves in one access: 32 banks of
    4 B; a warp's 8 B accesses go as two half-warps of 16 lanes."""
    lanes = 16 if itemsize == 8 else 32
    worst = 1
    for g in range(0, len(addrs), lanes):
        group = set(addrs[g:g + lanes])
        per_bank = {}
        for a in group:
            per_bank.setdefault((a * itemsize // 4) % 32, set()).add(a)
        worst = max(worst, max(len(v) for v in per_bank.values()))
    return worst


@pytest.mark.parametrize("dtype,n", [("float64", 2048), ("float64", 4096),
                                     ("float32", 2048), ("float32", 8192)])
def test_in_block_exchanges_hit_distinct_banks(dtype, n):
    """The padded index (one element after every 128 B) keeps a plane
    injective and the exchanges between register passes conflict-free: the
    first pass's stride-16 writes, the later passes' reads and writes, in
    fp64 (half-warps of 8 B) everywhere; in fp32 the writes of the middle
    passes (two runs of 16 a warp) share 8 banks two ways."""
    itemsize = np.dtype(dtype).itemsize
    e = autotune.fft_block_radix(n)
    ts = n // e
    phys = [_padded(i, itemsize) for i in range(n)]
    assert len(set(phys)) == n and max(phys) < _padded(n, itemsize)
    full, rest = divmod(n.bit_length() - 1, e.bit_length() - 1)
    log2s = 0
    for p in range(full - (rest == 0)):                # passes that exchange
        s = 1 << log2s
        for j in range(e):
            writes = [_padded(e * (t - (t & (s - 1))) + (t & (s - 1)) + j * s,
                              itemsize) for t in range(ts)]
            ways = _bank_ways(writes, itemsize)
            assert ways == 1 or (dtype == "float32" and p > 0 and ways == 2)
        log2s += e.bit_length() - 1
        r = e if p + 1 < full else 1 << rest
        for i in range(e // r):
            for k in range(r):
                reads = [_padded(t + i * ts + k * (n // r), itemsize)
                         for t in range(ts)]
                assert _bank_ways(reads, itemsize) == 1


def test_fft_refusals_in_both_packages():
    for n in (1000, 6):
        sig = np.ones((2, n))
        with pytest.raises(ValueError, match="power of two"):
            ref_ops.fft(sig, spec=RefExecSpec(interpret=True))
        with pytest.raises(ValueError, match="power of two"):
            ops.fft(sig, spec=CPU)
    with pytest.raises(LaunchPlanError, match="power of two"):
        ops.fft(np.ones((2, 1)), spec=CPU)
    with pytest.raises(LaunchPlanError, match="float32 or float64"):
        ops.fft(np.ones((2, 8), np.int64), spec=CPU)


def test_fft_wrapper_contract_and_cpu_launch_count():
    re, im = (torch.from_numpy(a) for a in _signal(3, 16, seed=1))
    wre, wim = (torch.from_numpy(w) for w in fft.fft_twiddles(16))
    before = dict(fft.KERNEL_LAUNCHES)
    out = fft.fft_stockham(re, im, wre, wim, b_block=2)
    assert fft.KERNEL_LAUNCHES == before     # CPU tensors: the plain path
    ref = fft.fft_stockham_ref(re, im, wre, wim)
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=0, atol=0)
    with pytest.raises(ValueError, match="power of two"):
        fft.fft_stockham(re[:, :12], im[:, :12], wre, wim)
    with pytest.raises(ValueError, match="twiddles"):
        fft.fft_stockham(re, im, wre[:, :4], wim[:, :4])
    with pytest.raises(TypeError, match="dtype"):
        fft.fft_stockham(re, im.float(), wre, wim)
    with pytest.raises(ValueError, match="b_block"):
        fft.fft_stockham(re, im, wre, wim, b_block=0)
