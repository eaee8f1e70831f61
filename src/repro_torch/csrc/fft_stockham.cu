// Batched radix-2 Stockham FFT for Hopper (sm_90a) on split re/im planes.
//
// Replaces the TPU kernel repro/kernels/fft.py::_fft_kernel (launched by
// fft_stockham): x of shape (batch, n), n a power of two, log2 n stages,
// twiddles pre-expanded per stage into (log2 n, n / 2) tables.  At stage s,
// with half = n / 2 and m = 2^s, butterfly j in [0, half) takes
// a = x[j], b = x[j + half], w = wre[s, j] + i wim[s, j] and writes
//   y[(j / m) * 2m + j % m]     = a + b
//   y[(j / m) * 2m + m + j % m] = (a - b) * w
// No bit reversal: Stockham sorts itself by ping-ponging between buffers.
// The stage-s entry is wre[s, j] + i wim[s, j] = w_n^((j >> s) << s), with
// w_n = exp(-2 pi i / n): row 0 holds w_n^e for every e < n / 2.
//
// What bounds it on the card: device-memory bytes.  The function reads the
// two input planes once, the twiddles of row 0 once, and writes the two
// output planes once: 4 * sizeof(T) * batch * n + sizeof(T) * n bytes.
// Its arithmetic, 10 flops per radix-2 butterfly (5 n log2 n a signal), is
// far below the card's fp64 rate at every n the service registers.
//
// Two forms:
//   * in-block (repro_fft_stockham_block), n <= 4096 in fp64 and n <= 8192
//     in fp32: `signals` whole signals a block (one from n = 2048 on), each
//     transformed by n / R threads that hold R = 16 complex values apiece
//     in registers (R = n below 16).  The FFT runs as radix-R Stockham
//     passes in registers (2048 = 16 * 16 * 8: three passes, two exchanges,
//     in place of 11 stages through shared memory):
//       - pass (L, S), L = n / S the current sub-length, radix r: the
//         butterfly u = q S + p (q < L / r, p < S) reads a_k = x[u + k n/r]
//         (k < r), takes their r-point DFT A_j in registers (radix-2
//         decimation in frequency, constant twiddles w_16^k, outputs in
//         bit-reversed register order, renamed at compile time) and writes
//         y[r (u - p) + p + j S] = A_j w_n^(j (u - p)); then S *= r;
//       - the first pass reads its inputs straight from device memory and
//         the last (where u = p: no twiddles) writes its outputs straight to
//         device memory: lane t of a warp takes element t + k n/r, so each
//         load and store of a warp covers 32 adjacent elements (256 B in
//         fp64, whole sectors), with 2R loads in flight a thread.  16 B
//         vectors would need the signal staged through shared memory first,
//         an exchange more, so the form does without them;
//       - between passes the values go through one shared buffer a signal,
//         written in place: __syncthreads() before the writes (every read of
//         the last exchange done) and after them.  log2 n = a log2 R + b:
//         a radix-R passes, then one radix-2^b pass (b > 0) in which a
//         thread runs R / 2^b butterflies;
//       - twiddles: w_n^(j (u - p)) = (w_n^(u - p))^j, powered up in registers
//         from one base read of a shared-memory copy of w_n^e for e < n / R
//         (u - p < n / R), the first entries of row 0 of the registered
//         tables: 2 KB at n = 2048 in fp64, loaded once a block;
//       - bank conflicts: a plane is padded by one element after every
//         128 B (element i at i + i / 16 in fp64, i + i / 32 in fp32).  The
//         first pass writes with stride R (16 u + j becomes 17 u + j in
//         fp64: 16 lanes on 16 distinct 8 B banks), later passes read and
//         write runs of adjacent elements; each half-warp of 8 B accesses
//         (a warp of 4 B) then hits distinct banks, but for the fp32 writes
//         of the middle passes (two runs of 16 a warp, 8 banks shared);
//       - registers: each pass loads its values into arrays of its own, so
//         no array lives across the (not unrolled) pass loop, and every
//         register index is a compile-time constant (dif_stage, below);
//         ptxas keeps them all in registers, none in local memory;
//       - shared memory: 2 * signals * (n + n/16 or n/32) + 2 n / R elements,
//         36 KB at n = 2048 in fp64, so up to six blocks fit an SM (its
//         registers allow four) and one block's loads and
//         stores overlap the others' passes.  A ragged last block (batch
//         not a multiple of `signals`) runs its empty signals on the
//         batch's last signal and stores nothing for them.
//   * two-pass (repro_fft_pass with cols = 1, then cols = 0), for longer
//     signals: the four-step FFT.  n = n1 * n2 (n1 = 2^floor(log2 n / 2), each
//     at most the in-block limit, so n <= 2^24 in fp64 and 2^26 in fp32);
//     input index j = j1 * n2 + j2, output index k = k1 + n1 * k2.
//       - each pass stages its sub-FFT's twiddles in shared memory and runs
//         one radix-2 stage when log2 of the sub-length is odd, then radix-4
//         stages (sub_fft below);
//       - pass A: a block loads `tile` adjacent columns j2 of one signal's
//         (n1, n2) row-major view into shared memory (each row segment
//         `tile` elements long: one 32 B sector or more at tile >= 4 in fp64),
//         runs the length-n1 Stockham FFT down each column, multiplies
//         entry (k1, j2) by w_n^(j2 * k1) and writes it to device scratch
//         A[k1, j2], rows contiguous;
//       - pass B: a block loads `tile` adjacent rows k1 of A (contiguous),
//         runs the length-n2 FFT along each row, and writes X[k1 + n1 * k2]:
//         the `tile` adjacent k1 of one k2 are contiguous.  Its rows are
//         padded by `tile` elements in shared memory, so the column-wise
//         reads of the store hit distinct banks.
//     So the batch crosses device memory twice (read + write per pass),
//     not log2 n times.  Every twiddle is read from row 0 of the tables the
//     caller already holds: a sub-FFT's are w_n1^e = w_n^(e * n2) and
//     w_n2^e = w_n^(e * n1), the cross twiddle is w_n^(j2 * k1) with
//     w_n^(e + n/2) = -w_n^e.  Blocks are numbered signal-major (signal,
//     then tile), so the blocks resident at one time read and write
//     neighbouring segments of one signal, and the short segments of
//     neighbouring blocks fill whole lines of device memory together.
//   * nvcc contracts dr * wr - di * wi into FMAs, so the kernel and the plain
//     PyTorch version differ by ulps per stage; the tolerance says so.
//   * Above 48 KB of dynamic shared memory a launch first raises the
//     kernel's limit with cudaFuncSetAttribute.  A refused request or
//     launch is returned as its cudaError_t (and cleared), never silent.
//
// The host wrapper is repro_torch/kernels/fft.py::fft_stockham; it chooses
// the form, `signals`, (n1, n2) and the tiles
// (repro_torch/core/autotune.py::fft_block_signals, fft_two_pass),
// allocates outputs and scratch, validates device, dtype, shape and
// contiguity, and raises on a non-zero return code.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// w_n^e for 0 <= e < n from row 0 of the twiddle tables (w_n^e, e < n / 2).
template <typename T>
__device__ __forceinline__ void twiddle(const T* w0r, const T* w0i, int64_t e,
                                        int64_t half, T& wr, T& wi) {
  if (e < half) {
    wr = __ldg(w0r + e);
    wi = __ldg(w0i + e);
  } else {
    wr = -__ldg(w0r + e - half);
    wi = -__ldg(w0i + e - half);
  }
}

// w_m^e for 0 <= e < m from a shared table tw[q] = w_m^q, q < m / 2.
template <typename T>
__device__ __forceinline__ void table_twiddle(const T* twr, const T* twi, int e,
                                              int hm, T& wr, T& wi) {
  if (e < hm) {
    wr = twr[e];
    wi = twi[e];
  } else {
    wr = -twr[e - hm];
    wi = -twi[e - hm];
  }
}

// (xr + i xi) * (wr + i wi) into (yr, yi).
template <typename T>
__device__ __forceinline__ void cmul(T xr, T xi, T wr, T wi, T& yr, T& yi) {
  yr = xr * wr - xi * wi;
  yi = xr * wi + xi * wr;
}

// ---- in-block form -------------------------------------------------------

// Most threads of an in-block block (repro_torch/core/autotune.py
// FFT_BLOCK_MAX_THREADS): a thread holds up to 16 complex values, so the
// bound leaves it up to 128 registers.
constexpr int kBlockMaxThreads = 512;

// log2 of a power of two, in constant expressions only.
__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x >> 1); }

// cos(2 pi k / 16) and sin(2 pi k / 16) for any integer k: w_16^k = c - i s.
__host__ __device__ constexpr double cos16(int k) {
  const int m = k & 15;
  const int a = m <= 8 ? m : 16 - m;          // cos is even: a in [0, 8]
  const int b = a <= 4 ? a : 8 - a;           // |cos| of the first quadrant
  const double v = b == 0 ? 1.0
                 : b == 1 ? 0.92387953251128675613
                 : b == 2 ? 0.70710678118654752440
                 : b == 3 ? 0.38268343236508977173 : 0.0;
  return a <= 4 ? v : -v;
}
__host__ __device__ constexpr double sin16(int k) { return cos16(k - 4); }

// j with its low `bits` bits reversed, in constant expressions.
__host__ __device__ constexpr int bitrev(int j, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((j >> b) & 1) << (bits - 1 - b);
  return r;
}

// Element i of an in-block plane lives at i + i / (128 B / sizeof(T)).
template <typename T>
__device__ __forceinline__ int padded(int i) {
  return i + (i >> (sizeof(T) == 8 ? 4 : 5));
}

// One radix-2 stage (half-span H) of dft: every loop bound is a
// template constant, so each loop unrolls completely and every register
// index is static (a bound set by an enclosing loop's variable leaves the
// arrays in local memory).
template <int R, int H, typename T>
__device__ __forceinline__ void dif_stage(T* vr, T* vi) {
#pragma unroll
  for (int b = 0; b < R; b += 2 * H) {
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const T ar = vr[b + i], ai = vi[b + i];
      const T cr = vr[b + i + H], ci = vi[b + i + H];
      vr[b + i] = ar + cr;
      vi[b + i] = ai + ci;
      const T dr = ar - cr, di = ai - ci;
      const int k = i * (8 / H);              // w_2H^i = w_16^k
      if (k == 0) {
        vr[b + i + H] = dr;
        vi[b + i + H] = di;
      } else if (k == 4) {                    // times -i
        vr[b + i + H] = di;
        vi[b + i + H] = -dr;
      } else {
        const T c = T(cos16(k)), sn = T(sin16(k));
        vr[b + i + H] = dr * c + di * sn;
        vi[b + i + H] = di * c - dr * sn;
      }
    }
  }
  if constexpr (H > 1) dif_stage<R, H / 2>(vr, vi);
}

// Moves output bitrev(m) of dif_stage from register m to register
// bitrev(m), one compile-time swap at a time.
template <int R, int J, typename T>
__device__ __forceinline__ void to_natural_order(T* vr, T* vi) {
  if constexpr (J < R) {
    constexpr int m = bitrev(J, ilog2(R));
    if constexpr (m > J) {
      T x = vr[J];
      vr[J] = vr[m];
      vr[m] = x;
      x = vi[J];
      vi[J] = vi[m];
      vi[m] = x;
    }
    to_natural_order<R, J + 1>(vr, vi);
  }
}

// The R-point DFT of (vr, vi)[0, R) in registers, in natural order: radix-2
// decimation in frequency (w_2h^i = w_16^(8 i / h), folded to constants),
// then the bit-reversal permutation, a renaming of registers.
template <int R, typename T>
__device__ __forceinline__ void dft(T* vr, T* vi) {
  if constexpr (R > 1) {
    dif_stage<R, R / 2>(vr, vi);
    to_natural_order<R, 0>(vr, vi);
  }
}

// The last pass when log2 n is not a multiple of log2 E: radix R = 2^rest,
// E / R butterflies a thread, u = t + i ts, inputs x[u + k n/R] from the
// shared buffer, outputs y[u + j n/R] to device memory (u = p: no twiddle).
template <int E, int R, typename T>
__device__ __forceinline__ void last_small_pass(const T* br, const T* bi, int t,
                                                int ts, int n, T* out_re,
                                                T* out_im, int64_t g, bool live) {
  constexpr int C = E / R;
  const int m = n / R;
  T vr[E], vi[E];
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int x = padded<T>(t + i * ts + k * m);
      vr[i * R + k] = br[x];
      vi[i * R + k] = bi[x];
    }
  }
#pragma unroll
  for (int i = 0; i < C; ++i) dft<R>(vr + i * R, vi + i * R);
  if (!live) return;
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int64_t o = g + t + i * ts + j * m;
      out_re[o] = vr[i * R + j];
      out_im[o] = vi[i * R + j];
    }
  }
}

// In-block FFT: block b holds signals [b * signals, b * signals + signals)
// (fewer in the last block), n / E threads a signal, thread t of a signal
// holding E complex values.  Shared memory: the signals' padded re and im
// planes, then the bases w_n^e, e < n / E (re, then im).
template <typename T, int E>
__global__ void __launch_bounds__(kBlockMaxThreads)
fft_block_kernel(const T* __restrict__ re, const T* __restrict__ im,
                 const T* __restrict__ w0r, const T* __restrict__ w0i,
                 T* __restrict__ out_re, T* __restrict__ out_im,
                 int64_t batch, int log2n, int signals) {
  constexpr int LOG2E = ilog2(E);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int n = 1 << log2n;
  const int log2ts = log2n - LOG2E;
  const int ts = 1 << log2ts;                 // threads a signal
  const int plane = n + (n >> (sizeof(T) == 8 ? 4 : 5));
  const int sl = threadIdx.x >> log2ts;       // the thread's signal in the block
  const int t = threadIdx.x & (ts - 1);
  const int64_t sig = static_cast<int64_t>(blockIdx.x) * signals + sl;
  const bool live = sig < batch;
  T* br = smem + 2 * sl * plane;
  T* bi = br + plane;
  T* twr = smem + 2 * signals * plane;
  T* twi = twr + ts;
  for (int e = threadIdx.x; e < ts; e += blockDim.x) {
    twr[e] = __ldg(w0r + e);
    twi[e] = __ldg(w0i + e);
  }

  // an empty signal of the last block computes on the batch's last signal
  // and stores nothing
  const int64_t g = sig * n;
  const int64_t src = (live ? sig : batch - 1) * n;
  __syncthreads();                            // the twiddle bases are staged

  const int full = log2n / LOG2E;             // radix-E passes (>= 1: E <= n)
  const int rest = log2n - full * LOG2E;      // log2 radix of a last pass
  int log2s = 0;
  for (int pass = 0; pass < full; ++pass) {
    // registers live within a pass: the exchange carries the values over
    T vr[E], vi[E];
    if (pass == 0) {
#pragma unroll
      for (int k = 0; k < E; ++k) {
        vr[k] = __ldg(re + src + t + k * ts);
        vi[k] = __ldg(im + src + t + k * ts);
      }
    } else {
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int x = padded<T>(t + k * ts);
        vr[k] = br[x];
        vi[k] = bi[x];
      }
    }
    dft<E>(vr, vi);
    if (pass == full - 1 && rest == 0) {      // the last pass: S = n / E, u = t
      if (live) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          out_re[g + t + j * ts] = vr[j];
          out_im[g + t + j * ts] = vi[j];
        }
      }
      return;
    }
    const int s = 1 << log2s;
    const int p = t & (s - 1);
    const int base = t - p;                   // u - p < n / E
    const T w1r = twr[base], w1i = twi[base];
    T pr = w1r, pi = w1i;                     // w^j, j = 1 .. E - 1
#pragma unroll
    for (int j = 1; j < E; ++j) {
      cmul(vr[j], vi[j], pr, pi, vr[j], vi[j]);
      cmul(pr, pi, w1r, w1i, pr, pi);
    }
    if (pass > 0) __syncthreads();            // every read of this exchange done
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int x = padded<T>(E * base + p + j * s);
      br[x] = vr[j];
      bi[x] = vi[j];
    }
    __syncthreads();
    log2s += LOG2E;
  }
  if constexpr (E == 16) {                    // E < 16 only where n = E: rest 0
    if (rest == 1) last_small_pass<E, 2>(br, bi, t, ts, n, out_re, out_im, g, live);
    if (rest == 2) last_small_pass<E, 4>(br, bi, t, ts, n, out_re, out_im, g, live);
    if (rest == 3) last_small_pass<E, 8>(br, bi, t, ts, n, out_re, out_im, g, live);
  }
}

// ---- two-pass form --------------------------------------------------------

// Stockham FFTs of `count` sub-signals of length m = 2^log2m held in shared
// memory: element i of sub-signal c lives at c * cs + i * is.  COLS numbers
// the butterflies sub-signal fastest (pass A: is = count, cs = 1, so
// neighbouring threads touch neighbouring words), else index fastest (pass
// B: is = 1).  twr/twi hold w_m^q for q < m / 2 (shared memory).
//
// Stage (L, S) of radix 2 takes x[q S + p], x[(q + L/2) S + p] (q < L/2,
// p < S) to y[2q S + p] = a + b and y[(2q + 1) S + p] = (a - b) w_L^q: the
// reference's stage loop.  Two consecutive stages (L, S) and (L/2, 2S) are
// one radix-4 stage: a_k = x[(q + k L/4) S + p] (q < L/4), A = a0 + a2,
// B = a1 + a3, C = a0 - a2, D = a1 - a3, and y[(4q + k) S + p] = A + B,
// (C - iD) w_L^q, (A - B) w_L^2q, (C + iD) w_L^3q for k = 0 .. 3.  So a
// sub-FFT is one radix-2 stage when log2 m is odd, then radix-4 stages:
// half the shared-memory passes and barriers of radix 2.  w_L^q = w_m^(q S).
// On return (ar, ai) hold the spectrum.
template <typename T, bool COLS>
__device__ __forceinline__ void sub_fft(T*& ar, T*& ai, T*& br, T*& bi, int log2m,
                                        int log2count, int cs, int is,
                                        const T* twr, const T* twi) {
  const int hm = 1 << (log2m - 1);
  const int cmask = (1 << log2count) - 1;
  int log2s = 0;
  if (log2m & 1) {
    const int work = hm << log2count;
    for (int u = threadIdx.x; u < work; u += blockDim.x) {
      const int c = COLS ? (u & cmask) : (u >> (log2m - 1));
      const int j = COLS ? (u >> log2count) : (u & (hm - 1));
      const int ia = c * cs + j * is, ib = ia + hm * is;
      const T xr = ar[ia], xi = ai[ia], yr = ar[ib], yi = ai[ib];
      const int o = c * cs + 2 * j * is;
      br[o] = xr + yr;
      bi[o] = xi + yi;
      cmul(xr - yr, xi - yi, twr[j], twi[j], br[o + is], bi[o + is]);
    }
    __syncthreads();
    T* tr = ar; ar = br; br = tr;
    T* ti = ai; ai = bi; bi = ti;
    log2s = 1;
  }
  const int log2qm = log2m - 2;      // m / 4 radix-4 butterflies a sub-signal
  const int qm = log2m >= 2 ? 1 << log2qm : 0;
  for (; log2s < log2m; log2s += 2) {
    const int stride = 1 << log2s;
    const int work = qm << log2count;
    for (int u = threadIdx.x; u < work; u += blockDim.x) {
      const int c = COLS ? (u & cmask) : (u >> log2qm);
      const int jj = COLS ? (u >> log2count) : (u & (qm - 1));
      const int q = jj >> log2s, p = jj & (stride - 1);
      const int i0 = c * cs + jj * is, step = qm * is;
      const T a0r = ar[i0], a0i = ai[i0];
      const T a1r = ar[i0 + step], a1i = ai[i0 + step];
      const T a2r = ar[i0 + 2 * step], a2i = ai[i0 + 2 * step];
      const T a3r = ar[i0 + 3 * step], a3i = ai[i0 + 3 * step];
      const T Ar = a0r + a2r, Ai = a0i + a2i, Br = a1r + a3r, Bi = a1i + a3i;
      const T Cr = a0r - a2r, Ci = a0i - a2i, Dr = a1r - a3r, Di = a1i - a3i;
      const int e = q * stride;
      T w1r, w1i, w2r, w2i, w3r, w3i;
      table_twiddle(twr, twi, e, hm, w1r, w1i);
      table_twiddle(twr, twi, 2 * e, hm, w2r, w2i);
      table_twiddle(twr, twi, 3 * e, hm, w3r, w3i);
      const int o = c * cs + (4 * q * stride + p) * is, os = stride * is;
      br[o] = Ar + Br;
      bi[o] = Ai + Bi;
      cmul(Cr + Di, Ci - Dr, w1r, w1i, br[o + os], bi[o + os]);
      cmul(Ar - Br, Ai - Bi, w2r, w2i, br[o + 2 * os], bi[o + 2 * os]);
      cmul(Cr - Di, Ci + Dr, w3r, w3i, br[o + 3 * os], bi[o + 3 * os]);
    }
    __syncthreads();
    T* tr = ar; ar = br; br = tr;
    T* ti = ai; ai = bi; bi = ti;
  }
}

// Pass A: block b takes columns [j2_0, j2_0 + tile) of signal b / tiles,
// tile b % tiles.  Shared memory: 4 * tile * n1 elements of data, then the
// table w_n1^q = w_n^(q n2), q < n1 / 2 (n1 elements).
template <typename T>
__global__ void __launch_bounds__(1024)
fft_pass_cols_kernel(const T* __restrict__ re, const T* __restrict__ im,
                     const T* __restrict__ w0r, const T* __restrict__ w0i,
                     T* __restrict__ ar_out, T* __restrict__ ai_out,
                     int64_t batch, int log2n, int log2n1, int log2tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tile = 1 << log2tile;
  const int n1 = 1 << log2n1;
  const int64_t n = int64_t(1) << log2n;
  const int64_t n2 = n >> log2n1;
  const int per = tile * n1;
  T* ar = smem;
  T* ai = smem + per;
  T* br = smem + 2 * per;
  T* bi = smem + 3 * per;
  T* twr = smem + 4 * per;
  T* twi = twr + n1 / 2;
  const int64_t tiles = n2 >> log2tile;
  const int64_t sig = static_cast<int64_t>(blockIdx.x) / tiles;
  const int64_t j2_0 = (static_cast<int64_t>(blockIdx.x) % tiles) << log2tile;
  const int64_t base = sig * n + j2_0;

  for (int q = threadIdx.x; q < n1 / 2; q += blockDim.x) {
    twr[q] = __ldg(w0r + q * n2);
    twi[q] = __ldg(w0i + q * n2);
  }
  // smem element (j1, t) at j1 * tile + t: row segments of `tile`, coalesced
  for (int i = threadIdx.x; i < per; i += blockDim.x) {
    const int64_t g = base + static_cast<int64_t>(i >> log2tile) * n2 + (i & (tile - 1));
    ar[i] = __ldg(re + g);
    ai[i] = __ldg(im + g);
  }
  __syncthreads();
  sub_fft<T, true>(ar, ai, br, bi, log2n1, log2tile, 1, tile, twr, twi);

  const int64_t half = n >> 1;
  for (int i = threadIdx.x; i < per; i += blockDim.x) {
    const int64_t k1 = i >> log2tile;
    const int64_t j2 = j2_0 + (i & (tile - 1));
    T wr, wi;
    twiddle(w0r, w0i, j2 * k1, half, wr, wi);
    const int64_t g = sig * n + k1 * n2 + j2;
    cmul(ar[i], ai[i], wr, wi, ar_out[g], ai_out[g]);
  }
}

// Pass B: block b takes rows [k1_0, k1_0 + tile) of signal b / tiles's
// scratch A, tile b % tiles.  Shared memory: 4 * tile * (n2 + tile)
// elements of data, then the table w_n2^q = w_n^(q n1), q < n2 / 2.
template <typename T>
__global__ void __launch_bounds__(1024)
fft_pass_rows_kernel(const T* __restrict__ ar_in, const T* __restrict__ ai_in,
                     const T* __restrict__ w0r, const T* __restrict__ w0i,
                     T* __restrict__ out_re, T* __restrict__ out_im,
                     int64_t batch, int log2n, int log2n1, int log2tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tile = 1 << log2tile;
  const int log2n2 = log2n - log2n1;
  const int n2 = 1 << log2n2;
  const int64_t n = int64_t(1) << log2n;
  const int64_t n1 = int64_t(1) << log2n1;
  const int stride = n2 + tile;
  const int per = tile * stride;
  T* ar = smem;
  T* ai = smem + per;
  T* br = smem + 2 * per;
  T* bi = smem + 3 * per;
  T* twr = smem + 4 * per;
  T* twi = twr + n2 / 2;
  const int64_t tiles = n1 >> log2tile;
  const int64_t sig = static_cast<int64_t>(blockIdx.x) / tiles;
  const int64_t k1_0 = (static_cast<int64_t>(blockIdx.x) % tiles) << log2tile;
  const int count = tile << log2n2;

  for (int q = threadIdx.x; q < n2 / 2; q += blockDim.x) {
    twr[q] = __ldg(w0r + q * n1);
    twi[q] = __ldg(w0i + q * n1);
  }
  // `tile` whole rows of A are contiguous in device memory
  const int64_t src = sig * n + k1_0 * n2;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int o = (i >> log2n2) * stride + (i & (n2 - 1));
    ar[o] = __ldg(ar_in + src + i);
    ai[o] = __ldg(ai_in + src + i);
  }
  __syncthreads();
  sub_fft<T, false>(ar, ai, br, bi, log2n2, log2tile, stride, 1, twr, twi);

  // X[k1 + n1 * k2]: the tile's k1 of one k2 are adjacent
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int t = i & (tile - 1);
    const int k2 = i >> log2tile;
    const int64_t g = sig * n + static_cast<int64_t>(k2) * n1 + k1_0 + t;
    out_re[g] = ar[t * stride + k2];
    out_im[g] = ai[t * stride + k2];
  }
}

// Complex values a thread of the in-block form holds: 16, or n below 16
// (autotune.py::fft_block_radix).
int block_radix(int64_t n) { return n < 16 ? static_cast<int>(n) : 16; }

// Shared memory of one in-block block: `signals` padded (re, im) planes and
// the n / radix twiddle bases (autotune.py::fft_block_smem_bytes).
template <typename T>
size_t block_smem(int64_t n, int signals) {
  const int64_t plane = n + (n >> (sizeof(T) == 8 ? 4 : 5));
  return sizeof(T) *
         static_cast<size_t>(2 * signals * plane + 2 * (n / block_radix(n)));
}

template <typename T>
cudaError_t launch_block(const void* re, const void* im, const void* wre,
                         const void* wim, void* out_re, void* out_im, int64_t batch,
                         int64_t n, int log2n, int signals, cudaStream_t stream) {
  const int radix = block_radix(n);
  const size_t smem = block_smem<T>(n, signals);
  const auto kernel = radix == 16 ? fft_block_kernel<T, 16>
                    : radix == 8  ? fft_block_kernel<T, 8>
                    : radix == 4  ? fft_block_kernel<T, 4>
                                  : fft_block_kernel<T, 2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();   // clear it: a later launch must not report it
    return err;
  }
  const dim3 grid(static_cast<unsigned>((batch + signals - 1) / signals));
  const int threads = signals * static_cast<int>(n / radix);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(re), static_cast<const T*>(im),
      static_cast<const T*>(wre), static_cast<const T*>(wim),
      static_cast<T*>(out_re), static_cast<T*>(out_im), batch, log2n, signals);
  return cudaGetLastError();
}

// One launch of a two-pass kernel over batch * (sub-signals / tile) blocks.
template <typename T>
cudaError_t launch_pass(bool cols, const void* xr, const void* xi, const void* wre,
                        const void* wim, void* yr, void* yi, int64_t batch,
                        int log2n, int log2n1, int log2tile, int threads,
                        cudaStream_t stream) {
  const int tile = 1 << log2tile;
  const int64_t n1 = int64_t(1) << log2n1;
  const int64_t n2 = int64_t(1) << (log2n - log2n1);
  // data (two planes, ping-pong) and the sub-FFT's half-circle table
  const size_t smem = sizeof(T) * static_cast<size_t>(
      cols ? 4 * tile * n1 + n1 : 4 * tile * (n2 + tile) + n2);
  const auto kernel = cols ? fft_pass_cols_kernel<T> : fft_pass_rows_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();   // clear it: a later launch must not report it
    return err;
  }
  const int64_t blocks = batch * ((cols ? n2 : n1) >> log2tile);
  kernel<<<dim3(static_cast<unsigned>(blocks)), threads, smem, stream>>>(
      static_cast<const T*>(xr), static_cast<const T*>(xi),
      static_cast<const T*>(wre), static_cast<const T*>(wim),
      static_cast<T*>(yr), static_cast<T*>(yi), batch, log2n, log2n1, log2tile);
  return cudaGetLastError();
}

bool bad_shape(int64_t batch, int64_t n, int log2n) {
  return batch <= 0 || log2n < 1 || log2n > 40 || n != (int64_t(1) << log2n);
}

}  // namespace

extern "C" {

// In-block form: re, im, out_re, out_im (batch, n); wre, wim (log2n, n / 2),
// of which the kernel reads the first n / radix entries of row 0;
// `signals` whole signals a block, radix = min(16, n) complex values a
// thread, so signals * n / radix threads a block (at most 512).  is_double
// selects float64 (1) or float32 (0).  The caller makes the stream's device
// current.  Returns the cudaError_t of the attribute call or the launch.
int repro_fft_stockham_block(const void* re, const void* im, const void* wre,
                             const void* wim, void* out_re, void* out_im,
                             int64_t batch, int64_t n, int log2n, int signals,
                             int is_double, void* stream) {
  if (bad_shape(batch, n, log2n) || log2n > 13 || signals <= 0 ||
      signals * (n / block_radix(n)) > kBlockMaxThreads ||
      (batch + signals - 1) / signals > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_double ? launch_block<double>(re, im, wre, wim, out_re, out_im, batch, n,
                                       log2n, signals, st)
                : launch_block<float>(re, im, wre, wim, out_re, out_im, batch, n,
                                      log2n, signals, st);
  return static_cast<int>(err);
}

// Two-pass form, pass A (cols = 1: planes (xr, xi) -> scratch (yr, yi)) or
// pass B (cols = 0: scratch -> output planes), all (batch, n); n1 =
// 2^log2n1, `2^log2tile` columns (A) or rows (B) a block.
int repro_fft_pass(int cols, const void* xr, const void* xi, const void* wre,
                   const void* wim, void* yr, void* yi, int64_t batch, int64_t n,
                   int log2n, int log2n1, int log2tile, int threads, int is_double,
                   void* stream) {
  const int log2sub = cols ? log2n - log2n1 : log2n1;   // sub-signals of a pass
  if (bad_shape(batch, n, log2n) || log2n1 < 1 || log2n1 >= log2n ||
      log2tile < 0 || log2tile > log2sub || threads <= 0 || threads > 1024 ||
      (batch << (log2sub - log2tile)) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_double ? launch_pass<double>(cols != 0, xr, xi, wre, wim, yr, yi, batch, log2n,
                                      log2n1, log2tile, threads, st)
                : launch_pass<float>(cols != 0, xr, xi, wre, wim, yr, yi, batch, log2n,
                                     log2n1, log2tile, threads, st);
  return static_cast<int>(err);
}

const char* repro_fft_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
