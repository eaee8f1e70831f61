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
// two input planes and the twiddle tables once and writes the two output
// planes once: 4 * sizeof(T) * batch * n + 2 * sizeof(T) * log2(n) * n / 2
// bytes.  Its arithmetic, 10 flops per butterfly (5 n log2 n a signal), is
// far below the card's fp64 rate at every n the service registers.
//
// Two forms:
//   * in-block (repro_fft_stockham_block): one block holds `signals` whole
//     signals in dynamic shared memory, two planes in two ping-pong buffers
//     (4 * signals * n * sizeof(T) bytes; the host caps `signals` so this
//     fits the 227 KB a block may claim, which serves n <= 4096 in fp64 and
//     n <= 8192 in fp32).  One thread per butterfly, looped when a block
//     holds more butterflies than threads, __syncthreads() between stages;
//     the input is read once and the output written once, coalesced.  The
//     last block of a batch that `signals` does not divide holds fewer
//     signals (masked, no padding).  Twiddles come from the device tables,
//     which stay in L2 (176 KB at n = 2048 in fp64).
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
// Left for later: bank-conflict-free stage writes, and radix-4 stages in the
// in-block form too.
//
// The host wrapper is repro_torch/kernels/fft.py::fft_stockham; it chooses
// the form, `signals`, (n1, n2) and the tiles
// (repro_torch/core/autotune.py::fft_block_signals, fft_two_pass),
// allocates outputs and scratch, validates device, dtype, shape and
// contiguity, and raises on a non-zero return code.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// One butterfly of stage s: reads x[off + j], x[off + j + half], writes the
// sum and the twiddled difference to their Stockham places in y.
template <typename T>
__device__ __forceinline__ void butterfly(const T* xr, const T* xi, T* yr, T* yi,
                                          int64_t off, int64_t j, int64_t half,
                                          int s, T wr, T wi) {
  const T ar = xr[off + j], ai = xi[off + j];
  const T br = xr[off + j + half], bi = xi[off + j + half];
  const T dr = ar - br, di = ai - bi;
  const int64_t m = int64_t(1) << s;
  const int64_t o = off + ((j >> s) << (s + 1)) + (j & (m - 1));
  yr[o] = ar + br;
  yi[o] = ai + bi;
  yr[o + m] = dr * wr - di * wi;
  yi[o + m] = dr * wi + di * wr;
}

template <typename T>
__global__ void __launch_bounds__(1024)
fft_block_kernel(const T* __restrict__ re, const T* __restrict__ im,
                 const T* __restrict__ wre, const T* __restrict__ wim,
                 T* __restrict__ out_re, T* __restrict__ out_im,
                 int64_t batch, int64_t n, int log2n, int signals) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int64_t per = static_cast<int64_t>(signals) * n;
  T* ar = smem;
  T* ai = smem + per;
  T* br = smem + 2 * per;
  T* bi = smem + 3 * per;

  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * signals;
  const int64_t left = batch - b0;   // the last block may hold fewer
  const int64_t rows = left < signals ? left : signals;
  const int64_t count = rows * n;
  const int64_t base = b0 * n;
  for (int64_t i = threadIdx.x; i < count; i += blockDim.x) {
    ar[i] = __ldg(re + base + i);
    ai[i] = __ldg(im + base + i);
  }
  __syncthreads();

  const int64_t half = n >> 1;
  const int64_t work = rows * half;
  for (int s = 0; s < log2n; ++s) {
    const T* wr = wre + s * half;
    const T* wi = wim + s * half;
    for (int64_t t = threadIdx.x; t < work; t += blockDim.x) {
      const int64_t sig = t >> (log2n - 1);   // t / half
      const int64_t j = t & (half - 1);
      butterfly(ar, ai, br, bi, sig * n, j, half, s, __ldg(wr + j), __ldg(wi + j));
    }
    __syncthreads();
    T* tr = ar; ar = br; br = tr;
    T* ti = ai; ai = bi; bi = ti;
  }

  for (int64_t i = threadIdx.x; i < count; i += blockDim.x) {
    out_re[base + i] = ar[i];
    out_im[base + i] = ai[i];
  }
}

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

template <typename T>
cudaError_t launch_block(const void* re, const void* im, const void* wre,
                         const void* wim, void* out_re, void* out_im, int64_t batch,
                         int64_t n, int log2n, int signals, int threads,
                         cudaStream_t stream) {
  const size_t smem = 4 * static_cast<size_t>(signals) * n * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      fft_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();   // clear it: a later launch must not report it
    return err;
  }
  const dim3 grid(static_cast<unsigned>((batch + signals - 1) / signals));
  fft_block_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(re), static_cast<const T*>(im),
      static_cast<const T*>(wre), static_cast<const T*>(wim),
      static_cast<T*>(out_re), static_cast<T*>(out_im), batch, n, log2n, signals);
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

// In-block form: re, im, out_re, out_im (batch, n); wre, wim (log2n, n / 2);
// `signals` whole signals a block, `threads` threads a block.  is_double
// selects float64 (1) or float32 (0).  The caller makes the stream's device
// current.  Returns the cudaError_t of the attribute call or the launch.
int repro_fft_stockham_block(const void* re, const void* im, const void* wre,
                             const void* wim, void* out_re, void* out_im,
                             int64_t batch, int64_t n, int log2n, int signals,
                             int threads, int is_double, void* stream) {
  if (bad_shape(batch, n, log2n) || signals <= 0 || threads <= 0 || threads > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_double ? launch_block<double>(re, im, wre, wim, out_re, out_im, batch, n,
                                       log2n, signals, threads, st)
                : launch_block<float>(re, im, wre, wim, out_re, out_im, batch, n,
                                      log2n, signals, threads, st);
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
