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
//
// What bounds it on the card: device-memory bytes.  The function reads the
// two input planes and the twiddle tables once and writes the two output
// planes once: 4 * sizeof(T) * batch * n + 2 * sizeof(T) * log2(n) * n / 2
// bytes.  Its arithmetic, 10 flops per butterfly (5 n log2 n a signal), is
// far below the card's fp64 rate at every n the service registers.
//
// Two forms, both right and simple first:
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
//   * per-stage (repro_fft_stockham_stage): for longer signals, one launch
//     per stage over the whole batch, one thread per butterfly, reading one
//     device buffer and writing the other (the wrapper allocates them).
//     Each stage moves the whole batch through device memory, log2 n times
//     the bound's bytes.
//   * nvcc contracts dr * wr - di * wi into FMAs, so the kernel and the plain
//     PyTorch version differ by ulps per stage; the tolerance says so.
//   * Above 48 KB of dynamic shared memory the in-block form first raises
//     the kernel's limit with cudaFuncSetAttribute.  A refused request or
//     launch is returned as its cudaError_t (and cleared), never silent.
// Left for later: bank-conflict-free stage writes, radix-4/8, and the
// four-step form for long n (shared-memory passes instead of log2 n sweeps).
//
// The host wrapper is repro_torch/kernels/fft.py::fft_stockham; it chooses
// the form and `signals` (repro_torch/core/autotune.py::fft_block_signals),
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

template <typename T>
__global__ void fft_stage_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                                 const T* __restrict__ wre, const T* __restrict__ wim,
                                 T* __restrict__ yr, T* __restrict__ yi,
                                 int64_t batch, int64_t n, int log2n, int s) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t half = n >> 1;
  if (t >= batch * half) return;
  const int64_t sig = t >> (log2n - 1);
  const int64_t j = t & (half - 1);
  butterfly(xr, xi, yr, yi, sig * n, j, half, s, __ldg(wre + s * half + j),
            __ldg(wim + s * half + j));
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

template <typename T>
cudaError_t launch_stage(const void* xr, const void* xi, const void* wre,
                         const void* wim, void* yr, void* yi, int64_t batch,
                         int64_t n, int log2n, int s, int threads,
                         cudaStream_t stream) {
  const int64_t work = batch * (n >> 1);
  const dim3 grid(static_cast<unsigned>((work + threads - 1) / threads));
  fft_stage_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(xr), static_cast<const T*>(xi),
      static_cast<const T*>(wre), static_cast<const T*>(wim),
      static_cast<T*>(yr), static_cast<T*>(yi), batch, n, log2n, s);
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

// Per-stage form: stage s from planes (xr, xi) into (yr, yi), all (batch, n).
int repro_fft_stockham_stage(const void* xr, const void* xi, const void* wre,
                             const void* wim, void* yr, void* yi, int64_t batch,
                             int64_t n, int log2n, int s, int threads,
                             int is_double, void* stream) {
  if (bad_shape(batch, n, log2n) || s < 0 || s >= log2n || threads <= 0 ||
      threads > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_double ? launch_stage<double>(xr, xi, wre, wim, yr, yi, batch, n, log2n, s,
                                       threads, st)
                : launch_stage<float>(xr, xi, wre, wim, yr, yi, batch, n, log2n, s,
                                      threads, st);
  return static_cast<int>(err);
}

const char* repro_fft_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
