// SELL-C-sigma multi-RHS SpMM for Hopper (sm_90a): Y = A @ X, one width
// bucket per launch.
//
// Replaces the TPU kernel repro/kernels/sell_core.py::_spmm_kernel (launched
// by _spmm_bucket / spmm_sell; sell.py::spmv_sell is its k = 1 column).
//
// What bounds it on the card: device-memory bytes.  Every slab entry (an
// int32 column index and a value) is read once, X is gathered through the
// 50 MB L2, and Y is written once; per entry the kernel does one multiply-add
// per RHS column, far below the card's arithmetic rate.  The least time of
// the function is (nnz * (4 + sizeof(T)) + 4 * n_rows + X + Y) / 3.35 TB/s;
// the pad entries of the SELL slabs are this layout's own bytes above it.
//
// Design, right and simple first:
//   * one thread per (slice s, lane c) row of the bucket; consecutive
//     threads take consecutive lanes of a slice, so the loads of
//     cols[s, w, :] and vals[s, w, :] are coalesced across the warp for any
//     slice height C the packer produces (8 .. 1024, warp multiple or not);
//   * the thread walks the bucket's whole width w = 0 .. W-1 and keeps
//     K_TILE partial sums in registers (K_TILE a template parameter in
//     {1, 2, 4, 8, 16, 32}); a PAD column (-1) skips the value load and the
//     X gather;
//   * the row scatter is fused into the epilogue: the thread writes its
//     K_TILE sums straight to Y[rows[s, c], k0 : k0 + K_TILE], so each
//     output element is written once and no (S, C, k) intermediate exists.
//     Padding lanes carry row id n_rows and land in Y's dump row, which the
//     wrapper trims; they race harmlessly (every one writes zeros).
//   * grid = (ceil(S * C / threads), k_pad / K_TILE); offsets are 64-bit.
//
// The host wrapper is repro_torch/kernels/sell_core.py::spmm_sell; it
// allocates Y (zeros, (n_rows + 1, k_pad)), validates device, dtype, shape
// and contiguity, and raises on a non-zero return code.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kPad = -1;

__device__ __forceinline__ float mac(float a, float b, float acc) { return fmaf(a, b, acc); }
__device__ __forceinline__ double mac(double a, double b, double acc) { return fma(a, b, acc); }

template <typename T, int K_TILE>
__global__ void spmm_sell_bucket_kernel(const int32_t* __restrict__ cols,
                                        const T* __restrict__ vals,
                                        const int32_t* __restrict__ rows,
                                        const T* __restrict__ x,
                                        T* __restrict__ y,
                                        int64_t n_lanes,  // S * C
                                        int64_t width,    // W of the bucket
                                        int64_t c,        // slice height C
                                        int64_t ld) {     // row stride of X and Y
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_lanes) return;
  const int64_t s = t / c;
  const int64_t lane = t - s * c;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * K_TILE;

  T acc[K_TILE];
#pragma unroll
  for (int kk = 0; kk < K_TILE; ++kk) acc[kk] = T(0);

  // element (s, w, lane) of a (S, W, C) slab lives at (s * W + w) * C + lane
  const int64_t base = s * width * c + lane;
  for (int64_t w = 0; w < width; ++w) {
    const int64_t e = base + w * c;
    const int32_t col = __ldg(cols + e);
    if (col != kPad) {
      const T v = __ldg(vals + e);
      const T* xr = x + static_cast<int64_t>(col) * ld + k0;
#pragma unroll
      for (int kk = 0; kk < K_TILE; ++kk) acc[kk] = mac(v, __ldg(xr + kk), acc[kk]);
    }
  }

  // rows is (S, C): the flat index of (s, lane) is t itself
  T* yr = y + static_cast<int64_t>(__ldg(rows + t)) * ld + k0;
#pragma unroll
  for (int kk = 0; kk < K_TILE; ++kk) yr[kk] = acc[kk];
}

template <typename T>
cudaError_t launch_typed(const void* cols, const void* vals, const void* rows,
                         const void* x, void* y, int64_t n_slices,
                         int64_t width, int64_t c, int64_t ld, int k_tile,
                         int threads, cudaStream_t stream) {
  const int64_t n_lanes = n_slices * c;
  const dim3 block(threads);
  const dim3 grid(static_cast<unsigned>((n_lanes + threads - 1) / threads),
                  static_cast<unsigned>(ld / k_tile));
  const auto* ci = static_cast<const int32_t*>(cols);
  const auto* vi = static_cast<const T*>(vals);
  const auto* ri = static_cast<const int32_t*>(rows);
  const auto* xi = static_cast<const T*>(x);
  auto* yo = static_cast<T*>(y);
  switch (k_tile) {
#define REPRO_SPMM_CASE(K)                                                       \
  case K:                                                                        \
    spmm_sell_bucket_kernel<T, K><<<grid, block, 0, stream>>>(ci, vi, ri, xi, yo, \
                                                              n_lanes, width, c, ld); \
    break;
    REPRO_SPMM_CASE(1)
    REPRO_SPMM_CASE(2)
    REPRO_SPMM_CASE(4)
    REPRO_SPMM_CASE(8)
    REPRO_SPMM_CASE(16)
    REPRO_SPMM_CASE(32)
#undef REPRO_SPMM_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One bucket: cols/vals (n_slices, width, c), rows (n_slices, c), x (n_cols,
// ld), y (n_rows + 1, ld); ld is a multiple of k_tile.  is_double selects
// float64 (1) or float32 (0).  The caller makes the stream's device current.
// Returns the cudaError_t of the launch (0 on success).
int repro_spmm_sell_bucket(const void* cols, const void* vals, const void* rows,
                           const void* x, void* y, int64_t n_slices,
                           int64_t width, int64_t c, int64_t ld, int k_tile,
                           int threads, int is_double, void* stream) {
  if (n_slices <= 0 || width <= 0 || c <= 0 || ld <= 0 || k_tile <= 0 ||
      ld % k_tile != 0 || threads <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_double ? launch_typed<double>(cols, vals, rows, x, y, n_slices, width, c, ld,
                                       k_tile, threads, s)
                : launch_typed<float>(cols, vals, rows, x, y, n_slices, width, c, ld,
                                      k_tile, threads, s);
  return static_cast<int>(err);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
