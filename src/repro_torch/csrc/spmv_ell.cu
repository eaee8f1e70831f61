// ELLPACK SpMV for Hopper (sm_90a): y = A @ x on the slice-transposed
// uniform-width layout, the paper's baseline format.
//
// Replaces the TPU kernel repro/kernels/spmv.py::_spmv_kernel (launched by
// spmv_ell): cols / vals of shape (S, W, C), element (s, w, c) the w-th
// nonzero of row s * C + c, PAD (-1) columns masked; y has S * C entries and
// the caller trims it to n_rows.
//
// What bounds it on the card: device-memory bytes.  The function reads every
// stored entry once (an int32 column and a value), gathers x through the
// 50 MB L2 and writes y once: 12 nnz + 8 n_cols + 8 n_rows bytes in fp64.
// One multiply-add per entry is far below the card's arithmetic rate.  The
// PAD entries of the uniform width are the layout's own bytes above that.
//
// Design, right and simple first:
//   * one thread per row (s, c); consecutive threads take consecutive lanes
//     c of a slice, so for every w the loads of cols[s, w, :] and
//     vals[s, w, :] coalesce across a warp in the reference's own layout (no
//     re-layout at upload, unlike the graph slabs of graph_step.cu);
//   * the thread walks w = 0 .. W-1 in ascending order and keeps its sum in
//     a register; a PAD column skips the value load and the x gather;
//   * rows past n_rows in the last slice hold only PAD and write 0;
//   * the TPU kernel's w-blocks (y accumulated across grid steps) become the
//     loop inside the thread: w_block does not change the result.
//   * grid = ceil(S * C / threads); offsets are 64-bit.
//
// The host wrapper is repro_torch/kernels/spmv.py::spmv_ell; it allocates y,
// validates device, dtype, shape and contiguity, and raises on a non-zero
// return code.  Column bounds are the preflight's job
// (repro_torch/analysis/preflight.py::plan_spmv_ell).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kPad = -1;

__device__ __forceinline__ float mac(float a, float b, float acc) { return fmaf(a, b, acc); }
__device__ __forceinline__ double mac(double a, double b, double acc) { return fma(a, b, acc); }

template <typename T>
__global__ void spmv_ell_kernel(const int32_t* __restrict__ cols,
                                const T* __restrict__ vals,
                                const T* __restrict__ x, T* __restrict__ y,
                                int64_t n_lanes,  // S * C
                                int64_t width,    // W
                                int64_t c) {      // slice height C
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_lanes) return;
  const int64_t s = t / c;
  const int64_t lane = t - s * c;
  const int64_t base = s * width * c + lane;
  T acc = T(0);
  for (int64_t w = 0; w < width; ++w) {
    const int64_t e = base + w * c;
    const int32_t col = __ldg(cols + e);
    if (col != kPad) acc = mac(__ldg(vals + e), __ldg(x + col), acc);
  }
  y[t] = acc;
}

template <typename T>
cudaError_t launch_typed(const void* cols, const void* vals, const void* x, void* y,
                         int64_t n_slices, int64_t width, int64_t c, int threads,
                         cudaStream_t stream) {
  const int64_t n_lanes = n_slices * c;
  const dim3 grid(static_cast<unsigned>((n_lanes + threads - 1) / threads));
  spmv_ell_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const int32_t*>(cols), static_cast<const T*>(vals),
      static_cast<const T*>(x), static_cast<T*>(y), n_lanes, width, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// cols / vals (n_slices, width, c), x (n_cols,), y (n_slices * c,).
// is_double selects float64 (1) or float32 (0).  The caller makes the
// stream's device current.  Returns the cudaError_t of the launch.
int repro_spmv_ell(const void* cols, const void* vals, const void* x, void* y,
                   int64_t n_slices, int64_t width, int64_t c, int threads,
                   int is_double, void* stream) {
  if (n_slices <= 0 || width < 0 || c <= 0 || threads <= 0 || threads > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_double ? launch_typed<double>(cols, vals, x, y, n_slices, width, c, threads, st)
                : launch_typed<float>(cols, vals, x, y, n_slices, width, c, threads, st);
  return static_cast<int>(err);
}

const char* repro_spmv_ell_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
