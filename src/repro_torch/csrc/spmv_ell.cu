// ELLPACK SpMV / SpMM for Hopper (sm_90a): y = A @ x and Y = A @ X on the
// slice-transposed uniform-width layout, the paper's baseline format.
//
// Replaces the TPU kernel repro/kernels/spmv.py::_spmv_kernel (launched by
// spmv_ell): cols / vals of shape (S, W, C), element (s, w, c) the w-th
// nonzero of row s * C + c, PAD (-1) columns masked; y has S * C entries and
// the caller trims it to n_rows.  The JAX package runs a k-column product
// one column at a time through that kernel (repro/kernels/ops.py::spmm); the
// k-column form below (repro_spmm_ell) computes the same columns in one
// launch a k tile.
//
// What bounds it on the card: device-memory bytes.  The function reads every
// stored entry once (an int32 column and a value), gathers x through the
// 50 MB L2 and writes y once: 12 nnz + 8 n_cols + 8 n_rows bytes in fp64,
// and 12 nnz + 8 k (n_x + n_rows) for k columns, where every entry also
// gathers a k-wide row of X (8 k nnz bytes, far past the L2 when X is).
// One multiply-add per entry and column is far below the arithmetic rate.
//
// Design:
//   * live width per warp: live[t >> 5] is 1 + the last slot w at which any
//     of the 32 consecutive rows t of that warp stores a non-PAD column (0
//     for none), computed once per operand by the host wrapper
//     (repro_torch/kernels/spmv.py::live_widths).  Every thread of the
//     warp walks w only up to it: the slots past it are PAD in every lane,
//     so their int32 columns are never loaded (on a Poisson operand at
//     width 38 the warps' longest rows end near slot 25).  A PAD slot
//     inside the walk is still masked.  The width read is bounded to
//     [0, W] here, so a width handed in past W walks the whole row and a
//     negative one walks none: no slot outside the slab is read;
//   * the walk is unrolled by U slots (UNROLL_1 / UNROLL_K), the last round
//     masked at the live width: first the U column loads, then the value
//     loads and the x gathers of the live ones, then the multiply-adds in
//     ascending w, so a thread keeps 3 U loads in flight where the plain
//     loop had one.  Each row's sum takes its multiply-adds in the same
//     order as a one-slot loop: the result is bit-equal to it and to the
//     column-by-column walk of the k form;
//   * the slabs are read once, so their loads are marked evict-first
//     (__ldcs) and leave the L2 to x (16 MB at 2M fp64 columns), which the
//     gathers reuse (faster at k = 1 in scripts/b6_variants.py);
//   * one kernel body serves both forms.  k = 1 (repro_spmv_ell) is the
//     body at one column a lane and groups of one lane: one thread per row
//     (s, c); consecutive threads take consecutive lanes c of a slice, so
//     for every w the loads of cols[s, w, :] and vals[s, w, :] coalesce
//     across a warp in the reference's own layout;
//   * k columns (repro_spmm_ell), X (n_x, ld) and Y (S * C, ld) row-major:
//     a group of G lanes of one warp serves one row, each lane V columns (16
//     B: V = 2 fp64 or 4 fp32 when the row stride allows, else 1), G * V
//     covering the launch's k tile (at most 32 lanes).  The group reads each
//     (col, val) slot once for the whole tile and gathers X row col as G
//     contiguous 16 B pieces: whole sectors.  Lanes past the tile's last
//     column are masked.  One launch a k tile: k = 32 fp64 is one launch of
//     16-lane groups (256 B a row), where the column-by-column walk made 32
//     launches and read the slabs 32 times;
//   * rows past n_rows in the last slice hold only PAD and write 0;
//   * the TPU kernel's w-blocks (y accumulated across grid steps) become the
//     loop inside the thread: w_block does not change the result.
//   * offsets are 64-bit.
//
// The host wrappers are repro_torch/kernels/spmv.py::spmv_ell and
// ::spmm_ell; they allocate y, validate device, dtype, shape and
// contiguity, and raise on a non-zero return code.  Column bounds are the
// preflight's job (repro_torch/analysis/preflight.py::plan_spmv_ell); the
// live widths are bounded in the kernel as above.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kPad = -1;
// Slots a thread loads before it multiplies (the body's U): 16 at k = 1, 4
// in the k form, whose X pieces take V registers each (the best of 4 / 8 /
// 16 at the 2,097,152-row operand on an H100: scripts/b6_variants.py).
constexpr int UNROLL_1 = 16;
constexpr int UNROLL_K = 4;

__device__ __forceinline__ float mac(float a, float b, float acc) { return fmaf(a, b, acc); }
__device__ __forceinline__ double mac(double a, double b, double acc) { return fma(a, b, acc); }

// V consecutive values of one row of X (16 B when V * sizeof(T) == 16).
template <typename T, int V>
struct Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_vec(const T* p) {
  Vec<T, V> r;
  if constexpr (V * sizeof(T) == 16) {
    if constexpr (sizeof(T) == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p));
      r.v[0] = q.x; r.v[1] = q.y; r.v[2] = q.z; r.v[3] = q.w;
    } else {
      const double2 q = __ldg(reinterpret_cast<const double2*>(p));
      r.v[0] = q.x; r.v[1] = q.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) r.v[i] = __ldg(p + i);
  }
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const T (&a)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
    } else {
      *reinterpret_cast<double2*>(p) = make_double2(a[0], a[1]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = a[i];
  }
}

// One k tile: columns [k0, k0 + kt) of X (n_x, ld) into Y (n_lanes, ld).
// Rows go in groups of `group` lanes (a power of two <= 32), lane j of a
// group holding columns k0 + j * V .. k0 + j * V + V - 1, U slots loaded
// before the multiply-adds.  k = 1 is this body at V = 1, group 1, ld 1:
// one thread a row.
template <typename T, int V, int U>
__global__ void spmm_ell_kernel(const int32_t* __restrict__ cols,
                                const T* __restrict__ vals,
                                const T* __restrict__ X, T* __restrict__ Y,
                                const int32_t* __restrict__ live,
                                int64_t n_lanes, int64_t width, int64_t c,
                                int64_t ld, int k0, int kt, int group) {
  const int rows_per_block = blockDim.x / group;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * rows_per_block +
                    threadIdx.x / group;
  if (r >= n_lanes) return;
  const int j = threadIdx.x % group;
  const bool active = j * V < kt;
  const int64_t col0 = k0 + static_cast<int64_t>(j) * V;
  const int64_t s = r / c;
  const int64_t lane = r - s * c;
  const int64_t base = s * width * c + lane;
  const int32_t handed = __ldg(live + (r >> 5));
  const int wl = handed < 0 ? 0 : (handed > width ? static_cast<int>(width) : handed);
  T acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = T(0);
  for (int w = 0; w < wl; w += U) {
    int32_t col[U];
    T v[U];
    Vec<T, V> xv[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      col[u] = w + u < wl ? __ldcs(cols + base + (w + u) * c) : kPad;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      v[u] = w + u < wl ? __ldcs(vals + base + (w + u) * c) : T(0);
      if (col[u] != kPad && active) {
        xv[u] = load_vec<T, V>(X + static_cast<int64_t>(col[u]) * ld + col0);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) xv[u].v[i] = T(0);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (col[u] != kPad) {
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = mac(v[u], xv[u].v[i], acc[i]);
      }
    }
  }
  if (active) store_vec<T, V>(Y + r * ld + col0, acc);
}

template <typename T, int V, int U>
cudaError_t launch_spmm(const void* cols, const void* vals, const void* X, void* Y,
                        const void* live, int64_t n_slices, int64_t width, int64_t c,
                        int64_t ld, int k0, int kt, int group, int threads,
                        cudaStream_t stream) {
  const int64_t n_lanes = n_slices * c;
  const int64_t rows = threads / group;
  const dim3 grid(static_cast<unsigned>((n_lanes + rows - 1) / rows));
  spmm_ell_kernel<T, V, U><<<grid, threads, 0, stream>>>(
      static_cast<const int32_t*>(cols), static_cast<const T*>(vals),
      static_cast<const T*>(X), static_cast<T*>(Y),
      static_cast<const int32_t*>(live), n_lanes, width, c, ld, k0, kt, group);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// cols / vals (n_slices, width, c), x (n_cols,), y (n_slices * c,), live
// (ceil(n_slices * c / 32),) int32.  is_double selects float64 (1) or
// float32 (0).  The caller makes the stream's device current.  Returns the
// cudaError_t of the launch.
int repro_spmv_ell(const void* cols, const void* vals, const void* x, void* y,
                   const void* live, int64_t n_slices, int64_t width, int64_t c,
                   int threads, int is_double, void* stream) {
  if (n_slices <= 0 || width < 0 || c <= 0 || threads <= 0 || threads > 1024 ||
      threads % 32 != 0 || live == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_double ? launch_spmm<double, 1, UNROLL_1>(cols, vals, x, y, live, n_slices, width, c,
                                                   1, 0, 1, 1, threads, st)
                : launch_spmm<float, 1, UNROLL_1>(cols, vals, x, y, live, n_slices, width, c,
                                                  1, 0, 1, 1, threads, st);
  return static_cast<int>(err);
}

// The k-column form: columns [k0, k0 + kt) of X (n_x, ld) into the same
// columns of Y (n_slices * c, ld), groups of `group` lanes a row, `vec`
// columns a lane (1, or 16 B: 2 fp64 / 4 fp32, which needs ld and k0
// multiples of vec and 16 B aligned X and Y).
int repro_spmm_ell(const void* cols, const void* vals, const void* X, void* Y,
                   const void* live, int64_t n_slices, int64_t width, int64_t c,
                   int64_t ld, int k0, int kt, int group, int vec, int threads,
                   int is_double, void* stream) {
  const bool pow2 = group > 0 && (group & (group - 1)) == 0;
  if (n_slices <= 0 || width < 0 || c <= 0 || threads <= 0 || threads > 1024 ||
      threads % 32 != 0 || live == nullptr || !pow2 || group > 32 || kt <= 0 ||
      k0 < 0 || k0 + kt > ld || kt > group * vec) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
#define REPRO_ELL_CASE(T, V)                                                              \
  launch_spmm<T, V, UNROLL_K>(cols, vals, X, Y, live, n_slices, width, c, ld, k0, kt, group, \
                              threads, st)
  cudaError_t err = cudaErrorInvalidValue;
  if (is_double) {
    if (vec == 1) err = REPRO_ELL_CASE(double, 1);
    else if (vec == 2) err = REPRO_ELL_CASE(double, 2);
  } else {
    if (vec == 1) err = REPRO_ELL_CASE(float, 1);
    else if (vec == 4) err = REPRO_ELL_CASE(float, 4);
  }
#undef REPRO_ELL_CASE
  return static_cast<int>(err);
}

const char* repro_spmv_ell_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
