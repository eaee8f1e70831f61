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
// Design:
//   * narrow buckets (width below the split width): one thread per
//     (slice s, lane c) row; consecutive threads take consecutive lanes of
//     a slice, so the loads of cols[s, w, :] and vals[s, w, :] are coalesced
//     across the warp for any slice height C the packer produces (8 .. 1024,
//     warp multiple or not);
//   * the thread walks the bucket's whole width w = 0 .. W-1 and keeps
//     K_TILE partial sums in registers (K_TILE a template parameter in
//     {1, 2, 4, 8, 16, 32}); a PAD column (-1) skips the value load and the
//     X gather;
//   * wide buckets (repro_torch/core/autotune.py::spmm_split): a row's walk
//     is the latency chain that sets a bucket's time (one thread walking
//     2,048 entries on big's widest bucket, with 64 rows on 2 SMs).  There
//     `parts` threads share each row: a block holds `lanes` consecutive rows
//     x `parts` threads (threadIdx = p * lanes + l), thread p walks
//     w = p, p + parts, ... (at a fixed w the lanes of a warp still read
//     consecutive slab entries), its loads for several w issued before their
//     multiply-adds.  The `parts` partial sums of a row are then added in
//     shared memory in the order p = 0, 1, ..., KC columns of the tile a
//     round: the result is deterministic (no atomics; two calls give the
//     same bits), though summed in another order than one thread's walk;
//   * X's K_TILE values of a row are loaded as 16-byte vectors where the
//     tile allows (double2; float4, or float2 at K_TILE = 2): ld and k0 are
//     multiples of K_TILE and the wrapper aligns X to 16 bytes;
//   * the row scatter is fused into the epilogue: the thread writes its
//     K_TILE sums straight to Y[rows[s, c], k0 : k0 + K_TILE], so each
//     output element is written once and no (S, C, k) intermediate exists.
//     Padding lanes carry row id n_rows and land in Y's dump row, which the
//     wrapper trims; they race harmlessly (every one writes zeros).
//   * grid = (ceil(S * C / rows a block), k_pad / K_TILE); offsets are
//     64-bit.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kPad = -1;

__device__ __forceinline__ float mac(float a, float b, float acc) { return fmaf(a, b, acc); }
__device__ __forceinline__ double mac(double a, double b, double acc) { return fma(a, b, acc); }

// K_TILE values of one X row from its column k0: 16-byte vectors where the
// tile allows.  p is 16-byte aligned whenever a vector type is used.
template <typename T, int K_TILE>
__device__ __forceinline__ void load_x(const T* __restrict__ p, T* out) {
  if constexpr (sizeof(T) == 8 && K_TILE % 2 == 0) {
    const double2* v = reinterpret_cast<const double2*>(p);
#pragma unroll
    for (int i = 0; i < K_TILE / 2; ++i) {
      const double2 d = __ldg(v + i);
      out[2 * i] = d.x;
      out[2 * i + 1] = d.y;
    }
  } else if constexpr (sizeof(T) == 4 && K_TILE % 4 == 0) {
    const float4* v = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int i = 0; i < K_TILE / 4; ++i) {
      const float4 f = __ldg(v + i);
      out[4 * i] = f.x;
      out[4 * i + 1] = f.y;
      out[4 * i + 2] = f.z;
      out[4 * i + 3] = f.w;
    }
  } else if constexpr (sizeof(T) == 4 && K_TILE == 2) {
    const float2 f = __ldg(reinterpret_cast<const float2*>(p));
    out[0] = f.x;
    out[1] = f.y;
  } else {
#pragma unroll
    for (int i = 0; i < K_TILE; ++i) out[i] = __ldg(p + i);
  }
}

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
      T xv[K_TILE];
      load_x<T, K_TILE>(x + static_cast<int64_t>(col) * ld + k0, xv);
#pragma unroll
      for (int kk = 0; kk < K_TILE; ++kk) acc[kk] = mac(v, xv[kk], acc[kk]);
    }
  }

  // rows is (S, C): the flat index of (s, lane) is t itself
  T* yr = y + static_cast<int64_t>(__ldg(rows + t)) * ld + k0;
#pragma unroll
  for (int kk = 0; kk < K_TILE; ++kk) yr[kk] = acc[kk];
}

// Columns of the tile reduced per round in a split block (the shared
// memory of the partial sums is threads * KC * sizeof(T): 32 KB at most).
template <int K_TILE>
__host__ __device__ constexpr int split_k_chunk() { return K_TILE < 4 ? K_TILE : 4; }

// Most threads of a split block: a thread keeps K_TILE sums and a gathered
// tile in registers, and 65,536 registers serve the block (the host's
// repro_torch/core/autotune.py::spmm_split_max_threads).
template <int K_TILE>
__host__ __device__ constexpr int split_max_threads() { return K_TILE >= 16 ? 256 : (K_TILE >= 8 ? 512 : 1024); }

template <typename T, int K_TILE>
__global__ void __launch_bounds__(split_max_threads<K_TILE>())
spmm_sell_split_kernel(const int32_t* __restrict__ cols, const T* __restrict__ vals,
                       const int32_t* __restrict__ rows, const T* __restrict__ x,
                       T* __restrict__ y, int64_t n_lanes, int64_t width, int64_t c,
                       int64_t ld, int parts) {
  constexpr int KC = split_k_chunk<K_TILE>();
  // loads in flight per step of the walk: fewer when each brings a wide tile
  constexpr int U = K_TILE >= 8 ? 1 : (K_TILE >= 4 ? 2 : 4);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* red = reinterpret_cast<T*>(smem_raw);
  const int lanes = blockDim.x / parts;
  const int l = threadIdx.x % lanes;
  const int p = threadIdx.x / lanes;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * lanes;
  const int64_t t = row0 + l;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * K_TILE;

  T acc[K_TILE];
#pragma unroll
  for (int kk = 0; kk < K_TILE; ++kk) acc[kk] = T(0);

  if (t < n_lanes) {
    const int64_t s = t / c;
    const int64_t base = s * width * c + (t - s * c);
    int64_t w = p;
    for (; w + (U - 1) * static_cast<int64_t>(parts) < width; w += U * parts) {
      int32_t col[U];
      T v[U];
      T xv[U][K_TILE];
#pragma unroll
      for (int u = 0; u < U; ++u) col[u] = __ldg(cols + base + (w + u * parts) * c);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (col[u] != kPad) {
          v[u] = __ldg(vals + base + (w + u * parts) * c);
          load_x<T, K_TILE>(x + static_cast<int64_t>(col[u]) * ld + k0, xv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (col[u] != kPad) {
#pragma unroll
          for (int kk = 0; kk < K_TILE; ++kk) acc[kk] = mac(v[u], xv[u][kk], acc[kk]);
        }
      }
    }
    for (; w < width; w += parts) {
      const int64_t e = base + w * c;
      const int32_t col = __ldg(cols + e);
      if (col != kPad) {
        const T v = __ldg(vals + e);
        T xv[K_TILE];
        load_x<T, K_TILE>(x + static_cast<int64_t>(col) * ld + k0, xv);
#pragma unroll
        for (int kk = 0; kk < K_TILE; ++kk) acc[kk] = mac(v, xv[kk], acc[kk]);
      }
    }
  }

  // Each round: every thread stores KC partial sums at (p, l, j); then one
  // thread per (row l, column j) adds the `parts` of them in order p = 0, 1,
  // ... and writes Y once.
#pragma unroll
  for (int kc0 = 0; kc0 < K_TILE; kc0 += KC) {
#pragma unroll
    for (int j = 0; j < KC; ++j) red[(p * lanes + l) * KC + j] = acc[kc0 + j];
    __syncthreads();
    for (int o = threadIdx.x; o < lanes * KC; o += blockDim.x) {
      const int lo = o / KC;
      const int j = o - lo * KC;
      if (row0 + lo < n_lanes) {
        T sum = red[lo * KC + j];
        for (int q = 1; q < parts; ++q) sum += red[(q * lanes + lo) * KC + j];
        y[static_cast<int64_t>(__ldg(rows + row0 + lo)) * ld + k0 + kc0 + j] = sum;
      }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch_typed(const void* cols, const void* vals, const void* rows,
                         const void* x, void* y, int64_t n_slices,
                         int64_t width, int64_t c, int64_t ld, int k_tile,
                         int threads, int parts, cudaStream_t stream) {
  const int64_t n_lanes = n_slices * c;
  const int64_t per_block = parts > 1 ? threads / parts : threads;
  const dim3 block(threads);
  const dim3 grid(static_cast<unsigned>((n_lanes + per_block - 1) / per_block),
                  static_cast<unsigned>(ld / k_tile));
  const auto* ci = static_cast<const int32_t*>(cols);
  const auto* vi = static_cast<const T*>(vals);
  const auto* ri = static_cast<const int32_t*>(rows);
  const auto* xi = static_cast<const T*>(x);
  auto* yo = static_cast<T*>(y);
  switch (k_tile) {
#define REPRO_SPMM_CASE(K)                                                       \
  case K:                                                                        \
    if (parts > 1) {                                                             \
      if (threads > split_max_threads<K>()) return cudaErrorInvalidValue;       \
      const size_t smem = static_cast<size_t>(threads) * split_k_chunk<K>() *   \
                          sizeof(T);                                             \
      spmm_sell_split_kernel<T, K><<<grid, block, smem, stream>>>(              \
          ci, vi, ri, xi, yo, n_lanes, width, c, ld, parts);                     \
    } else {                                                                     \
      spmm_sell_bucket_kernel<T, K><<<grid, block, 0, stream>>>(                \
          ci, vi, ri, xi, yo, n_lanes, width, c, ld);                            \
    }                                                                            \
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
// ld), y (n_rows + 1, ld); ld is a multiple of k_tile, x 16-byte aligned.
// parts = 1: one thread a row, `threads` a block; parts > 1: `parts` threads
// a row, threads = rows a block x parts (at most 1024).  is_double selects
// float64 (1) or float32 (0).  The caller makes the stream's device current.
// Returns the cudaError_t of the launch (0 on success).
int repro_spmm_sell_bucket(const void* cols, const void* vals, const void* rows,
                           const void* x, void* y, int64_t n_slices,
                           int64_t width, int64_t c, int64_t ld, int k_tile,
                           int threads, int parts, int is_double, void* stream) {
  if (n_slices <= 0 || width <= 0 || c <= 0 || ld <= 0 || k_tile <= 0 ||
      ld % k_tile != 0 || threads <= 0 || threads > 1024 || parts <= 0 ||
      threads % parts != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_double ? launch_typed<double>(cols, vals, rows, x, y, n_slices, width, c, ld,
                                       k_tile, threads, parts, s)
                : launch_typed<float>(cols, vals, rows, x, y, n_slices, width, c, ld,
                                      k_tile, threads, parts, s);
  return static_cast<int>(err);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
