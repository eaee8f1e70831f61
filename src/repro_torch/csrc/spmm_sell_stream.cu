// SELL-C-sigma multi-RHS SpMM for Hopper (sm_90a), streaming schedule:
// Y = A @ X, one width bucket per launch, X staged through shared memory in
// column tiles.
//
// Replaces the TPU kernel repro/kernels/sell_core.py::_spmm_stream_kernel
// (launched by _spmm_bucket_stream / spmm_sell_stream).  It computes the
// function of kernel B1 (spmm_sell.cu); what differs is the schedule: X is
// read in (col_tile, K_TILE) tiles that every row of a block reuses from
// shared memory, and each row's sums stay in registers across all tiles and
// are written once, through the same fused row scatter as B1.
//
// What bounds it on the card: device-memory bytes.  The function's least
// bytes are B1's, 12 * nnz + 4 * n_rows + 8 * k * (n_cols + n_rows) at fp64.
// The schedule adds its own: every block loads each X tile it touches, so X
// traffic is (blocks x touched tiles x col_tile x K_TILE x sizeof(T)); on
// uniformly random columns every block touches nearly every tile and loads
// nearly all of X.  Its arithmetic, one multiply-add per entry and column,
// is far below the card's rate.
//
// Design, right and simple first:
//   * the TPU cell keeps a (row_tile, C, k_tile) accumulator in VMEM across
//     a serial walk of column tiles; that does not fit a Hopper block (512
//     KB at 8 x 256 x 32 fp64).  So, as in B1, one thread owns one
//     (slice, lane) row and keeps K_TILE sums in registers; a block holds
//     `block_rows` consecutive rows (row_tile slices, at most 256 threads;
//     a taller slice is split across blocks), and a loop inside the block
//     replaces the TPU's sequential grid over column tiles;
//   * a row cursor instead of the TPU's masked walk: each thread consumes
//     its row's entries in w order while their column lies in the current
//     tile, so each slab entry is read once (the masked walk re-reads the
//     slab for every column tile, 256 .. 8192 times on a 2M-column operand).
//     The cursor steps over PAD entries (-1) wherever they lie, as B1 does;
//   * tile skipping: the next tile is the one holding the block-wide
//     minimum of the threads' next columns (warp __reduce_min_sync, then
//     shared memory), so a block loads only the tiles its rows touch (a
//     handful on a banded operand);
//   * two tile buffers filled by cp.async: while the block walks adjacent
//     tiles, the next tile in column order is fetched as the current one is
//     consumed (the Hopper form of the TPU's double-buffered DMA; TMA is
//     later work);
//   * each thread performs B1's multiply-adds (fma) in the order of B1's
//     one-thread-a-row body (w ascending, PAD skipped), on the same X
//     values, so on every bucket B1 does not split across threads the
//     result is bit-equal to B1's whatever the order of a row's columns (on
//     a split bucket the two agree to rounding): a thread
//     whose next column lies in an earlier tile waits until the block-wide
//     minimum steps back to it.  Ascending columns only keep a block from
//     loading a tile twice;
//   * the last tile is cut at n_cols (no padded copy of X); above 48 KB the
//     dynamic shared-memory limit is raised with cudaFuncSetAttribute, and a
//     refused request or launch is returned as its cudaError_t (and
//     cleared), never silent.
//
// The host wrapper is repro_torch/kernels/sell_core.py::spmm_sell_stream; it
// allocates Y (zeros, (n_rows + 1, k_pad)), pads k once to the K_TILE
// multiple, validates device, dtype, shape, contiguity and alignment, and
// raises on a non-zero return code.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kPad = -1;
constexpr int kEnd = INT_MAX;      // a thread's next column once its row is done
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;

__device__ __forceinline__ float mac(float a, float b, float acc) { return fmaf(a, b, acc); }
__device__ __forceinline__ double mac(double a, double b, double acc) { return fma(a, b, acc); }

template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(N));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying rows [tile * col_tile, min(.., n_cols)) of X's k tile into
// buf, (col_tile, K_TILE) row-major, in chunks of up to 16 bytes.
template <typename T, int K_TILE>
__device__ __forceinline__ void load_tile(T* buf, const T* __restrict__ x, int64_t tile,
                                          int col_tile, int64_t n_cols, int64_t ld,
                                          int64_t k0) {
  constexpr int kRowBytes = K_TILE * static_cast<int>(sizeof(T));
  constexpr int kChunk = kRowBytes < 16 ? kRowBytes : 16;
  constexpr int kPerRow = kRowBytes / kChunk;
  constexpr int kElems = kChunk / static_cast<int>(sizeof(T));
  const int64_t lo = tile * col_tile;
  const int64_t n_rows = (n_cols - lo < col_tile) ? n_cols - lo : col_tile;
  const int64_t n = n_rows * kPerRow;
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
    const int64_t r = i / kPerRow;
    const int64_t q = i - r * kPerRow;
    cp_async<kChunk>(buf + r * K_TILE + q * kElems, x + (lo + r) * ld + k0 + q * kElems);
  }
  cp_async_commit();
}

constexpr int kPadScan = 8;         // entries read at once past a PAD

// Column of the first stored (non-PAD) entry at or after e in the row whose
// entries lie C apart and end before e_end; e is left on it.  kEnd past the
// row's last entry.  Past a PAD the rest of the row is read kPadScan
// entries at a time with independent loads: the packer puts a row's PAD
// after its entries, and one dependent load per trailing PAD made a
// block's slowest row walk its whole bucket width serially.
__device__ __forceinline__ int next_column(const int32_t* __restrict__ cols, int64_t& e,
                                           int64_t e_end, int64_t c) {
  if (e >= e_end) return kEnd;
  const int col = __ldg(cols + e);
  if (col != kPad) return col;
  for (e += c; e < e_end; e += kPadScan * c) {
    int ahead[kPadScan];
#pragma unroll
    for (int i = 0; i < kPadScan; ++i)
      ahead[i] = e + i * c < e_end ? __ldg(cols + e + i * c) : kPad;
#pragma unroll
    for (int i = 0; i < kPadScan; ++i) {
      if (ahead[i] != kPad) {
        e += i * c;
        return ahead[i];
      }
    }
  }
  return kEnd;
}

// Minimum of v over the block (blockDim.x a multiple of 32, every thread
// calls it).  Its barriers also mean every thread is done with the tile it
// was consuming.
__device__ __forceinline__ int block_min(int v, int* s_min) {
  v = __reduce_min_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) s_min[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = s_min[0];
  for (int i = 1; i < static_cast<int>(blockDim.x >> 5); ++i) m = min(m, s_min[i]);
  __syncthreads();
  return m;
}

template <typename T, int K_TILE>
__global__ void __launch_bounds__(kMaxThreads)
    spmm_sell_stream_kernel(const int32_t* __restrict__ cols, const T* __restrict__ vals,
                            const int32_t* __restrict__ rows, const T* __restrict__ x,
                            T* __restrict__ y,
                            int64_t n_lanes,  // S * C
                            int64_t width,    // W of the bucket
                            int64_t c,        // slice height C
                            int64_t ld,       // row stride of X and Y
                            int64_t n_cols,   // rows of X
                            int col_tile, int block_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_min[kMaxWarps];
  T* use = reinterpret_cast<T*>(smem_raw);
  T* spare = use + static_cast<int64_t>(col_tile) * K_TILE;

  const int64_t t = static_cast<int64_t>(blockIdx.x) * block_rows + threadIdx.x;
  const bool valid = static_cast<int>(threadIdx.x) < block_rows && t < n_lanes;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * K_TILE;

  // the row cursor: element (s, w, lane) of a (S, W, C) slab lives at
  // (s * W + w) * C + lane, so the next entry is C further on
  int64_t e = 0, e_end = 0;
  int nc = kEnd;
  if (valid) {
    const int64_t s = t / c;
    e = s * width * c + (t - s * c);
    e_end = e + width * c;
    nc = next_column(cols, e, e_end, c);
  }
  T acc[K_TILE];
#pragma unroll
  for (int kk = 0; kk < K_TILE; ++kk) acc[kk] = T(0);

  const int64_t n_tiles = (n_cols + col_tile - 1) / col_tile;
  const int first = block_min(nc, s_min);
  if (first != kEnd) {
    int64_t tile = first / col_tile;
    load_tile<T, K_TILE>(use, x, tile, col_tile, n_cols, ld, k0);
    cp_async_wait_all();
    __syncthreads();
    bool adjacent = true;  // the block walks adjacent tiles: fetch ahead
    for (;;) {
      const bool fetched = adjacent && tile + 1 < n_tiles;
      if (fetched) load_tile<T, K_TILE>(spare, x, tile + 1, col_tile, n_cols, ld, k0);
      const int64_t lo = tile * col_tile;
      const int64_t hi = (lo + col_tile < n_cols) ? lo + col_tile : n_cols;
      // a row whose columns do not ascend may step back below lo: it waits
      // there until the block-wide minimum returns to that tile
      while (nc >= lo && nc < hi) {
        const T v = __ldg(vals + e);
        const T* xr = use + (nc - lo) * K_TILE;
#pragma unroll
        for (int kk = 0; kk < K_TILE; ++kk) acc[kk] = mac(v, xr[kk], acc[kk]);
        e += c;
        nc = next_column(cols, e, e_end, c);
      }
      const int next = block_min(nc, s_min);
      if (next == kEnd) {
        cp_async_wait_all();  // no copy may land after the block is gone
        break;
      }
      const int64_t next_tile = next / col_tile;
      adjacent = next_tile == tile + 1;
      if (adjacent && fetched) {
        T* done = use;
        use = spare;
        spare = done;
      } else {
        // `use` is free: block_min's barrier came after its last read
        load_tile<T, K_TILE>(use, x, next_tile, col_tile, n_cols, ld, k0);
      }
      cp_async_wait_all();
      __syncthreads();
      tile = next_tile;
    }
  }

  if (valid) {
    // rows is (S, C): the flat index of (s, lane) is t itself
    T* yr = y + static_cast<int64_t>(__ldg(rows + t)) * ld + k0;
#pragma unroll
    for (int kk = 0; kk < K_TILE; ++kk) yr[kk] = acc[kk];
  }
}

template <typename T, int K_TILE>
cudaError_t launch_tile(const void* cols, const void* vals, const void* rows, const void* x,
                        void* y, int64_t n_lanes, int64_t width, int64_t c, int64_t ld,
                        int64_t n_cols, int col_tile, int block_rows, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(col_tile) * K_TILE * sizeof(T);
  if (smem > static_cast<size_t>(INT_MAX)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(spmm_sell_stream_kernel<T, K_TILE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: a later launch must not report it
    return err;
  }
  const dim3 block(static_cast<unsigned>((block_rows + 31) / 32 * 32));
  const dim3 grid(static_cast<unsigned>((n_lanes + block_rows - 1) / block_rows),
                  static_cast<unsigned>(ld / K_TILE));
  spmm_sell_stream_kernel<T, K_TILE><<<grid, block, smem, stream>>>(
      static_cast<const int32_t*>(cols), static_cast<const T*>(vals),
      static_cast<const int32_t*>(rows), static_cast<const T*>(x), static_cast<T*>(y),
      n_lanes, width, c, ld, n_cols, col_tile, block_rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* cols, const void* vals, const void* rows, const void* x,
                         void* y, int64_t n_lanes, int64_t width, int64_t c, int64_t ld,
                         int64_t n_cols, int k_tile, int col_tile, int block_rows,
                         cudaStream_t stream) {
  switch (k_tile) {
#define REPRO_STREAM_CASE(K)                                                              \
  case K:                                                                                 \
    return launch_tile<T, K>(cols, vals, rows, x, y, n_lanes, width, c, ld, n_cols,       \
                             col_tile, block_rows, stream);
    REPRO_STREAM_CASE(1)
    REPRO_STREAM_CASE(2)
    REPRO_STREAM_CASE(4)
    REPRO_STREAM_CASE(8)
    REPRO_STREAM_CASE(16)
    REPRO_STREAM_CASE(32)
#undef REPRO_STREAM_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One bucket: cols/vals (n_slices, width, c), rows (n_slices, c), x (n_cols,
// ld) 16-byte aligned, y (n_rows + 1, ld); ld is a multiple of k_tile; a
// block holds block_rows (1 .. 256) consecutive rows and stages two
// (col_tile, k_tile) X tiles.  is_double selects float64 (1) or float32
// (0).  The caller makes the stream's device current.  Returns the
// cudaError_t of the attribute request or the launch (0 on success).
int repro_spmm_sell_stream_bucket(const void* cols, const void* vals, const void* rows,
                                  const void* x, void* y, int64_t n_slices, int64_t width,
                                  int64_t c, int64_t ld, int64_t n_cols, int k_tile,
                                  int col_tile, int block_rows, int is_double, void* stream) {
  if (n_slices <= 0 || width <= 0 || c <= 0 || ld <= 0 || k_tile <= 0 || ld % k_tile != 0 ||
      ld / k_tile > 65535 || n_cols < 0 || n_cols > INT_MAX || col_tile <= 0 ||
      block_rows <= 0 || block_rows > kMaxThreads ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t n_lanes = n_slices * c;
  const cudaError_t err =
      is_double ? launch_typed<double>(cols, vals, rows, x, y, n_lanes, width, c, ld, n_cols,
                                       k_tile, col_tile, block_rows, s)
                : launch_typed<float>(cols, vals, rows, x, y, n_lanes, width, c, ld, n_cols,
                                      k_tile, col_tile, block_rows, s);
  return static_cast<int>(err);
}

const char* repro_stream_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
