// SELL-C-sigma multi-RHS SpMM for Hopper (sm_90a), streaming schedule:
// Y = A @ X, one width bucket per launch, the rows of X that each block's
// rows touch staged through shared memory.
//
// Replaces the TPU kernel repro/kernels/sell_core.py::_spmm_stream_kernel
// (launched by _spmm_bucket_stream / spmm_sell_stream).  It computes the
// function of kernel B1 (spmm_sell.cu); what differs is the schedule: X
// reaches a block's rows through shared memory, each staged row reused by
// every row of the block that names it, and each row's sums stay in
// registers across the whole walk and are written once, through the same
// fused row scatter as B1.
//
// What bounds it on the card: device-memory bytes.  The function's least
// bytes are B1's, 12 * nnz + 4 * n_rows + 8 * k * (n_x + n_rows) at fp64,
// n_x the distinct stored columns.  The schedule adds its own: every block
// stages each distinct column its rows name once per k tile, so X traffic
// is (sum over blocks of their distinct columns) x K_TILE x sizeof(T) per k
// tile, plus 4 B a listed column and 4 B a lane for the map below.
//
// Design:
//   * the TPU cell keeps a (row_tile, C, k_tile) accumulator in VMEM across
//     a serial walk of column tiles of X; the Hopper form keeps the purpose
//     (X through fast memory, reused across rows) but stages only what the
//     block reads.  The host builds, per block of `block_rows` consecutive
//     lanes, the block's distinct stored columns in ascending order
//     (block_ptr / block_cols) and rewrites each entry as its index into
//     that list (lcols, PAD kept as -1): repro_torch/sparse/formats.py::
//     stream_column_map, cached per operand by the wrapper's caller;
//   * one thread owns one (slice, lane) row and keeps K_TILE sums in
//     registers; a loop inside the block walks the list in chunks of
//     `chunk_rows` entries, each chunk's X rows gathered into shared memory
//     by cp.async (16 B pieces where a row allows, else the row), two
//     buffers so that the next chunk is fetched while the current one is
//     consumed.  Every chunk holds a column some row names, so while the
//     walk ascends the chunk fetched ahead is always used;
//   * the next chunk is the one holding the block-wide minimum of the
//     threads' next local index (warp __reduce_min_sync, then shared
//     memory); each row's walk ends at its lane_end (no trailing PAD is
//     read) and reads its slab entries kBatch at a time with independent
//     loads, so a long row is one memory round trip per kBatch entries,
//     not per entry;
//   * each thread performs B1's multiply-adds (fma) in the order of B1's
//     one-thread-a-row body (w ascending, PAD skipped), on the same X
//     values, so on every bucket B1 does not split across threads the
//     result is bit-equal to B1's whatever the order of a row's columns (on
//     a split bucket the two agree to rounding): a list ascends, so local
//     order is column order, and a thread whose next entry lies in an
//     earlier chunk waits until the block-wide minimum steps back to it;
//   * above 48 KB the dynamic shared-memory limit is raised with
//     cudaFuncSetAttribute, and a refused request or launch is returned as
//     its cudaError_t (and cleared), never silent.
//
// The host wrapper is repro_torch/kernels/sell_core.py::spmm_sell_stream; it
// allocates Y ((n_rows + 1, k_pad), uninitialised: every real row is one
// lane's and each lane writes its k tile), pads k once to the K_TILE
// multiple, validates device, dtype, shape, contiguity and alignment, and
// raises on a non-zero return code.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kPad = -1;
constexpr int kEnd = INT_MAX;      // a thread's next local index once its row is done
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kBatch = 8;          // slab entries a thread loads at once

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

// Start copying the X rows list[j0 .. j0 + n) (their k tile) into buf,
// (n, K_TILE) row-major, in pieces of up to 16 bytes.
template <typename T, int K_TILE>
__device__ __forceinline__ void load_chunk(T* buf, const T* __restrict__ x,
                                           const int32_t* __restrict__ list, int j0, int n,
                                           int64_t ld, int64_t k0) {
  constexpr int kRowBytes = K_TILE * static_cast<int>(sizeof(T));
  constexpr int kPiece = kRowBytes < 16 ? kRowBytes : 16;
  constexpr int kPerRow = kRowBytes / kPiece;
  constexpr int kElems = kPiece / static_cast<int>(sizeof(T));
  const int total = n * kPerRow;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / kPerRow;
    const int q = i - r * kPerRow;
    const int64_t col = __ldg(list + j0 + r);
    cp_async<kPiece>(buf + r * K_TILE + q * kElems, x + col * ld + k0 + q * kElems);
  }
  cp_async_commit();
}

// Consume the row's entries in w order while their local index lies in
// [lo, hi), adding vals * buf[local - lo] to acc; PAD entries are skipped.
// Entries are read kBatch at a time with independent loads.  Returns the
// first local index outside [lo, hi) (e is left on its entry), kEnd at the
// row's end.  With lo == hi it consumes nothing and peeks at the next one.
template <typename T, int K_TILE>
__device__ __forceinline__ int walk(const int32_t* __restrict__ lcols,
                                    const T* __restrict__ vals, int64_t& e, int64_t e_end,
                                    int64_t c, int lo, int hi, const T* buf,
                                    T (&acc)[K_TILE]) {
  for (;;) {
    int l[kBatch];
    T v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int64_t ei = e + i * c;
      l[i] = ei < e_end ? __ldg(lcols + ei) : kEnd;
      v[i] = ei < e_end ? __ldg(vals + ei) : T(0);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (l[i] != kPad) {
        if (l[i] < lo || l[i] >= hi) return l[i];
        const T* xr = buf + static_cast<int64_t>(l[i] - lo) * K_TILE;
#pragma unroll
        for (int kk = 0; kk < K_TILE; ++kk) acc[kk] = mac(v[i], xr[kk], acc[kk]);
      }
      e += c;
    }
  }
}

// Minimum of v over the block (blockDim.x a multiple of 32, every thread
// calls it).  Its barriers also mean every thread is done with the chunk it
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
    spmm_sell_stream_kernel(const int32_t* __restrict__ lcols, const T* __restrict__ vals,
                            const int32_t* __restrict__ rows,
                            const int32_t* __restrict__ lane_end,
                            const int64_t* __restrict__ block_ptr,
                            const int32_t* __restrict__ block_cols,
                            const T* __restrict__ x, T* __restrict__ y,
                            int64_t n_lanes,  // S * C
                            int64_t width,    // W of the bucket
                            int64_t c,        // slice height C
                            int64_t ld,       // row stride of X and Y
                            int chunk_rows, int block_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_min[kMaxWarps];
  T* use = reinterpret_cast<T*>(smem_raw);
  T* spare = use + static_cast<int64_t>(chunk_rows) * K_TILE;

  const int64_t t = static_cast<int64_t>(blockIdx.x) * block_rows + threadIdx.x;
  const bool valid = static_cast<int>(threadIdx.x) < block_rows && t < n_lanes;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * K_TILE;
  const int64_t j_lo = block_ptr[blockIdx.x];
  const int n_list = static_cast<int>(block_ptr[blockIdx.x + 1] - j_lo);
  const int32_t* list = block_cols + j_lo;

  T acc[K_TILE];
#pragma unroll
  for (int kk = 0; kk < K_TILE; ++kk) acc[kk] = T(0);

  // the row cursor: element (s, w, lane) of a (S, W, C) slab lives at
  // (s * W + w) * C + lane, so the next entry is C further on
  int64_t e = 0, e_end = 0;
  int nc = kEnd;
  if (valid) {
    const int64_t s = t / c;
    e = s * width * c + (t - s * c);
    e_end = e + static_cast<int64_t>(__ldg(lane_end + t)) * c;
    nc = walk<T, K_TILE>(lcols, vals, e, e_end, c, 0, 0, use, acc);
  }

  const int n_chunks = (n_list + chunk_rows - 1) / chunk_rows;
  const int first = block_min(nc, s_min);
  if (first != kEnd) {
    int chunk = first / chunk_rows;
    load_chunk<T, K_TILE>(use, x, list, chunk * chunk_rows,
                          min(chunk_rows, n_list - chunk * chunk_rows), ld, k0);
    cp_async_wait_all();
    __syncthreads();
    bool adjacent = true;  // the block walks adjacent chunks: fetch ahead
    for (;;) {
      const bool fetched = adjacent && chunk + 1 < n_chunks;
      const int lo = chunk * chunk_rows;
      if (fetched)
        load_chunk<T, K_TILE>(spare, x, list, lo + chunk_rows,
                              min(chunk_rows, n_list - lo - chunk_rows), ld, k0);
      // a row whose columns do not ascend may step back below lo: it waits
      // there until the block-wide minimum returns to that chunk
      if (nc >= lo && nc < lo + chunk_rows)
        nc = walk<T, K_TILE>(lcols, vals, e, e_end, c, lo, lo + chunk_rows, use, acc);
      const int next = block_min(nc, s_min);
      if (next == kEnd) {
        cp_async_wait_all();  // no copy may land after the block is gone
        break;
      }
      const int next_chunk = next / chunk_rows;
      adjacent = next_chunk == chunk + 1;
      if (adjacent && fetched) {
        T* done = use;
        use = spare;
        spare = done;
      } else {
        // `use` is free: block_min's barrier came after its last read
        load_chunk<T, K_TILE>(use, x, list, next_chunk * chunk_rows,
                              min(chunk_rows, n_list - next_chunk * chunk_rows), ld, k0);
      }
      cp_async_wait_all();
      __syncthreads();
      chunk = next_chunk;
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
cudaError_t launch_tile(const void* lcols, const void* vals, const void* rows,
                        const void* lane_end, const void* block_ptr, const void* block_cols,
                        const void* x, void* y, int64_t n_lanes, int64_t width, int64_t c,
                        int64_t ld, int chunk_rows, int block_rows, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(chunk_rows) * K_TILE * sizeof(T);
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
      static_cast<const int32_t*>(lcols), static_cast<const T*>(vals),
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(lane_end),
      static_cast<const int64_t*>(block_ptr), static_cast<const int32_t*>(block_cols),
      static_cast<const T*>(x), static_cast<T*>(y), n_lanes, width, c, ld, chunk_rows,
      block_rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* lcols, const void* vals, const void* rows,
                         const void* lane_end, const void* block_ptr, const void* block_cols,
                         const void* x, void* y, int64_t n_lanes, int64_t width, int64_t c,
                         int64_t ld, int k_tile, int chunk_rows, int block_rows,
                         cudaStream_t stream) {
  switch (k_tile) {
#define REPRO_STREAM_CASE(K)                                                              \
  case K:                                                                                 \
    return launch_tile<T, K>(lcols, vals, rows, lane_end, block_ptr, block_cols, x, y,    \
                             n_lanes, width, c, ld, chunk_rows, block_rows, stream);
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

// One bucket: lcols/vals (n_slices, width, c), rows and lane_end (n_slices,
// c), block_ptr (n_blocks + 1) int64 and block_cols int32 (the column map,
// n_blocks = ceil(n_slices * c / block_rows)), x (n_cols, ld) 16-byte
// aligned, y (n_rows + 1, ld); ld is a multiple of k_tile; a block holds
// block_rows (1 .. 256) consecutive rows and stages two chunks of
// chunk_rows X rows of k_tile columns.  is_double selects float64 (1) or
// float32 (0).  The caller makes the stream's device current.  Returns the
// cudaError_t of the attribute request or the launch (0 on success).
int repro_spmm_sell_stream_bucket(const void* lcols, const void* vals, const void* rows,
                                  const void* lane_end, const void* block_ptr,
                                  const void* block_cols, const void* x, void* y,
                                  int64_t n_slices, int64_t width, int64_t c, int64_t ld,
                                  int k_tile, int chunk_rows, int block_rows, int is_double,
                                  void* stream) {
  if (n_slices <= 0 || width <= 0 || c <= 0 || ld <= 0 || k_tile <= 0 || ld % k_tile != 0 ||
      ld / k_tile > 65535 || chunk_rows <= 0 || block_rows <= 0 ||
      block_rows > kMaxThreads || reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t n_lanes = n_slices * c;
  const cudaError_t err =
      is_double ? launch_typed<double>(lcols, vals, rows, lane_end, block_ptr, block_cols, x,
                                       y, n_lanes, width, c, ld, k_tile, chunk_rows,
                                       block_rows, s)
                : launch_typed<float>(lcols, vals, rows, lane_end, block_ptr, block_cols, x, y,
                                      n_lanes, width, c, ld, k_tile, chunk_rows, block_rows,
                                      s);
  return static_cast<int>(err);
}

const char* repro_stream_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
