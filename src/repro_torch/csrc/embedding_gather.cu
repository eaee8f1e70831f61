// Embedding gather for Hopper (sm_90a): out[i] = table[ids[i]].
//
// Replaces the TPU kernel repro/kernels/gather.py::_gather_kernel (launched
// by embedding_gather): ids (T,) int32 or int64, table (V, d), out (T, d).
// The TPU kernel gathers vl rows a grid step from a VMEM-resident table;
// here the table stays in device memory and each row is one contiguous copy.
//
// What bounds it on the card: device-memory bytes, 2 * T * d * itemsize +
// T * sizeof(id) (each gathered row read once and written once, each id
// read once).  It does no arithmetic.
//
// Design:
//   * grid (T, chunks): block (row, c) copies bytes [c * 64 * threads,
//     (c + 1) * 64 * threads) of row ids[row], masked at the row's end.  The
//     host (repro_torch/core/autotune.py::gather_grid) cuts a row into as
//     few chunks as 256 threads allow and, while T rows give fewer than two
//     blocks an SM, into more, down to a warp a chunk: d = 2560 fp32 is one
//     160-thread block a row (T = 512: 512 blocks on 132 SMs), and T = 4 is
//     twenty one-warp blocks;
//   * loads in flight: each thread copies 64 bytes, four 16 B vectors (or
//     eight 8 B, sixteen 4 B where a row or a pointer allows no wider
//     vector), all loaded before any is stored; lane t of a warp takes
//     vector t + 32 k, so every load and store of a warp is 512 contiguous
//     bytes (16 B vectors).  The copy is of bytes, so one kernel serves
//     float32 and float64;
//   * ids are read as they come, int32 or int64 (a template on the id type),
//     so the engine's int64 argmax ids need no conversion kernel: one
//     launch a call.
//   * every id is bounded here, as the reference's indexing bounds it: a
//     negative id wraps by V once, then the row is clamped to [0, V - 1]
//     (an int64 id is bounded as it is, without narrowing it to int32).
//     So no id already on the card reads outside the table, and the
//     bound needs no host read (a captured decode step allows none).  The
//     host preflight (repro_torch/analysis/preflight.py::
//     plan_embedding_gather) still refuses host ids outside [0, V).
//
// The host wrapper is repro_torch/kernels/gather.py::embedding_gather; it
// plans the launch (once per shape for ids already on the card), allocates
// the output and raises on a non-zero return code.
//
// The backward, gather_bwd_kernel: dtable[v] = sum of dout[i] over the i
// with ids[i] = v (ids bounded as above), dense (V, d) as XLA's scatter into
// zeros is.  It replaces no TPU kernel (the reference differentiates XLA's
// gather, repro/models/model.py::_embed); it keeps plain PyTorch off the
// card's training path.  Deterministic, with no atomics: the wrapper
// (gather.py::embedding_gather_bwd) stable-sorts the bounded ids on the card
// first, a preparation step as the SELL pack is, so equal ids form a run in
// ascending position.  Grid (V, chunks): block (v, c) finds v's run by
// binary search in the sorted ids and sums its rows of dout, chunk c of the
// row, in ascending position, each thread 64 bytes of the row (a zero row
// where v has no id).  Bound: bytes, V * d + T * d values and the ids and
// their order (8 B each), 0.155 ms at mamba2's V = 50,280, d = 2560, T =
// 1024 in fp32 on an H100's 3.35 TB/s.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// Bytes one thread copies (autotune.py GATHER_THREAD_BYTES).
constexpr int kThreadBytes = 64;
// Most threads a block (autotune.py GATHER_MAX_THREADS).
constexpr int kMaxThreads = 256;

template <typename V, typename Id>
__global__ void __launch_bounds__(kMaxThreads)
gather_rows_kernel(const Id* __restrict__ ids, const V* __restrict__ table,
                   V* __restrict__ out, int64_t row_vecs, int64_t n_rows) {
  constexpr int LOADS = kThreadBytes / sizeof(V);
  const int64_t r = blockIdx.x;
  const int64_t begin = static_cast<int64_t>(blockIdx.y) * LOADS * blockDim.x;
  int64_t id = static_cast<int64_t>(__ldg(ids + r));
  if (id < 0) id += n_rows;
  id = id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
  const V* src = table + id * row_vecs;
  V* dst = out + r * row_vecs;
  V buf[LOADS];
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    const int64_t i = begin + threadIdx.x + k * blockDim.x;
    if (i < row_vecs) buf[k] = __ldg(src + i);
  }
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    const int64_t i = begin + threadIdx.x + k * blockDim.x;
    if (i < row_vecs) dst[i] = buf[k];
  }
}

// Block (v, chunk): dtable[v][chunk] = sum over the run of v in `sorted`
// (ids ascending, `order` their positions, ascending within a run) of
// dout[order[k]][chunk], in ascending k; zero where v has no run.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gather_bwd_kernel(const long long* __restrict__ sorted, const long long* __restrict__ order,
                  const T* __restrict__ dout, T* __restrict__ dtable, int64_t n_ids,
                  int64_t d) {
  constexpr int PER = kThreadBytes / sizeof(T);
  __shared__ int64_t run[2];
  const int64_t v = blockIdx.x;
  if (threadIdx.x < 2) {
    const int64_t want = v + threadIdx.x;    // lower bounds of v and v + 1
    int64_t lo = 0, hi = n_ids;
    while (lo < hi) {
      const int64_t mid = (lo + hi) / 2;
      if (sorted[mid] < want) lo = mid + 1; else hi = mid;
    }
    run[threadIdx.x] = lo;
  }
  __syncthreads();
  const int64_t begin = static_cast<int64_t>(blockIdx.y) * PER * blockDim.x;
  T acc[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) acc[k] = T(0);
  for (int64_t r = run[0]; r < run[1]; ++r) {
    const T* src = dout + order[r] * d;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int64_t i = begin + threadIdx.x + k * blockDim.x;
      if (i < d) acc[k] += src[i];
    }
  }
  T* dst = dtable + v * d;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int64_t i = begin + threadIdx.x + k * blockDim.x;
    if (i < d) dst[i] = acc[k];
  }
}

template <typename V, typename Id>
cudaError_t launch(const void* table, int64_t n_rows, const void* ids, void* out,
                   int64_t n_ids, int64_t row_bytes, int chunks, int threads,
                   cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(n_ids), static_cast<unsigned>(chunks));
  gather_rows_kernel<V, Id><<<grid, threads, 0, stream>>>(
      static_cast<const Id*>(ids), static_cast<const V*>(table),
      static_cast<V*>(out), row_bytes / static_cast<int64_t>(sizeof(V)), n_rows);
  return cudaGetLastError();
}

template <typename Id>
cudaError_t launch_id(const void* table, int64_t n_rows, const void* ids, void* out,
                      int64_t n_ids, int64_t row_bytes, int chunks, int threads,
                      cudaStream_t st) {
  auto aligned = [&](uintptr_t v) {
    return row_bytes % v == 0 && reinterpret_cast<uintptr_t>(table) % v == 0 &&
           reinterpret_cast<uintptr_t>(out) % v == 0;
  };
  if (aligned(16))
    return launch<uint4, Id>(table, n_rows, ids, out, n_ids, row_bytes, chunks, threads, st);
  if (aligned(8))
    return launch<uint2, Id>(table, n_rows, ids, out, n_ids, row_bytes, chunks, threads, st);
  return launch<unsigned, Id>(table, n_rows, ids, out, n_ids, row_bytes, chunks, threads, st);
}

}  // namespace

extern "C" {

// table (n_rows = V, d) and out (n_ids, d) of one element type, row_bytes =
// d times its size (a multiple of 4); ids (n_ids,) of id_bytes (4: int32,
// 8: int64), any values: each is bounded to a row as above.  Grid (n_ids, chunks) of `threads` (a multiple of 32, at most
// 256), each block copying 64 * threads bytes of its row: the chunks must
// cover the row and none may start past its end.  The caller makes the
// stream's device current.  Returns the launch's cudaError_t.
int repro_embedding_gather(const void* table, int64_t n_rows, const void* ids,
                           void* out, int64_t n_ids, int64_t row_bytes,
                           int id_bytes, int chunks, int threads, void* stream) {
  const int64_t chunk_bytes = static_cast<int64_t>(kThreadBytes) * threads;
  if (n_rows <= 0 || n_ids <= 0 || n_ids > 2147483647 || row_bytes <= 0 ||
      row_bytes % 4 != 0 ||
      (id_bytes != 4 && id_bytes != 8) || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || chunks < 1 || chunks > 65535 ||
      chunks * chunk_bytes < row_bytes || (chunks - 1) * chunk_bytes >= row_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      id_bytes == 8
          ? launch_id<long long>(table, n_rows, ids, out, n_ids, row_bytes, chunks, threads,
                                 st)
          : launch_id<int>(table, n_rows, ids, out, n_ids, row_bytes, chunks, threads, st);
  return static_cast<int>(err);
}

// The backward.  sorted (n_ids,) int64: the bounded ids in ascending order;
// order (n_ids,) int64: their positions, ascending within equal ids; dout
// (n_ids, d) and dtable (n_rows, d) of one element type (float64 when
// is_double).  Grid (n_rows, chunks) of `threads` (a multiple of 32, at most
// 256), each thread 64 bytes of a row: the chunks must cover the row and
// none may start past its end.  The caller makes the stream's device
// current.  Returns the launch's cudaError_t.
int repro_embedding_gather_bwd(const void* sorted, const void* order, const void* dout,
                               void* dtable, int64_t n_rows, int64_t n_ids, int64_t d,
                               int is_double, int chunks, int threads, void* stream) {
  const int64_t chunk_elems =
      static_cast<int64_t>(kThreadBytes / (is_double ? 8 : 4)) * threads;
  if (n_rows <= 0 || n_rows > 2147483647 || n_ids <= 0 || d <= 0 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || chunks < 1 || chunks > 65535 ||
      chunks * chunk_elems < d || (chunks - 1) * chunk_elems >= d) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_rows), static_cast<unsigned>(chunks));
  auto ids = static_cast<const long long*>(sorted);
  auto pos = static_cast<const long long*>(order);
  if (is_double) {
    gather_bwd_kernel<double><<<grid, threads, 0, st>>>(
        ids, pos, static_cast<const double*>(dout), static_cast<double*>(dtable), n_ids, d);
  } else {
    gather_bwd_kernel<float><<<grid, threads, 0, st>>>(
        ids, pos, static_cast<const float*>(dout), static_cast<float*>(dtable), n_ids, d);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* repro_gather_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
