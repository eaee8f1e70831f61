// Embedding gather for Hopper (sm_90a): out[i] = table[ids[i]].
//
// Replaces the TPU kernel repro/kernels/gather.py::_gather_kernel (launched
// by embedding_gather): ids (T,) int32, table (V, d), out (T, d).  The
// TPU kernel gathers vl rows a grid step from a VMEM-resident table; here
// the table stays in device memory and each row is one contiguous copy.
//
// What bounds it on the card: device-memory bytes, 2 * T * d * itemsize +
// 4 * T (each gathered row read once and written once, each id read once).
// It does no arithmetic.
//
// Design: one warp a row, threads / 32 rows a block; a warp copies its row
// with 16-byte vector loads and stores where the row length and both
// pointers allow (d = 2560 fp32: 640 uint4 a row, 20 a lane), else 8 or 4
// bytes.  The copy is of bytes, so one kernel serves float32 and float64.
// Ids are not range-checked here: CUDA does not clamp an out-of-range
// gather the way JAX does, so the host preflight
// (repro_torch/analysis/preflight.py::plan_embedding_gather) refuses ids
// outside [0, V) wherever they come from the host; ids made on the card
// (a decode step's argmax over V) are in range by construction.
//
// The host wrapper is repro_torch/kernels/gather.py::embedding_gather; it
// converts the ids to int32, allocates the output and raises on a non-zero
// return code.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <typename V>
__global__ void gather_rows_kernel(const int* __restrict__ ids,
                                   const V* __restrict__ table,
                                   V* __restrict__ out, int64_t n_ids,
                                   int64_t row_vecs) {
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                    (threadIdx.x >> 5);
  if (r >= n_ids) return;
  const V* src = table + static_cast<int64_t>(__ldg(ids + r)) * row_vecs;
  V* dst = out + r * row_vecs;
  for (int64_t i = lane; i < row_vecs; i += 32) dst[i] = __ldg(src + i);
}

template <typename V>
cudaError_t launch(const void* table, const void* ids, void* out, int64_t n_ids,
                   int64_t row_bytes, int threads, cudaStream_t stream) {
  const int64_t rows_per_block = threads / 32;
  const dim3 grid(static_cast<unsigned>((n_ids + rows_per_block - 1) / rows_per_block));
  gather_rows_kernel<V><<<grid, threads, 0, stream>>>(
      static_cast<const int*>(ids), static_cast<const V*>(table),
      static_cast<V*>(out), n_ids, row_bytes / static_cast<int64_t>(sizeof(V)));
  return cudaGetLastError();
}

bool aligned(int64_t row_bytes, const void* a, const void* b, int64_t v) {
  return row_bytes % v == 0 && reinterpret_cast<uintptr_t>(a) % v == 0 &&
         reinterpret_cast<uintptr_t>(b) % v == 0;
}

}  // namespace

extern "C" {

// table (V, d) and out (n_ids, d) of one element type, row_bytes = d times
// its size (a multiple of 4); ids (n_ids,) int32 in [0, V).  threads a
// multiple of 32.  The caller makes the stream's device current.  Returns
// the launch's cudaError_t.
int repro_embedding_gather(const void* table, const void* ids, void* out,
                           int64_t n_ids, int64_t row_bytes, int threads,
                           void* stream) {
  if (n_ids <= 0 || row_bytes <= 0 || row_bytes % 4 != 0 || threads < 32 ||
      threads > 1024 || threads % 32 != 0 ||
      (n_ids + threads / 32 - 1) / (threads / 32) > 2147483647) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (aligned(row_bytes, table, out, 16)) {
    err = launch<uint4>(table, ids, out, n_ids, row_bytes, threads, st);
  } else if (aligned(row_bytes, table, out, 8)) {
    err = launch<uint2>(table, ids, out, n_ids, row_bytes, threads, st);
  } else {
    err = launch<unsigned>(table, ids, out, n_ids, row_bytes, threads, st);
  }
  return static_cast<int>(err);
}

const char* repro_gather_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
