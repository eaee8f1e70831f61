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
//     eight 8 B, sixteen 4 B, thirty-two 2 B where a row or a pointer
//     allows no wider vector: a bf16 row of odd d is 2 B aligned), all
//     loaded before any is stored; lane t of a warp takes vector t + 32 k,
//     so every load and store of a warp is 512 contiguous bytes (16 B
//     vectors).  The copy is of bytes, so one kernel serves float32,
//     float64 and bfloat16 (the reference returns a bf16 table's rows in
//     bf16, repro/kernels/gather.py:44, 52);
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
// The vocab-shard form (repro_embedding_gather_shard, the same kernel): a
// table sharded by rows over a mesh's model axis, each device holding rows
// [lo, lo + V_d).  Each id is bounded by the whole table's V first, then a
// row this shard does not hold gathers zeros, so the shards' outputs sum to
// the whole-table gather exactly.  (A bound by the shard's own rows would
// be wrong: an id past V must read row V - 1 from the last shard alone.)
// It moves T * d * itemsize bytes of zeros or rows out a shard and reads
// only its own rows; the whole table (lo = 0, V_d = V) is the special case
// the plain entry launches.  Host wrapper: gather.py::embedding_gather_shard.
//
// The host wrapper is repro_torch/kernels/gather.py::embedding_gather; it
// plans the launch (once per shape for ids already on the card), allocates
// the output and raises on a non-zero return code.
//
// The backward, gather_bwd_kernel: dtable[v] = the sum of dout[i] over the
// i with ids[i] = v (ids bounded as above), in ascending i, dense (V, d) as
// XLA's scatter into zeros is.  It replaces no TPU kernel (the reference
// differentiates XLA's gather, repro/models/model.py::_embed); it keeps
// plain PyTorch off the card's training path.
//
// What bounds it: bytes.  The (V, d) gradient is written once and each row
// of dout read once: (V d + T d) itemsize + T id bytes, 0.157 ms at
// mamba2's V = 50,280, d = 2560, T = 1024 fp32 on an H100's 3.35 TB/s.
// Almost all of it is the zero rows: at most T of V rows have an id.
//
// The element types (dout_type, table_type: 0 float32, 1 float64, 2
// bfloat16): dout and dtable of one type, or a bf16 table's gradient from
// float32 output gradients (the model's path where the table is stored in
// bf16 and the activations run in float32).  Sums run in float32 (float64
// for float64), whatever is stored: a bf16 dout is widened as it is loaded,
// a bf16 row's sum rounded once, to nearest even, as it is stored.  A sum
// that spans slices of ids (T > kSlice) carries through a float32 scratch
// (carry, (T, d): a row's partial at the position of its first id), not
// through the bf16 row, so that the row is rounded once.
//
// Design: one launch, no sort and no search (the form before it bound and
// stable-sorted the ids on the card in several small launches, then had
// each of V blocks search its run serially before its stores: 0.82 ms the
// launch alone, 0.99 through its wrapper).  Block s C + c (C chunks a
// row; a stripe's chunks neighbours in launch order, so a Zipf stream's
// frequent low ids start first) owns a stripe of table rows [s S, (s + 1)
// S) and column chunk c (a 16 B vector of every row a thread, or 8 / 4 B
// where the row or a pointer allows no wider):
//   1. warps 1.. zero-fill the stripe's chunk, vector stores at the memory
//      rate (the kernel's bulk), while
//   2. warp 0 reads the ids (from L2: every block reads all T) in slices of
//      kSlice, whose positions fit the block's shared memory (8 KB of packed
//      hits, 8 KB of their order), bounding each by the forward's rule and
//      compacting the slice's hits on the stripe in ascending position
//      (ballot and popc, 4 x 32 ids' loads in flight), counting them per
//      stripe row, and
//   3. places them by row with a stable counting sort (a warp scan of the
//      counts, __match_any_sync ranks in ascending position);
//   4. after a barrier (which orders the zeros before the sums, whichever
//      thread stored them) every thread sums the hits of the column it owns,
//      each hit row's rows of dout in ascending position, from zero (or
//      from the row's sum over the earlier slices, re-read by the thread
//      that wrote it), and stores the sum over the row's zeros.  The sorted
//      hits go in groups of kRowsInFlight across row boundaries: a group's
//      loads are in flight together, so a stripe of many rows with few hits
//      each costs a round trip a group, not one a row.
// Per column this is the plain version's order (kernels/gather.py::
// embedding_gather_bwd_ref), so the two are equal; no atomics.  A long run
// (a frequent token: ~200 of 1024 ids on token 0 in the Zipf stream) is
// spread over the row's column chunks, never into partial sums.  The host
// (repro_torch/core/autotune.py::gather_bwd_grid) picks S, the chunk and
// the vector width from V, d and T.  On an H100 at the train shape
// (scripts/ssd_launch_times.py gather) it runs ~0.20 ms against ~0.18 for
// torch.zeros of the table: the zero-fill is the bulk.  All T ids equal
// (one run summed by one stripe's blocks, serially a column) take ~0.22.
//
// The vocab-shard backward (repro_embedding_gather_shard_bwd, the same
// kernel): the (shard_rows, d) gradient of rows [lo, lo + shard_rows) of a
// vocab-row table, the shard a device of a mesh's model axis holds.  Each
// id is bounded by the whole vocab first, exactly as the forward bounds it
// (so an id past V lands on row V - 1, the last shard's alone), then an id
// outside the window is dropped at step 2's compaction, so the kernel
// writes only the owned rows.  A row's hits are summed in ascending
// position from zero as in the whole-table form, so the shards' gradients
// stacked in model order are the whole-table gradient, bit for bit.
// Bound: (shard_rows d + T d) itemsize + T id bytes (every block reads
// all of dout's hit rows at most once a column; the zeros are the bulk).
// Host wrapper: gather.py::embedding_gather_shard_bwd.

#include <cuda_bf16.h>
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
                   V* __restrict__ out, int64_t row_vecs, int64_t vocab, int64_t lo,
                   int64_t shard_rows) {
  constexpr int LOADS = kThreadBytes / sizeof(V);
  const int64_t r = blockIdx.x;
  const int64_t begin = static_cast<int64_t>(blockIdx.y) * LOADS * blockDim.x;
  int64_t id = static_cast<int64_t>(__ldg(ids + r));
  if (id < 0) id += vocab;
  id = (id < 0 ? 0 : (id >= vocab ? vocab - 1 : id)) - lo;
  V* dst = out + r * row_vecs;
  if (id < 0 || id >= shard_rows) {          // another shard owns the row
    const V zero{};
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const int64_t i = begin + threadIdx.x + k * blockDim.x;
      if (i < row_vecs) dst[i] = zero;
    }
    return;
  }
  const V* src = table + id * row_vecs;
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

// Backward (autotune.py GATHER_BWD_SLICE, GATHER_BWD_MAX_STRIPE).
constexpr int kSlice = 2048;        // ids compacted and sorted at a time
constexpr int kMaxStripe = 256;     // table rows a block (a hit's row fits 8 bits)
constexpr int kRowsInFlight = 16;   // dout rows loaded before they are added
constexpr int kIdsInFlight = 4;     // rounds of 32 ids warp 0 loads at once

// N consecutive elements of one type: the vector a backward thread reads
// from dout or writes to dtable (4, 8 or 16 B, or one element).
template <typename E, int N>
struct alignas(sizeof(E) * N) Pack {
  E v[N];
};

// Sums of E run in Acc<E>: float for float32 and bfloat16, double for float64.
template <typename E> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void narrow(float v, float& out) { out = v; }
__device__ __forceinline__ void narrow(double v, double& out) { out = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16& out) { out = __float2bfloat16_rn(v); }

template <typename Id>
__device__ __forceinline__ int64_t bounded(const Id* ids, int64_t k, int64_t n_rows) {
  int64_t id = static_cast<int64_t>(__ldg(ids + k));
  if (id < 0) id += n_rows;
  return id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
}

// Block s * chunks + c: rows [s * stripe, (s + 1) * stripe) of dtable,
// vector c * blockDim.x + threadIdx.x of each (row_vecs vectors of N
// elements a row: N of D from dout, N of S to dtable); a stripe's chunks
// are neighbours in launch order, so the first stripes (the frequent ids of
// a Zipf stream) start first.  Warp 0 reads the ids while the other warps
// zero-fill the stripe; then every thread sums the hits of the column it
// owns, in A = AccOf<D>.
// Ids are bounded by `vocab` and shifted by `lo` (the shard's first row);
// rows outside [0, n_rows) after the shift are another shard's.  carry
// ((n_ids, d) of A, nullable): where S is narrower than A and T > kSlice,
// a row's partial sum between slices, at the position of its first id.
template <typename D, typename S, int N, typename Id>
__global__ void __launch_bounds__(kMaxThreads)
gather_bwd_kernel(const Id* __restrict__ ids, const D* __restrict__ dout,
                  S* __restrict__ dtable, typename AccOf<D>::type* __restrict__ carry,
                  int64_t n_rows, int64_t vocab, int64_t lo, int n_ids, int64_t row_vecs,
                  int stripe, int chunks) {
  using A = typename AccOf<D>::type;
  using VD = Pack<D, N>;
  using VS = Pack<S, N>;
  constexpr bool kExact = sizeof(S) == sizeof(A);   // dtable holds the sums as they are
  __shared__ int hits[kSlice];              // (stripe row << 16) | slice position
  __shared__ int order[kSlice];             // the hits by row, ascending position within
  __shared__ int cnt[kMaxStripe];           // hits of each row in this slice
  __shared__ int start[kMaxStripe + 1];     // their offsets in order[]
  __shared__ int placed[kMaxStripe];        // hits of each row placed so far
  __shared__ int first[kMaxStripe];         // position of a summed row's first id
  __shared__ unsigned char done[kMaxStripe];  // an earlier slice summed into it
  __shared__ int n_hits;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x / chunks) * stripe;
  const int rows = static_cast<int>(min(static_cast<int64_t>(stripe), n_rows - r0));
  const int64_t c0 = static_cast<int64_t>(blockIdx.x % chunks) * blockDim.x;
  const int vecs = static_cast<int>(min(static_cast<int64_t>(blockDim.x), row_vecs - c0));
  VS* dst = reinterpret_cast<VS*>(dtable) + r0 * row_vecs + c0;   // this block's corner

  // 1. the zeros: every vector of the stripe's chunk, by warps 1.. (by the
  // one warp first where the block is one warp), while warp 0 reads ids
  if (warp > 0 || blockDim.x == 32) {
    const int first_w = blockDim.x == 32 ? 0 : 32, workers = blockDim.x - first_w;
    const VS z{};
    for (int e = tid - first_w; e < rows * vecs; e += workers)
      dst[static_cast<int64_t>(e / vecs) * row_vecs + e % vecs] = z;
  }
  if (warp == 0)
    for (int r = lane; r < rows; r += 32) done[r] = 0;
  for (int s0 = 0; s0 < n_ids; s0 += kSlice) {
    const int len = min(kSlice, n_ids - s0);
    if (warp == 0) {
      // 2. the slice's hits on the stripe, in ascending position
      // (kIdsInFlight rounds of 32 ids loaded at once), counted per row
      for (int r = lane; r < rows; r += 32) cnt[r] = 0;
      __syncwarp();
      int nh = 0;
      for (int k0 = 0; k0 < len; k0 += 32 * kIdsInFlight) {
        int64_t rr[kIdsInFlight];
#pragma unroll
        for (int u = 0; u < kIdsInFlight; ++u) {
          const int k = k0 + 32 * u + lane;
          rr[u] = k < len ? bounded(ids, s0 + k, vocab) - lo - r0 : -1;
        }
#pragma unroll
        for (int u = 0; u < kIdsInFlight; ++u) {
          const bool in = rr[u] >= 0 && rr[u] < rows;
          const unsigned ball = __ballot_sync(0xffffffffu, in);
          if (in) {
            const int r = static_cast<int>(rr[u]);
            hits[nh + __popc(ball & ((1u << lane) - 1u))] = (r << 16) | (k0 + 32 * u + lane);
            atomicAdd(&cnt[r], 1);           // an integer count: order-free
          }
          nh += __popc(ball);
        }
      }
      __syncwarp();
      // exclusive offsets of the rows' hits (a warp scan, 32 rows a step)
      int carry_n = 0;
      for (int c = 0; c < rows; c += 32) {
        const int v = c + lane < rows ? cnt[c + lane] : 0;
        int inc = v;
#pragma unroll
        for (int dd = 1; dd < 32; dd <<= 1) {
          const int u = __shfl_up_sync(0xffffffffu, inc, dd);
          if (lane >= dd) inc += u;
        }
        if (c + lane < rows) { start[c + lane] = carry_n + inc - v; placed[c + lane] = 0; }
        carry_n += __shfl_sync(0xffffffffu, inc, 31);
      }
      if (lane == 0) { start[rows] = carry_n; n_hits = nh; }
      __syncwarp();
      // 3. stable placement by row, in ascending position: a hit's rank
      // among the equal rows of its 32 goes after those placed before
      for (int i0 = 0; i0 < nh; i0 += 32) {
        const int i = i0 + lane;
        const int h = i < nh ? hits[i] : -1;
        const int key = h < 0 ? -1 : h >> 16;
        const unsigned same = __match_any_sync(0xffffffffu, key);
        if (key >= 0) order[start[key] + placed[key] + __popc(same & ((1u << lane) - 1u))] = h;
        __syncwarp();
        if (key >= 0 && lane == __ffs(same) - 1) placed[key] += __popc(same);
        __syncwarp();
      }
    }
    __syncthreads();                         // the zeros stored, the slice sorted
    const int nh = n_hits;
    if (nh > 0 && tid < vecs) {
      // 4. the sorted hits in groups of kRowsInFlight, across row
      // boundaries: a group's loads are all in flight before its adds,
      // which run in order, a row's sum stored when the next row begins
      const VD* src = reinterpret_cast<const VD*>(dout) + static_cast<int64_t>(s0) * row_vecs +
                      c0 + tid;
      VS* out = dst + tid;
      const bool carried = !kExact && carry != nullptr && s0 + kSlice < n_ids;
      // a row's partial between slices: at its first id's position (the
      // row's first hit in this slice where no earlier slice hit it)
      auto carry_at = [&](int r) {
        const int64_t pos = done[r] ? first[r] : s0 + (order[start[r]] & 0xffff);
        return carry + (pos * row_vecs + c0 + tid) * N;
      };
      auto flush = [&](int r, const A (&acc)[N]) {
        VS o;
#pragma unroll
        for (int e = 0; e < N; ++e) narrow(acc[e], o.v[e]);
        out[static_cast<int64_t>(r) * row_vecs] = o;
        if (carried) {
          A* c = carry_at(r);
#pragma unroll
          for (int e = 0; e < N; ++e) c[e] = acc[e];
        }
      };
      int cur = -1;
      A acc[N];
#pragma unroll
      for (int e = 0; e < N; ++e) acc[e] = A(0);
      for (int k0 = 0; k0 < nh; k0 += kRowsInFlight) {
        VD v[kRowsInFlight];
#pragma unroll
        for (int u = 0; u < kRowsInFlight; ++u)
          if (k0 + u < nh) v[u] = src[static_cast<int64_t>(order[k0 + u] & 0xffff) * row_vecs];
#pragma unroll
        for (int u = 0; u < kRowsInFlight; ++u) {
          if (k0 + u >= nh) break;
          const int r = order[k0 + u] >> 16;
          if (r != cur) {
            if (cur >= 0) flush(cur, acc);
            cur = r;
            // from zero, or from the row's sum over the earlier slices
            // (this thread's own store: the row itself where it holds the
            // sum exactly, else the carry)
            if (!done[r]) {
#pragma unroll
              for (int e = 0; e < N; ++e) acc[e] = A(0);
            } else if constexpr (kExact) {
              const VS o = out[static_cast<int64_t>(r) * row_vecs];
#pragma unroll
              for (int e = 0; e < N; ++e) acc[e] = widen(o.v[e]);
            } else {
              const A* c = carry_at(r);
#pragma unroll
              for (int e = 0; e < N; ++e) acc[e] = c[e];
            }
          }
#pragma unroll
          for (int e = 0; e < N; ++e) acc[e] += widen(v[u].v[e]);
        }
      }
      if (cur >= 0) flush(cur, acc);
    }
    __syncthreads();                         // the sums read start[], order[] and done[]
    if (warp == 0)
      for (int r = lane; r < rows; r += 32)
        if (start[r + 1] > start[r] && !done[r]) {
          first[r] = s0 + (order[start[r]] & 0xffff);
          done[r] = 1;
        }
  }
}

template <typename V, typename Id>
cudaError_t launch(const void* table, const void* ids, void* out, int64_t n_ids,
                   int64_t row_bytes, int64_t vocab, int64_t lo, int64_t shard_rows,
                   int chunks, int threads, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(n_ids), static_cast<unsigned>(chunks));
  gather_rows_kernel<V, Id><<<grid, threads, 0, stream>>>(
      static_cast<const Id*>(ids), static_cast<const V*>(table), static_cast<V*>(out),
      row_bytes / static_cast<int64_t>(sizeof(V)), vocab, lo, shard_rows);
  return cudaGetLastError();
}

template <typename Id>
cudaError_t launch_id(const void* table, const void* ids, void* out, int64_t n_ids,
                      int64_t row_bytes, int64_t vocab, int64_t lo, int64_t shard_rows,
                      int chunks, int threads, cudaStream_t st) {
  auto aligned = [&](uintptr_t v) {
    return row_bytes % v == 0 && reinterpret_cast<uintptr_t>(table) % v == 0 &&
           reinterpret_cast<uintptr_t>(out) % v == 0;
  };
  if (aligned(16))
    return launch<uint4, Id>(table, ids, out, n_ids, row_bytes, vocab, lo, shard_rows, chunks,
                             threads, st);
  if (aligned(8))
    return launch<uint2, Id>(table, ids, out, n_ids, row_bytes, vocab, lo, shard_rows, chunks,
                             threads, st);
  if (aligned(4))
    return launch<unsigned, Id>(table, ids, out, n_ids, row_bytes, vocab, lo, shard_rows,
                                chunks, threads, st);
  return launch<unsigned short, Id>(table, ids, out, n_ids, row_bytes, vocab, lo, shard_rows,
                                    chunks, threads, st);
}

// The checks and the launch of both forward entries: rows [lo, lo +
// shard_rows) of a vocab-row table, held in `table`.
int gather_entry(const void* table, int64_t vocab, int64_t lo, int64_t shard_rows,
                 const void* ids, void* out, int64_t n_ids, int64_t row_bytes, int id_bytes,
                 int chunks, int threads, void* stream) {
  const int64_t chunk_bytes = static_cast<int64_t>(kThreadBytes) * threads;
  if (vocab <= 0 || lo < 0 || shard_rows <= 0 || lo + shard_rows > vocab || n_ids <= 0 ||
      n_ids > 2147483647 || row_bytes <= 0 || row_bytes % 2 != 0 ||
      reinterpret_cast<uintptr_t>(table) % 2 != 0 || reinterpret_cast<uintptr_t>(out) % 2 != 0 ||
      (id_bytes != 4 && id_bytes != 8) || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || chunks < 1 || chunks > 65535 ||
      chunks * chunk_bytes < row_bytes || (chunks - 1) * chunk_bytes >= row_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      id_bytes == 8 ? launch_id<long long>(table, ids, out, n_ids, row_bytes, vocab, lo,
                                           shard_rows, chunks, threads, st)
                    : launch_id<int>(table, ids, out, n_ids, row_bytes, vocab, lo, shard_rows,
                                     chunks, threads, st);
  return static_cast<int>(err);
}

template <typename D, typename S, int N>
int launch_bwd(const void* ids, int id_bytes, const void* dout, void* dtable, void* carry,
               int64_t n_rows, int64_t vocab, int64_t lo, int n_ids, int64_t row_vecs, int stripe,
               int chunks, int threads, cudaStream_t st) {
  using A = typename AccOf<D>::type;
  const unsigned grid = static_cast<unsigned>(((n_rows + stripe - 1) / stripe) * chunks);
  if (id_bytes == 8) {
    gather_bwd_kernel<D, S, N, long long><<<grid, threads, 0, st>>>(
        static_cast<const long long*>(ids), static_cast<const D*>(dout), static_cast<S*>(dtable),
        static_cast<A*>(carry), n_rows, vocab, lo, n_ids, row_vecs, stripe, chunks);
  } else {
    gather_bwd_kernel<D, S, N, int><<<grid, threads, 0, st>>>(
        static_cast<const int*>(ids), static_cast<const D*>(dout), static_cast<S*>(dtable),
        static_cast<A*>(carry), n_rows, vocab, lo, n_ids, row_vecs, stripe, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch of one (dout, table) type pair, by the vector's element count.
template <typename D, typename S>
int launch_types(int n_elems, const void* ids, int id_bytes, const void* dout, void* dtable,
                 void* carry, int64_t n_rows, int64_t vocab, int64_t lo, int n_ids,
                 int64_t row_vecs, int stripe, int chunks, int threads, cudaStream_t st) {
  switch (n_elems) {
    case 1: return launch_bwd<D, S, 1>(ids, id_bytes, dout, dtable, carry, n_rows, vocab, lo,
                                       n_ids, row_vecs, stripe, chunks, threads, st);
    case 2: return launch_bwd<D, S, 2>(ids, id_bytes, dout, dtable, carry, n_rows, vocab, lo,
                                       n_ids, row_vecs, stripe, chunks, threads, st);
    case 4: return launch_bwd<D, S, 4>(ids, id_bytes, dout, dtable, carry, n_rows, vocab, lo,
                                       n_ids, row_vecs, stripe, chunks, threads, st);
    default:
      if constexpr (sizeof(D) == 2)
        return launch_bwd<D, S, 8>(ids, id_bytes, dout, dtable, carry, n_rows, vocab, lo,
                                   n_ids, row_vecs, stripe, chunks, threads, st);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Element-type codes of the backward entries.
enum DtypeCode : int { kFloat32 = 0, kFloat64 = 1, kBfloat16 = 2 };

int item_bytes(int code) {
  return code == kFloat32 ? 4 : code == kFloat64 ? 8 : code == kBfloat16 ? 2 : 0;
}

// The checks and the launch of both backward entries: the gradient of rows
// [lo, lo + n_rows) of a vocab-row table.  vec_bytes is dout's vector: N =
// vec_bytes / dout's element size elements, the same N of the table.
int bwd_entry(const void* ids, int id_bytes, const void* dout, void* dtable, void* carry,
              int64_t n_rows, int64_t lo, int64_t vocab, int64_t n_ids, int64_t d,
              int dout_type, int table_type, int vec_bytes, int stripe, int chunks,
              int threads, void* stream) {
  const int item = item_bytes(dout_type), titem = item_bytes(table_type);
  const int n_elems = item > 0 && vec_bytes % item == 0 ? vec_bytes / item : 0;
  const int64_t row_vecs = n_elems > 0 ? d / n_elems : 0;
  const int64_t n_stripes = stripe > 0 ? (n_rows + stripe - 1) / stripe : 0;
  auto misaligned = [&](const void* ptr, int64_t bytes) {
    return bytes <= 0 || reinterpret_cast<uintptr_t>(ptr) % static_cast<uintptr_t>(bytes) != 0;
  };
  const bool pair_ok = (item > 0 && dout_type == table_type) ||
                       (dout_type == kFloat32 && table_type == kBfloat16);
  const bool needs_carry = titem < item_bytes(dout_type == kFloat64 ? kFloat64 : kFloat32) &&
                           n_ids > kSlice;
  if (!pair_ok || n_rows <= 0 || lo < 0 || lo + n_rows > vocab || n_ids <= 0 ||
      n_ids > 2147483647 || d <= 0 || (id_bytes != 4 && id_bytes != 8) ||
      (n_elems != 1 && n_elems != 2 && n_elems != 4 && n_elems != 8) || vec_bytes > 16 ||
      d % n_elems != 0 || misaligned(dout, vec_bytes) ||
      misaligned(dtable, static_cast<int64_t>(n_elems) * titem) ||
      (needs_carry && misaligned(carry, 4)) ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || stripe < 1 ||
      stripe > kMaxStripe || chunks < 1 || n_stripes * chunks > 2147483647 ||
      static_cast<int64_t>(chunks) * threads < row_vecs ||
      static_cast<int64_t>(chunks - 1) * threads >= row_vecs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const int t = static_cast<int>(n_ids);
  void* c = needs_carry ? carry : nullptr;
  if (dout_type == kFloat64)
    return launch_types<double, double>(n_elems, ids, id_bytes, dout, dtable, c, n_rows, vocab,
                                        lo, t, row_vecs, stripe, chunks, threads, st);
  if (dout_type == kBfloat16)
    return launch_types<__nv_bfloat16, __nv_bfloat16>(n_elems, ids, id_bytes, dout, dtable, c,
                                                      n_rows, vocab, lo, t, row_vecs, stripe,
                                                      chunks, threads, st);
  if (table_type == kBfloat16)
    return launch_types<float, __nv_bfloat16>(n_elems, ids, id_bytes, dout, dtable, c, n_rows,
                                              vocab, lo, t, row_vecs, stripe, chunks, threads,
                                              st);
  return launch_types<float, float>(n_elems, ids, id_bytes, dout, dtable, c, n_rows, vocab, lo,
                                    t, row_vecs, stripe, chunks, threads, st);
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
  return gather_entry(table, n_rows, 0, n_rows, ids, out, n_ids, row_bytes, id_bytes, chunks,
                      threads, stream);
}

// The vocab-shard form: `table` holds rows [lo, lo + shard_rows) of a vocab-row
// table (0 <= lo, lo + shard_rows <= vocab).  Each id is bounded to a row of the
// whole table as above (by vocab, not by the shard); out[i] is that row where this
// shard holds it, else zeros.  Summed over the shards of a table, the outputs are
// the whole-table gather exactly (one shard owns each row).  The rest as for
// repro_embedding_gather.
int repro_embedding_gather_shard(const void* table, int64_t shard_rows, int64_t lo,
                                 int64_t vocab, const void* ids, void* out, int64_t n_ids,
                                 int64_t row_bytes, int id_bytes, int chunks, int threads,
                                 void* stream) {
  return gather_entry(table, vocab, lo, shard_rows, ids, out, n_ids, row_bytes, id_bytes,
                      chunks, threads, stream);
}

// The backward.  ids (n_ids,) of id_bytes (4: int32, 8: int64), any values
// (each bounded to a row as above); dout (n_ids, d) of dout_type and dtable
// (n_rows, d) of table_type (codes 0 float32, 1 float64, 2 bfloat16: the
// same type, or a bfloat16 table from float32 dout), each thread reading a
// vector of vec_bytes (16, 8, 4 or one element) of dout's rows and writing
// as many elements of dtable's; d a multiple of them, both pointers
// aligned to them.  carry: (n_ids, d) float32 scratch, needed (4 B
// aligned) where the table is bf16 and n_ids > 2048, else ignored
// (nullable).  Grid ceil(n_rows / stripe) x chunks blocks of `threads` (a
// multiple of 32, at most 256), stripe at most 256 rows, each thread one
// vector of each row: the chunks must cover the row and none may start
// past its end.  The caller makes the stream's device current.  Returns
// the launch's cudaError_t.
int repro_embedding_gather_bwd(const void* ids, int id_bytes, const void* dout, void* dtable,
                               void* carry, int64_t n_rows, int64_t n_ids, int64_t d,
                               int dout_type, int table_type, int vec_bytes, int stripe,
                               int chunks, int threads, void* stream) {
  return bwd_entry(ids, id_bytes, dout, dtable, carry, n_rows, 0, n_rows, n_ids, d, dout_type,
                   table_type, vec_bytes, stripe, chunks, threads, stream);
}

// The vocab-shard backward: dtable (shard_rows, d) is the gradient of rows
// [lo, lo + shard_rows) of a vocab-row table (0 <= lo, lo + shard_rows <=
// vocab).  Each id is bounded by vocab as the forward bounds it; an id whose
// row this shard does not hold adds nothing.  The rest as for
// repro_embedding_gather_bwd, the grid's stripes over the shard's rows.
int repro_embedding_gather_shard_bwd(const void* ids, int id_bytes, const void* dout,
                                     void* dtable, void* carry, int64_t shard_rows, int64_t lo,
                                     int64_t vocab, int64_t n_ids, int64_t d, int dout_type,
                                     int table_type, int vec_bytes, int stripe, int chunks,
                                     int threads, void* stream) {
  return bwd_entry(ids, id_bytes, dout, dtable, carry, shard_rows, lo, vocab, n_ids, d,
                   dout_type, table_type, vec_bytes, stripe, chunks, threads, stream);
}

const char* repro_gather_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
