// Graph node-step kernels for Hopper (sm_90a): one pull step of BFS or
// PageRank, over one width bucket of SELL-C-sigma slabs per launch or over a
// whole ELLPACK adjacency.
//
// Replaces four TPU kernels of the JAX package:
//   repro_bfs_sell_bucket       (B3, BFS)       repro/kernels/sell_core.py::bucketed_node_step
//                                               running repro/kernels/bfs.py::_bfs_sell_step_kernel
//   repro_pagerank_sell_bucket  (B3, PageRank)  the same loop running
//                                               repro/kernels/pagerank.py::_pr_sell_step_kernel
//   repro_bfs_ell_step          (B4)            repro/kernels/bfs.py::_bfs_step_kernel (bfs_step)
//   repro_pagerank_ell_step     (B5)            repro/kernels/pagerank.py::_pr_step_kernel (pagerank_step)
//
// What bounds them on the card: device-memory bytes.  A step reads every
// stored neighbour id once (4 B), the node map once (4 B a node, SELL only),
// gathers the neighbours' state through the 50 MB L2, and writes each node's
// new state once; per neighbour it does one compare (BFS) or one add per
// state column (PageRank), far below the card's arithmetic rate.  The least
// bytes of a step are 4 E + 4 n + 8 n k (BFS: int32 state read and written
// once) and 4 E + 4 n + 16 n k (PageRank: fp64 contributions read, ranks
// written); ELLPACK has no node-map term.  The pad entries of the slabs are
// the layout's own bytes above that.
//
// Design, right and simple first:
//   * one thread per node (one (slice, lane) of a SELL bucket, or node v of
//     an ELLPACK adjacency) walks its W in-neighbour slots in ascending w and
//     keeps K_TILE state columns in registers (K_TILE a template parameter in
//     {1, 2, 4, 8, 16, 32}; grid.y walks the column tiles);
//   * layout: the JAX package stores graph slabs node-major, (S, C, W), so
//     neighbouring threads would read ids W * 4 B apart.  The port's upload
//     keeps the neighbour axis outermost instead: a SELL bucket is stored
//     (S, W, C) and an ELLPACK adjacency (width, n), so element (s, w, lane)
//     lives at (s * W + w) * C + lane and a warp's id loads are coalesced.
//     ELLPACK is the special case of one slice with C = n and the identity
//     node map;
//   * the scatter to node order is fused: a SELL thread reads its node id
//     from the bucket's node map and writes out[node] directly.  Padding
//     lanes carry node id n and return before any read or write, so the
//     dump slot keeps the value the wrapper put there (INF for BFS, 0 for
//     PageRank) and no two threads write one address;
//   * a PAD neighbour (-1) is skipped, never clamped: its state is not read;
//   * BFS reads the old distances and writes a fresh buffer (the host loop
//     compares old with new).  A thread first loads its own K_TILE
//     distances; only the columns still at INF search the in-neighbours
//     (a bitmask), and the walk stops once each of them has found a
//     neighbour on level - 1.  On the first level from the sources every
//     node searches its whole in-list, so the byte count above holds;
//   * PageRank keeps K_TILE fp64 partial sums, added in ascending w, and
//     writes base + d * (pulled + dangling_term) per column, the constants
//     read from a (3, ld) array (ld = 1 broadcasts one configuration).
//   * the widest buckets (RMAT in-degree reaches thousands) are one serial
//     chain of dependent loads per thread, as in B1; that is left for a
//     later PR, and the per-bucket times show it.
//
// The host wrappers are repro_torch/kernels/bfs.py and pagerank.py (through
// sell_core.bucketed_node_step for SELL); they allocate the output, validate
// device, dtype, shape and strides, skip empty buckets and raise on a
// non-zero return code.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int32_t kPad = -1;
constexpr int32_t kInf = 0x7fffffff;
constexpr int kMaxThreads = 1024;
constexpr int64_t kMaxGridY = 65535;

template <bool kSell, int K_TILE>
__global__ void bfs_step_kernel(const int32_t* __restrict__ adj,
                                const int32_t* __restrict__ nodes,  // SELL: (S, C)
                                const int32_t* __restrict__ dist,   // (rows, ld)
                                int32_t* __restrict__ out,          // (rows, ld)
                                int32_t level,
                                int64_t n_lanes,   // S * C
                                int64_t width,     // W
                                int64_t c,         // slice height (n for ELLPACK)
                                int64_t ld,        // state columns
                                int64_t n_nodes) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_lanes) return;
  const int64_t v = kSell ? static_cast<int64_t>(__ldg(nodes + t)) : t;
  if (v >= n_nodes) return;  // padding lane: the dump slot stays as it is
  const int64_t s = t / c;
  const int64_t lane = t - s * c;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * K_TILE;

  const int32_t* mine_p = dist + v * ld + k0;
  int32_t mine[K_TILE];
  uint32_t need = 0;
#pragma unroll
  for (int kk = 0; kk < K_TILE; ++kk) {
    mine[kk] = __ldg(mine_p + kk);
    if (mine[kk] == kInf) need |= 1u << kk;
  }
  uint32_t hit = 0;
  if (need != 0) {
    const int32_t prev = level - 1;
    const int64_t base = s * width * c + lane;
    for (int64_t w = 0; w < width && hit != need; ++w) {
      const int32_t u = __ldg(adj + base + w * c);
      if (u == kPad) continue;
      const int32_t* du = dist + static_cast<int64_t>(u) * ld + k0;
#pragma unroll
      for (int kk = 0; kk < K_TILE; ++kk) {
        if (((need >> kk) & 1u) && __ldg(du + kk) == prev) hit |= 1u << kk;
      }
    }
  }
  int32_t* o = out + v * ld + k0;
#pragma unroll
  for (int kk = 0; kk < K_TILE; ++kk) o[kk] = ((hit >> kk) & 1u) ? level : mine[kk];
}

template <bool kSell, int K_TILE>
__global__ void pagerank_step_kernel(const int32_t* __restrict__ adj,
                                     const int32_t* __restrict__ nodes,   // SELL: (S, C)
                                     const double* __restrict__ contrib,  // (rows, ld)
                                     const double* __restrict__ consts,   // (3, ld)
                                     double* __restrict__ out,            // (rows, ld)
                                     int64_t n_lanes, int64_t width, int64_t c,
                                     int64_t ld, int64_t n_nodes) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_lanes) return;
  const int64_t v = kSell ? static_cast<int64_t>(__ldg(nodes + t)) : t;
  if (v >= n_nodes) return;  // padding lane: the dump slot stays 0
  const int64_t s = t / c;
  const int64_t lane = t - s * c;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * K_TILE;

  double acc[K_TILE];
#pragma unroll
  for (int kk = 0; kk < K_TILE; ++kk) acc[kk] = 0.0;
  const int64_t base = s * width * c + lane;
  for (int64_t w = 0; w < width; ++w) {
    const int32_t u = __ldg(adj + base + w * c);
    if (u == kPad) continue;
    const double* cu = contrib + static_cast<int64_t>(u) * ld + k0;
#pragma unroll
    for (int kk = 0; kk < K_TILE; ++kk) acc[kk] += __ldg(cu + kk);
  }
  double* o = out + v * ld + k0;
#pragma unroll
  for (int kk = 0; kk < K_TILE; ++kk) {
    const double base_term = __ldg(consts + k0 + kk);
    const double damping = __ldg(consts + ld + k0 + kk);
    const double dangling = __ldg(consts + 2 * ld + k0 + kk);
    o[kk] = base_term + damping * (acc[kk] + dangling);
  }
}

bool bad_shape(int64_t n_lanes, int64_t width, int64_t ld, int k_tile, int threads) {
  return n_lanes <= 0 || width < 0 || ld <= 0 || k_tile <= 0 || ld % k_tile != 0 ||
         ld / k_tile > kMaxGridY || threads <= 0 || threads > kMaxThreads;
}

dim3 grid_of(int64_t n_lanes, int64_t ld, int k_tile, int threads) {
  return dim3(static_cast<unsigned>((n_lanes + threads - 1) / threads),
              static_cast<unsigned>(ld / k_tile));
}

}  // namespace

extern "C" {

// One SELL bucket of a BFS level: adj stored (n_slices, width, c), nodes
// (n_slices, c), dist and out (n_nodes + 1, ld) int32, ld a multiple of
// k_tile.  Returns the cudaError_t of the launch (0 on success).
int repro_bfs_sell_bucket(const void* adj, const void* nodes, const void* dist, void* out,
                          int level, int64_t n_slices, int64_t width, int64_t c, int64_t ld,
                          int k_tile, int64_t n_nodes, int threads, void* stream) {
  const int64_t n_lanes = n_slices * c;
  if (n_slices <= 0 || c <= 0 || bad_shape(n_lanes, width, ld, k_tile, threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid = grid_of(n_lanes, ld, k_tile, threads);
  const dim3 block(threads);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const int32_t*>(adj);
  const auto* m = static_cast<const int32_t*>(nodes);
  const auto* d = static_cast<const int32_t*>(dist);
  auto* o = static_cast<int32_t*>(out);
  switch (k_tile) {
#define REPRO_BFS_CASE(K)                                                          \
  case K:                                                                          \
    bfs_step_kernel<true, K><<<grid, block, 0, st>>>(a, m, d, o, level, n_lanes,  \
                                                     width, c, ld, n_nodes);      \
    break;
    REPRO_BFS_CASE(1)
    REPRO_BFS_CASE(2)
    REPRO_BFS_CASE(4)
    REPRO_BFS_CASE(8)
    REPRO_BFS_CASE(16)
    REPRO_BFS_CASE(32)
#undef REPRO_BFS_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// One SELL bucket of a PageRank power step: adj stored (n_slices, width, c),
// nodes (n_slices, c), contrib and out (n_nodes + 1, ld) float64, consts
// (3, ld) float64.
int repro_pagerank_sell_bucket(const void* adj, const void* nodes, const void* contrib,
                               const void* consts, void* out, int64_t n_slices,
                               int64_t width, int64_t c, int64_t ld, int k_tile,
                               int64_t n_nodes, int threads, void* stream) {
  const int64_t n_lanes = n_slices * c;
  if (n_slices <= 0 || c <= 0 || bad_shape(n_lanes, width, ld, k_tile, threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid = grid_of(n_lanes, ld, k_tile, threads);
  const dim3 block(threads);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const int32_t*>(adj);
  const auto* m = static_cast<const int32_t*>(nodes);
  const auto* x = static_cast<const double*>(contrib);
  const auto* k = static_cast<const double*>(consts);
  auto* o = static_cast<double*>(out);
  switch (k_tile) {
#define REPRO_PR_CASE(K)                                                               \
  case K:                                                                              \
    pagerank_step_kernel<true, K><<<grid, block, 0, st>>>(a, m, x, k, o, n_lanes,     \
                                                          width, c, ld, n_nodes);     \
    break;
    REPRO_PR_CASE(1)
    REPRO_PR_CASE(2)
    REPRO_PR_CASE(4)
    REPRO_PR_CASE(8)
    REPRO_PR_CASE(16)
    REPRO_PR_CASE(32)
#undef REPRO_PR_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// One BFS level on an ELLPACK in-adjacency stored (width, n_nodes); dist and
// out (n_nodes,) int32.
int repro_bfs_ell_step(const void* adj, const void* dist, void* out, int level,
                       int64_t n_nodes, int64_t width, int threads, void* stream) {
  if (bad_shape(n_nodes, width, 1, 1, threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bfs_step_kernel<false, 1><<<grid_of(n_nodes, 1, 1, threads), dim3(threads), 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(adj), nullptr, static_cast<const int32_t*>(dist),
      static_cast<int32_t*>(out), level, n_nodes, width, n_nodes, 1, n_nodes);
  return static_cast<int>(cudaGetLastError());
}

// One PageRank power step on an ELLPACK reverse adjacency stored (width,
// n_nodes); contrib and out (n_nodes,) float64, consts (3,) float64.
int repro_pagerank_ell_step(const void* adj, const void* contrib, const void* consts,
                            void* out, int64_t n_nodes, int64_t width, int threads,
                            void* stream) {
  if (bad_shape(n_nodes, width, 1, 1, threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  pagerank_step_kernel<false, 1><<<grid_of(n_nodes, 1, 1, threads), dim3(threads), 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(adj), nullptr, static_cast<const double*>(contrib),
      static_cast<const double*>(consts), static_cast<double*>(out), n_nodes, width,
      n_nodes, 1, n_nodes);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_graph_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
