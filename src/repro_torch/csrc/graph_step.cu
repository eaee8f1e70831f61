// Graph node-step kernels for Hopper (sm_90a): one pull step of BFS or
// PageRank, over one width bucket of SELL-C-sigma slabs per launch or over a
// whole ELLPACK adjacency.
//
// Replaces four TPU kernels of the JAX package:
//   repro_bfs_sell_bucket       (B3, BFS)       repro/kernels/sell_core.py::bucketed_node_step
//                                               running repro/kernels/bfs.py::_bfs_sell_step_kernel
//   repro_pagerank_sell_bucket  (B3, PageRank)  the same loop running
//                                               repro/kernels/pagerank.py::_pr_sell_step_kernel
//   repro_bfs_frontier and      (B4)            repro/kernels/bfs.py::_bfs_step_kernel (bfs_step)
//   repro_bfs_ell_step
//   repro_pagerank_ell_step     (B5)            repro/kernels/pagerank.py::_pr_step_kernel (pagerank_step)
//
// What bounds them on the card: device-memory bytes.  A step reads every
// stored neighbour id once (4 B), the node map once (4 B a node, SELL only),
// gathers the neighbours' state through the 50 MB L2, and writes each node's
// new state once; per neighbour it does one compare (BFS) or one add per
// state column (PageRank), far below the card's arithmetic rate.  The least
// bytes of a step are 4 E + 4 n + 8 n k (BFS: int32 state read and written
// once) and 4 E + 4 n + 2 s n k (PageRank: contributions read, ranks
// written, s = 8 B in fp64 and 4 B in fp32); ELLPACK has no node-map term.
// The pad entries of the slabs are the layout's own bytes above that.
//
// PageRank runs in the rank type T, double or float (the JAX package's x64
// and x64-off paths): B3's PageRank kernels and B5 are templates on T, and
// their C entries take an is_double code.  In fp32 a state row of 16 B is 4
// columns (float4 loads where fp64 loads double2), the split parts' partial
// sums are sizeof(T) wide in shared memory, and every sum and the combine
// base + d * (pulled + dangling_term) are made in T.  BFS stays int32.
//
// Layout: the JAX package stores graph slabs node-major, (S, C, W), so
// neighbouring threads would read ids W * 4 B apart.  The port's upload
// keeps the neighbour axis outermost instead: a SELL bucket is stored
// (S, W, C) and an ELLPACK adjacency (width, n), so element (s, w, lane)
// lives at (s * W + w) * C + lane and a warp's id loads are coalesced.  A
// PAD neighbour (-1) is skipped, never clamped: its state is not read.
//
// B4 / B5 (ELLPACK, one thread a node v, one state column):
//   * live width per warp: live[v >> 5] is 1 + the last slot at which any
//     of the warp's 32 consecutive nodes stores a neighbour (0 for none),
//     computed once per graph and device by the host
//     (repro_torch/kernels/bfs.py::ell_live_widths, B6's live_widths of
//     the (1, width, n) view); a thread walks only up to it.  On uniform21
//     (Poisson in-degrees, width 40) the warps' walks cover 0.645 of the
//     stored slots.  A PAD slot inside the walk is still skipped.  The
//     width read is bounded to [0, width] in the kernel, so a width handed
//     in past the adjacency's walks the whole row and a negative one walks
//     none: no id outside the adjacency is read;
//   * U slots a round (UNROLL_ELL): first the U id loads,
//     evict-first (__ldcs: the ids are read once and leave the L2 to the
//     state), then the U state reads of the non-PAD ones, then the tests or
//     adds, so a thread keeps U loads in flight where a one-slot loop had
//     one round trip a slot;
//   * B4 tests a neighbour against a frontier bitmap, not its distance: a
//     first launch (bfs_frontier_kernel) packs dist == level - 1 into
//     ceil(n / 32) words with one __ballot_sync a warp (256 KB at 2M
//     nodes, 8 MB of dist read once).  A 32 B sector of the bitmap covers
//     256 nodes, so the bit tests stay in L1 / L2 where the int32 gathers
//     took one sector a neighbour.  A node not at INF writes its distance
//     back without walking; a node at INF stops after the first round with
//     a hit and writes level or INF.  Exact, equal to the one-slot walk;
//   * B5 adds each node's contributions in ascending w, skipping PAD: the
//     one-slot loop's order, so its sum is bit-equal to it, and writes
//     base + d * (pulled + dangling_term).  The fp64 gathers (16.7 MB at
//     2M nodes, inside the L2) stay one 32 B sector a neighbour: on a
//     uniform random graph no layout removes them, so the L2's random
//     sector rate is B5's practical floor (scripts/graph_ell_variants.py
//     reads it as B5 with every id taken mod 2048).
//
// B3 (SELL, k state columns), where a state row is 16 B or less and its
// bucket is not split (k_tile 1 / 2 fp64, 1 .. 4 fp32 or int32): one thread a node
// (bfs_step_kernel / pagerank_step_kernel):
//   * a thread reads its node id from the bucket's node map, walks its W
//     in-neighbour slots in ascending w and keeps K_TILE state columns in
//     registers (K_TILE a template parameter; grid.y walks the column
//     tiles), then writes out[node] directly (the scatter to node order is
//     fused).  Padding lanes carry node id n and return before any read or
//     write, so the dump slot keeps the value the wrapper put there (INF
//     for BFS, 0 for PageRank) and no two threads write one address;
//   * BFS reads the old distances and writes a fresh buffer (the host loop
//     compares old with new).  A thread first loads its own K_TILE
//     distances; only the columns still at INF search the in-neighbours
//     (a bitmask), and the walk stops once each of them has found a
//     neighbour on level - 1;
//   * PageRank keeps K_TILE partial sums in T, added in ascending w, and
//     writes base + d * (pulled + dangling_term) per column, the constants
//     read from a (3, ld) array (ld = 1 broadcasts one configuration);
//   * on those buckets the group form below, at one lane a node, was
//     slower (uniform21 at k = 1, chip_smoke.py timings on an NVIDIA H100
//     80GB HBM3 at 700 W: BFS 0.69-0.72 ms against 0.47-0.52, PageRank
//     0.46-0.48 against 0.38-0.42); it loads row 0 for each PAD slot and
//     votes each step, where this body skips PAD slots.
//
// B3's group form (bfs_group_step_kernel / pagerank_group_step_kernel) for the rest:
//   * lanes across the state columns: a node is served by a group of G
//     lanes of one warp, G = K_TILE * sizeof(state) / 16 (PageRank fp64 at
//     k_tile 32: 16; fp32 and BFS int32: 8), so one neighbour's K_TILE state row is
//     read as one coalesced access, 16 B a lane, where one thread made
//     K_TILE scalar loads from one row and a warp load touched 32 rows;
//   * the group's lanes load G neighbour ids at once, one each, and pass
//     them round with __shfl_sync, so the G state rows behind them are
//     gathered with independent loads: a round trip per G neighbours;
//   * BFS keeps each lane's columns' need / hit bits and stops when a
//     __any_sync over the group's mask finds every lane done; PageRank
//     sums each lane's columns in ascending w, bit-equal to the body above;
//   * a split bucket whose state row is 16 B or less has groups of one
//     lane;
//   * a wide bucket is split: `parts` groups share one node, part p walking
//     w = p, p + parts, ... (core/autotune.py::node_split fills the card,
//     bounds each walk and fits the block), so rmat's W = 8192 slice is no
//     longer one chain of 8,192 dependent steps a thread.  The parts combine
//     through shared memory: BFS by an OR of the hit masks (exact);
//     PageRank by adding the partial sums in a fixed pairwise order
//     (deterministic, within rtol 1e-10 of the plain version, not bit-equal
//     to the unsplit walk).
//
// The host wrappers are repro_torch/kernels/bfs.py and pagerank.py (through
// sell_core.bucketed_node_step for SELL); they allocate the output (and
// B4's frontier words), validate device, dtype, shape and strides, skip
// empty buckets and raise on a non-zero return code.  Neighbour-id bounds
// are the preflight's job (repro_torch/analysis/preflight.py::plan_bfs_ell
// and friends); B4 / B5 bound the live widths themselves, as above.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int32_t kPad = -1;
constexpr int32_t kInf = 0x7fffffff;
constexpr int kMaxThreads = 1024;
constexpr int64_t kMaxGridY = 65535;

template <int K_TILE>
__global__ void bfs_step_kernel(const int32_t* __restrict__ adj,
                                const int32_t* __restrict__ nodes,  // (S, C)
                                const int32_t* __restrict__ dist,   // (rows, ld)
                                int32_t* __restrict__ out,          // (rows, ld)
                                int32_t level,
                                int64_t n_lanes,   // S * C
                                int64_t width,     // W
                                int64_t c,         // slice height
                                int64_t ld,        // state columns
                                int64_t n_nodes) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_lanes) return;
  const int64_t v = static_cast<int64_t>(__ldg(nodes + t));
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

template <typename T, int K_TILE>
__global__ void pagerank_step_kernel(const int32_t* __restrict__ adj,
                                     const int32_t* __restrict__ nodes,   // (S, C)
                                     const T* __restrict__ contrib,       // (rows, ld)
                                     const T* __restrict__ consts,        // (3, ld)
                                     T* __restrict__ out,                 // (rows, ld)
                                     int64_t n_lanes, int64_t width, int64_t c,
                                     int64_t ld, int64_t n_nodes) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_lanes) return;
  const int64_t v = static_cast<int64_t>(__ldg(nodes + t));
  if (v >= n_nodes) return;  // padding lane: the dump slot stays 0
  const int64_t s = t / c;
  const int64_t lane = t - s * c;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * K_TILE;

  T acc[K_TILE];
#pragma unroll
  for (int kk = 0; kk < K_TILE; ++kk) acc[kk] = T(0);
  const int64_t base = s * width * c + lane;
  for (int64_t w = 0; w < width; ++w) {
    const int32_t u = __ldg(adj + base + w * c);
    if (u == kPad) continue;
    const T* cu = contrib + static_cast<int64_t>(u) * ld + k0;
#pragma unroll
    for (int kk = 0; kk < K_TILE; ++kk) acc[kk] += __ldg(cu + kk);
  }
  T* o = out + v * ld + k0;
#pragma unroll
  for (int kk = 0; kk < K_TILE; ++kk) {
    const T base_term = __ldg(consts + k0 + kk);
    const T damping = __ldg(consts + ld + k0 + kk);
    const T dangling = __ldg(consts + 2 * ld + k0 + kk);
    o[kk] = base_term + damping * (acc[kk] + dangling);
  }
}

// ---------------------------------------------------------------------------
// B3's group form
// ---------------------------------------------------------------------------

constexpr int kLaneBytes = 16;
constexpr int kMaxGroupThreads = 1024;

// Lanes that serve one node, and the state columns each of them holds.
template <typename T, int K_TILE>
struct Lanes {
  static constexpr int kRowBytes = K_TILE * static_cast<int>(sizeof(T));
  static constexpr int G = kRowBytes > kLaneBytes ? kRowBytes / kLaneBytes : 1;
  static constexpr int kCols = K_TILE / G;
};

// N consecutive state columns as one load (16, 8 or 4 bytes).
template <int N>
__device__ __forceinline__ void load_cols(const int32_t* p, int32_t (&o)[N]) {
  if constexpr (N == 4) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else if constexpr (N == 2) {
    const int2 v = __ldg(reinterpret_cast<const int2*>(p));
    o[0] = v.x; o[1] = v.y;
  } else {
    o[0] = __ldg(p);
  }
}

template <int N>
__device__ __forceinline__ void load_cols(const double* p, double (&o)[N]) {
  if constexpr (N == 2) {
    const double2 v = __ldg(reinterpret_cast<const double2*>(p));
    o[0] = v.x; o[1] = v.y;
  } else {
    o[0] = __ldg(p);
  }
}

template <int N>
__device__ __forceinline__ void load_cols(const float* p, float (&o)[N]) {
  if constexpr (N == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    o[0] = v.x; o[1] = v.y;
  } else {
    o[0] = __ldg(p);
  }
}

// Where a thread of a group-form block sits: node `node` of the block,
// part `part` of that node's walk, lane `g` of the part's group; `gmask`
// names the group's lanes in the warp.
struct Place {
  int node, part, g;
  unsigned gmask;
};

template <int G>
__device__ __forceinline__ Place place_of(int parts) {
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const unsigned gmask = G >= 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane & ~(G - 1));
  return Place{tid / (parts * G), (tid / G) % parts, tid & (G - 1), gmask};
}

// The id of walk slot wb + g * parts, then the G slots' ids in turn: each
// lane of the group loads one id and __shfl_sync passes it round.
template <int G>
__device__ __forceinline__ int32_t group_id(int32_t mine, int j, unsigned gmask) {
  if constexpr (G == 1) {
    return mine;
  } else {
    return __shfl_sync(gmask, mine, j, G);
  }
}

template <int K_TILE>
__global__ void __launch_bounds__(kMaxGroupThreads)
    bfs_group_step_kernel(const int32_t* __restrict__ adj, const int32_t* __restrict__ nodes,
                     const int32_t* __restrict__ dist, int32_t* __restrict__ out,
                     int32_t level, int64_t n_lanes, int64_t width, int64_t c, int64_t ld,
                     int64_t n_nodes, int parts) {
  using L = Lanes<int32_t, K_TILE>;
  constexpr int G = L::G;
  constexpr int kCols = L::kCols;
  extern __shared__ __align__(16) unsigned char group_smem[];
  uint32_t* s_hit = reinterpret_cast<uint32_t*>(group_smem);  // a mask a node, when split
  const Place at = place_of<G>(parts);
  const int per_block = static_cast<int>(blockDim.x) / (parts * G);
  const int64_t t = static_cast<int64_t>(blockIdx.x) * per_block + at.node;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * K_TILE + at.g * kCols;
  if (parts > 1) {
    for (int i = threadIdx.x; i < per_block; i += blockDim.x) s_hit[i] = 0;
    __syncthreads();
  }
  int64_t v = n_nodes;
  if (t < n_lanes) v = __ldg(nodes + t);
  const bool active = v < n_nodes;  // one value for the whole group
  int32_t mine[kCols];
  uint32_t need = 0, hit = 0;
  if (active) {
    load_cols<kCols>(dist + v * ld + col0, mine);
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      if (mine[i] == kInf) need |= 1u << i;
    const int32_t prev = level - 1;
    const int64_t s = t / c;
    const int64_t base = s * width * c + (t - s * c);
    const int64_t step = static_cast<int64_t>(parts) * G;
    for (int64_t wb = at.part; wb < width; wb += step) {
      if (!__any_sync(at.gmask, hit != need)) break;
      const int64_t w = wb + static_cast<int64_t>(at.g) * parts;
      const int32_t id = w < width ? __ldg(adj + base + w * c) : kPad;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int32_t u = group_id<G>(id, j, at.gmask);
        int32_t du[kCols];
        load_cols<kCols>(dist + static_cast<int64_t>(u == kPad ? 0 : u) * ld + col0, du);
#pragma unroll
        for (int i = 0; i < kCols; ++i)
          if (u != kPad && ((need >> i) & 1u) && du[i] == prev) hit |= 1u << i;
      }
    }
  }
  if (parts > 1) {
    // OR the parts' hit masks: over the lanes of a warp that serve one node,
    // then one shared-memory atomic a warp (or a node's lanes)
    const int seg = parts * G < 32 ? parts * G : 32;
    const int lane = static_cast<int>(threadIdx.x) & 31;
    const unsigned smask = seg >= 32 ? 0xffffffffu : ((1u << seg) - 1u) << (lane & ~(seg - 1));
    const uint32_t mask = __reduce_or_sync(smask, hit << (at.g * kCols));
    if ((lane & (seg - 1)) == 0 && mask != 0) atomicOr(&s_hit[at.node], mask);
    __syncthreads();
    if (at.part != 0) return;
    hit = (s_hit[at.node] >> (at.g * kCols)) & ((kCols >= 32 ? 0u : (1u << kCols)) - 1u);
  }
  if (!active) return;  // padding lane: the dump slot stays as it is
  int32_t* o = out + v * ld + col0;
#pragma unroll
  for (int i = 0; i < kCols; ++i) o[i] = ((hit >> i) & 1u) ? level : mine[i];
}

template <typename T, int K_TILE>
__global__ void __launch_bounds__(kMaxGroupThreads)
    pagerank_group_step_kernel(const int32_t* __restrict__ adj, const int32_t* __restrict__ nodes,
                          const T* __restrict__ contrib,
                          const T* __restrict__ consts, T* __restrict__ out,
                          int64_t n_lanes, int64_t width, int64_t c, int64_t ld,
                          int64_t n_nodes, int parts) {
  using L = Lanes<T, K_TILE>;
  constexpr int G = L::G;
  constexpr int kCols = L::kCols;
  extern __shared__ __align__(16) unsigned char group_smem[];
  T* s_part = reinterpret_cast<T*>(group_smem);  // (nodes, parts, K_TILE) when split
  const Place at = place_of<G>(parts);
  const int per_block = static_cast<int>(blockDim.x) / (parts * G);
  const int64_t t = static_cast<int64_t>(blockIdx.x) * per_block + at.node;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * K_TILE;
  const int64_t col0 = k0 + at.g * kCols;
  int64_t v = n_nodes;
  if (t < n_lanes) v = __ldg(nodes + t);
  const bool active = v < n_nodes;
  T acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = T(0);
  if (active) {
    const int64_t s = t / c;
    const int64_t base = s * width * c + (t - s * c);
    const int64_t step = static_cast<int64_t>(parts) * G;
    for (int64_t wb = at.part; wb < width; wb += step) {
      const int64_t w = wb + static_cast<int64_t>(at.g) * parts;
      const int32_t id = w < width ? __ldg(adj + base + w * c) : kPad;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int32_t u = group_id<G>(id, j, at.gmask);
        T cu[kCols];
        load_cols<kCols>(contrib + static_cast<int64_t>(u == kPad ? 0 : u) * ld + col0, cu);
        if (u != kPad) {
#pragma unroll
          for (int i = 0; i < kCols; ++i) acc[i] += cu[i];
        }
      }
    }
  }
  if (parts > 1) {
    // the parts' partial sums, added in a fixed pairwise order
    T* mine = s_part + (static_cast<int64_t>(at.node) * parts + at.part) * K_TILE
                   + at.g * kCols;
#pragma unroll
    for (int i = 0; i < kCols; ++i) mine[i] = acc[i];
    for (int stride = parts >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      const int items = per_block * stride * K_TILE;
      for (int i = threadIdx.x; i < items; i += blockDim.x) {
        const int col = i % K_TILE;
        const int rest = i / K_TILE;
        const int p = rest % stride;
        const int nd = rest / stride;
        s_part[(nd * parts + p) * K_TILE + col] += s_part[(nd * parts + p + stride) * K_TILE + col];
      }
    }
    __syncthreads();
    if (at.part != 0) return;
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] = mine[i];
  }
  if (!active) return;  // padding lane: the dump slot stays 0
  T* o = out + v * ld + col0;
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const T base_term = __ldg(consts + col0 + i);
    const T damping = __ldg(consts + ld + col0 + i);
    const T dangling = __ldg(consts + 2 * ld + col0 + i);
    o[i] = base_term + damping * (acc[i] + dangling);
  }
}

// ---------------------------------------------------------------------------
// B4 / B5: ELLPACK, one thread a node, up to its warp's live width
// ---------------------------------------------------------------------------

// Slots a thread loads before it tests (B4) or adds (B5) them: the best of
// 4 / 8 / 16 for both at uniform21 on an H100 80GB HBM3 at 700 W
// (scripts/graph_ell_variants.py: B4's walk 0.134 / 0.149 / 0.164 ms, B5
// 0.294 / 0.305 / 0.327 ms at 128 threads).
constexpr int UNROLL_ELL = 4;

// A warp's live width as the walk takes it: in [0, width] whatever was
// handed in.
__device__ __forceinline__ int bounded_width(int32_t live, int64_t width) {
  return live < 0 ? 0 : (live > width ? static_cast<int>(width) : live);
}

// B4's frontier pass: bit (v & 31) of word v >> 5 is dist[v] == prev.  A
// warp's 32 consecutive nodes are exactly one word, so lane 0 writes it
// and no atomics are needed; lanes past n_nodes vote 0.
__global__ void bfs_frontier_kernel(const int32_t* __restrict__ dist,
                                    uint32_t* __restrict__ frontier, int32_t prev,
                                    int64_t n_nodes) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint32_t word = __ballot_sync(0xffffffffu, v < n_nodes && __ldg(dist + v) == prev);
  if ((threadIdx.x & 31) == 0 && v < n_nodes) frontier[v >> 5] = word;
}

// B4's walk: a node still at INF tests U in-neighbours a round against the
// frontier bitmap (their U ids loaded first, evict-first) and stops after
// the first round with a hit; every other node keeps its distance.
template <int U>
__global__ void bfs_ell_kernel(const int32_t* __restrict__ adj,         // (width, n)
                               const int32_t* __restrict__ live,        // (ceil(n / 32),)
                               const uint32_t* __restrict__ frontier,   // (ceil(n / 32),)
                               const int32_t* __restrict__ dist,        // (n,)
                               int32_t* __restrict__ out,               // (n,)
                               int32_t level, int64_t n_nodes, int64_t width) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= n_nodes) return;
  const int32_t mine = __ldg(dist + v);
  if (mine != kInf) {
    out[v] = mine;
    return;
  }
  const int wl = bounded_width(__ldg(live + (v >> 5)), width);
  const int32_t* a = adj + v;
  bool hit = false;
  for (int w = 0; w < wl && !hit; w += U) {
    int32_t u[U];
    uint32_t word[U];
#pragma unroll
    for (int i = 0; i < U; ++i)
      u[i] = w + i < wl ? __ldcs(a + static_cast<int64_t>(w + i) * n_nodes) : kPad;
#pragma unroll
    for (int i = 0; i < U; ++i) word[i] = u[i] != kPad ? __ldg(frontier + (u[i] >> 5)) : 0u;
#pragma unroll
    for (int i = 0; i < U; ++i) hit |= ((word[i] >> (u[i] & 31)) & 1u) != 0;
  }
  out[v] = hit ? level : kInf;
}

// B5: U ids a round (evict-first), then the U contribution gathers of the
// non-PAD ones (contrib stays in the L2), then the adds in ascending w: the
// order of a one-slot loop, so each node's sum is bit-equal to it.
template <typename T, int U>
__global__ void pagerank_ell_kernel(const int32_t* __restrict__ adj,      // (width, n)
                                    const int32_t* __restrict__ live,     // (ceil(n / 32),)
                                    const T* __restrict__ contrib,        // (n,)
                                    const T* __restrict__ consts,         // (3,)
                                    T* __restrict__ out,                  // (n,)
                                    int64_t n_nodes, int64_t width) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= n_nodes) return;
  const int wl = bounded_width(__ldg(live + (v >> 5)), width);
  const int32_t* a = adj + v;
  T acc = T(0);
  for (int w = 0; w < wl; w += U) {
    int32_t u[U];
    T c[U];
#pragma unroll
    for (int i = 0; i < U; ++i)
      u[i] = w + i < wl ? __ldcs(a + static_cast<int64_t>(w + i) * n_nodes) : kPad;
#pragma unroll
    for (int i = 0; i < U; ++i) c[i] = u[i] != kPad ? __ldg(contrib + u[i]) : T(0);
#pragma unroll
    for (int i = 0; i < U; ++i)
      if (u[i] != kPad) acc += c[i];
  }
  out[v] = __ldg(consts) + __ldg(consts + 1) * (acc + __ldg(consts + 2));
}

// Lanes a group of the form serving a k_tile of this state type.
template <typename T>
int group_of(int k_tile) {
  const int bytes = k_tile * static_cast<int>(sizeof(T));
  return bytes > kLaneBytes ? bytes / kLaneBytes : 1;
}

bool bad_split(int threads, int parts, int group) {
  return parts <= 0 || (parts & (parts - 1)) != 0 || threads > kMaxGroupThreads ||
         threads % (parts * group) != 0;
}

bool bad_shape(int64_t n_lanes, int64_t width, int64_t ld, int k_tile, int threads) {
  return n_lanes <= 0 || width < 0 || ld <= 0 || k_tile <= 0 || ld % k_tile != 0 ||
         ld / k_tile > kMaxGridY || threads <= 0 || threads > kMaxThreads;
}

// B4 / B5 launches: blocks of whole warps (the frontier's ballot, the live
// widths a warp).
bool bad_ell(int64_t n_nodes, int threads) {
  return n_nodes <= 0 || threads <= 0 || threads > kMaxThreads || threads % 32 != 0;
}

dim3 grid_of(int64_t n_lanes, int64_t ld, int k_tile, int threads) {
  return dim3(static_cast<unsigned>((n_lanes + threads - 1) / threads),
              static_cast<unsigned>(ld / k_tile));
}

// One SELL bucket of a PageRank power step in the rank type T: a launch of
// the one-thread body (one part, a state row of 16 B or less) or of the
// group form (groups of max(1, k_tile * sizeof(T) / 16) lanes, `parts`
// groups a node, the parts' sums in shared memory).
template <typename T>
int pagerank_sell_bucket(const int32_t* a, const int32_t* m, const T* x, const T* k, T* o,
                         int64_t n_lanes, int64_t width, int64_t c, int64_t ld, int k_tile,
                         int64_t n_nodes, int threads, int parts, cudaStream_t st) {
  const int group = group_of<T>(k_tile);
  const dim3 block(threads);
  if (group == 1 && parts == 1) {
    const dim3 grid = grid_of(n_lanes, ld, k_tile, threads);
    switch (k_tile) {
#define REPRO_PR_CASE(K)                                                               \
  case K:                                                                              \
    pagerank_step_kernel<T, K><<<grid, block, 0, st>>>(a, m, x, k, o, n_lanes,         \
                                                       width, c, ld, n_nodes);         \
    break;
      REPRO_PR_CASE(1)
      REPRO_PR_CASE(2)
      REPRO_PR_CASE(4)
#undef REPRO_PR_CASE
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid = grid_of(n_lanes, ld, k_tile, threads / (parts * group));
  const size_t smem =
      parts > 1 ? static_cast<size_t>(threads / group) * k_tile * sizeof(T) : 0;
  switch (k_tile) {
#define REPRO_PR_GROUP_CASE(K)                                                           \
  case K:                                                                                \
    pagerank_group_step_kernel<T, K><<<grid, block, smem, st>>>(a, m, x, k, o, n_lanes,  \
                                                                width, c, ld, n_nodes,   \
                                                                parts);                  \
    break;
    REPRO_PR_GROUP_CASE(1)
    REPRO_PR_GROUP_CASE(2)
    REPRO_PR_GROUP_CASE(4)
    REPRO_PR_GROUP_CASE(8)
    REPRO_PR_GROUP_CASE(16)
    REPRO_PR_GROUP_CASE(32)
#undef REPRO_PR_GROUP_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One SELL bucket of a BFS level: adj stored (n_slices, width, c), nodes
// (n_slices, c), dist and out (n_nodes + 1, ld) int32 16-byte aligned, ld a
// multiple of k_tile.  `parts` groups share a node's walk (a power of two)
// in blocks of `threads` threads; with one part and a state row of 16 B
// or less (k_tile <= 4) a thread serves a node, else a group of
// max(1, k_tile / 4) lanes does.  Returns the cudaError_t of the launch (0 on success).
int repro_bfs_sell_bucket(const void* adj, const void* nodes, const void* dist, void* out,
                          int level, int64_t n_slices, int64_t width, int64_t c, int64_t ld,
                          int k_tile, int64_t n_nodes, int threads, int parts, void* stream) {
  const int64_t n_lanes = n_slices * c;
  const int group = group_of<int32_t>(k_tile);
  if (n_slices <= 0 || c <= 0 || bad_shape(n_lanes, width, ld, k_tile, threads) ||
      bad_split(threads, parts, group) || reinterpret_cast<uintptr_t>(dist) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const int32_t*>(adj);
  const auto* m = static_cast<const int32_t*>(nodes);
  const auto* d = static_cast<const int32_t*>(dist);
  auto* o = static_cast<int32_t*>(out);
  const dim3 block(threads);
  if (group == 1 && parts == 1) {
    const dim3 grid = grid_of(n_lanes, ld, k_tile, threads);
    switch (k_tile) {
#define REPRO_BFS_CASE(K)                                                          \
  case K:                                                                          \
    bfs_step_kernel<K><<<grid, block, 0, st>>>(a, m, d, o, level, n_lanes,  \
                                                     width, c, ld, n_nodes);      \
    break;
      REPRO_BFS_CASE(1)
      REPRO_BFS_CASE(2)
      REPRO_BFS_CASE(4)
#undef REPRO_BFS_CASE
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int per_block = threads / (parts * group);
  const dim3 grid = grid_of(n_lanes, ld, k_tile, per_block);
  const size_t smem = parts > 1 ? static_cast<size_t>(per_block) * sizeof(uint32_t) : 0;
  switch (k_tile) {
#define REPRO_BFS_GROUP_CASE(K)                                                       \
  case K:                                                                             \
    bfs_group_step_kernel<K><<<grid, block, smem, st>>>(a, m, d, o, level, n_lanes, width, \
                                                   c, ld, n_nodes, parts);            \
    break;
    REPRO_BFS_GROUP_CASE(1)
    REPRO_BFS_GROUP_CASE(2)
    REPRO_BFS_GROUP_CASE(4)
    REPRO_BFS_GROUP_CASE(8)
    REPRO_BFS_GROUP_CASE(16)
    REPRO_BFS_GROUP_CASE(32)
#undef REPRO_BFS_GROUP_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// One SELL bucket of a PageRank power step: adj stored (n_slices, width, c),
// nodes (n_slices, c), contrib and out (n_nodes + 1, ld) 16-byte aligned,
// consts (3, ld), all three float64 when is_double is 1 and float32 when it
// is 0; `threads` and `parts` as for BFS (one thread a node at one part and
// a state row of 16 B or less: k_tile <= 2 in fp64, <= 4 in fp32), else a
// group of max(1, k_tile * sizeof(T) / 16) lanes.
int repro_pagerank_sell_bucket(const void* adj, const void* nodes, const void* contrib,
                               const void* consts, void* out, int64_t n_slices,
                               int64_t width, int64_t c, int64_t ld, int k_tile,
                               int64_t n_nodes, int threads, int parts, int is_double,
                               void* stream) {
  const int64_t n_lanes = n_slices * c;
  const int group = is_double ? group_of<double>(k_tile) : group_of<float>(k_tile);
  if (n_slices <= 0 || c <= 0 || bad_shape(n_lanes, width, ld, k_tile, threads) ||
      bad_split(threads, parts, group) || reinterpret_cast<uintptr_t>(contrib) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const int32_t*>(adj);
  const auto* m = static_cast<const int32_t*>(nodes);
  if (is_double) {
    return pagerank_sell_bucket<double>(
        a, m, static_cast<const double*>(contrib), static_cast<const double*>(consts),
        static_cast<double*>(out), n_lanes, width, c, ld, k_tile, n_nodes, threads, parts, st);
  }
  return pagerank_sell_bucket<float>(
      a, m, static_cast<const float*>(contrib), static_cast<const float*>(consts),
      static_cast<float*>(out), n_lanes, width, c, ld, k_tile, n_nodes, threads, parts, st);
}

// B4's frontier pass for a BFS level: word i of `frontier` ((ceil(n_nodes /
// 32),) int32) gets bit j set where dist[32 i + j] == level - 1.  Blocks of
// `threads` threads, a multiple of 32.
int repro_bfs_frontier(const void* dist, void* frontier, int level, int64_t n_nodes,
                       int threads, void* stream) {
  if (bad_ell(n_nodes, threads) || dist == nullptr || frontier == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bfs_frontier_kernel<<<grid_of(n_nodes, 1, 1, threads), dim3(threads), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(dist), static_cast<uint32_t*>(frontier), level - 1,
      n_nodes);
  return static_cast<int>(cudaGetLastError());
}

// One BFS level (B4's walk) on an ELLPACK in-adjacency stored (width,
// n_nodes), live (ceil(n_nodes / 32),) int32 each warp's live width
// (bounded to [0, width] by the kernel), frontier the level's
// repro_bfs_frontier words; dist and out (n_nodes,) int32.
int repro_bfs_ell_step(const void* adj, const void* live, const void* frontier,
                       const void* dist, void* out, int level, int64_t n_nodes,
                       int64_t width, int threads, void* stream) {
  if (bad_ell(n_nodes, threads) || width < 0 || live == nullptr || frontier == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bfs_ell_kernel<UNROLL_ELL><<<grid_of(n_nodes, 1, 1, threads), dim3(threads), 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(adj), static_cast<const int32_t*>(live),
      static_cast<const uint32_t*>(frontier), static_cast<const int32_t*>(dist),
      static_cast<int32_t*>(out), level, n_nodes, width);
  return static_cast<int>(cudaGetLastError());
}

// One PageRank power step (B5) on an ELLPACK reverse adjacency stored
// (width, n_nodes), live as for BFS; contrib and out (n_nodes,), consts (3,),
// all float64 when is_double is 1 and float32 when it is 0.
int repro_pagerank_ell_step(const void* adj, const void* live, const void* contrib,
                            const void* consts, void* out, int64_t n_nodes, int64_t width,
                            int threads, int is_double, void* stream) {
  if (bad_ell(n_nodes, threads) || width < 0 || live == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid = grid_of(n_nodes, 1, 1, threads);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const int32_t*>(adj);
  const auto* l = static_cast<const int32_t*>(live);
  if (is_double) {
    pagerank_ell_kernel<double, UNROLL_ELL><<<grid, dim3(threads), 0, st>>>(
        a, l, static_cast<const double*>(contrib), static_cast<const double*>(consts),
        static_cast<double*>(out), n_nodes, width);
  } else {
    pagerank_ell_kernel<float, UNROLL_ELL><<<grid, dim3(threads), 0, st>>>(
        a, l, static_cast<const float*>(contrib), static_cast<const float*>(consts),
        static_cast<float*>(out), n_nodes, width);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* repro_graph_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
