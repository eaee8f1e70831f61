// Backward of the Mamba2 SSD chunked scan (kernel B8) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference differentiates its plain jnp scan
// (repro/models/ssm.py::ssd_chunked) and has no backward Pallas kernel.  It
// was added because the port's forward runs kernel B8 (ssd_fused.cu) on the
// card, and a backward through the plain version would put plain PyTorch on
// the card's training path.  It computes what autograd of the plain scan
// (repro_torch/kernels/ssd.py::ssd_fused_ref) computes.
//
// Per (b, h) and chunk of q rows, with cum the running sum of ad in the
// chunk, L[i, j] = e^{cum_i - cum_j} (i >= j, else 0), G = C Bᵀ, S_in the
// state entering the chunk, S_out the one leaving it and dS_out the gradient
// arriving from the next chunk (the final state's for the last chunk):
//   dS_in = e^{cum_last} dS_out + sum_i e^{cum_i} dY_iᵀ C_i
//   M     = (dY Xᵀ) ∘ L
//   dX    = (G ∘ L)ᵀ dY + diag(e^{cum_last - cum}) B dS_outᵀ
//   dC    = M B + diag(e^{cum}) dY S_in
//   dB    = Mᵀ C + diag(e^{cum_last - cum}) X dS_out
//   dcum  = rowsum(G ∘ M) - colsum(G ∘ M) + rowsum(dY ∘ y_inter)
//           - e^{cum_last - cum_j} <dS_out, X_jᵀ B_j> (+ <dS_out, S_out> at
//           the chunk's last row)
//   dad   = the reverse running sum of dcum within the chunk.
// rowsum(dY ∘ y_inter)_i is computed as sum_n C[i, n] (e^{cum_i} dY_i S_in)[n]
// and the state term of dcum_j as -sum_n B[j, n] (e^{cum_last - cum_j} X_j
// dS_out)[n]: both from products the gradients need anyway.
//
// What bounds it on the card: operations.  Per (b, h) and chunk the function
// is q(q+1)/2 (3n + 2p) + 4 q p n multiply-adds (G, M, dC, dB and dX on and
// below the diagonal; the local term and the three dS terms), two operations
// each: 16.15 GFLOP at mamba2's train step (b 2, l 512, h 80, p 64, n 128,
// q 256), 0.241 ms at the CUDA cores' 67 TFLOP/s, 0.098 ms as 3xTF32 (three
// TF32 products each) at the tensor cores' 495.  Its 64-row tiles execute
// at most 18.8 GFLOP there (the diagonal tiles whole, each pair once).
//
// Five launches:
//   1. ssd_bwd_local_kernel, grid (b h nc, ceil(p/64), ceil(n/64)): each
//      chunk's local term sum_i e^{cum_i} dY_iᵀ C_i, a 64 x 64 tile of (p, n)
//      a block;
//   2. ssd_bwd_state_pass_kernel, on the forward state pass's grid (one thread
//      per (b, h, p, n) entry): walks the chunks last to first, writes dS_out
//      of each chunk and carries dS_in; writes init_state's gradient;
//   3. ssd_bwd_key_kernel, grid (b h nc, ceil(q/64)), one 64-row key tile J a
//      block (the most query tiles first), in two phases: (1) for each query
//      tile I >= J the pair's G_IJ and dY_I X_Jᵀ, once; M_IJ and (G ∘ L)_IJ
//      to (b h nc, pairs, 64, 64) scratch (52 MB each at the train shape),
//      the pair's row sums of G ∘ M to scratch, its column sums into dcum's
//      key part; (2) each 64-column slice of dB_J = X_J dS_out-term +
//      sum_I M_IJᵀ C_I and of dX_J = B_J dS_outᵀ-term + sum_I (G ∘ L)_IJᵀ
//      dY_I, stored once;
//   4. ssd_bwd_query_kernel, the same grid, one 64-row query tile I a block:
//      dC_I = diag(e^{cum}) dY_I S_in + sum_{J <= I} M_IJ B_J from launch 3's
//      M tiles, and dcum's query part (the state term's row sums and launch
//      3's row sums, ascending J);
//   5. ssd_bwd_finish_kernel: dad (the reverse running sum within each chunk,
//      a warp a chunk), and dB, dC summed over the h / g heads of each group
//      in ascending head order.
// Each launch has its own entry point; the host makes them in this order.
//
// Design, against what bounds it:
//   * No product is computed twice: launch 4 reads launch 3's M tiles
//     instead of recomputing G and dY Xᵀ (that recomputation was ~5 of the
//     ~23.8 GFLOP the five-launch form before it executed).  Handing tiles
//     through scratch was chosen over a cluster of four blocks sharing them
//     through distributed shared memory: a key block's pairs vary from 1 to
//     q / 64, so no fixed cluster balances them, and the round trip (~210
//     MB, mostly L2) costs less than the work it removes.  No output has
//     two writers, no float atomics are used, and every sum runs in a fixed
//     order: two calls give bit-equal gradients.
//   * fp32 products (the training path) on the tensor cores: mma.sync
//     m16n8k8 TF32 with the 3xTF32 split of ssd_mma.cuh (shared with the
//     forward; its split is integer arithmetic, not the conversion pipe), 8
//     warps tiling a 64 x 64 output 4 x 2.  fp64: CUDA-core micro-tiles, 256
//     threads as 16 x 16, a 4 x 4 tile each.
//   * Operands come from shared-memory tiles staged as they lie in device
//     memory by cp.async, four stages deep: every step is a k-step of 32
//     over two tiles (4608 elements; a product over a tile's 64 rows takes
//     two steps), and each block's products run as one pipeline a phase, so
//     a product's first tiles arrive during the one before.  No register
//     carries a tile.  Ragged tiles (q, p or n not a multiple of the tile)
//     are staged as zeros and masked on store.
//   * Row and column sums of a tile go through a (64, 65) shared tile, four
//     threads a row or column, each a quarter in index order, the quarters
//     added in a fixed butterfly.
//   * Shared memory is fixed whatever the shape: fp32 73, 89 and 89 KB for
//     launches 1, 3 and 4, two blocks an SM (fp64 twice that).
//   * The per-head dB and dC go to (b, l, h, n) scratch (42 MB each at the
//     train shape) before launch 5's group sums; launch 5 takes ~5% of the
//     call once dad is a warp a chunk.
//   * On an H100 at the train shape (scripts/ssd_launch_times.py): ~0.06,
//     0.016, 0.47, 0.15 and 0.044 ms; the five-launch form before this
//     design read 0.123, 0.016, 0.706 (key), 0.577 (query) and 0.086.
//
// The entering states S_in and the cum of every chunk are the forward's
// (saved by repro_torch/kernels/ssd.py's autograd Function from the forward
// launches), not recomputed.
//
// The bf16 form (the forward's SSD_BF16 mix): xd, dy, B and C stored in
// bf16; ad, dfinal, cum, the states and every scratch float32.  Each kernel
// is a template on the storage type S over the fp32 form's arithmetic: a
// bf16 operand is widened to float as it is staged (a plain load and a
// shared-memory store in place of cp.async, which cannot convert), so the
// products and sums are the fp32 form's on the upcast inputs; dX is
// rounded once to bf16 as it is stored, dB and dC once after the sum over
// the heads of a group (launch 5), dad and d init_state stay float32.  So
// each output is the fp32 form's on the upcast inputs, rounded once.
//
// The host wrapper is repro_torch/kernels/ssd.py::ssd_fused_bwd; it plans the
// launches (repro_torch/analysis/preflight.py::plan_ssd_fused_bwd),
// allocates outputs and scratch and raises on a non-zero return code.

#include <cuda_runtime.h>
#include <cstdint>

#include "ssd_mma.cuh"

namespace {

using namespace ssd_mma;

constexpr int TILE = 64;       // rows and columns of an output tile
constexpr int KC = 32;         // k of one staged step of a product over n or p
constexpr int THREADS = 256;   // 8 warps (fp32) or 16 x 16 threads (fp64)
constexpr int LDR = KC + 4;    // row stride of a (64, 32) tile contracted along its rows
constexpr int LDK = TILE + 8;  // row stride of a 64-wide tile contracted down its columns
constexpr int LDW = TILE + 1;  // row stride of the sums tile
constexpr int STAGE = 2 * TILE * LDR;            // a k-step's two tiles (= 2 * KC * LDK)
constexpr int PAIR = TILE * TILE;                // elements of a handed M tile
static_assert(STAGE == 2 * KC * LDK, "the two k-step layouts fill one stage");
constexpr int NS = 4;          // stages of every pipeline (k-steps of 32: STAGE each)

template <typename T>
__device__ __forceinline__ T exp_t(T v);
template <>
__device__ __forceinline__ float exp_t<float>(float v) { return expf(v); }
template <>
__device__ __forceinline__ double exp_t<double>(double v) { return exp(v); }

// The product engine: element (x, y) of a thread's 4 x 4 accumulator lies at
// (row(x, y), col(x, y)) of the block's 64 x 64 output tile, and mma<AK, BK,
// K> adds A B over k in [0, K): A[m][k] at A[m * lda + k] (at A[k * lda + m]
// when AK), B[k][n] at B[n * ldb + k] (at B[k * ldb + n] when BK); a
// non-null ascale multiplies A's column k by ascale[k].
template <typename T>
struct Engine;

template <>
struct Engine<float> {
  __device__ static int row(int tid, int x, int y) {
    return ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2) + (y >> 1) * 8;
  }
  __device__ static int col(int tid, int x, int y) {
    return (tid >> 7) * 32 + 8 * x + 2 * (tid & 3) + (y & 1);
  }
  template <bool AK, bool BK, int K>
  __device__ static void mma(float (&acc)[4][4], const float* A, int lda, const float* B,
                             int ldb, const float* ascale, int tid) {
    const int lane = tid & 31, warp = tid >> 5;
    const int mb = (warp & 3) * 16, nb = (warp >> 2) * 32;
#pragma unroll
    for (int kb = 0; kb < K; kb += 8) {
      uint32_t a[4], b[4][2];
      if constexpr (AK) frag_a_cols(a, A, lda, mb, kb, lane);
      else frag_a(a, A, lda, mb, kb, lane);
      if (ascale) {
        const float s0 = ascale[kb + (lane & 3)], s1 = ascale[kb + (lane & 3) + 4];
        a[0] = __float_as_uint(__uint_as_float(a[0]) * s0);
        a[1] = __float_as_uint(__uint_as_float(a[1]) * s0);
        a[2] = __float_as_uint(__uint_as_float(a[2]) * s1);
        a[3] = __float_as_uint(__uint_as_float(a[3]) * s1);
      }
      if constexpr (BK) frag_b_cols(b, B, ldb, nb, kb, lane);
      else frag_b_rows(b, B, ldb, nb, kb, lane);
      mma3(acc, a, b);
    }
  }
};

template <>
struct Engine<double> {
  __device__ static int row(int tid, int x, int y) { return (tid >> 4) * 4 + x; }
  __device__ static int col(int tid, int x, int y) { return (tid & 15) * 4 + y; }
  template <bool AK, bool BK, int K>
  __device__ static void mma(double (&acc)[4][4], const double* A, int lda, const double* B,
                             int ldb, const double* ascale, int tid) {
    const int r0 = (tid >> 4) * 4, c0 = (tid & 15) * 4;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      double a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = AK ? A[k * lda + r0 + i] : A[(r0 + i) * lda + k];
        b[i] = BK ? B[k * ldb + c0 + i] : B[(c0 + i) * ldb + k];
      }
      if (ascale) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] *= ascale[k];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
  }
};

template <typename T>
__device__ __forceinline__ void zero(T (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
}

// f(row, col, value&) for each element of this thread's accumulator.
template <typename T, typename F>
__device__ __forceinline__ void each(T (&acc)[4][4], int tid, F f) {
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) f(Engine<T>::row(tid, x, y), Engine<T>::col(tid, x, y), acc[x][y]);
}

// Reads (load) or writes this thread's part of a 64 x 64 output tile at
// rows r0.., columns c0.. of base (row stride `stride`), within (rows, cols);
// a load leaves 0 outside.  Elements (x, y) and (x, y + 1), y even, are
// neighbours in a row: one 2-vector access where base and stride allow.
template <typename T>
__device__ __forceinline__ void tile_io(T (&acc)[4][4], T* base, int64_t stride, int r0, int c0,
                                        int rows, int cols, int tid, bool store) {
  const bool pairs = (reinterpret_cast<uintptr_t>(base) % (2 * sizeof(T))) == 0 &&
                     stride % 2 == 0 && c0 % 2 == 0;
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; y += 2) {
      const int r = r0 + Engine<T>::row(tid, x, y), c = c0 + Engine<T>::col(tid, x, y);
      T* p = base + static_cast<int64_t>(r) * stride + c;
      if (pairs && r < rows && c + 1 < cols) {
        if constexpr (sizeof(T) == 4) {
          if (store) *reinterpret_cast<float2*>(p) = make_float2(acc[x][y], acc[x][y + 1]);
          else {
            const float2 v = *reinterpret_cast<const float2*>(p);
            acc[x][y] = v.x; acc[x][y + 1] = v.y;
          }
        } else {
          if (store) *reinterpret_cast<double2*>(p) = make_double2(acc[x][y], acc[x][y + 1]);
          else {
            const double2 v = *reinterpret_cast<const double2*>(p);
            acc[x][y] = v.x; acc[x][y + 1] = v.y;
          }
        }
        continue;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (r < rows && c + e < cols) {
          if (store) p[e] = acc[x][y + e]; else acc[x][y + e] = p[e];
        } else if (!store) {
          acc[x][y + e] = T(0);
        }
      }
    }
}

// The store of tile_io into a bf16 output: each element rounded once.
__device__ __forceinline__ void tile_io(float (&acc)[4][4], __nv_bfloat16* base, int64_t stride,
                                        int r0, int c0, int rows, int cols, int tid, bool) {
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int r = r0 + Engine<float>::row(tid, x, y), c = c0 + Engine<float>::col(tid, x, y);
      if (r < rows && c < cols) store_as(base + static_cast<int64_t>(r) * stride + c, acc[x][y]);
    }
}

template <typename T>
__device__ __forceinline__ bool aligned16(const T* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Whether a source's tiles can be staged a vector a copy: float / double
// rows in 16 B copies (base and row stride 16 B aligned), bf16 rows four
// values (8 B) a load (base and row stride 8 B aligned).
template <typename S>
__device__ __forceinline__ bool vec_rows(const S* p, int64_t stride) {
  constexpr int64_t V = sizeof(S) == 2 ? 8 : 16;
  return (reinterpret_cast<uintptr_t>(p) % V) == 0 && (stride * static_cast<int64_t>(sizeof(S))) % V == 0;
}

// Stages rows [r0, r0 + R) and columns [c0, c0 + CC) of a row-major source
// (row r at base + r * stride) into S (row stride ld) by cp.async, zeros
// where a row is >= rows or a column >= cols.  vec: 16-byte copies (base
// and stride 16 B aligned, c0 a multiple of 16 B), else an element a copy.
template <typename T, int R, int CC>
__device__ __forceinline__ void stage_tile(T* S, int ld, const T* base, int64_t stride, int r0,
                                           int c0, int rows, int cols, bool vec, int tid) {
  if (vec) {
    constexpr int PV = 16 / sizeof(T);
    constexpr int ROWV = CC / PV;
    for (int e = tid; e < R * ROWV; e += THREADS) {
      const int r = e / ROWV, c = (e % ROWV) * PV;
      const int rr = r0 + r, cc = c0 + c;
      int valid = rr < rows ? cols - cc : 0;
      valid = valid < 0 ? 0 : (valid > PV ? PV : valid);
      const T* src = valid ? base + static_cast<int64_t>(rr) * stride + cc : base;
      cp_async<16>(S + r * ld + c, src, valid * static_cast<int>(sizeof(T)));
    }
  } else {
    for (int e = tid; e < R * CC; e += THREADS) {
      const int r = e / CC, c = e % CC;
      const int rr = r0 + r, cc = c0 + c;
      const bool in = rr < rows && cc < cols;
      cp_async<sizeof(T)>(S + r * ld + c, in ? base + static_cast<int64_t>(rr) * stride + cc : base,
                          in ? static_cast<int>(sizeof(T)) : 0);
    }
  }
}

// stage_tile of a bf16 source into a float tile: the same tile, widened as
// it is loaded (cp.async copies bytes and cannot convert), by plain loads
// and shared-memory stores; vec: four values (8 B) a load.  Its stores are
// ordered before the tile's readers by the pipeline's barriers.
template <typename T, int R, int CC>
__device__ __forceinline__ void stage_tile(float* S, int ld, const __nv_bfloat16* base,
                                           int64_t stride, int r0, int c0, int rows, int cols,
                                           bool vec, int tid) {
  if (vec) {
    constexpr int ROWV = CC / 4;
    for (int e = tid; e < R * ROWV; e += THREADS) {
      const int r = e / ROWV, c = (e % ROWV) * 4;
      const int rr = r0 + r, cc = c0 + c;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (rr < rows && cc < cols) {
        const __nv_bfloat16* src = base + static_cast<int64_t>(rr) * stride + cc;
        if (cc + 4 <= cols) {
          const uint2 raw = *reinterpret_cast<const uint2*>(src);
          const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
          const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
          v = make_float4(lo.x, lo.y, hi.x, hi.y);
        } else {
          v.x = as_acc(src[0]);
          if (cc + 1 < cols) v.y = as_acc(src[1]);
          if (cc + 2 < cols) v.z = as_acc(src[2]);
        }
      }
      *reinterpret_cast<float4*>(S + r * ld + c) = v;
    }
  } else {
    for (int e = tid; e < R * CC; e += THREADS) {
      const int r = e / CC, c = e % CC;
      const int rr = r0 + r, cc = c0 + c;
      S[r * ld + c] = rr < rows && cc < cols
          ? as_acc(base[static_cast<int64_t>(rr) * stride + cc]) : 0.f;
    }
  }
}

// Runs `steps` steps NS stages deep: stage(s, buf) issues step s's
// cp.async copies into stage buffer buf (s % NS), work(s, buf) consumes
// them.  The copies of steps s + 1 .. s + NS - 1 are in flight during step
// s's work; one barrier a step.  Starts with a barrier (whatever read the
// stages before is done); the caller syncs before reusing them.
template <int NS, typename Stage, typename Work>
__device__ __forceinline__ void pipeline(int steps, Stage stage, Work work) {
  __syncthreads();
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < steps) stage(s, s);
    cp_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_wait<NS - 2>();                          // step s's copies have landed
    __syncthreads();                            // ... everyone's; step s - 1's work done
    if (s + NS - 1 < steps) stage(s + NS - 1, (s + NS - 1) % NS);
    cp_commit();
    work(s, s % NS);
  }
}

struct Plane {
  int64_t c, bh, bi, bhc, t0;
  int hh, gi;
};

__device__ __forceinline__ Plane plane_of(int64_t l, int h, int g, int q) {
  Plane pl;
  const int64_t nc = l / q;
  pl.bhc = blockIdx.x;
  pl.c = pl.bhc % nc;
  pl.bh = pl.bhc / nc;
  pl.hh = static_cast<int>(pl.bh % h);
  pl.bi = pl.bh / h;
  pl.gi = pl.hh / (h / g);
  pl.t0 = pl.c * q;
  return pl;
}

// Launch 1: local[b, h, c] (p, n) = sum_i e^{cum_i} dY_iᵀ C_i, over the
// chunk's rows in k-steps of 32 (dY and C tiles k-major, e^{cum} a k-scale).
template <typename T, typename S>
__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_local_kernel(const S* __restrict__ dy, const S* __restrict__ Cm,
                     const T* __restrict__ cum, T* __restrict__ local, int64_t l, int h,
                     int p, int g, int n, int q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* st = reinterpret_cast<T*>(smem_raw);   // NS stages: dY (KC, LDK) and C (KC, LDK)
  T* sc = st + NS * STAGE;                  // NS x KC scales e^{cum}
  const Plane pl = plane_of(l, h, g, q);
  const int p0 = blockIdx.y * TILE, n0 = blockIdx.z * TILE;
  const int tid = threadIdx.x;
  const int64_t xrow = static_cast<int64_t>(h) * p, brow = static_cast<int64_t>(g) * n;
  const S* dybase = dy + (pl.bi * l + pl.t0) * xrow + static_cast<int64_t>(pl.hh) * p;
  const S* cbase = Cm + (pl.bi * l + pl.t0) * brow + static_cast<int64_t>(pl.gi) * n;
  const T* cumb = cum + pl.bh * l + pl.t0;
  const bool vx = vec_rows(dybase, xrow);
  const bool vb = vec_rows(cbase, brow);
  T acc[4][4];
  zero(acc);
  pipeline<NS>(
      (q + KC - 1) / KC,
      [&](int s, int buf) {
        T* A = st + buf * STAGE;
        stage_tile<T, KC, TILE>(A, LDK, dybase, xrow, s * KC, p0, q, p, vx, tid);
        stage_tile<T, KC, TILE>(A + KC * LDK, LDK, cbase, brow, s * KC, n0, q, n, vb, tid);
        if (tid < KC) sc[buf * KC + tid] = s * KC + tid < q ? exp_t(cumb[s * KC + tid]) : T(0);
      },
      [&](int, int buf) {
        const T* A = st + buf * STAGE;
        Engine<T>::template mma<true, true, KC>(acc, A, LDK, A + KC * LDK, LDK, sc + buf * KC,
                                                tid);
      });
  tile_io(acc, local + pl.bhc * p * static_cast<int64_t>(n), n, p0, n0, p, n, tid, true);
}

// Launch 2: the reverse pass over the chunks, one thread per state entry r
// of one (b, h) plane.  dso[c] = the gradient of the state leaving chunk c;
// the carry dS_in[c] = e^{cum_last[c]} dso[c] + local[c]; dinit = dS_in[0].
template <typename T>
__global__ void ssd_bwd_state_pass_kernel(const T* __restrict__ local, T* __restrict__ dso,
                                          const T* __restrict__ cum,
                                          const T* __restrict__ dfinal, T* __restrict__ dinit,
                                          int64_t l, int pn, int q, int nc) {
  const int r = blockIdx.y * blockDim.x + threadIdx.x;
  if (r >= pn) return;
  const int64_t bh = blockIdx.x;
  T run = dfinal ? dfinal[bh * pn + r] : T(0);
  for (int c = nc - 1; c >= 0; --c) {
    const int64_t idx = (bh * nc + c) * pn + r;
    dso[idx] = run;
    run = run * exp_t(cum[bh * l + static_cast<int64_t>(c) * q + q - 1]) + local[idx];
  }
  if (dinit) dinit[bh * pn + r] = run;
}

// The sums of row and of column tid / 4 of W (all 256 threads: four a row,
// a quarter each in index order, the quarters added in a fixed butterfly),
// in every one of the four threads.
template <typename T>
__device__ __forceinline__ void tile_sums(const T* W, int tid, T& row, T& col) {
  const int i = tid >> 2, q16 = (tid & 3) * 16;
  row = col = T(0);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    row += W[i * LDW + q16 + k];
    col += W[(q16 + k) * LDW + i];
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    row += __shfl_xor_sync(0xffffffffu, row, off);
    col += __shfl_xor_sync(0xffffffffu, col, off);
  }
}

// Launch 3: key tile J of one chunk, in two phases.
//   1. For each query tile I >= J, the pair's G_IJ = C_I B_Jᵀ and dY_I X_Jᵀ
//      (k-steps over n, then over p), once: M_IJ and (G ∘ L)_IJ into mh and
//      gh ((b h nc, pairs, 64, 64) scratch), the pair's row sums of G ∘ M
//      into rh (b h nc, pairs, 64) for launch 4, its column sums into
//      dcum's key part.
//   2. For each 64-column slice of dB_J and of dX_J: the dS_out term's
//      k-steps (dB_J: X_J dS_out over p; dX_J: B_J dS_outᵀ over n), then
//      one step a pair, M_IJᵀ C_I (dB) or (G ∘ L)_IJᵀ dY_I (dX) over the
//      pair's 64 query rows; the slice is stored once (dx (b, l, h, p),
//      per-head dbh (b, l, h, n)), with dcum's dS_out part -sum_n B dB.
// Each phase is one pipeline of staged steps; the key part of dcum goes to
// dck (b, h, l).
template <typename T, typename S>
__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_key_kernel(const S* __restrict__ xd, const S* __restrict__ dy,
                   const S* __restrict__ Bm, const S* __restrict__ Cm,
                   const T* __restrict__ cum, const T* __restrict__ entering,
                   const T* __restrict__ fstate, const T* __restrict__ dso, int has_dfinal,
                   T* __restrict__ dbh, S* __restrict__ dx, T* __restrict__ dck,
                   T* __restrict__ mh, T* __restrict__ gh, T* __restrict__ rh, int64_t l, int h,
                   int p, int g, int n, int q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* st = reinterpret_cast<T*>(smem_raw);   // NS stages of STAGE
  T* W = st + NS * STAGE;                   // (TILE, LDW) the tile being summed
  T* cq = W + TILE * LDW;                   // (TILE) cum of the query rows
  T* ck = cq + TILE;                        // (TILE) cum of the key rows
  T* kacc = ck + TILE;                      // (TILE) dcum's key part
  T* red = kacc + TILE;                     // (THREADS / 32) warp sums

  const Plane pl = plane_of(l, h, g, q);
  const int64_t nc = l / q;
  const int J = blockIdx.y, j0 = J * TILE, nt = gridDim.y;
  const int tid = threadIdx.x;
  const int64_t xrow = static_cast<int64_t>(h) * p, brow = static_cast<int64_t>(g) * n;
  const int64_t hrow = static_cast<int64_t>(h) * n;
  const int64_t pn = static_cast<int64_t>(p) * n;
  const S* xbase = xd + (pl.bi * l + pl.t0) * xrow + static_cast<int64_t>(pl.hh) * p;
  const S* dybase = dy + (pl.bi * l + pl.t0) * xrow + static_cast<int64_t>(pl.hh) * p;
  S* dxbase = dx + (pl.bi * l + pl.t0) * xrow + static_cast<int64_t>(pl.hh) * p;
  const S* bbase = Bm + (pl.bi * l + pl.t0) * brow + static_cast<int64_t>(pl.gi) * n;
  const S* cbase = Cm + (pl.bi * l + pl.t0) * brow + static_cast<int64_t>(pl.gi) * n;
  T* dbbase = dbh + (pl.bi * l + pl.t0) * hrow + static_cast<int64_t>(pl.hh) * n;
  const T* cumb = cum + pl.bh * l + pl.t0;
  const T* ds_out = dso + pl.bhc * pn;                               // (p, n)
  const T* s_out = pl.c + 1 < nc ? entering + (pl.bhc + 1) * pn : fstate + pl.bh * pn;
  const bool has_dso = pl.c + 1 < nc || has_dfinal;
  const int n_ns = (n + TILE - 1) / TILE, n_ps = (p + TILE - 1) / TILE;
  const int kn = (n + KC - 1) / KC, kp = (p + KC - 1) / KC;
  const int np = nt - J;                    // the block's pairs: I = J .. nt - 1
  const int64_t pair0 = pl.bhc * (static_cast<int64_t>(nt) * (nt + 1) / 2);
  const T cum_last = cumb[q - 1];
  const bool vx = vec_rows(xbase, xrow) && vec_rows(dybase, xrow);
  const bool vb = vec_rows(bbase, brow) && vec_rows(cbase, brow);
  const bool vs = aligned16(ds_out) && (n * sizeof(T)) % 16 == 0;
  auto pair_of = [&](int I) { return pair0 + static_cast<int64_t>(I) * (I + 1) / 2 + J; };

  if (tid < TILE) {
    ck[tid] = j0 + tid < q ? cumb[j0 + tid] : T(0);
    kacc[tid] = T(0);
  }
  // <dS_out, S_out> at the chunk's last row (the block that holds it)
  if (has_dso && j0 <= q - 1 && q - 1 < j0 + TILE) {
    T v = T(0);
    for (int64_t r = tid; r < pn; r += THREADS) v += ds_out[r] * s_out[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if ((tid & 31) == 0) red[tid >> 5] = v;
    __syncthreads();
    if (tid == 0) {
      T total = T(0);
      for (int w = 0; w < THREADS / 32; ++w) total += red[w];
      kacc[q - 1 - j0] += total;
    }
  }

  T acc[4][4], gacc[4][4];
  zero(acc);
  zero(gacc);
  // phase 1: each pair's G and dY Xᵀ
  const int per_pair = kn + kp;
  pipeline<NS>(
      np * per_pair,
      [&](int s, int buf) {
        const int i0 = (J + s / per_pair) * TILE, k = s % per_pair;
        T* A = st + buf * STAGE;
        if (k < kn) {                        // C_I and B_J (64, 32)
          stage_tile<T, TILE, KC>(A, LDR, cbase, brow, i0, k * KC, q, n, vb, tid);
          stage_tile<T, TILE, KC>(A + TILE * LDR, LDR, bbase, brow, j0, k * KC, q, n, vb, tid);
        } else {                             // dY_I and X_J (64, 32)
          stage_tile<T, TILE, KC>(A, LDR, dybase, xrow, i0, (k - kn) * KC, q, p, vx, tid);
          stage_tile<T, TILE, KC>(A + TILE * LDR, LDR, xbase, xrow, j0, (k - kn) * KC, q, p, vx,
                                  tid);
        }
      },
      [&](int s, int buf) {
        const int I = J + s / per_pair, i0 = I * TILE, k = s % per_pair;
        const T* A = st + buf * STAGE;
        if (k < kn) {
          if (k == 0 && tid < TILE) cq[tid] = i0 + tid < q ? cumb[i0 + tid] : T(0);
          Engine<T>::template mma<false, false, KC>(gacc, A, LDR, A + TILE * LDR, LDR, nullptr,
                                                    tid);
          return;
        }
        Engine<T>::template mma<false, false, KC>(acc, A, LDR, A + TILE * LDR, LDR, nullptr, tid);
        if (k + 1 < per_pair) return;
        // M = (dY Xᵀ) ∘ L, G ∘ L and G ∘ M (above the diagonal 0, its decay
        // never evaluated; cq was written at the pair's first step)
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            const int r = Engine<T>::row(tid, x, y), c = Engine<T>::col(tid, x, y);
            const int i = i0 + r, j = j0 + c;
            const T lv = i >= j && i < q ? exp_t(cq[r] - ck[c]) : T(0);
            const T m = acc[x][y] * lv;
            W[r * LDW + c] = gacc[x][y] * m;
            acc[x][y] = m;
            gacc[x][y] *= lv;
          }
        const int64_t pair = pair_of(I);
        tile_io(acc, mh + pair * PAIR, TILE, 0, 0, TILE, TILE, tid, true);
        tile_io(gacc, gh + pair * PAIR, TILE, 0, 0, TILE, TILE, tid, true);
        zero(acc);
        zero(gacc);
        __syncthreads();
        T row, col;
        tile_sums(W, tid, row, col);
        if ((tid & 3) == 0) {
          rh[pair * TILE + (tid >> 2)] = row;
          kacc[tid >> 2] -= col;
        }
      });
  __threadfence_block();                     // mh, gh written before phase 2 reads them

  // phase 2: the slices of dB_J, then of dX_J; a pair's product over its
  // 64 query rows in two k-steps of 32
  const int sdb = has_dso ? kp : 0, sdx = has_dso ? kn : 0;
  const int per_b = sdb + 2 * np, per_x = sdx + 2 * np;
  auto decode = [&](int s, bool& is_b, int& c0, int& k) {
    is_b = s < n_ns * per_b;
    if (!is_b) s -= n_ns * per_b;
    const int per = is_b ? per_b : per_x;
    c0 = (s / per) * TILE;
    k = s % per;
  };
  pipeline<NS>(
      n_ns * per_b + n_ps * per_x,
      [&](int s, int buf) {
        bool is_b;
        int c0, k;
        decode(s, is_b, c0, k);
        T* A = st + buf * STAGE;
        const int ks = is_b ? sdb : sdx;
        if (k < ks) {
          if (is_b) {                        // X_J (64, 32) and dS_out (32, 64)
            stage_tile<T, TILE, KC>(A, LDR, xbase, xrow, j0, k * KC, q, p, vx, tid);
            stage_tile<T, KC, TILE>(A + TILE * LDR, LDK, ds_out, n, k * KC, c0, p, n, vs, tid);
          } else {                           // B_J (64, 32) and dS_out (64, 32)
            stage_tile<T, TILE, KC>(A, LDR, bbase, brow, j0, k * KC, q, n, vb, tid);
            stage_tile<T, TILE, KC>(A + TILE * LDR, LDR, ds_out, n, c0, k * KC, p, n, vs, tid);
          }
          return;
        }
        // half h of pair I: rows [h 32, h 32 + 32) of M_IJ or (G ∘ L)_IJ and
        // of C_I's or dY_I's slice, (32, 64) each
        const int I = J + (k - ks) / 2, r0 = ((k - ks) & 1) * KC;
        stage_tile<T, KC, TILE>(A, LDK, (is_b ? mh : gh) + pair_of(I) * PAIR + r0 * TILE, TILE,
                                0, 0, KC, TILE, true, tid);
        if (is_b) stage_tile<T, KC, TILE>(A + KC * LDK, LDK, cbase, brow, I * TILE + r0, c0, q,
                                          n, vb, tid);
        else stage_tile<T, KC, TILE>(A + KC * LDK, LDK, dybase, xrow, I * TILE + r0, c0, q, p,
                                     vx, tid);
      },
      [&](int s, int buf) {
        bool is_b;
        int c0, k;
        decode(s, is_b, c0, k);
        const T* A = st + buf * STAGE;
        const int ks = is_b ? sdb : sdx;
        if (k < ks) {                        // the dS_out term
          if (is_b)
            Engine<T>::template mma<false, true, KC>(acc, A, LDR, A + TILE * LDR, LDK, nullptr,
                                                     tid);
          else
            Engine<T>::template mma<false, false, KC>(acc, A, LDR, A + TILE * LDR, LDR, nullptr,
                                                      tid);
          if (k + 1 < ks) return;
          if (!is_b) {
            each(acc, tid, [&](int r, int, T& v) { v *= exp_t(cum_last - ck[r]); });
            return;
          }
          each(acc, tid, [&](int r, int c, T& v) {
            v *= exp_t(cum_last - ck[r]);
            const int j = j0 + r, kk = c0 + c;
            W[r * LDW + c] = j < q && kk < n ? v * as_acc(bbase[static_cast<int64_t>(j) * brow + kk])
                                             : T(0);
          });
          __syncthreads();
          T row, col;
          tile_sums(W, tid, row, col);
          if ((tid & 3) == 0) kacc[tid >> 2] -= row;
          return;
        }
        // dB_J += M_IJᵀ C_I or dX_J += (G ∘ L)_IJᵀ dY_I: A[j][i] is tile[i][j]
        Engine<T>::template mma<true, true, KC>(acc, A, LDK, A + KC * LDK, LDK, nullptr, tid);
        if (k + 1 < ks + 2 * np) return;
        if (is_b) tile_io(acc, dbbase, hrow, j0, c0, q, n, tid, true);
        else tile_io(acc, dxbase, xrow, j0, c0, q, p, tid, true);
        zero(acc);
      });
  __syncthreads();
  if (tid < TILE && j0 + tid < q) dck[pl.bh * l + pl.t0 + j0 + tid] = kacc[tid];
}

// Launch 4: query tile I of one chunk.  dC_I (per head, into dch (b, l, h,
// n)) from the state term and launch 3's M_IJ, and the query part of dcum
// (into dcq (b, h, l)) from the state term and launch 3's row sums.  One
// pipeline: for each n-slice the state term's k-steps over p, then one
// step a key tile J <= I (M_IJ and B_J's slice).
template <typename T, typename S>
__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_query_kernel(const S* __restrict__ dy, const S* __restrict__ Bm,
                     const S* __restrict__ Cm, const T* __restrict__ cum,
                     const T* __restrict__ entering, int has_init, const T* __restrict__ mh,
                     const T* __restrict__ rh, T* __restrict__ dch, T* __restrict__ dcq,
                     int64_t l, int h, int p, int g, int n, int q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* st = reinterpret_cast<T*>(smem_raw);   // NS stages of STAGE
  T* W = st + NS * STAGE;                   // (TILE, LDW) the tile being summed
  T* cq = W + TILE * LDW;                   // (TILE) cum of the query rows

  const Plane pl = plane_of(l, h, g, q);
  const int nt = gridDim.y;
  const int I = nt - 1 - blockIdx.y, i0 = I * TILE;   // the most key tiles first
  const int tid = threadIdx.x;
  const int64_t xrow = static_cast<int64_t>(h) * p, brow = static_cast<int64_t>(g) * n;
  const int64_t hrow = static_cast<int64_t>(h) * n;
  const S* dybase = dy + (pl.bi * l + pl.t0) * xrow + static_cast<int64_t>(pl.hh) * p;
  const S* bbase = Bm + (pl.bi * l + pl.t0) * brow + static_cast<int64_t>(pl.gi) * n;
  const S* cbase = Cm + (pl.bi * l + pl.t0) * brow + static_cast<int64_t>(pl.gi) * n;
  T* dcbase = dch + (pl.bi * l + pl.t0) * hrow + static_cast<int64_t>(pl.hh) * n;
  const T* cumb = cum + pl.bh * l + pl.t0;
  const T* s_in = entering + pl.bhc * p * static_cast<int64_t>(n);   // (p, n)
  const bool has_state = pl.c > 0 || has_init;
  const int n_ns = (n + TILE - 1) / TILE, kp = (p + KC - 1) / KC;
  const int64_t pair0 = pl.bhc * (static_cast<int64_t>(nt) * (nt + 1) / 2) +
                        static_cast<int64_t>(I) * (I + 1) / 2;
  const bool vx = vec_rows(dybase, xrow);
  const bool vb = vec_rows(bbase, brow);
  const bool vs = aligned16(s_in) && (n * sizeof(T)) % 16 == 0;
  const int ks = has_state ? kp : 0;        // state k-steps of a slice
  const int per_slice = ks + 2 * (I + 1);   // a pair in two k-steps of 32

  if (tid < TILE) cq[tid] = i0 + tid < q ? cumb[i0 + tid] : T(0);
  T racc = T(0);                            // dcum's query part of row tid / 4
  T acc[4][4];
  zero(acc);
  pipeline<NS>(
      n_ns * per_slice,
      [&](int s, int buf) {
        const int ns = (s / per_slice) * TILE, k = s % per_slice;
        T* A = st + buf * STAGE;
        if (k < ks) {                        // dY_I (64, 32) and S_in (32, 64)
          stage_tile<T, TILE, KC>(A, LDR, dybase, xrow, i0, k * KC, q, p, vx, tid);
          stage_tile<T, KC, TILE>(A + TILE * LDR, LDK, s_in, n, k * KC, ns, p, n, vs, tid);
        } else {                             // half h of pair J: M_IJ (64, 32), B_J (32, 64)
          const int J = (k - ks) / 2, c0 = ((k - ks) & 1) * KC;
          stage_tile<T, TILE, KC>(A, LDR, mh + (pair0 + J) * PAIR, TILE, 0, c0, TILE, TILE, true,
                                  tid);
          stage_tile<T, KC, TILE>(A + TILE * LDR, LDK, bbase, brow, J * TILE + c0, ns, q, n, vb,
                                  tid);
        }
      },
      [&](int s, int buf) {
        const int ns = (s / per_slice) * TILE, k = s % per_slice;
        const T* A = st + buf * STAGE;
        if (k < ks) {                        // dC_I = diag(e^{cum}) dY_I S_in
          Engine<T>::template mma<false, true, KC>(acc, A, LDR, A + TILE * LDR, LDK, nullptr,
                                                   tid);
          if (k + 1 < ks) return;
          each(acc, tid, [&](int r, int c, T& v) {
            v *= exp_t(cq[r]);
            const int i = i0 + r, kk = ns + c;
            W[r * LDW + c] = i < q && kk < n ? v * as_acc(cbase[static_cast<int64_t>(i) * brow + kk])
                                             : T(0);
          });
          __syncthreads();
          T row, col;
          tile_sums(W, tid, row, col);
          racc += row;
          return;
        }
        // dC_I += M_IJ B_J
        Engine<T>::template mma<false, true, KC>(acc, A, LDR, A + TILE * LDR, LDK, nullptr, tid);
        if (k + 1 < per_slice) return;
        tile_io(acc, dcbase, hrow, i0, ns, q, n, tid, true);
        zero(acc);
      });
  const int r = tid >> 2;                   // racc is row r's in its four threads
  if ((tid & 3) == 0 && i0 + r < q) {
    for (int J = 0; J <= I; ++J) racc += rh[(pair0 + J) * TILE + r];
    dcq[pl.bh * l + pl.t0 + i0 + r] = racc;
  }
}

// Launch 5.  blockIdx.y 0: dad (b, l, h), one warp a (b, h, chunk), the
// reverse running sum of dcq + dck within the chunk (first in launch
// order); blockIdx.y 1 / 2: dB / dC (b, l, g, n) = the per-head dbh / dch
// summed over the h / g heads of the group in ascending order, one thread
// an element.
template <typename T, typename S>
__global__ void ssd_bwd_finish_kernel(const T* __restrict__ dcq, const T* __restrict__ dck,
                                      T* __restrict__ dad, const T* __restrict__ dbh,
                                      const T* __restrict__ dch, S* __restrict__ dB,
                                      S* __restrict__ dC, int64_t b, int64_t l, int h, int g,
                                      int n, int q) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (blockIdx.y > 0) {
    const int64_t gn = static_cast<int64_t>(g) * n;
    if (idx >= b * l * gn) return;
    const int64_t bt = idx / gn;
    const int rem = static_cast<int>(idx % gn);
    const int gi = rem / n, k = rem % n, hg = h / g;
    const T* src = (blockIdx.y == 1 ? dbh : dch) + (bt * h + static_cast<int64_t>(gi) * hg) * n + k;
    T s = T(0);
    for (int j = 0; j < hg; ++j) s += src[static_cast<int64_t>(j) * n];
    store_as((blockIdx.y == 1 ? dB : dC) + idx, s);
    return;
  }
  // dad: one warp a (b, h, chunk), the chunk's rows in segments of 256 from
  // the last, 8 consecutive rows a lane: the lane's suffix sums, then the
  // totals of the lanes after it (a fixed shuffle order), then the carry of
  // the segments after this one
  const int64_t nc = l / q;
  const int64_t wc = idx >> 5;               // the warp's (b, h, chunk)
  const int lane = threadIdx.x & 31;
  if (wc >= b * h * nc) return;
  const int64_t bh = wc / nc, c = wc % nc;
  const int64_t bi = bh / h;
  const int hh = static_cast<int>(bh % h);
  const T* cq_ = dcq + bh * l + c * q;
  const T* ck_ = dck + bh * l + c * q;
  T* out = dad + (bi * l + c * q) * h + hh;
  constexpr int R = 8;
  T carry = T(0);
  for (int seg = ((q - 1) / (32 * R)) * 32 * R; seg >= 0; seg -= 32 * R) {
    const int r0 = seg + lane * R;
    T v[R];
#pragma unroll
    for (int u = 0; u < R; ++u) v[u] = r0 + u < q ? cq_[r0 + u] + ck_[r0 + u] : T(0);
#pragma unroll
    for (int u = R - 2; u >= 0; --u) v[u] += v[u + 1];   // the lane's suffix sums
    T x = v[0];                                // lanes lane .. 31: an inclusive suffix scan
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T y = __shfl_down_sync(0xffffffffu, x, off);
      if (lane + off < 32) x += y;
    }
    const T next = __shfl_down_sync(0xffffffffu, x, 1);
    const T after = lane < 31 ? next : T(0);   // the lanes after this one
    const T seg_total = __shfl_sync(0xffffffffu, x, 0);
#pragma unroll
    for (int u = 0; u < R; ++u)
      if (r0 + u < q) out[static_cast<int64_t>(r0 + u) * h] = carry + (after + v[u]);
    carry += seg_total;
  }
}

// Dynamic shared memory of launches 1, 3 and 4 (elements).
constexpr int LOCAL_SMEM = NS * (STAGE + KC);
constexpr int KEY_SMEM = NS * STAGE + TILE * LDW + 3 * TILE + THREADS / 32;
constexpr int QUERY_SMEM = NS * STAGE + TILE * LDW + TILE;

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) cudaGetLastError();   // clear it: a later launch must not report it
  return err;
}

bool bad_shape(int64_t b, int64_t l, int h, int p, int g, int n, int q) {
  if (b <= 0 || h <= 0 || p <= 0 || g <= 0 || n <= 0 || q <= 0 || l < q ||
      l % q != 0 || h % g != 0) {
    return true;
  }
  const int64_t planes = b * h * (l / q);
  return planes > 2147483647 || b * h > 2147483647 ||
         static_cast<int64_t>(p) * n > 2147483647 - THREADS ||
         (static_cast<int64_t>(p) * n + THREADS - 1) / THREADS > 65535 ||
         (p + TILE - 1) / TILE > 65535 || (n + TILE - 1) / TILE > 65535 ||
         (q + TILE - 1) / TILE > 65535 ||
         (b * l * g * n + THREADS - 1) / THREADS > 2147483647;
}

template <typename T, typename S>
cudaError_t local_term(const void* dy, const void* C, const void* cum, void* local, int64_t b,
                       int64_t l, int h, int p, int g, int n, int q, cudaStream_t st) {
  const size_t smem = LOCAL_SMEM * sizeof(T);
  cudaError_t err = set_smem(ssd_bwd_local_kernel<T, S>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(b * h * (l / q)), static_cast<unsigned>((p + TILE - 1) / TILE),
                  static_cast<unsigned>((n + TILE - 1) / TILE));
  ssd_bwd_local_kernel<T, S><<<grid, THREADS, smem, st>>>(
      static_cast<const S*>(dy), static_cast<const S*>(C), static_cast<const T*>(cum),
      static_cast<T*>(local), l, h, p, g, n, q);
  return cudaGetLastError();
}

template <typename T>
cudaError_t state_pass(const void* local, void* dso, const void* cum, const void* dfinal,
                       void* dinit, int64_t b, int64_t l, int h, int p, int n, int q,
                       cudaStream_t st) {
  const int pn = p * n;
  const dim3 grid(static_cast<unsigned>(b * h), static_cast<unsigned>((pn + THREADS - 1) / THREADS));
  ssd_bwd_state_pass_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(local), static_cast<T*>(dso), static_cast<const T*>(cum),
      static_cast<const T*>(dfinal), static_cast<T*>(dinit), l, pn, q, static_cast<int>(l / q));
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t key_side(const void* xd, const void* dy, const void* B, const void* C,
                     const void* cum, const void* entering, const void* fstate, const void* dso,
                     int has_dfinal, void* dbh, void* dx, void* dck, void* mh, void* gh,
                     void* rh, int64_t b, int64_t l, int h, int p, int g, int n, int q,
                     cudaStream_t st) {
  const size_t smem = KEY_SMEM * sizeof(T);
  cudaError_t err = set_smem(ssd_bwd_key_kernel<T, S>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(b * h * (l / q)), static_cast<unsigned>((q + TILE - 1) / TILE));
  ssd_bwd_key_kernel<T, S><<<grid, THREADS, smem, st>>>(
      static_cast<const S*>(xd), static_cast<const S*>(dy), static_cast<const S*>(B),
      static_cast<const S*>(C), static_cast<const T*>(cum), static_cast<const T*>(entering),
      static_cast<const T*>(fstate), static_cast<const T*>(dso), has_dfinal,
      static_cast<T*>(dbh), static_cast<S*>(dx), static_cast<T*>(dck), static_cast<T*>(mh),
      static_cast<T*>(gh), static_cast<T*>(rh), l, h, p, g, n, q);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t query_side(const void* dy, const void* B, const void* C, const void* cum,
                       const void* entering, int has_init, const void* mh, const void* rh,
                       void* dch, void* dcq, int64_t b, int64_t l, int h, int p, int g, int n,
                       int q, cudaStream_t st) {
  const size_t smem = QUERY_SMEM * sizeof(T);
  cudaError_t err = set_smem(ssd_bwd_query_kernel<T, S>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(b * h * (l / q)), static_cast<unsigned>((q + TILE - 1) / TILE));
  ssd_bwd_query_kernel<T, S><<<grid, THREADS, smem, st>>>(
      static_cast<const S*>(dy), static_cast<const S*>(B), static_cast<const S*>(C),
      static_cast<const T*>(cum), static_cast<const T*>(entering), has_init,
      static_cast<const T*>(mh), static_cast<const T*>(rh), static_cast<T*>(dch),
      static_cast<T*>(dcq), l, h, p, g, n, q);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t finish(const void* dcq, const void* dck, void* dad, const void* dbh, const void* dch,
                   void* dB, void* dC, int64_t b, int64_t l, int h, int g, int n, int q,
                   cudaStream_t st) {
  const int64_t elems = b * l * g * n, lanes = 32 * b * h * (l / q);
  const int64_t most = elems > lanes ? elems : lanes;
  const dim3 grid(static_cast<unsigned>((most + THREADS - 1) / THREADS), 3);
  ssd_bwd_finish_kernel<T, S><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(dcq), static_cast<const T*>(dck), static_cast<T*>(dad),
      static_cast<const T*>(dbh), static_cast<const T*>(dch), static_cast<S*>(dB),
      static_cast<S*>(dC), b, l, h, g, n, q);
  return cudaGetLastError();
}

bool bad_dtype(int dtype) { return dtype != kFloat32 && dtype != kFloat64 && dtype != kBfloat16; }

// The entry's form by dtype code: F(tag) with tag's value types (acc, storage).
template <typename F>
cudaError_t by_dtype(int dtype, F f) {
  if (dtype == kFloat64) return f(double{}, double{});
  if (dtype == kBfloat16) return f(float{}, __nv_bfloat16{});
  return f(float{}, float{});
}

}  // namespace

extern "C" {

// Every entry point takes the element types by `dtype` (ssd_mma.cuh's
// codes: 0 all float32; 1 all float64; 2 the bf16 form, xd / dy / B / C /
// dx / dB / dC bf16 and the rest float32), runs on `stream` (the caller
// makes its device current) and returns the cudaError_t of its attribute
// call or launch.  Layouts: xd, dy, dx (b, l, h, p); ad, dad (b, l, h); B,
// C, dB, dC (b, l, g, n); dbh, dch (b, l, h, n) scratch; cum, dcq, dck (b,
// h, l); entering, local, dso (b, h, l / chunk, p, n); fstate, dfinal,
// dinit (b, h, p, n); mh, gh (b h (l / chunk), pairs, 64, 64) and rh (b h
// (l / chunk), pairs, 64) scratch, pairs = t (t + 1) / 2 for t = ceil(chunk
// / 64).

// Launch 1: local (b, h, nc, p, n) from dy, C and the forward's cum.
int repro_ssd_bwd_local(const void* dy, const void* C, const void* cum, void* local, int64_t b,
                        int64_t l, int h, int p, int g, int n, int chunk, int dtype,
                        void* stream) {
  if (bad_shape(b, l, h, p, g, n, chunk) || bad_dtype(dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_dtype(dtype, [&](auto t, auto s) {
    return local_term<decltype(t), decltype(s)>(dy, C, cum, local, b, l, h, p, g, n, chunk, st);
  }));
}

// Launch 2: dso (b, h, nc, p, n) and dinit (nullable) from local, cum and
// dfinal (nullable: zero).
int repro_ssd_bwd_state_pass(const void* local, void* dso, const void* cum, const void* dfinal,
                             void* dinit, int64_t b, int64_t l, int h, int p, int n, int chunk,
                             int dtype, void* stream) {
  if (bad_shape(b, l, h, p, 1, n, chunk) || bad_dtype(dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == kFloat64
      ? state_pass<double>(local, dso, cum, dfinal, dinit, b, l, h, p, n, chunk, st)
      : state_pass<float>(local, dso, cum, dfinal, dinit, b, l, h, p, n, chunk, st));
}

// Launch 3: dbh, dx, dck, the handed mh, rh and its own gh; fstate is the forward's
// final state, has_dfinal 1 when the final state has a gradient (dso's last
// chunk is then it).
int repro_ssd_bwd_key(const void* xd, const void* dy, const void* B, const void* C,
                      const void* cum, const void* entering, const void* fstate, const void* dso,
                      int has_dfinal, void* dbh, void* dx, void* dck, void* mh, void* gh,
                      void* rh, int64_t b, int64_t l, int h, int p, int g, int n, int chunk,
                      int dtype, void* stream) {
  if (bad_shape(b, l, h, p, g, n, chunk) || bad_dtype(dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_dtype(dtype, [&](auto t, auto s) {
    return key_side<decltype(t), decltype(s)>(xd, dy, B, C, cum, entering, fstate, dso,
                                              has_dfinal, dbh, dx, dck, mh, gh, rh, b, l, h,
                                              p, g, n, chunk, st);
  }));
}

// Launch 4: dch and dcq from launch 3's mh and rh; has_init is 1 when the
// forward started from a given state (entering[chunk 0] is then that state).
int repro_ssd_bwd_query(const void* dy, const void* B, const void* C, const void* cum,
                        const void* entering, int has_init, const void* mh, const void* rh,
                        void* dch, void* dcq, int64_t b, int64_t l, int h, int p, int g, int n,
                        int chunk, int dtype, void* stream) {
  if (bad_shape(b, l, h, p, g, n, chunk) || bad_dtype(dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_dtype(dtype, [&](auto t, auto s) {
    return query_side<decltype(t), decltype(s)>(dy, B, C, cum, entering, has_init, mh, rh, dch,
                                                dcq, b, l, h, p, g, n, chunk, st);
  }));
}

// Launch 5: dad, dB and dC.
int repro_ssd_bwd_finish(const void* dcq, const void* dck, void* dad, const void* dbh,
                         const void* dch, void* dB, void* dC, int64_t b, int64_t l, int h, int g,
                         int n, int chunk, int dtype, void* stream) {
  if (bad_shape(b, l, h, 1, g, n, chunk) || bad_dtype(dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_dtype(dtype, [&](auto t, auto s) {
    return finish<decltype(t), decltype(s)>(dcq, dck, dad, dbh, dch, dB, dC, b, l, h, g, n,
                                            chunk, st);
  }));
}

const char* repro_ssd_bwd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
