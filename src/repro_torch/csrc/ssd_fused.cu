// Mamba2 SSD chunked scan for Hopper (sm_90a), in the chunk-parallel form.
//
// Replaces the TPU kernel repro/kernels/ssd.py::_ssd_fused_kernel (launched
// by ssd_fused).  Inputs: xd (b, l, h, p) (x pre-multiplied by dt), ad
// (b, l, h) (dt * A, negative), B and C (b, l, g, n), each head h reading
// group g = h / (h_heads / n_groups); optional initial state (b, h, p, n).
// Per (b, h) and chunk of q rows, with cum the running sum of ad in the chunk:
//   y_i   = sum_{j <= i} (C_i . B_j) e^{cum_i - cum_j} x_j + e^{cum_i} C_i stateᵀ
//   state = state e^{cum_{q-1}} + sum_j e^{cum_{q-1} - cum_j} x_j ⊗ B_j
// Outputs y (b, l, h, p) and the final state (b, h, p, n).  Everything is
// computed in the accumulation type T (float, or double for float64 inputs:
// the reference accumulates in promote(xd, f32)), the carried state included.
//
// The bf16 form (the reference model's SSD_BF16 mix, repro/models/ssm.py:
// 214-217): xd, B and C stored in bf16, ad in float32.  Each kernel is a
// template on the storage type S of xd / B / C / y over the fp32 form's own
// arithmetic: a bf16 value is widened to float as it is loaded (exact), cum,
// the states and the entering states stay float32, y is rounded once to
// bf16 as it is stored, the final state is float32.  So the bf16 form's y
// is the fp32 form's y on the upcast inputs, rounded, and its state is the
// fp32 form's, bit for bit (what the reference's ssd_fused computes for
// bf16 inputs: promote(bf16, f32) sums, y in xd's dtype, ssd.py:30, 92-93).
// Launch 3 keeps its 3xTF32 products (a bf16 value splits into hi = value,
// lo = 0).  Where p takes more than one 64-column slice, y's partial sums
// between key tiles go through a float32 scratch (yacc), not through the
// bf16 y, so that y is rounded once.
//
// What bounds it on the card: operations.  The function is q(q+1)(n+p) +
// 4qnp multiply-adds x 2 a chunk and head: 3.363 GFLOP for mamba2-2.7b's
// prefill layer (b 1, l 512, h 80, p 64, n 128, q 256) against ~24 MB of
// xd, ad, B, C, y and state (0.0502 ms at fp32's 67 TFLOP/s).
//
// Design: the TPU ran one (b, h) plane a grid step with the chunk loop
// inside; 80 planes leave most of 132 SMs idle, so the chunks go in
// parallel (Mamba-2, arXiv:2405.21060, section 6), in three launches:
//   1. ssd_chunk_state_kernel, grid (b h nc, ceil(p/64), ceil(n/64)): the
//      chunk's local state S_c = sum_j e^{cum_last - cum_j} x_j ⊗ B_j, one
//      64 x 64 tile of (p, n) a block.  The chunk's cum is a block scan of
//      256-row segments (each warp's 32 rows a shuffle tree in ascending
//      lane order, then the warp totals before it in ascending order, then
//      the carry); the first block of each chunk writes it to the scratch
//      cum (b, h, l);
//   2. ssd_state_pass_kernel, one thread per (b, h, p, n) state entry: walks
//      the chunks in order, writes the state entering chunk c to its own
//      buffer and carries state e^{cum_last} + S_c; writes the final state;
//   3. ssd_chunk_output_kernel, grid (b h nc, ceil(q/64)), one 64-row query
//      tile I a block (the heaviest tiles, most key tiles, first):
//      y_I = e^{cum_I} C_I stateᵀ + sum_{J <= I} (C_I B_Jᵀ ∘ L_IJ) x_J.
//      The carried-state product is skipped where the entering state is
//      zero (chunk 0 with no initial state).
//   * No entry of C Bᵀ is computed twice: each (I, J) tile belongs to one
//     block, once, whatever p is (y's columns beyond the first 64 are
//     carried through y itself, never by recomputing the tile).
//   * Products, fp32 launch 3 (the served path): tensor cores,
//     mma.sync.m16n8k8 TF32 with the 3xTF32 split (x = hi + lo, both TF32;
//     a_lo b_hi + a_hi b_lo + a_hi b_hi accumulated in fp32: fp32's error
//     level, where one TF32 pass rounds at 2^-11, the scale of the 2e-4
//     tolerance).  8 warps tile the 64 x 64 output 4 x 2; fragments come
//     from shared memory through ldmatrix (C, B and state tiles row-major
//     as they lie in memory, G query-major) or conflict-free scalar loads
//     (x key-major); the accumulators stay in registers.
//   * Products, launch 1 and fp64 launch 3: register micro-tiles, 256
//     threads as 16 x 16 each owning a 4 x 4 tile of the 64 x 64 output;
//     operands stored k-major with a row stride of 68, so that each k step
//     is two 16 B loads per thread (4 values of each operand into
//     registers) for 16 multiply-adds from registers.
//   * Neither form has an FMA read an operand from shared memory.  Both
//     stage their operands in k-steps of 32 (of n, or of a chunk's rows)
//     in two stages: step s is stored from registers, one barrier, then
//     step s + 1's global loads are issued before step s's products.
//     Ragged tiles (q, p or n not a multiple of the tile) are staged as
//     zeros and masked on store.
//   * Above the diagonal G is 0 and its decay is never evaluated (cum_i -
//     cum_j > 0 there): no exp(+) * 0.
//   * Shared memory is fixed (launch 1: 37 KB fp32, 74 KB fp64; launch 3:
//     55 KB, 105 KB) whatever q, p and n are: no shape is refused for it.
//   * Flops executed at mamba2's prefill, b 1 (tiles padded to 64 on the
//     diagonal, the zero state's product skipped): 0.671 (1) + 0.335 + 1.678
//     + 0.839 (3) = 3.523 GFLOP against the function's 3.363
//     (repro_torch/core/autotune.py::ssd_flops_executed).
//   * On an H100 at mamba2's prefill (b 1) the launches take about 0.06,
//     0.01 and 0.13 ms (scripts/ssd_launch_times.py): launch 3 holds its
//     loads' latency in view (64-wide k-steps were slower), not its
//     products (the tensor cores took it from 0.146 to 0.131 ms).
// Left for later: launch 1 on the tensor cores; deeper (cp.async) staging.
//
// The host wrapper is repro_torch/kernels/ssd.py::ssd_fused; it validates
// device, dtype, shape and contiguity, plans the launches
// (repro_torch/analysis/preflight.py::plan_ssd_fused), allocates the
// outputs and the scratch (cum, chunk states) and raises on a non-zero
// return code.

#include <cuda_runtime.h>
#include <cstdint>

#include "ssd_mma.cuh"

namespace {

using namespace ssd_mma;

constexpr int TILE = 64;       // rows and columns of an output tile
constexpr int KC = 32;         // k rows staged a step (one warp's segment)
constexpr int LDS = TILE + 4;  // shared-memory row stride (16 B aligned)
constexpr int THREADS = 256;   // 16 x 16 threads, a 4 x 4 tile each

template <typename T>
__device__ __forceinline__ T exp_t(T v);
template <>
__device__ __forceinline__ float exp_t<float>(float v) { return expf(v); }
template <>
__device__ __forceinline__ double exp_t<double>(double v) { return exp(v); }

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// Four consecutive values of a shared-memory row (16 B aligned).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// acc[a][b] += sum_k A[k][ty*4 + a] * B[k][tx*4 + b]; A and B k-major with
// row stride LDS.  Each k: 4 + 4 values into registers, 16 FMAs.
template <typename T>
__device__ __forceinline__ void micro(const T* __restrict__ A, const T* __restrict__ Bt,
                                      int kc, int ty, int tx, T (&acc)[4][4]) {
#pragma unroll 8
  for (int k = 0; k < kc; ++k) {
    T a[4], b[4];
    load4(A + k * LDS + ty * 4, a);
    load4(Bt + k * LDS + tx * 4, b);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fma_t(a[i], b[j], acc[i][j]);
  }
}

template <typename T>
__device__ __forceinline__ void zero(T (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
}

constexpr int SEG = THREADS;    // rows of ad one block scan covers
constexpr int PER = TILE * KC / THREADS;   // elements of a staged tile a thread holds

// A staged (KC x TILE) operand tile is written k-major, S[kk * LDS + m].
// Thread tid holds elements e = tid + i * THREADS; a "rows" tile reads a
// source whose rows are m and whose k is contiguous (C, B, the state),
// a "cols" tile one whose rows are k and whose m is contiguous (x, B in
// launch 1), so that consecutive threads read consecutive addresses.
enum Kind { ROWS, COLS };

template <Kind K>
__device__ __forceinline__ void coords(int e, int& kk, int& m) {
  if constexpr (K == ROWS) { m = e / KC; kk = e % KC; }
  else { kk = e / TILE; m = e % TILE; }
}

template <Kind K, typename T, typename F>
__device__ __forceinline__ void fetch(F f, int k0, int tid, T (&v)[PER]) {
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    int kk, m;
    coords<K>(tid + i * THREADS, kk, m);
    v[i] = f(k0 + kk, m);
  }
}

template <Kind K, typename T>
__device__ __forceinline__ void put(T* S, const T (&v)[PER], int tid) {
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    int kk, m;
    coords<K>(tid + i * THREADS, kk, m);
    S[kk * LDS + m] = v[i];
  }
}

// acc += A Bᵀ over k = k_begin .. k_end in steps of KC, A[k][m] = fa(k, m)
// and B[k][n] = fb(k, n) (0 outside their bounds).  Two shared-memory
// stages: step s is written to stage s & 1 from registers, one barrier,
// then the loads of step s + 1 are issued before step s's products, so
// their latency hides behind them.  `ab` holds 4 (KC, LDS) tiles; the
// caller syncs before reusing it.
template <Kind KA, Kind KB, typename T, typename FA, typename FB>
__device__ __forceinline__ void staged(T* ab, int k_begin, int k_end, FA fa, FB fb, int tid,
                                       int ty, int tx, T (&acc)[4][4]) {
  T ra[PER], rb[PER];
  fetch<KA>(fa, k_begin, tid, ra);
  fetch<KB>(fb, k_begin, tid, rb);
  for (int k0 = k_begin, s = 0; k0 < k_end; k0 += KC, ++s) {
    T* As = ab + (s & 1) * 2 * KC * LDS;
    T* Bs = As + KC * LDS;
    put<KA>(As, ra, tid);
    put<KB>(Bs, rb, tid);
    __syncthreads();
    if (k0 + KC < k_end) {
      fetch<KA>(fa, k0 + KC, tid, ra);
      fetch<KB>(fb, k0 + KC, tid, rb);
    }
    micro(As, Bs, KC, ty, tx, acc);
  }
}

// Inclusive running sum of ad over rows s0 .. s0 + SEG - 1 of a chunk
// (rows past q add 0) into cs[0 .. SEG): each warp scans its 32 rows as a
// shuffle tree in ascending lane order, then adds the totals of the warps
// before it (in ascending order) and the carry of the rows before s0.
// Returns the running sum at the segment's last row.  Every call with the
// same inputs gives the same bits.  Ends with a barrier.
template <typename T>
__device__ __forceinline__ T block_scan(const T* __restrict__ abase, int64_t h, int s0, int q,
                                        T carry, T* cs, T* wsum, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  T v = (s0 + tid < q) ? abase[static_cast<int64_t>(s0 + tid) * h] : T(0);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  T before = carry;
  for (int w = 0; w < warp; ++w) before += wsum[w];
  cs[tid] = before + v;
  __syncthreads();
  return cs[SEG - 1];
}

template <typename T, typename S>
__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_state_kernel(const S* __restrict__ xd, const T* __restrict__ ad,
                       const S* __restrict__ Bm, T* __restrict__ cum,
                       T* __restrict__ states, int64_t l, int h, int p, int g,
                       int n, int q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ab = reinterpret_cast<T*>(smem_raw);   // 2 stages of (KC, LDS) x and B tiles
  T* cs = ab + 4 * KC * LDS;                // (SEG) cum of the current segment
  T* ds = cs + SEG;                         // (SEG) its e^{cum_last - cum_j}
  T* wsum = ds + SEG;                       // (THREADS / 32) warp totals

  const int64_t nc = l / q;
  const int64_t bhc = blockIdx.x;
  const int64_t c = bhc % nc, bh = bhc / nc;
  const int hh = static_cast<int>(bh % h);
  const int64_t bi = bh / h;
  const int gi = hh / (h / g);
  const int p0 = blockIdx.y * TILE, n0 = blockIdx.z * TILE;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t t0 = c * q;
  const int64_t xrow = static_cast<int64_t>(h) * p, brow = static_cast<int64_t>(g) * n;
  const S* xbase = xd + (bi * l + t0) * xrow + static_cast<int64_t>(hh) * p;
  const S* bbase = Bm + (bi * l + t0) * brow + static_cast<int64_t>(gi) * n;
  const T* abase = ad + (bi * l + t0) * h + hh;
  T* cbase = cum + bh * l + t0;
  const bool writer = blockIdx.y == 0 && blockIdx.z == 0;

  // pass 1: the chunk's cum (written by its first block) and cum_last
  T carry = T(0);
  for (int s0 = 0; s0 < q; s0 += SEG) {
    carry = block_scan(abase, h, s0, q, carry, cs, wsum, tid);
    if (writer && s0 + tid < q) cbase[s0 + tid] = cs[tid];
    __syncthreads();                         // cs read before the next scan
  }
  const T cum_last = carry;

  // pass 2: S[p][n] += sum_j (e^{cum_last - cum_j} x_j[p]) B_j[n], a
  // segment of rows at a time (its cum rescanned when the chunk has more)
  T acc[4][4];
  zero(acc);
  carry = T(0);
  for (int s0 = 0; s0 < q; s0 += SEG) {
    if (q > SEG) carry = block_scan(abase, h, s0, q, carry, cs, wsum, tid);
    ds[tid] = exp_t(cum_last - cs[tid]);
    __syncthreads();
    auto fa = [&](int j, int m) -> T {
      return j < q && p0 + m < p ? as_acc(xbase[j * xrow + p0 + m]) * ds[j - s0] : T(0);
    };
    auto fb = [&](int j, int m) -> T {
      return j < q && n0 + m < n ? as_acc(bbase[j * brow + n0 + m]) : T(0);
    };
    staged<COLS, COLS>(ab, s0, min(s0 + SEG, q), fa, fb, tid, ty, tx, acc);
    __syncthreads();                         // stages, cs and ds read
  }
  T* sbase = states + bhc * p * static_cast<int64_t>(n);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int pp = p0 + ty * 4 + a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int k = n0 + tx * 4 + b;
      if (pp < p && k < n) sbase[static_cast<int64_t>(pp) * n + k] = acc[a][b];
    }
  }
}

// One thread per state entry r of one (b, h) plane (grid (b h, ceil(p n /
// 256))).  The entering states go to their own buffer: rewriting the chunk
// states in place (a load and a store of one address by one thread) on the
// same grid ran 1.7-2.6x slower at mamba2's widths, b = 1-8, on an H100
// (scripts/ssd_state_pass_variants.py).
template <typename T>
__global__ void ssd_state_pass_kernel(const T* __restrict__ states, T* __restrict__ entering,
                                      const T* __restrict__ cum, const T* __restrict__ init,
                                      T* __restrict__ fstate, int64_t l, int pn, int q,
                                      int nc) {
  const int r = blockIdx.y * blockDim.x + threadIdx.x;
  if (r >= pn) return;
  const int64_t bh = blockIdx.x;
  T carried = init ? init[bh * pn + r] : T(0);
  for (int c = 0; c < nc; ++c) {
    const int64_t idx = (bh * nc + c) * pn + r;
    const T s = states[idx];
    entering[idx] = carried;                 // the state entering chunk c
    carried = carried * exp_t(cum[bh * l + static_cast<int64_t>(c) * q + q - 1]) + s;
  }
  fstate[bh * pn + r] = carried;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_output_kernel(const T* __restrict__ xd, const T* __restrict__ Bm,
                        const T* __restrict__ Cm, const T* __restrict__ cum,
                        const T* __restrict__ states, int has_init, T* __restrict__ y,
                        int64_t l, int h, int p, int g, int n, int q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ab = reinterpret_cast<T*>(smem_raw);   // 2 stages of (KC, LDS) operand tiles
  T* Xs = ab;                               // (TILE, LDS) x rows (reuses stage 0)
  T* Gs = ab + 4 * KC * LDS;                // (TILE, LDS) G, key-major
  T* cq = Gs + TILE * LDS;                  // (TILE) cum of the query rows
  T* ck = cq + TILE;                        // (TILE) cum of the key rows

  const int64_t nc = l / q;
  const int64_t bhc = blockIdx.x;
  const int64_t c = bhc % nc, bh = bhc / nc;
  const int hh = static_cast<int>(bh % h);
  const int64_t bi = bh / h;
  const int gi = hh / (h / g);
  const int I = gridDim.y - 1 - blockIdx.y;   // heaviest tiles first
  const int i0 = I * TILE;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t t0 = c * q;
  const int64_t xrow = static_cast<int64_t>(h) * p, brow = static_cast<int64_t>(g) * n;
  const T* xbase = xd + (bi * l + t0) * xrow + static_cast<int64_t>(hh) * p;
  T* ybase = y + (bi * l + t0) * xrow + static_cast<int64_t>(hh) * p;
  const T* bbase = Bm + (bi * l + t0) * brow + static_cast<int64_t>(gi) * n;
  const T* cbase = Cm + (bi * l + t0) * brow + static_cast<int64_t>(gi) * n;
  const T* cumb = cum + bh * l + t0;
  const T* st_in = states + bhc * p * static_cast<int64_t>(n);   // (p, n)
  const bool has_state = c > 0 || has_init;
  const int n_ps = (p + TILE - 1) / TILE;

  if (tid < TILE) cq[tid] = i0 + tid < q ? cumb[i0 + tid] : T(0);
  __syncthreads();

  // y's columns [ps, ps + 64) of this thread's 4 x 4 tile, through y itself
  // when p takes more than one slice (the G tiles are never recomputed).
  auto y_io = [&](T (&acc)[4][4], int ps, bool store) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty * 4 + a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int pp = ps + tx * 4 + b;
        if (i < q && pp < p) {
          T* dst = ybase + static_cast<int64_t>(i) * xrow + pp;
          if (store) *dst = acc[a][b]; else acc[a][b] = *dst;
        }
      }
    }
  };
  auto c_rows = [&](int k, int m) -> T {       // C_I[m][k]
    return i0 + m < q && k < n ? cbase[static_cast<int64_t>(i0 + m) * brow + k] : T(0);
  };

  T acc[4][4];
  // carried-state term: e^{cum_i} C_i stateᵀ, K = n
  for (int s = 0; s < n_ps; ++s) {
    const int ps = s * TILE;
    zero(acc);
    if (has_state) {
      auto s_rows = [&](int k, int m) -> T {   // state[ps + m][k]
        return ps + m < p && k < n ? st_in[static_cast<int64_t>(ps + m) * n + k] : T(0);
      };
      __syncthreads();                       // the stages' last readers are done
      staged<ROWS, ROWS>(ab, 0, n, c_rows, s_rows, tid, ty, tx, acc);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const T d = exp_t(cq[ty * 4 + a]);
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] *= d;
      }
    }
    if (n_ps > 1) y_io(acc, ps, true);
  }

  // intra-chunk term over the key tiles on or below the diagonal
  for (int J = 0; J <= I; ++J) {
    const int j0 = J * TILE;
    T gacc[4][4];
    zero(gacc);
    __syncthreads();                         // Gs, Xs, ck and the stages read
    if (tid < TILE) ck[tid] = j0 + tid < q ? cumb[j0 + tid] : T(0);
    auto b_rows = [&](int k, int m) -> T {     // B_J[m][k]
      return j0 + m < q && k < n ? bbase[static_cast<int64_t>(j0 + m) * brow + k] : T(0);
    };
    staged<ROWS, ROWS>(ab, 0, n, c_rows, b_rows, tid, ty, tx, gacc);
    // G ∘ L, written key-major as the next product's A operand
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int ii = ty * 4 + a, i = i0 + ii;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int jj = tx * 4 + b, j = j0 + jj;
        T v = T(0);
        if (i >= j && i < q) v = gacc[a][b] * exp_t(cq[ii] - ck[jj]);
        Gs[jj * LDS + ii] = v;
      }
    }
    for (int s = 0; s < n_ps; ++s) {
      const int ps = s * TILE;
      __syncthreads();                       // the stages (or the last Xs) read
      for (int e = tid; e < TILE * TILE; e += THREADS) {
        const int jj = e / TILE, pp = e % TILE;
        Xs[jj * LDS + pp] = j0 + jj < q && ps + pp < p
            ? xbase[static_cast<int64_t>(j0 + jj) * xrow + ps + pp] : T(0);
      }
      __syncthreads();                       // Xs and Gs written
      if (n_ps > 1) y_io(acc, ps, false);
      micro(Gs, Xs, TILE, ty, tx, acc);
      if (n_ps > 1) y_io(acc, ps, true);
    }
  }
  if (n_ps == 1) y_io(acc, 0, true);
}

// ---------------------------------------------------------------------------
// Launch 3 in fp32 on the tensor cores: mma.sync m16n8k8 TF32 with the
// 3xTF32 split (each operand x = hi + lo, both TF32; a_lo b_hi + a_hi b_lo
// + a_hi b_hi accumulated in fp32, so the error stays at fp32's level; the
// helpers are ssd_mma.cuh's, shared with the backward).
// The 8 warps of a block tile its 64 x 64 output 4 x 2, each 16 rows x 4
// n-tiles of 8.  C, B and state tiles are staged row-major as they lie in
// memory (row stride CK = 36 floats: conflict-free rows for ldmatrix),
// G row-major (GS = 68), x key-major (XS = 72 = 8 mod 32 words, so the
// B fragments' scalar loads hit distinct banks).
// ---------------------------------------------------------------------------

constexpr int CK = KC + 4;
constexpr int GS = TILE + 4;
constexpr int XS = TILE + 8;

template <typename F>
__device__ __forceinline__ void fetch_rm(F f, int k0, int tid, float (&v)[PER]) {
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * THREADS;
    v[i] = f(k0 + e % KC, e / KC);
  }
}

__device__ __forceinline__ void put_rm(float* S, const float (&v)[PER], int tid) {
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * THREADS;
    S[(e / KC) * CK + e % KC] = v[i];
  }
}

// c += A Bᵀ over k = 0 .. k_end, A[m][k] = fa(k, m), B[n][k] = fb(k, n),
// staged row-major in two stages as `staged` does.
template <typename FA, typename FB>
__device__ __forceinline__ void staged_tc(float* ab, int k_end, FA fa, FB fb, int tid,
                                          int lane, int mb, int nb, float (&c)[4][4]) {
  float ra[PER], rb[PER];
  fetch_rm(fa, 0, tid, ra);
  fetch_rm(fb, 0, tid, rb);
  for (int k0 = 0, s = 0; k0 < k_end; k0 += KC, ++s) {
    float* As = ab + (s & 1) * 2 * TILE * CK;
    float* Bs = As + TILE * CK;
    put_rm(As, ra, tid);
    put_rm(Bs, rb, tid);
    __syncthreads();
    if (k0 + KC < k_end) {
      fetch_rm(fa, k0 + KC, tid, ra);
      fetch_rm(fb, k0 + KC, tid, rb);
    }
#pragma unroll
    for (int kb = 0; kb < KC; kb += 8) {
      uint32_t a[4], b[4][2];
      frag_a(a, As, CK, mb, kb, lane);
      frag_b_rows(b, Bs, CK, nb, kb, lane);
      mma3(c, a, b);
    }
  }
}

// S: the storage type of xd, B, C and y (float, or bf16); yacc: y's float
// partial sums where p takes more than one slice and S is not float (else
// unused: a float y holds them itself).
template <typename S>
__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_output_tc_kernel(const S* __restrict__ xd, const S* __restrict__ Bm,
                           const S* __restrict__ Cm, const float* __restrict__ cum,
                           const float* __restrict__ states, int has_init, S* y,
                           float* yacc, int64_t l, int h, int p, int g, int n, int q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ab = reinterpret_cast<float*>(smem_raw);   // 2 stages of 2 (TILE, CK) tiles
  float* Xs = ab;                                   // (TILE, XS) x rows (reuses stage 0)
  float* Gs = ab + 4 * TILE * CK;                   // (TILE, GS) G, query-major
  float* cq = Gs + TILE * GS;                       // (TILE) cum of the query rows
  float* ck = cq + TILE;                            // (TILE) cum of the key rows

  const int64_t nc = l / q;
  const int64_t bhc = blockIdx.x;
  const int64_t c = bhc % nc, bh = bhc / nc;
  const int hh = static_cast<int>(bh % h);
  const int64_t bi = bh / h;
  const int gi = hh / (h / g);
  const int I = gridDim.y - 1 - blockIdx.y;   // heaviest tiles first
  const int i0 = I * TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mb = (warp & 3) * 16, nb = (warp >> 2) * 32;   // the warp's 16 x 32 tile
  const int fg = lane >> 2, ft = lane & 3;                 // fragment row / column
  const int64_t t0 = c * q;
  const int64_t xrow = static_cast<int64_t>(h) * p, brow = static_cast<int64_t>(g) * n;
  const S* xbase = xd + (bi * l + t0) * xrow + static_cast<int64_t>(hh) * p;
  S* ybase = y + (bi * l + t0) * xrow + static_cast<int64_t>(hh) * p;
  float* abase;                             // y's partial sums between key tiles
  if constexpr (sizeof(S) == sizeof(float)) abase = ybase;
  else abase = yacc + (bi * l + t0) * xrow + static_cast<int64_t>(hh) * p;
  const S* bbase = Bm + (bi * l + t0) * brow + static_cast<int64_t>(gi) * n;
  const S* cbase = Cm + (bi * l + t0) * brow + static_cast<int64_t>(gi) * n;
  const float* cumb = cum + bh * l + t0;
  const float* st_in = states + bhc * p * static_cast<int64_t>(n);   // (p, n)
  const bool has_state = c > 0 || has_init;
  const int n_ps = (p + TILE - 1) / TILE;

  if (tid < TILE) cq[tid] = i0 + tid < q ? cumb[i0 + tid] : 0.f;
  __syncthreads();

  // element e of this thread's fragment of n-tile j: row mb + fg (+ 8 for
  // e >= 2), column nb + 8 j + 2 ft + (e & 1).  io: LOAD a partial sum,
  // PART store one (float), DONE store y (rounded once where S is bf16).
  enum { LOAD, PART, DONE };
  auto y_io = [&](float (&acc)[4][4], int ps, int io) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + mb + fg + (e >> 1) * 8;
        const int pp = ps + nb + 8 * j + 2 * ft + (e & 1);
        if (i < q && pp < p) {
          const int64_t at = static_cast<int64_t>(i) * xrow + pp;
          if (io == LOAD) acc[j][e] = abase[at];
          else if (io == PART) abase[at] = acc[j][e];
          else store_as(ybase + at, acc[j][e]);
        }
      }
  };
  auto c_rows = [&](int k, int m) -> float {       // C_I[m][k]
    return i0 + m < q && k < n ? as_acc(cbase[static_cast<int64_t>(i0 + m) * brow + k]) : 0.f;
  };
  auto zero4 = [](float (&a)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[j][e] = 0.f;
  };

  float acc[4][4];
  // carried-state term: e^{cum_i} C_i stateᵀ, K = n
  for (int s = 0; s < n_ps; ++s) {
    const int ps = s * TILE;
    zero4(acc);
    if (has_state) {
      auto s_rows = [&](int k, int m) -> float {   // state[ps + m][k]
        return ps + m < p && k < n ? st_in[static_cast<int64_t>(ps + m) * n + k] : 0.f;
      };
      __syncthreads();
      staged_tc(ab, n, c_rows, s_rows, tid, lane, mb, nb, acc);
      const float d0 = expf(cq[mb + fg]), d1 = expf(cq[mb + fg + 8]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[j][0] *= d0; acc[j][1] *= d0; acc[j][2] *= d1; acc[j][3] *= d1;
      }
    }
    if (n_ps > 1) y_io(acc, ps, PART);
  }

  // intra-chunk term over the key tiles on or below the diagonal
  for (int J = 0; J <= I; ++J) {
    const int j0 = J * TILE;
    float gacc[4][4];
    zero4(gacc);
    __syncthreads();                         // Gs, Xs, ck and the stages read
    if (tid < TILE) ck[tid] = j0 + tid < q ? cumb[j0 + tid] : 0.f;
    auto b_rows = [&](int k, int m) -> float {     // B_J[m][k]
      return j0 + m < q && k < n ? as_acc(bbase[static_cast<int64_t>(j0 + m) * brow + k]) : 0.f;
    };
    staged_tc(ab, n, c_rows, b_rows, tid, lane, mb, nb, gacc);
    // G ∘ L into Gs, query-major (above the diagonal 0, its decay unevaluated)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int ii = mb + fg + hr * 8, jj = nb + 8 * j + 2 * ft;
        const int i = i0 + ii, jg = j0 + jj;
        float2 v = make_float2(0.f, 0.f);
        if (i < q && i >= jg) v.x = gacc[j][2 * hr] * expf(cq[ii] - ck[jj]);
        if (i < q && i >= jg + 1) v.y = gacc[j][2 * hr + 1] * expf(cq[ii] - ck[jj + 1]);
        *reinterpret_cast<float2*>(Gs + ii * GS + jj) = v;
      }
    for (int s = 0; s < n_ps; ++s) {
      const int ps = s * TILE;
      __syncthreads();                       // the stages (or the last Xs) read
      for (int e = tid; e < TILE * TILE; e += THREADS) {
        const int jj = e / TILE, pp = e % TILE;
        Xs[jj * XS + pp] = j0 + jj < q && ps + pp < p
            ? as_acc(xbase[static_cast<int64_t>(j0 + jj) * xrow + ps + pp]) : 0.f;
      }
      __syncthreads();                       // Xs and Gs written
      if (n_ps > 1) y_io(acc, ps, LOAD);
#pragma unroll
      for (int kb = 0; kb < TILE; kb += 8) {
        uint32_t a[4], b[4][2];
        frag_a(a, Gs, GS, mb, kb, lane);
        frag_b_cols(b, Xs, XS, nb, kb, lane);
        mma3(acc, a, b);
      }
      if (n_ps > 1) y_io(acc, ps, J == I ? DONE : PART);
    }
  }
  if (n_ps == 1) y_io(acc, 0, DONE);
}

size_t state_smem(size_t itemsize) {
  return (4 * KC * LDS + 2 * SEG + THREADS / 32) * itemsize;
}
size_t output_smem(size_t itemsize) {
  if (itemsize == sizeof(float)) return (4 * TILE * CK + TILE * GS + 2 * TILE) * sizeof(float);
  return (4 * KC * LDS + TILE * LDS + 2 * TILE) * itemsize;
}

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
         (static_cast<int64_t>(p) * n + THREADS - 1) / THREADS > 65535 ||
         (p + TILE - 1) / TILE > 65535 ||
         (n + TILE - 1) / TILE > 65535 || (q + TILE - 1) / TILE > 65535;
}

template <typename T, typename S>
cudaError_t chunk_state(const void* xd, const void* ad, const void* B, void* cum,
                        void* states, int64_t b, int64_t l, int h, int p, int g, int n,
                        int q, cudaStream_t stream) {
  const size_t smem = state_smem(sizeof(T));
  cudaError_t err = set_smem(ssd_chunk_state_kernel<T, S>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(b * h * (l / q)),
                  static_cast<unsigned>((p + TILE - 1) / TILE),
                  static_cast<unsigned>((n + TILE - 1) / TILE));
  ssd_chunk_state_kernel<T, S><<<grid, THREADS, smem, stream>>>(
      static_cast<const S*>(xd), static_cast<const T*>(ad), static_cast<const S*>(B),
      static_cast<T*>(cum), static_cast<T*>(states), l, h, p, g, n, q);
  return cudaGetLastError();
}

template <typename T>
cudaError_t state_pass(const void* states, void* entering, const void* cum, const void* init,
                       void* fstate, int64_t b, int64_t l, int h, int p, int n, int q,
                       cudaStream_t stream) {
  const int pn = p * n;
  const dim3 grid(static_cast<unsigned>(b * h), static_cast<unsigned>((pn + THREADS - 1) / THREADS));
  ssd_state_pass_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(states), static_cast<T*>(entering), static_cast<const T*>(cum),
      static_cast<const T*>(init), static_cast<T*>(fstate), l, pn,
      q, static_cast<int>(l / q));
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t chunk_output(const void* xd, const void* B, const void* C, const void* cum,
                         const void* states, int has_init, void* y, void* yacc, int64_t b,
                         int64_t l, int h, int p, int g, int n, int q, cudaStream_t stream) {
  const size_t smem = output_smem(sizeof(T));
  const dim3 grid(static_cast<unsigned>(b * h * (l / q)),
                  static_cast<unsigned>((q + TILE - 1) / TILE));
  if constexpr (sizeof(T) == sizeof(float)) {
    cudaError_t err = set_smem(ssd_chunk_output_tc_kernel<S>, smem);
    if (err != cudaSuccess) return err;
    ssd_chunk_output_tc_kernel<S><<<grid, THREADS, smem, stream>>>(
        static_cast<const S*>(xd), static_cast<const S*>(B), static_cast<const S*>(C),
        static_cast<const float*>(cum), static_cast<const float*>(states), has_init,
        static_cast<S*>(y), static_cast<float*>(yacc), l, h, p, g, n, q);
  } else {
    cudaError_t err = set_smem(ssd_chunk_output_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    ssd_chunk_output_kernel<T><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(xd), static_cast<const T*>(B), static_cast<const T*>(C),
        static_cast<const T*>(cum), static_cast<const T*>(states), has_init,
        static_cast<T*>(y), l, h, p, g, n, q);
  }
  return cudaGetLastError();
}

bool bad_dtype(int dtype) { return dtype != kFloat32 && dtype != kFloat64 && dtype != kBfloat16; }

}  // namespace

extern "C" {

// Element types by `dtype` (ssd_mma.cuh's codes): 0 all float32; 1 all
// float64; 2 the bf16 form, xd / B / C (and y) bf16, ad and everything
// else (cum, the states, init, fstate, yacc) float32.  The caller makes
// the stream's device current.  Each entry point returns the cudaError_t
// of its attribute call or launch.

// Launch 1.  xd (b, l, h, p), ad (b, l, h), B (b, l, g, n); writes cum
// (b, h, l) and states (b, h, l / chunk, p, n).
int repro_ssd_chunk_state(const void* xd, const void* ad, const void* B, void* cum,
                          void* states, int64_t b, int64_t l, int h, int p, int g,
                          int n, int chunk, int dtype, void* stream) {
  if (bad_shape(b, l, h, p, g, n, chunk) || bad_dtype(dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat64)
    return static_cast<int>(
        chunk_state<double, double>(xd, ad, B, cum, states, b, l, h, p, g, n, chunk, st));
  if (dtype == kBfloat16)
    return static_cast<int>(chunk_state<float, __nv_bfloat16>(xd, ad, B, cum, states, b, l,
                                                              h, p, g, n, chunk, st));
  return static_cast<int>(
      chunk_state<float, float>(xd, ad, B, cum, states, b, l, h, p, g, n, chunk, st));
}

// Launch 2.  states and cum from launch 1, init (b, h, p, n; nullable);
// writes entering (b, h, l / chunk, p, n), the state entering each chunk,
// and fstate (b, h, p, n).  All in the accumulation type (float64 for
// dtype 1, else float32).
int repro_ssd_state_pass(const void* states, void* entering, const void* cum,
                         const void* init, void* fstate, int64_t b, int64_t l, int h, int p,
                         int n, int chunk, int dtype, void* stream) {
  if (bad_shape(b, l, h, p, 1, n, chunk) || bad_dtype(dtype) ||
      static_cast<int64_t>(p) * n > 2147483647 - THREADS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == kFloat64
          ? state_pass<double>(states, entering, cum, init, fstate, b, l, h, p, n, chunk, st)
          : state_pass<float>(states, entering, cum, init, fstate, b, l, h, p, n, chunk, st));
}

// Launch 3.  xd, B, C as launch 1, cum from launch 1 and the entering states
// from launch 2 (as `states`), has_init (1 when the scan started from a given state); writes y
// (b, l, h, p).  yacc (b, l, h, p) float32: y's partial sums, needed by the
// bf16 form where p > 64 (nullable otherwise; unused by the other forms).
int repro_ssd_chunk_output(const void* xd, const void* B, const void* C, const void* cum,
                           const void* states, int has_init, void* y, void* yacc, int64_t b,
                           int64_t l, int h, int p, int g, int n, int chunk, int dtype,
                           void* stream) {
  if (bad_shape(b, l, h, p, g, n, chunk) || bad_dtype(dtype) ||
      (dtype == kBfloat16 && p > TILE && yacc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat64)
    return static_cast<int>(chunk_output<double, double>(xd, B, C, cum, states, has_init, y,
                                                         yacc, b, l, h, p, g, n, chunk, st));
  if (dtype == kBfloat16)
    return static_cast<int>(chunk_output<float, __nv_bfloat16>(
        xd, B, C, cum, states, has_init, y, yacc, b, l, h, p, g, n, chunk, st));
  return static_cast<int>(chunk_output<float, float>(xd, B, C, cum, states, has_init, y, yacc,
                                                     b, l, h, p, g, n, chunk, st));
}

const char* repro_ssd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
