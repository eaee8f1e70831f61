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
// Five launches:
//   1. ssd_bwd_local_kernel, grid (b h nc, ceil(p/64), ceil(n/64)): each
//      chunk's local term sum_i e^{cum_i} dY_iᵀ C_i, a 64 x 64 tile of (p, n)
//      a block (the forward's launch 1 with dY, C and e^{cum} in place of x,
//      B and e^{cum_last - cum});
//   2. ssd_bwd_state_pass_kernel, on the forward state pass's grid (one thread
//      per (b, h, p, n) entry): walks the chunks last to first, writes dS_out
//      of each chunk and carries dS_in; writes init_state's gradient;
//   3. ssd_bwd_query_kernel, grid (b h nc, ceil(q/64)), one 64-row query tile
//      I a block: dC_I and the row sums of dcum over the key tiles J <= I;
//   4. ssd_bwd_key_kernel, the same grid, one 64-row key tile J a block: dX_J,
//      dB_J and the column sums of dcum over the query tiles I >= J, with the
//      dS_out terms;
//   5. ssd_bwd_finish_kernel: dad (the reverse running sum, one thread a
//      chunk, last row to first), and dB, dC summed over the h / g heads of
//      each group in ascending head order.
// Launches 3 and 4 both recompute the (I, J) tiles of G and dY Xᵀ: launch 3
// owns the query rows, launch 4 the key rows, so no output has two writers
// and no float atomics are needed: two calls give bit-equal gradients.
// The per-head dB and dC of launches 3 and 4 go to (b, l, h, n) scratch
// before the group sums.
//
// What bounds it on the card: operations.  Per (b, h) and chunk the function
// is q(q+1)/2 (3n + 2p) + 4 q p n multiply-adds (G, M, dC, dB and dX on and
// below the diagonal; the local term and the three dS terms), two operations
// each: about 2.7 times the forward's quadratic part.  All products are
// register micro-tiles on the CUDA cores (256 threads as 16 x 16, a 4 x 4
// tile each, operands staged k-major through shared memory in k-steps of
// 32), in the element type T (float, or double for float64): fp32 at the
// CUDA cores' 67 TFLOP/s, not the tensor cores'.  Outputs wider than one
// 64-column tile are carried through device memory between key tiles (each
// element owned by one thread), as the forward's y is.  Simple and right
// first; its speed is queue B's (ROADMAP).
//
// The entering states S_in and the cum of every chunk are the forward's
// (saved by repro_torch/kernels/ssd.py's autograd Function from the forward
// launches), not recomputed.
//
// The host wrapper is repro_torch/kernels/ssd.py::ssd_fused_bwd; it plans the
// launches (repro_torch/analysis/preflight.py::plan_ssd_fused_bwd),
// allocates outputs and scratch and raises on a non-zero return code.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TILE = 64;       // rows and columns of an output tile
constexpr int KC = 32;         // k rows staged a step
constexpr int LDS = TILE + 4;  // shared-memory row stride (16 B aligned)
constexpr int THREADS = 256;   // 16 x 16 threads, a 4 x 4 tile each
constexpr int PER = TILE * KC / THREADS;   // elements of a staged tile a thread holds

template <typename T>
__device__ __forceinline__ T exp_t(T v);
template <>
__device__ __forceinline__ float exp_t<float>(float v) { return expf(v); }
template <>
__device__ __forceinline__ double exp_t<double>(double v) { return exp(v); }

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

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
// row stride LDS.
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

// A staged (KC x TILE) operand tile is written k-major, S[kk * LDS + m].  A
// ROWS source has rows m and k contiguous, a COLS source rows k and m
// contiguous, so that consecutive threads read consecutive addresses.
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

// acc += A Bᵀ over k = 0 .. k_end in steps of KC, A[k][m] = fa(k, m) and
// B[k][n] = fb(k, n) (the callers return 0 outside their bounds), in two
// shared-memory stages (the next step's loads issued before this step's
// products).  `ab` holds 4 (KC, LDS) tiles.  Starts with a barrier, so the
// caller may reuse `ab` and whatever it read before.
template <Kind KA, Kind KB, typename T, typename FA, typename FB>
__device__ __forceinline__ void staged(T* ab, int k_end, FA fa, FB fb, int tid, int ty,
                                       int tx, T (&acc)[4][4]) {
  T ra[PER], rb[PER];
  __syncthreads();
  fetch<KA>(fa, 0, tid, ra);
  fetch<KB>(fb, 0, tid, rb);
  for (int k0 = 0, s = 0; k0 < k_end; k0 += KC, ++s) {
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

// The sum over the 16 threads of one tile row (tx = lane & 15), in a fixed
// butterfly order; every lane of the row gets a sum, lane tx = 0's is used.
template <typename T>
__device__ __forceinline__ T row_sum(T v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Reads (load) or writes this thread's 4 x 4 tile of a (rows, cols) output
// whose row r, column c lies at base[r * stride + c]; rows past `rows` and
// columns past `cols` are skipped (a load leaves 0 there).
template <typename T>
__device__ __forceinline__ void tile_io(T* base, int64_t stride, int r0, int c0, int rows,
                                        int cols, int ty, int tx, T (&acc)[4][4], bool store) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + ty * 4 + a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = c0 + tx * 4 + b;
      if (r < rows && c < cols) {
        T* p = base + static_cast<int64_t>(r) * stride + c;
        if (store) *p = acc[a][b]; else acc[a][b] = *p;
      } else if (!store) {
        acc[a][b] = T(0);
      }
    }
  }
}

// Loads a (TILE, TILE) tile of a row-major source (rows r0 .., columns c0 ..)
// into S k-major (S[r * LDS + c]), zeros outside (rows, cols).
template <typename T>
__device__ __forceinline__ void load_tile(T* S, const T* __restrict__ base, int64_t stride,
                                          int r0, int c0, int rows, int cols, int tid) {
  for (int e = tid; e < TILE * TILE; e += THREADS) {
    const int r = e / TILE, c = e % TILE;
    S[r * LDS + c] = r0 + r < rows && c0 + c < cols
        ? base[static_cast<int64_t>(r0 + r) * stride + c0 + c] : T(0);
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

// Launch 1: local[b, h, c] (p, n) = sum_i e^{cum_i} dY_iᵀ C_i.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_local_kernel(const T* __restrict__ dy, const T* __restrict__ Cm,
                     const T* __restrict__ cum, T* __restrict__ local, int64_t l, int h,
                     int p, int g, int n, int q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ab = reinterpret_cast<T*>(smem_raw);
  const Plane pl = plane_of(l, h, g, q);
  const int p0 = blockIdx.y * TILE, n0 = blockIdx.z * TILE;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t xrow = static_cast<int64_t>(h) * p, brow = static_cast<int64_t>(g) * n;
  const T* dybase = dy + (pl.bi * l + pl.t0) * xrow + static_cast<int64_t>(pl.hh) * p;
  const T* cbase = Cm + (pl.bi * l + pl.t0) * brow + static_cast<int64_t>(pl.gi) * n;
  const T* cumb = cum + pl.bh * l + pl.t0;
  auto fa = [&](int i, int m) -> T {
    return i < q && p0 + m < p ? dybase[i * xrow + p0 + m] * exp_t(cumb[i]) : T(0);
  };
  auto fb = [&](int i, int m) -> T {
    return i < q && n0 + m < n ? cbase[i * brow + n0 + m] : T(0);
  };
  T acc[4][4];
  zero(acc);
  staged<COLS, COLS>(ab, q, fa, fb, tid, ty, tx, acc);
  tile_io(local + pl.bhc * p * static_cast<int64_t>(n), n, p0, n0, p, n, ty, tx, acc, true);
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

// Launch 3: query tile I of one chunk.  dC_I (per head, into dch (b, l, h,
// n)) and the row part of dcum (into dcq (b, h, l)).
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_query_kernel(const T* __restrict__ xd, const T* __restrict__ dy,
                     const T* __restrict__ Bm, const T* __restrict__ Cm,
                     const T* __restrict__ cum, const T* __restrict__ entering, int has_init,
                     T* __restrict__ dch, T* __restrict__ dcq, int64_t l, int h, int p, int g,
                     int n, int q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ab = reinterpret_cast<T*>(smem_raw);   // stages; an operand tile between products
  T* Ms = ab + 4 * KC * LDS;                // (TILE, LDS) M_IJ, key-major
  T* cq = Ms + TILE * LDS;                  // (TILE) cum of the query rows
  T* ck = cq + TILE;                        // (TILE) cum of the key rows

  const Plane pl = plane_of(l, h, g, q);
  const int i0 = blockIdx.y * TILE;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t xrow = static_cast<int64_t>(h) * p, brow = static_cast<int64_t>(g) * n;
  const int64_t hrow = static_cast<int64_t>(h) * n;
  const T* xbase = xd + (pl.bi * l + pl.t0) * xrow + static_cast<int64_t>(pl.hh) * p;
  const T* dybase = dy + (pl.bi * l + pl.t0) * xrow + static_cast<int64_t>(pl.hh) * p;
  const T* bbase = Bm + (pl.bi * l + pl.t0) * brow + static_cast<int64_t>(pl.gi) * n;
  const T* cbase = Cm + (pl.bi * l + pl.t0) * brow + static_cast<int64_t>(pl.gi) * n;
  T* dcbase = dch + (pl.bi * l + pl.t0) * hrow + static_cast<int64_t>(pl.hh) * n;
  const T* cumb = cum + pl.bh * l + pl.t0;
  const T* s_in = entering + pl.bhc * p * static_cast<int64_t>(n);   // (p, n)
  const bool has_state = pl.c > 0 || has_init;
  const int n_ns = (n + TILE - 1) / TILE;

  if (tid < TILE) cq[tid] = i0 + tid < q ? cumb[i0 + tid] : T(0);
  __syncthreads();

  T rowacc[4] = {T(0), T(0), T(0), T(0)};
  T acc[4][4];
  auto dy_rows = [&](int k, int m) -> T {      // dY_I[m][k]
    return i0 + m < q && k < p ? dybase[static_cast<int64_t>(i0 + m) * xrow + k] : T(0);
  };
  auto c_rows = [&](int k, int m) -> T {       // C_I[m][k]
    return i0 + m < q && k < n ? cbase[static_cast<int64_t>(i0 + m) * brow + k] : T(0);
  };

  // state term: dC_I = diag(e^{cum}) dY_I S_in; its dcum part sum_n C dC
  for (int s = 0; s < n_ns; ++s) {
    const int ns = s * TILE;
    zero(acc);
    if (has_state) {
      auto s_cols = [&](int k, int m) -> T {   // S_in[k][ns + m]
        return k < p && ns + m < n ? s_in[static_cast<int64_t>(k) * n + ns + m] : T(0);
      };
      staged<ROWS, COLS>(ab, p, dy_rows, s_cols, tid, ty, tx, acc);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int ii = ty * 4 + a;
        const T d = exp_t(cq[ii]);
        T part = T(0);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          acc[a][b] *= d;
          part += acc[a][b] * c_rows(ns + tx * 4 + b, ii);
        }
        rowacc[a] += row_sum(part);
      }
    }
    tile_io(dcbase, hrow, i0, ns, q, n, ty, tx, acc, true);
  }

  // the key tiles J <= I
  for (int J = 0; J <= static_cast<int>(blockIdx.y); ++J) {
    const int j0 = J * TILE;
    __syncthreads();                         // ck, Ms and the operand tile read
    if (tid < TILE) ck[tid] = j0 + tid < q ? cumb[j0 + tid] : T(0);
    auto b_rows = [&](int k, int m) -> T {     // B_J[m][k]
      return j0 + m < q && k < n ? bbase[static_cast<int64_t>(j0 + m) * brow + k] : T(0);
    };
    auto x_rows = [&](int k, int m) -> T {     // X_J[m][k]
      return j0 + m < q && k < p ? xbase[static_cast<int64_t>(j0 + m) * xrow + k] : T(0);
    };
    T gacc[4][4], macc[4][4];
    zero(gacc);
    zero(macc);
    staged<ROWS, ROWS>(ab, n, c_rows, b_rows, tid, ty, tx, gacc);   // G_IJ
    staged<ROWS, ROWS>(ab, p, dy_rows, x_rows, tid, ty, tx, macc);  // dY_I X_Jᵀ
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int ii = ty * 4 + a, i = i0 + ii;
      T part = T(0);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int jj = tx * 4 + b, j = j0 + jj;
        T mv = T(0);
        if (i >= j && i < q) mv = macc[a][b] * exp_t(cq[ii] - ck[jj]);
        part += gacc[a][b] * mv;
        Ms[jj * LDS + ii] = mv;
      }
      rowacc[a] += row_sum(part);
    }
    // dC_I += M_IJ B_J, a 64-column slice of n at a time
    for (int s = 0; s < n_ns; ++s) {
      const int ns = s * TILE;
      __syncthreads();                       // Ms written; the last tile read
      load_tile(ab, bbase, brow, j0, ns, q, n, tid);
      __syncthreads();
      tile_io(dcbase, hrow, i0, ns, q, n, ty, tx, acc, false);
      micro(Ms, ab, TILE, ty, tx, acc);
      tile_io(dcbase, hrow, i0, ns, q, n, ty, tx, acc, true);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty * 4 + a;
      if (i < q) dcq[pl.bh * l + pl.t0 + i] = rowacc[a];
    }
  }
}

// Launch 4: key tile J of one chunk.  dX_J (into dx (b, l, h, p)), dB_J (per
// head, into dbh (b, l, h, n)) and the column part of dcum (into dck
// (b, h, l)), with the terms of the gradient dS_out of the state leaving the
// chunk (dso[c]; for the last chunk the final state's, absent without one).
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_key_kernel(const T* __restrict__ xd, const T* __restrict__ dy,
                   const T* __restrict__ Bm, const T* __restrict__ Cm,
                   const T* __restrict__ cum, const T* __restrict__ entering,
                   const T* __restrict__ fstate, const T* __restrict__ dso, int has_dfinal,
                   T* __restrict__ dbh, T* __restrict__ dx, T* __restrict__ dck, int64_t l,
                   int h, int p, int g, int n, int q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ab = reinterpret_cast<T*>(smem_raw);   // stages; an operand tile between products
  T* Ms = ab + 4 * KC * LDS;                // (TILE, LDS) M_IJᵀ, query-major
  T* GLs = Ms + TILE * LDS;                 // (TILE, LDS) (G ∘ L)_IJᵀ, query-major
  T* cq = GLs + TILE * LDS;                 // (TILE) cum of the query rows
  T* ck = cq + TILE;                        // (TILE) cum of the key rows
  T* red = ck + TILE;                       // (THREADS / 32) warp sums

  const Plane pl = plane_of(l, h, g, q);
  const int64_t nc = l / q;
  const int j0 = blockIdx.y * TILE;
  const int n_tiles = gridDim.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t xrow = static_cast<int64_t>(h) * p, brow = static_cast<int64_t>(g) * n;
  const int64_t hrow = static_cast<int64_t>(h) * n;
  const int64_t pn = static_cast<int64_t>(p) * n;
  const T* xbase = xd + (pl.bi * l + pl.t0) * xrow + static_cast<int64_t>(pl.hh) * p;
  const T* dybase = dy + (pl.bi * l + pl.t0) * xrow + static_cast<int64_t>(pl.hh) * p;
  T* dxbase = dx + (pl.bi * l + pl.t0) * xrow + static_cast<int64_t>(pl.hh) * p;
  const T* bbase = Bm + (pl.bi * l + pl.t0) * brow + static_cast<int64_t>(pl.gi) * n;
  const T* cbase = Cm + (pl.bi * l + pl.t0) * brow + static_cast<int64_t>(pl.gi) * n;
  T* dbbase = dbh + (pl.bi * l + pl.t0) * hrow + static_cast<int64_t>(pl.hh) * n;
  const T* cumb = cum + pl.bh * l + pl.t0;
  const T* ds_out = dso + pl.bhc * pn;                               // (p, n)
  const T* s_out = pl.c + 1 < nc ? entering + (pl.bhc + 1) * pn : fstate + pl.bh * pn;
  const bool has_dso = pl.c + 1 < nc || has_dfinal;
  const int n_ns = (n + TILE - 1) / TILE, n_ps = (p + TILE - 1) / TILE;
  const T cum_last = cumb[q - 1];

  if (tid < TILE) ck[tid] = j0 + tid < q ? cumb[j0 + tid] : T(0);
  __syncthreads();
  T dec[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) dec[a] = exp_t(cum_last - ck[ty * 4 + a]);

  T rowacc[4] = {T(0), T(0), T(0), T(0)};
  T acc[4][4];
  auto x_rows = [&](int k, int m) -> T {       // X_J[m][k]
    return j0 + m < q && k < p ? xbase[static_cast<int64_t>(j0 + m) * xrow + k] : T(0);
  };
  auto b_rows = [&](int k, int m) -> T {       // B_J[m][k]
    return j0 + m < q && k < n ? bbase[static_cast<int64_t>(j0 + m) * brow + k] : T(0);
  };

  // dS_out terms: dB_J = diag(e^{cum_last - cum}) X_J dS_out (and its dcum
  // part -sum_n B dB), dX_J = diag(e^{cum_last - cum}) B_J dS_outᵀ
  for (int s = 0; s < n_ns; ++s) {
    const int ns = s * TILE;
    zero(acc);
    if (has_dso) {
      auto so_cols = [&](int k, int m) -> T {  // dS_out[k][ns + m]
        return k < p && ns + m < n ? ds_out[static_cast<int64_t>(k) * n + ns + m] : T(0);
      };
      staged<ROWS, COLS>(ab, p, x_rows, so_cols, tid, ty, tx, acc);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        T part = T(0);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          acc[a][b] *= dec[a];
          part += acc[a][b] * b_rows(ns + tx * 4 + b, ty * 4 + a);
        }
        rowacc[a] -= row_sum(part);
      }
    }
    tile_io(dbbase, hrow, j0, ns, q, n, ty, tx, acc, true);
  }
  for (int s = 0; s < n_ps; ++s) {
    const int ps = s * TILE;
    zero(acc);
    if (has_dso) {
      auto so_rows = [&](int k, int m) -> T {  // dS_out[ps + m][k]
        return ps + m < p && k < n ? ds_out[static_cast<int64_t>(ps + m) * n + k] : T(0);
      };
      staged<ROWS, ROWS>(ab, n, b_rows, so_rows, tid, ty, tx, acc);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] *= dec[a];
    }
    tile_io(dxbase, xrow, j0, ps, q, p, ty, tx, acc, true);
  }

  // <dS_out, S_out> at the chunk's last row (the block that holds it)
  if (has_dso && j0 <= q - 1 && q - 1 < j0 + TILE) {
    T v = T(0);
    for (int64_t r = tid; r < pn; r += THREADS) v += ds_out[r] * s_out[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if ((tid & 31) == 0) red[tid >> 5] = v;
    __syncthreads();
    T total = T(0);
    for (int w = 0; w < THREADS / 32; ++w) total += red[w];
    const int last = q - 1 - j0;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      if (ty * 4 + a == last) rowacc[a] += total;
  }

  // the query tiles I >= J
  for (int I = blockIdx.y; I < n_tiles; ++I) {
    const int i0 = I * TILE;
    __syncthreads();                         // cq, Ms, GLs and the operand tile read
    if (tid < TILE) cq[tid] = i0 + tid < q ? cumb[i0 + tid] : T(0);
    auto c_rows = [&](int k, int m) -> T {     // C_I[m][k]
      return i0 + m < q && k < n ? cbase[static_cast<int64_t>(i0 + m) * brow + k] : T(0);
    };
    auto dy_rows = [&](int k, int m) -> T {    // dY_I[m][k]
      return i0 + m < q && k < p ? dybase[static_cast<int64_t>(i0 + m) * xrow + k] : T(0);
    };
    T gacc[4][4], macc[4][4];
    zero(gacc);
    zero(macc);
    staged<ROWS, ROWS>(ab, n, b_rows, c_rows, tid, ty, tx, gacc);   // G_IJᵀ
    staged<ROWS, ROWS>(ab, p, x_rows, dy_rows, tid, ty, tx, macc);  // X_J dY_Iᵀ
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int jj = ty * 4 + a, j = j0 + jj;
      T part = T(0);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int ii = tx * 4 + b, i = i0 + ii;
        T lv = T(0);
        if (i >= j && i < q) lv = exp_t(cq[ii] - ck[jj]);
        const T mv = macc[a][b] * lv;
        part += gacc[a][b] * mv;
        Ms[ii * LDS + jj] = mv;
        GLs[ii * LDS + jj] = gacc[a][b] * lv;
      }
      rowacc[a] -= row_sum(part);
    }
    // dB_J += M_IJᵀ C_I, a 64-column slice of n at a time
    for (int s = 0; s < n_ns; ++s) {
      const int ns = s * TILE;
      __syncthreads();
      load_tile(ab, cbase, brow, i0, ns, q, n, tid);
      __syncthreads();
      tile_io(dbbase, hrow, j0, ns, q, n, ty, tx, acc, false);
      micro(Ms, ab, TILE, ty, tx, acc);
      tile_io(dbbase, hrow, j0, ns, q, n, ty, tx, acc, true);
    }
    // dX_J += (G ∘ L)_IJᵀ dY_I, a 64-column slice of p at a time
    for (int s = 0; s < n_ps; ++s) {
      const int ps = s * TILE;
      __syncthreads();
      load_tile(ab, dybase, xrow, i0, ps, q, p, tid);
      __syncthreads();
      tile_io(dxbase, xrow, j0, ps, q, p, ty, tx, acc, false);
      micro(GLs, ab, TILE, ty, tx, acc);
      tile_io(dxbase, xrow, j0, ps, q, p, ty, tx, acc, true);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = j0 + ty * 4 + a;
      if (j < q) dck[pl.bh * l + pl.t0 + j] = rowacc[a];
    }
  }
}

// Launch 5.  blockIdx.y 0 / 1: dB / dC (b, l, g, n) = the per-head dbh / dch
// summed over the h / g heads of the group in ascending order, one thread an
// element; blockIdx.y 2: dad (b, l, h), one thread a (b, h, chunk), the
// reverse running sum of dcq + dck from the chunk's last row to its first.
template <typename T>
__global__ void ssd_bwd_finish_kernel(const T* __restrict__ dcq, const T* __restrict__ dck,
                                      T* __restrict__ dad, const T* __restrict__ dbh,
                                      const T* __restrict__ dch, T* __restrict__ dB,
                                      T* __restrict__ dC, int64_t b, int64_t l, int h, int g,
                                      int n, int q) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (blockIdx.y < 2) {
    const int64_t gn = static_cast<int64_t>(g) * n;
    if (idx >= b * l * gn) return;
    const int64_t bt = idx / gn;
    const int rem = static_cast<int>(idx % gn);
    const int gi = rem / n, k = rem % n, hg = h / g;
    const T* src = (blockIdx.y == 0 ? dbh : dch) + (bt * h + static_cast<int64_t>(gi) * hg) * n + k;
    T s = T(0);
    for (int j = 0; j < hg; ++j) s += src[static_cast<int64_t>(j) * n];
    (blockIdx.y == 0 ? dB : dC)[idx] = s;
    return;
  }
  const int64_t nc = l / q;
  if (idx >= b * h * nc) return;
  const int64_t bh = idx / nc, c = idx % nc;
  const int64_t bi = bh / h;
  const int hh = static_cast<int>(bh % h);
  T run = T(0);
  for (int i = q - 1; i >= 0; --i) {
    const int64_t t = c * q + i;
    run += dcq[bh * l + t] + dck[bh * l + t];
    dad[(bi * l + t) * h + hh] = run;
  }
}

// Dynamic shared memory of launches 1, 3 and 4 (elements).
constexpr int LOCAL_SMEM = 4 * KC * LDS;
constexpr int QUERY_SMEM = 4 * KC * LDS + TILE * LDS + 2 * TILE;
constexpr int KEY_SMEM = 4 * KC * LDS + 2 * TILE * LDS + 2 * TILE + THREADS / 32;

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

template <typename T>
cudaError_t local_term(const void* dy, const void* C, const void* cum, void* local, int64_t b,
                       int64_t l, int h, int p, int g, int n, int q, cudaStream_t st) {
  const size_t smem = LOCAL_SMEM * sizeof(T);
  cudaError_t err = set_smem(ssd_bwd_local_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(b * h * (l / q)), static_cast<unsigned>((p + TILE - 1) / TILE),
                  static_cast<unsigned>((n + TILE - 1) / TILE));
  ssd_bwd_local_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(C), static_cast<const T*>(cum),
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

template <typename T>
cudaError_t query_side(const void* xd, const void* dy, const void* B, const void* C,
                       const void* cum, const void* entering, int has_init, void* dch, void* dcq,
                       int64_t b, int64_t l, int h, int p, int g, int n, int q, cudaStream_t st) {
  const size_t smem = QUERY_SMEM * sizeof(T);
  cudaError_t err = set_smem(ssd_bwd_query_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(b * h * (l / q)), static_cast<unsigned>((q + TILE - 1) / TILE));
  ssd_bwd_query_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(xd), static_cast<const T*>(dy), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const T*>(cum), static_cast<const T*>(entering),
      has_init, static_cast<T*>(dch), static_cast<T*>(dcq), l, h, p, g, n, q);
  return cudaGetLastError();
}

template <typename T>
cudaError_t key_side(const void* xd, const void* dy, const void* B, const void* C,
                     const void* cum, const void* entering, const void* fstate, const void* dso,
                     int has_dfinal, void* dbh, void* dx, void* dck, int64_t b, int64_t l, int h,
                     int p, int g, int n, int q, cudaStream_t st) {
  const size_t smem = KEY_SMEM * sizeof(T);
  cudaError_t err = set_smem(ssd_bwd_key_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(b * h * (l / q)), static_cast<unsigned>((q + TILE - 1) / TILE));
  ssd_bwd_key_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(xd), static_cast<const T*>(dy), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const T*>(cum), static_cast<const T*>(entering),
      static_cast<const T*>(fstate), static_cast<const T*>(dso), has_dfinal,
      static_cast<T*>(dbh), static_cast<T*>(dx), static_cast<T*>(dck), l, h, p, g, n, q);
  return cudaGetLastError();
}

template <typename T>
cudaError_t finish(const void* dcq, const void* dck, void* dad, const void* dbh, const void* dch,
                   void* dB, void* dC, int64_t b, int64_t l, int h, int g, int n, int q,
                   cudaStream_t st) {
  const int64_t elems = b * l * g * n, chunks = b * h * (l / q);
  const int64_t most = elems > chunks ? elems : chunks;
  const dim3 grid(static_cast<unsigned>((most + THREADS - 1) / THREADS), 3);
  ssd_bwd_finish_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(dcq), static_cast<const T*>(dck), static_cast<T*>(dad),
      static_cast<const T*>(dbh), static_cast<const T*>(dch), static_cast<T*>(dB),
      static_cast<T*>(dC), b, l, h, g, n, q);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry point takes one element type (float64 when is_double), runs
// on `stream` (the caller makes its device current) and returns the
// cudaError_t of its attribute call or launch.  Layouts: xd, dy, dx (b, l,
// h, p); ad, dad (b, l, h); B, C, dB, dC (b, l, g, n); dbh, dch (b, l, h, n)
// scratch; cum, dcq, dck (b, h, l); entering, local, dso (b, h, l / chunk,
// p, n); fstate, dfinal, dinit (b, h, p, n).

// Launch 1: local (b, h, nc, p, n) from dy, C and the forward's cum.
int repro_ssd_bwd_local(const void* dy, const void* C, const void* cum, void* local, int64_t b,
                        int64_t l, int h, int p, int g, int n, int chunk, int is_double,
                        void* stream) {
  if (bad_shape(b, l, h, p, g, n, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_double
      ? local_term<double>(dy, C, cum, local, b, l, h, p, g, n, chunk, st)
      : local_term<float>(dy, C, cum, local, b, l, h, p, g, n, chunk, st));
}

// Launch 2: dso (b, h, nc, p, n) and dinit (nullable) from local, cum and
// dfinal (nullable: zero).
int repro_ssd_bwd_state_pass(const void* local, void* dso, const void* cum, const void* dfinal,
                             void* dinit, int64_t b, int64_t l, int h, int p, int n, int chunk,
                             int is_double, void* stream) {
  if (bad_shape(b, l, h, p, 1, n, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_double
      ? state_pass<double>(local, dso, cum, dfinal, dinit, b, l, h, p, n, chunk, st)
      : state_pass<float>(local, dso, cum, dfinal, dinit, b, l, h, p, n, chunk, st));
}

// Launch 3: dch and dcq; has_init is 1 when the forward started from a given
// state (entering[chunk 0] is then that state).
int repro_ssd_bwd_query(const void* xd, const void* dy, const void* B, const void* C,
                        const void* cum, const void* entering, int has_init, void* dch,
                        void* dcq, int64_t b, int64_t l, int h, int p, int g, int n, int chunk,
                        int is_double, void* stream) {
  if (bad_shape(b, l, h, p, g, n, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_double
      ? query_side<double>(xd, dy, B, C, cum, entering, has_init, dch, dcq, b, l, h, p, g, n,
                           chunk, st)
      : query_side<float>(xd, dy, B, C, cum, entering, has_init, dch, dcq, b, l, h, p, g, n,
                          chunk, st));
}

// Launch 4: dbh, dx and dck; fstate is the forward's final state, has_dfinal
// 1 when the final state has a gradient (dso's last chunk is then it).
int repro_ssd_bwd_key(const void* xd, const void* dy, const void* B, const void* C,
                      const void* cum, const void* entering, const void* fstate, const void* dso,
                      int has_dfinal, void* dbh, void* dx, void* dck, int64_t b, int64_t l,
                      int h, int p, int g, int n, int chunk, int is_double, void* stream) {
  if (bad_shape(b, l, h, p, g, n, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_double
      ? key_side<double>(xd, dy, B, C, cum, entering, fstate, dso, has_dfinal, dbh, dx, dck, b,
                         l, h, p, g, n, chunk, st)
      : key_side<float>(xd, dy, B, C, cum, entering, fstate, dso, has_dfinal, dbh, dx, dck, b,
                        l, h, p, g, n, chunk, st));
}

// Launch 5: dad, dB and dC.
int repro_ssd_bwd_finish(const void* dcq, const void* dck, void* dad, const void* dbh,
                         const void* dch, void* dB, void* dC, int64_t b, int64_t l, int h, int g,
                         int n, int chunk, int is_double, void* stream) {
  if (bad_shape(b, l, h, 1, g, n, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_double
      ? finish<double>(dcq, dck, dad, dbh, dch, dB, dC, b, l, h, g, n, chunk, st)
      : finish<float>(dcq, dck, dad, dbh, dch, dB, dC, b, l, h, g, n, chunk, st));
}

const char* repro_ssd_bwd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
