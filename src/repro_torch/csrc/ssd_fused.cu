// Fused Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd.py::_ssd_fused_kernel (launched
// by ssd_fused).  Inputs: xd (b, l, h, p) (x pre-multiplied by dt), ad
// (b, l, h) (dt * A, negative), B and C (b, l, g, n), each head h reading
// group g = h / (h_heads / n_groups); optional initial state (b, h, p, n).
// Per (b, h) and chunk of q rows, with cum the running sum of ad in the chunk:
//   y_i   = sum_{j <= i} (C_i . B_j) e^{cum_i - cum_j} x_j + e^{cum_i} C_i stateᵀ
//   state = state e^{cum_{q-1}} + sum_j e^{cum_{q-1} - cum_j} x_j ⊗ B_j
// Outputs y (b, l, h, p) and the final state (b, h, p, n).  Everything is
// computed in the element type T (float, or double for float64 inputs: the
// reference accumulates in promote(xd, f32)).
//
// What bounds it on the card: operations.  At mamba2's prefill (q = 256,
// p = 64, n = 128) the lower triangle of C Bᵀ, its product with x and the
// state terms are ~(2 q² n + q² p + 4 q n p) per chunk and head, ~4.7 GFLOP
// a layer at l = 512, b = 1, against ~24 MB of xd, ad, B, C, y and state.
//
// Design, right and simple first:
//   * One block per (b, h) plane and p_block-wide slice of the head's
//     columns (grid (b * h, p / p_block)): output columns are independent,
//     so when b * h does not fill the 132 SMs the host halves p_block and
//     each half recomputes the (cheap) decay tile.  The chunk loop runs
//     inside the block, carrying the (p_block, n) state in shared memory.
//   * The (q, q) decay matrix never exists: at q = 256 it is 256 KB at
//     fp32, more than a block may claim.  Query rows go in tiles of TILE;
//     for each, key tiles j0 <= i0 form G = (C_I B_Jᵀ) ∘ L in shared memory,
//     L computed on the fly from cum only where i >= j (cum_i - cum_j <= 0
//     there; above the diagonal G is 0, never exp(+) * 0), and Y_I += G x_J.
//   * B and C are read in place through the group index, never repeated per
//     head.  Shared-memory rows of n are padded by one element so a warp's
//     column walks hit distinct banks.
//   * cum: the chunk's ad values are loaded by all threads, then summed in
//     order by one thread (the reference's sequential cumsum).
//   * Above 48 KB of dynamic shared memory the kernel first raises its
//     limit with cudaFuncSetAttribute; a refused request or launch is
//     returned as its cudaError_t (and cleared), never silent.
// Left for later: tensor-core (mma / wgmma, TF32) products for the tiles,
// register micro-tiles, and a split of the chunk loop across blocks with a
// second pass for the carried state (ROADMAP A11).
//
// The host wrapper is repro_torch/kernels/ssd.py::ssd_fused; it validates
// device, dtype, shape and contiguity, plans the launch
// (repro_torch/analysis/preflight.py::plan_ssd_fused), allocates the
// outputs and raises on a non-zero return code.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TILE = 32;

template <typename T>
__device__ __forceinline__ T exp_t(T v);
template <>
__device__ __forceinline__ float exp_t<float>(float v) { return expf(v); }
template <>
__device__ __forceinline__ double exp_t<double>(double v) { return exp(v); }

size_t smem_elems(int q, int pb, int n) {
  return static_cast<size_t>(q) + static_cast<size_t>(pb) * (n + 1) +
         2 * static_cast<size_t>(TILE) * (n + 1) + static_cast<size_t>(TILE) * pb +
         static_cast<size_t>(TILE) * (TILE + 1) + static_cast<size_t>(TILE) * pb;
}

template <typename T>
__global__ void __launch_bounds__(1024)
ssd_fused_kernel(const T* __restrict__ xd, const T* __restrict__ ad,
                 const T* __restrict__ Bm, const T* __restrict__ Cm,
                 const T* __restrict__ init, T* __restrict__ y,
                 T* __restrict__ fstate, int64_t l, int h, int p, int g, int n,
                 int q, int pb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ns = n + 1;                 // padded row stride of n-wide rows
  T* cum = reinterpret_cast<T*>(smem_raw);   // (q)
  T* st = cum + q;                      // (pb, ns) carried state
  T* cq = st + pb * ns;                 // (TILE, ns) C rows of the query tile
  T* bk = cq + TILE * ns;               // (TILE, ns) B rows of the key tile
  T* xk = bk + TILE * ns;               // (TILE, pb) x rows of the key tile
  T* gm = xk + TILE * pb;               // (TILE, TILE + 1) decay-weighted C Bᵀ
  T* yt = gm + TILE * (TILE + 1);       // (TILE, pb) output tile

  const int64_t bi = blockIdx.x / h;
  const int hh = blockIdx.x % h;
  const int p0 = blockIdx.y * pb;
  const int gi = hh / (h / g);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t row = static_cast<int64_t>(h) * p;   // xd / y stride per token
  const int64_t brow = static_cast<int64_t>(g) * n;  // B / C stride per token
  const T* xbase = xd + bi * l * row + static_cast<int64_t>(hh) * p + p0;
  T* ybase = y + bi * l * row + static_cast<int64_t>(hh) * p + p0;
  const T* abase = ad + bi * l * h + hh;
  const T* bbase = Bm + bi * l * brow + static_cast<int64_t>(gi) * n;
  const T* cbase = Cm + bi * l * brow + static_cast<int64_t>(gi) * n;
  const int64_t sbase = ((bi * h + hh) * p + p0) * static_cast<int64_t>(n);

  for (int e = tid; e < pb * n; e += nt) {
    const int pp = e / n, k = e % n;
    st[pp * ns + k] = init ? init[sbase + static_cast<int64_t>(pp) * n + k] : T(0);
  }

  const int64_t n_chunks = l / q;
  for (int64_t c = 0; c < n_chunks; ++c) {
    const int64_t t0 = c * q;
    for (int i = tid; i < q; i += nt) cum[i] = abase[(t0 + i) * h];
    __syncthreads();                    // also: the last chunk's state is final
    if (tid == 0) {
      T s = 0;
      for (int i = 0; i < q; ++i) {
        s += cum[i];
        cum[i] = s;
      }
    }
    __syncthreads();
    const T cum_last = cum[q - 1];

    for (int i0 = 0; i0 < q; i0 += TILE) {
      const int ti = min(TILE, q - i0);
      for (int e = tid; e < ti * n; e += nt) {
        const int i = e / n, k = e % n;
        cq[i * ns + k] = cbase[(t0 + i0 + i) * brow + k];
      }
      __syncthreads();
      // carried-state term: e^{cum_i} C_i stateᵀ (the state before the chunk)
      for (int e = tid; e < ti * pb; e += nt) {
        const int i = e / pb, pp = e % pb;
        T acc = 0;
        for (int k = 0; k < n; ++k) acc += cq[i * ns + k] * st[pp * ns + k];
        yt[i * pb + pp] = exp_t(cum[i0 + i]) * acc;
      }
      // intra-chunk term over the key tiles on or below the diagonal
      for (int j0 = 0; j0 <= i0; j0 += TILE) {
        const int tj = min(TILE, q - j0);
        __syncthreads();                // the last key tile's readers are done
        for (int e = tid; e < tj * n; e += nt) {
          const int j = e / n, k = e % n;
          bk[j * ns + k] = bbase[(t0 + j0 + j) * brow + k];
        }
        for (int e = tid; e < tj * pb; e += nt) {
          const int j = e / pb, pp = e % pb;
          xk[j * pb + pp] = xbase[(t0 + j0 + j) * row + pp];
        }
        __syncthreads();
        for (int e = tid; e < ti * tj; e += nt) {
          const int i = e / tj, j = e % tj;
          T v = 0;
          if (i0 + i >= j0 + j) {
            T acc = 0;
            for (int k = 0; k < n; ++k) acc += cq[i * ns + k] * bk[j * ns + k];
            v = acc * exp_t(cum[i0 + i] - cum[j0 + j]);
          }
          gm[i * (TILE + 1) + j] = v;
        }
        __syncthreads();
        for (int e = tid; e < ti * pb; e += nt) {
          const int i = e / pb, pp = e % pb;
          T acc = 0;
          for (int j = 0; j < tj; ++j) acc += gm[i * (TILE + 1) + j] * xk[j * pb + pp];
          yt[i * pb + pp] += acc;
        }
      }
      for (int e = tid; e < ti * pb; e += nt) {
        const int i = e / pb, pp = e % pb;
        ybase[(t0 + i0 + i) * row + pp] = yt[i * pb + pp];
      }
      __syncthreads();                  // cq, yt and the state reads are done
    }

    // state update: each thread owns the same state entries throughout
    const T dec = exp_t(cum_last);
    for (int e = tid; e < pb * n; e += nt) st[(e / n) * ns + e % n] *= dec;
    for (int j0 = 0; j0 < q; j0 += TILE) {
      const int tj = min(TILE, q - j0);
      __syncthreads();
      for (int e = tid; e < tj * n; e += nt) {
        const int j = e / n, k = e % n;
        bk[j * ns + k] = exp_t(cum_last - cum[j0 + j]) * bbase[(t0 + j0 + j) * brow + k];
      }
      for (int e = tid; e < tj * pb; e += nt) {
        const int j = e / pb, pp = e % pb;
        xk[j * pb + pp] = xbase[(t0 + j0 + j) * row + pp];
      }
      __syncthreads();
      for (int e = tid; e < pb * n; e += nt) {
        const int pp = e / n, k = e % n;
        T acc = 0;
        for (int j = 0; j < tj; ++j) acc += xk[j * pb + pp] * bk[j * ns + k];
        st[pp * ns + k] += acc;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < pb * n; e += nt) {
    const int pp = e / n, k = e % n;
    fstate[sbase + static_cast<int64_t>(pp) * n + k] = st[pp * ns + k];
  }
}

template <typename T>
cudaError_t launch(const void* xd, const void* ad, const void* B, const void* C,
                   const void* init, void* y, void* fstate, int64_t b, int64_t l,
                   int h, int p, int g, int n, int q, int pb, int threads,
                   cudaStream_t stream) {
  const size_t smem = smem_elems(q, pb, n) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();   // clear it: a later launch must not report it
    return err;
  }
  const dim3 grid(static_cast<unsigned>(b * h), static_cast<unsigned>(p / pb));
  ssd_fused_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(xd), static_cast<const T*>(ad),
      static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<const T*>(init), static_cast<T*>(y), static_cast<T*>(fstate),
      l, h, p, g, n, q, pb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xd, y (b, l, h, p); ad (b, l, h); B, C (b, l, g, n); init (nullable) and
// fstate (b, h, p, n); all one element type, float64 when is_double.  l a
// multiple of the chunk q, h of g, p of p_block.  The caller makes the
// stream's device current.  Returns the cudaError_t of the attribute call
// or the launch.
int repro_ssd_fused(const void* xd, const void* ad, const void* B, const void* C,
                    const void* init, void* y, void* fstate, int64_t b, int64_t l,
                    int h, int p, int g, int n, int chunk, int p_block,
                    int threads, int is_double, void* stream) {
  if (b <= 0 || h <= 0 || p <= 0 || g <= 0 || n <= 0 || chunk <= 0 ||
      p_block <= 0 || l < chunk || l % chunk != 0 || h % g != 0 ||
      p % p_block != 0 || threads <= 0 || threads > 1024 || b * h > 2147483647 ||
      p / p_block > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_double ? launch<double>(xd, ad, B, C, init, y, fstate, b, l, h, p, g, n,
                                 chunk, p_block, threads, st)
                : launch<float>(xd, ad, B, C, init, y, fstate, b, l, h, p, g, n,
                                chunk, p_block, threads, st);
  return static_cast<int>(err);
}

const char* repro_ssd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
