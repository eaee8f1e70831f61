// Tensor-core and staging helpers of kernel B8 (sm_90a), shared by its
// forward (ssd_fused.cu) and its backward (ssd_bwd.cu).
//
// Products in fp32 run as mma.sync.m16n8k8 TF32 with the 3xTF32 split: each
// operand x = hi + lo (split below), and a_lo b_hi + a_hi b_lo + a_hi b_hi is
// accumulated in fp32, so the error stays near fp32's level (one TF32 pass
// rounds at 2^-11).  A warp computes a 16 x 32 piece of a 64 x 64 output
// tile: four n-tiles of 8, c[j][e] holding row g (+ 8 for e >= 2), column
// 8 j + 2 t + (e & 1) of n-tile j, g = lane / 4, t = lane % 4.  Fragments
// come from shared memory: ldmatrix where the contraction runs along a
// tile's rows (row stride = 4 mod 32 words: conflict-free), scalar loads
// where it runs down its columns (row stride = 8 mod 32 words).
//
// Operand tiles are staged with cp.async (16-byte copies where the source
// rows allow, else one element a copy), zero-filled outside the source's
// bounds, so no register holds a tile on its way to shared memory.
//
// The bf16 forms of both kernels keep the fp32 forms' arithmetic: bf16
// storage is widened to float as it is loaded (exact) and each output is
// rounded once, to nearest even, as it is stored (as_acc, store_as below).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace ssd_mma {

// Element-type codes of the C entry points (kernels/ssd.py, kernels/gather.py).
enum DtypeCode : int { kFloat32 = 0, kFloat64 = 1, kBfloat16 = 2 };

// A stored value as the accumulation type reads it: float and double as
// they are, bf16 widened to float (exact).
__device__ __forceinline__ float as_acc(float v) { return v; }
__device__ __forceinline__ double as_acc(double v) { return v; }
__device__ __forceinline__ float as_acc(__nv_bfloat16 v) { return __bfloat162float(v); }

// An accumulated value stored as S: rounded once to nearest even for bf16.
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(double* p, double v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// x = hi + lo: hi is x rounded to TF32's 10 mantissa bits, half an ulp
// away from zero (an integer add and mask, full rate, where cvt.rna takes
// the conversion pipe); lo = x - hi, exact in fp32, goes to the tensor core
// as it is, which reads its top 19 bits (|lo| <= 2^-11 |x|, so the part it
// drops is below 2^-21 |x|).
__device__ __forceinline__ void split(uint32_t raw, uint32_t& hi, uint32_t& lo) {
  hi = (raw + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(raw) - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c[j] += A B_j over one k8 step, 3xTF32.  a: the raw fp32 A fragment
// (rows g, g + 8; cols t, t + 4); b[j]: the raw B fragment of n-tile j.
// Each c[j] takes a_lo b_hi, then a_hi b_lo, then a_hi b_hi; the three
// passes run over the four n-tiles in turn, so that consecutive mma
// instructions never wait on one another.
__device__ __forceinline__ void mma3(float (&c)[4][4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[4][2]) {
  uint32_t ah[4], al[4], bh[4][2], bl[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], ah[i], al[i]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    split(b[j][0], bh[j][0], bl[j][0]);
    split(b[j][1], bh[j][1], bl[j][1]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) mma_tf32(c[j], al, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < 4; ++j) mma_tf32(c[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
  for (int j = 0; j < 4; ++j) mma_tf32(c[j], ah, bh[j][0], bh[j][1]);
}

// A fragment (rows mb .. mb + 15, cols kb .. kb + 7) of a row-major tile,
// A[m][k] at S[m * ld + k].
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const float* S, int ld, int mb,
                                       int kb, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  ldsm_x4(a, S + (mb + r + (mi & 1) * 8) * ld + kb + (mi >> 1) * 4);
}

// The same fragment of a k-major tile, A[m][k] at S[k * ld + m].
__device__ __forceinline__ void frag_a_cols(uint32_t (&a)[4], const float* S, int ld, int mb,
                                            int kb, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = S + (kb + t) * ld + mb + g;
  a[0] = __float_as_uint(p[0]);
  a[1] = __float_as_uint(p[8]);
  a[2] = __float_as_uint(p[4 * ld]);
  a[3] = __float_as_uint(p[4 * ld + 8]);
}

// B fragments of n-tiles 0 .. 3 from a tile whose rows are n, B[k][n] at
// S[n * ld + k] (rows nb + 8 j + ...).
__device__ __forceinline__ void frag_b_rows(uint32_t (&b)[4][2], const float* S, int ld,
                                            int nb, int kb, int lane) {
  const int mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int j = 0; j < 4; j += 2) {
    uint32_t q[4];
    ldsm_x4(q, S + (nb + 8 * (j + (mi >> 1)) + r) * ld + kb + (mi & 1) * 4);
    b[j][0] = q[0]; b[j][1] = q[1]; b[j + 1][0] = q[2]; b[j + 1][1] = q[3];
  }
}

// B fragments of n-tiles 0 .. 3 from a k-major tile, B[k][n] at S[k * ld + n].
__device__ __forceinline__ void frag_b_cols(uint32_t (&b)[4][2], const float* S, int ld,
                                            int nb, int kb, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    b[j][0] = __float_as_uint(S[(kb + t) * ld + nb + 8 * j + g]);
    b[j][1] = __float_as_uint(S[(kb + t + 4) * ld + nb + 8 * j + g]);
  }
}

// cp.async of `bytes` (4, 8 or 16) into shared memory, of which the first
// src_bytes are read from src and the rest zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(BYTES), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace ssd_mma
