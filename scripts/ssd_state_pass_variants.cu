// Three forms of kernel B8's state pass (fp32), timed by
// scripts/ssd_state_pass_variants.py: A in place with 64-bit index math,
// B to its own buffer on a (b h, p n / 256) grid, C in place four entries
// a thread.
#include <cuda_runtime.h>
#include <cstdint>
// A: in place, 64-bit index math on a 1-D grid (the first form)
__global__ void k2a(float* __restrict__ states, const float* __restrict__ cum, float* __restrict__ fstate,
                    int64_t b, int64_t l, int h, int p, int n, int q) {
  const int64_t pn = static_cast<int64_t>(p) * n;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= b * h * pn) return;
  const int64_t bh = e / pn, r = e - bh * pn;
  const int64_t nc = l / q;
  float carried = 0.f;
  for (int64_t c = 0; c < nc; ++c) {
    const int64_t idx = (bh * nc + c) * pn + r;
    const float s = states[idx];
    states[idx] = carried;
    carried = carried * expf(cum[bh * l + c * q + q - 1]) + s;
  }
  fstate[e] = carried;
}
// B: out of place, block per (bh, slice of pn): 2D grid, no division
__global__ void k2b(const float* __restrict__ states, float* __restrict__ entering, const float* __restrict__ cum,
                    float* __restrict__ fstate, int64_t l, int pn, int q, int nc) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t bh = blockIdx.y;
  if (r >= pn) return;
  float carried = 0.f;
  for (int c = 0; c < nc; ++c) {
    const int64_t idx = (bh * nc + c) * pn + r;
    const float s = states[idx];
    entering[idx] = carried;
    carried = carried * expf(cum[bh * l + static_cast<int64_t>(c) * q + q - 1]) + s;
  }
  fstate[bh * pn + r] = carried;
}
// C: in place, 2D grid, float4
__global__ void k2c(float* __restrict__ states, const float* __restrict__ cum,
                    float* __restrict__ fstate, int64_t l, int pn, int q, int nc) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  const int64_t bh = blockIdx.y;
  if (r >= pn) return;
  float4 carried = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nc; ++c) {
    float4* sp = reinterpret_cast<float4*>(states + (bh * nc + c) * pn + r);
    const float4 s = *sp;
    *sp = carried;
    const float d = expf(cum[bh * l + static_cast<int64_t>(c) * q + q - 1]);
    carried = make_float4(carried.x * d + s.x, carried.y * d + s.y, carried.z * d + s.z, carried.w * d + s.w);
  }
  *reinterpret_cast<float4*>(fstate + bh * pn + r) = carried;
}
extern "C" {
void run_a(float* st, const float* cum, float* f, int64_t b, int64_t l, int h, int p, int n, int q, void* s) {
  int64_t tot = b * h * (int64_t)p * n;
  k2a<<<(unsigned)((tot + 255) / 256), 256, 0, (cudaStream_t)s>>>(st, cum, f, b, l, h, p, n, q);
}
void run_b(const float* st, float* en, const float* cum, float* f, int64_t bh, int64_t l, int pn, int q, int nc, void* s) {
  k2b<<<dim3((pn + 255) / 256, (unsigned)bh), 256, 0, (cudaStream_t)s>>>(st, en, cum, f, l, pn, q, nc);
}
void run_c(float* st, const float* cum, float* f, int64_t bh, int64_t l, int pn, int q, int nc, void* s) {
  k2c<<<dim3((pn / 4 + 255) / 256, (unsigned)bh), 256, 0, (cudaStream_t)s>>>(st, cum, f, l, pn, q, nc);
}
}
