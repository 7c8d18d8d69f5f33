// Shared pieces of the row-wise int8 kernels (quant.cu, fused_sampler.cu):
// the scale and quantize of a row, the sampler step, and the warp and
// block row routes of quant.cu.
//
// Every floating-point step is an explicit round-to-nearest intrinsic
// (__fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn): the compiler may neither
// contract them into FMAs nor swap in approximate division or square root,
// so each kernel rounds exactly where its plain PyTorch version does and
// the two agree bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kModeDdim = 0;  // two-term DDIM step from (abar_t, abar_s)
constexpr int kModeRf = 1;    // rectified-flow Euler step x + dt*v

__device__ __forceinline__ float load_f32(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Row scale amax/127 (IEEE quotient), or 1.0 for an all-zero row.
__device__ __forceinline__ float row_scale(float amax) {
  return amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
}

// clip(round-half-even(v/scale), -127, 127) as int8.
__device__ __forceinline__ int8_t quantize(float v, float scale) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// Classifier-free guidance: eps_u + g*(eps_c - eps_u); g == 1 uses eps_c.
__device__ __forceinline__ float cfg_combine(float ec, float eu, float g) {
  return g == 1.f ? ec : __fadd_rn(eu, __fmul_rn(g, __fsub_rn(ec, eu)));
}

// One sampler-step tail, as repro_torch.core.samplers.step_update, from the
// step's two coefficients (c0, c1):
// ddim: x0 = (x - sqrt(1-c0)*eps)/sqrt(c0); sqrt(c1)*x0 + sqrt(1-c1)*eps
// rf:   x + c0*eps
// split into the factors the coefficients give (step_factors: uniform, so
// a kernel takes them once per thread, as the plain version takes the
// roots once per call on the scalars) and the per-element part
// (step_apply).  Together they round exactly where the plain version does.
struct StepFactors {
  float sqrt_1m_t, sqrt_t, sqrt_s, sqrt_1m_s;  // ddim: the four roots
  float dt;                                    // rf: c0
};

__device__ __forceinline__ StepFactors step_factors(int mode, float c0, float c1) {
  if (mode == kModeDdim)
    return {__fsqrt_rn(__fsub_rn(1.f, c0)), __fsqrt_rn(c0), __fsqrt_rn(c1),
            __fsqrt_rn(__fsub_rn(1.f, c1)), 0.f};
  return {0.f, 0.f, 0.f, 0.f, c0};
}

__device__ __forceinline__ float step_apply(int mode, const StepFactors& f, float x, float eps) {
  if (mode == kModeDdim) {
    const float x0 = __fdiv_rn(__fsub_rn(x, __fmul_rn(f.sqrt_1m_t, eps)), f.sqrt_t);
    return __fadd_rn(__fmul_rn(f.sqrt_s, x0), __fmul_rn(f.sqrt_1m_s, eps));
  }
  return __fadd_rn(x, __fmul_rn(f.dt, eps));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// One warp per row, rows of at most 32*PT elements: lane l holds elements
// l, l+32, ... in registers, so the row is read once and q written once.
// `value(i)` yields the fp32 value at flat index i.  A warp's row index is
// uniform, so a warp past the last row returns as a whole.
template <int PT, class Value>
__global__ void quant_rows_warp(Value value, int8_t* __restrict__ q, float* __restrict__ s,
                                long long rows, int len) {
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long base = row * len;
  float v[PT];
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < PT; ++k) {
    const int j = lane + 32 * k;
    v[k] = j < len ? value(base + j) : 0.f;
    amax = fmaxf(amax, fabsf(v[k]));
  }
  const float scale = row_scale(warp_max(amax));
#pragma unroll
  for (int k = 0; k < PT; ++k) {
    const int j = lane + 32 * k;
    if (j < len) q[base + j] = quantize(v[k], scale);
  }
  if (lane == 0) s[row] = scale;
}

// One block per row for rows longer than a warp holds: a first pass takes
// the row max (warp shuffles, then shared memory across warps), a second
// pass recomputes each value and quantizes it.
template <class Value>
__global__ void quant_rows_block(Value value, int8_t* __restrict__ q, float* __restrict__ s,
                                 int len) {
  __shared__ float partial[32];
  __shared__ float scale_sh;
  const long long base = static_cast<long long>(blockIdx.x) * len;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  float amax = 0.f;
  for (int j = threadIdx.x; j < len; j += blockDim.x) amax = fmaxf(amax, fabsf(value(base + j)));
  amax = warp_max(amax);
  if (lane == 0) partial[warp] = amax;
  __syncthreads();
  if (warp == 0) {
    amax = warp_max(lane < nwarps ? partial[lane] : 0.f);
    if (lane == 0) scale_sh = row_scale(amax);
  }
  __syncthreads();
  const float scale = scale_sh;
  for (int j = threadIdx.x; j < len; j += blockDim.x) q[base + j] = quantize(value(base + j), scale);
  if (threadIdx.x == 0) s[blockIdx.x] = scale;
}

constexpr int kWarpRowMax = 1024;  // longest row one warp holds (32 lanes x 32)

template <class Value>
cudaError_t launch_quant_rows(Value value, int8_t* q, float* s, long long rows, int len,
                              cudaStream_t stream) {
  if (len > kWarpRowMax) {
    quant_rows_block<Value><<<static_cast<unsigned>(rows), 256, 0, stream>>>(value, q, s, len);
    return cudaGetLastError();
  }
  constexpr int kWarps = 4;  // rows per 128-thread block
  const unsigned grid = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  const int pt = (len + 31) / 32;
  if (pt <= 1) quant_rows_warp<1, Value><<<grid, 32 * kWarps, 0, stream>>>(value, q, s, rows, len);
  else if (pt <= 2) quant_rows_warp<2, Value><<<grid, 32 * kWarps, 0, stream>>>(value, q, s, rows, len);
  else if (pt <= 4) quant_rows_warp<4, Value><<<grid, 32 * kWarps, 0, stream>>>(value, q, s, rows, len);
  else if (pt <= 8) quant_rows_warp<8, Value><<<grid, 32 * kWarps, 0, stream>>>(value, q, s, rows, len);
  else if (pt <= 16) quant_rows_warp<16, Value><<<grid, 32 * kWarps, 0, stream>>>(value, q, s, rows, len);
  else quant_rows_warp<32, Value><<<grid, 32 * kWarps, 0, stream>>>(value, q, s, rows, len);
  return cudaGetLastError();
}

// Grid size of a grid-stride elementwise pass over n elements.
inline unsigned elementwise_grid(long long n, int threads) {
  const long long blocks = (n + threads - 1) / threads;
  return static_cast<unsigned>(blocks < 65536 ? blocks : 65536);
}

}  // namespace repro
