// The sampler-step kernels: the interior step, and the fused int8 segment
// boundaries (the sampler step that is the handoff).
//
// Interior step -- replaces the Pallas kernel
//   repro/kernels/fused_sampler/kernel.py::fused_cfg_step_fwd
//     (body _fused_kernel).
// eps = eu + g*(ec - eu) with no skip at g == 1 (the TPU kernel combines
// unconditionally; with eu aliasing ec that is ec for finite values), then
// ddim: c1*x + c2*eps (the affine collapse) or rf: x + c1*eps, in fp32,
// stored in x's dtype.  One flat grid-stride pass; g, c1 and c2 are launch
// arguments (static in the TPU kernel); eu may alias ec, so no pointer is
// __restrict__.  It reads 3*n*sizeof(T) bytes and writes n*sizeof(T): at
// the relay's latents (8 x 8x8x4) launch latency bounds it.  A fused
// elementwise pass is a natural Triton case; it is CUDA C++ so that it
// builds into the one library beside the boundary kernels, with one launch
// path and this source's --fmad=false.
//
// Boundaries -- replace the Pallas kernels
//   repro/kernels/fused_sampler/kernel.py::fused_cfg_step_quant_fwd
//     (body _fused_quant_kernel, tail _combine_update) -- the emit, and
//   repro/kernels/fused_sampler/kernel.py::fused_cfg_step_dequant_fwd
//     (body _fused_dequant_kernel) -- the consume.
//
// Emit: CFG combine (g == 1 uses eps_c alone), the two-term DDIM step from
// (abar_t, abar_s) or the RF step x + dt*v, then row-wise int8 of the
// stepped rows (scale amax/127, or 1 when amax = 0).  Consume: x = q*s in
// registers, then the same combine and step, stored in eps_c's dtype.
//
// Bound on the H100: memory and launch latency.  The emit reads
// 3*R*L*sizeof(T) bytes and writes R*L + 4*R; the consume reads R*L + 4*R
// + 2*R*L*sizeof(T) and writes R*L*sizeof(T).  A dozen flops per element is
// far below the arithmetic rate, and at the relay's wire shapes (R = 4*batch
// rows of L = 64) a call moves a few KiB, so launch latency bounds it.
//
// Design: the emit is the row-quantize of rowquant.cuh (one warp per row,
// values in registers, shuffle amax) with the step computed as each value
// is loaded, so the stepped latent never reaches memory.  The consume is a
// flat grid-stride pass.  The step coefficients are read through a device
// pointer (no host sync, capturable in a CUDA graph); the guidance is a
// launch argument.
#include "rowquant.cuh"

// Named (not anonymous): types used as __global__ template arguments.
namespace fused_impl {

template <class T>
struct EmitValue {
  const T* x;
  const T* ec;
  const T* eu;
  const float* coeffs;
  float g;
  int mode;
  __device__ float operator()(long long i) const {
    const float e = repro::load_f32(ec, i);
    const float eps = g == 1.f ? e : repro::cfg_combine(e, repro::load_f32(eu, i), g);
    return repro::step_update(mode, repro::load_f32(x, i), eps, coeffs[0], coeffs[1]);
  }
};

template <class T>
__global__ void consume_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                               const T* __restrict__ ec, const T* __restrict__ eu,
                               const float* __restrict__ coeffs, float g, int mode,
                               T* __restrict__ out, long long n, int len) {
  const float c0 = coeffs[0], c1 = coeffs[1];
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float x = __fmul_rn(static_cast<float>(q[i]), s[i / len]);
    const float e = repro::load_f32(ec, i);
    const float eps = g == 1.f ? e : repro::cfg_combine(e, repro::load_f32(eu, i), g);
    repro::store_f32(out, i, repro::step_update(mode, x, eps, c0, c1));
  }
}

template <class T>
__global__ void cfg_step_kernel(const T* x, const T* ec, const T* eu, float g, float c1,
                                float c2, int mode, T* out, long long n) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float xv = repro::load_f32(x, i);
    const float e_u = repro::load_f32(eu, i);
    const float eps = __fadd_rn(e_u, __fmul_rn(g, __fsub_rn(repro::load_f32(ec, i), e_u)));
    const float y = mode == repro::kModeDdim ? __fadd_rn(__fmul_rn(c1, xv), __fmul_rn(c2, eps))
                                             : __fadd_rn(xv, __fmul_rn(c1, eps));
    repro::store_f32(out, i, y);
  }
}

template <class T>
cudaError_t launch_cfg_step(const void* x, const void* ec, const void* eu, float g, float c1,
                            float c2, int mode, void* out, long long n, cudaStream_t stream) {
  cfg_step_kernel<T><<<repro::elementwise_grid(n, 256), 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ec), static_cast<const T*>(eu), g, c1, c2,
      mode, static_cast<T*>(out), n);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_consume(const void* q, const void* s, const void* ec, const void* eu,
                           const void* coeffs, float g, int mode, void* out, long long rows,
                           int len, cudaStream_t stream) {
  const long long n = rows * len;
  consume_kernel<T><<<repro::elementwise_grid(n, 256), 256, 0, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s), static_cast<const T*>(ec),
      static_cast<const T*>(eu), static_cast<const float*>(coeffs), g, mode,
      static_cast<T*>(out), n, len);
  return cudaGetLastError();
}

}  // namespace fused_impl

extern "C" {

// dtype: 0 = fp32, 1 = bf16 (of x, eps_c, eps_u and the output); mode: 0 =
// ddim, 1 = rf
int repro_fused_cfg_step(int device, const void* x, const void* ec, const void* eu, int dtype,
                         float guidance, float c1, float c2, int mode, void* out, long long n,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fused_impl::launch_cfg_step<float>(x, ec, eu, guidance, c1, c2, mode, out, n, st);
  return fused_impl::launch_cfg_step<__nv_bfloat16>(x, ec, eu, guidance, c1, c2, mode, out, n,
                                                    st);
}

// dtype: 0 = fp32, 1 = bf16 (of x, eps_c, eps_u); mode: 0 = ddim, 1 = rf
int repro_fused_cfg_step_quant(int device, const void* x, const void* ec, const void* eu,
                               int dtype, const void* coeffs, float guidance, int mode, void* q,
                               void* s, long long rows, int len, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  auto* qp = static_cast<int8_t*>(q);
  auto* sp = static_cast<float*>(s);
  const auto* cf = static_cast<const float*>(coeffs);
  if (dtype == 0) {
    using T = float;
    return repro::launch_quant_rows(
        fused_impl::EmitValue<T>{static_cast<const T*>(x), static_cast<const T*>(ec),
                     static_cast<const T*>(eu), cf, guidance, mode},
        qp, sp, rows, len, st);
  }
  using T = __nv_bfloat16;
  return repro::launch_quant_rows(
      fused_impl::EmitValue<T>{static_cast<const T*>(x), static_cast<const T*>(ec), static_cast<const T*>(eu),
                   cf, guidance, mode},
      qp, sp, rows, len, st);
}

// dtype: 0 = fp32, 1 = bf16 (of eps_c, eps_u and the output)
int repro_fused_cfg_step_dequant(int device, const void* q, const void* s, const void* ec,
                                 const void* eu, int dtype, const void* coeffs, float guidance,
                                 int mode, void* out, long long rows, int len, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fused_impl::launch_consume<float>(q, s, ec, eu, coeffs, guidance, mode, out, rows, len, st);
  return fused_impl::launch_consume<__nv_bfloat16>(q, s, ec, eu, coeffs, guidance, mode, out, rows, len, st);
}

}  // extern "C"
