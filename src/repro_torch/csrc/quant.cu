// Row-wise symmetric int8 quantize / dequantize.
//
// Replaces the Pallas kernels repro/kernels/quant/kernel.py::quant_int8_fwd
// (body _quant_kernel) and ::dequant_int8_fwd (body _dequant_kernel).
//
// Bound on the H100: memory and launch latency.  Per element the quantize
// does one abs/max, one division and one rounding: far below the card's
// arithmetic rate.  At the relay's wire shapes (R = 4*batch rows of
// L = 64) a call moves a few KiB, so launch latency bounds it; at large
// R*L the quantize moves 4*R*L bytes in (fp32) and R*L + 4*R out.
//
// Design: quantize runs one warp per row for L <= 1024, each lane holding
// its elements in registers (the row is read once, the amax is a shuffle
// reduction, nothing goes through shared memory); longer rows take one
// block per row and read the row twice.  No padding: the ragged tail is
// masked.  Dequantize is a flat grid-stride pass, q*s per element.
#include "rowquant.cuh"

// Named (not anonymous): types used as __global__ template arguments.
namespace quant_impl {

template <class T>
struct LoadValue {
  const T* x;
  __device__ float operator()(long long i) const { return repro::load_f32(x, i); }
};

__global__ void dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                               float* __restrict__ out, long long n, int len) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    out[i] = __fmul_rn(static_cast<float>(q[i]), s[i / len]);
  }
}

__global__ void empty_kernel() {}

}  // namespace quant_impl

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches a kernel that does nothing: the floor that every launch through
// this library pays (launch latency), for measurement.
int repro_empty(int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  quant_impl::empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

// dtype: 0 = fp32, 1 = bf16
int repro_quant_int8(int device, const void* x, int dtype, void* q, void* s, long long rows,
                     int len, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  auto* qp = static_cast<int8_t*>(q);
  auto* sp = static_cast<float*>(s);
  if (dtype == 0)
    return repro::launch_quant_rows(quant_impl::LoadValue<float>{static_cast<const float*>(x)}, qp, sp, rows,
                                    len, st);
  return repro::launch_quant_rows(
      quant_impl::LoadValue<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(x)}, qp, sp, rows, len, st);
}

int repro_dequant_int8(int device, const void* q, const void* s, void* out, long long rows,
                       int len, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long n = rows * len;
  quant_impl::dequant_kernel<<<repro::elementwise_grid(n, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s), static_cast<float*>(out), n,
      len);
  return cudaGetLastError();
}

}  // extern "C"
