// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t along the sequence,
// from h_0 = 0, for every (batch, channel), in fp32.
//
// Replaces the Pallas kernel repro/kernels/rglru/kernel.py::rglru_scan_fwd
// (body _rglru_kernel).
//
// Bound on the H100: memory.  Per element it reads a and b and writes h,
// 12 bytes, for one multiply and one add: 3*B*S*R*4 bytes over 3.35 TB/s,
// far below the card's fp32 rate.
//
// Design: the TPU kernel tiles (batch x channel) over its grid and walks
// the sequence as the minor, sequential grid axis, carrying h in VMEM
// between sequence blocks.  Blocks on the card run in no order, so the
// walk is a loop inside one thread: one thread per (b, r) channel, h in a
// register, adjacent threads on adjacent r so that each step's loads and
// store are coalesced.  The loads do not depend on h, so they run one
// chunk of kUnroll steps ahead: the next chunk's a and b are in flight
// while the current chunk's steps are computed.  Ragged R and any S are
// masked, not padded.  Built with --fmad=false and written with
// __fmul_rn/__fadd_rn: a product rounded to fp32, then a sum rounded to
// fp32, as the plain version (kernels/rglru/ref.py) rounds, so the two
// agree bit for bit.
//
// Weak where B*R is small and S long (1 x 4096 x 4096: 4,096 threads over
// 4,096 dependent steps, a few warps per SM); a chunked two-pass scan is
// the remedy, left for later.
#include <cuda_runtime.h>

namespace rglru_impl {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ h_out, int s_len, int width, long long channels) {
  const long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= channels) return;
  const long long base = (c / width) * s_len * width + c % width;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h_out + base;

  float ca[kUnroll], cb[kUnroll], na[kUnroll], nb[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const bool in = u < s_len;
    ca[u] = in ? ap[static_cast<long long>(u) * width] : 0.f;
    cb[u] = in ? bp[static_cast<long long>(u) * width] : 0.f;
  }
  float h = 0.f;
  for (int t0 = 0; t0 < s_len; t0 += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // the next chunk, ahead of its use
      const int t = t0 + kUnroll + u;
      const bool in = t < s_len;
      na[u] = in ? ap[static_cast<long long>(t) * width] : 0.f;
      nb[u] = in ? bp[static_cast<long long>(t) * width] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < s_len) {
        h = __fadd_rn(__fmul_rn(ca[u], h), cb[u]);
        hp[static_cast<long long>(t) * width] = h;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
}

}  // namespace rglru_impl

extern "C" {

// a, b, h: contiguous (B, S, R) fp32.
int repro_rglru_scan(int device, const void* a, const void* b, void* h, int batch, int s_len,
                     int width, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch <= 0 || s_len <= 0 || width <= 0) return cudaErrorInvalidValue;
  const long long channels = static_cast<long long>(batch) * width;
  const long long blocks = (channels + rglru_impl::kThreads - 1) / rglru_impl::kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  rglru_impl::rglru_scan_kernel<<<static_cast<unsigned>(blocks), rglru_impl::kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(h), s_len,
      width, channels);
  return cudaGetLastError();
}

}  // extern "C"
