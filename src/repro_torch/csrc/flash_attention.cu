// Flash attention forward: online softmax over KV blocks.
//
// Replaces the Pallas kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_fwd (body _attn_kernel), with its arguments: causal,
// window (key j of query row i attends iff j > i - window), logit softcap
// cap*tanh(s/cap), kv_len (keys at kv_len and past are masked; read at
// launch, so a decode step passes cache_pos + 1 over the whole cache), GQA
// through h // group with no K/V replication, fp32 running (m, l, acc),
// rows with no valid key written as zeros.
//
// Bound on the H100: at the LM relay's prefill and scoring shapes the
// work is operations (4*D flops per attended key per query row, which the
// card's bf16 tensor cores would do at 989 TFLOP/s); at the decode shape
// (S = 1) it is launch latency and the bytes of the KV cache.  This first
// version runs on the CUDA cores in fp32 (67 TFLOP/s at most), so it sits
// far above the tensor-core bound at large S*T; wgmma/TMA come later.
//
// Design: the TPU kernel's sequential KV grid axis becomes a loop inside
// the block.  One CTA per (b, h, block of kBlockQ query rows); 4 warps,
// each owning kRows query rows.  Per KV block of kBlockK keys, K and V
// are staged in shared memory as fp32 (K rows padded to D + 1 floats, so
// the 32 lanes reading 32 different keys hit 32 banks), then
//   scores: lane j computes keys j and j + 32 for each of its warp's rows;
//   softmax: row max and sum by warp shuffles, p to shared memory;
//   p@v:    lane j owns output columns j, j + 32, ... (NC of them).
// The loop stops at kv_len and at the causal diagonal of the block's last
// row, and starts at the window's first key.  Operands are strided views
// (last dim contiguous): the model's (B, S, H, D) tensors go in without a
// copy.  Exact expf/tanhf, IEEE division, no fast math; FMAs are allowed
// (the contract is a tolerance, not bits).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace flash_impl {

constexpr int kWarps = 4;
constexpr int kRows = 8;                 // query rows per warp
constexpr int kBlockQ = kWarps * kRows;  // query rows per CTA
constexpr int kBlockK = 64;              // keys per KV block: two per lane
constexpr float kNegInf = -1e30f;        // the TPU kernel's masked logit

struct Strides {
  long long b, h, s;  // element strides; the last dim is contiguous
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq, sk, sv, so;
  int heads, group, s_len, t_len, d;
  int causal, window;  // window <= 0: none
  float softcap;       // <= 0: none
  float scale;
  int kv_len;
};

__device__ __forceinline__ float load_f32(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

size_t smem_bytes(int d) {
  return sizeof(float) *
         (static_cast<size_t>(kBlockQ) * d + static_cast<size_t>(kBlockK) * (d + 1) +
          static_cast<size_t>(kBlockK) * d + static_cast<size_t>(kBlockQ) * kBlockK);
}

// NC: output columns per lane, 32*NC >= D.
template <class T, int NC>
__global__ void __launch_bounds__(kWarps * 32) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int d = p.d;
  const int kst = d + 1;
  float* qs = smem;                   // [kBlockQ][d]
  float* ks = qs + kBlockQ * d;       // [kBlockK][d + 1]
  float* vs = ks + kBlockK * kst;     // [kBlockK][d]
  float* ps = vs + kBlockK * d;       // [kBlockQ][kBlockK]

  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads, kvh = h / p.group;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* q = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* k = static_cast<const T*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv.b + kvh * p.sv.h;
  T* o = static_cast<T*>(p.o) + b * p.so.b + h * p.so.h;

  for (int i = threadIdx.x; i < kBlockQ * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    const int qp = q0 + r;
    qs[i] = qp < p.s_len ? load_f32(q, qp * p.sq.s + c) : 0.f;
  }

  // the keys some row of this block may attend: [k_begin, k_end)
  const int q_last = min(q0 + kBlockQ, p.s_len) - 1;
  const int k_end = p.causal ? min(p.kv_len, q_last + 1) : p.kv_len;
  int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  k_begin -= k_begin % kBlockK;

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0.f;
  }

  for (int kb = k_begin; kb < k_end; kb += kBlockK) {
    __syncthreads();  // the previous block is done with ks, vs
    for (int i = threadIdx.x; i < kBlockK * d; i += blockDim.x) {
      const int r = i / d, c = i - r * d;
      const int kp = kb + r;
      // keys at k_end and past are masked for every row: zeros, never
      // read, so no garbage past the cache can reach the sums
      const bool in = kp < k_end;
      ks[r * kst + c] = in ? load_f32(k, kp * p.sk.s + c) : 0.f;
      vs[r * d + c] = in ? load_f32(v, kp * p.sv.s + c) : 0.f;
    }
    __syncthreads();

    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    const float* k0 = ks + lane * kst;
    const float* k1 = ks + (lane + 32) * kst;
    const float* qw = qs + warp * kRows * d;
    for (int c = 0; c < d; ++c) {
      const float a0 = k0[c], a1 = k1[c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = qw[r * d + c];
        s[r][0] = fmaf(qv, a0, s[r][0]);
        s[r][1] = fmaf(qv, a1, s[r][1]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + warp * kRows + r;
      bool ok[2];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = kb + lane + 32 * j;
        float x = s[r][j] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        ok[j] = kp < p.kv_len && (!p.causal || kp <= qp) &&
                (p.window <= 0 || kp > qp - p.window);
        s[r][j] = ok[j] ? x : kNegInf;
        mx = fmaxf(mx, s[r][j]);
      }
      const float m_new = fmaxf(m[r], warp_max(mx));
      const float p0 = ok[0] ? expf(s[r][0] - m_new) : 0.f;
      const float p1 = ok[1] ? expf(s[r][1] - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[r][j] *= alpha;
      float* pr = ps + (warp * kRows + r) * kBlockK;
      pr[lane] = p0;
      pr[lane + 32] = p1;
    }
    __syncwarp();  // each warp reads back only its own rows of ps

    const float* pw = ps + warp * kRows * kBlockK;
    for (int kk = 0; kk < kBlockK; ++kk) {
      float vv[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = lane + 32 * j;
        vv[j] = c < d ? vs[kk * d + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pk = pw[r * kBlockK + kk];
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[r][j] = fmaf(pk, vv[j], acc[r][j]);
      }
    }
    __syncwarp();  // ps is rewritten by the next block's softmax
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + warp * kRows + r;
    if (qp >= p.s_len) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];  // fully masked rows → zeros
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      if (c < d) store_f32(o, qp * p.so.s + c, acc[r][j] / denom);
    }
  }
}

template <class T, int NC>
cudaError_t launch(const Params& p, int batch, int device, cudaStream_t stream) {
  static bool raised[64] = {};  // per device: the >48 KiB shared-memory opt-in
  const size_t smem = smem_bytes(p.d);
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!raised[device]) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, NC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem_bytes(32 * 8)));
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  const dim3 grid((p.s_len + kBlockQ - 1) / kBlockQ, batch * p.heads);
  flash_fwd_kernel<T, NC><<<grid, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <class T>
cudaError_t dispatch(const Params& p, int batch, int device, cudaStream_t stream) {
  if (p.d <= 32) return launch<T, 1>(p, batch, device, stream);
  if (p.d <= 64) return launch<T, 2>(p, batch, device, stream);
  if (p.d <= 128) return launch<T, 4>(p, batch, device, stream);
  if (p.d <= 256) return launch<T, 8>(p, batch, device, stream);
  return cudaErrorInvalidValue;
}

}  // namespace flash_impl

extern "C" {

// q (B, H, S, D), k/v (B, KV, T, D), o (B, H, S, D) as strided views with
// a contiguous last dim; dtype: 0 = fp32, 1 = bf16 (all four tensors).
int repro_flash_attention(int device, const void* q, const void* k, const void* v, void* o,
                          int dtype, int batch, int heads, int kv_heads, int s_len, int t_len,
                          int d, long long sq_b, long long sq_h, long long sq_s, long long sk_b,
                          long long sk_h, long long sk_s, long long sv_b, long long sv_h,
                          long long sv_s, long long so_b, long long so_h, long long so_s,
                          int causal, int window, float softcap, float scale, int kv_len,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (kv_heads <= 0 || heads % kv_heads != 0 || d <= 0) return cudaErrorInvalidValue;
  flash_impl::Params p{q,        k,      v,     o,       {sq_b, sq_h, sq_s}, {sk_b, sk_h, sk_s},
                       {sv_b, sv_h, sv_s}, {so_b, so_h, so_s}, heads, heads / kv_heads,
                       s_len,    t_len,  d,     causal,  window, softcap, scale, kv_len};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return flash_impl::dispatch<float>(p, batch, device, st);
  if (dtype == 1) return flash_impl::dispatch<__nv_bfloat16>(p, batch, device, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
