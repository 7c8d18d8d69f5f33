// Flash attention forward for the H100: three kernels behind one entry.
//
// Replaces the Pallas kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_fwd (body _attn_kernel), with its arguments: causal
// (key j of query row i attends iff j <= i, top-left aligned also when
// S != T), window (j > i - window), logit softcap cap*tanh(s/cap), kv_len
// (keys at kv_len and past are masked; read at launch, so a decode step
// passes cache_pos + 1 over the whole cache), GQA through h // group with
// no K/V replication, the scale a multiply by 1/sqrt(d), fp32 running
// (m, l, acc), rows with no valid key written as zeros.  Operands are
// strided views with a contiguous last dim: the model's (B, S, H, D)
// tensors go in without a copy.  The wrapper (kernels/flash_attention/
// ops.py::plan) picks the variant from dtype, D, S, G = H/KV and the
// strides:
//
// * decode (bf16, S*G <= 16, D in {64, 128, 256}): every decode step of
//   both LMs.  Bound: the bytes of the KV cache (each key and value read
//   once) and the launch.  One CTA per (b, KV head, KV split) computes all
//   S*G query rows of that KV head's group as the M = 16 rows of
//   mma.sync.m16n8k16 (bf16 in, fp32 accumulators), so each K/V element
//   crosses HBM once per call.  Q and K/V arrive by cp.async 16-byte
//   copies.  Its 8 warps form groups (one warp, or two at D = 256 that
//   split the output columns and so keep 64 accumulators a thread, not
//   128); each group walks its own 16-key steps of the split through a
//   private two-stage ring, so the next step's load overlaps this step's
//   math; keys past the split or kv_len are zero-filled, never read.  The
//   groups' partials merge in shared memory.  With several splits each
//   CTA writes an fp32 partial (m, l, acc) and the last CTA of its (b, KV
//   head), found with a counter that it resets, merges the splits in
//   split order: no floating-point atomics, the same bits run to run.  The
//   split count (ops.py::decode_splits) depends on T and B*KV only, never
//   on kv_len, so a captured launch keeps its shape; a split is at least
//   128 keys, below which the merge costs more than it spreads.
// * scoring (bf16, everything else with D in {64, 128, 256}): prefill and
//   the scored forward.  At S = T = 128 it is bound by bytes, at
//   S = T = 4096 by tensor-core operations.  One CTA (one warpgroup) per
//   (b, h, 64 query rows); Q, K and V tiles of 64 rows arrive by TMA
//   (mbarrier-completed, 128-byte swizzle, the tensor maps taking the
//   strided model layout as it is) into a ring of two stages (one at
//   D = 256, so that two CTAs share an SM), K and V on their own barriers;
//   S = Q K^T and O += P V are wgmma m64n64k16 (Q and K from shared
//   memory, P from registers, V MN-major), the online softmax in
//   registers.  Causal and window bands skip whole tiles and mask only
//   the diagonal and edge tiles.
// * simt (fp32, and bf16 at other head dims): the CUDA-core kernel below,
//   fp32 FMAs; fp32 is kept off the tensor cores (TF32 or bf16 could not
//   meet the fp32 tolerance).
//
// P enters the tensor cores as two bf16 parts, hi = bf16(p) and
// lo = bf16(p - hi), two products: bf16(p) alone would err by 2^-9 per
// term, about one bf16 ulp of the output, and outputs near zero would miss
// the one-ulp contract.  The tensor-core kernels take exp as the SFU's
// ex2.approx of log2e-scaled logits (relative error ~2^-22) and divide by
// the row sum as one reciprocal per row; the CUDA-core kernel keeps exact
// expf and IEEE division.  tanhf is exact everywhere; no fast math.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

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

// The CUDA-core kernel (fp32, and bf16 at head dims the tensor-core
// kernels do not take): one CTA per (b, h, block of kBlockQ query rows);
// 4 warps, each owning kRows query rows.  Per KV block of kBlockK keys, K
// and V are staged in shared memory as fp32 (K rows padded to D + 1
// floats), then scores (lane j: keys j and j + 32), softmax by warp
// shuffles, p@v (lane j: output columns j, j + 32, ...).  NC: output
// columns per lane, 32*NC >= D.
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

// ---------------------------------------------------------------------------
// Tensor-core kernels (bf16)

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// p ~= hi + lo as two bf16 pairs (first value in the low half): the
// tensor-core operand of P, exact to 2^-17 relative
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// 2^x by the SFU (relative error ~2^-22): the tensor-core kernels' exp
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// raw scores q.k -> logits in log2 units (the softcap branch taken once)
template <int N>
__device__ __forceinline__ void logits2(float (&s)[N], float scale, float softcap) {
  if (softcap > 0.f) {
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = softcap * tanhf(s[i] * scale / softcap) * kLog2e;
  } else {
    const float sl = scale * kLog2e;
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] *= sl;
  }
}

__device__ __forceinline__ bool attends(int key, int qp, int k_hi, int causal, int window) {
  return key < k_hi && (!causal || key <= qp) && (window <= 0 || key > qp - window);
}

// D(16x8, fp32) += A(16x16, bf16, row) * B(16x8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}

// 16 bytes global -> shared, zero-filled when !valid (nothing is read)
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- decode: one CTA per (b, KV head, KV split) ----------------------------

constexpr int kDecRows = 16;   // S*G query rows, padded to the m16 tile
constexpr int kDecKeys = 16;   // keys per step
constexpr int kMaxSplits = 128;

struct DecodeParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  Strides sq, sk, sv, so;
  int kv_heads, group, s_len;
  int causal, window;
  float softcap, scale;
  int kv_len;
  int split_len, splits;
  float* part;    // splits > 1: acc [B*KV][splits][16][D], then (m, l) [B*KV][splits][16]
  int* counters;  // [B*KV], zero between launches
};

template <int D>
struct Dec {
  // 8 warps in groups, each group on its own 16-key steps; at D = 256 a
  // group is two warps, each owning half of the output columns (64
  // accumulators a thread, not 128: no spills), both computing the
  // step's scores
  static constexpr int kHalves = D >= 256 ? 2 : 1;
  static constexpr int kGroups = 8 / kHalves;
  static constexpr int kThreads = 256;
  static constexpr int kStages = 2;
  static constexpr int kLd = D + 8;  // smem row stride (bf16): a 16-byte pad, no bank conflicts
  static constexpr int kTile = kDecKeys * kLd;
  static constexpr int kQ = kDecRows * kLd;
  static constexpr size_t kKvBytes = size_t(kGroups) * kStages * 2 * kTile * sizeof(bf16);
  static constexpr size_t kSmem = size_t(kQ) * sizeof(bf16) + kKvBytes;
  // after the key loop the K/V area holds the groups' partials, then the
  // split weights
  static_assert(size_t(kGroups) * kDecRows * (D + 11) * 4 + kDecRows * 8 <= kKvBytes,
                "group merge area");
  static_assert(size_t(2 * kMaxSplits + 1) * kDecRows * 4 <= kKvBytes, "split merge area");
};

template <int D>
__global__ void __launch_bounds__(Dec<D>::kThreads) flash_fwd_decode_kernel(DecodeParams p) {
  using C = Dec<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int is_last;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* kvs = qs + C::kQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g4 = lane / 4, c4 = lane % 4;
  // key group, and the output columns [cols, cols + D / kHalves) this warp owns
  const int grp = warp / C::kHalves, cols = (warp % C::kHalves) * (D / C::kHalves);
  const int split = blockIdx.x, bk = blockIdx.y;
  const int b = bk / p.kv_heads, kvh = bk % p.kv_heads;
  const int rows = p.s_len * p.group;  // row r: query r % S of head kvh*G + r / S

  // Q by cp.async too (rows past S*G zero-filled), in flight with the
  // first K/V steps: its own commit group, the first one
  for (int i = tid; i < kDecRows * (D / 8); i += blockDim.x) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int h = kvh * p.group + r / p.s_len, s = r % p.s_len;
    cp_async16(qs + r * C::kLd + c,
               r < rows ? p.q + b * p.sq.b + h * p.sq.h + s * p.sq.s + c : p.q, r < rows);
  }
  cp_async_commit();

  // the keys of this split that some row may attend: [k_lo, k_hi)
  const int k_end = p.causal ? min(p.kv_len, p.s_len) : p.kv_len;
  const int k_lo = split * p.split_len;
  const int k_hi = min(k_lo + p.split_len, k_end);
  const int n_steps = k_hi > k_lo ? (k_hi - k_lo + kDecKeys - 1) / kDecKeys : 0;
  const int my_steps = n_steps > grp ? (n_steps - grp + C::kGroups - 1) / C::kGroups : 0;
  const bf16* kg = p.k + b * p.sk.b + kvh * p.sk.h;
  const bf16* vg = p.v + b * p.sv.b + kvh * p.sv.h;
  bf16* ring = kvs + grp * C::kStages * 2 * C::kTile;  // this group's [stage][K, V]

  // the group's warps wait for each other (its ring is theirs alone)
  auto group_sync = [&]() {
    if constexpr (C::kHalves == 1) {
      __syncwarp();
    } else {
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(32 * C::kHalves) : "memory");
    }
  };
  // step it of this group: keys k_lo + 16*(grp + kGroups*it) + [0, 16)
  auto load = [&](int it) {
    const int key0 = k_lo + (grp + it * C::kGroups) * kDecKeys;
    bf16* ks = ring + (it % C::kStages) * 2 * C::kTile;
    bf16* vs = ks + C::kTile;
#pragma unroll
    for (int i = tid % (32 * C::kHalves); i < kDecKeys * (D / 8); i += 32 * C::kHalves) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const int key = key0 + r;
      const bool ok = key < k_hi;
      cp_async16(ks + r * C::kLd + c, ok ? kg + key * p.sk.s + c : kg, ok);
      cp_async16(vs + r * C::kLd + c, ok ? vg + key * p.sv.s + c : vg, ok);
    }
  };

  int qpos[2];  // query position of this thread's rows g4 and g4 + 8
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = g4 + 8 * j;
    qpos[j] = r < rows ? r % p.s_len : 0;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  constexpr int kN = D / 8 / C::kHalves;  // this warp's n8 tiles of the output
  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

#pragma unroll
  for (int it = 0; it < C::kStages - 1; ++it) {
    if (it < my_steps) load(it);
    cp_async_commit();
  }
  cp_async_wait<C::kStages - 1>();  // this thread's Q chunks
  __syncthreads();                  // everyone's

  for (int it = 0; it < my_steps; ++it) {
    if (it + C::kStages - 1 < my_steps) load(it + C::kStages - 1);
    cp_async_commit();
    cp_async_wait<C::kStages - 1>();
    group_sync();
    const bf16* ks = ring + (it % C::kStages) * 2 * C::kTile;
    const bf16* vs = ks + C::kTile;
    const int key0 = k_lo + (grp + it * C::kGroups) * kDecKeys;

    // scores of 16 rows x 16 keys: two n8 tiles
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const bf16* qa = qs + g4 * C::kLd + kk * 16 + 2 * c4;
      const uint32_t a0 = ld_u32(qa), a1 = ld_u32(qa + 8 * C::kLd);
      const uint32_t a2 = ld_u32(qa + 8), a3 = ld_u32(qa + 8 * C::kLd + 8);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const bf16* kb = ks + (nt * 8 + g4) * C::kLd + kk * 16 + 2 * c4;
        mma_16816(s[nt], a0, a1, a2, a3, ld_u32(kb), ld_u32(kb + 8));
      }
    }

    // online softmax; element e of tile nt: row g4 + 8*(e/2), key
    // key0 + 8*nt + 2*c4 + e%2
    logits2(s[0], p.scale, p.softcap);
    logits2(s[1], p.scale, p.softcap);
    if (key0 + kDecKeys > k_hi || p.causal || p.window > 0) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + nt * 8 + 2 * c4 + (e & 1);
          if (!attends(key, qpos[e / 2], k_hi, p.causal, p.window)) s[nt][e] = kNegInf;
        }
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
    }
    float alpha[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float m_new = fmaxf(m[j], quad_max(mx[j]));
      alpha[j] = exp2_approx(m[j] - m_new);
      m[j] = m_new;
      l[j] *= alpha[j];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a row with no valid key so far has m = kNegInf: its p are zero
        const float pv = m[e / 2] == kNegInf ? 0.f : exp2_approx(s[nt][e] - m[e / 2]);
        l[e / 2] += pv;
        s[nt][e] = pv;
      }
    }
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e / 2];
    }

    // P (16 x 16) as the A fragment, in two bf16 parts
    uint32_t ah[4], al[4];
    split_bf16(s[0][0], s[0][1], ah[0], al[0]);
    split_bf16(s[0][2], s[0][3], ah[1], al[1]);
    split_bf16(s[1][0], s[1][1], ah[2], al[2]);
    split_bf16(s[1][2], s[1][3], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < kN; n += 2) {
      // matrices: keys 0-7 and 8-15 of columns cols + 8n.., then of
      // cols + 8n + 8..
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4_trans(b0, b1, b2, b3,
                        vs + ((lane & 7) + (lane & 8)) * C::kLd + cols + n * 8 + (lane >> 4) * 8);
      mma_16816(acc[n], ah[0], ah[1], ah[2], ah[3], b0, b1);
      mma_16816(acc[n], al[0], al[1], al[2], al[3], b0, b1);
      mma_16816(acc[n + 1], ah[0], ah[1], ah[2], ah[3], b2, b3);
      mma_16816(acc[n + 1], al[0], al[1], al[2], al[3], b2, b3);
    }
    group_sync();  // the stage is refilled at the next step
  }
  cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < 2; ++j) l[j] = quad_sum(l[j]);

  // merge the groups in group order: acc [group][16][D], (m, l)
  // [group][16], the weight of each group's rows [group][16], (M, L) [16]
  __syncthreads();  // every group is done with its ring
  constexpr int kAccLd = D + 8;  // padded: the float2 writes hit 32 banks
  float* wacc = reinterpret_cast<float*>(kvs);
  float* wml = wacc + C::kGroups * kDecRows * kAccLd;
  float* wsc = wml + C::kGroups * kDecRows * 2;
  float* row_ml = wsc + C::kGroups * kDecRows;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = g4 + 8 * j;
      *reinterpret_cast<float2*>(wacc + (grp * kDecRows + r) * kAccLd + cols + n * 8 + 2 * c4) =
          make_float2(acc[n][2 * j], acc[n][2 * j + 1]);
    }
  }
  if (c4 == 0 && cols == 0) {  // a group's warps hold the same (m, l)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = g4 + 8 * j;
      wml[(grp * kDecRows + r) * 2] = m[j];
      wml[(grp * kDecRows + r) * 2 + 1] = l[j];
    }
  }
  __syncthreads();
  if (tid < kDecRows) {
    float mm = kNegInf, ll = 0.f;
#pragma unroll
    for (int w = 0; w < C::kGroups; ++w) mm = fmaxf(mm, wml[(w * kDecRows + tid) * 2]);
#pragma unroll
    for (int w = 0; w < C::kGroups; ++w) {
      const float sc = exp2_approx(wml[(w * kDecRows + tid) * 2] - mm);
      wsc[w * kDecRows + tid] = sc;
      ll += sc * wml[(w * kDecRows + tid) * 2 + 1];
    }
    row_ml[tid * 2] = mm;
    row_ml[tid * 2 + 1] = ll;
  }
  __syncthreads();

  // each thread: kVec runs of 4 columns of the 16 x D tile
  constexpr int kVec = kDecRows * D / 4 / C::kThreads;
  auto store_out = [&](int r, int c, float4 a, float inv) {
    const int h = kvh * p.group + r / p.s_len, s = r % p.s_len;
    const __nv_bfloat162 lo = __floats2bfloat162_rn(a.x * inv, a.y * inv);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(a.z * inv, a.w * inv);
    *reinterpret_cast<uint2*>(p.o + b * p.so.b + h * p.so.h + s * p.so.s + c) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
  };
  const size_t first = size_t(bk) * p.splits * kDecRows;  // this (b, KV head)'s partials
  float* part_ml =
      p.splits > 1 ? p.part + size_t(gridDim.y) * p.splits * kDecRows * D : nullptr;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int i = tid + j * C::kThreads;
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    if (r >= rows) continue;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < C::kGroups; ++w) {
      const float sc = wsc[w * kDecRows + r];
      const float4 x = *reinterpret_cast<const float4*>(wacc + (w * kDecRows + r) * kAccLd + c);
      a.x += sc * x.x;
      a.y += sc * x.y;
      a.z += sc * x.z;
      a.w += sc * x.w;
    }
    if (p.splits == 1) {
      const float ll = row_ml[r * 2 + 1];
      store_out(r, c, a, ll == 0.f ? 0.f : 1.f / ll);  // fully masked rows → zeros
    } else {
      *reinterpret_cast<float4*>(p.part + (first + size_t(split) * kDecRows + r) * D + c) = a;
    }
  }
  if (p.splits == 1) return;
  if (tid < rows) {
    part_ml[(first + size_t(split) * kDecRows + tid) * 2] = row_ml[tid * 2];
    part_ml[(first + size_t(split) * kDecRows + tid) * 2 + 1] = row_ml[tid * 2 + 1];
  }

  // the last CTA of this (b, KV head) merges the splits, in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(p.counters + bk, 1);
    is_last = done == p.splits - 1;
    if (is_last) atomicExch(p.counters + bk, 0);  // zero for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // (m, l) of every split and row, then each split's weight [split][16]
  // and the rows' sums [16]
  float* sm = reinterpret_cast<float*>(kvs);
  float* sl = sm + kMaxSplits * kDecRows;
  float* denom = sl + kMaxSplits * kDecRows;
  for (int i = tid; i < p.splits * kDecRows; i += blockDim.x) {
    sm[i] = __ldcg(part_ml + (first + i) * 2);
    sl[i] = __ldcg(part_ml + (first + i) * 2 + 1);
  }
  __syncthreads();
  if (tid < kDecRows) {
    float mm = kNegInf, ll = 0.f;
    for (int s = 0; s < p.splits; ++s) mm = fmaxf(mm, sm[s * kDecRows + tid]);
    for (int s = 0; s < p.splits; ++s) {
      const float sc = exp2_approx(sm[s * kDecRows + tid] - mm);
      sm[s * kDecRows + tid] = sc;
      ll += sc * sl[s * kDecRows + tid];
    }
    denom[tid] = ll == 0.f ? 0.f : 1.f / ll;  // the rows' 1 / sum
  }
  __syncthreads();
  float4 a[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (int s = 0; s < p.splits; ++s) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int i = tid + j * C::kThreads;
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      if (r >= rows) continue;
      const float sc = sm[s * kDecRows + r];
      const float4 x = __ldcg(
          reinterpret_cast<const float4*>(p.part + (first + size_t(s) * kDecRows + r) * D + c));
      a[j].x += sc * x.x;
      a[j].y += sc * x.y;
      a[j].z += sc * x.z;
      a[j].w += sc * x.w;
    }
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int i = tid + j * C::kThreads;
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    if (r < rows) store_out(r, c, a[j], denom[r]);
  }
}

template <int D>
cudaError_t launch_decode(const DecodeParams& p, int bkv, int device, cudaStream_t stream) {
  static bool raised[64] = {};  // per device and instance: the >48 KiB opt-in
  if (!raised[device]) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_decode_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(Dec<D>::kSmem));
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  flash_fwd_decode_kernel<D><<<dim3(p.splits, bkv), Dec<D>::kThreads, Dec<D>::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// ---- scoring: one warpgroup per (b, h, 64 query rows), wgmma + TMA ---------

constexpr int kScM = 64;            // query rows per CTA
constexpr int kScN = 64;            // keys per tile
constexpr int kBox = 64 * 64 * 2;   // one TMA box: 64 rows x 64 bf16 (128 bytes, swizzled)

template <int D>
struct Sc {
  static constexpr int kChunks = D / 64;  // 128-byte column chunks of a row
  static constexpr int kTile = kChunks * kBox;
  // K/V ring stages: one at D = 256, so that two CTAs share an SM
  static constexpr int kStages = D >= 256 ? 1 : 2;
  // Q, then K stages, then V stages (each 1024-aligned), then barriers
  // (Q, K stages, V stages); 1 KiB of slack to align the dynamic buffer
  static constexpr size_t kSmem = 1024 + size_t(kTile) * (1 + 2 * kStages) + 64;
};

struct ScoringParams {
  bf16* o;
  Strides so;
  int heads, group, s_len;
  int causal, window;
  float softcap, scale;
  int kv_len;
  int perm_q[3], perm_k[3], perm_v[3];  // tensor-map dim of (row, head, batch)
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         const int (&perm)[3], int col, int row, int head,
                                         int batch) {
  // the coordinate of map dim i (1-3): row, head or batch, as perm says
  auto at = [&](int i) { return perm[0] == i ? row : perm[1] == i ? head : batch; };
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(at(1)), "r"(at(2)),
      "r"(at(3))
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO); LBO: the next 64-column
// chunk (MN-major only; unused at N = 64)
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo) {
  const uint32_t a = smem_u32(p);
  return uint64_t((a & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses of async accumulators past a wait
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64x64, fp32) (+)= A(64x16, smem, K-major) B(16x64, smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accum));
}

// D(64x64, fp32) += A(64x16, registers) B(16x64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__global__ void __launch_bounds__(128, 1)
    flash_fwd_scoring_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, const ScoringParams p) {
  using C = Sc<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;
  unsigned char* kst = smem + C::kTile;  // [stage][chunk][64][64]
  unsigned char* vst = kst + C::kStages * C::kTile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(vst + C::kStages * C::kTile);
  uint64_t* kbar = bars + 1;  // bars[0]: Q
  uint64_t* vbar = kbar + C::kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kScM;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads, kvh = h / p.group;

  // the key tiles some row of this block may attend
  const int q_last = min(q0 + kScM, p.s_len) - 1;
  const int k_end = p.causal ? min(p.kv_len, q_last + 1) : p.kv_len;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_begin = k_begin / kScN;
  const int n_tiles = k_end > k_begin ? (k_end + kScN - 1) / kScN - t_begin : 0;

  // K and V complete on their own barriers: the scores start before V is in
  auto issue_kv = [&](int stage, int tile) {
    mbar_expect_tx(kbar + stage, C::kTile);
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
      tma_load(kst + stage * C::kTile + c * kBox, &tk, kbar + stage, p.perm_k, c * 64,
               tile * kScN, kvh, b);
    mbar_expect_tx(vbar + stage, C::kTile);
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
      tma_load(vst + stage * C::kTile + c * kBox, &tv, vbar + stage, p.perm_v, c * 64,
               tile * kScN, kvh, b);
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= 2 * C::kStages; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(bars, C::kTile);
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
      tma_load(qs + c * kBox, &tq, bars, p.perm_q, c * 64, q0, h, b);
    for (int st = 0; st < C::kStages && st < n_tiles; ++st) issue_kv(st, t_begin + st);
  }

  // accumulator element i of chunk c: row 16*warp + lane/4 + 8*((i/2)%2),
  // column 64*c + 8*(i/4) + 2*(lane%4) + i%2
  float o[C::kChunks][32];
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + lane / 4;  // this thread's rows: row0, row0 + 8

  if (n_tiles > 0) mbar_wait(bars, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % C::kStages;
    const uint32_t parity = (j / C::kStages) & 1;
    mbar_wait(kbar + st, parity);
    const int kb = (t_begin + j) * kScN;
    const unsigned char* ks = kst + st * C::kTile;
    const unsigned char* vs = vst + st * C::kTile;

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * kBox + (kk % 4) * 32;  // 16 columns = 32 bytes
      wgmma_ss(s, gmma_desc(qs + off, 16), gmma_desc(ks + off, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // mask only the tiles that cut the band or pass kv_len
    const bool edge = kb + kScN > p.kv_len || (p.causal && kb + kScN - 1 > q0) ||
                      (p.window > 0 && kb <= q_last - p.window);
    logits2(s, p.scale, p.softcap);
    if (edge) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = kb + (i / 4) * 8 + 2 * (lane % 4) + (i & 1);
        if (!attends(key, row0 + 8 * ((i >> 1) & 1), p.kv_len, p.causal, p.window))
          s[i] = kNegInf;
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2];
#pragma unroll
    for (int j2 = 0; j2 < 2; ++j2) {
      const float m_new = fmaxf(m[j2], quad_max(mx[j2]));
      alpha[j2] = exp2_approx(m[j2] - m_new);
      m[j2] = m_new;
      l[j2] *= alpha[j2];
    }
    // P (64 x 64) as four k16 A fragments, hi and lo: fragment kk holds
    // keys 16kk.., elements 8kk..8kk+7 of s
    uint32_t ph[16], pl[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int j2 = (i >> 1) & 1;
      const bool live = m[j2] != kNegInf;  // else no valid key yet: p = 0
      const float p0 = live ? exp2_approx(s[i] - m[j2]) : 0.f;
      const float p1 = live ? exp2_approx(s[i + 1] - m[j2]) : 0.f;
      l[j2] += p0 + p1;
      split_bf16(p0, p1, ph[i / 2], pl[i / 2]);
    }
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];

    mbar_wait(vbar + st, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kScN / 16; ++kk) {
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) {
        // V rows 16kk.. (2048 bytes per 16 rows) of column chunk c
        const uint64_t dv = gmma_desc(vs + c * kBox + kk * 2048, kBox);
        wgmma_rs(o[c], ph + 4 * kk, dv);
        wgmma_rs(o[c], pl + 4 * kk, dv);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) fence_regs(o[c]);

    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && j + C::kStages < n_tiles) issue_kv(st, t_begin + j + C::kStages);
  }

#pragma unroll
  for (int j2 = 0; j2 < 2; ++j2) {
    const int row = row0 + 8 * j2;
    const float denom = quad_sum(l[j2]);
    if (row >= p.s_len) continue;
    const float inv = denom == 0.f ? 0.f : 1.f / denom;  // fully masked rows → zeros
    bf16* orow = p.o + b * p.so.b + h * p.so.h + row * p.so.s + 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int i = n * 4 + 2 * j2;
        *reinterpret_cast<__nv_bfloat162*>(orow + c * 64 + n * 8) =
            __floats2bfloat162_rn(o[c][i] * inv, o[c][i + 1] * inv);
      }
    }
  }
}

// cuTensorMapEncodeTiled, resolved at run time through the CUDA runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)ptr;
  }
  return fn;
}

// A 4-d map of a strided (B, heads, rows, D) view, boxes of 64 rows x 64
// columns: dim 0 is D, dims 1-3 are (rows, heads, batch) sorted by stride,
// so the map follows the memory order of whatever view comes in; perm
// receives the dim of each.  Rows past `rows` read as zeros.
cudaError_t encode_map(CUtensorMap* map, const void* base, int d, long long rows, long long batch,
                       long long heads, const Strides& st, int (&perm)[3]) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  struct Dim {
    long long size, stride;
    int role;
  } dims[3] = {{rows, st.s, 0}, {heads, st.h, 1}, {batch, st.b, 2}};
  for (Dim& x : dims)
    if (x.size == 1) x.stride = d;  // any valid stride: never stepped
  std::stable_sort(dims, dims + 3, [](const Dim& a, const Dim& b) { return a.stride < b.stride; });
  cuuint64_t size[4] = {cuuint64_t(d), 0, 0, 0}, stride[3];
  cuuint32_t box[4] = {64, 1, 1, 1}, unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    size[1 + i] = cuuint64_t(dims[i].size);
    stride[i] = cuuint64_t(dims[i].stride) * sizeof(bf16);
    if (dims[i].role == 0) box[1 + i] = 64;
    perm[dims[i].role] = 1 + i;
  }
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            size, stride, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_scoring(const Params& a, int batch, int device, cudaStream_t stream) {
  static bool raised[64] = {};
  if (!raised[device]) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_scoring_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(Sc<D>::kSmem));
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  ScoringParams p{static_cast<bf16*>(a.o), a.so, a.heads, a.group, a.s_len, a.causal, a.window,
                  a.softcap, a.scale, a.kv_len, {}, {}, {}};
  CUtensorMap tq, tk, tv;
  const long long kv_heads = a.heads / a.group, kv_rows = std::max(a.kv_len, 1);
  cudaError_t err = encode_map(&tq, a.q, D, a.s_len, batch, a.heads, a.sq, p.perm_q);
  if (err != cudaSuccess) return err;
  if (a.kv_len == 0) {  // no key is ever loaded (an empty cache may have no base)
    tk = tv = tq;
  } else {
    err = encode_map(&tk, a.k, D, kv_rows, batch, kv_heads, a.sk, p.perm_k);
    if (err == cudaSuccess) err = encode_map(&tv, a.v, D, kv_rows, batch, kv_heads, a.sv, p.perm_v);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.s_len + kScM - 1) / kScM, batch * a.heads);
  flash_fwd_scoring_kernel<D><<<grid, 128, Sc<D>::kSmem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace flash_impl

extern "C" {

// q (B, H, S, D), k/v (B, KV, T, D), o (B, H, S, D) as strided views with
// a contiguous last dim; dtype: 0 = fp32, 1 = bf16 (all four tensors).
// variant: 0 = the CUDA-core kernel, 1 = decode (bf16, S*G <= 16, with
// `splits` splits of `split_len` keys, the fp32 scratch `part` and the
// zeroed int counters `counters` when splits > 1), 2 = scoring (bf16).
int repro_flash_attention(int device, const void* q, const void* k, const void* v, void* o,
                          int dtype, int batch, int heads, int kv_heads, int s_len, int t_len,
                          int d, long long sq_b, long long sq_h, long long sq_s, long long sk_b,
                          long long sk_h, long long sk_s, long long sv_b, long long sv_h,
                          long long sv_s, long long so_b, long long so_h, long long so_s,
                          int causal, int window, float softcap, float scale, int kv_len,
                          int variant, int split_len, int splits, void* part, void* counters,
                          void* stream) {
  using namespace flash_impl;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (kv_heads <= 0 || heads % kv_heads != 0 || d <= 0) return cudaErrorInvalidValue;
  Params p{q,        k,      v,     o,       {sq_b, sq_h, sq_s}, {sk_b, sk_h, sk_s},
           {sv_b, sv_h, sv_s}, {so_b, so_h, so_s}, heads, heads / kv_heads,
           s_len,    t_len,  d,     causal,  window, softcap, scale, kv_len};
  auto st = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    if (dtype == 0) return dispatch<float>(p, batch, device, st);
    if (dtype == 1) return dispatch<__nv_bfloat16>(p, batch, device, st);
    return cudaErrorInvalidValue;
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  if (variant == 1) {
    if (s_len * p.group > kDecRows || splits < 1 || splits > kMaxSplits || split_len < 1 ||
        split_len % kDecKeys || (splits > 1 && (!part || !counters)))
      return cudaErrorInvalidValue;
    DecodeParams dp{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<bf16*>(o), p.sq, p.sk, p.sv, p.so,
                    kv_heads, p.group, s_len, causal, window, softcap, scale, kv_len,
                    split_len, splits, static_cast<float*>(part), static_cast<int*>(counters)};
    const int bkv = batch * kv_heads;
    if (d == 64) return launch_decode<64>(dp, bkv, device, st);
    if (d == 128) return launch_decode<128>(dp, bkv, device, st);
    if (d == 256) return launch_decode<256>(dp, bkv, device, st);
    return cudaErrorInvalidValue;
  }
  if (variant == 2) {
    if (d == 64) return launch_scoring<64>(p, batch, device, st);
    if (d == 128) return launch_scoring<128>(p, batch, device, st);
    if (d == 256) return launch_scoring<256>(p, batch, device, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
