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
// (2 or 3)*R*L*sizeof(T) bytes and writes R*L + 4*R; the consume reads
// R*L + 4*R + 2*R*L*sizeof(T) and writes R*L*sizeof(T).  A dozen flops per
// element is far below the arithmetic rate, and at the relay's wire shapes
// (R = 4*batch rows of L = 64) a call moves a few KiB, so launch latency
// bounds it: there the emit is one chain of latency, and its design keeps
// that chain short.
//
// Emit design.  The stepped latent never reaches memory, and the inputs
// are read from HBM once.  The launch plan (kernels/fused_sampler/ops.py::
// emit_plan, a pure function of the shapes, dtype and pointers) picks the
// route, the load width (16-byte loads when every base pointer and the row
// pitch allow, narrower down to scalar), the values a thread holds and the
// cluster size; the mode and "g == 1" are template parameters.  The
// coefficients' four roots are taken once per thread (step_factors),
// overlapping the loads; per element only the step's own operations and
// two IEEE divisions (x0 and the quantize) remain.
// * rows (L <= 1024): a group of 1-32 lanes per row, each lane holding its
//   values in registers; every load is issued before any arithmetic (one
//   memory round trip), the amax is a shuffle reduction within the group.
// * cluster (L > 1024): a thread-block cluster of 1-8 CTAs per row, each
//   CTA stepping its chunk once into dynamic shared memory; the CTAs'
//   partial amax meet through distributed shared memory, then each CTA
//   quantizes its own chunk from shared memory and rank 0 writes s.  A
//   cluster costs time of its own (a launch with a cluster dimension, the
//   cluster barrier; chip_smoke.py phase 5 times every cluster size), so
//   a cluster of one is a plain launch that reduces within the CTA, and
//   the plan grows the cluster only while rows x cluster stays within one
//   wave.
// * two-pass: a row whose chunks do not fit a cluster of 8 on chip
//   (ops.STAGE_MAX = 57,344 fp32 values, 224 KiB of shared memory a CTA,
//   so rows over 8 * 57,344 = 458,752 values; no path comes near) steps
//   its chunks twice, once for the amax and once to quantize.
#include <cooperative_groups.h>

#include "rowquant.cuh"

namespace cg = cooperative_groups;

// Named (not anonymous): types used as __global__ template arguments.
namespace fused_impl {

constexpr int kRouteRows = 0, kRouteCluster = 1, kRouteTwoPass = 2;
constexpr int kRowThreads = 128;      // CTA of the rows route
constexpr int kClusterThreads = 256;  // CTA of the cluster and two-pass routes
constexpr int kBatch = 4;             // vectors a cluster thread loads before stepping
constexpr int kRowValues = 32;        // most values a rows-route lane holds

// VEC consecutive elements from p[i] as fp32, in one load of
// VEC*sizeof(T) bytes (the launch plan guarantees the alignment).
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, long long i, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(p + i));
    v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
  } else if constexpr (VEC == 2) {
    const float2 r = __ldg(reinterpret_cast<const float2*>(p + i));
    v[0] = r.x, v[1] = r.y;
  } else {
    static_assert(VEC == 1, "fp32 loads are 4, 8 or 16 bytes");
    v[0] = __ldg(p + i);
  }
}

// bf16 -> fp32 is exact: a bf16's bits are the upper half of the fp32's
__device__ __forceinline__ void bf16x2_to_f32(unsigned w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, long long i, float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p + i));
    bf16x2_to_f32(r.x, v[0], v[1]);
    bf16x2_to_f32(r.y, v[2], v[3]);
    bf16x2_to_f32(r.z, v[4], v[5]);
    bf16x2_to_f32(r.w, v[6], v[7]);
  } else if constexpr (VEC == 4) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p + i));
    bf16x2_to_f32(r.x, v[0], v[1]);
    bf16x2_to_f32(r.y, v[2], v[3]);
  } else if constexpr (VEC == 2) {
    bf16x2_to_f32(__ldg(reinterpret_cast<const unsigned*>(p + i)), v[0], v[1]);
  } else {
    static_assert(VEC == 1, "bf16 loads are 2, 4, 8 or 16 bytes");
    v[0] = __uint_as_float(static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p + i)))
                           << 16);
  }
}

// q[i, i + VEC) = quantize(v, scale), in one store of VEC bytes
template <int VEC>
__device__ __forceinline__ void store_q(int8_t* q, long long i, const float (&v)[VEC], float scale) {
  unsigned w[(VEC + 3) / 4] = {};
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    w[e / 4] |= static_cast<unsigned>(static_cast<uint8_t>(repro::quantize(v[e], scale)))
                << (8 * (e % 4));
  if constexpr (VEC == 8) *reinterpret_cast<uint2*>(q + i) = make_uint2(w[0], w[1]);
  else if constexpr (VEC == 4) *reinterpret_cast<unsigned*>(q + i) = w[0];
  else if constexpr (VEC == 2) *reinterpret_cast<unsigned short*>(q + i) = static_cast<unsigned short>(w[0]);
  else q[i] = static_cast<int8_t>(w[0]);
}

// the k-th vector of a CTA's staged values in shared memory
template <int VEC>
__device__ __forceinline__ void stage_store(float* st, int k, const float (&v)[VEC]) {
  if constexpr (VEC >= 4) {
#pragma unroll
    for (int h = 0; h < VEC / 4; ++h)
      reinterpret_cast<float4*>(st)[k * (VEC / 4) + h] =
          make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
  } else if constexpr (VEC == 2) {
    reinterpret_cast<float2*>(st)[k] = make_float2(v[0], v[1]);
  } else {
    st[k] = v[0];
  }
}

template <int VEC>
__device__ __forceinline__ void stage_load(const float* st, int k, float (&v)[VEC]) {
  if constexpr (VEC >= 4) {
#pragma unroll
    for (int h = 0; h < VEC / 4; ++h) {
      const float4 r = reinterpret_cast<const float4*>(st)[k * (VEC / 4) + h];
      v[4 * h] = r.x, v[4 * h + 1] = r.y, v[4 * h + 2] = r.z, v[4 * h + 3] = r.w;
    }
  } else if constexpr (VEC == 2) {
    const float2 r = reinterpret_cast<const float2*>(st)[k];
    v[0] = r.x, v[1] = r.y;
  } else {
    v[0] = st[k];
  }
}

// One vector of the step's operands: loaded first, stepped later.
template <class T, bool GUIDED, int VEC>
struct Operands {
  float x[VEC], ec[VEC], eu[GUIDED ? VEC : 1];

  __device__ __forceinline__ void load(const T* xp, const T* ecp, const T* eup, long long i) {
    load_vec<VEC>(xp, i, x);
    load_vec<VEC>(ecp, i, ec);
    if constexpr (GUIDED) load_vec<VEC>(eup, i, eu);
  }

  // eps = eu + g*(ec - eu), or ec at g == 1; then the step
  template <int MODE>
  __device__ __forceinline__ void step(const repro::StepFactors& f, float g,
                                       float (&y)[VEC]) const {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float eps = ec[e];
      if constexpr (GUIDED) eps = __fadd_rn(eu[e], __fmul_rn(g, __fsub_rn(ec[e], eu[e])));
      y[e] = repro::step_apply(MODE, f, x[e], eps);
    }
  }
};

// Rows route: a group of 2^group_log2 lanes per row, PT vectors of VEC
// values per lane, interleaved so that neighbouring lanes read neighbouring
// addresses.  A lane past the last row, or a vector past the row's end,
// loads the row's first values and discards them: every load is
// unconditional, so all of them issue before the first arithmetic, and
// every lane of the warp reaches the shuffles.
template <class T, int MODE, bool GUIDED, int VEC, int PT>
__global__ void __launch_bounds__(kRowThreads)
    emit_rows_kernel(const T* x, const T* ec, const T* eu, const float* coeffs, float g,
                     int8_t* __restrict__ q, float* __restrict__ s, long long rows, int len,
                     int group_log2) {
  const long long t = static_cast<long long>(blockIdx.x) * kRowThreads + threadIdx.x;
  const long long row = t >> group_log2;
  const int group = 1 << group_log2;
  const int lane = static_cast<int>(t) & (group - 1);
  const long long base = (row < rows ? row : rows - 1) * len;
  const float c0 = __ldg(coeffs), c1 = __ldg(coeffs + 1);
  Operands<T, GUIDED, VEC> in[PT];
#pragma unroll
  for (int k = 0; k < PT; ++k) {
    const int j = (k * group + lane) * VEC;
    in[k].load(x, ec, eu, base + (j < len ? j : 0));
  }
  const repro::StepFactors f = repro::step_factors(MODE, c0, c1);
  float y[PT][VEC];
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < PT; ++k) {
    in[k].template step<MODE>(f, g, y[k]);
    if ((k * group + lane) * VEC < len) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) amax = fmaxf(amax, fabsf(y[k][e]));
    }
  }
  for (int off = group >> 1; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (row >= rows) return;
  const float scale = repro::row_scale(amax);
#pragma unroll
  for (int k = 0; k < PT; ++k) {
    const int j = (k * group + lane) * VEC;
    if (j < len) store_q<VEC>(q, base + j, y[k], scale);
  }
  if (lane == 0) s[row] = scale;
}

// The stepped vectors [v0, v1) of a row starting at element `base`: each
// thread takes every kClusterThreads-th vector, loading kBatch of them
// before stepping any, and hands each to visit(vector index, values).
template <class T, int MODE, bool GUIDED, int VEC, class Visit>
__device__ __forceinline__ void sweep(const T* x, const T* ec, const T* eu, long long base,
                                      int v0, int v1, const repro::StepFactors& f, float g,
                                      Visit visit) {
  for (int v = v0 + static_cast<int>(threadIdx.x); v < v1; v += kBatch * kClusterThreads) {
    Operands<T, GUIDED, VEC> in[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int vu = v + u * kClusterThreads;
      in[u].load(x, ec, eu, base + static_cast<long long>(vu < v1 ? vu : v) * VEC);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int vu = v + u * kClusterThreads;
      if (vu < v1) {
        float y[VEC];
        in[u].template step<MODE>(f, g, y);
        visit(vu, y);
      }
    }
  }
}

// barrier.cluster in two halves: arrive once this CTA has read the other
// CTAs' shared memory, wait before exiting, so that no CTA leaves while
// another may still read its shared memory
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" : : : "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" : : : "memory");
}

// Cluster and two-pass routes: the row blockIdx.x / cluster size, its
// vectors split into chunks of `chunk`, one per CTA of the cluster.  A
// cluster of one CTA (launched without clusters) reduces within the CTA.
// staged: the first sweep keeps the stepped chunk in dynamic shared memory
// and the quantize reads it from there; otherwise (two-pass) the quantize
// sweeps the chunk again from HBM.
template <class T, int MODE, bool GUIDED, int VEC>
__global__ void __launch_bounds__(kClusterThreads)
    emit_cluster_kernel(const T* x, const T* ec, const T* eu, const float* coeffs, float g,
                        int8_t* __restrict__ q, float* __restrict__ s, int len, int chunk,
                        bool staged) {
  extern __shared__ float4 stage4[];
  float* stage = reinterpret_cast<float*>(stage4);
  __shared__ float warp_amax[kClusterThreads / 32];
  __shared__ float cta_amax;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned size = cluster.num_blocks(), rank = cluster.block_rank();
  const long long row = blockIdx.x / size;
  const long long base = row * len;
  const int v0 = static_cast<int>(rank) * chunk;
  const int v1 = min(len / VEC, v0 + chunk);
  const float c0 = __ldg(coeffs), c1 = __ldg(coeffs + 1);
  const repro::StepFactors f = repro::step_factors(MODE, c0, c1);

  float amax = 0.f;
  sweep<T, MODE, GUIDED, VEC>(x, ec, eu, base, v0, v1, f, g, [&](int v, const float (&y)[VEC]) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) amax = fmaxf(amax, fabsf(y[e]));
    if (staged) stage_store<VEC>(stage, v - v0, y);
  });
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  amax = repro::warp_max(amax);
  if (lane == 0) warp_amax[warp] = amax;
  __syncthreads();
  if (warp == 0) {
    amax = repro::warp_max(lane < kClusterThreads / 32 ? warp_amax[lane] : 0.f);
    if (lane == 0) cta_amax = amax;
  }
  float row_amax;
  if (size > 1) {
    cluster.sync();  // every CTA's partial is in its shared memory
    row_amax = 0.f;
    for (unsigned r = 0; r < size; ++r)
      row_amax = fmaxf(row_amax, *cluster.map_shared_rank(&cta_amax, r));
    cluster_arrive();
  } else {
    __syncthreads();
    row_amax = cta_amax;
  }
  const float scale = repro::row_scale(row_amax);
  if (staged) {
    // a thread reads back the vectors it staged itself
    for (int v = v0 + static_cast<int>(threadIdx.x); v < v1; v += kClusterThreads) {
      float y[VEC];
      stage_load<VEC>(stage, v - v0, y);
      store_q<VEC>(q, base + static_cast<long long>(v) * VEC, y, scale);
    }
  } else {
    sweep<T, MODE, GUIDED, VEC>(x, ec, eu, base, v0, v1, f, g, [&](int v, const float (&y)[VEC]) {
      store_q<VEC>(q, base + static_cast<long long>(v) * VEC, y, scale);
    });
  }
  if (rank == 0 && threadIdx.x == 0) s[row] = scale;
  if (size > 1) cluster_wait();
}

template <class T>
struct EmitArgs {
  const T* x;
  const T* ec;
  const T* eu;
  const float* coeffs;
  float g;
  int8_t* q;
  float* s;
  long long rows;
  int len;
};

template <class T, int MODE, bool GUIDED, int VEC, int PT>
cudaError_t launch_rows(const EmitArgs<T>& a, int group, cudaStream_t st) {
  if constexpr (VEC * PT > kRowValues) {
    return cudaErrorInvalidValue;
  } else {
    int group_log2 = 0;
    while ((1 << group_log2) < group) ++group_log2;
    if (group != 1 << group_log2 || group > 32 || static_cast<long long>(group) * PT * VEC < a.len)
      return cudaErrorInvalidValue;
    const long long blocks = (a.rows * group + kRowThreads - 1) / kRowThreads;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    emit_rows_kernel<T, MODE, GUIDED, VEC, PT><<<static_cast<unsigned>(blocks), kRowThreads, 0, st>>>(
        a.x, a.ec, a.eu, a.coeffs, a.g, a.q, a.s, a.rows, a.len, group_log2);
    return cudaGetLastError();
  }
}

template <class T, int MODE, bool GUIDED, int VEC>
cudaError_t launch_cluster(const EmitArgs<T>& a, int cluster, bool staged, cudaStream_t st) {
  if (cluster < 1 || cluster > 8 || a.rows * cluster > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int chunk = (a.len / VEC + cluster - 1) / cluster;
  const size_t smem = staged ? static_cast<size_t>(chunk) * VEC * sizeof(float) : 0;
  const auto kernel = emit_cluster_kernel<T, MODE, GUIDED, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (cluster == 1) {  // a plain launch: no cluster launch, no cluster barrier
    kernel<<<static_cast<unsigned>(a.rows), kClusterThreads, smem, st>>>(
        a.x, a.ec, a.eu, a.coeffs, a.g, a.q, a.s, a.len, chunk, staged);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.rows * cluster));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a.x, a.ec, a.eu, a.coeffs, a.g, a.q, a.s, a.len, chunk,
                            staged);
}

// the plan's fields: route, values per thread (rows), lanes per row
// (rows), CTAs per row (cluster, two-pass)
struct Plan {
  int route, per_thread, group, cluster;
};

template <class T, int MODE, bool GUIDED, int VEC>
cudaError_t launch_emit_vec(const EmitArgs<T>& a, const Plan& p, cudaStream_t st) {
  if (VEC > 1 && a.len % VEC) return cudaErrorInvalidValue;
  if (p.route == kRouteCluster || p.route == kRouteTwoPass)
    return launch_cluster<T, MODE, GUIDED, VEC>(a, p.cluster, p.route == kRouteCluster, st);
  if (p.route != kRouteRows || p.per_thread % VEC) return cudaErrorInvalidValue;
  switch (p.per_thread / VEC) {
    case 1: return launch_rows<T, MODE, GUIDED, VEC, 1>(a, p.group, st);
    case 2: return launch_rows<T, MODE, GUIDED, VEC, 2>(a, p.group, st);
    case 4: return launch_rows<T, MODE, GUIDED, VEC, 4>(a, p.group, st);
    case 8: return launch_rows<T, MODE, GUIDED, VEC, 8>(a, p.group, st);
    case 16: return launch_rows<T, MODE, GUIDED, VEC, 16>(a, p.group, st);
    case 32: return launch_rows<T, MODE, GUIDED, VEC, 32>(a, p.group, st);
    default: return cudaErrorInvalidValue;
  }
}

template <class T, int MODE, bool GUIDED>
cudaError_t launch_emit_mode(const EmitArgs<T>& a, int vec, const Plan& p, cudaStream_t st) {
  switch (vec) {
    case 1: return launch_emit_vec<T, MODE, GUIDED, 1>(a, p, st);
    case 2: return launch_emit_vec<T, MODE, GUIDED, 2>(a, p, st);
    case 4: return launch_emit_vec<T, MODE, GUIDED, 4>(a, p, st);
    case 8:
      if constexpr (sizeof(T) == 2) return launch_emit_vec<T, MODE, GUIDED, 8>(a, p, st);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <class T>
cudaError_t launch_emit(const EmitArgs<T>& a, int mode, int vec, const Plan& p, cudaStream_t st) {
  const bool guided = a.g != 1.f;
  if (mode == repro::kModeDdim)
    return guided ? launch_emit_mode<T, repro::kModeDdim, true>(a, vec, p, st)
                  : launch_emit_mode<T, repro::kModeDdim, false>(a, vec, p, st);
  return guided ? launch_emit_mode<T, repro::kModeRf, true>(a, vec, p, st)
                : launch_emit_mode<T, repro::kModeRf, false>(a, vec, p, st);
}

template <class T>
__global__ void consume_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                               const T* __restrict__ ec, const T* __restrict__ eu,
                               const float* __restrict__ coeffs, float g, int mode,
                               T* __restrict__ out, long long n, int len) {
  const repro::StepFactors f = repro::step_factors(mode, coeffs[0], coeffs[1]);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float x = __fmul_rn(static_cast<float>(q[i]), s[i / len]);
    const float e = repro::load_f32(ec, i);
    const float eps = g == 1.f ? e : repro::cfg_combine(e, repro::load_f32(eu, i), g);
    repro::store_f32(out, i, repro::step_apply(mode, f, x, eps));
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

// dtype: 0 = fp32, 1 = bf16 (of x, eps_c, eps_u); mode: 0 = ddim, 1 = rf;
// then the launch plan of ops.emit_plan: route (0 rows, 1 cluster,
// 2 two-pass), elements per load, values per thread, lanes per row (rows
// route) and CTAs per row (cluster routes).  A plan the kernels do not
// instantiate returns cudaErrorInvalidValue.
int repro_fused_cfg_step_quant(int device, const void* x, const void* ec, const void* eu,
                               int dtype, const void* coeffs, float guidance, int mode, void* q,
                               void* s, long long rows, int len, int route, int vec,
                               int per_thread, int group, int cluster, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  const fused_impl::Plan plan{route, per_thread, group, cluster};
  auto* qp = static_cast<int8_t*>(q);
  auto* sp = static_cast<float*>(s);
  const auto* cf = static_cast<const float*>(coeffs);
  if (dtype == 0) {
    using T = float;
    return fused_impl::launch_emit<T>(
        {static_cast<const T*>(x), static_cast<const T*>(ec), static_cast<const T*>(eu), cf,
         guidance, qp, sp, rows, len},
        mode, vec, plan, st);
  }
  using T = __nv_bfloat16;
  return fused_impl::launch_emit<T>(
      {static_cast<const T*>(x), static_cast<const T*>(ec), static_cast<const T*>(eu), cf,
       guidance, qp, sp, rows, len},
      mode, vec, plan, st);
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
