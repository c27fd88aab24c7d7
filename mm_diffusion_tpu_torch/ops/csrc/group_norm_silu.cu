// GroupNorm, FiLM and SiLU in one kernel over bf16 activations, for the
// ResBlocks of the port's samplers (ops/group_norm.py).
//
//   y = (x - mean_g) * rstd_g * w_c + b_c
//   y = y * (1 + scale_nc) + shift_nc        (FiLM, when given)
//   out = bf16(silu(y))                      (or bf16(y) without the SiLU)
//
// x is channels-first and contiguous, [N, C, S]: a (sample, group) slab is
// one contiguous run of (C / G) * S elements.  Statistics are fp32 over the
// slab, the variance biased; every product is fp32 and the result is
// rounded to bf16 once, at the store.
//
// It replaces no Pallas kernel: on the TPU, XLA fuses the JAX package's
// GroupNormFP32 (mm_diffusion_tpu/models/layers.py) and the SiLU after it.
// Eager PyTorch runs the same function as seven passes (a bf16 -> fp32
// copy, the moments, the affine, FiLM's mul and add, the fp32 -> bf16 copy,
// the SiLU), about 34 bytes of device memory an element.
//
// Bound: device memory, 2 bytes read and 2 written an element (no
// operation count comes near the tensor cores' or the FMA units'; the SiLU's
// exp and reciprocal are two MUFU operations an element, half of what the
// special-function units do at 3.35 TB/s / 4 bytes).
//
// Design, built as described (device ms at every sampling shape: chip_smoke.py
// phase 13; PERF.md):
//   - a thread-block cluster of k <= 8 blocks holds a slab of up to 768 KB
//     in shared memory, each block a chunk of at most 96 KB, so that two
//     blocks share an SM and one's loads overlap the other's arithmetic.
//     Each block copies its chunk in with 16-byte cp.async, sums it from
//     shared memory, the cluster adds the blocks' sums over distributed
//     shared memory in a fixed order (the same float in every block), then
//     the squared deviations the same way, then each block writes its
//     chunk: every element leaves device memory once and enters it once
//     (4 bytes);
//   - a larger slab takes the two-read mode: one pass sums x - x0 and
//     (x - x0)^2 (x0 the slab's first element, a shift that keeps the
//     variance from cancelling), the cluster adds them, and a second pass
//     reads x again, last vector first, so that what the first pass read
//     last is still in L2, and writes (up to 6 bytes an element).  On the
//     card the chunks of 128-192 KB that would hold such a slab leave one
//     block to an SM, whose load, sums and stores then run one after the
//     other: 10-20% slower than the two reads at the 1 and 1.5 MB slabs of
//     the sampling paths (the SR decoder's 384-channel norm at 256^2, the
//     base MM-UNet's 256- and 384-channel video norms at 64^2).
//     ops/group_norm.py's private two-read entry forces this mode at any
//     slab, for the same-run comparison;
//   - per-channel coefficients (rstd * w * (1 + scale), and the matching
//     offset) are made once a block in shared memory, so the apply is one
//     FMA, the SiLU (one exp, one approximate reciprocal), and a 16-byte
//     store per 8 elements;
//   - 16-byte vectors need S % 8 == 0 and 16-byte aligned tensors; other
//     shapes (odd S) run the same passes element by element;
//   - k follows the slab's bytes (chunks of at most 96 KB) and the number
//     of slabs (more blocks a slab while slabs are fewer than twice the
//     SMs and chunks hold at least 8192 elements).
// What bounds it: the slabs of the 8x8 - 32x32 levels are a few KB, where
// a launch (~8 us) is most of the time; at the large levels the resident
// mode reaches 64-67% of the 4-byte bound, the two-read mode 51-54%.

#include <algorithm>
#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace mmdiff {
namespace gn {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 8;                      // the portable cluster size
constexpr int kVec = 8;                             // bf16 in a 16-byte vector
constexpr long kChunkTarget = 96L * 1024;           // bytes: two blocks share an SM
constexpr long kSmemLimit = 227L * 1024 - 1024;     // a block's dynamic shared memory, static kept aside
constexpr long kMinChunk = 8192;                    // elements: the least chunk worth its own block

struct Args {
  const bf16* x;
  bf16* out;
  const float* weight;  // [C]
  const float* bias;    // [C]
  const void* scale;    // FiLM [N, C], rows film_stride elements apart, or null
  const void* shift;
  long film_stride;
  int film_bf16;        // 1: scale / shift are bf16, 0: fp32
  int groups;
  int cpg;              // channels per group
  int s;                // elements per channel
  int slab;             // cpg * s
  int chunk;            // elements of a slab per block, a multiple of 8
  float eps;
  int silu;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void unpack8(const uint4& q, float (&f)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[kVec]) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return q;
}

__device__ __forceinline__ float apply(float v, float w, float b, int silu) {
  const float y = fmaf(v, w, b);
  return silu ? __fdividef(y, 1.f + __expf(-y)) : y;  // y -> -inf: y / inf = -0
}

// The sums of v[] over the block, then over the cluster's blocks in a fixed
// order, in every thread of every block of the cluster.  `part` holds this
// block's sums for its peers: a slot of its own for each call, since a
// peer may still read the last call's slot.
template <int kN>
__device__ void cluster_sum(float (&v)[kN], float* red, float* part, float* bcast,
                            cg::cluster_group& cluster, int k) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    v[i] = warp_sum(v[i]);
    if (lane == 0) red[i * kMaxWarps + warp] = v[i];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const float t = warp_sum(lane < warps ? red[i * kMaxWarps + lane] : 0.f);
      if (lane == 0) part[i] = t;
    }
  }
  cluster_arrive();  // part[] is written: release it to the cluster
  cluster_wait();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const float t = lane < k ? *cluster.map_shared_rank(&part[i], lane) : 0.f;
      const float total = warp_sum(t);  // a butterfly: the same float in every lane and block
      if (lane == 0) bcast[i] = total;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kN; ++i) v[i] = bcast[i];
}

template <bool kResident, bool kVector>
__global__ void __launch_bounds__(kMaxThreads, 2) group_norm_silu_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2 * kMaxWarps];
  __shared__ float part[2];  // the mean's sum, then the squared deviations' (two-read: both at once)
  __shared__ float bcast[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const long slab_id = blockIdx.x / k;
  const int n = (int)(slab_id / a.groups), g = (int)(slab_id % a.groups);
  const int lo = min(rank * a.chunk, a.slab), hi = min(lo + a.chunk, a.slab);
  const bf16* x = a.x + slab_id * (long)a.slab;
  bf16* out = a.out + slab_id * (long)a.slab;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int coef_bytes = (2 * a.cpg * (int)sizeof(float) + 15) & ~15;
  float* coef_w = reinterpret_cast<float*>(smem);
  float* coef_b = coef_w + a.cpg;
  bf16* buf = reinterpret_cast<bf16*>(smem + coef_bytes);  // the chunk (resident mode)
  const uint4* buf4 = reinterpret_cast<const uint4*>(buf);
  const int nv = (hi - lo) / kVec;

  float mean, rstd;
  if (kResident) {
    if (kVector) {
      for (int v = tid; v < nv; v += nt) cp_async16(buf + v * kVec, x + lo + v * kVec);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    } else {
      for (int i = tid; i < hi - lo; i += nt) buf[i] = x[lo + i];
    }
    __syncthreads();
    float s1[1] = {0.f};
    if (kVector) {
      for (int v = tid; v < nv; v += nt) {
        float f[kVec];
        unpack8(buf4[v], f);
#pragma unroll
        for (int i = 0; i < kVec; ++i) s1[0] += f[i];
      }
    } else {
      for (int i = tid; i < hi - lo; i += nt) s1[0] += __bfloat162float(buf[i]);
    }
    cluster_sum(s1, red, &part[0], bcast, cluster, k);
    mean = s1[0] / (float)a.slab;
    float s2[1] = {0.f};
    if (kVector) {
      for (int v = tid; v < nv; v += nt) {
        float f[kVec];
        unpack8(buf4[v], f);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float d = f[i] - mean;
          s2[0] = fmaf(d, d, s2[0]);
        }
      }
    } else {
      for (int i = tid; i < hi - lo; i += nt) {
        const float d = __bfloat162float(buf[i]) - mean;
        s2[0] = fmaf(d, d, s2[0]);
      }
    }
    cluster_sum(s2, red, &part[1], bcast, cluster, k);
    rstd = rsqrtf(s2[0] / (float)a.slab + a.eps);
  } else {
    const float x0 = __bfloat162float(x[0]);
    float s[2] = {0.f, 0.f};
    if (kVector) {
      for (int v = tid; v < nv; v += nt) {
        float f[kVec];
        unpack8(__ldg(reinterpret_cast<const uint4*>(x + lo) + v), f);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float d = f[i] - x0;
          s[0] += d;
          s[1] = fmaf(d, d, s[1]);
        }
      }
    } else {
      for (int i = lo + tid; i < hi; i += nt) {
        const float d = __bfloat162float(x[i]) - x0;
        s[0] += d;
        s[1] = fmaf(d, d, s[1]);
      }
    }
    cluster_sum(s, red, &part[0], bcast, cluster, k);
    const float dm = s[0] / (float)a.slab;
    mean = x0 + dm;
    rstd = rsqrtf(fmaxf(s[1] / (float)a.slab - dm * dm, 0.f) + a.eps);
  }
  cluster_arrive();  // this block's reads of its peers' sums are done (waited for before exit)

  for (int j = tid; j < a.cpg; j += nt) {
    const int c = g * a.cpg + j;
    float w = a.weight[c] * rstd;
    float b = a.bias[c] - mean * w;
    if (a.scale) {
      const long off = (long)n * a.film_stride + c;
      const float sc = a.film_bf16 ? __bfloat162float(static_cast<const bf16*>(a.scale)[off])
                                   : static_cast<const float*>(a.scale)[off];
      const float sh = a.film_bf16 ? __bfloat162float(static_cast<const bf16*>(a.shift)[off])
                                   : static_cast<const float*>(a.shift)[off];
      w *= 1.f + sc;
      b = fmaf(b, 1.f + sc, sh);
    }
    coef_w[j] = w;
    coef_b[j] = b;
  }
  __syncthreads();

  if (kVector) {
    for (int i = tid; i < nv; i += nt) {
      const int v = kResident ? i : nv - 1 - i;  // two-read: the last vectors read are in L2
      const int e = lo + v * kVec;
      const int j = e / a.s;  // S % 8 == 0: the vector lies in one channel
      float f[kVec];
      unpack8(kResident ? buf4[v] : __ldg(reinterpret_cast<const uint4*>(x + e)), f);
      const float w = coef_w[j], b = coef_b[j];
#pragma unroll
      for (int i = 0; i < kVec; ++i) f[i] = apply(f[i], w, b, a.silu);
      *reinterpret_cast<uint4*>(out + e) = pack8(f);
    }
  } else {
    for (int i = tid; i < hi - lo; i += nt) {
      const int e = kResident ? lo + i : hi - 1 - i;
      const int j = e / a.s;
      const float v = __bfloat162float(kResident ? buf[i] : x[e]);
      out[e] = __float2bfloat16_rn(apply(v, coef_w[j], coef_b[j], a.silu));
    }
  }
  cluster_wait();  // no block leaves while a peer may still read its sums
}

static int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms;
}

template <bool kResident, bool kVector>
static int launch(const Args& a, long slabs, int k, int threads, int smem, cudaStream_t stream) {
  auto kernel = group_norm_silu_kernel<kResident, kVector>;
  static int smem_set = 48 * 1024;  // the default limit; raised once a kernel (benign race)
  if (smem > smem_set) {
    const int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              (int)kSmemLimit);
    if (err) return err;
    smem_set = (int)kSmemLimit;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(slabs * k), 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int err = (int)cudaLaunchKernelEx(&cfg, kernel, a);
  return err ? err : (int)cudaGetLastError();
}

}  // namespace gn
}  // namespace mmdiff

// x, out [N, C, S] contiguous bf16; weight, bias [C] fp32; scale, shift
// [N, C] rows film_stride elements apart (bf16 if film_bf16, else fp32) or
// both null; C % groups == 0.  two_read forces the two-read mode (the
// same-run comparison).  Returns the launch's error (0 on success).
extern "C" int mmdiff_group_norm_silu(const void* x, void* out, const void* weight, const void* bias,
                                      const void* scale, const void* shift, long long film_stride,
                                      int film_bf16, int n, int c, int groups, long long s, float eps,
                                      int silu, int two_read, void* stream) {
  using namespace mmdiff::gn;
  if (n < 1 || c < 1 || groups < 1 || s < 1 || c % groups || (scale == nullptr) != (shift == nullptr))
    return (int)cudaErrorInvalidValue;
  const long cpg = c / groups, slab = cpg * s, slabs = (long)n * groups;
  if (slab > INT_MAX - kVec || s > INT_MAX) return (int)cudaErrorInvalidValue;
  const bool vec = slab % kVec == 0 && s % kVec == 0 && (reinterpret_cast<uintptr_t>(x) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) % 16) == 0;
  const long coef_bytes = (2 * cpg * (long)sizeof(float) + 15) & ~15L;
  auto chunk_of = [&](int k) { return ((slab + k - 1) / k + kVec - 1) / kVec * kVec; };
  // Blocks a slab: enough that a chunk fits ~96 KB, then more while the
  // slabs are fewer than twice the SMs and the chunks stay large.
  int k = 1;
  while (k < kMaxCluster && chunk_of(k) * 2 > kChunkTarget) k *= 2;
  const long sms = sm_count();
  while (k < kMaxCluster && slabs * k < 2 * sms && chunk_of(2 * k) >= kMinChunk) k *= 2;
  const long chunk = chunk_of(k);
  const bool resident = !two_read && chunk * 2 <= kChunkTarget && chunk * 2 + coef_bytes <= kSmemLimit;
  if (coef_bytes > kSmemLimit || slabs * k > INT_MAX) return (int)cudaErrorInvalidValue;
  const long items = vec ? chunk / kVec : chunk;  // a thread's work: ~4 vectors or elements at least
  const int threads = (int)std::min<long>(kMaxThreads, std::max<long>(64, ((items + 3) / 4 + 31) / 32 * 32));
  const int smem = (int)(coef_bytes + (resident ? (chunk * 2 + 15) / 16 * 16 : 0));

  Args a;
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  a.weight = static_cast<const float*>(weight);
  a.bias = static_cast<const float*>(bias);
  a.scale = scale;
  a.shift = shift;
  a.film_stride = (long)film_stride;
  a.film_bf16 = film_bf16;
  a.groups = groups;
  a.cpg = (int)cpg;
  a.s = (int)s;
  a.slab = (int)slab;
  a.chunk = (int)chunk;
  a.eps = eps;
  a.silu = silu;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (resident)
    return vec ? launch<true, true>(a, slabs, k, threads, smem, st)
               : launch<true, false>(a, slabs, k, threads, smem, st);
  return vec ? launch<false, true>(a, slabs, k, threads, smem, st)
             : launch<false, false>(a, slabs, k, threads, smem, st);
}
