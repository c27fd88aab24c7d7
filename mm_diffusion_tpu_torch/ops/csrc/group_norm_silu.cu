// GroupNorm, FiLM and SiLU in one kernel over bf16 activations, for the
// ResBlocks of the port's samplers (ops/group_norm.py).
//
//   x = x + t_nc                             (the input term, when given)
//   y = (x - mean_g) * rstd_g * w_c + b_c
//   y = y * (1 + scale_nc) + shift_nc        (FiLM, when given)
//   out = bf16(silu(y))                      (or bf16(y) without the SiLU)
//
// The input term t is the bias of the conv that wrote x (the image U-Net's
// ResBlocks run that conv without one), per channel, or per (sample,
// channel) with the time embedding added in: rows of C fp32 or bf16 values,
// added in fp32 before the statistics and before the apply (the
// channels-first kernel adds it to each element, the channels-last one
// folds it into its lanes' shifts, below), so the conv's broadcast bias add,
// a whole read and write of x, is gone.  A template flag (kInBias) and a
// kernel argument of its own: the instantiations without it are the
// kernels as they were.
//
// Two layouts, two kernels.  Channels-first, x contiguous [N, C, S]: a
// (sample, group) slab is one contiguous run of (C / G) * S elements
// (group_norm_silu_kernel).  Channels-last, x contiguous [N, S, C] (the
// image U-Net's activations, held with torch.channels_last strides): a
// sample is S rows of C channels and a group is C / G adjacent channels of
// every row (group_norm_silu_cl_kernel, below the first).  Statistics are
// fp32 over the (sample, group), the variance biased; every product is fp32
// and the result is rounded to bf16 once, at the store.
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
// Channels-first design, built as described (device ms at every sampling
// shape: chip_smoke.py phase 13; PERF.md):
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

// The input term: rows of C values, `stride` elements apart (0: one row for
// every sample), bf16 or fp32; a kernel argument of its own, so that the
// kernels without it keep their argument block.
struct Term {
  const void* rows;
  long stride;
  int bf16;
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

// Channel c of sample n's row of the input term, in fp32.
__device__ __forceinline__ float term_at(const Term& t, long n, long c) {
  const long off = n * t.stride + c;
  return t.bf16 ? __bfloat162float(static_cast<const bf16*>(t.rows)[off]) : static_cast<const float*>(t.rows)[off];
}

template <int kN>
__device__ __forceinline__ void add_term(float (&f)[kN], float t) {
#pragma unroll
  for (int i = 0; i < kN; ++i) f[i] += t;
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

template <bool kResident, bool kVector, bool kInBias>
__global__ void __launch_bounds__(kMaxThreads, 2) group_norm_silu_kernel(Args a, Term term) {
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
  const int coef_bytes = ((kInBias ? 3 : 2) * a.cpg * (int)sizeof(float) + 15) & ~15;
  float* coef_w = reinterpret_cast<float*>(smem);
  float* coef_b = coef_w + a.cpg;
  float* coef_t = coef_b + a.cpg;  // the group's input term (kInBias)
  bf16* buf = reinterpret_cast<bf16*>(smem + coef_bytes);  // the chunk (resident mode)
  const uint4* buf4 = reinterpret_cast<const uint4*>(buf);
  const int nv = (hi - lo) / kVec;

  if constexpr (kInBias) {
    for (int j = tid; j < a.cpg; j += nt) coef_t[j] = term_at(term, n, g * a.cpg + j);
    __syncthreads();
  }
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
        if constexpr (kInBias) add_term(f, coef_t[(lo + v * kVec) / a.s]);
#pragma unroll
        for (int i = 0; i < kVec; ++i) s1[0] += f[i];
      }
    } else {
      for (int i = tid; i < hi - lo; i += nt) {
        float v = __bfloat162float(buf[i]);
        if constexpr (kInBias) v += coef_t[(lo + i) / a.s];
        s1[0] += v;
      }
    }
    cluster_sum(s1, red, &part[0], bcast, cluster, k);
    mean = s1[0] / (float)a.slab;
    float s2[1] = {0.f};
    if (kVector) {
      for (int v = tid; v < nv; v += nt) {
        float f[kVec];
        unpack8(buf4[v], f);
        if constexpr (kInBias) add_term(f, coef_t[(lo + v * kVec) / a.s]);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float d = f[i] - mean;
          s2[0] = fmaf(d, d, s2[0]);
        }
      }
    } else {
      for (int i = tid; i < hi - lo; i += nt) {
        float v = __bfloat162float(buf[i]);
        if constexpr (kInBias) v += coef_t[(lo + i) / a.s];
        const float d = v - mean;
        s2[0] = fmaf(d, d, s2[0]);
      }
    }
    cluster_sum(s2, red, &part[1], bcast, cluster, k);
    rstd = rsqrtf(s2[0] / (float)a.slab + a.eps);
  } else {
    float x0 = __bfloat162float(x[0]);
    if constexpr (kInBias) x0 += coef_t[0];
    float s[2] = {0.f, 0.f};
    if (kVector) {
      for (int v = tid; v < nv; v += nt) {
        float f[kVec];
        unpack8(__ldg(reinterpret_cast<const uint4*>(x + lo) + v), f);
        if constexpr (kInBias) add_term(f, coef_t[(lo + v * kVec) / a.s]);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float d = f[i] - x0;
          s[0] += d;
          s[1] = fmaf(d, d, s[1]);
        }
      }
    } else {
      for (int i = lo + tid; i < hi; i += nt) {
        float v = __bfloat162float(x[i]);
        if constexpr (kInBias) v += coef_t[i / a.s];
        const float d = v - x0;
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
      if constexpr (kInBias) add_term(f, coef_t[j]);
      const float w = coef_w[j], b = coef_b[j];
#pragma unroll
      for (int i = 0; i < kVec; ++i) f[i] = apply(f[i], w, b, a.silu);
      *reinterpret_cast<uint4*>(out + e) = pack8(f);
    }
  } else {
    for (int i = tid; i < hi - lo; i += nt) {
      const int e = kResident ? lo + i : hi - 1 - i;
      const int j = e / a.s;
      float v = __bfloat162float(kResident ? buf[i] : x[e]);
      if constexpr (kInBias) v += coef_t[j];
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

template <bool kResident, bool kVector, bool kInBias>
static int launch(const Args& a, const Term& term, long slabs, int k, int threads, int smem, cudaStream_t stream) {
  auto kernel = group_norm_silu_kernel<kResident, kVector, kInBias>;
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
  const int err = (int)cudaLaunchKernelEx(&cfg, kernel, a, term);
  return err ? err : (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Channels-last mode: x, out [N, S, C] contiguous.
//
// A 16-byte vector holds 8 adjacent channels of one row, and a group of
// 6, 10, 12 or 18 channels starts inside a vector, so no vector belongs to
// one group.  The kernel therefore keeps per-channel sums, not per-group
// ones: a block is `rows` x `cols` threads over a row of C channels,
// cols = C / lanes (lanes = 8 channels a 16-byte vector, or 1 an element
// where C % 8 != 0), and thread (row, col) always holds the same lanes
// channels, of rows row, row + rows, ...  So
//   - every thread adds its channels' x - x0 and (x - x0)^2 in registers
//     (fp32, no group test in the loop; x0 the group's first element, a
//     shift that keeps the variance from cancelling);
//   - the block adds its rows' per-channel sums in shared memory by a fixed
//     tree, then each group's channels by one warp;
//   - each thread makes its lanes' coefficients (rstd * w * (1 + scale) and
//     the offset) once, in registers, and the apply is one FMA and the SiLU
//     a lane, a 16-byte streaming store per 8 channels;
//   - the input term (kInBias) costs the loops nothing: a group's shift is
//     x0 + t of its first channel, and a lane's shift is that less its own
//     channel's t, so the sums it adds are those of x + t less the group's
//     shift, and the offset it makes, b - (shift + mean) * w, carries t
//     into the apply; the loops are those of the kernel without the term.
// A sample is split by rows over a cluster of k blocks (each step of a
// block one contiguous run of rows x C elements); the blocks' group sums
// are added over distributed shared memory (the same float in every
// block), and the rows are read again last first, so that what the first
// pass read last is still in L2: up to 6 bytes an element.  k grows while
// the blocks stay within one an SM, up to 16 (a non-portable cluster, where
// the card schedules one): the SR U-Net's 16 samples take 8 blocks each,
// SDXL's 8 take 16.  There is no resident mode: one that held whole groups
// of a sample in shared memory (the 32^2 and smaller levels) measured no
// faster over an SR evaluation's norms (PERF.md).
// C > 8 * kRowThreads (or C > kRowThreads where C % 8 != 0) is refused.

constexpr int kRowThreads = 512;
constexpr int kRowMaxCluster = 16;
constexpr long kRowSmemCap = 110L * 1024;  // two blocks share an SM
constexpr int kRowUnroll = 4;              // loads in flight a thread

struct RowArgs {
  const bf16* x;
  bf16* out;
  const float* weight;  // [C]
  const float* bias;    // [C]
  const void* scale;    // FiLM [N, C], rows film_stride elements apart, or null
  const void* shift;
  long film_stride;
  int film_bf16;
  int c;         // channels: a row
  int cpg;       // channels per group
  long s;        // rows (pixels) a sample
  long chunk;    // rows a block
  int cols;      // threads along a row: C / lanes
  int rows;      // rows in flight
  int row_half;  // the reduction tree's first step: half the power of two >= rows
  float eps;
  int silu;
};

template <int kLanes>
struct RowVec;

template <>
struct RowVec<8> {
  using T = uint4;
  static __device__ __forceinline__ T load(const bf16* p) { return __ldg(reinterpret_cast<const T*>(p)); }
  static __device__ __forceinline__ void unpack(const T& q, float (&f)[8]) { unpack8(q, f); }
  static __device__ __forceinline__ void store(bf16* p, const float (&f)[8]) {  // streaming: evict first
    __stcs(reinterpret_cast<T*>(p), pack8(f));
  }
};

template <>
struct RowVec<1> {
  using T = bf16;
  static __device__ __forceinline__ T load(const bf16* p) { return *p; }
  static __device__ __forceinline__ void unpack(const T& q, float (&f)[1]) { f[0] = __bfloat162float(q); }
  static __device__ __forceinline__ void store(bf16* p, const float (&f)[1]) { *p = __float2bfloat16_rn(f[0]); }
};

// Shared memory: the rows' per-channel sums (2 x rows x C floats), the
// block's group sums and the cluster's (2 x groups each), the groups'
// shifts.
struct RowSmem {
  float* red;
  float* part;
  float* tot;
  float* shift;
};

inline long row_smem_bytes(int rows, int c, int groups) {
  return (2L * rows * c + 5L * groups) * (long)sizeof(float);
}

__device__ inline RowSmem row_smem(unsigned char* base, const RowArgs& a, int groups) {
  RowSmem m;
  m.red = reinterpret_cast<float*>(base);
  m.part = m.red + 2L * a.rows * a.c;
  m.tot = m.part + 2 * groups;
  m.shift = m.tot + 2 * groups;
  return m;
}

// The block's sums of s1[] and s2[] (each thread's lanes channels, over its
// rows) by group, into dst[0, groups) and dst[groups, 2 groups): the rows'
// per-channel sums added by a fixed tree in red, then each group's channels
// by one warp (lanes over channels, a butterfly).  blockDim.x >= 32.
template <int kLanes>
__device__ void row_block_sums(const float (&s1)[kLanes], const float (&s2)[kLanes], float* red, float* dst,
                               const RowArgs& a, int groups, int row, int c0) {
  const long plane = (long)a.rows * a.c;
  float* mine = red + (long)row * a.c + c0;
  if (row < a.rows) {  // not the idle threads of the last warp
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      mine[l] = s1[l];
      mine[plane + l] = s2[l];
    }
  }
  __syncthreads();
  for (int h = a.row_half; h >= 1; h >>= 1) {
    if (row < h && row + h < a.rows) {
      const float* other = mine + (long)h * a.c;
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        mine[l] += other[l];
        mine[plane + l] += other[plane + l];
      }
    }
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int i = warp; i < 2 * groups; i += warps) {
    const float* src = red + (i < groups ? 0 : plane) + (long)(i % groups) * a.cpg;
    float t = 0.f;
    for (int j = lane; j < a.cpg; j += 32) t += src[j];
    t = warp_sum(t);
    if (lane == 0) dst[i] = t;
  }
  __syncthreads();
}

// tot[i] = the sum of the cluster's blocks' part[i], i < m, in every block:
// a warp takes 32 / w values at once, w = k rounded up to a power of two,
// lane r of each w-lane segment reading block r's, then a butterfly within
// the segment (the same float in every block).
__device__ void row_cluster_sums(float* part, float* tot, int m, cg::cluster_group& cluster, int k) {
  cluster_arrive();  // part[] is written: release it to the cluster
  cluster_wait();
  int w = 1;
  while (w < k) w *= 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int per_warp = 32 / w, seg = lane / w, r = lane % w;
  for (int i0 = warp * per_warp; i0 < m; i0 += warps * per_warp) {
    const int i = i0 + seg;
    float t = (r < k && i < m) ? *cluster.map_shared_rank(part + i, r) : 0.f;
    for (int o = w / 2; o; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (r == 0 && i < m) tot[i] = t;
  }
  __syncthreads();
}

template <int kLanes>
__device__ __forceinline__ void row_sum(const float (&f)[kLanes], const float (&x0)[kLanes], float (&s1)[kLanes],
                                        float (&s2)[kLanes]) {
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    const float d = f[l] - x0[l];
    s1[l] += d;
    s2[l] = fmaf(d, d, s2[l]);
  }
}

// Lane l's coefficients (channel c0 + l of sample n; its group's sums in
// tot[g] and tot[groups + g]), in w[] and b[].
template <int kLanes>
__device__ __forceinline__ void row_coefficients(const RowArgs& a, const float* tot, int groups, long n,
                                                 int c0, bool active, const float (&x0)[kLanes],
                                                 float (&w)[kLanes], float (&b)[kLanes]) {
  const float m_inv = 1.f / ((float)a.s * (float)a.cpg);
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    const int c = active ? c0 + l : 0;
    const int g = c / a.cpg;
    const float dm = tot[g] * m_inv;
    const float mean = x0[l] + dm;
    const float rstd = rsqrtf(fmaxf(tot[groups + g] * m_inv - dm * dm, 0.f) + a.eps);
    w[l] = a.weight[c] * rstd;
    b[l] = a.bias[c] - mean * w[l];
    if (a.scale) {
      const long off = n * a.film_stride + c;
      const float sc = a.film_bf16 ? __bfloat162float(static_cast<const bf16*>(a.scale)[off])
                                   : static_cast<const float*>(a.scale)[off];
      const float sh = a.film_bf16 ? __bfloat162float(static_cast<const bf16*>(a.shift)[off])
                                   : static_cast<const float*>(a.shift)[off];
      w[l] *= 1.f + sc;
      b[l] = fmaf(b[l], 1.f + sc, sh);
    }
  }
}

template <int kLanes>
__device__ __forceinline__ void row_apply(float (&f)[kLanes], const float (&w)[kLanes], const float (&b)[kLanes],
                                          int silu) {
#pragma unroll
  for (int l = 0; l < kLanes; ++l) f[l] = apply(f[l], w[l], b[l], silu);
}

// Cluster (sample n) of k blocks, block r rows [r * chunk, ...).
template <int kLanes, bool kInBias>
__global__ void __launch_bounds__(kRowThreads, 2) group_norm_silu_cl_kernel(RowArgs a, Term term) {
  using V = RowVec<kLanes>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks();
  const int groups = a.c / a.cpg;
  const long rank = (long)cluster.block_rank();
  const long n = blockIdx.x / k;
  const long lo = rank * a.chunk < a.s ? rank * a.chunk : a.s;
  const long hi = lo + a.chunk < a.s ? lo + a.chunk : a.s;
  const bf16* x = a.x + n * a.s * a.c;
  bf16* out = a.out + n * a.s * a.c;
  const RowSmem m = row_smem(smem, a, groups);
  const int col = threadIdx.x % a.cols, row = threadIdx.x / a.cols;
  const int c0 = col * kLanes;
  const bool active = row < a.rows;  // the threads past rows x cols fill the last warp
  const long step = a.rows;
  const long first = active ? row : a.chunk;  // the idle threads take no row

  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float x0 = __bfloat162float(x[g * a.cpg]);
    if constexpr (kInBias) x0 += term_at(term, n, g * a.cpg);
    m.shift[g] = x0;
  }
  __syncthreads();
  float x0[kLanes], s1[kLanes], s2[kLanes];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    x0[l] = active ? m.shift[(c0 + l) / a.cpg] : 0.f;
    if constexpr (kInBias) x0[l] -= active ? term_at(term, n, c0 + l) : 0.f;
    s1[l] = 0.f;
    s2[l] = 0.f;
  }
  long p = lo + first;
  for (; p + (kRowUnroll - 1L) * step < hi; p += kRowUnroll * step) {
    typename V::T q[kRowUnroll];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) q[u] = V::load(x + (p + u * step) * a.c + c0);
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      float f[kLanes];
      V::unpack(q[u], f);
      row_sum(f, x0, s1, s2);
    }
  }
  for (; p < hi; p += step) {
    float f[kLanes];
    V::unpack(V::load(x + p * a.c + c0), f);
    row_sum(f, x0, s1, s2);
  }
  row_block_sums(s1, s2, m.red, m.part, a, groups, row, c0);
  row_cluster_sums(m.part, m.tot, 2 * groups, cluster, k);
  cluster_arrive();  // this block's reads of its peers' sums are done (waited for before exit)
  float w[kLanes], b[kLanes];
  row_coefficients(a, m.tot, groups, n, c0, active, x0, w, b);

  // The last rows first: what the first pass read last is still in L2.
  p = hi - 1 - first;
  for (; p - (kRowUnroll - 1L) * step >= lo; p -= kRowUnroll * step) {
    typename V::T q[kRowUnroll];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) q[u] = V::load(x + (p - u * step) * a.c + c0);
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      float f[kLanes];
      V::unpack(q[u], f);
      row_apply(f, w, b, a.silu);
      V::store(out + (p - u * step) * a.c + c0, f);
    }
  }
  for (; p >= lo; p -= step) {
    float f[kLanes];
    V::unpack(V::load(x + p * a.c + c0), f);
    row_apply(f, w, b, a.silu);
    V::store(out + p * a.c + c0, f);
  }
  cluster_wait();  // no block leaves while a peer may still read its sums
}

// The largest cluster (16 or 8 blocks) that the card schedules for the
// kernel's largest block: kRowThreads threads, kRowSmemCap bytes.
template <int kLanes, bool kInBias>
static int row_max_cluster(int* max_k) {
  auto kernel = group_norm_silu_cl_kernel<kLanes, kInBias>;
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kRowSmemCap);
  if (!err) err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kRowMaxCluster, 1, 1);
  cfg.blockDim = dim3(kRowThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)kRowSmemCap;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kRowMaxCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess) {
    (void)cudaGetLastError();  // not an error of the launch: fall back to the portable size
    clusters = 0;
  }
  *max_k = clusters > 0 ? kRowMaxCluster : kMaxCluster;
  return 0;
}

template <typename Kernel>
static int launch_row_kernel(Kernel kernel, const RowArgs& a, const Term& term, long blocks, int k, int threads,
                             int smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
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
  const int err = (int)cudaLaunchKernelEx(&cfg, kernel, a, term);
  return err ? err : (int)cudaGetLastError();
}

}  // namespace gn
}  // namespace mmdiff

// x, out [N, C, S] contiguous bf16; weight, bias [C] fp32; scale, shift
// [N, C] rows film_stride elements apart (bf16 if film_bf16, else fp32) or
// both null; in_bias the input term, rows of C in_stride elements apart (0:
// one row for every sample; bf16 if in_bf16, else fp32) or null; C % groups
// == 0.  two_read forces the two-read mode (the same-run comparison).
// Returns the launch's error (0 on success).
extern "C" int mmdiff_group_norm_silu(const void* x, void* out, const void* weight, const void* bias,
                                      const void* scale, const void* shift, long long film_stride,
                                      int film_bf16, const void* in_bias, long long in_stride, int in_bf16,
                                      int n, int c, int groups, long long s, float eps, int silu, int two_read,
                                      void* stream) {
  using namespace mmdiff::gn;
  if (n < 1 || c < 1 || groups < 1 || s < 1 || c % groups || (scale == nullptr) != (shift == nullptr))
    return (int)cudaErrorInvalidValue;
  const long cpg = c / groups, slab = cpg * s, slabs = (long)n * groups;
  if (slab > INT_MAX - kVec || s > INT_MAX) return (int)cudaErrorInvalidValue;
  const bool vec = slab % kVec == 0 && s % kVec == 0 && (reinterpret_cast<uintptr_t>(x) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) % 16) == 0;
  const bool term = in_bias != nullptr;
  const long coef_bytes = ((term ? 3 : 2) * cpg * (long)sizeof(float) + 15) & ~15L;
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
  const Term t = {in_bias, (long)in_stride, in_bf16};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (term) {
    if (resident)
      return vec ? launch<true, true, true>(a, t, slabs, k, threads, smem, st)
                 : launch<true, false, true>(a, t, slabs, k, threads, smem, st);
    return vec ? launch<false, true, true>(a, t, slabs, k, threads, smem, st)
               : launch<false, false, true>(a, t, slabs, k, threads, smem, st);
  }
  if (resident)
    return vec ? launch<true, true, false>(a, t, slabs, k, threads, smem, st)
               : launch<true, false, false>(a, t, slabs, k, threads, smem, st);
  return vec ? launch<false, true, false>(a, t, slabs, k, threads, smem, st)
             : launch<false, false, false>(a, t, slabs, k, threads, smem, st);
}

// Channels-last: x, out [N, S, C] contiguous bf16 (the memory of a
// torch.channels_last [N, C, H, W]); the rest as above, with no two-read
// flag (this mode always reads twice).  Returns cudaErrorInvalidValue for
// C > 8 * kRowThreads (C > kRowThreads where C % 8 != 0 or x / out are not
// 16-byte aligned).
extern "C" int mmdiff_group_norm_silu_cl(const void* x, void* out, const void* weight, const void* bias,
                                         const void* scale, const void* shift, long long film_stride,
                                         int film_bf16, const void* in_bias, long long in_stride, int in_bf16,
                                         int n, int c, int groups, long long s, float eps, int silu,
                                         void* stream) {
  using namespace mmdiff::gn;
  if (n < 1 || c < 1 || groups < 1 || s < 1 || c % groups || (scale == nullptr) != (shift == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool vec = c % kVec == 0 && (reinterpret_cast<uintptr_t>(x) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) % 16) == 0;
  if ((vec ? c / kVec : c) > kRowThreads || s > INT_MAX) return (int)cudaErrorInvalidValue;

  RowArgs a;
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  a.weight = static_cast<const float*>(weight);
  a.bias = static_cast<const float*>(bias);
  a.scale = scale;
  a.shift = shift;
  a.film_stride = (long)film_stride;
  a.film_bf16 = film_bf16;
  a.c = c;
  a.cpg = c / groups;
  a.s = (long)s;
  a.eps = eps;
  a.silu = silu;
  const Term t = {in_bias, (long)in_stride, in_bf16};
  // rows x cols threads (~kRowThreads), rounded up to whole warps (the idle
  // ones only join the reductions); the tree's first step.
  a.cols = c / (vec ? kVec : 1);
  a.rows = std::max(1, kRowThreads / a.cols);
  int half = 1;
  while (half < a.rows) half *= 2;
  a.row_half = half / 2;
  const int threads = (a.rows * a.cols + 31) / 32 * 32;

  // One query a kernel and process for the largest cluster the card
  // schedules, then k blocks a sample, doubled while the blocks stay within
  // one an SM and the chunks large.
  static const long sms = sm_count();  // one query a process
  static int max_k[2][2] = {{0, 0}, {0, 0}};
  const bool term = in_bias != nullptr;
  int& mk = max_k[vec][term];
  if (!mk) {
    const int err = term ? (vec ? row_max_cluster<8, true>(&mk) : row_max_cluster<1, true>(&mk))
                         : (vec ? row_max_cluster<8, false>(&mk) : row_max_cluster<1, false>(&mk));
    if (err) {
      mk = 0;
      return err;
    }
  }
  const long smem = row_smem_bytes(a.rows, c, groups);
  int k = 1;
  while (k < mk && (long)n * k * 2 <= sms && (s + 2 * k - 1) / (2 * k) * c >= kMinChunk) k *= 2;
  a.chunk = (s + k - 1) / k;
  if (smem > kRowSmemCap || (long)n * k > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long blocks = (long)n * k;
  if (term)
    return vec ? launch_row_kernel(group_norm_silu_cl_kernel<8, true>, a, t, blocks, k, threads, (int)smem, st)
               : launch_row_kernel(group_norm_silu_cl_kernel<1, true>, a, t, blocks, k, threads, (int)smem, st);
  return vec ? launch_row_kernel(group_norm_silu_cl_kernel<8, false>, a, t, blocks, k, threads, (int)smem, st)
             : launch_row_kernel(group_norm_silu_cl_kernel<1, false>, a, t, blocks, k, threads, (int)smem, st);
}
