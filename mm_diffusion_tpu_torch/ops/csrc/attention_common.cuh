// Shared pieces of the mma.sync attention forward kernels: the flash MHA
// forward (flash_mha.cu), the K1 variants (self_attention.cu), and the
// designs that fp32 inputs run of K1 (self_attention.cu) and of
// the banded RS-MMA forward (banded_attention.cu, replacing
// `_banded_oneshot_kernel` and `_banded_fwd_kernel`,
// mm_diffusion_tpu/ops/block_attention.py:609, :534; the bf16 K1 and banded
// forward run attention_sm90.cuh): a flash-attention inner loop on
// Hopper's warp-level bf16 tensor-core product (mma.sync m16n8k16, fp32
// accumulate).  Bound on
// this card by the bytes moved and the blocks in flight at the model's short
// sequences, and by this loop's unpipelined staging at T = 1024.
//
// Block shape: 4 warps, 16 query rows per warp (64 rows per block).  The
// query rows of a warp live in registers as mma A fragments for the whole
// kernel; keys and values are staged 64 rows at a time in shared memory
// (K row-major, V transposed so that both B operands are 32-bit loads), and
// an online softmax in fp32 (base-2 exponent, running max and sum per row)
// carries the output accumulator across tiles.
//
// Inputs are read in place from the packed qkv projection by offset and row
// stride: no layout copy is made.  bf16 inputs are staged as they are; fp32
// inputs are rounded to bf16 when staged (bf16 operands, fp32 accumulation).
//
// Head dims: a kernel built for D serves every head dim `dim` <= D with
// dim % 8 == 0 (ops/block_attention.py::kernel_head_dim picks D).  The lanes
// at or past `dim` are zero-filled on load and never stored: zero q/k lanes
// add nothing to a logit, and zero v lanes give output lanes nobody reads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mmdiff {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 16 * kWarps;  // query rows per block
constexpr int kBlockK = 64;           // keys per staged tile
constexpr int kPadK = 8;              // row padding (bf16) against bank conflicts
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

typedef __nv_bfloat16 bf16;

static __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two consecutive elements of a row, as one packed bf16 pair.
template <typename T>
struct Io;

template <>
struct Io<bf16> {
  static __device__ __forceinline__ uint32_t load_pair(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

template <>
struct Io<float> {
  static __device__ __forceinline__ uint32_t load_pair(const float* p) {
    float2 v = *reinterpret_cast<const float2*>(p);
    return pack_bf16(v.x, v.y);
  }
  static __device__ __forceinline__ void store_pair(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

// D[16x8] += A[16x16] * B[16x8]; A row-major, B column-major, fp32 accumulate.
static __device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 bit patterns (unsigned short keeps the shared arrays trivially
// constructible); read back as packed pairs.
template <int D>
struct SharedTiles {
  unsigned short k[kBlockK * (D + kPadK)];   // [key][dim]
  unsigned short vt[D * (kBlockK + kPadK)];  // [dim][key]
};

// Per-warp state: this warp's 16 query rows as A fragments, the output
// accumulator as C fragments, and the running max / sum of the two rows
// (g and g + 8) that each thread holds.
template <int D>
struct FlashState {
  uint32_t q[D / 16][4];
  float o[D / 8][4];
  float m[2];
  float l[2];
};

// Load rows [row0, row0 + 16) of a query block (row stride `stride`,
// `rows` valid rows in all, `dim` lanes) into A fragments; rows past the end
// and lanes past `dim` are zero.
template <int D, typename T>
__device__ __forceinline__ void load_queries(FlashState<D>& st, const T* q, long stride,
                                             int row0, int rows, int dim) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = row0 + g, r1 = row0 + g + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    const bool c0 = c < dim, c1 = c + 8 < dim;
    st.q[kk][0] = r0 < rows && c0 ? Io<T>::load_pair(q + r0 * stride + c) : 0u;
    st.q[kk][1] = r1 < rows && c0 ? Io<T>::load_pair(q + r1 * stride + c) : 0u;
    st.q[kk][2] = r0 < rows && c1 ? Io<T>::load_pair(q + r0 * stride + c + 8) : 0u;
    st.q[kk][3] = r1 < rows && c1 ? Io<T>::load_pair(q + r1 * stride + c + 8) : 0u;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[n][e] = 0.f;
  }
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;
}

// Stage `rows` (<= kBlockK) key and value rows of `dim` lanes into shared
// memory; the rest of the tile is zero so that masked keys never read stale
// values and lanes past `dim` add nothing.
template <int D, typename T>
__device__ __forceinline__ void stage_kv(SharedTiles<D>& sm, const T* k, const T* v,
                                         long stride, int rows, int dim) {
  constexpr int kPairs = D / 2;
  for (int idx = threadIdx.x; idx < kBlockK * kPairs; idx += kThreads) {
    const int r = idx / kPairs;
    const int c = (idx - r * kPairs) * 2;
    uint32_t kp = 0u, vp = 0u;
    if (r < rows && c < dim) {
      kp = Io<T>::load_pair(k + r * stride + c);
      vp = Io<T>::load_pair(v + r * stride + c);
    }
    *reinterpret_cast<uint32_t*>(&sm.k[r * (D + kPadK) + c]) = kp;
    sm.vt[c * (kBlockK + kPadK) + r] = (unsigned short)(vp & 0xffffu);
    sm.vt[(c + 1) * (kBlockK + kPadK) + r] = (unsigned short)(vp >> 16);
  }
}

// One staged tile of `keys` valid keys: S = Q K^T, online softmax, O += P V.
template <int D>
__device__ __forceinline__ void attend_tile(FlashState<D>& st, const SharedTiles<D>& sm,
                                            int keys, float scale_log2) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float s[kBlockK / 8][4];
#pragma unroll
  for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const unsigned short* kr = sm.k + (j * 8 + g) * (D + kPadK) + kk * 16 + 2 * t;
      mma_16816(s[j], st.q[kk], *reinterpret_cast<const uint32_t*>(kr),
                *reinterpret_cast<const uint32_t*>(kr + 8));
    }
  }

  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j * 8 + 2 * t + (e & 1);
      const float v = key < keys ? s[j][e] * scale_log2 : -INFINITY;
      s[j][e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
  }
  float alpha[2], mnew[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mnew[r] = fmaxf(st.m[r], mx[r]);  // finite: every tile holds a valid key
    alpha[r] = exp2f(st.m[r] - mnew[r]);
    st.m[r] = mnew[r];
  }
#pragma unroll
  for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[j][e] - mnew[e >> 1]);
      s[j][e] = p;
      rowsum[e >> 1] += p;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) st.l[r] = st.l[r] * alpha[r] + rowsum[r];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[n][e] *= alpha[e >> 1];
  }

  // The C fragments of S are the A fragments of P, two key octets at a time.
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const unsigned short* vr = sm.vt + (n * 8 + g) * (kBlockK + kPadK) + kk * 16 + 2 * t;
      mma_16816(st.o[n], a, *reinterpret_cast<const uint32_t*>(vr),
                *reinterpret_cast<const uint32_t*>(vr + 8));
    }
  }
}

// All tiles of one key/value sequence of `len` rows.
template <int D, typename T>
__device__ __forceinline__ void attend_sequence(FlashState<D>& st, SharedTiles<D>& sm,
                                                const T* k, const T* v, long stride,
                                                int len, int dim, float scale_log2) {
  for (int k0 = 0; k0 < len; k0 += kBlockK) {
    const int rows = min(kBlockK, len - k0);
    stage_kv<D, T>(sm, k + k0 * stride, v + k0 * stride, stride, rows, dim);
    __syncthreads();
    attend_tile<D>(st, sm, rows, scale_log2);
    __syncthreads();
  }
}

// out[row, :dim] = O / l for the warp's valid rows (row stride `stride`),
// and lse[row] = natural-log logsumexp of the scaled logits.
template <int D, typename T>
__device__ __forceinline__ void store_rows(FlashState<D>& st, T* out, long stride, float* lse,
                                           int row0, int rows, int dim) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 1);
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 2);
  }
  const float inv0 = 1.f / st.l[0], inv1 = 1.f / st.l[1];
  const int r0 = row0 + g, r1 = row0 + g + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (c >= dim) continue;
    if (r0 < rows) Io<T>::store_pair(out + r0 * stride + c, st.o[n][0] * inv0, st.o[n][1] * inv0);
    if (r1 < rows) Io<T>::store_pair(out + r1 * stride + c, st.o[n][2] * inv1, st.o[n][3] * inv1);
  }
  if (t == 0) {
    if (r0 < rows) lse[r0] = (st.m[0] + log2f(st.l[0])) * kLn2;
    if (r1 < rows) lse[r1] = (st.m[1] + log2f(st.l[1])) * kLn2;
  }
}

}  // namespace mmdiff
