// Shared pieces of the mma.sync attention backward kernels: the banded
// backward (banded_attention_bwd.cu, replacing `_banded_bwd_lw1_kernel` and
// `_banded_bwd_oneshot_kernel`, mm_diffusion_tpu/ops/block_attention.py:792,
// :877), the flash MHA backward (flash_mha.cu) and the self-attention
// backward's design for fp32 inputs (self_attention_bwd.cu; bf16
// runs attention_sm90.cuh): a flash-attention backward in two passes on
// Hopper's warp-level bf16 tensor-core product (mma.sync m16n8k16, fp32
// accumulate), with P recomputed from the logsumexp that the forward kernels
// write.  Bound on this card by the re-reads of K/V and Q/dO per tile and
// the blocks in flight.
//
//   dq pass   one block per (sequence, head, 64 query rows); each warp holds
//             16 query rows and their dO rows as mma A fragments and loops
//             over 32-key tiles of K and V staged in shared memory:
//               S = Q K^T, P = exp(S - lse), dP = dO V^T,
//               dS = P (dP - delta) / sqrt(d), dQ += dS K.
//             It first writes delta = rowsum(dO * O) (fp32) for the dkv pass.
//   dkv pass  one block per (sequence, head, 64 keys); each warp owns 16 keys
//             and loops over 32-row query tiles of Q, dO, lse and delta:
//               S^T = K Q^T, P^T = exp(S^T - lse), dP^T = V dO^T,
//               dS^T = P^T (dP^T - delta) / sqrt(d),
//               dV += P^T dO, dK += dS^T Q.
//
// Every gradient is summed in registers by the one block that owns its rows:
// no atomics, no partial outputs, the same result on every run.  The two
// passes recompute S and P once each (7 tile products per key-query tile
// against the 5 a fused single pass needs), the price of needing neither
// atomics nor a second reduction.
//
// Shared-memory tiles are row-major bf16 with kPadK elements of row padding;
// an operand that the product needs transposed is read as two 16-bit loads
// (lds_b_cols) instead of being stored twice.  Inputs are read in place by
// offset and row stride from the packed projections, fp32 inputs rounded to
// bf16 when staged; rows past a sequence's end are zero-filled and masked,
// and so are the lanes past the real head dim `dim` (attention_common.cuh).

#pragma once

#include "attention_common.cuh"

namespace mmdiff {

constexpr int kBwdTile = 32;           // keys per tile (dq pass), queries per tile (dkv pass)
constexpr int kBwdKeys = 16 * kWarps;  // keys per block of the dkv pass

// Two consecutive elements as fp32 (for delta = rowsum(dO * O)).
template <typename T>
struct Load2;

template <>
struct Load2<bf16> {
  static __device__ __forceinline__ float2 get(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

template <>
struct Load2<float> {
  static __device__ __forceinline__ float2 get(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};

// Stage `rows` rows of `dim` elements (row stride `stride`) into a bf16 tile
// of `tile_rows` rows and D lanes; the rows past `rows` and lanes past `dim`
// are zero.
template <int D, typename T>
__device__ __forceinline__ void stage_rows(unsigned short* dst, const T* src, long stride,
                                           int rows, int tile_rows, int dim) {
  constexpr int kPairs = D / 2;
  for (int idx = threadIdx.x; idx < tile_rows * kPairs; idx += kThreads) {
    const int r = idx / kPairs;
    const int c = (idx - r * kPairs) * 2;
    const uint32_t v = r < rows && c < dim ? Io<T>::load_pair(src + r * stride + c) : 0u;
    *reinterpret_cast<uint32_t*>(dst + r * (D + kPadK) + c) = v;
  }
}

// A fragment of rows [r0, r0 + 16) and columns [c0, c0 + 16) of a row-major
// shared tile with leading dimension `ld`.
static __device__ __forceinline__ void lds_a(uint32_t (&a)[4], const unsigned short* tile, int ld,
                                             int r0, int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned short* p0 = tile + (r0 + g) * ld + c0 + 2 * t;
  const unsigned short* p1 = p0 + 8 * ld;
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
}

// B fragment (k in [k0, k0 + 16), n in [n0, n0 + 8)) of B = X^T, X a
// row-major shared tile indexed [n][k]: pairs along k are contiguous.
static __device__ __forceinline__ void lds_b_rows(uint32_t& b0, uint32_t& b1,
                                                  const unsigned short* tile, int ld, int n0,
                                                  int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned short* p = tile + (n0 + g) * ld + k0 + 2 * t;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment of B = X, X a row-major shared tile indexed [k][n]: each pair
// along k is two 16-bit loads from consecutive rows.
static __device__ __forceinline__ void lds_b_cols(uint32_t& b0, uint32_t& b1,
                                                  const unsigned short* tile, int ld, int k0,
                                                  int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned short* p = tile + (k0 + 2 * t) * ld + n0 + g;
  b0 = (uint32_t)p[0] | ((uint32_t)p[ld] << 16);
  b1 = (uint32_t)p[8 * ld] | ((uint32_t)p[9 * ld] << 16);
}

// A fragments of a warp's rows [row0, row0 + 16) of a global row-major array
// (row stride `stride`, `dim` columns, D lanes); rows at or past `rows` and
// lanes past `dim` are zero.
template <int D, typename T>
__device__ __forceinline__ void load_frags(uint32_t (&a)[D / 16][4], const T* x, long stride,
                                           int row0, int rows, int dim) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = row0 + g, r1 = row0 + g + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    const bool c0 = c < dim, c1 = c + 8 < dim;
    a[kk][0] = r0 < rows && c0 ? Io<T>::load_pair(x + r0 * stride + c) : 0u;
    a[kk][1] = r1 < rows && c0 ? Io<T>::load_pair(x + r1 * stride + c) : 0u;
    a[kk][2] = r0 < rows && c1 ? Io<T>::load_pair(x + r0 * stride + c + 8) : 0u;
    a[kk][3] = r1 < rows && c1 ? Io<T>::load_pair(x + r1 * stride + c + 8) : 0u;
  }
}

// Store a warp's C-fragment accumulator of rows [row0, row0 + 16) x `dim`
// columns (row stride `stride`), rows at or past `rows` skipped.
template <int D, typename T>
__device__ __forceinline__ void store_frags(const float (&acc)[D / 8][4], T* x, long stride,
                                            int row0, int rows, int dim) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = row0 + g, r1 = row0 + g + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (c >= dim) continue;
    if (r0 < rows) Io<T>::store_pair(x + r0 * stride + c, acc[n][0], acc[n][1]);
    if (r1 < rows) Io<T>::store_pair(x + r1 * stride + c, acc[n][2], acc[n][3]);
  }
}

// Zero a warp's rows [row0, row0 + 16) x `dim` columns.
template <int D, typename T>
__device__ __forceinline__ void zero_rows(T* x, long stride, int row0, int rows, int dim) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = row0 + g, r1 = row0 + g + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (c >= dim) continue;
    if (r0 < rows) Io<T>::store_pair(x + r0 * stride + c, 0.f, 0.f);
    if (r1 < rows) Io<T>::store_pair(x + r1 * stride + c, 0.f, 0.f);
  }
}

template <int D>
__device__ __forceinline__ void zero_acc(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
}

// C fragments of two adjacent 8-column tiles -> one 16-column A fragment.
static __device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                              const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// ---------------------------------------------------------------------------
// dq pass
// ---------------------------------------------------------------------------

template <int D>
struct DqState {
  uint32_t q[D / 16][4];   // the warp's query rows
  uint32_t go[D / 16][4];  // their output gradients dO
  float dq[D / 8][4];
  float lse2[2];   // logsumexp of rows g and g + 8, base-2 units
  float delta[2];  // rowsum(dO * O) of the two rows
};

// Load the warp's q and dO rows, read their logsumexp, compute delta from O
// and dO in fp32 and write it to `delta_out` for the dkv pass.
template <int D, typename T>
__device__ __forceinline__ void dq_begin(DqState<D>& st, const T* q, long q_stride, const T* o,
                                         const T* dout, long o_stride, const float* lse,
                                         float* delta_out, int row0, int rows, int dim) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  load_frags<D, T>(st.q, q, q_stride, row0, rows, dim);
  load_frags<D, T>(st.go, dout, o_stride, row0, rows, dim);
  zero_acc<D>(st.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    float acc = 0.f;
    if (r < rows) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = kk * 16 + 2 * t + 8 * half;
          if (c >= dim) continue;
          const float2 a = Load2<T>::get(o + r * o_stride + c);
          const float2 b = Load2<T>::get(dout + r * o_stride + c);
          acc += a.x * b.x + a.y * b.y;
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    st.delta[i] = acc;
    st.lse2[i] = r < rows ? lse[r] * kLog2e : 0.f;
    if (t == 0 && r < rows) delta_out[r] = acc;
  }
}

// One staged tile of `keys` valid keys (K and V row-major, kBwdTile rows).
template <int D>
__device__ __forceinline__ void dq_tile(DqState<D>& st, const unsigned short* sk,
                                        const unsigned short* sv, int keys, float scale_log2,
                                        float scale) {
  constexpr int kLd = D + kPadK;
  constexpr int kN = kBwdTile / 8;
  const int lane = threadIdx.x & 31, t = lane & 3;
  float s[kN][4], dp[kN][4];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      uint32_t b0, b1;
      lds_b_rows(b0, b1, sk, kLd, j * 8, kk * 16);
      mma_16816(s[j], st.q[kk], b0, b1);
      lds_b_rows(b0, b1, sv, kLd, j * 8, kk * 16);
      mma_16816(dp[j], st.go[kk], b0, b1);
    }
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j * 8 + 2 * t + (e & 1);
      const float p = key < keys ? exp2f(s[j][e] * scale_log2 - st.lse2[e >> 1]) : 0.f;
      s[j][e] = p * (dp[j][e] - st.delta[e >> 1]) * scale;  // dS
    }
  }
#pragma unroll
  for (int kk = 0; kk < kBwdTile / 16; ++kk) {
    uint32_t a[4];
    c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t b0, b1;
      lds_b_cols(b0, b1, sk, kLd, kk * 16, n * 8);
      mma_16816(st.dq[n], a, b0, b1);
    }
  }
}

// All key tiles of one key/value sequence of `len` rows.
template <int D, typename T>
__device__ __forceinline__ void dq_sequence(DqState<D>& st, unsigned short* sk, unsigned short* sv,
                                            const T* k, const T* v, long stride, int len,
                                            int dim, float scale_log2, float scale) {
  for (int k0 = 0; k0 < len; k0 += kBwdTile) {
    const int rows = min(kBwdTile, len - k0);
    stage_rows<D, T>(sk, k + k0 * stride, stride, rows, kBwdTile, dim);
    stage_rows<D, T>(sv, v + k0 * stride, stride, rows, kBwdTile, dim);
    __syncthreads();
    dq_tile<D>(st, sk, sv, rows, scale_log2, scale);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// dkv pass
// ---------------------------------------------------------------------------

template <int D>
struct DkvState {
  float dk[D / 8][4];
  float dv[D / 8][4];
};

// Dynamic shared memory of the dkv pass: the block's K and V rows, one query
// tile of Q and dO, and the tile's logsumexp (base 2) and delta.
template <int D>
struct DkvSmem {
  static constexpr int kLd = D + kPadK;
  unsigned short *k, *v, *q, *go;
  float *lse2, *delta;

  static constexpr size_t bytes() {
    return (size_t)(2 * kBwdKeys + 2 * kBwdTile) * kLd * sizeof(unsigned short) +
           2 * kBwdTile * sizeof(float);
  }

  __device__ explicit DkvSmem(unsigned char* raw) {
    k = reinterpret_cast<unsigned short*>(raw);
    v = k + kBwdKeys * kLd;
    q = v + kBwdKeys * kLd;
    go = q + kBwdTile * kLd;
    lse2 = reinterpret_cast<float*>(go + kBwdTile * kLd);
    delta = lse2 + kBwdTile;
  }
};

// One staged query tile against the warp's 16 keys (rows [key_row0,
// key_row0 + 16) of the block's K and V tiles).  Query columns past the end
// carry lse2 = +inf, so their P and dS are exactly zero.
template <int D>
__device__ __forceinline__ void dkv_tile(DkvState<D>& st, const DkvSmem<D>& sm, int key_row0,
                                         float scale_log2, float scale) {
  constexpr int kLd = D + kPadK;
  constexpr int kN = kBwdTile / 8;
  const int lane = threadIdx.x & 31, t = lane & 3;
  float s[kN][4], dp[kN][4];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t ak[4], av[4];
    lds_a(ak, sm.k, kLd, key_row0, kk * 16);
    lds_a(av, sm.v, kLd, key_row0, kk * 16);
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      uint32_t b0, b1;
      lds_b_rows(b0, b1, sm.q, kLd, j * 8, kk * 16);
      mma_16816(s[j], ak, b0, b1);
      lds_b_rows(b0, b1, sm.go, kLd, j * 8, kk * 16);
      mma_16816(dp[j], av, b0, b1);
    }
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = j * 8 + 2 * t + (e & 1);
      const float p = exp2f(s[j][e] * scale_log2 - sm.lse2[qi]);
      dp[j][e] = p * (dp[j][e] - sm.delta[qi]) * scale;  // dS^T
      s[j][e] = p;                                        // P^T
    }
  }
#pragma unroll
  for (int kk = 0; kk < kBwdTile / 16; ++kk) {
    uint32_t ap[4], ad[4];
    c_to_a(ap, s[2 * kk], s[2 * kk + 1]);
    c_to_a(ad, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t b0, b1;
      lds_b_cols(b0, b1, sm.go, kLd, kk * 16, n * 8);
      mma_16816(st.dv[n], ap, b0, b1);
      lds_b_cols(b0, b1, sm.q, kLd, kk * 16, n * 8);
      mma_16816(st.dk[n], ad, b0, b1);
    }
  }
}

// All query tiles of one query sequence of `len` rows (q, dO with their row
// strides; lse, delta indexed by row).  The block's K and V must be staged.
template <int D, typename T>
__device__ __forceinline__ void dkv_sequence(DkvState<D>& st, const DkvSmem<D>& sm, const T* q,
                                             long q_stride, const T* dout, long g_stride,
                                             const float* lse, const float* delta, int len,
                                             int dim, float scale_log2, float scale) {
  const int key_row0 = (threadIdx.x >> 5) * 16;
  for (int q0 = 0; q0 < len; q0 += kBwdTile) {
    const int rows = min(kBwdTile, len - q0);
    stage_rows<D, T>(sm.q, q + q0 * q_stride, q_stride, rows, kBwdTile, dim);
    stage_rows<D, T>(sm.go, dout + q0 * g_stride, g_stride, rows, kBwdTile, dim);
    if (threadIdx.x < kBwdTile) {
      const int i = threadIdx.x;
      sm.lse2[i] = i < rows ? lse[q0 + i] * kLog2e : INFINITY;
      sm.delta[i] = i < rows ? delta[q0 + i] : 0.f;
    }
    __syncthreads();
    dkv_tile<D>(st, sm, key_row0, scale_log2, scale);
    __syncthreads();
  }
}

// Host side: allow a kernel its dynamic shared memory (the dkv pass above
// 48 KB at head dim 128), then launch.
template <typename Kernel>
static int set_dynamic_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace mmdiff
