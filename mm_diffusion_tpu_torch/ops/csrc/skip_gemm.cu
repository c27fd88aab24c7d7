// A bf16 GEMM whose A operand may come in two parts split along K:
//   C[z][M, N] = A0[z][M, K0] . B[z][0:K0, N] + A1[z][M, K1] . B[z][K0:K0+K1, N]
// with fp32 accumulation and a bf16 result.  A parts are row-major (K
// contiguous, row stride lda), B and C row-major (N contiguous); z is a
// batch index with its own element strides (0 shares an operand).
//
// It replaces two TPU spike kernels:
//   * `_gemm_kernel` (tools/bench_skip_conv.py:39, `pallas_call` in
//     `skip_gemm` :57): the decoder-skip 1x1 conv over two NHWC channel parts,
//     x1 . W[:C] + x2 . W[C:], without a concat in device memory.  Here the
//     two parts are staged tile by tile into the same shared-memory A tile
//     (K-stacked on chip), so the concat never exists; CO is any multiple of
//     8, not the TPU tool's fixed 192.
//   * the GEMM core of tools/conv_chw_spike.py (`gemm()` :206, `kern` :217,
//     `pallas_call` :223): [Co, K] x [nblk, K, npx] -> [nblk, Co, npx], one
//     part with A shared across the batch (a_batch = 0).
//
// What bounds it on this card: the skip projection at 16x256^2x(192+192) ->
// 192 is 155 GFLOP against 1.21 GB of activations in and out, so device
// memory bounds it (0.36 ms at 3.35 TB/s); the conv core is 696 GFLOP against
// 3.6 GB of B, also bytes-bound (~1.2 ms).  The design reads every
// activation byte once from device memory (the N tiles of one M tile run on
// neighbouring blocks, so A's re-reads hit L2), with 16-byte loads staged
// through registers one K tile ahead of the tensor-core products
// (mma.sync m16n8k16).  Speed (cp.async/TMA pipelines, wgmma) is later work.
//
// Tiles: 64 x 64 outputs per block, K in steps of 32, 4 warps of 32 x 32.
// Grid: (ceil(N / 64), ceil(M / 64), batch).  K0, K1, N and the row strides
// must be multiples of 8 and the pointers 16-byte aligned (the wrapper
// checks); M is any size, its ragged end masked.

#include "attention_bwd_common.cuh"

namespace mmdiff {

constexpr int kGemmBM = 64, kGemmBN = 64, kGemmBK = 32;
constexpr int kGemmThreads = 128;
constexpr int kGemmLdA = kGemmBK + 8;  // bf16 elements per shared A row (80 bytes)
constexpr int kGemmLdB = kGemmBN + 8;  // bf16 elements per shared B row (144 bytes)
constexpr int kGemmChunks = 2;         // 16-byte chunks per thread per tile and operand

struct GemmPart {
  const bf16* a;
  long long lda, a_batch;
  int k;
};

// Load K tile `tile` (of part 0's tiles, then part 1's) of A and B into
// registers, zeros outside the matrices.
__device__ __forceinline__ void gemm_load_tile(uint4 (&ra)[kGemmChunks], uint4 (&rb)[kGemmChunks],
                                               const GemmPart& p0, const GemmPart& p1,
                                               const bf16* b, long long ldb, int tile,
                                               int tiles0, int m0, int n0, int m, int n) {
  const bool first = tile < tiles0;
  const GemmPart& p = first ? p0 : p1;
  const int k0 = (first ? tile : tile - tiles0) * kGemmBK;
  const long long kb = (first ? 0 : p0.k) + k0;  // row of B
#pragma unroll
  for (int i = 0; i < kGemmChunks; ++i) {
    const int id = threadIdx.x + i * kGemmThreads;
    const int ar = id / (kGemmBK / 8), ac = (id % (kGemmBK / 8)) * 8;
    ra[i] = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + ar < m && k0 + ac < p.k)
      ra[i] = *reinterpret_cast<const uint4*>(p.a + (m0 + ar) * p.lda + k0 + ac);
    const int br = id / (kGemmBN / 8), bc = (id % (kGemmBN / 8)) * 8;
    rb[i] = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + br < p.k && n0 + bc < n)
      rb[i] = *reinterpret_cast<const uint4*>(b + (kb + br) * ldb + n0 + bc);
  }
}

__global__ void __launch_bounds__(kGemmThreads)
    gemm_bf16_kernel(GemmPart p0, GemmPart p1, const bf16* __restrict__ b, long long ldb,
                     long long b_batch, bf16* __restrict__ c, long long ldc, long long c_batch,
                     int m, int n) {
  __shared__ __align__(16) unsigned short sa[kGemmBM * kGemmLdA];
  __shared__ __align__(16) unsigned short sb[kGemmBK * kGemmLdB];
  const int z = blockIdx.z;
  p0.a += z * p0.a_batch;
  p1.a += z * p1.a_batch;
  b += z * b_batch;
  c += z * c_batch;
  const int n0 = blockIdx.x * kGemmBN, m0 = blockIdx.y * kGemmBM;
  const int warp = threadIdx.x >> 5, wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int tiles0 = (p0.k + kGemmBK - 1) / kGemmBK;
  const int tiles = tiles0 + (p1.k + kGemmBK - 1) / kGemmBK;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }

  uint4 ra[kGemmChunks], rb[kGemmChunks];
  if (tiles > 0) gemm_load_tile(ra, rb, p0, p1, b, ldb, 0, tiles0, m0, n0, m, n);
  for (int tile = 0; tile < tiles; ++tile) {
#pragma unroll
    for (int i = 0; i < kGemmChunks; ++i) {
      const int id = threadIdx.x + i * kGemmThreads;
      const int ar = id / (kGemmBK / 8), ac = (id % (kGemmBK / 8)) * 8;
      *reinterpret_cast<uint4*>(sa + ar * kGemmLdA + ac) = ra[i];
      const int br = id / (kGemmBN / 8), bc = (id % (kGemmBN / 8)) * 8;
      *reinterpret_cast<uint4*>(sb + br * kGemmLdB + bc) = rb[i];
    }
    __syncthreads();
    // The next tile's global loads are in flight during this tile's products.
    if (tile + 1 < tiles) gemm_load_tile(ra, rb, p0, p1, b, ldb, tile + 1, tiles0, m0, n0, m, n);
#pragma unroll
    for (int kk = 0; kk < kGemmBK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) lds_a(af[i], sa, kGemmLdA, wm + i * 16, kk * 16);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b0, b1;
        lds_b_cols(b0, b1, sb, kGemmLdB, kk * 16, wn + j * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_16816(acc[i][j], af[i], b0, b1);
      }
    }
    __syncthreads();
  }

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r0 = m0 + wm + i * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn + j * 8 + 2 * t;
      if (col >= n) continue;
      if (r0 < m)
        *reinterpret_cast<__nv_bfloat162*>(c + r0 * ldc + col) =
            __floats2bfloat162_rn(acc[i][j][0], acc[i][j][1]);
      if (r1 < m)
        *reinterpret_cast<__nv_bfloat162*>(c + r1 * ldc + col) =
            __floats2bfloat162_rn(acc[i][j][2], acc[i][j][3]);
    }
  }
}

}  // namespace mmdiff

// See the note at the top.  a1 may be null with k1 = 0 (one part).  Returns
// the launch's cudaGetLastError() (0 on success).
extern "C" int mmdiff_gemm_bf16(const void* a0, long long lda0, long long a0_batch, int k0,
                                const void* a1, long long lda1, long long a1_batch, int k1,
                                const void* b, long long ldb, long long b_batch, void* c,
                                long long ldc, long long c_batch, int m, int n, int batch,
                                void* stream) {
  using mmdiff::bf16;
  const mmdiff::GemmPart p0{static_cast<const bf16*>(a0), lda0, a0_batch, k0};
  const mmdiff::GemmPart p1{static_cast<const bf16*>(a1), lda1, a1_batch, k1};
  const dim3 grid((n + mmdiff::kGemmBN - 1) / mmdiff::kGemmBN,
                  (m + mmdiff::kGemmBM - 1) / mmdiff::kGemmBM, batch);
  mmdiff::gemm_bf16_kernel<<<grid, mmdiff::kGemmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p0, p1, static_cast<const bf16*>(b), ldb, b_batch, static_cast<bf16*>(c), ldc, c_batch, m,
      n);
  return (int)cudaGetLastError();
}
