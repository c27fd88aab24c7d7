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
//     two parts stream into the same shared-memory ring, part 0's K-steps
//     then part 1's (K-stacked on chip), so the concat never exists; CO is
//     any multiple of 8, not the TPU tool's fixed 192.
//   * the GEMM core of tools/conv_chw_spike.py (`gemm()` :206, `kern` :217,
//     `pallas_call` :223): [Co, K] x [nblk, K, npx] -> [nblk, Co, npx], one
//     part with A shared across the batch (a_batch = 0).
//
// What bounds it on this card: the skip projection at 16x256^2x(192+192) ->
// 192 is 155 GFLOP against 1.21 GB of activations in and out, so device
// memory bounds it (0.36 ms at 3.35 TB/s); the conv core at Co = 192, K =
// 1728 is 696 GFLOP against 3.6 GB of B, also bytes-bound (~1.2 ms a case).
// So the design reads every byte of the large operand once from device
// memory and keeps enough of it in flight to run at the memory's rate.
//
// The design (bf16; attention_sm90.cuh's TMA, mbarrier and wgmma helpers;
// the mainloop of conv3x3_chw.cu without taps):
//   - a block tile is 192 rows of A x BN columns of B, BN = 192 when N <=
//     192 and 256 otherwise (ops/gemm_conv.py::gemm_tiles).  The tile
//     covers the short side whole at both hot shapes: at the conv core every
//     row of A (M = Co = 192), so each byte of B leaves device memory once
//     and A (663 KB) streams from L2; at the skip projection every column of
//     B (N = CO = 192), so each pixel row of x1 and x2 is read once and the
//     147 KB of weights stream from L2;
//   - A reaches shared memory by TMA in K-major boxes of 32 lanes x 192
//     rows, through one map per part {K_p, M, batch}; B in MN-major boxes of
//     32 columns x 64 K rows, through one map per part over its own K_p rows
//     ({N, K_p, batch}, part 1's base at row K0).  Each map zero-fills past
//     its own K_p, so the last K-step of a part whose K_p is not a multiple
//     of 64 meets zero A lanes with zero B rows, and rows past M and columns
//     past N are zeros too.  B is [K, N] with N contiguous: the wgmma reads
//     it with the transpose bit (wgmma_ss_mn), 32-column chunks 4 KB apart;
//   - one thread of a producer warpgroup streams the K-steps (64 deep: two A
//     boxes and BN / 32 B boxes, 56 KB at BN = 256) through a 4-stage ring;
//     the producer warpgroup gives its registers to the three consumer
//     warpgroups (setmaxnreg 24 / 160), each of which runs two m64n(BN/2)k16
//     wgmma per 16 of K on its 64 rows of A (one m64n256 would need all of
//     its 128 accumulators live in one instruction, above the 128 registers
//     a thread of the 512-thread block is compiled for), holding BN / 2
//     accumulators a thread;
//   - persistent blocks, one per SM, walk the (batch, M-tile, N-tile) tiles
//     with N fastest, the producer running into the next tile's K-steps
//     while the consumers store; the epilogue rounds to bf16 and masks rows
//     past M and columns past N.  Neighbouring blocks share their A tile
//     (the conv core) or their B tile (the skip projection) in L2.
// K0, K1, N, the row and batch strides must be multiples of 8 and the
// pointers 16-byte aligned (TMA); M is any size.

#include <algorithm>
#include <climits>

#include "attention_common.cuh"
#include "attention_sm90.cuh"

namespace mmdiff {

// ---------------------------------------------------------------------------
// The Hopper kernel
// ---------------------------------------------------------------------------

constexpr int kGemmWG = 3;                               // consumer warpgroups, 64 rows each
constexpr int kGemmTileM = kGemmWG * sm90::kRows;        // rows of A per tile
constexpr int kGemmKStep = 2 * sm90::kChunk;             // K per ring stage
constexpr int kGemmStages = 4;                           // depth of the ring
constexpr int kGemmBlockThreads = (kGemmWG + 1) * sm90::kWarpgroup;
constexpr int kGemmConsumerRegs = 160, kGemmProducerRegs = 24;
constexpr int kGemmABox = kGemmTileM * sm90::kChunk * 2;  // one A box: 192 rows x 32 lanes

template <int BN>
struct GemmSmem {
  static constexpr int kBBytes = BN / sm90::kChunk * sm90::kChunkBytes;  // BN / 32 boxes
  uint8_t a[kGemmStages][2 * kGemmABox];
  uint8_t b[kGemmStages][kBBytes];
  uint64_t full[kGemmStages];
  uint64_t empty[kGemmStages];
};

struct GemmArgs {
  bf16* c;
  long long ldc, c_batch;
  int m, n;
  int steps0, steps1;             // K-steps of each part
  int mtiles, ntiles, tiles;
  int batched;                    // bit p (A) and 2 + p (B): part p's map has a batch axis
};

struct GemmTile {
  int z, m0, n0;
};

__device__ __forceinline__ GemmTile gemm_tile(const GemmArgs& a, int tile, int bn) {
  const int nt = tile % a.ntiles;
  tile /= a.ntiles;
  return GemmTile{tile / a.mtiles, (tile % a.mtiles) * kGemmTileM, nt * bn};
}

// The 4 x 4 transpose of 32-bit values across the four threads of a quad
// (t = lane & 3): returns {thread 0's v[t], thread 1's v[t], thread 2's v[t],
// thread 3's v[t]}.  In round i a thread sends v[(t - i) & 3] and receives
// thread (t + i) & 3's v[t].
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&v)[4], int t) {
  uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int send = (t - i) & 3, src = (t + i) & 3;
    const uint32_t x = send == 0 ? v[0] : send == 1 ? v[1] : send == 2 ? v[2] : v[3];
    const uint32_t y = __shfl_sync(0xffffffffu, x, ((threadIdx.x & 31) & ~3) | src);
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = src == k ? y : o[k];
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

template <int BN>
__global__ void __launch_bounds__(kGemmBlockThreads, 1)
    gemm_bf16_sm90_kernel(const __grid_constant__ CUtensorMap a0_map,
                          const __grid_constant__ CUtensorMap a1_map,
                          const __grid_constant__ CUtensorMap b0_map,
                          const __grid_constant__ CUtensorMap b1_map, const GemmArgs a) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  GemmSmem<BN>& sm = aligned_smem<GemmSmem<BN>>(smem_raw);
  const int warp = threadIdx.x >> 5, steps = a.steps0 + a.steps1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kGemmWG * kWarpgroup);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kGemmWG * 4) {  // producer warpgroup: one lane issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kGemmProducerRegs));
    if (threadIdx.x == kGemmWG * kWarpgroup) {
      int it = 0;  // K-steps issued by this block, across its tiles
      for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
        const GemmTile tl = gemm_tile(a, tile, BN);
        for (int s = 0; s < steps; ++s, ++it) {
          const int st = it % kGemmStages;
          mbar_wait(&sm.empty[st], ((it / kGemmStages) & 1) ^ 1);
          mbar_expect_tx(&sm.full[st], 2 * kGemmABox + GemmSmem<BN>::kBBytes);
          const int part = s < a.steps0 ? 0 : 1;
          const int k0 = (part ? s - a.steps0 : s) * kGemmKStep;  // K row within the part
          const CUtensorMap* am = part ? &a1_map : &a0_map;
          const CUtensorMap* bm = part ? &b1_map : &b0_map;
          const int za = (a.batched >> part) & 1 ? tl.z : 0;
          const int zb = (a.batched >> (2 + part)) & 1 ? tl.z : 0;
#pragma unroll
          for (int c = 0; c < 2; ++c)
            tma_load(sm.a[st] + c * kGemmABox, am, &sm.full[st], k0 + c * kChunk, tl.m0, za, 0);
#pragma unroll
          for (int c = 0; c < BN / kChunk; ++c)
            tma_load(sm.b[st] + c * kChunkBytes, bm, &sm.full[st], tl.n0 + c * kChunk, k0, zb, 0);
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg: rows m0 + 64 wg + [0, 64) of the tile; this
  // thread holds rows r_lo and r_lo + 8, columns n0 + 8 j + 2 t + {0, 1}.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kGemmConsumerRegs));
  const int wg = warp >> 2, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int it = 0;
  constexpr int kHalf = BN / 2;  // columns of each of the two m64nBN/2 products
  float acc[2][kHalf / 2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
    for (int i = 0; i < kHalf / 2; ++i) acc[hf][i] = 0.f;  // each tile's first product overwrites it
  }
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const GemmTile tl = gemm_tile(a, tile, BN);
    int prev = 0;
    for (int s = 0; s < steps; ++s, ++it) {
      const int st = it % kGemmStages;
      mbar_wait(&sm.full[st], (it / kGemmStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGemmKStep / 16; ++kk) {
        // k-step kk: A box kk / 2 at (kk & 1) * 32 bytes into its rows; B's
        // K rows [16 kk, 16 kk + 16) of every 32-column chunk, half hf's
        // chunks from chunk hf * kHalf / 32 on
        const uint32_t a_k = smem_u32(sm.a[st] + (kk >> 1) * kGemmABox + wg * kChunkBytes);
        const uint64_t da = desc(a_k + (kk & 1) * 32, 16, 512);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          wgmma_ss_mn<kHalf>(acc[hf], da,
                             desc(smem_u32(sm.b[st] + hf * (kHalf / kChunk) * kChunkBytes) +
                                      kk * 16 * 64,
                                  kChunkBytes, 512),
                             s > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous K-step's products are done with its stage
      if (s > 0) mbar_arrive(&sm.empty[prev]);
      prev = st;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) fence_regs(acc[hf]);
    mbar_arrive(&sm.empty[prev]);

    // Rows r_lo and r_lo + 8.  A thread holds two columns of each 8-column
    // block; the four threads of a quad (one row) trade them so that thread
    // t holds all 8 columns of block 4 jb + t: one 16-byte store a thread per
    // 32 columns of a row.
    const int r_lo = tl.m0 + wg * kRows + (warp & 3) * 16 + g;
    bf16* cz = a.c + (long long)tl.z * a.c_batch;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r_lo + 8 * r;
      bf16* crow = cz + (long long)row * a.ldc;
#pragma unroll
      for (int jb = 0; jb < BN / 32; ++jb) {
        uint32_t v[4];  // this thread's column pair of blocks 4 jb + i
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 4 * jb + i;
          const float* pair = &acc[j / (kHalf / 8)][4 * (j % (kHalf / 8)) + 2 * r];
          v[i] = pack_bf16x2(pair[0], pair[1]);
        }
        const uint4 o = quad_transpose(v, t);
        const int col = tl.n0 + 32 * jb + 8 * t;  // N % 8 == 0: col < N implies col + 8 <= N
        if (row < a.m && col < a.n) *reinterpret_cast<uint4*>(crow + col) = o;
      }
    }
  }
}

// The A map of part p {K_p, M, batch} (batch extent 1 when shared) and its
// B map {N, K_p, batch} over the part's own K rows; sets the part's bits of
// `batched`.
static int encode_gemm_maps(CUtensorMap* am, CUtensorMap* bm, int* batched, int p, const void* a,
                            long long lda, long long a_batch, int k, const void* b,
                            long long ldb, long long b_batch, int m, int n, int batch) {
  const bool za = a_batch != 0 && batch > 1, zb = b_batch != 0 && batch > 1;
  *batched |= (za << p) | (zb << (2 + p));
  const long az = za ? batch : 1, bz = zb ? batch : 1;
  const long as = za ? (long)a_batch : (long)lda * m, bs = zb ? (long)b_batch : (long)ldb * k;
  int err = encode_map_4d(am, a, {k, m, az, 1}, {(long)lda, as, as * az},
                          {sm90::kChunk, kGemmTileM, 1, 1});
  if (!err)
    err = encode_map_4d(bm, b, {n, k, bz, 1}, {(long)ldb, bs, bs * bz},
                        {sm90::kChunk, kGemmKStep, 1, 1});
  return err;
}

template <int BN>
static int launch_gemm_sm90(const CUtensorMap (&maps)[4], const GemmArgs& a, cudaStream_t stream) {
  constexpr size_t smem = sizeof(GemmSmem<BN>) + 1024;
  const int err = (int)cudaFuncSetAttribute(gemm_bf16_sm90_kernel<BN>,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const int blocks = std::min(a.tiles, sm_count());
  gemm_bf16_sm90_kernel<BN><<<blocks, kGemmBlockThreads, smem, stream>>>(maps[0], maps[1], maps[2],
                                                                        maps[3], a);
  return (int)cudaGetLastError();
}

static int gemm_bf16_sm90(const void* a0, long long lda0, long long a0_batch, int k0,
                          const void* a1, long long lda1, long long a1_batch, int k1,
                          const void* b, long long ldb, long long b_batch, void* c,
                          long long ldc, long long c_batch, int m, int n, int batch, int tile_n,
                          cudaStream_t stream) {
  const long long mult8[] = {k0, k1, n, lda0, lda1, ldb, ldc, a0_batch, a1_batch, b_batch, c_batch};
  for (long long x : mult8)
    if (x % 8) return (int)cudaErrorInvalidValue;
  if (std::min({m, n, batch, k0}) < 1 || k1 < 0 || (k1 > 0 && !a1) ||
      (tile_n != 192 && tile_n != 256))
    return (int)cudaErrorInvalidValue;
  GemmArgs a;
  a.batched = 0;
  CUtensorMap maps[4];  // a0, a1, b0, b1
  int err = encode_gemm_maps(&maps[0], &maps[2], &a.batched, 0, a0, lda0, a0_batch, k0, b, ldb,
                             b_batch, m, n, batch);
  if (!err && k1 > 0)
    err = encode_gemm_maps(&maps[1], &maps[3], &a.batched, 1, a1, lda1, a1_batch, k1,
                           static_cast<const bf16*>(b) + (long long)k0 * ldb, ldb, b_batch, m, n,
                           batch);
  if (err) return err;
  if (k1 == 0) {  // one part: part 1's maps are never read
    maps[1] = maps[0];
    maps[3] = maps[2];
  }
  a.c = static_cast<bf16*>(c);
  a.ldc = ldc;
  a.c_batch = c_batch;
  a.m = m;
  a.n = n;
  a.steps0 = (k0 + kGemmKStep - 1) / kGemmKStep;
  a.steps1 = (k1 + kGemmKStep - 1) / kGemmKStep;
  a.mtiles = (m + kGemmTileM - 1) / kGemmTileM;
  a.ntiles = (n + tile_n - 1) / tile_n;
  const long long tiles = (long long)a.mtiles * a.ntiles * batch;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  return tile_n == 192 ? launch_gemm_sm90<192>(maps, a, stream)
                       : launch_gemm_sm90<256>(maps, a, stream);
}

}  // namespace mmdiff

// See the note at the top.  a1 may be null with k1 = 0 (one part).  The
// Hopper kernel, with BN = tile_n (192 or 256; ops/gemm_conv.py::
// gemm_tiles).  Returns the first CUDA error of the tensor maps' encoding
// or the launch (0 on success).
extern "C" int mmdiff_gemm_bf16(const void* a0, long long lda0, long long a0_batch, int k0,
                                const void* a1, long long lda1, long long a1_batch, int k1,
                                const void* b, long long ldb, long long b_batch, void* c,
                                long long ldc, long long c_batch, int m, int n, int batch,
                                int tile_n, void* stream) {
  return mmdiff::gemm_bf16_sm90(a0, lda0, a0_batch, k0, a1, lda1, a1_batch, k1, b, ldb, b_batch,
                                c, ldc, c_batch, m, n, batch, tile_n,
                                static_cast<cudaStream_t>(stream));
}
