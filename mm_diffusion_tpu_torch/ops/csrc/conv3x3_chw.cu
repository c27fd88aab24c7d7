// 3x3 SAME convolution in channel-major layout, as an implicit GEMM:
//   out[b, co, y, x] = sum_{ci, dy, dx} w[co, ci, dy, dx] . x[b, ci, y + dy - 1, x + dx - 1]
// (zero outside the image), i.e. per image out_T[Co, px] = W'[Co, 9 Ci] .
// im2col[9 Ci, px]; bf16 in, fp32 accumulation, bf16 out.
//
// Replaces the TPU spike kernel `_kernel` of tools/conv_chw_spike.py (:69,
// `pallas_call` in `conv3x3_chw` :142), which builds the im2col tile of a
// block of th = 8 rows in VMEM scratch (row shifts as lane slices of a
// haloed concat, column shifts as lane rolls) and runs one [Co, 9 Ci] x
// [9 Ci, TH*W] product per block.
//
// What bounds it on this card: at the SR U-Net's 16 x 192 x 256^2 -> 192
// the conv is 696 GFLOP against 0.4 GB of activations in and out, so the
// tensor cores bound it (0.70 ms at 989 TFLOP/s).  Below that bound it also
// pays for its L2 stream: every output tile needs all of W' (663 KB at Ci =
// Co = 192) and nine shifted views of three input rows.
//
// The design (bf16; attention_sm90.cuh's TMA, mbarrier and wgmma helpers):
//   - the weights, reordered once per call by the wrapper into tap-major K
//     order W' [Co, 9, Ci'] (Ci' = Ci rounded up to 8, zeros past Ci), are
//     the GEMM's A operand, K-major, read through a map {Ci', 9, Co} in
//     boxes of 32 channels x 192 output channels;
//   - the input is read through a map {Ci', W + 2, H + 2, B} of a
//     channels-last copy with a one-pixel zero ring, which the wrapper makes
//     once per call (channels_last_halo_kernel): the B operand of tap (dy,
//     dx) and channels [ci0, ci0 + 64) is two boxes of 32 channels x 256
//     pixels at (ci0 + 32 c, x0 + dx, y + dy, b).  A tap's shift is then a
//     box coordinate of a pixel axis: TMA's tiled mode needs the box to
//     start 16-byte aligned in the innermost dimension (a start at x = -1
//     of the channel-major input faults with an illegal instruction on the
//     card), so a one-pixel shift along a contiguous W cannot be a
//     coordinate.  The ring is SAME padding, TMA zero-fills past the ring,
//     and the im2col matrix exists neither in device nor in shared memory.
//     B is K-major: 256 pixel rows of 64 channel lanes, the layout of K in
//     S = Q K^T;
//   - a tile is 192 output channels x 256 pixels of one output row; three
//     consumer warpgroups each run two m64n128k16 wgmma per k-step (A and
//     B from shared memory) over the 9 * ceil(Ci' / 64) K-steps, which one
//     thread of a producer warpgroup streams through a 4-stage ring of 56
//     KB stages; the producer warpgroup gives its registers to the
//     consumers (setmaxnreg 24 / 160), whose 128 accumulators would spill
//     under the 128 registers a thread of the 512-thread block starts with.
//     The 256-pixel tile reads 30% fewer bytes through L2 than a 128-pixel
//     one (6.2 against 8.8 GB at the bench shape);
//   - persistent blocks, one per SM, walk the (Co / 192, B, H, W / 256)
//     tiles, the producer running into the next tile's K-steps while the
//     consumers store; the epilogue rounds to bf16 and masks rows past Co
//     and columns past W.
// Ci, Co, H and W are unrestricted.

#include <algorithm>
#include <climits>

#include "attention_common.cuh"
#include "attention_sm90.cuh"

namespace mmdiff {

// ---------------------------------------------------------------------------
// The Hopper kernel
// ---------------------------------------------------------------------------

constexpr int kConvWG = 3;                                  // consumer warpgroups, 64 co each
constexpr int kConvM = kConvWG * sm90::kRows;               // output channels per tile
constexpr int kConvN = 256;                                 // output pixels per tile
constexpr int kConvHalves = kConvN / 128;                   // m64n128 products per k-step
constexpr int kConvK = 64;                                  // input channels per K-step
constexpr int kConvStages = 4;                              // depth of the ring
// Three consumer warpgroups and a producer warpgroup, whose registers the
// consumers take over (setmaxnreg): a consumer thread's 128 accumulators
// need more than the 128 registers a thread of a 512-thread block starts
// with.
constexpr int kConvBlockThreads = (kConvWG + 1) * sm90::kWarpgroup;
constexpr int kConvConsumerRegs = 160, kConvProducerRegs = 24;
constexpr int kConvAHalf = kConvM * sm90::kChunk * 2;       // one A box: 192 co x 32 ci
constexpr int kConvABytes = 2 * kConvAHalf;                 // 24 KB
constexpr int kConvBHalf = kConvN * sm90::kChunk * 2;       // one B box: 256 px x 32 ci
constexpr int kConvBBytes = 2 * kConvBHalf;                 // 32 KB

struct ConvSmem {
  uint8_t a[kConvStages][kConvABytes];
  uint8_t b[kConvStages][kConvBBytes];
  uint64_t full[kConvStages];
  uint64_t empty[kConvStages];
};

struct ConvArgs {
  bf16* out;
  int batch, co, h, w;  // w: the output's (real) width
  int xsegs, tiles, ck;  // kConvN-pixel segments per row, tiles, K-steps per tap
};

struct ConvTile {
  int co0, b, y, x0;
};

__device__ __forceinline__ ConvTile conv_tile(const ConvArgs& a, int tile) {
  const int xs = tile % a.xsegs;
  tile /= a.xsegs;
  const int y = tile % a.h;
  tile /= a.h;
  return ConvTile{(tile / a.batch) * kConvM, tile % a.batch, y, xs * kConvN};
}

__global__ void __launch_bounds__(kConvBlockThreads, 1)
    conv3x3_chw_sm90_kernel(const __grid_constant__ CUtensorMap x_map,
                            const __grid_constant__ CUtensorMap w_map, const ConvArgs a) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  ConvSmem& sm = aligned_smem<ConvSmem>(smem_raw);
  const int warp = threadIdx.x >> 5, steps = 9 * a.ck;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kConvStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConvWG * kWarpgroup);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConvWG * 4) {  // producer warpgroup: one lane issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kConvProducerRegs));
    if (threadIdx.x == kConvWG * kWarpgroup) {
      int it = 0;  // K-steps issued by this block, across its tiles
      for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
        const ConvTile tl = conv_tile(a, tile);
        for (int s = 0; s < steps; ++s, ++it) {
          const int st = it % kConvStages;
          mbar_wait(&sm.empty[st], ((it / kConvStages) & 1) ^ 1);
          mbar_expect_tx(&sm.full[st], kConvABytes + kConvBBytes);
          const int tap = s / a.ck, ci0 = (s - tap * a.ck) * kConvK;
          const int dy = tap / 3, dx = tap - 3 * dy;
#pragma unroll
          for (int c = 0; c < 2; ++c)
            tma_load(sm.a[st] + c * kConvAHalf, &w_map, &sm.full[st], ci0 + c * kChunk, tap,
                     tl.co0, 0);
#pragma unroll
          for (int c = 0; c < 2; ++c)
            tma_load(sm.b[st] + c * kConvBHalf, &x_map, &sm.full[st], ci0 + c * kChunk,
                     tl.x0 + dx, tl.y + dy, tl.b);
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg: output channels co0 + 64 wg + [0, 64), as
  // kConvHalves accumulators of 128 pixels; this thread holds channels
  // co_lo and co_lo + 8, pixels x0 + 128 hf + 8 j + 2 t + {0, 1}.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConvConsumerRegs));
  const int wg = warp >> 2, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool vec2 = (a.w & 1) == 0;  // bf16x2 stores stay 4-byte aligned
  int it = 0;
  float acc[kConvHalves][64];
#pragma unroll
  for (int hf = 0; hf < kConvHalves; ++hf) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[hf][i] = 0.f;  // each tile's first product overwrites it
  }
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const ConvTile tl = conv_tile(a, tile);
    int prev = 0;
    for (int s = 0; s < steps; ++s, ++it) {
      const int st = it % kConvStages;
      mbar_wait(&sm.full[st], (it / kConvStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kConvK / 16; ++kk) {
        // k-step kk: box kk / 2 of each operand, its 16 lanes at (kk & 1) * 32 bytes
        const uint32_t a_k = smem_u32(sm.a[st] + (kk >> 1) * kConvAHalf + wg * kChunkBytes);
        const uint32_t b_k = smem_u32(sm.b[st] + (kk >> 1) * kConvBHalf);
        const uint64_t da = desc(a_k + (kk & 1) * 32, 16, 512);
#pragma unroll
        for (int hf = 0; hf < kConvHalves; ++hf)  // pixel rows [128 hf, 128 hf + 128) of B
          wgmma_ss_n128(acc[hf], da, desc(b_k + hf * 128 * 64 + (kk & 1) * 32, 16, 512),
                        s > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous K-step's products are done with its stage
      if (s > 0) mbar_arrive(&sm.empty[prev]);
      prev = st;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int hf = 0; hf < kConvHalves; ++hf) fence_regs(acc[hf]);
    mbar_arrive(&sm.empty[prev]);

    const int co_lo = tl.co0 + wg * kRows + (warp & 3) * 16 + g;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int co = co_lo + 8 * r;
      if (co >= a.co) continue;
      bf16* row = a.out + (((long)tl.b * a.co + co) * a.h + tl.y) * a.w;
#pragma unroll
      for (int j = 0; j < kConvN / 8; ++j) {
        const int x = tl.x0 + 8 * j + 2 * t;
        const float* pair = &acc[j / 16][4 * (j % 16) + 2 * r];  // columns x, x + 1
        const float v0 = pair[0], v1 = pair[1];
        if (vec2) {
          if (x < a.w) *reinterpret_cast<__nv_bfloat162*>(row + x) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (x < a.w) row[x] = __float2bfloat16_rn(v0);
          if (x + 1 < a.w) row[x + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// The input as the kernel above reads it: x [B, Ci, H, W] -> x_halo [B, H
// + 2, W + 2, ci_row], channels-last, with a one-pixel ring of zeros and
// zeros past Ci.  Memory-bound (one read of x, one write of the copy); a
// block transposes a tile of 64 channels x 64 pixels of one row through
// shared memory, so that both the reads (along W) and the 16-byte writes
// (along the channels) are coalesced.  Grid B * ceil(ci_row / 64) * (H +
// 2) * ceil((W + 2) / 64), 256 threads.
constexpr int kHaloTile = 64;
constexpr int kHaloThreads = 256;

__global__ void __launch_bounds__(kHaloThreads)
    channels_last_halo_kernel(const unsigned short* __restrict__ x, unsigned short* __restrict__ xh,
                              int ci_n, int ci_row, int h, int w) {
  __shared__ unsigned short tile[kHaloTile][kHaloTile + 2];  // [channel][pixel]
  const int ctiles = (ci_row + kHaloTile - 1) / kHaloTile;
  const int xtiles = (w + 2 + kHaloTile - 1) / kHaloTile;
  int blk = blockIdx.x;  // (b, channel tile, copy row, pixel tile), the last fastest
  const int xh0 = (blk % xtiles) * kHaloTile;
  blk /= xtiles;
  const int yh = blk % (h + 2), y = yh - 1;
  blk /= h + 2;
  const int b = blk / ctiles, c0 = (blk - b * ctiles) * kHaloTile;
  const int lane = threadIdx.x & (kHaloTile - 1);
  const int xo = xh0 + lane - 1;  // the input column of copy column xh0 + lane
  const bool in_row = y >= 0 && y < h && xo >= 0 && xo < w;
  for (int c = threadIdx.x / kHaloTile; c < kHaloTile; c += kHaloThreads / kHaloTile) {
    const int ci = c0 + c;
    tile[c][lane] = in_row && ci < ci_n ? x[(((long)b * ci_n + ci) * h + y) * w + xo] : 0;
  }
  __syncthreads();
  const int w2 = w + 2;
  for (int i = threadIdx.x; i < kHaloTile * (kHaloTile / 8); i += kHaloThreads) {
    const int px = i >> 3, cv = (i & 7) * 8;  // pixel, first of 8 channels
    if (xh0 + px >= w2 || c0 + cv >= ci_row) continue;
    uint32_t v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = (uint32_t)tile[cv + 2 * k][px] | ((uint32_t)tile[cv + 2 * k + 1][px] << 16);
    *reinterpret_cast<uint4*>(xh + (((long)b * (h + 2) + yh) * w2 + xh0 + px) * ci_row + c0 + cv) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

static int conv3x3_chw_sm90(const void* x_halo, const void* w_taps, void* out, int batch,
                            int ci_row, int co, int h, int w, cudaStream_t stream) {
  if (ci_row % 8 || std::min({batch, ci_row, co, h, w}) < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap x_map, w_map;
  const long row = (long)(w + 2) * ci_row;
  int err = encode_map_4d(&x_map, x_halo, {ci_row, w + 2, h + 2, batch},
                          {ci_row, row, (long)(h + 2) * row}, {sm90::kChunk, kConvN, 1, 1});
  if (!err)
    err = encode_map_4d(&w_map, w_taps, {ci_row, 9, co, 1},
                        {ci_row, 9L * ci_row, 9L * ci_row * co}, {sm90::kChunk, 1, kConvM, 1});
  if (err) return err;
  ConvArgs a;
  a.out = static_cast<bf16*>(out);
  a.batch = batch;
  a.co = co;
  a.h = h;
  a.w = w;
  a.xsegs = (w + kConvN - 1) / kConvN;
  a.ck = (ci_row + kConvK - 1) / kConvK;
  const long tiles = (long)((co + kConvM - 1) / kConvM) * batch * h * a.xsegs;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  constexpr size_t smem = sizeof(ConvSmem) + 1024;
  err = (int)cudaFuncSetAttribute(conv3x3_chw_sm90_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const int blocks = std::min(a.tiles, sm_count());
  conv3x3_chw_sm90_kernel<<<blocks, kConvBlockThreads, smem, stream>>>(x_map, w_map, a);
  return (int)cudaGetLastError();
}

}  // namespace mmdiff

// The Hopper kernel.  x_halo [B, H + 2, W + 2, ci_row] bf16: the input
// channels-last with a one-pixel zero ring and its channels zero-padded to
// ci_row (ci_row % 8 == 0, 16-byte aligned); w_taps [Co, 9, ci_row] bf16,
// the weights in tap-major K order (w_taps[co, 3 dy + dx, ci] =
// w[co, ci, dy, dx], zero past Ci); out [B, Co, H, W] bf16, contiguous.
// Returns the first CUDA error of the tensor maps' encoding or the launch
// (0 on success).
extern "C" int mmdiff_conv3x3_chw(const void* x_halo, const void* w_taps, void* out, int batch,
                                  int ci_row, int co, int h, int w, void* stream) {
  return mmdiff::conv3x3_chw_sm90(x_halo, w_taps, out, batch, ci_row, co, h, w,
                                  static_cast<cudaStream_t>(stream));
}

// x [B, Ci, H, W] -> x_halo [B, H + 2, W + 2, ci_row] (ci_row % 8 == 0,
// ci <= ci_row), both bf16 and contiguous.  Returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int mmdiff_channels_last_halo(const void* x, void* x_halo, int batch, int ci,
                                         int ci_row, int h, int w, void* stream) {
  using namespace mmdiff;
  const long blocks = (long)batch * ((ci_row + kHaloTile - 1) / kHaloTile) * (h + 2) *
                      ((w + 2 + kHaloTile - 1) / kHaloTile);
  if (ci_row % 8 || ci > ci_row || std::min({batch, ci, h, w}) < 1 || blocks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  channels_last_halo_kernel<<<(int)blocks, kHaloThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(x), static_cast<unsigned short*>(x_halo), ci, ci_row, h,
      w);
  return (int)cudaGetLastError();
}
