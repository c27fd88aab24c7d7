// 3x3 SAME convolution in channel-major layout, as a direct implicit GEMM:
//   out[b, co, y, x] = sum_{ci, dy, dx} w[co, ci, dy, dx] . x[b, ci, y + dy - 1, x + dx - 1]
// (zero outside the image), i.e. per image out_T[Co, px] = W'[Co, 9 Ci] .
// im2col[9 Ci, px]; bf16 in, fp32 accumulation, bf16 out.
//
// Replaces the TPU spike kernel `_kernel` of tools/conv_chw_spike.py (:69,
// `pallas_call` in `conv3x3_chw` :142), which builds the im2col tile of a
// block of rows in VMEM scratch (row shifts as lane slices of a haloed
// concat, column shifts as lane rolls) and runs one [Co, 9 Ci] x [9 Ci, TH*W]
// product per block.
//
// What bounds it on this card: at the SR U-Net's 16 x 192 x 256^2 -> 192 the
// conv is 696 GFLOP against 0.4 GB of activations in and out, so the tensor
// cores bound it (0.70 ms at 989 TFLOP/s).  The im2col matrix never reaches
// device memory: each block stages, per chunk of 16 input channels, the
// three input rows its output row segment needs plus a one-pixel halo on
// each side ([16 ch][3 rows][130 px]) and the chunk's weights for all nine
// taps ([9][64 co][16 ch], read straight from w[Co, Ci, 3, 3]); the B
// operand of tap (dy, dx) is then that halo tile read at a row offset dy and
// a column offset dx, so each staged input element serves nine taps.  The
// products are mma.sync m16n8k16 bf16 with fp32 accumulation.  Speed
// (wgmma, TMA, pipelined staging, weights kept across blocks) is later work.
//
// Tiles: 64 output channels x 128 pixels of one output row per block, 4 warps
// of 32 x 64.  Grid: (ceil(W / 128) * H, ceil(Co / 64), B).  Any Ci, Co, H, W.

#include "attention_bwd_common.cuh"

namespace mmdiff {

constexpr int kConvBM = 64;    // output channels per block
constexpr int kConvBN = 128;   // output pixels (one row segment) per block
constexpr int kConvBK = 16;    // input channels per staged chunk
constexpr int kConvThreads = 128;
constexpr int kHaloW = kConvBN + 2;
constexpr int kHaloLd = kConvBN + 8;        // bf16 elements per staged input row
constexpr int kHaloChLd = 3 * kHaloLd;      // per input channel: three rows
constexpr int kWLd = kConvBK + 8;           // bf16 elements per staged weight row

__global__ void __launch_bounds__(kConvThreads)
    conv3x3_chw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       bf16* __restrict__ out, int ci_n, int co_n, int h, int w_px) {
  __shared__ __align__(16) unsigned short halo[kConvBK * kHaloChLd];
  __shared__ __align__(16) unsigned short wt[9 * kConvBM * kWLd];
  const int wtiles = (w_px + kConvBN - 1) / kConvBN;
  const int y = blockIdx.x / wtiles, x0 = (blockIdx.x % wtiles) * kConvBN;
  const int co0 = blockIdx.y * kConvBM, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x) + (long)b * ci_n * h * w_px;
  const unsigned short* ws = reinterpret_cast<const unsigned short*>(w);

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }

  for (int ci0 = 0; ci0 < ci_n; ci0 += kConvBK) {
    // Input rows y-1, y, y+1 of channels [ci0, ci0 + 16), pixels x0-1 .. x0+128.
    for (int idx = threadIdx.x; idx < kConvBK * 3 * kHaloW; idx += kConvThreads) {
      const int c = idx / (3 * kHaloW), rem = idx % (3 * kHaloW);
      const int dy = rem / kHaloW, j = rem % kHaloW;
      const int ci = ci0 + c, yy = y + dy - 1, xx = x0 - 1 + j;
      unsigned short v = 0;
      if (ci < ci_n && yy >= 0 && yy < h && xx >= 0 && xx < w_px)
        v = xs[((long)ci * h + yy) * w_px + xx];
      halo[c * kHaloChLd + dy * kHaloLd + j] = v;
    }
    // Weights w[co0 .. co0 + 64, ci0 .. ci0 + 16, 3, 3] (144 contiguous
    // elements per output channel) as wt[tap][co][ci].
    for (int idx = threadIdx.x; idx < kConvBM * kConvBK * 9; idx += kConvThreads) {
      const int co_l = idx / (kConvBK * 9), rem = idx % (kConvBK * 9);
      const int c = rem / 9, tap = rem % 9;
      const int co = co0 + co_l, ci = ci0 + c;
      unsigned short v = 0;
      if (co < co_n && ci < ci_n) v = ws[((long)co * ci_n + ci) * 9 + tap];
      wt[(tap * kConvBM + co_l) * kWLd + c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) lds_a(af[i], wt + tap * kConvBM * kWLd, kWLd, wm + i * 16, 0);
      // B[k = ci][n = px] of this tap: the halo tile at row dy, column px + dx.
      const unsigned short* bt = halo + dy * kHaloLd + dx;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b0, b1;
        lds_b_cols(b0, b1, bt, kHaloChLd, 0, wn + j * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_16816(acc[i][j], af[i], b0, b1);
      }
    }
    __syncthreads();
  }

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int co = co0 + wm + i * 16 + g + 8 * half;
      if (co >= co_n) continue;
      bf16* row = out + (((long)b * co_n + co) * h + y) * w_px;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int xx = x0 + wn + j * 8 + 2 * t;
        if (xx < w_px) row[xx] = __float2bfloat16_rn(acc[i][j][2 * half]);
        if (xx + 1 < w_px) row[xx + 1] = __float2bfloat16_rn(acc[i][j][2 * half + 1]);
      }
    }
  }
}

}  // namespace mmdiff

// x [B, Ci, H, W], w [Co, Ci, 3, 3], out [B, Co, H, W], all contiguous bf16.
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int mmdiff_conv3x3_chw(const void* x, const void* w, void* out, int batch, int ci,
                                  int co, int h, int w_px, void* stream) {
  using mmdiff::bf16;
  const int wtiles = (w_px + mmdiff::kConvBN - 1) / mmdiff::kConvBN;
  const dim3 grid(wtiles * h, (co + mmdiff::kConvBM - 1) / mmdiff::kConvBM, batch);
  mmdiff::conv3x3_chw_kernel<<<grid, mmdiff::kConvThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(out), ci, co, h,
      w_px);
  return (int)cudaGetLastError();
}
