// Backward of RS-MMA banded cross-attention over packed qkv (the forward is
// banded_attention.cu): query frame f of q_src attended to the kv frames
// g = (f + shift + j) % F, j < lw, of kv_src under one joint softmax.
//   (q_src [N, F, Tq, 3C], kv_src [N, F, Tk, 3C], out [N, F, Tq, C],
//    dout [N, F, Tq, C], lse [N, F, H, Tq])
//   -> dq_src [N, F, Tq, 3C]  (dq in lanes [0, C), zeros elsewhere)
//      dkv_src [N, F, Tk, 3C] (dk in [C, 2C), dv in [2C, 3C), zeros in [0, C))
//
// Replaces both TPU backward kernels of mm_diffusion_tpu/ops/block_attention.py:
// `_banded_bwd_lw1_kernel` (:792, lw == 1, launched by `_banded_bwd_lw1_pallas`)
// and `_banded_bwd_oneshot_kernel` (:877, lw > 1, launched by
// `_banded_bwd_oneshot_pallas`, which emits lw dkv partials that the caller
// sums).  One kernel pair serves every window.
//
// What bounds it on this card: bytes, at every training shape (the packed
// sources, out, dout and lse read once, both packed gradients written whole,
// zeros included).  A (frame, head) pair is small -- Tq x lw Tk of 1024 x 400
// down to 25 x 8 * 64 at head dim 64 -- so what keeps a kernel from that
// bound is how full its tiles are, how many blocks are in flight and whether
// a copy is in flight while the products run.
//
// The design (bf16; the machinery and the tile products of attention_sm90.cuh,
// shared with the self-attention backward), two passes, deterministic (every
// gradient row summed in registers by the one block that owns it, no float
// atomics, no lw partial outputs):
//   dq pass   a work item is 64 query rows: their Q and dO tiles come once
//             by TMA, a producer warp streams 64-row K and V tiles of kv_src
//             through a ring of 2-4 stages.  The consumer warpgroup first
//             writes delta = rowsum(dO * O) for the dkv pass, then per tile,
//             on wgmma, S = Q K^T, dP = dO V^T, P and dS on the accumulators,
//             dQ += dS K (dS from registers, K read MN-major);
//   dkv pass  a work item is 64 keys: their K and V tiles stay in shared
//             memory, the producer streams Q and dO tiles of q_src with each
//             query row's lse and delta, loaded one tile ahead:
//             dV += P^T dO, dK += dS^T Q.
// The window as at most two contiguous row ranges of the clip, streamed in
// 64-row TMA boxes that cross frames, and frames of T <= 32 packed per tile
// (banded_sm90.cuh, shared with the forward).  A one-frame tile is masked
// only past its range's end: keys by index in the dq pass, queries by a
// +inf lse in the dkv pass.  The zero lanes of both packed gradients are
// written by the same blocks: no zero-fill pass, no extra launch.  lw = 1 is
// the same kernel with a one-frame window.
// fp32 inputs run the mma.sync design (attention_bwd_common.cuh:
// per-frame loops over 32-row tiles staged through registers).
//
// Grids: both passes are persistent, as many blocks of 160 threads (one
// consumer warpgroup and the producer warp) as fit on the card, each walking
// the pass's work items (head, own tile) with its own tiles double-buffered,
// so that one item's stores overlap the next item's copies.  The dq pass
// writes delta, which the dkv pass reads, so the two run in this order on
// the caller's stream.  Previous design: (N * F, H, ceil(T / 64)), 128
// threads.

#include "attention_bwd_common.cuh"
#include "banded_sm90.cuh"

namespace mmdiff {

// ---------------------------------------------------------------------------
// The Hopper kernels (bf16)
// ---------------------------------------------------------------------------

// The pointers and scales of one call beside its window (banded_sm90.cuh).
struct BandedArgs : BandedWindow {
  const bf16* out;
  const bf16* dout;
  const float* lse;
  float* delta;
  bf16* dq_src;
  bf16* dkv_src;
  float scale_log2, scale;
};

// Both kernels are persistent: a block walks the work items w = blockIdx.x,
// w + gridDim.x, ... with its own tiles double-buffered, so that the next
// item's own tile and first streamed boxes arrive while it finishes the last
// one's products and stores.
template <int DK, int S = stages_for(DK)>
struct BandedDqSmem {
  static constexpr int kStages = S;
  uint8_t q[2][sm90::Tile<DK>::kBytes];  // the own tiles of two items in turn
  uint8_t go[2][sm90::Tile<DK>::kBytes];
  uint8_t k[S][sm90::Tile<DK>::kBytes];
  uint8_t v[S][sm90::Tile<DK>::kBytes];
  int kframe[S][sm90::kRows];  // each streamed key row's frame (kNoFrame: none)
  uint64_t own_full[2], own_empty[2], full[S], empty[S];
};

// The dq pass: each item's 64 query rows against the key rows of their windows.
template <int DK>
__global__ void __launch_bounds__(sm90::kWarpgroup + sm90::kProducerThreads, 1)
    banded_attention_bwd_dq_sm90(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap kv_map,
                                 const __grid_constant__ CUtensorMap dout_map, const BandedArgs a) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  BandedDqSmem<DK>& sm = aligned_smem<BandedDqSmem<DK>>(smem_raw);
  constexpr int kTileBytes = Tile<DK>::kBytes, kStages = BandedDqSmem<DK>::kStages;
  const int items = work_items(a, true);

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&sm.own_full[b], 1);
      mbar_init(&sm.own_empty[b], kWarpgroup);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], kProducerThreads + 1);  // lane 0 arrives twice
      mbar_init(&sm.empty[s], kWarpgroup);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWarpgroup) {  // producer warp: every lane stages key frames, one the tiles
    const int lane = threadIdx.x - kWarpgroup;
    int g = 0;  // boxes streamed so far: the ring's position
    for (int w = blockIdx.x, it = 0; w < items; w += gridDim.x, ++it) {
      const Work wk(a, w, true);
      const int b = it & 1;
      if (lane == 0) {
        mbar_wait(&sm.own_empty[b], ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(&sm.own_full[b], 2 * kTileBytes);
        load_tile<DK>(sm.q[b], &q_map, &sm.own_full[b], 0, wk.h, 0, (int)wk.tile.row0);
        load_tile<DK>(sm.go[b], &dout_map, &sm.own_full[b], 0, wk.h, 0, (int)wk.tile.row0);
      }
      const long kv_clip = (long)wk.tile.n * a.frames * a.tk;
      for (int j = 0; j < wk.st.boxes(); ++j, ++g) {
        const int s = g % kStages;
        int row, left;
        wk.st.box(j, row, left);
        mbar_wait(&sm.empty[s], ((g / kStages) & 1) ^ 1);
        if (lane == 0) {  // the copies first, so that they overlap the staging
          mbar_expect_tx(&sm.full[s], 2 * kTileBytes);
          load_tile<DK>(sm.k[s], &kv_map, &sm.full[s], 1, wk.h, 0, (int)(kv_clip + row));
          load_tile<DK>(sm.v[s], &kv_map, &sm.full[s], 2, wk.h, 0, (int)(kv_clip + row));
        }
        if (wk.tile.frames > 1) {  // packed frames: the consumers test each pair by frame
#pragma unroll
          for (int i = lane; i < kRows; i += 32)
            sm.kframe[s][i] = i < left ? (row + i) / a.tk : kNoFrame;
        }
        mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }

  int rows[2];
  thread_rows(rows, 0);
  const int t = threadIdx.x & 3;
  const int c = a.heads * a.dim;
  const long c3 = 3L * c;
  int g = 0;
  for (int w = blockIdx.x, it = 0; w < items; w += gridDim.x, ++it) {
    const Work wk(a, w, true);
    const OwnTile& tile = wk.tile;
    const int h = wk.h, b = it & 1;
    // This thread's two query rows: real or not, frame, logsumexp (base 2)
    // and delta = rowsum(dO * O), written to a.delta for the dkv pass.
    bool ok[2];
    int fq[2];
    long row[2];
    float lse2[2], delta[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ok[r] = rows[r] < tile.valid;
      fq[r] = ok[r] ? tile.frame(rows[r], a.tq) : kNoFrame;
      row[r] = tile.row0 + rows[r];
    }
#pragma unroll
    for (int col = 8 * t; col < DK; col += 32) {  // 16-byte loads of both rows, then the sums
      uint4 o[2], d[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool in = ok[r] && col < a.dim;
        const long off = row[r] * c + (long)h * a.dim + col;
        o[r] = in ? *reinterpret_cast<const uint4*>(a.out + off) : make_uint4(0, 0, 0, 0);
        d[r] = in ? *reinterpret_cast<const uint4*>(a.dout + off) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const __nv_bfloat162* po = reinterpret_cast<const __nv_bfloat162*>(&o[r]);
        const __nv_bfloat162* pd = reinterpret_cast<const __nv_bfloat162*>(&d[r]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(po[e]), y = __bfloat1622float2(pd[e]);
          delta[r] += x.x * y.x + x.y * y.y;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
      lse2[r] = 0.f;
      if (ok[r]) {
        const long nf = row[r] / a.tq;  // frame of the whole tensor
        const long idx = (nf * a.heads + h) * a.tq + (row[r] - nf * a.tq);
        lse2[r] = a.lse[idx] * kLog2e;
        if (t == 0) a.delta[idx] = delta[r];
      }
    }

    float dq[DK / 2];
    zero<DK>(dq);
    mbar_wait(&sm.own_full[b], (it >> 1) & 1);
    for (int j = 0; j < wk.st.boxes(); ++j, ++g) {
      const int s = g % kStages;
      int row_j, left;
      wk.st.box(j, row_j, left);
      mbar_wait(&sm.full[s], (g / kStages) & 1);
      if (tile.frames > 1) {  // packed frames: the window test per pair
        const int* kf = sm.kframe[s];
        dq_products<DK>(dq, sm.q[b], sm.go[b], sm.k[s], sm.v[s], lse2, delta, a.scale_log2,
                        a.scale, [&](int key, int r) { return in_window(a, kf[key], fq[r]); });
      } else if (left >= kRows) {  // one frame, a full box: every key meets every row
        dq_products<DK>(dq, sm.q[b], sm.go[b], sm.k[s], sm.v[s], lse2, delta, a.scale_log2,
                        a.scale, [](int, int) { return true; });
      } else {  // one frame, the range's last box: the keys before its end
        dq_products<DK>(dq, sm.q[b], sm.go[b], sm.k[s], sm.v[s], lse2, delta, a.scale_log2,
                        a.scale, [&](int key, int) { return key < left; });
      }
      mbar_arrive(&sm.empty[s]);
    }
    mbar_arrive(&sm.own_empty[b]);
    bf16* row0 = a.dq_src + row[0] * c3 + (long)h * a.dim;
    bf16* row1 = row0 + 8 * c3;
    store_acc<DK>(dq, row0, row1, ok[0], ok[1], 1.f, 1.f, a.dim);
    zero<DK>(dq);  // the k and v lanes of dq_src
    store_acc<DK>(dq, row0 + c, row1 + c, ok[0], ok[1], 1.f, 1.f, a.dim);
    store_acc<DK>(dq, row0 + 2 * c, row1 + 2 * c, ok[0], ok[1], 1.f, 1.f, a.dim);
  }
}

template <int DK, int S = stages_for(DK)>
struct BandedDkvSmem {
  static constexpr int kStages = S;
  uint8_t k[2][sm90::Tile<DK>::kBytes];  // the own tiles of two items in turn
  uint8_t v[2][sm90::Tile<DK>::kBytes];
  uint8_t q[S][sm90::Tile<DK>::kBytes];
  uint8_t go[S][sm90::Tile<DK>::kBytes];
  float lse2[S][sm90::kRows];  // each streamed query row's logsumexp, base 2 (+inf: none)
  float delta[S][sm90::kRows];
  int qframe[S][sm90::kRows];  // and its frame (kNoFrame: none)
  uint64_t own_full[2], own_empty[2], full[S], empty[S];
};

// The dkv pass: each item's 64 keys against the query rows whose windows hold them.
template <int DK>
__global__ void __launch_bounds__(sm90::kWarpgroup + sm90::kProducerThreads, 1)
    banded_attention_bwd_dkv_sm90(const __grid_constant__ CUtensorMap q_map,
                                  const __grid_constant__ CUtensorMap kv_map,
                                  const __grid_constant__ CUtensorMap dout_map,
                                  const BandedArgs a) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  BandedDkvSmem<DK>& sm = aligned_smem<BandedDkvSmem<DK>>(smem_raw);
  constexpr int kTileBytes = Tile<DK>::kBytes, kStages = BandedDkvSmem<DK>::kStages;
  const int items = work_items(a, false);

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&sm.own_full[b], 1);
      mbar_init(&sm.own_empty[b], kWarpgroup);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], kProducerThreads + 1);  // lane 0 arrives twice
      mbar_init(&sm.empty[s], kWarpgroup);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWarpgroup) {  // producer warp: every lane stages row stats, one the tiles
    const int lane = threadIdx.x - kWarpgroup;
    // Each lane stages rows lane and lane + 32 of every box: their lse,
    // delta and frame, loaded one box ahead so that the loads are in flight
    // while the producer waits for the next free stage.
    float lse[2], dl[2];
    int fr[2];
    auto fetch = [&](const Work& wk, int j) {
      int row, left;
      wk.st.box(j, row, left);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = lane + 32 * r;
        const int f = i < left ? (row + i) / a.tq : 0;  // frame within the clip
        const long nf = (long)wk.tile.n * a.frames + f;
        const long idx = i < left ? (nf * a.heads + wk.h) * a.tq + (row + i - f * a.tq) : 0;
        lse[r] = a.lse[idx];  // used only where fr[r] is a frame
        dl[r] = a.delta[idx];
        fr[r] = i < left ? f : kNoFrame;
      }
    };
    int g = 0;  // boxes streamed so far: the ring's position
    for (int w = blockIdx.x, it = 0; w < items; w += gridDim.x, ++it) {
      const Work wk(a, w, false);
      const int b = it & 1;
      if (lane == 0) {
        mbar_wait(&sm.own_empty[b], ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(&sm.own_full[b], 2 * kTileBytes);
        load_tile<DK>(sm.k[b], &kv_map, &sm.own_full[b], 1, wk.h, 0, (int)wk.tile.row0);
        load_tile<DK>(sm.v[b], &kv_map, &sm.own_full[b], 2, wk.h, 0, (int)wk.tile.row0);
      }
      const long q_clip = (long)wk.tile.n * a.frames * a.tq;
      fetch(wk, 0);
      for (int j = 0; j < wk.st.boxes(); ++j, ++g) {
        const int s = g % kStages;
        int row, left;
        wk.st.box(j, row, left);
        mbar_wait(&sm.empty[s], ((g / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&sm.full[s], 2 * kTileBytes);
          load_tile<DK>(sm.q[s], &q_map, &sm.full[s], 0, wk.h, 0, (int)(q_clip + row));
          load_tile<DK>(sm.go[s], &dout_map, &sm.full[s], 0, wk.h, 0, (int)(q_clip + row));
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bool real = fr[r] != kNoFrame;
          sm.lse2[s][lane + 32 * r] = real ? lse[r] * kLog2e : INFINITY;
          sm.delta[s][lane + 32 * r] = real ? dl[r] : 0.f;
          sm.qframe[s][lane + 32 * r] = fr[r];
        }
        mbar_arrive(&sm.full[s]);
        if (j + 1 < wk.st.boxes()) fetch(wk, j + 1);
      }
    }
    return;
  }

  int kr[2];
  thread_rows(kr, 0);
  const int c = a.heads * a.dim;
  const long c3 = 3L * c;
  int g = 0;
  for (int w = blockIdx.x, it = 0; w < items; w += gridDim.x, ++it) {
    const Work wk(a, w, false);
    const OwnTile& tile = wk.tile;
    const int h = wk.h, b = it & 1;
    const bool ok[2] = {kr[0] < tile.valid, kr[1] < tile.valid};
    const int gk[2] = {ok[0] ? tile.frame(kr[0], a.tk) : kNoFrame,
                       ok[1] ? tile.frame(kr[1], a.tk) : kNoFrame};
    float dk[DK / 2], dv[DK / 2];
    zero<DK>(dk);
    zero<DK>(dv);
    mbar_wait(&sm.own_full[b], (it >> 1) & 1);
    for (int j = 0; j < wk.st.boxes(); ++j, ++g) {
      const int s = g % kStages;
      mbar_wait(&sm.full[s], (g / kStages) & 1);
      if (tile.frames > 1) {  // packed frames: the window test per pair
        const int* qf = sm.qframe[s];
        dkv_products<DK>(dk, dv, sm.k[b], sm.v[b], sm.q[s], sm.go[s], sm.lse2[s], sm.delta[s],
                         a.scale_log2, a.scale,
                         [&](int x, int r) { return in_window(a, gk[r], qf[x]); });
      } else {  // one frame: every streamed query meets every key (+inf lse past the range)
        dkv_products<DK>(dk, dv, sm.k[b], sm.v[b], sm.q[s], sm.go[s], sm.lse2[s], sm.delta[s],
                         a.scale_log2, a.scale, [](int, int) { return true; });
      }
      mbar_arrive(&sm.empty[s]);
    }
    mbar_arrive(&sm.own_empty[b]);
    bf16* row0 = a.dkv_src + (tile.row0 + kr[0]) * c3 + (long)h * a.dim;
    bf16* row1 = row0 + 8 * c3;
    store_acc<DK>(dk, row0 + c, row1 + c, ok[0], ok[1], 1.f, 1.f, a.dim);
    store_acc<DK>(dv, row0 + 2 * c, row1 + 2 * c, ok[0], ok[1], 1.f, 1.f, a.dim);
    zero<DK>(dk);  // the q lanes of dkv_src
    store_acc<DK>(dk, row0, row1, ok[0], ok[1], 1.f, 1.f, a.dim);
  }
}

template <int DK>
static int launch_sm90(const CUtensorMap& q_map, const CUtensorMap& kv_map,
                       const CUtensorMap& dout_map, const BandedArgs& a, cudaStream_t stream) {
  int err = launch_persistent(banded_attention_bwd_dq_sm90<DK>, sizeof(BandedDqSmem<DK>) + 1024,
                              work_items(a, true), stream, q_map, kv_map, dout_map, a);
  if (err) return err;
  return launch_persistent(banded_attention_bwd_dkv_sm90<DK>, sizeof(BandedDkvSmem<DK>) + 1024,
                           work_items(a, false), stream, q_map, kv_map, dout_map, a);
}

static int dispatch_sm90(const void* q_src, const void* kv_src, const void* out, const void* dout,
                         const float* lse, float* delta, void* dq_src, void* dkv_src, int n,
                         int frames, int tq, int tk, int heads, int dim, int kernel_dim,
                         float scale, int shift, int window, cudaStream_t stream) {
  const int c = heads * dim;
  const long q_rows = (long)n * frames * tq, kv_rows = (long)n * frames * tk;
  CUtensorMap q_map, kv_map, dout_map;
  int err = encode_qkv_map(&q_map, q_src, q_rows, heads, dim, dim, c);
  if (!err) err = encode_qkv_map(&kv_map, kv_src, kv_rows, heads, dim, dim, c);
  if (!err) err = encode_map(&dout_map, dout, dim, heads, dim, 1, c, q_rows, c);
  if (err) return err;
  BandedArgs a;
  static_cast<BandedWindow&>(a) = banded_window(n, frames, tq, tk, heads, dim, shift, window);
  a.out = static_cast<const bf16*>(out);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = lse;
  a.delta = delta;
  a.dq_src = static_cast<bf16*>(dq_src);
  a.dkv_src = static_cast<bf16*>(dkv_src);
  a.scale = scale;
  a.scale_log2 = kLog2e * scale;
  switch (kernel_dim) {
    case 32: return launch_sm90<32>(q_map, kv_map, dout_map, a, stream);
    case 64: return launch_sm90<64>(q_map, kv_map, dout_map, a, stream);
    case 96: return launch_sm90<96>(q_map, kv_map, dout_map, a, stream);
    case 128: return launch_sm90<128>(q_map, kv_map, dout_map, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The mma.sync design (fp32 inputs)
// ---------------------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    banded_attention_bwd_dq_kernel(const T* __restrict__ q_src, const T* __restrict__ kv_src,
                                   const T* __restrict__ out, const T* __restrict__ dout,
                                   const float* __restrict__ lse, float* __restrict__ delta,
                                   T* __restrict__ dq_src, int frames, int tq, int tk, int heads,
                                   int dim, int shift, int window, float scale_log2, float scale) {
  __shared__ __align__(16) unsigned short sk[kBwdTile * (D + kPadK)];
  __shared__ __align__(16) unsigned short sv[kBwdTile * (D + kPadK)];
  const int nf = blockIdx.x, h = blockIdx.y;
  const int n = nf / frames, f = nf - n * frames;
  const int c = heads * dim;
  const long stride = 3L * c;
  const long q_off = (long)nf * tq * stride + (long)h * dim;
  const long o_off = (long)nf * tq * c + (long)h * dim;
  const long row_off = ((long)nf * heads + h) * tq;
  const int row0 = blockIdx.z * kBlockQ + (threadIdx.x >> 5) * 16;

  DqState<D> st;
  dq_begin<D, T>(st, q_src + q_off, stride, out + o_off, dout + o_off, c, lse + row_off,
                 delta + row_off, row0, tq, dim);
  for (int j = 0; j < window; ++j) {
    const int g = (f + shift + j) % frames;
    const T* k = kv_src + ((long)n * frames + g) * tk * stride + c + (long)h * dim;
    dq_sequence<D, T>(st, sk, sv, k, k + c, stride, tk, dim, scale_log2, scale);
  }
  store_frags<D, T>(st.dq, dq_src + q_off, stride, row0, tq, dim);
  zero_rows<D, T>(dq_src + q_off + c, stride, row0, tq, dim);
  zero_rows<D, T>(dq_src + q_off + 2 * c, stride, row0, tq, dim);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    banded_attention_bwd_dkv_kernel(const T* __restrict__ q_src, const T* __restrict__ kv_src,
                                    const T* __restrict__ dout, const float* __restrict__ lse,
                                    const float* __restrict__ delta, T* __restrict__ dkv_src,
                                    int frames, int tq, int tk, int heads, int dim, int shift,
                                    int window, float scale_log2, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DkvSmem<D> sm(smem);
  const int ng = blockIdx.x, h = blockIdx.y;
  const int n = ng / frames, g = ng - n * frames;
  const int c = heads * dim;
  const long stride = 3L * c;
  const long kv_off = (long)ng * tk * stride + (long)h * dim;
  const int key0 = blockIdx.z * kBwdKeys;
  const int keys = min(kBwdKeys, tk - key0);

  stage_rows<D, T>(sm.k, kv_src + kv_off + c + key0 * stride, stride, keys, kBwdKeys, dim);
  stage_rows<D, T>(sm.v, kv_src + kv_off + 2 * c + key0 * stride, stride, keys, kBwdKeys, dim);
  DkvState<D> st;
  zero_acc<D>(st.dk);
  zero_acc<D>(st.dv);
  for (int j = 0; j < window; ++j) {
    const int f = ((g - shift - j) % frames + frames) % frames;
    const long nf = (long)n * frames + f;
    const long row_off = (nf * heads + h) * tq;
    dkv_sequence<D, T>(st, sm, q_src + nf * tq * stride + (long)h * dim, stride,
                       dout + nf * tq * c + (long)h * dim, c, lse + row_off, delta + row_off, tq,
                       dim, scale_log2, scale);
  }
  const int row0 = key0 + (threadIdx.x >> 5) * 16;
  store_frags<D, T>(st.dk, dkv_src + kv_off + c, stride, row0, tk, dim);
  store_frags<D, T>(st.dv, dkv_src + kv_off + 2 * c, stride, row0, tk, dim);
  zero_rows<D, T>(dkv_src + kv_off, stride, row0, tk, dim);
}

template <int D, typename T>
static int launch(const void* q_src, const void* kv_src, const void* out, const void* dout,
                  const float* lse, float* delta, void* dq_src, void* dkv_src, int n, int frames,
                  int tq, int tk, int heads, int dim, float scale, int shift, int window,
                  cudaStream_t stream) {
  const float scale_log2 = kLog2e * scale;
  const T* q = static_cast<const T*>(q_src);
  const T* kv = static_cast<const T*>(kv_src);
  const T* go = static_cast<const T*>(dout);

  const dim3 grid_q(n * frames, heads, (tq + kBlockQ - 1) / kBlockQ);
  banded_attention_bwd_dq_kernel<D, T><<<grid_q, kThreads, 0, stream>>>(
      q, kv, static_cast<const T*>(out), go, lse, delta, static_cast<T*>(dq_src), frames, tq, tk,
      heads, dim, shift, window, scale_log2, scale);
  int err = (int)cudaGetLastError();
  if (err) return err;

  const size_t smem = DkvSmem<D>::bytes();
  err = set_dynamic_smem(banded_attention_bwd_dkv_kernel<D, T>, smem);
  if (err) return err;
  const dim3 grid_kv(n * frames, heads, (tk + kBwdKeys - 1) / kBwdKeys);
  banded_attention_bwd_dkv_kernel<D, T><<<grid_kv, kThreads, smem, stream>>>(
      q, kv, go, lse, delta, static_cast<T*>(dkv_src), frames, tq, tk, heads, dim, shift, window,
      scale_log2, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* q_src, const void* kv_src, const void* out, const void* dout,
                    const float* lse, float* delta, void* dq_src, void* dkv_src, int n,
                    int frames, int tq, int tk, int heads, int head_dim, int kernel_dim,
                    float scale, int shift, int window, cudaStream_t stream) {
#define MMDIFF_LAUNCH(D)                                                                     \
  return launch<D, T>(q_src, kv_src, out, dout, lse, delta, dq_src, dkv_src, n, frames, tq, \
                      tk, heads, head_dim, scale, shift, window, stream);
  switch (kernel_dim) {
    case 32: MMDIFF_LAUNCH(32)
    case 64: MMDIFF_LAUNCH(64)
    case 96: MMDIFF_LAUNCH(96)
    case 128: MMDIFF_LAUNCH(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef MMDIFF_LAUNCH
}

}  // namespace mmdiff

static bool head_dim_fits(int head_dim, int kernel_dim) {
  return head_dim % 8 == 0 && head_dim >= 8 && head_dim <= kernel_dim;
}

// `shift` must lie in [0, frames) and 1 <= window <= frames (checked by the
// Python wrapper); lse is the forward's [N, F, H, Tq] logsumexp and delta a
// scratch of the same shape; `head_dim` runs on the kernels built for
// `kernel_dim`, with the logit scale `scale` (1/sqrt(d) of the caller's real
// head dim d, which may be below a zero-padded `head_dim`).  bf16 takes the Hopper kernels (q_src, kv_src and dout
// 16-byte aligned), fp32 the mma.sync design.  Every element of dq_src and
// dkv_src is written.  Returns the first failing launch's CUDA error (0 on
// success).
extern "C" int mmdiff_banded_attention_bwd(const void* q_src, const void* kv_src, const void* out,
                                           const void* dout, const float* lse, float* delta,
                                           void* dq_src, void* dkv_src, int n, int frames,
                                           int tq, int tk, int heads, int head_dim,
                                           int kernel_dim, float scale, int shift, int window,
                                           int is_fp32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!head_dim_fits(head_dim, kernel_dim)) return (int)cudaErrorInvalidValue;
  if (is_fp32)
    return mmdiff::dispatch<float>(q_src, kv_src, out, dout, lse, delta, dq_src, dkv_src, n,
                                   frames, tq, tk, heads, head_dim, kernel_dim, scale, shift, window,
                                   s);
  return mmdiff::dispatch_sm90(q_src, kv_src, out, dout, lse, delta, dq_src, dkv_src, n, frames,
                               tq, tk, heads, head_dim, kernel_dim, scale, shift, window, s);
}

// Frames per 64-row tile that the Hopper kernels pack for a [N, F, T] side
// with `heads` heads on this device (1 unless T <= 32): what
// mmdiff_banded_attention_bwd chooses for the queries (T = Tq) and the keys
// (T = Tk).
extern "C" int mmdiff_banded_attention_bwd_frames_per_tile(int n, int frames, int len, int heads) {
  return mmdiff::frames_per_tile(n, frames, len, heads);
}
