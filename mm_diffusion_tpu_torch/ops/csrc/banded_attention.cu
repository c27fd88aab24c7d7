// RS-MMA banded cross-attention over the packed qkv of two modalities:
//   q_src  [N, F, Tq, 3C]  (this modality; q = lanes [0, C))
//   kv_src [N, F, Tk, 3C]  (other modality; k = lanes [C, 2C), v = [2C, 3C))
// Query frame f attends to the kv frames (f + shift + j) % F, j < lw, under
// one joint softmax over lw * Tk keys.  Output [N, F, Tq, C], plus the
// per-row logsumexp [N, F, H, Tq] (fp32) that the backward
// (banded_attention_bwd.cu) reuses.
//
// Replaces both TPU kernels that compute this function in
// mm_diffusion_tpu/ops/block_attention.py: `_banded_oneshot_kernel` (:609,
// lw > 1, launched by `_banded_oneshot_pallas`) and `_banded_fwd_kernel`
// (:534, lw == 1 and the streamed online-softmax form, launched by
// `_banded_fwd_pallas`).  One kernel serves every window, lw == 1 included.
//
// What bounds it on this card: bytes, at every flagship shape (the q lanes
// of q_src and the k|v lanes of kv_src read once, out and lse written once):
// a (frame, head) pair is small -- Tq x lw Tk of 1024 x 400 down to 25 x
// 16 * 64 at head dim 64 -- so what keeps the kernel from that bound is how
// full its tiles are, how many blocks are in flight, and whether a copy is
// in flight while the products run.
//
// The design (bf16; the machinery of attention_sm90.cuh and the window
// tiling of banded_sm90.cuh, both shared with the backward): a work item is
// 64 query rows of one head -- one frame's, or at Tq <= 32 several whole
// frames of one clip packed into the tile -- whose Q tile TMA brings once;
// a producer warp streams the 64-row K and V boxes of the tile's window
// range(s) (one, or two where the window wraps past frame F - 1; boxes may
// cross frames) through a ring of 2-3 stages; the consumer warpgroup
// computes S = Q K^T on wgmma (Q and K K-major in shared memory), the online
// softmax in fp32 on the accumulators (base 2, scale folded in), and
// O += P V with P packed to bf16 in registers and V read MN-major, then
// writes the tile's out (bf16) and lse (fp32).  Masks: a one-frame tile
// meets every key of its range, so only the keys past the range's end (the
// next frame's, the next clip's, or TMA's zero fill past the tensor) are
// masked, by index, and only in the range's last box; a packed tile tests
// each (query frame, key frame) pair with in_window.  Query rows past the
// tile's real rows are never stored.  Blocks are persistent, three per SM
// at head dims up to 64, each walking the (head, query tile) items with its
// Q tile double-buffered, so that one item's stores overlap the next item's
// copies.  Measured and left out (PERF.md, PR 6): two consumer warpgroups
// sharing each K/V box (half the boxes streamed per query row; 8-25%
// slower), and box j + 1's S = Q K^T issued before box j's softmax (10-15%
// slower): a box waits on neither the K/V stream nor the products' latency
// alone, and more blocks in flight per SM is what helped.
// fp32 inputs run the mma.sync design (wgmma reads bf16 from shared
// memory): the mma.sync loop of attention_common.cuh, one frame of the
// window at a time, K and V staged through registers.
//
// Grids: Hopper min(items, blocks that fit) x 160 threads (one consumer
// warpgroup and the producer warp); mma.sync design (N * F, H,
// ceil(Tq / 64)) x 128 threads.

#include "attention_common.cuh"
#include "banded_sm90.cuh"

namespace mmdiff {

// ---------------------------------------------------------------------------
// The Hopper kernel (bf16)
// ---------------------------------------------------------------------------

struct BandedFwdArgs : BandedWindow {
  bf16* out;
  float* lse;
  float scale_log2;
};

// Depth of the K/V ring: three stages let three blocks share an SM at
// DK <= 64 (3 x 66 KB of shared memory), which measured 3-26% faster at the
// ds2 and ds4 shapes than two blocks on four stages, and 0-6% slower at the
// one-wave ds8 and middle shapes (PERF.md, PR 6).
constexpr int fwd_stages(int dk) { return dk <= 64 ? 3 : 2; }

template <int DK, int S = fwd_stages(DK)>
struct BandedFwdSmem {
  static constexpr int kStages = S;
  uint8_t q[2][sm90::Tile<DK>::kBytes];  // the query tiles of two items in turn
  uint8_t k[S][sm90::Tile<DK>::kBytes];
  uint8_t v[S][sm90::Tile<DK>::kBytes];
  int kframe[S][sm90::kRows];  // each streamed key row's frame (kNoFrame: none), packed tiles
  uint64_t own_full[2], own_empty[2], full[S], empty[S];
};

// The online softmax over one box of scaled logits sc (base 2; -inf where a
// key is masked) for this thread's two rows: running max m and sum l, the
// accumulator o rescaled, sc replaced by P.
template <int DK>
__device__ __forceinline__ void softmax_step(float (&sc)[32], float (&o)[DK / 2], float (&m)[2],
                                             float (&l)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float base[2], alpha[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mnew = fmaxf(m[r], mx[r]);
    base[r] = mnew == -INFINITY ? 0.f : mnew;  // a row that has met no key yet
    alpha[r] = exp2f(m[r] - base[r]);
    m[r] = mnew;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = exp2f(sc[i] - base[(i >> 1) & 1]);
    rowsum[(i >> 1) & 1] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rowsum[r];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// One box: S = Q K^T, the mask (meets(key, r)), the softmax step, O += P V.
template <int DK, typename Meets>
__device__ __forceinline__ void attend_box(float (&o)[DK / 2], float (&m)[2], float (&l)[2],
                                           const uint8_t* q, const uint8_t* k, const uint8_t* v,
                                           float scale_log2, Meets meets) {
  using namespace sm90;
  float sc[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) wgmma_ss_n64(sc, desc_k(q, kk), desc_k(k, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
#pragma unroll
  for (int i = 0; i < 32; ++i)
    sc[i] = meets(acc_col(i), (i >> 1) & 1) ? sc[i] * scale_log2 : -INFINITY;
  softmax_step<DK>(sc, o, m, l);
  uint32_t pa[4][4];
  acc_to_a(pa, sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<DK>(o, pa[kk], desc_mn(v, kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

// At DK <= 64 three blocks share an SM (<= 136 registers; the ring above).
template <int DK>
__global__ void __launch_bounds__(sm90::kWarpgroup + sm90::kProducerThreads, DK <= 64 ? 3 : 1)
    banded_attention_fwd_sm90(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap kv_map, const BandedFwdArgs a) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  BandedFwdSmem<DK>& sm = aligned_smem<BandedFwdSmem<DK>>(smem_raw);
  constexpr int kTileBytes = Tile<DK>::kBytes, kStages = BandedFwdSmem<DK>::kStages;
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
        mbar_expect_tx(&sm.own_full[b], kTileBytes);
        load_tile<DK>(sm.q[b], &q_map, &sm.own_full[b], 0, wk.h, 0, (int)wk.tile.row0);
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
  int g = 0;
  for (int w = blockIdx.x, it = 0; w < items; w += gridDim.x, ++it) {
    const Work wk(a, w, true);
    const OwnTile& tile = wk.tile;
    const int h = wk.h, b = it & 1;
    bool ok[2];
    int fq[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ok[r] = rows[r] < tile.valid;
      fq[r] = ok[r] ? tile.frame(rows[r], a.tq) : kNoFrame;
    }
    float o[DK / 2];
    zero<DK>(o);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    mbar_wait(&sm.own_full[b], (it >> 1) & 1);
    for (int j = 0; j < wk.st.boxes(); ++j, ++g) {
      const int s = g % kStages;
      int row_j, left;
      wk.st.box(j, row_j, left);
      mbar_wait(&sm.full[s], (g / kStages) & 1);
      if (tile.frames > 1) {  // packed frames: the window test per pair
        const int* kf = sm.kframe[s];
        attend_box<DK>(o, m, l, sm.q[b], sm.k[s], sm.v[s], a.scale_log2,
                       [&](int key, int r) { return in_window(a, kf[key], fq[r]); });
      } else if (left >= kRows) {  // one frame, a full box: every key meets every row
        attend_box<DK>(o, m, l, sm.q[b], sm.k[s], sm.v[s], a.scale_log2,
                       [](int, int) { return true; });
      } else {  // one frame, the range's last box: the keys before its end
        attend_box<DK>(o, m, l, sm.q[b], sm.k[s], sm.v[s], a.scale_log2,
                       [&](int key, int) { return key < left; });
      }
      mbar_arrive(&sm.empty[s]);
    }
    mbar_arrive(&sm.own_empty[b]);

    float inv[2];
    bf16* out_row[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / l[r];
      const long row = tile.row0 + rows[r];
      out_row[r] = a.out + row * c + (long)h * a.dim;
      if (ok[r] && t == 0) {
        const long nf = row / a.tq;  // frame of the whole tensor
        a.lse[(nf * a.heads + h) * a.tq + (row - nf * a.tq)] = (m[r] + log2f(l[r])) * kLn2;
      }
    }
    store_acc<DK>(o, out_row[0], out_row[1], ok[0], ok[1], inv[0], inv[1], a.dim);
  }
}

static int dispatch_sm90(const void* q_src, const void* kv_src, void* out, float* lse, int n,
                         int frames, int tq, int tk, int heads, int dim, int kernel_dim,
                         float scale, int shift, int window, cudaStream_t stream) {
  const int c = heads * dim;
  CUtensorMap q_map, kv_map;
  int err = encode_qkv_map(&q_map, q_src, (long)n * frames * tq, heads, dim, dim, c);
  if (!err) err = encode_qkv_map(&kv_map, kv_src, (long)n * frames * tk, heads, dim, dim, c);
  if (err) return err;
  BandedFwdArgs a;
  static_cast<BandedWindow&>(a) = banded_window(n, frames, tq, tk, heads, dim, shift, window);
  a.out = static_cast<bf16*>(out);
  a.lse = lse;
  a.scale_log2 = kLog2e * scale;
  const int items = work_items(a, true);
#define MMDIFF_CASE(DK)                                                                       \
  case DK:                                                                                    \
    return launch_persistent(banded_attention_fwd_sm90<DK>, sizeof(BandedFwdSmem<DK>) + 1024, \
                             items, stream, q_map, kv_map, a);
  switch (kernel_dim) {
    MMDIFF_CASE(32)
    MMDIFF_CASE(64)
    MMDIFF_CASE(96)
    MMDIFF_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef MMDIFF_CASE
}

// ---------------------------------------------------------------------------
// The mma.sync design (fp32 inputs)
// ---------------------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    banded_attention_fwd_kernel(const T* __restrict__ q_src, const T* __restrict__ kv_src,
                                T* __restrict__ out, float* __restrict__ lse, int frames,
                                int tq, int tk, int heads, int dim, int shift, int window,
                                float scale_log2) {
  __shared__ __align__(16) SharedTiles<D> sm;
  const int nf = blockIdx.x, h = blockIdx.y;
  const int n = nf / frames, f = nf - n * frames;
  const int c = heads * dim;
  const long stride = 3L * c;
  const int row0 = blockIdx.z * kBlockQ + (threadIdx.x >> 5) * 16;

  FlashState<D> st;
  load_queries<D, T>(st, q_src + (long)nf * tq * stride + (long)h * dim, stride, row0, tq, dim);
  for (int j = 0; j < window; ++j) {
    const int g = (f + shift + j) % frames;
    const T* k = kv_src + ((long)n * frames + g) * tk * stride + c + (long)h * dim;
    attend_sequence<D, T>(st, sm, k, k + c, stride, tk, dim, scale_log2);
  }
  store_rows<D, T>(st, out + (long)nf * tq * c + (long)h * dim, c,
                   lse + ((long)nf * heads + h) * tq, row0, tq, dim);
}

template <int D, typename T>
static void launch(const void* q_src, const void* kv_src, void* out, float* lse, int n,
                   int frames, int tq, int tk, int heads, int dim, float scale, int shift,
                   int window, cudaStream_t stream) {
  const dim3 grid(n * frames, heads, (tq + kBlockQ - 1) / kBlockQ);
  banded_attention_fwd_kernel<D, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q_src), static_cast<const T*>(kv_src), static_cast<T*>(out), lse,
      frames, tq, tk, heads, dim, shift, window, kLog2e * scale);
}

template <typename T>
static int dispatch(const void* q_src, const void* kv_src, void* out, float* lse, int n,
                    int frames, int tq, int tk, int heads, int head_dim, int kernel_dim,
                    float scale, int shift, int window, cudaStream_t stream) {
#define MMDIFF_LAUNCH(D)                                                                    \
  launch<D, T>(q_src, kv_src, out, lse, n, frames, tq, tk, heads, head_dim, scale, shift, \
               window, stream);                                                          \
  break;
  switch (kernel_dim) {
    case 32: MMDIFF_LAUNCH(32)
    case 64: MMDIFF_LAUNCH(64)
    case 96: MMDIFF_LAUNCH(96)
    case 128: MMDIFF_LAUNCH(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef MMDIFF_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace mmdiff

static bool head_dim_fits(int head_dim, int kernel_dim) {
  return head_dim % 8 == 0 && head_dim >= 8 && head_dim <= kernel_dim;
}

// `shift` must lie in [0, frames) and 1 <= window <= frames (checked by the
// Python wrapper); `head_dim` runs on the kernel built for `kernel_dim`
// (ops/block_attention.py::kernel_head_dim), with the logit scale `scale`
// (1/sqrt(d) of the caller's real head dim d, which may be below a
// zero-padded `head_dim`).  bf16 takes the Hopper kernel (q_src and kv_src
// 16-byte aligned), fp32 the mma.sync design.  Returns the launch's CUDA
// error (0 on success).
extern "C" int mmdiff_banded_attention_fwd(const void* q_src, const void* kv_src, void* out,
                                           float* lse, int n, int frames, int tq, int tk,
                                           int heads, int head_dim, int kernel_dim, float scale,
                                           int shift, int window, int is_fp32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!head_dim_fits(head_dim, kernel_dim)) return (int)cudaErrorInvalidValue;
  if (is_fp32)
    return mmdiff::dispatch<float>(q_src, kv_src, out, lse, n, frames, tq, tk, heads, head_dim,
                                   kernel_dim, scale, shift, window, s);
  return mmdiff::dispatch_sm90(q_src, kv_src, out, lse, n, frames, tq, tk, heads, head_dim,
                               kernel_dim, scale, shift, window, s);
}
