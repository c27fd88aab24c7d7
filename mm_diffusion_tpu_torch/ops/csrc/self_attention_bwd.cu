// Backward of multi-head self-attention over packed qkv [N, T, 3C]:
//   (qkv, out [N, T, C], dout [N, T, C], lse [N, H, T]) -> dqkv [N, T, 3C]
// in the caller's layout (dq, dk, dv at the lanes where q, k, v were read).
//
// Replaces both TPU backward kernels of mm_diffusion_tpu/ops/block_attention.py:
// `_self_bwd_kernel` (:195, launched by `_self_attention_bwd_pallas`, whole
// [T, T] tiles per row block) and `_self_bwd_chunked_kernel` (:264, launched
// by `_self_attention_bwd_chunked_pallas`, q in 256-row chunks for T = 1024).
// Neither form carries over: on Hopper no block holds a [T, T] tile, so one
// flash-style backward over 64-row tiles serves every T, T = 16 with
// thousands of sequences and ragged T = 400 included.
//
// What bounds it on this card: at T = 1024 the five [T, T] products (10 T^2 d
// FLOPs per (sequence, head)) bound it on the tensor cores; at T <= 400 the
// bytes of qkv, out and dout, and the blocks in flight.  The mma.sync design
// (attention_bwd_common.cuh; fp32 only now) staged every tile through registers
// with two __syncthreads per 32-row tile and read transposed operands as
// 16-bit pairs; it ran at 2.5x the time of PyTorch's fused backward at
// T = 1024.
//
// The design (bf16; attention_sm90.cuh), two passes, deterministic (every
// gradient summed in registers by the one block that owns its rows, no float
// atomics):
//   dq pass   a block owns 64 query rows: its Q and dO tiles come once by
//             TMA, a producer warp streams 64-key K and V tiles through a
//             kBwdStages ring.  It first writes delta = rowsum(dO * O) for
//             the dkv pass, then per tile, on wgmma:
//               S = Q K^T, dP = dO V^T (shared-memory operands, K-major),
//               P = exp2(S scale_log2 - lse), dS = P (dP - delta) / sqrt(d),
//               dQ += dS K (dS from registers, K read MN-major);
//   dkv pass  a block owns 64 keys: its K and V tiles stay in shared memory,
//             the producer streams Q and dO tiles with their lse and delta:
//               S^T = K Q^T, dP^T = V dO^T,
//               P^T = exp2(S^T scale_log2 - lse), dV += P^T dO,
//               dS^T = P^T (dP^T - delta) / sqrt(d), dK += dS^T Q.
// P and dS are rounded to bf16 before the gradient products, as before.
// T <= 32 packs up to floor(64 / T) sequences into one 64-row tile under a
// block-diagonal mask, chosen by grid size as the forward does (pack_for).
// At T <= 64 the block's tile holds every key and query its rows meet, and
// one kernel does both passes' work from tiles loaded once (one launch, no
// delta round trip).
// fp32 inputs run the mma.sync design.
//
// Grids: every kernel (blocks, H), blocks = N * ceil(T / 64) or ceil(N / pack),
// 160 threads (one consumer warpgroup and the producer warp); mma.sync design
// (N, H, ceil(T / 64)), 128 threads.  At T > 64 the dq pass writes delta,
// which the dkv pass reads, so the two run in this order on the caller's
// stream.

#include "attention_bwd_common.cuh"
#include "attention_sm90.cuh"

namespace mmdiff {

// ---------------------------------------------------------------------------
// The Hopper kernels (bf16)
// ---------------------------------------------------------------------------

constexpr int kBwdStages = 2;  // depth of the K/V (dq pass) and Q/dO (dkv pass) rings

struct BwdArgs {
  const bf16* out;
  const bf16* dout;
  const float* lse;
  float* delta;
  bf16* dqkv;
  int n, len, heads, dim, per_head, head_stride, k_off, v_off;
  int pack;   // > 1: `pack` whole sequences share one 64-row tile (T <= 32)
  int tiles;  // 64-row tiles per sequence
  float scale_log2, scale;
};

// The block's 64-row tile: sequence `seq` (the pack's first), its first row
// r0 within the sequence, the `valid` rows (of the sequence or the pack) and
// the number of tiles the other operand streams.
struct BlockRows {
  int seq, r0, valid, ntiles;
  __device__ explicit BlockRows(const BwdArgs& a) {
    if (a.pack > 1) {
      seq = blockIdx.x * a.pack;
      r0 = 0;
      valid = min(a.pack, a.n - seq) * a.len;
      ntiles = 1;
    } else {
      seq = blockIdx.x / a.tiles;
      r0 = (blockIdx.x - seq * a.tiles) * sm90::kRows;
      valid = a.len;
      ntiles = a.tiles;
    }
  }
  // Whether row `x` of the streamed operand's tile j meets row `y` of the
  // block's tile: the same sequence, and a real row.
  __device__ bool meets(const BwdArgs& a, int j, int x, int y) const {
    return a.pack > 1 ? x < valid && x / a.len == y / a.len : j * sm90::kRows + x < a.len;
  }
  // Index into [N, H, T] (lse, delta) of row `x` (of the sequence or pack).
  __device__ long row_index(const BwdArgs& a, int h, int x) const {
    const int sq = a.pack > 1 ? seq + x / a.len : seq, i = a.pack > 1 ? x % a.len : x;
    return ((long)sq * a.heads + h) * a.len + i;
  }
};

// Whether query column x of a streamed tile meets key row y of the block's
// tile in the dkv products: always, but for packed sequences (a.pack > 1),
// which meet only within their own segment (rows past the last sequence
// have lse2 = +inf).
__device__ __forceinline__ bool same_segment(const BwdArgs& a, int x, int y) {
  return a.pack == 1 || x / a.len == y / a.len;
}

// This thread's two rows of the block's tile (query rows): whether each is
// real, its logsumexp in base 2, and delta = rowsum(dO * O), which is also
// written to a.delta for a dkv pass.
__device__ __forceinline__ void row_stats(const BwdArgs& a, const BlockRows& br, int h, int row0,
                                          const int (&rows)[2], bool (&ok)[2], float (&lse2)[2],
                                          float (&delta)[2]) {
  const int t = threadIdx.x & 3;
  const int c = a.heads * a.dim;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ok[r] = rows[r] < br.valid;
    const long off = (long)(row0 + rows[r]) * c + (long)h * a.dim;
    float acc = 0.f;
    if (ok[r]) {
      for (int col = 2 * t; col < a.dim; col += 8) {
        const float2 o = Load2<bf16>::get(a.out + off + col);
        const float2 d = Load2<bf16>::get(a.dout + off + col);
        acc += o.x * d.x + o.y * d.y;
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    delta[r] = acc;
    const long idx = br.row_index(a, h, rows[r]);
    lse2[r] = ok[r] ? a.lse[idx] * kLog2e : 0.f;
    if (ok[r] && t == 0) a.delta[idx] = acc;
  }
}

// Store a gradient accumulator of this thread's rows (real ones only) at lane
// offset `lane_off` (0, k_off or v_off) of each row's head in dqkv.
template <int DK>
__device__ __forceinline__ void store_grad(const float (&acc)[DK / 2], const BwdArgs& a, int h,
                                           int row0, const int (&rows)[2], const bool (&ok)[2],
                                           int lane_off) {
  const long c3 = 3L * a.heads * a.dim;
  bf16* base = a.dqkv + (long)h * a.head_stride + lane_off;
  sm90::store_acc<DK>(acc, base + (row0 + rows[0]) * c3, base + (row0 + rows[1]) * c3, ok[0],
                      ok[1], 1.f, 1.f, a.dim);
}

template <int DK>
struct DqSmem90 {
  uint8_t q[sm90::Tile<DK>::kBytes];
  uint8_t go[sm90::Tile<DK>::kBytes];
  uint8_t k[kBwdStages][sm90::Tile<DK>::kBytes];
  uint8_t v[kBwdStages][sm90::Tile<DK>::kBytes];
  uint64_t q_full, full[kBwdStages], empty[kBwdStages];
};

// The dq pass (T > 64): the block's 64 query rows against every key tile.
template <int DK>
__global__ void __launch_bounds__(sm90::kWarpgroup + sm90::kProducerThreads, 1)
    self_attention_bwd_dq_sm90(const __grid_constant__ CUtensorMap qkv_map,
                               const __grid_constant__ CUtensorMap dout_map, const BwdArgs a) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  DqSmem90<DK>& sm = sm90::aligned_smem<DqSmem90<DK>>(smem_raw);
  constexpr int kTileBytes = Tile<DK>::kBytes;
  const int h = blockIdx.y;
  const BlockRows br(a);
  const int row0 = br.seq * a.len;  // qkv row of the sequence's first token

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kWarpgroup);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWarpgroup) {  // producer warp
    if (threadIdx.x == kWarpgroup) {
      mbar_expect_tx(&sm.q_full, 2 * kTileBytes);
      load_tile<DK>(sm.q, &qkv_map, &sm.q_full, 0, h, a.per_head, row0 + br.r0);
      load_tile<DK>(sm.go, &dout_map, &sm.q_full, 0, h, 0, row0 + br.r0);
      for (int j = 0; j < br.ntiles; ++j) {
        const int s = j % kBwdStages;
        mbar_wait(&sm.empty[s], ((j / kBwdStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * kTileBytes);
        load_tile<DK>(sm.k[s], &qkv_map, &sm.full[s], 1, h, a.per_head, row0 + j * kRows);
        load_tile<DK>(sm.v[s], &qkv_map, &sm.full[s], 2, h, a.per_head, row0 + j * kRows);
      }
    }
    return;
  }

  int qr[2];
  thread_rows(qr, br.r0);
  bool ok[2];
  float lse2[2], delta[2];
  row_stats(a, br, h, row0, qr, ok, lse2, delta);
  float dq[DK / 2];
  zero<DK>(dq);
  mbar_wait(&sm.q_full, 0);
  for (int j = 0; j < br.ntiles; ++j) {
    const int s = j % kBwdStages;
    mbar_wait(&sm.full[s], (j / kBwdStages) & 1);
    dq_products<DK>(dq, sm.q, sm.go, sm.k[s], sm.v[s], lse2, delta, a.scale_log2, a.scale,
                [&](int key, int r) { return br.meets(a, j, key, qr[r]); });
    mbar_arrive(&sm.empty[s]);
  }
  store_grad<DK>(dq, a, h, row0, qr, ok, 0);
}

template <int DK>
struct DkvSmem90 {
  uint8_t k[sm90::Tile<DK>::kBytes];
  uint8_t v[sm90::Tile<DK>::kBytes];
  uint8_t q[kBwdStages][sm90::Tile<DK>::kBytes];
  uint8_t go[kBwdStages][sm90::Tile<DK>::kBytes];
  float lse2[kBwdStages][sm90::kRows];  // the query tile's logsumexp, base 2 (+inf: no row)
  float delta[kBwdStages][sm90::kRows];
  uint64_t kv_full, full[kBwdStages], empty[kBwdStages];
};

// The dkv pass (T > 64): the block's 64 keys against every query tile.
template <int DK>
__global__ void __launch_bounds__(sm90::kWarpgroup + sm90::kProducerThreads, 1)
    self_attention_bwd_dkv_sm90(const __grid_constant__ CUtensorMap qkv_map,
                                const __grid_constant__ CUtensorMap dout_map, const BwdArgs a) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  DkvSmem90<DK>& sm = sm90::aligned_smem<DkvSmem90<DK>>(smem_raw);
  constexpr int kTileBytes = Tile<DK>::kBytes;
  const int h = blockIdx.y;
  const BlockRows br(a);  // the block's 64 keys
  const int row0 = br.seq * a.len;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&sm.full[s], kProducerThreads);
      mbar_init(&sm.empty[s], kWarpgroup);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWarpgroup) {  // producer warp: every lane stages lse and delta, one the tiles
    const int lane = threadIdx.x - kWarpgroup;
    if (lane == 0) {
      mbar_expect_tx(&sm.kv_full, 2 * kTileBytes);
      load_tile<DK>(sm.k, &qkv_map, &sm.kv_full, 1, h, a.per_head, row0 + br.r0);
      load_tile<DK>(sm.v, &qkv_map, &sm.kv_full, 2, h, a.per_head, row0 + br.r0);
    }
    for (int j = 0; j < br.ntiles; ++j) {
      const int s = j % kBwdStages;
      mbar_wait(&sm.empty[s], ((j / kBwdStages) & 1) ^ 1);
#pragma unroll
      for (int i = lane; i < kRows; i += 32) {
        const int x = j * kRows + i;  // query row of the sequence
        const bool real = x < br.valid;
        const long idx = real ? br.row_index(a, h, x) : 0;
        sm.lse2[s][i] = real ? a.lse[idx] * kLog2e : INFINITY;
        sm.delta[s][i] = real ? a.delta[idx] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(&sm.full[s], 2 * kTileBytes);
        load_tile<DK>(sm.q[s], &qkv_map, &sm.full[s], 0, h, a.per_head, row0 + j * kRows);
        load_tile<DK>(sm.go[s], &dout_map, &sm.full[s], 0, h, 0, row0 + j * kRows);
      } else {
        mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }

  int kr[2];
  thread_rows(kr, br.r0);
  const bool ok[2] = {kr[0] < br.valid, kr[1] < br.valid};
  float dk[DK / 2], dv[DK / 2];
  zero<DK>(dk);
  zero<DK>(dv);
  mbar_wait(&sm.kv_full, 0);
  for (int j = 0; j < br.ntiles; ++j) {
    const int s = j % kBwdStages;
    mbar_wait(&sm.full[s], (j / kBwdStages) & 1);
    dkv_products<DK>(dk, dv, sm.k, sm.v, sm.q[s], sm.go[s], sm.lse2[s], sm.delta[s], a.scale_log2,
                 a.scale, [&](int x, int r) { return same_segment(a, x, kr[r]); });
    mbar_arrive(&sm.empty[s]);
  }
  store_grad<DK>(dk, a, h, row0, kr, ok, a.k_off);
  store_grad<DK>(dv, a, h, row0, kr, ok, a.v_off);
}

template <int DK>
struct TileSmem90 {
  uint8_t q[sm90::Tile<DK>::kBytes];
  uint8_t k[sm90::Tile<DK>::kBytes];
  uint8_t v[sm90::Tile<DK>::kBytes];
  uint8_t go[sm90::Tile<DK>::kBytes];
  float lse2[sm90::kRows];  // per query row, base 2 (+inf: no row)
  float delta[sm90::kRows];
  uint64_t full;
};

// T <= 64: the block's 64 rows hold every key and query that they meet (one
// sequence, or `pack` whole sequences under the block-diagonal mask), so one
// block computes dQ, dK and dV of its rows in a single pass from its Q, K, V
// and dO tiles, loaded once: the dq pass's products, then the dkv pass's.
template <int DK>
__global__ void __launch_bounds__(sm90::kWarpgroup + sm90::kProducerThreads, 1)
    self_attention_bwd_tile_sm90(const __grid_constant__ CUtensorMap qkv_map,
                                 const __grid_constant__ CUtensorMap dout_map, const BwdArgs a) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  TileSmem90<DK>& sm = sm90::aligned_smem<TileSmem90<DK>>(smem_raw);
  const int h = blockIdx.y;
  const BlockRows br(a);  // ntiles == 1, r0 == 0
  const int row0 = br.seq * a.len;

  if (threadIdx.x == 0) {
    mbar_init(&sm.full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWarpgroup) {  // producer warp
    if (threadIdx.x == kWarpgroup) {
      mbar_expect_tx(&sm.full, 4 * Tile<DK>::kBytes);
      load_tile<DK>(sm.q, &qkv_map, &sm.full, 0, h, a.per_head, row0);
      load_tile<DK>(sm.k, &qkv_map, &sm.full, 1, h, a.per_head, row0);
      load_tile<DK>(sm.v, &qkv_map, &sm.full, 2, h, a.per_head, row0);
      load_tile<DK>(sm.go, &dout_map, &sm.full, 0, h, 0, row0);
    }
    return;
  }

  int rows[2];  // this thread's query rows, and key rows
  thread_rows(rows, 0);
  bool ok[2];
  float lse2[2], delta[2];
  row_stats(a, br, h, row0, rows, ok, lse2, delta);
  if ((threadIdx.x & 3) == 0) {  // by column, for the dK / dV products
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sm.lse2[rows[r]] = ok[r] ? lse2[r] : INFINITY;
      sm.delta[rows[r]] = ok[r] ? delta[r] : 0.f;
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWarpgroup) : "memory");  // the consumers only
  mbar_wait(&sm.full, 0);

  {
    float dq[DK / 2];
    zero<DK>(dq);
    dq_products<DK>(dq, sm.q, sm.go, sm.k, sm.v, lse2, delta, a.scale_log2, a.scale,
                [&](int key, int r) { return br.meets(a, 0, key, rows[r]); });
    store_grad<DK>(dq, a, h, row0, rows, ok, 0);
  }
  float dk[DK / 2], dv[DK / 2];
  zero<DK>(dk);
  zero<DK>(dv);
  dkv_products<DK>(dk, dv, sm.k, sm.v, sm.q, sm.go, sm.lse2, sm.delta, a.scale_log2, a.scale,
               [&](int x, int r) { return same_segment(a, x, rows[r]); });
  store_grad<DK>(dk, a, h, row0, rows, ok, a.k_off);
  store_grad<DK>(dv, a, h, row0, rows, ok, a.v_off);
}

template <int DK>
static int launch_sm90(const CUtensorMap& qkv_map, const CUtensorMap& dout_map, const BwdArgs& a,
                       cudaStream_t stream) {
  const int blocks = a.pack > 1 ? (a.n + a.pack - 1) / a.pack : a.n * a.tiles;
  const dim3 grid(blocks, a.heads);
  constexpr int kThreads90 = sm90::kWarpgroup + sm90::kProducerThreads;
  if (a.tiles == 1) {  // T <= 64: one pass
    constexpr size_t smem = sizeof(TileSmem90<DK>) + 1024;
    const int err = set_dynamic_smem(self_attention_bwd_tile_sm90<DK>, smem);
    if (err) return err;
    self_attention_bwd_tile_sm90<DK><<<grid, kThreads90, smem, stream>>>(qkv_map, dout_map, a);
    return (int)cudaGetLastError();
  }
  constexpr size_t dq_smem = sizeof(DqSmem90<DK>) + 1024;
  int err = set_dynamic_smem(self_attention_bwd_dq_sm90<DK>, dq_smem);
  if (err) return err;
  self_attention_bwd_dq_sm90<DK><<<grid, kThreads90, dq_smem, stream>>>(qkv_map, dout_map, a);
  err = (int)cudaGetLastError();
  if (err) return err;
  constexpr size_t dkv_smem = sizeof(DkvSmem90<DK>) + 1024;
  err = set_dynamic_smem(self_attention_bwd_dkv_sm90<DK>, dkv_smem);
  if (err) return err;
  self_attention_bwd_dkv_sm90<DK><<<grid, kThreads90, dkv_smem, stream>>>(qkv_map, dout_map, a);
  return (int)cudaGetLastError();
}

static int dispatch_sm90(const void* qkv, const void* out, const void* dout, const float* lse,
                         float* delta, void* dqkv, int n, int len, int heads, int dim,
                         int kernel_dim, float scale, int head_stride, int k_off, int v_off,
                         cudaStream_t stream) {
  const long rows = (long)n * len;
  const int c = heads * dim;
  CUtensorMap qkv_map, dout_map;
  int err = encode_qkv_map(&qkv_map, qkv, rows, heads, dim, head_stride, k_off);
  if (!err) err = encode_map(&dout_map, dout, dim, heads, dim, 1, c, rows, c);
  if (err) return err;
  BwdArgs a;
  a.out = static_cast<const bf16*>(out);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = lse;
  a.delta = delta;
  a.dqkv = static_cast<bf16*>(dqkv);
  a.n = n;
  a.len = len;
  a.heads = heads;
  a.dim = dim;
  a.per_head = head_stride != dim;
  a.head_stride = head_stride;
  a.k_off = k_off;
  a.v_off = v_off;
  a.pack = pack_for(n, len, heads);
  a.tiles = (len + sm90::kRows - 1) / sm90::kRows;
  a.scale = scale;
  a.scale_log2 = kLog2e * scale;
  switch (kernel_dim) {
    case 32: return launch_sm90<32>(qkv_map, dout_map, a, stream);
    case 64: return launch_sm90<64>(qkv_map, dout_map, a, stream);
    case 96: return launch_sm90<96>(qkv_map, dout_map, a, stream);
    case 128: return launch_sm90<128>(qkv_map, dout_map, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The mma.sync design (fp32 inputs)
// ---------------------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    self_attention_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ out,
                                 const T* __restrict__ dout, const float* __restrict__ lse,
                                 float* __restrict__ delta, T* __restrict__ dqkv, int len,
                                 int heads, int dim, int head_stride, int k_off, int v_off,
                                 float scale_log2, float scale) {
  __shared__ __align__(16) unsigned short sk[kBwdTile * (D + kPadK)];
  __shared__ __align__(16) unsigned short sv[kBwdTile * (D + kPadK)];
  const int n = blockIdx.x, h = blockIdx.y;
  const int c = heads * dim;
  const long stride = 3L * c;
  const long seq = (long)n * len * stride + (long)h * head_stride;
  const long o_off = (long)n * len * c + (long)h * dim;
  const long row_off = ((long)n * heads + h) * len;
  const int row0 = blockIdx.z * kBlockQ + (threadIdx.x >> 5) * 16;

  DqState<D> st;
  dq_begin<D, T>(st, qkv + seq, stride, out + o_off, dout + o_off, c, lse + row_off,
                 delta + row_off, row0, len, dim);
  dq_sequence<D, T>(st, sk, sv, qkv + seq + k_off, qkv + seq + v_off, stride, len, dim,
                    scale_log2, scale);
  store_frags<D, T>(st.dq, dqkv + seq, stride, row0, len, dim);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    self_attention_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                                  const float* __restrict__ lse, const float* __restrict__ delta,
                                  T* __restrict__ dqkv, int len, int heads, int dim,
                                  int head_stride, int k_off, int v_off, float scale_log2,
                                  float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DkvSmem<D> sm(smem);
  const int n = blockIdx.x, h = blockIdx.y;
  const int c = heads * dim;
  const long stride = 3L * c;
  const long seq = (long)n * len * stride + (long)h * head_stride;
  const long o_off = (long)n * len * c + (long)h * dim;
  const long row_off = ((long)n * heads + h) * len;
  const int key0 = blockIdx.z * kBwdKeys;
  const int keys = min(kBwdKeys, len - key0);

  stage_rows<D, T>(sm.k, qkv + seq + k_off + key0 * stride, stride, keys, kBwdKeys, dim);
  stage_rows<D, T>(sm.v, qkv + seq + v_off + key0 * stride, stride, keys, kBwdKeys, dim);
  DkvState<D> st;
  zero_acc<D>(st.dk);
  zero_acc<D>(st.dv);
  dkv_sequence<D, T>(st, sm, qkv + seq, stride, dout + o_off, c, lse + row_off,
                     delta + row_off, len, dim, scale_log2, scale);
  const int row0 = key0 + (threadIdx.x >> 5) * 16;
  store_frags<D, T>(st.dk, dqkv + seq + k_off, stride, row0, len, dim);
  store_frags<D, T>(st.dv, dqkv + seq + v_off, stride, row0, len, dim);
}

template <int D, typename T>
static int launch(const void* qkv, const void* out, const void* dout, const float* lse,
                  float* delta, void* dqkv, int n, int len, int heads, int dim, float scale,
                  int head_stride, int k_off, int v_off, cudaStream_t stream) {
  const float scale_log2 = kLog2e * scale;
  const T* x = static_cast<const T*>(qkv);
  const T* o = static_cast<const T*>(out);
  const T* go = static_cast<const T*>(dout);
  T* dx = static_cast<T*>(dqkv);

  const dim3 grid_q(n, heads, (len + kBlockQ - 1) / kBlockQ);
  self_attention_bwd_dq_kernel<D, T><<<grid_q, kThreads, 0, stream>>>(
      x, o, go, lse, delta, dx, len, heads, dim, head_stride, k_off, v_off, scale_log2, scale);
  int err = (int)cudaGetLastError();
  if (err) return err;

  const size_t smem = DkvSmem<D>::bytes();
  err = set_dynamic_smem(self_attention_bwd_dkv_kernel<D, T>, smem);
  if (err) return err;
  const dim3 grid_kv(n, heads, (len + kBwdKeys - 1) / kBwdKeys);
  self_attention_bwd_dkv_kernel<D, T><<<grid_kv, kThreads, smem, stream>>>(
      x, go, lse, delta, dx, len, heads, dim, head_stride, k_off, v_off, scale_log2, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* qkv, const void* out, const void* dout, const float* lse,
                    float* delta, void* dqkv, int n, int len, int heads, int dim, int kernel_dim,
                    float scale, int head_stride, int k_off, int v_off, cudaStream_t stream) {
#define MMDIFF_CASE(D)                                                                         \
  case D:                                                                                      \
    return launch<D, T>(qkv, out, dout, lse, delta, dqkv, n, len, heads, dim, scale,         \
                        head_stride, k_off, v_off, stream);
  switch (kernel_dim) {
    MMDIFF_CASE(32)
    MMDIFF_CASE(64)
    MMDIFF_CASE(96)
    MMDIFF_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef MMDIFF_CASE
}

}  // namespace mmdiff

static bool head_dim_fits(int head_dim, int kernel_dim) {
  return head_dim % 8 == 0 && head_dim >= 8 && head_dim <= kernel_dim;
}

// qkv and dqkv share the layout of mmdiff_self_attention_fwd (head stride and
// k/v offsets); out and dout are [N, T, C], lse and the scratch delta
// [N, H, T] fp32; `head_dim` runs on the kernels built for `kernel_dim`, with
// the logit scale `scale` (1/sqrt(d) of the caller's real head dim d).
// bf16 takes the Hopper kernels (qkv and dout 16-byte aligned), fp32 the
// mma.sync design.  Every element of dqkv is written.  Returns the first
// failing launch's CUDA error (0 on success).
extern "C" int mmdiff_self_attention_bwd(const void* qkv, const void* out, const void* dout,
                                         const float* lse, float* delta, void* dqkv, int n,
                                         int len, int heads, int head_dim, int kernel_dim,
                                         float scale, int head_stride, int k_off, int v_off,
                                         int is_fp32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!head_dim_fits(head_dim, kernel_dim)) return (int)cudaErrorInvalidValue;
  if (is_fp32)
    return mmdiff::dispatch<float>(qkv, out, dout, lse, delta, dqkv, n, len, heads, head_dim,
                                   kernel_dim, scale, head_stride, k_off, v_off, s);
  return mmdiff::dispatch_sm90(qkv, out, dout, lse, delta, dqkv, n, len, heads, head_dim,
                               kernel_dim, scale, head_stride, k_off, v_off, s);
}
