// Multi-head self-attention over packed qkv [N, T, 3C] -> [N, T, C], plus the
// per-row logsumexp [N, H, T] (fp32) that the backward reuses; and the A/B
// variants of its softmax (rows, nomax, noexp) without the logsumexp.
//
// Replaces the TPU kernel `_self_fwd_kernel` of
// mm_diffusion_tpu/ops/block_attention.py:165 (launched by
// `_self_attention_pallas` through `self_attention_packed`), and the TPU
// spike kernels `_fwd_kernel_v2` (tools/bench_attn_variants.py:36, rows_cap)
// and `_fwd_kernel_v3` (tools/bench_attn_variants2.py:40, nomax / noexp).
//
// What bounds it on this card: the model's sequences are short (T <= 1024,
// head dim 64/96/128), so one (sequence, head) pair is at most ~0.5 GFLOP;
// at T = 1024 the call is bound by the tensor cores (4 T^2 d FLOPs per pair
// against one read of qkv), at T <= 256 by the bytes of qkv and by the blocks
// in flight.  The mma.sync design (attention_common.cuh; fp32 only now) ran
// bf16 at 70-90 TFLOP/s at T = 1024 (PERF.md): its K/V staging went through
// registers with no load in flight during the products, and warp-level
// m16n8k16 products reach about two thirds of the card's dense rate at best.
//
// The design (bf16; attention_sm90.cuh):
//   - a warp-specialised block: one producer warp keeps TMA loads of 64-key
//     K and V tiles in flight through a ring of kFwdStages stages (full /
//     empty mbarriers); one or two consumer warpgroups each own 64 query
//     rows, whose Q tile TMA brings once;
//   - both products on wgmma (m64nNk16, bf16 in, fp32 accumulate):
//     S = Q K^T with Q and K read from shared memory (K-major), and
//     O += P V with P packed to bf16 from S's accumulators in registers and
//     V read in its natural [key][dim] order as an MN-major operand (at
//     kernel head dims 192 and 256, variants only, as two products of half
//     the columns each);
//   - the softmax in fp32 on the accumulator fragments, a compile-time mode
//     (Mode below): the main path's online softmax (base 2, scale folded in,
//     running max and sum per row, the logsumexp written), or a variant's;
//   - one tensor map serves both qkv layouts (the thirds' [q | k | v] and the
//     SR U-Net's per-head [h0: q k v | h1: ...]); keys past T are the next
//     sequence's rows and are masked by index;
//   - T <= 32: up to floor(64 / T) sequences share one 64-row tile under a
//     block-diagonal mask, so the temporal sites (T = 16, N up to 4096) fill
//     the warpgroup instead of a quarter of it (fewer when that would leave
//     SMs idle, pack_for);
//   - two consumer warpgroups (128 query rows sharing each K/V tile) when
//     T > 64 and that still gives a block per SM; one otherwise.
// The variants (mmdiff_self_attention_variant_fwd; thirds layout, no lse):
//   nomax  P = exp2(min(logit * scale * log2 e, 40 * log2 e)): no running
//          max, no rescale of O, the row sum normalises at the end; exact
//          only while the logits stay below 40 (P up to e^40 ~ 2.4e17,
//          finite in bf16 and in the fp32 sums), diagnostic only;
//   noexp  P = logit * scale * 1e-3, no softmax and no normalisation: the
//          two products alone, a floor and not attention (per sequence,
//          where the TPU tool's packed blocks mix sequences);
//   rows   the TPU tool's raised rows-per-block cap: fewer, larger grid
//          steps at tiny T.  Here, at T <= 32, persistent blocks (as many
//          as fit on the card) each walk a strided list of 64-row tiles of
//          floor(64 / T) whole sequences -- never fewer, since the grid is
//          sized to the card -- with each tile's Q, K and V in one stage of
//          a ring, so that the producer loads the next tiles while the
//          consumers compute and store the current one; at T > 32 it is the
//          main path's kernel without the logsumexp.  The launch plan
//          (pack, blocks, tiles per block, warpgroups) comes from the
//          caller (ops/block_attention.py::rows_launch_plan).
//   nomax and noexp keep the main path's grid and pack_for at T <= 32, so
//   rows against the main path at T = 16 isolates the persistence.
// fp32 inputs run the mma.sync design (wgmma reads bf16 from shared
// memory).
//
// Grids: Hopper (blocks, H), blocks = N * ceil(T / (64 * warpgroups)) or
// ceil(N / pack); rows at T <= 32: the plan's blocks, one dimension;
// mma.sync design (N, H, ceil(T / 64)), 128 threads.

#include "attention_common.cuh"
#include "attention_sm90.cuh"

namespace mmdiff {

// The softmax of a tile: the main path's (0) or a variant's (the variant
// codes of mmdiff_self_attention_variant_fwd).
enum Mode { kStock = 0, kVariantRows = 1, kVariantNoMax = 2, kVariantNoExp = 3 };

constexpr float kNoMaxClampLog2 = 40.f * kLog2e;  // clamp of nomax, base-2 units
constexpr float kNoExpScale = 1e-3f;

// ---------------------------------------------------------------------------
// The Hopper kernels (bf16)
// ---------------------------------------------------------------------------

constexpr int kFwdStages = 2;  // depth of the K/V ring

template <int DK, int WG>
struct FwdSmem {
  uint8_t q[WG][sm90::Tile<DK>::kBytes];
  uint8_t k[kFwdStages][sm90::Tile<DK>::kBytes];
  uint8_t v[kFwdStages][sm90::Tile<DK>::kBytes];
  uint64_t q_full;
  uint64_t full[kFwdStages];
  uint64_t empty[kFwdStages];
};

struct FwdArgs {
  bf16* out;
  float* lse;  // kStock only
  int n, len, heads, dim, per_head;
  int pack;   // > 1: `pack` whole sequences share one 64-row tile (T <= 32)
  int tiles;  // query tiles of 64 * WG rows per sequence (pack == 1)
  float logit_mul;  // the logits' factor: scale * log2 e (softmax), scale * 1e-3 (noexp)
};

// O += P V for one 64-key tile: P (bf16, registers) as four k-steps, V
// MN-major in shared memory.  Above 128 columns (192, 256) two products of
// DK / 2 columns each, the second on V's chunks from DK / 64 on.
template <int DK>
__device__ __forceinline__ void pv_products(float (&o)[DK / 2], const uint32_t (&pa)[4][4],
                                            const uint8_t* v) {
  using namespace sm90;
  if constexpr (DK <= 128) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<DK>(o, pa[kk], desc_mn(v, kk));
  } else {
    constexpr int kHalf = DK / 2;
    float(&lo)[kHalf / 2] = *reinterpret_cast<float(*)[kHalf / 2]>(&o[0]);
    float(&hi)[kHalf / 2] = *reinterpret_cast<float(*)[kHalf / 2]>(&o[kHalf / 2]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<kHalf>(lo, pa[kk], desc_mn(v, kk));
      wgmma_rs<kHalf>(hi, pa[kk], desc_mn(v + (kHalf / kChunk) * kChunkBytes, kk));
    }
  }
}

// One 64-key tile against a warpgroup's 64 query rows: S = Q K^T, P from S
// in mode M for this thread's two rows (meets(i): whether accumulator
// element i's key counts for its row), O += P V.
//   stock / rows: the online softmax (base 2), running max m and sum l, O
//                 rescaled;
//   nomax:        P = exp2(min(S mul, 40 log2 e)), l += the row sums; no
//                 max, no rescale;
//   noexp:        P = S mul (mul = scale * 1e-3); no l.
// Masked keys give P = 0.
template <int DK, int M, typename Meets>
__device__ __forceinline__ void attend_tile_sm90(float (&o)[DK / 2], float (&m)[2],
                                                 float (&l)[2], const uint8_t* q,
                                                 const uint8_t* k, const uint8_t* v, float mul,
                                                 Meets meets) {
  using namespace sm90;
  float sc[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) wgmma_ss_n64(sc, desc_k(q, kk), desc_k(k, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);

  if constexpr (M == kVariantNoExp) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = meets(i) ? sc[i] * mul : 0.f;
  } else if constexpr (M == kVariantNoMax) {
    float rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = meets(i) ? exp2f(fminf(sc[i] * mul, kNoMaxClampLog2)) : 0.f;
      rowsum[(i >> 1) & 1] += sc[i];
    }
    l[0] += rowsum[0];
    l[1] += rowsum[1];
  } else {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = meets(i) ? sc[i] * mul : -INFINITY;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
    float base[2], alpha[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mnew = fmaxf(m[r], mx[r]);
      base[r] = mnew == -INFINITY ? 0.f : mnew;  // a packed row with no key yet
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

  uint32_t pa[4][4];
  acc_to_a(pa, sc);
  wgmma_fence();
  pv_products<DK>(o, pa, v);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

// The factor of a row's output: 1 / its softmax sum (reduced over the quad
// that holds the row), 1 in noexp.
template <int M>
__device__ __forceinline__ void row_inverse(float (&inv)[2], float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (M == kVariantNoExp) {
      inv[r] = 1.f;
    } else {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / l[r];
    }
  }
}

// At DK <= 64 the compiler is asked for two resident blocks per SM (17%
// faster at T = 1024 than one, PERF.md); at DK 96 and 128 the accumulators
// would spill under the register cap that two blocks impose.
template <int DK, int WG, int M>
__global__ void __launch_bounds__(WG * sm90::kWarpgroup + sm90::kProducerThreads,
                                  DK <= 64 ? 2 : 1)
    self_attention_sm90_kernel(const __grid_constant__ CUtensorMap qkv_map, const FwdArgs a) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  FwdSmem<DK, WG>& sm = sm90::aligned_smem<FwdSmem<DK, WG>>(smem_raw);
  constexpr int kTileBytes = Tile<DK>::kBytes;
  const int h = blockIdx.y, len = a.len;
  // pack > 1: rows [seq * T, seq * T + 64) hold `pack` whole sequences, of
  // which `valid` rows are real; pack == 1: sequence `seq`, query rows
  // [q0, q0 + 64 * WG) of it.
  int seq, q0, ntiles, valid;
  if (a.pack > 1) {
    seq = blockIdx.x * a.pack;
    q0 = 0;
    ntiles = 1;
    valid = min(a.pack, a.n - seq) * len;
  } else {
    seq = blockIdx.x / a.tiles;
    q0 = (blockIdx.x - seq * a.tiles) * (kRows * WG);
    ntiles = (len + kRows - 1) / kRows;
    valid = len;
  }
  const int row0 = seq * len;  // qkv row of the sequence's (or the pack's) first token
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], WG * kWarpgroup);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == WG * 4) {  // producer warp: one lane issues every copy
    if ((threadIdx.x & 31) == 0) {
      mbar_expect_tx(&sm.q_full, WG * kTileBytes);
      for (int w = 0; w < WG; ++w)
        load_tile<DK>(sm.q[w], &qkv_map, &sm.q_full, 0, h, a.per_head, row0 + q0 + w * kRows);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kFwdStages;
        mbar_wait(&sm.empty[s], ((j / kFwdStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * kTileBytes);
        load_tile<DK>(sm.k[s], &qkv_map, &sm.full[s], 1, h, a.per_head, row0 + j * kRows);
        load_tile<DK>(sm.v[s], &qkv_map, &sm.full[s], 2, h, a.per_head, row0 + j * kRows);
      }
    }
    return;
  }

  // Consumer warpgroup wg: query rows q0 + 64 wg + [0, 64); this thread
  // holds rows qr[0] and qr[1] (of the sequence, or of the pack).
  const int wg = warp >> 2, t = threadIdx.x & 3;
  int qr[2];
  thread_rows(qr, q0 + wg * kRows);
  float o[DK / 2];
  zero<DK>(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(&sm.q_full, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % kFwdStages;
    mbar_wait(&sm.full[s], (j / kFwdStages) & 1);
    attend_tile_sm90<DK, M>(o, m, l, sm.q[wg], sm.k[s], sm.v[s], a.logit_mul, [&](int i) {
      const int key = j * kRows + acc_col(i), r = (i >> 1) & 1;
      return a.pack > 1 ? key < valid && key / len == qr[r] / len : key < len;
    });
    mbar_arrive(&sm.empty[s]);
  }

  const int c = a.heads * a.dim;
  float inv[2];
  row_inverse<M>(inv, l);
  bool ok[2];
  bf16* rows[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ok[r] = qr[r] < valid;
    rows[r] = a.out + (long)(row0 + qr[r]) * c + (long)h * a.dim;
    if (M == kStock && ok[r] && t == 0) {
      const int sq = seq + qr[r] / len, i = qr[r] % len;
      a.lse[((long)sq * a.heads + h) * len + i] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
  store_acc<DK>(o, rows[0], rows[1], ok[0], ok[1], inv[0], inv[1], a.dim);
}

template <int DK, int WG, int M>
static int launch_sm90(const CUtensorMap& map, FwdArgs a, cudaStream_t stream) {
  a.tiles = (a.len + sm90::kRows * WG - 1) / (sm90::kRows * WG);
  const int blocks = a.pack > 1 ? (a.n + a.pack - 1) / a.pack : a.n * a.tiles;
  constexpr size_t smem = sizeof(FwdSmem<DK, WG>) + 1024;
  int err = (int)cudaFuncSetAttribute(self_attention_sm90_kernel<DK, WG, M>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  self_attention_sm90_kernel<DK, WG, M>
      <<<dim3(blocks, a.heads), WG * sm90::kWarpgroup + sm90::kProducerThreads, smem, stream>>>(
          map, a);
  return (int)cudaGetLastError();
}

// Two consumer warpgroups share each K/V tile when T > 64 and the grid of
// 128-row tiles still covers the card; one otherwise (always above kernel
// head dim 128).
static int warpgroups_for(int n, int len, int heads, int kernel_dim) {
  const long wide = (long)n * heads * ((len + 2 * sm90::kRows - 1) / (2 * sm90::kRows));
  return kernel_dim <= 128 && len > sm90::kRows && wide >= sm_count() ? 2 : 1;
}

template <int DK, int M>
static int launch_sm90_wg(const CUtensorMap& map, const FwdArgs& a, int wg, cudaStream_t stream) {
  if constexpr (DK <= 128) {
    if (a.pack == 1 && wg == 2) return launch_sm90<DK, 2, M>(map, a, stream);
  }
  return launch_sm90<DK, 1, M>(map, a, stream);
}

// The FwdArgs of a call on one qkv map (pack and logit factor set by the caller).
static FwdArgs fwd_args(void* out, float* lse, int n, int len, int heads, int dim,
                        int head_stride) {
  FwdArgs a;
  a.out = static_cast<bf16*>(out);
  a.lse = lse;
  a.n = n;
  a.len = len;
  a.heads = heads;
  a.dim = dim;
  a.per_head = head_stride != dim;
  a.pack = 1;
  a.tiles = 1;
  a.logit_mul = 0.f;
  return a;
}

static int dispatch_sm90(const void* qkv, void* out, float* lse, int n, int len, int heads,
                         int dim, int kernel_dim, float scale, int head_stride, int k_off,
                         cudaStream_t stream) {
  CUtensorMap map;
  int err = encode_qkv_map(&map, qkv, (long)n * len, heads, dim, head_stride, k_off);
  if (err) return err;
  FwdArgs a = fwd_args(out, lse, n, len, heads, dim, head_stride);
  a.pack = pack_for(n, len, heads);
  a.logit_mul = kLog2e * scale;
  const int wg = warpgroups_for(n, len, heads, kernel_dim);
  switch (kernel_dim) {
    case 32: return launch_sm90_wg<32, kStock>(map, a, wg, stream);
    case 64: return launch_sm90_wg<64, kStock>(map, a, wg, stream);
    case 96: return launch_sm90_wg<96, kStock>(map, a, wg, stream);
    case 128: return launch_sm90_wg<128, kStock>(map, a, wg, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The rows variant at T <= 32: persistent blocks over packed tiles
// ---------------------------------------------------------------------------

// Blocks per SM and the depth of the ring (each stage one tile's Q, K and
// V): three blocks of three stages at DK <= 64 (3 x 73 KB of shared
// memory), two of two at 96 / 128, one of two at 192 / 256 (192 KB).
constexpr int rows_blocks_per_sm(int dk) { return dk <= 64 ? 3 : (dk <= 128 ? 2 : 1); }
constexpr int rows_stages(int dk) { return dk <= 64 ? 3 : 2; }

template <int DK, int S = rows_stages(DK)>
struct RowsSmem {
  static constexpr int kStages = S;
  uint8_t qkv[S][3][sm90::Tile<DK>::kBytes];  // stage s: one tile's q, k, v
  uint64_t full[S], empty[S];
};

struct RowsArgs {
  bf16* out;
  int n, len, heads, dim;
  int pack;       // whole sequences per 64-row tile: floor(64 / T)
  int items;      // tiles x heads: ceil(N / pack) * H
  int per_block;  // items a block walks: blockIdx.x + i * gridDim.x, i < per_block
  float logit_mul;  // scale * log2 e
};

// Work item w: tile w / H (sequences [pack * tile, ...)), head w % H, so
// that the heads of one tile run side by side and read its rows together.
template <int DK>
__global__ void __launch_bounds__(sm90::kWarpgroup + sm90::kProducerThreads,
                                  rows_blocks_per_sm(DK))
    self_attention_rows_sm90_kernel(const __grid_constant__ CUtensorMap qkv_map,
                                    const RowsArgs a) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  RowsSmem<DK>& sm = aligned_smem<RowsSmem<DK>>(smem_raw);
  constexpr int kTileBytes = Tile<DK>::kBytes, kStages = RowsSmem<DK>::kStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kWarpgroup);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWarpgroup) {  // producer warp: one lane issues every copy
    if (threadIdx.x == kWarpgroup) {
      for (int it = 0, w = blockIdx.x; it < a.per_block && w < a.items; ++it, w += gridDim.x) {
        const int s = it % kStages, tile = w / a.heads, h = w - tile * a.heads;
        const int row0 = tile * a.pack * a.len;
        mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 3 * kTileBytes);
        for (int x = 0; x < 3; ++x)  // q, k, v
          load_tile<DK>(sm.qkv[s][x], &qkv_map, &sm.full[s], x, h, 0, row0);
      }
    }
    return;
  }

  // This thread's rows of the tile, and the first row of each one's sequence.
  int rows[2], first[2];
  thread_rows(rows, 0);
  for (int r = 0; r < 2; ++r) first[r] = rows[r] / a.len * a.len;
  const int c = a.heads * a.dim;
  for (int it = 0, w = blockIdx.x; it < a.per_block && w < a.items; ++it, w += gridDim.x) {
    const int s = it % kStages, tile = w / a.heads, h = w - tile * a.heads;
    const int seq = tile * a.pack, valid = min(a.pack, a.n - seq) * a.len;
    float o[DK / 2];
    zero<DK>(o);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    mbar_wait(&sm.full[s], (it / kStages) & 1);
    // A row meets the keys of its own sequence (rows past `valid` are never stored).
    attend_tile_sm90<DK, kVariantRows>(
        o, m, l, sm.qkv[s][0], sm.qkv[s][1], sm.qkv[s][2], a.logit_mul, [&](int i) {
          return (unsigned)(acc_col(i) - first[(i >> 1) & 1]) < (unsigned)a.len;
        });
    mbar_arrive(&sm.empty[s]);

    float inv[2];
    row_inverse<kVariantRows>(inv, l);
    bf16* out_row[2];
    for (int r = 0; r < 2; ++r)
      out_row[r] = a.out + ((long)seq * a.len + rows[r]) * c + (long)h * a.dim;
    store_acc<DK>(o, out_row[0], out_row[1], rows[0] < valid, rows[1] < valid, inv[0], inv[1],
                  a.dim);
  }
}

template <int DK>
static int launch_rows_sm90(const CUtensorMap& map, const RowsArgs& a, int blocks,
                            cudaStream_t stream) {
  constexpr size_t smem = sizeof(RowsSmem<DK>) + 1024;
  int err = (int)cudaFuncSetAttribute(self_attention_rows_sm90_kernel<DK>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  self_attention_rows_sm90_kernel<DK>
      <<<blocks, sm90::kWarpgroup + sm90::kProducerThreads, smem, stream>>>(map, a);
  return (int)cudaGetLastError();
}

template <int DK>
static int rows_occupancy(int* per_sm) {
  constexpr size_t smem = sizeof(RowsSmem<DK>) + 1024;
  int err = (int)cudaFuncSetAttribute(self_attention_rows_sm90_kernel<DK>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, self_attention_rows_sm90_kernel<DK>, sm90::kWarpgroup + sm90::kProducerThreads,
      smem);
}

// A variant on the Hopper kernels.  rows: at pack > 1 the persistent kernel
// on the plan's blocks and tiles per block; at pack == 1 the main path's
// kernel (no lse) on the plan's warpgroups, whose grid must be the plan's
// blocks.  nomax / noexp: the main path's kernel, grid and packing.
template <int DK>
static int launch_variant_sm90(const CUtensorMap& map, FwdArgs a, int variant, float scale,
                               int pack, int blocks, int per_block, int warpgroups,
                               cudaStream_t stream) {
  if (variant == kVariantRows) {
    if (pack > 1) {
      RowsArgs r;
      r.out = a.out;
      r.n = a.n;
      r.len = a.len;
      r.heads = a.heads;
      r.dim = a.dim;
      r.pack = pack;
      r.items = (a.n + pack - 1) / pack * a.heads;
      r.per_block = per_block;
      r.logit_mul = kLog2e * scale;
      if (pack * a.len > sm90::kRows || (long)blocks * per_block < r.items)
        return (int)cudaErrorInvalidValue;
      return launch_rows_sm90<DK>(map, r, blocks, stream);
    }
    const int tiles = (a.len + sm90::kRows * warpgroups - 1) / (sm90::kRows * warpgroups);
    if ((warpgroups != 1 && warpgroups != 2) || blocks != a.n * tiles)
      return (int)cudaErrorInvalidValue;
    a.logit_mul = kLog2e * scale;
    return launch_sm90_wg<DK, kVariantRows>(map, a, warpgroups, stream);
  }
  a.pack = pack_for(a.n, a.len, a.heads);
  const int wg = warpgroups_for(a.n, a.len, a.heads, DK);
  if (variant == kVariantNoMax) {
    a.logit_mul = kLog2e * scale;
    return launch_sm90_wg<DK, kVariantNoMax>(map, a, wg, stream);
  }
  if (variant == kVariantNoExp) {
    a.logit_mul = kNoExpScale * scale;
    return launch_sm90_wg<DK, kVariantNoExp>(map, a, wg, stream);
  }
  return (int)cudaErrorInvalidValue;
}

static int dispatch_variant_sm90(const void* qkv, void* out, int n, int len, int heads, int dim,
                                 int kernel_dim, float scale, int variant, int pack, int blocks,
                                 int per_block, int warpgroups, cudaStream_t stream) {
  CUtensorMap map;
  int err = encode_qkv_map(&map, qkv, (long)n * len, heads, dim, dim, heads * dim);  // thirds
  if (err) return err;
  const FwdArgs a = fwd_args(out, nullptr, n, len, heads, dim, dim);
#define MMDIFF_CASE(DK)                                                                   \
  case DK:                                                                                \
    return launch_variant_sm90<DK>(map, a, variant, scale, pack, blocks, per_block,       \
                                   warpgroups, stream);
  switch (kernel_dim) {
    MMDIFF_CASE(32)
    MMDIFF_CASE(64)
    MMDIFF_CASE(96)
    MMDIFF_CASE(128)
    MMDIFF_CASE(192)
    MMDIFF_CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef MMDIFF_CASE
}

// ---------------------------------------------------------------------------
// The mma.sync design (fp32 inputs)
// ---------------------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    self_attention_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                              float* __restrict__ lse, int len, int heads, int dim,
                              int head_stride, int k_off, int v_off, float scale_log2) {
  __shared__ __align__(16) SharedTiles<D> sm;
  const int n = blockIdx.x, h = blockIdx.y;
  const int c = heads * dim;
  const long stride = 3L * c;
  const T* q = qkv + (long)n * len * stride + (long)h * head_stride;
  const int row0 = blockIdx.z * kBlockQ + (threadIdx.x >> 5) * 16;

  FlashState<D> st;
  load_queries<D, T>(st, q, stride, row0, len, dim);
  attend_sequence<D, T>(st, sm, q + k_off, q + v_off, stride, len, dim, scale_log2);
  store_rows<D, T>(st, out + (long)n * len * c + (long)h * dim, c,
                   lse + ((long)n * heads + h) * len, row0, len, dim);
}

template <int D, typename T>
static int launch(const void* qkv, void* out, float* lse, int n, int len, int heads, int dim,
                  float scale, int head_stride, int k_off, int v_off, cudaStream_t stream) {
  const dim3 grid(n, heads, (len + kBlockQ - 1) / kBlockQ);
  const float scale_log2 = kLog2e * scale;
  self_attention_fwd_kernel<D, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), lse, len, heads, dim, head_stride, k_off,
      v_off, scale_log2);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* qkv, void* out, float* lse, int n, int len, int heads, int dim,
                    int kernel_dim, float scale, int head_stride, int k_off, int v_off,
                    cudaStream_t stream) {
#define MMDIFF_CASE(D)                                                                         \
  case D:                                                                                      \
    return launch<D, T>(qkv, out, lse, n, len, heads, dim, scale, head_stride, k_off, v_off, \
                        stream);
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
// The variants in the mma.sync design (thirds layout, no lse; fp32
// inputs).  What each means is above (Mode); the stock kernel already
// hoists a block's q rows (hoist), multiplies by 1/l (recip) and folds
// log2(e) into the logit scale (exp2), so those names launch the main
// path's kernel and no copy of it is built.  Here rows packs floor(64 / T)
// short sequences into one 64-row query tile of a (ceil(N / pack), H) grid
// at T <= 32, and K and V are staged through registers between two
// __syncthreads, as in the main path's mma.sync design.
// Grid: rows at T <= 32: (ceil(N / pack), H, 1); otherwise (N, H, ceil(T / 64)).

// One staged tile of `keys` valid keys for variant V.  `seg` > 0 masks keys
// outside the query row's own sequence (rows of `seg` tokens packed in the
// tile); `row0` is the warp's first row within the block's query tile.
template <int D, int V>
__device__ __forceinline__ void attend_tile_variant(FlashState<D>& st, const SharedTiles<D>& sm,
                                                    int keys, float scale_log2, float scale,
                                                    int seg, int row0) {
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

  float mx[2] = {-INFINITY, -INFINITY}, rowsum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j * 8 + 2 * t + (e & 1);
      const int row = row0 + g + 8 * (e >> 1);
      const bool ok = key < keys && (seg == 0 || key / seg == row / seg);
      if (V == kVariantNoExp) {
        s[j][e] = ok ? s[j][e] * scale * kNoExpScale : 0.f;
      } else if (V == kVariantNoMax) {
        const float p = ok ? exp2f(fminf(s[j][e] * scale_log2, kNoMaxClampLog2)) : 0.f;
        s[j][e] = p;
        rowsum[e >> 1] += p;
      } else {
        const float x = ok ? s[j][e] * scale_log2 : -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
  }
  if (V == kVariantRows) {
    float alpha[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mnew = fmaxf(st.m[r], mx[r]);
      // A query row past the last packed sequence has no valid key.
      base[r] = mnew == -INFINITY ? 0.f : mnew;
      alpha[r] = exp2f(st.m[r] - base[r]);
      st.m[r] = mnew;
    }
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - base[e >> 1]);
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
  } else if (V == kVariantNoMax) {
#pragma unroll
    for (int r = 0; r < 2; ++r) st.l[r] += rowsum[r];
  }

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

template <int D, typename T, int V>
__global__ void __launch_bounds__(kThreads)
    self_attention_variant_kernel(const T* __restrict__ qkv, T* __restrict__ out, int n, int len,
                                  int heads, int dim, int pack, float scale_log2, float scale) {
  __shared__ __align__(16) SharedTiles<D> sm;
  const int h = blockIdx.y;
  const int c = heads * dim;
  const long stride = 3L * c;
  const int seq0 = blockIdx.x * pack;
  // pack > 1: rows [0, rows) of the block are `pack` whole sequences, one
  // key tile; pack == 1: one sequence, query tile blockIdx.z.
  const int rows = min(pack, n - seq0) * len;
  const int seg = pack > 1 ? len : 0;
  const int row0 = blockIdx.z * kBlockQ + (threadIdx.x >> 5) * 16;
  const T* q = qkv + (long)seq0 * len * stride + (long)h * dim;

  FlashState<D> st;
  load_queries<D, T>(st, q, stride, row0, rows, dim);
  for (int k0 = 0; k0 < rows; k0 += kBlockK) {
    const int keys = min(kBlockK, rows - k0);
    stage_kv<D, T>(sm, q + c + k0 * stride, q + 2 * c + k0 * stride, stride, keys, dim);
    __syncthreads();
    attend_tile_variant<D, V>(st, sm, keys, scale_log2, scale, seg, row0);
    __syncthreads();
  }

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float inv[2] = {1.f, 1.f};
  if (V != kVariantNoExp) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = st.l[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = 1.f / l;
    }
  }
  T* o = out + (long)seq0 * len * c + (long)h * dim;
  const int r0 = row0 + g, r1 = row0 + g + 8;
#pragma unroll
  for (int nn = 0; nn < D / 8; ++nn) {
    const int col = nn * 8 + 2 * t;
    if (col >= dim) continue;
    if (r0 < rows) Io<T>::store_pair(o + r0 * (long)c + col, st.o[nn][0] * inv[0], st.o[nn][1] * inv[0]);
    if (r1 < rows) Io<T>::store_pair(o + r1 * (long)c + col, st.o[nn][2] * inv[1], st.o[nn][3] * inv[1]);
  }
}

template <int D, typename T, int V>
static int launch_variant(const void* qkv, void* out, int n, int len, int heads, int dim,
                          float scale, cudaStream_t stream) {
  const int pack = (V == kVariantRows && len <= kBlockQ / 2) ? kBlockQ / len : 1;
  const dim3 grid = pack > 1 ? dim3((n + pack - 1) / pack, heads, 1)
                             : dim3(n, heads, (len + kBlockQ - 1) / kBlockQ);
  self_attention_variant_kernel<D, T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), n, len, heads, dim, pack, kLog2e * scale,
      scale);
  return (int)cudaGetLastError();
}

template <int D, typename T>
static int dispatch_variant_mode(const void* qkv, void* out, int n, int len, int heads, int dim,
                                 float scale, int variant, cudaStream_t s) {
#define MMDIFF_CASE(V) \
  case V: return launch_variant<D, T, V>(qkv, out, n, len, heads, dim, scale, s);
  switch (variant) {
    MMDIFF_CASE(kVariantRows)
    MMDIFF_CASE(kVariantNoMax)
    MMDIFF_CASE(kVariantNoExp)
    default: return (int)cudaErrorInvalidValue;
  }
#undef MMDIFF_CASE
}

template <typename T>
static int dispatch_variant(const void* qkv, void* out, int n, int len, int heads, int dim,
                            int kernel_dim, float scale, int variant, cudaStream_t s) {
  switch (kernel_dim) {
    case 32: return dispatch_variant_mode<32, T>(qkv, out, n, len, heads, dim, scale, variant, s);
    case 64: return dispatch_variant_mode<64, T>(qkv, out, n, len, heads, dim, scale, variant, s);
    case 96: return dispatch_variant_mode<96, T>(qkv, out, n, len, heads, dim, scale, variant, s);
    case 128: return dispatch_variant_mode<128, T>(qkv, out, n, len, heads, dim, scale, variant, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mmdiff

static bool head_dim_fits(int head_dim, int kernel_dim) {
  return head_dim % 8 == 0 && head_dim >= 8 && head_dim <= kernel_dim;
}

// Head h reads q at h*head_stride, k at h*head_stride + k_off and v at
// h*head_stride + v_off within each row of 3*heads*head_dim elements:
//   thirds:   head_stride = D,   k_off = C, v_off = 2C
//   per_head: head_stride = 3D,  k_off = D, v_off = 2D
// `head_dim` runs on the kernel built for `kernel_dim`
// (ops/block_attention.py::kernel_head_dim), with the logit scale `scale`
// (1/sqrt(d) of the caller's real head dim d, which may be below a
// zero-padded `head_dim`).  bf16 takes the Hopper kernel
// (qkv 16-byte aligned), fp32 the mma.sync design.  Returns the launch's
// CUDA error (0 on success).
extern "C" int mmdiff_self_attention_fwd(const void* qkv, void* out, float* lse, int n, int len,
                                         int heads, int head_dim, int kernel_dim, float scale,
                                         int head_stride, int k_off, int v_off, int is_fp32,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!head_dim_fits(head_dim, kernel_dim)) return (int)cudaErrorInvalidValue;
  if (is_fp32)
    return mmdiff::dispatch<float>(qkv, out, lse, n, len, heads, head_dim, kernel_dim, scale,
                                   head_stride, k_off, v_off, s);
  return mmdiff::dispatch_sm90(qkv, out, lse, n, len, heads, head_dim, kernel_dim, scale,
                               head_stride, k_off, s);
}

// The variants over thirds-layout qkv [N, T, 3C] -> out [N, T, C], at the
// logit scale `scale`; variant 1 = rows, 2 = nomax, 3 = noexp.  bf16 runs
// the Hopper kernels (kernel head dims 32-256; qkv 16-byte aligned), fp32
// the mma.sync design (32-128).  rows takes the launch plan of
// ops/block_attention.py::rows_launch_plan: `pack` sequences per 64-row
// tile, `blocks`, `per_block` tiles a block and `warpgroups` (bf16 only; the
// other variants ignore them).  Returns the launch's CUDA error (0 on
// success).
extern "C" int mmdiff_self_attention_variant_fwd(const void* qkv, void* out, int n, int len,
                                                 int heads, int head_dim, int kernel_dim,
                                                 float scale, int variant, int pack, int blocks,
                                                 int per_block, int warpgroups, int is_fp32,
                                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!head_dim_fits(head_dim, kernel_dim)) return (int)cudaErrorInvalidValue;
  if (is_fp32)
    return mmdiff::dispatch_variant<float>(qkv, out, n, len, heads, head_dim, kernel_dim, scale,
                                           variant, s);
  return mmdiff::dispatch_variant_sm90(qkv, out, n, len, heads, head_dim, kernel_dim, scale,
                                       variant, pack, blocks, per_block, warpgroups, s);
}

// Resident blocks per SM of the persistent rows kernel at `kernel_dim` on
// the current device (the plan's blocks_per_sm), or -1 on a CUDA error.
extern "C" int mmdiff_self_attention_rows_blocks_per_sm(int kernel_dim) {
  int per_sm = 0, err;
  switch (kernel_dim) {
    case 32: err = mmdiff::rows_occupancy<32>(&per_sm); break;
    case 64: err = mmdiff::rows_occupancy<64>(&per_sm); break;
    case 96: err = mmdiff::rows_occupancy<96>(&per_sm); break;
    case 128: err = mmdiff::rows_occupancy<128>(&per_sm); break;
    case 192: err = mmdiff::rows_occupancy<192>(&per_sm); break;
    case 256: err = mmdiff::rows_occupancy<256>(&per_sm); break;
    default: return -1;
  }
  return err ? -1 : per_sm;
}
