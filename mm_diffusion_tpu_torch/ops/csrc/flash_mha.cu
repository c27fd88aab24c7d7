// Flash multi-head attention over strided [B, H, T, D] operands, forward and
// backward: out = softmax(Q K^T / sqrt(D)) V per (batch, head), Tq != Tk
// allowed, plus the per-row logsumexp [B, H, Tq] (fp32, natural log) that
// the backward reuses.
//
// Replaces the TPU flash kernel of JAX's library that
// mm_diffusion_tpu/ops/fused_attention.py reaches through `flash_mha_bhtd`
// (:69): jax/experimental/pallas/ops/tpu/flash_attention.py, the forward
// `pallas_call` (:758) and the backward's dkv (:1121) and dq (:1456) kernels
// behind its custom VJP (:254).
//
// What bounds it on this card: at the API's hot shapes (B*F = 128 rows, 4
// heads, head dim 64, T = 1024) the forward is 137 GFLOP against 0.13 GB of
// operands, so the tensor cores bound it (0.139 ms at 989 TFLOP/s), and the
// backward's five [Tq, Tk] products (344 GFLOP, 0.347 ms) too; at Tq = 100
// or Tk = 400 they approach the bytes bound.  Every design keeps the [Tq,
// Tk] logits out of device memory (online softmax over 64-key tiles; the
// backward recomputes P from the forward's logsumexp), reads q, k and v in
// place through their (batch, head, row) strides -- so [B, T, H, D]
// (`flash_mha`) and [B, H, T, D] (`flash_mha_bhtd`) go through the same
// kernels with no transpose copy, and the gradients are written in the
// caller's strides -- and masks the ragged ends of Tq and Tk in the kernel
// instead of padding them to 128 in device memory as the TPU path does.
//
// The Hopper designs, bf16 at kernel head dims 32-128 (attention_sm90.cuh),
// read every operand through one 4-D tensor map, {D, and batch, head, row
// in order of stride} (encode_rows_map), so T is a map dimension of its own
// and TMA zero-fills rows past Tq or Tk inside each (batch, head), never
// another head's rows.
//   forward   K1's Hopper forward over strided operands: a producer warp
//             streams 64-key K and V boxes through a 2-stage mbarrier ring;
//             S = Q K^T and O += P V run on wgmma with the online softmax on
//             the accumulators; keys past Tk are set to -inf in the last key
//             tile only; two consumer warpgroups (128 query rows) share each
//             K/V box where that grid still covers the card.  Grid (B *
//             ceil(Tq / (64 WG)), H).
//   backward  K4/K5's two passes (self_attention_bwd.cu) with the tile
//             products of attention_sm90.cuh: a dq pass, whose block owns 64
//             query rows of one (b, h) -- Q and dO once by TMA, a producer
//             warp streaming 64-key K and V tiles, keys past Tk masked in
//             the last tile -- and writes delta = rowsum(dO * O); then a dkv
//             pass, whose block owns 64 keys -- K and V kept in shared
//             memory, the producer streaming Q and dO tiles with their lse
//             and delta, loaded a tile ahead (rows past Tq take lse = +inf,
//             so P = 0 there).  Every gradient is summed in registers by the
//             one block that owns its rows (no float atomics, the same result
//             on every run).  Grids (B * ceil(Tq / 64), H) and (B * ceil(Tk
//             / 64), H), 160 threads (a consumer warpgroup and the producer
//             warp).
//
// The mma.sync design (attention_common.cuh and attention_bwd_common.cuh;
// mmdiff_flash_mha_fwd_mma, mmdiff_flash_mha_bwd_mma) runs fp32 and kernel
// head dims 192 and 256: K and V staged through registers with no load
// in flight during the products, two __syncthreads per 64-key tile, V
// transposed with scalar stores, m16n8k16 products; the backward is the
// same two-pass form, deterministic too.  Grids: (ceil(Tq / 64), H, B) for
// the forward and the dq pass, (ceil(Tk / 64), H, B) for the dk/dv pass;
// 128 threads per block.
//
// Head dims: every D with D % 8 == 0 up to 256 (JAX's flash gate), on the
// kernels built for 32, 64, 96, 128, 192 and 256 (ops/fused_attention.py::
// kernel_head_dim); lanes past D are zero-filled and never stored.  At 192
// and 256 the per-warp fragments outgrow the register file and spill (see
// PERF.md), and the forward's K/V tiles (above 48 KB) take dynamic shared
// memory.

#include <type_traits>

#include "attention_bwd_common.cuh"
#include "attention_sm90.cuh"

namespace mmdiff {

// Element strides of one [B, H, T, D] operand (D is contiguous).
struct Strides {
  long long b, h, t;
};

// ---------------------------------------------------------------------------
// The Hopper forward (bf16, kernel head dims 32-128)
// ---------------------------------------------------------------------------

constexpr int kFlashStages = 2;  // depth of the K/V ring

// Where (batch, head, row) sit among dims 1-3 of an operand's tensor map:
// the three in order of their strides (dim 0 is the head dim).
struct MapAxes {
  int b, h, t;
};

template <int DK, int WG>
struct FlashFwdSmem {
  uint8_t q[WG][sm90::Tile<DK>::kBytes];
  uint8_t k[kFlashStages][sm90::Tile<DK>::kBytes];
  uint8_t v[kFlashStages][sm90::Tile<DK>::kBytes];
  uint64_t q_full;
  uint64_t full[kFlashStages];
  uint64_t empty[kFlashStages];
};

struct FlashFwdArgs {
  bf16* out;
  float* lse;
  int heads, len_q, len_k, dim;
  int tiles;  // query tiles of 64 * WG rows per (batch, head)
  Strides so;
  MapAxes qa, ka;  // axes of q's map, and of k's and v's
  float scale_log2;
};

// All DK / 32 chunks of the 64-row box at row `row` of (b, h).
template <int DK>
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                          MapAxes ax, int b, int h, int row) {
  int c[4];
#pragma unroll
  for (int i = 1; i < 4; ++i) c[i] = ax.b == i ? b : (ax.h == i ? h : row);
#pragma unroll
  for (int j = 0; j < sm90::Tile<DK>::kChunks; ++j)
    sm90::tma_load(dst + j * sm90::kChunkBytes, map, bar, j * sm90::kChunk, c[1], c[2], c[3]);
}

// Block (b * tiles + tile, h): query rows [64 WG tile, 64 WG (tile + 1))
// of (b, h) against all of its keys.  Q, K and V reach shared memory by
// TMA; rows past Tq or Tk are zero-filled by the maps, keys past Tk are
// masked in the last key tile only, rows past Tq are not stored.
template <int DK, int WG>
__global__ void __launch_bounds__(WG * sm90::kWarpgroup + sm90::kProducerThreads,
                                  DK <= 64 ? 2 : 1)
    flash_mha_fwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map, const FlashFwdArgs a) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  FlashFwdSmem<DK, WG>& sm = aligned_smem<FlashFwdSmem<DK, WG>>(smem_raw);
  constexpr int kTileBytes = Tile<DK>::kBytes;
  const int h = blockIdx.y, b = blockIdx.x / a.tiles;
  const int q0 = (blockIdx.x - b * a.tiles) * (kRows * WG);
  const int len_k = a.len_k, ntiles = (len_k + kRows - 1) / kRows, nfull = len_k / kRows;
  const float scale_log2 = a.scale_log2;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kFlashStages; ++s) {
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
        load_rows<DK>(sm.q[w], &q_map, &sm.q_full, a.qa, b, h, q0 + w * kRows);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kFlashStages;
        mbar_wait(&sm.empty[s], ((j / kFlashStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * kTileBytes);
        load_rows<DK>(sm.k[s], &k_map, &sm.full[s], a.ka, b, h, j * kRows);
        load_rows<DK>(sm.v[s], &v_map, &sm.full[s], a.ka, b, h, j * kRows);
      }
    }
    return;
  }

  // Consumer warpgroup wg: query rows q0 + 64 wg + [0, 64); this thread
  // holds rows qr[0] and qr[1].
  const int wg = warp >> 2, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r_lo = q0 + wg * kRows + (warp & 3) * 16 + g;
  const int qr[2] = {r_lo, r_lo + 8};
  float o[DK / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // One 64-key tile j; `masked` (the last tile when Tk % 64 != 0) sets the
  // logits of keys at or past Tk to -inf.
  auto attend = [&](int j, auto masked) {
    const int s = j % kFlashStages;
    mbar_wait(&sm.full[s], (j / kFlashStages) & 1);
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      wgmma_ss_n64(sc, desc_k(sm.q[wg], kk), desc_k(sm.k[s], kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if constexpr (decltype(masked)::value) {
        const int key = j * kRows + acc_col(i);
        sc[i] = key < len_k ? sc[i] * scale_log2 : -INFINITY;
      } else {
        sc[i] *= scale_log2;
      }
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
    float base[2], alpha[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mnew = fmaxf(m[r], mx[r]);
      base[r] = mnew == -INFINITY ? 0.f : mnew;
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

    uint32_t pa[4][4];
    acc_to_a(pa, sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<DK>(o, pa[kk], desc_mn(sm.v[s], kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&sm.empty[s]);
  };

  mbar_wait(&sm.q_full, 0);
  for (int j = 0; j < nfull; ++j) attend(j, std::false_type{});
  if (nfull < ntiles) attend(nfull, std::true_type{});

  float inv[2];
  bool ok[2];
  bf16* rows[2];
  const long base_o = (long)b * a.so.b + (long)h * a.so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
    ok[r] = qr[r] < a.len_q;
    rows[r] = a.out + base_o + (long)qr[r] * a.so.t;
    if (ok[r] && t == 0)
      a.lse[((long)b * a.heads + h) * a.len_q + qr[r]] = (m[r] + log2f(l[r])) * kLn2;
  }
  store_acc<DK>(o, rows[0], rows[1], ok[0], ok[1], inv[0], inv[1], a.dim);
}

// The map {D, and batch, head, row in order of stride} of one operand, boxes
// of 32 lanes x 64 rows; `ax` receives where batch, head and row sit.  An
// axis of extent 1 goes first and gets the stride that continues the one
// below it (its stride is never stepped), so the strides grow with the dims.
static int encode_rows_map(CUtensorMap* map, MapAxes* ax, const void* base, int dim, int batch,
                           int heads, int len, Strides s) {
  struct Axis {
    long n, stride;
    int role;  // 0 batch, 1 head, 2 row
  } axes[3] = {{batch, (long)s.b, 0}, {heads, (long)s.h, 1}, {len, (long)s.t, 2}};
  auto key = [](const Axis& x) { return x.n == 1 ? 0L : x.stride; };
  for (int i = 1; i < 3; ++i)  // insertion sort by stride
    for (int j = i; j > 0 && key(axes[j]) < key(axes[j - 1]); --j) {
      const Axis tmp = axes[j];
      axes[j] = axes[j - 1];
      axes[j - 1] = tmp;
    }
  long gdim[4] = {dim, 0, 0, 0}, strides[3], below = dim;
  int box[4] = {sm90::kChunk, 1, 1, 1}, pos[3];
  for (int i = 0; i < 3; ++i) {
    if (axes[i].n == 1) axes[i].stride = below;
    below = axes[i].n * axes[i].stride;
    gdim[i + 1] = axes[i].n;
    strides[i] = axes[i].stride;
    pos[axes[i].role] = i + 1;
    if (axes[i].role == 2) box[i + 1] = sm90::kRows;
  }
  *ax = MapAxes{pos[0], pos[1], pos[2]};
  return encode_map_4d(map, base, gdim, strides, box);
}

template <int DK, int WG>
static int launch_fwd_sm90(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                           FlashFwdArgs a, int batch, cudaStream_t stream) {
  a.tiles = (a.len_q + sm90::kRows * WG - 1) / (sm90::kRows * WG);
  constexpr size_t smem = sizeof(FlashFwdSmem<DK, WG>) + 1024;
  int err = (int)cudaFuncSetAttribute(flash_mha_fwd_sm90_kernel<DK, WG>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  flash_mha_fwd_sm90_kernel<DK, WG>
      <<<dim3(batch * a.tiles, a.heads), WG * sm90::kWarpgroup + sm90::kProducerThreads, smem,
         stream>>>(qm, km, vm, a);
  return (int)cudaGetLastError();
}

// Two consumer warpgroups share each K/V tile when Tq > 64 and the grid of
// 128-row tiles still covers the card; one otherwise (K1's rule).
template <int DK>
static int launch_fwd_sm90_rows(const CUtensorMap& qm, const CUtensorMap& km,
                                const CUtensorMap& vm, const FlashFwdArgs& a, int batch,
                                cudaStream_t stream) {
  const long wide = (long)batch * a.heads * ((a.len_q + 2 * sm90::kRows - 1) / (2 * sm90::kRows));
  if (a.len_q > sm90::kRows && wide >= sm_count())
    return launch_fwd_sm90<DK, 2>(qm, km, vm, a, batch, stream);
  return launch_fwd_sm90<DK, 1>(qm, km, vm, a, batch, stream);
}

static int dispatch_fwd_sm90(const void* q, const void* k, const void* v, void* out, float* lse,
                             int batch, int heads, int len_q, int len_k, int head_dim,
                             int kernel_dim, float scale, Strides sq, Strides sk, Strides so,
                             cudaStream_t stream) {
  if (head_dim % 8 || head_dim < 8 || head_dim > kernel_dim) return (int)cudaErrorInvalidValue;
  FlashFwdArgs a;
  CUtensorMap qm, km, vm;
  int err = encode_rows_map(&qm, &a.qa, q, head_dim, batch, heads, len_q, sq);
  if (!err) err = encode_rows_map(&km, &a.ka, k, head_dim, batch, heads, len_k, sk);
  MapAxes va;
  if (!err) err = encode_rows_map(&vm, &va, v, head_dim, batch, heads, len_k, sk);
  if (err) return err;
  a.out = static_cast<bf16*>(out);
  a.lse = lse;
  a.heads = heads;
  a.len_q = len_q;
  a.len_k = len_k;
  a.dim = head_dim;
  a.tiles = 1;
  a.so = so;
  a.scale_log2 = kLog2e * scale;
  switch (kernel_dim) {
    case 32: return launch_fwd_sm90_rows<32>(qm, km, vm, a, batch, stream);
    case 64: return launch_fwd_sm90_rows<64>(qm, km, vm, a, batch, stream);
    case 96: return launch_fwd_sm90_rows<96>(qm, km, vm, a, batch, stream);
    case 128: return launch_fwd_sm90_rows<128>(qm, km, vm, a, batch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The Hopper backward (bf16, kernel head dims 32-128)
// ---------------------------------------------------------------------------

constexpr int kFlashBwdStages = 2;  // depth of the K/V (dq pass) and Q/dO (dkv pass) rings

struct FlashBwdArgs {
  const bf16* out;
  const bf16* dout;
  const float* lse;
  float* delta;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int heads, len_q, len_k, dim;
  int q_tiles, k_tiles;  // 64-row tiles of q and of k per (batch, head)
  Strides sq, sk, so;    // dq has q's strides, dk and dv k's, dout out's
  MapAxes qa, ka, oa;    // axes of q's map, of k's and v's, of dout's
  float scale_log2, scale;
};

// [B, H, Tq] index (lse, delta) of query row x of (b, h).
__device__ __forceinline__ long lse_index(const FlashBwdArgs& a, int b, int h, int x) {
  return ((long)b * a.heads + h) * a.len_q + x;
}

template <int DK>
struct FlashDqSmem {
  uint8_t q[sm90::Tile<DK>::kBytes];
  uint8_t go[sm90::Tile<DK>::kBytes];
  uint8_t k[kFlashBwdStages][sm90::Tile<DK>::kBytes];
  uint8_t v[kFlashBwdStages][sm90::Tile<DK>::kBytes];
  uint64_t q_full, full[kFlashBwdStages], empty[kFlashBwdStages];
};

// The dq pass.  Block (b * q_tiles + tile, h): query rows [64 tile, 64 tile
// + 64) of (b, h) against every key tile.  Q and dO come once by TMA, the
// producer warp streams 64-key K and V tiles; rows past Tq and Tk are
// zero-filled by the maps (T is a dimension of its own), keys past Tk are
// masked in the last key tile only, rows past Tq are not stored.  Writes
// delta = rowsum(dO * O) for the dkv pass.
template <int DK>
__global__ void __launch_bounds__(sm90::kWarpgroup + sm90::kProducerThreads, 1)
    flash_mha_bwd_dq_sm90(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map, const FlashBwdArgs a) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  FlashDqSmem<DK>& sm = aligned_smem<FlashDqSmem<DK>>(smem_raw);
  constexpr int kTileBytes = Tile<DK>::kBytes;
  const int h = blockIdx.y, b = blockIdx.x / a.q_tiles;
  const int q0 = (blockIdx.x - b * a.q_tiles) * kRows;
  const int ntiles = a.k_tiles, nfull = a.len_k / kRows;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kFlashBwdStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kWarpgroup);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWarpgroup) {  // producer warp: one lane issues every copy
    if (threadIdx.x == kWarpgroup) {
      mbar_expect_tx(&sm.q_full, 2 * kTileBytes);
      load_rows<DK>(sm.q, &q_map, &sm.q_full, a.qa, b, h, q0);
      load_rows<DK>(sm.go, &do_map, &sm.q_full, a.oa, b, h, q0);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kFlashBwdStages;
        mbar_wait(&sm.empty[s], ((j / kFlashBwdStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * kTileBytes);
        load_rows<DK>(sm.k[s], &k_map, &sm.full[s], a.ka, b, h, j * kRows);
        load_rows<DK>(sm.v[s], &v_map, &sm.full[s], a.ka, b, h, j * kRows);
      }
    }
    return;
  }

  // This thread's query rows qr[r]: whether each is real, its logsumexp in
  // base 2, and delta = rowsum(dO * O) (also written for the dkv pass).
  int qr[2];
  thread_rows(qr, q0);
  bool ok[2];
  float lse2[2], delta[2];
  const int t = threadIdx.x & 3;
  const long base_o = (long)b * a.so.b + (long)h * a.so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ok[r] = qr[r] < a.len_q;
    float acc = 0.f;
    if (ok[r]) {
      const long off = base_o + (long)qr[r] * a.so.t;
      for (int col = 2 * t; col < a.dim; col += 8) {
        const float2 o = Load2<bf16>::get(a.out + off + col);
        const float2 d = Load2<bf16>::get(a.dout + off + col);
        acc += o.x * d.x + o.y * d.y;
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    delta[r] = acc;
    const long idx = lse_index(a, b, h, qr[r]);
    lse2[r] = ok[r] ? a.lse[idx] * kLog2e : 0.f;
    if (ok[r] && t == 0) a.delta[idx] = acc;
  }

  float dq[DK / 2];
  zero<DK>(dq);
  mbar_wait(&sm.q_full, 0);
  auto tile = [&](int j, auto masked) {
    const int s = j % kFlashBwdStages;
    mbar_wait(&sm.full[s], (j / kFlashBwdStages) & 1);
    dq_products<DK>(dq, sm.q, sm.go, sm.k[s], sm.v[s], lse2, delta, a.scale_log2, a.scale,
                    [&](int key, int) {
                      return !decltype(masked)::value || j * kRows + key < a.len_k;
                    });
    mbar_arrive(&sm.empty[s]);
  };
  for (int j = 0; j < nfull; ++j) tile(j, std::false_type{});
  if (nfull < ntiles) tile(nfull, std::true_type{});

  const long base_q = (long)b * a.sq.b + (long)h * a.sq.h;
  store_acc<DK>(dq, a.dq + base_q + (long)qr[0] * a.sq.t, a.dq + base_q + (long)qr[1] * a.sq.t,
                ok[0], ok[1], 1.f, 1.f, a.dim);
}

template <int DK>
struct FlashDkvSmem {
  uint8_t k[sm90::Tile<DK>::kBytes];
  uint8_t v[sm90::Tile<DK>::kBytes];
  uint8_t q[kFlashBwdStages][sm90::Tile<DK>::kBytes];
  uint8_t go[kFlashBwdStages][sm90::Tile<DK>::kBytes];
  float lse2[kFlashBwdStages][sm90::kRows];  // the query tile's logsumexp, base 2 (+inf: no row)
  float delta[kFlashBwdStages][sm90::kRows];
  uint64_t kv_full, full[kFlashBwdStages], empty[kFlashBwdStages];
};

// The dkv pass.  Block (b * k_tiles + tile, h): keys [64 tile, 64 tile +
// 64) of (b, h), whose K and V tiles stay in shared memory, against every
// query tile, which the producer warp streams with its lse and delta (rows
// past Tq: lse = +inf, so P = 0 there, and never another head's rows).
template <int DK>
__global__ void __launch_bounds__(sm90::kWarpgroup + sm90::kProducerThreads, 1)
    flash_mha_bwd_dkv_sm90(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map, const FlashBwdArgs a) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  FlashDkvSmem<DK>& sm = aligned_smem<FlashDkvSmem<DK>>(smem_raw);
  constexpr int kTileBytes = Tile<DK>::kBytes;
  const int h = blockIdx.y, b = blockIdx.x / a.k_tiles;
  const int k0 = (blockIdx.x - b * a.k_tiles) * kRows;
  const int ntiles = a.q_tiles;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kFlashBwdStages; ++s) {
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
      load_rows<DK>(sm.k, &k_map, &sm.kv_full, a.ka, b, h, k0);
      load_rows<DK>(sm.v, &v_map, &sm.kv_full, a.ka, b, h, k0);
    }
    // Query rows lane and lane + 32 of a tile: their lse (base 2, +inf past
    // Tq) and delta, loaded one tile ahead of the stage they go to.
    float lse2[2], dlt[2];
    auto fetch = [&](int j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int x = j * kRows + lane + 32 * i;  // query row of (b, h)
        const bool real = x < a.len_q;
        const long idx = real ? lse_index(a, b, h, x) : 0;
        lse2[i] = real ? a.lse[idx] * kLog2e : INFINITY;
        dlt[i] = real ? a.delta[idx] : 0.f;
      }
    };
    fetch(0);
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % kFlashBwdStages;
      mbar_wait(&sm.empty[s], ((j / kFlashBwdStages) & 1) ^ 1);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sm.lse2[s][lane + 32 * i] = lse2[i];
        sm.delta[s][lane + 32 * i] = dlt[i];
      }
      if (lane == 0) {  // its arrival (with the copies' bytes) follows its own stores
        mbar_expect_tx(&sm.full[s], 2 * kTileBytes);
        load_rows<DK>(sm.q[s], &q_map, &sm.full[s], a.qa, b, h, j * kRows);
        load_rows<DK>(sm.go[s], &do_map, &sm.full[s], a.oa, b, h, j * kRows);
      } else {
        mbar_arrive(&sm.full[s]);
      }
      if (j + 1 < ntiles) fetch(j + 1);
    }
    return;
  }

  int kr[2];
  thread_rows(kr, k0);
  float dk[DK / 2], dv[DK / 2];
  zero<DK>(dk);
  zero<DK>(dv);
  mbar_wait(&sm.kv_full, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % kFlashBwdStages;
    mbar_wait(&sm.full[s], (j / kFlashBwdStages) & 1);
    dkv_products<DK>(dk, dv, sm.k, sm.v, sm.q[s], sm.go[s], sm.lse2[s], sm.delta[s],
                     a.scale_log2, a.scale, [](int, int) { return true; });
    mbar_arrive(&sm.empty[s]);
  }
  const bool ok[2] = {kr[0] < a.len_k, kr[1] < a.len_k};
  const long base_k = (long)b * a.sk.b + (long)h * a.sk.h;
  bf16* rows_k[2] = {a.dk + base_k + (long)kr[0] * a.sk.t, a.dk + base_k + (long)kr[1] * a.sk.t};
  bf16* rows_v[2] = {a.dv + base_k + (long)kr[0] * a.sk.t, a.dv + base_k + (long)kr[1] * a.sk.t};
  store_acc<DK>(dk, rows_k[0], rows_k[1], ok[0], ok[1], 1.f, 1.f, a.dim);
  store_acc<DK>(dv, rows_v[0], rows_v[1], ok[0], ok[1], 1.f, 1.f, a.dim);
}

template <int DK>
static int launch_bwd_sm90(const CUtensorMap (&maps)[4], const FlashBwdArgs& a, int batch,
                           cudaStream_t stream) {
  constexpr int kThreads90 = sm90::kWarpgroup + sm90::kProducerThreads;
  constexpr size_t dq_smem = sizeof(FlashDqSmem<DK>) + 1024;
  int err = set_dynamic_smem(flash_mha_bwd_dq_sm90<DK>, dq_smem);
  if (err) return err;
  flash_mha_bwd_dq_sm90<DK><<<dim3(batch * a.q_tiles, a.heads), kThreads90, dq_smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  err = (int)cudaGetLastError();
  if (err) return err;
  constexpr size_t dkv_smem = sizeof(FlashDkvSmem<DK>) + 1024;
  err = set_dynamic_smem(flash_mha_bwd_dkv_sm90<DK>, dkv_smem);
  if (err) return err;
  flash_mha_bwd_dkv_sm90<DK><<<dim3(batch * a.k_tiles, a.heads), kThreads90, dkv_smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  return (int)cudaGetLastError();
}

static int dispatch_bwd_sm90(const void* q, const void* k, const void* v, const void* out,
                             const void* dout, const float* lse, float* delta, void* dq, void* dk,
                             void* dv, int batch, int heads, int len_q, int len_k, int head_dim,
                             int kernel_dim, float scale, Strides sq, Strides sk, Strides so,
                             cudaStream_t stream) {
  if (head_dim % 8 || head_dim < 8 || head_dim > kernel_dim) return (int)cudaErrorInvalidValue;
  FlashBwdArgs a;
  CUtensorMap maps[4];  // q, k, v, dout
  MapAxes va;
  int err = encode_rows_map(&maps[0], &a.qa, q, head_dim, batch, heads, len_q, sq);
  if (!err) err = encode_rows_map(&maps[1], &a.ka, k, head_dim, batch, heads, len_k, sk);
  if (!err) err = encode_rows_map(&maps[2], &va, v, head_dim, batch, heads, len_k, sk);
  if (!err) err = encode_rows_map(&maps[3], &a.oa, dout, head_dim, batch, heads, len_q, so);
  if (err) return err;
  a.out = static_cast<const bf16*>(out);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = lse;
  a.delta = delta;
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.heads = heads;
  a.len_q = len_q;
  a.len_k = len_k;
  a.dim = head_dim;
  a.q_tiles = (len_q + sm90::kRows - 1) / sm90::kRows;
  a.k_tiles = (len_k + sm90::kRows - 1) / sm90::kRows;
  a.sq = sq;
  a.sk = sk;
  a.so = so;
  a.scale = scale;
  a.scale_log2 = kLog2e * scale;
  switch (kernel_dim) {
    case 32: return launch_bwd_sm90<32>(maps, a, batch, stream);
    case 64: return launch_bwd_sm90<64>(maps, a, batch, stream);
    case 96: return launch_bwd_sm90<96>(maps, a, batch, stream);
    case 128: return launch_bwd_sm90<128>(maps, a, batch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The mma.sync design: fp32 and kernel head dims 192 / 256; forward and
// backward
// ---------------------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                         int heads, int len_q, int len_k, int dim, Strides sq, Strides sk,
                         Strides so, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  SharedTiles<D>& sm = *reinterpret_cast<SharedTiles<D>*>(smem);
  const int b = blockIdx.z, h = blockIdx.y;
  const long qo = b * sq.b + h * sq.h, ko = b * sk.b + h * sk.h, oo = b * so.b + h * so.h;
  const int row0 = blockIdx.x * kBlockQ + (threadIdx.x >> 5) * 16;

  FlashState<D> st;
  load_queries<D, T>(st, q + qo, sq.t, row0, len_q, dim);
  attend_sequence<D, T>(st, sm, k + ko, v + ko, sk.t, len_k, dim, scale_log2);
  store_rows<D, T>(st, out + oo, so.t, lse + ((long)b * heads + h) * len_q, row0, len_q, dim);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_mha_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ out,
                            const T* __restrict__ dout, const float* __restrict__ lse,
                            float* __restrict__ delta, T* __restrict__ dq, int heads, int len_q,
                            int len_k, int dim, Strides sq, Strides sk, Strides so,
                            float scale_log2, float scale) {
  __shared__ __align__(16) unsigned short sk_tile[kBwdTile * (D + kPadK)];
  __shared__ __align__(16) unsigned short sv_tile[kBwdTile * (D + kPadK)];
  const int b = blockIdx.z, h = blockIdx.y;
  const long qo = b * sq.b + h * sq.h, ko = b * sk.b + h * sk.h, oo = b * so.b + h * so.h;
  const long ro = ((long)b * heads + h) * len_q;
  const int row0 = blockIdx.x * kBlockQ + (threadIdx.x >> 5) * 16;

  DqState<D> st;
  dq_begin<D, T>(st, q + qo, sq.t, out + oo, dout + oo, so.t, lse + ro, delta + ro, row0, len_q,
                 dim);
  dq_sequence<D, T>(st, sk_tile, sv_tile, k + ko, v + ko, sk.t, len_k, dim, scale_log2, scale);
  store_frags<D, T>(st.dq, dq + qo, sq.t, row0, len_q, dim);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_mha_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             T* __restrict__ dk, T* __restrict__ dv, int heads, int len_q,
                             int len_k, int dim, Strides sq, Strides sk, Strides so,
                             float scale_log2, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DkvSmem<D> sm(smem);
  const int b = blockIdx.z, h = blockIdx.y;
  const long qo = b * sq.b + h * sq.h, ko = b * sk.b + h * sk.h, oo = b * so.b + h * so.h;
  const long ro = ((long)b * heads + h) * len_q;
  const int key0 = blockIdx.x * kBwdKeys;
  const int keys = min(kBwdKeys, len_k - key0);

  stage_rows<D, T>(sm.k, k + ko + key0 * sk.t, sk.t, keys, kBwdKeys, dim);
  stage_rows<D, T>(sm.v, v + ko + key0 * sk.t, sk.t, keys, kBwdKeys, dim);
  DkvState<D> st;
  zero_acc<D>(st.dk);
  zero_acc<D>(st.dv);
  dkv_sequence<D, T>(st, sm, q + qo, sq.t, dout + oo, so.t, lse + ro, delta + ro, len_q, dim,
                     scale_log2, scale);
  const int row0 = key0 + (threadIdx.x >> 5) * 16;
  store_frags<D, T>(st.dk, dk + ko, sk.t, row0, len_k, dim);
  store_frags<D, T>(st.dv, dv + ko, sk.t, row0, len_k, dim);
}

template <int D, typename T>
static int launch_fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                      int batch, int heads, int len_q, int len_k, int dim, float scale,
                      Strides sq, Strides sk, Strides so, cudaStream_t stream) {
  const dim3 grid((len_q + kBlockQ - 1) / kBlockQ, heads, batch);
  const float scale_log2 = kLog2e * scale;
  const size_t smem = sizeof(SharedTiles<D>);
  const int err = set_dynamic_smem(flash_mha_fwd_kernel<D, T>, smem);
  if (err) return err;
  flash_mha_fwd_kernel<D, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, heads, len_q, len_k, dim, sq, sk, so, scale_log2);
  return (int)cudaGetLastError();
}

template <int D, typename T>
static int launch_bwd(const void* q, const void* k, const void* v, const void* out,
                      const void* dout, const float* lse, float* delta, void* dq, void* dk,
                      void* dv, int batch, int heads, int len_q, int len_k, int dim, float scale,
                      Strides sq, Strides sk, Strides so, cudaStream_t stream) {
  const float scale_log2 = kLog2e * scale;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* go = static_cast<const T*>(dout);

  const dim3 grid_q((len_q + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_mha_bwd_dq_kernel<D, T><<<grid_q, kThreads, 0, stream>>>(
      q_, k_, v_, static_cast<const T*>(out), go, lse, delta, static_cast<T*>(dq), heads, len_q,
      len_k, dim, sq, sk, so, scale_log2, scale);
  int err = (int)cudaGetLastError();
  if (err) return err;

  const size_t smem = DkvSmem<D>::bytes();
  err = set_dynamic_smem(flash_mha_bwd_dkv_kernel<D, T>, smem);
  if (err) return err;
  const dim3 grid_kv((len_k + kBwdKeys - 1) / kBwdKeys, heads, batch);
  flash_mha_bwd_dkv_kernel<D, T><<<grid_kv, kThreads, smem, stream>>>(
      q_, k_, v_, go, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), heads, len_q, len_k,
      dim, sq, sk, so, scale_log2, scale);
  return (int)cudaGetLastError();
}

// The kernels built for each head dim (ops/fused_attention.py::HEAD_DIMS).
#define MMDIFF_FLASH_HEAD_DIMS(X) X(32) X(64) X(96) X(128) X(192) X(256)

template <typename T>
static int dispatch_fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                        int batch, int heads, int len_q, int len_k, int head_dim, int kernel_dim,
                        float scale, Strides sq, Strides sk, Strides so, cudaStream_t s) {
  if (head_dim % 8 || head_dim < 8 || head_dim > kernel_dim) return (int)cudaErrorInvalidValue;
#define MMDIFF_CASE(D)                                                                      \
  case D:                                                                                   \
    return launch_fwd<D, T>(q, k, v, out, lse, batch, heads, len_q, len_k, head_dim, scale,  \
                            sq, sk, so, s);
  switch (kernel_dim) {
    MMDIFF_FLASH_HEAD_DIMS(MMDIFF_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef MMDIFF_CASE
}

template <typename T>
static int dispatch_bwd(const void* q, const void* k, const void* v, const void* out,
                        const void* dout, const float* lse, float* delta, void* dq, void* dk,
                        void* dv, int batch, int heads, int len_q, int len_k, int head_dim,
                        int kernel_dim, float scale, Strides sq, Strides sk, Strides so,
                        cudaStream_t s) {
  if (head_dim % 8 || head_dim < 8 || head_dim > kernel_dim) return (int)cudaErrorInvalidValue;
#define MMDIFF_CASE(D)                                                                      \
  case D:                                                                                   \
    return launch_bwd<D, T>(q, k, v, out, dout, lse, delta, dq, dk, dv, batch, heads, len_q, \
                            len_k, head_dim, scale, sq, sk, so, s);
  switch (kernel_dim) {
    MMDIFF_FLASH_HEAD_DIMS(MMDIFF_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef MMDIFF_CASE
}

}  // namespace mmdiff

// q (and in the backward dq) has the element strides q_s* (batch, head,
// row), k, v (and dk, dv) k_s*, out (and dout) o_s*; the head dim is
// contiguous and runs on the kernels built for `kernel_dim`, with the logit
// scale `scale` (1/sqrt(d) of the caller's real head dim d, which may be
// below a zero-padded `head_dim`).  lse and the backward's scratch delta are
// [B, H, Tq] fp32.  Returns the first failing launch's CUDA error (0 on
// success).
//
// Each direction's design is chosen by the caller (ops/fused_attention.py::
// forward_design, backward_design): mmdiff_flash_mha_fwd and
// mmdiff_flash_mha_bwd are the Hopper kernels, bf16 at kernel head dims
// 32-128 (16-byte aligned operands and strides, for TMA); they refuse
// anything else.  mmdiff_flash_mha_fwd_mma and mmdiff_flash_mha_bwd_mma are
// the mma.sync design, bf16 or fp32 at every kernel head dim.
extern "C" int mmdiff_flash_mha_fwd(const void* q, const void* k, const void* v, void* out,
                                    float* lse, int batch, int heads, int len_q, int len_k,
                                    int head_dim, int kernel_dim, float scale, long long q_sb,
                                    long long q_sh, long long q_st, long long k_sb,
                                    long long k_sh, long long k_st, long long o_sb,
                                    long long o_sh, long long o_st, int is_fp32, void* stream) {
  if (is_fp32) return (int)cudaErrorInvalidValue;
  const mmdiff::Strides sq{q_sb, q_sh, q_st}, sk{k_sb, k_sh, k_st}, so{o_sb, o_sh, o_st};
  return mmdiff::dispatch_fwd_sm90(q, k, v, out, lse, batch, heads, len_q, len_k, head_dim,
                                   kernel_dim, scale, sq, sk, so,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" int mmdiff_flash_mha_fwd_mma(const void* q, const void* k, const void* v, void* out,
                                        float* lse, int batch, int heads, int len_q, int len_k,
                                        int head_dim, int kernel_dim, float scale,
                                        long long q_sb, long long q_sh, long long q_st,
                                        long long k_sb, long long k_sh, long long k_st,
                                        long long o_sb, long long o_sh, long long o_st,
                                        int is_fp32, void* stream) {
  const mmdiff::Strides sq{q_sb, q_sh, q_st}, sk{k_sb, k_sh, k_st}, so{o_sb, o_sh, o_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp32)
    return mmdiff::dispatch_fwd<float>(q, k, v, out, lse, batch, heads, len_q, len_k, head_dim,
                                       kernel_dim, scale, sq, sk, so, s);
  return mmdiff::dispatch_fwd<mmdiff::bf16>(q, k, v, out, lse, batch, heads, len_q, len_k,
                                            head_dim, kernel_dim, scale, sq, sk, so, s);
}

extern "C" int mmdiff_flash_mha_bwd(const void* q, const void* k, const void* v, const void* out,
                                    const void* dout, const float* lse, float* delta, void* dq,
                                    void* dk, void* dv, int batch, int heads, int len_q,
                                    int len_k, int head_dim, int kernel_dim, float scale,
                                    long long q_sb, long long q_sh, long long q_st,
                                    long long k_sb, long long k_sh, long long k_st,
                                    long long o_sb, long long o_sh, long long o_st, int is_fp32,
                                    void* stream) {
  if (is_fp32) return (int)cudaErrorInvalidValue;
  const mmdiff::Strides sq{q_sb, q_sh, q_st}, sk{k_sb, k_sh, k_st}, so{o_sb, o_sh, o_st};
  return mmdiff::dispatch_bwd_sm90(q, k, v, out, dout, lse, delta, dq, dk, dv, batch, heads,
                                   len_q, len_k, head_dim, kernel_dim, scale, sq, sk, so,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" int mmdiff_flash_mha_bwd_mma(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, const float* lse,
                                        float* delta, void* dq, void* dk, void* dv, int batch,
                                        int heads, int len_q, int len_k, int head_dim,
                                        int kernel_dim, float scale, long long q_sb,
                                        long long q_sh, long long q_st, long long k_sb,
                                        long long k_sh, long long k_st, long long o_sb,
                                        long long o_sh, long long o_st, int is_fp32,
                                        void* stream) {
  const mmdiff::Strides sq{q_sb, q_sh, q_st}, sk{k_sb, k_sh, k_st}, so{o_sb, o_sh, o_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp32)
    return mmdiff::dispatch_bwd<float>(q, k, v, out, dout, lse, delta, dq, dk, dv, batch, heads,
                                       len_q, len_k, head_dim, kernel_dim, scale, sq, sk, so, s);
  return mmdiff::dispatch_bwd<mmdiff::bf16>(q, k, v, out, dout, lse, delta, dq, dk, dv, batch,
                                            heads, len_q, len_k, head_dim, kernel_dim, scale, sq,
                                            sk, so, s);
}
