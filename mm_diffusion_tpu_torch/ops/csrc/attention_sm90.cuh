// Hopper (sm_90a) machinery of the attention kernels: the self-attention
// forward (self_attention.cu) and backward (self_attention_bwd.cu), the
// banded RS-MMA forward (banded_attention.cu) and backward
// (banded_attention_bwd.cu) and the flash MHA forward and backward
// (flash_mha.cu); its copies, barriers and products also serve the direct
// 3x3 conv (conv3x3_chw.cu) and the GEMM of skip_gemm.cu, whose B operand
// (row-major [K, N]) the wgmma reads MN-major from shared memory with the
// transpose bit (wgmma_ss_mn).  TMA tile loads through
// tensor maps of the packed projections, mbarrier rings between a producer
// warp and the consumer warpgroups, and warpgroup products (wgmma.mma_async,
// bf16 in, fp32 accumulate); the backward's two tile products (dq_products,
// dkv_products), which the self-attention, banded and flash MHA backwards
// share, each with its own mask.
//
// The kernels it serves replace the TPU kernels `_self_fwd_kernel`,
// `_self_bwd_kernel`, `_self_bwd_chunked_kernel`, `_banded_fwd_kernel`,
// `_banded_oneshot_kernel`, `_banded_bwd_lw1_kernel` and
// `_banded_bwd_oneshot_kernel` of mm_diffusion_tpu/ops/block_attention.py
// (:165, :195, :264, :534, :609, :792, :877).  On this card they are bound
// by the tensor cores at T = 1024 and by the bytes of the packed
// projections and the blocks in flight below it; this header is what lets
// them reach the first bound: copies that need no registers and stay in
// flight during the products, and products at warpgroup width.
//
// What it replaces: the mma.sync design of attention_common.cuh, which
// staged K and V through registers with no load in flight during the
// products (two __syncthreads per 64-key tile), transposed V with scalar
// 16-bit stores, fetched every fragment with 32-bit shared loads and ran
// warp-level m16n8k16 products, about two thirds of the card's dense rate at
// best.  Here a tile reaches shared memory by TMA while the previous tile's
// products run, and the tensor cores read it there directly.
//
// Tiles.  Every operand tile is 64 rows x DK columns of bf16, kept as DK / 32
// chunks of 64 rows x 32 columns: 64 bytes a row, 4 KB a chunk, in the
// 64-byte swizzle that TMA writes (CU_TENSOR_MAP_SWIZZLE_64B) and wgmma reads
// (descriptor layout type 2).  A chunk is one TMA box, so every DK in
// {32, 64, 96, 128} has one layout.  The same chunks serve both operand
// orders:
//   K-major (the reduction runs along the row: Q, K, dO in S = Q K^T,
//     dP = dO V^T and their transposes): 8-row groups 512 B apart (SBO); a
//     16-column k-step is +32 B inside a chunk, the next chunk +4 KB;
//   MN-major (the reduction runs down the rows: V in O += P V, K in
//     dQ += dS K, dO and Q in dV += P^T dO and dK += dS^T Q): 32-column
//     chunks 4 KB apart (LBO), 8-row groups 512 B apart (SBO); a 16-row
//     k-step is +1 KB.
// So V is read in its natural [key][dim] order and never transposed.
//
// The tensor map.  The packed projection [rows, 3C] is seen as a 4-D tensor
// {dim, n1, n2, rows} whose innermost extent is the real head dim, so TMA
// zero-fills the lanes of a chunk at or past it (the head-dim rule of
// attention_common.cuh).  thirds: {dim, heads, 3 (q|k|v), rows}, per_head:
// {dim, 3, heads, rows}; dO [rows, C]: {dim, heads, 1, rows}.  TMA
// zero-fills only past the end of the whole tensor: rows past T of one
// sequence are the next sequence's, and the kernels mask them by index.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mmdiff {
namespace sm90 {

constexpr int kRows = 64;                        // rows of every tile (wgmma M, keys per tile)
constexpr int kChunk = 32;                       // columns of one TMA box / swizzle chunk
constexpr int kChunkBytes = kRows * kChunk * 2;  // 4 KB
constexpr int kWarpgroup = 128;
constexpr int kProducerThreads = 32;             // one producer warp after the consumers

template <int DK>
struct Tile {
  static constexpr int kChunks = DK / kChunk;
  static constexpr int kBytes = kChunks * kChunkBytes;
};

// ---------------------------------------------------------------------------
// Barriers and copies
// ---------------------------------------------------------------------------

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

static __device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

static __device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic.
static __device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

static __device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

static __device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed.  A phase that has
// not completed after 10 s (a lost arrival or copy) traps, so that it fails
// the launch instead of hanging the device.
static __device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint64_t start = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == 1024) start = globaltimer_ns();
    if (polls > 1024 && (polls & 1023) == 0 && globaltimer_ns() - start > 10000000000ull)
      asm volatile("trap;");
  }
}

// One 32-column x 64-row box of a 4-D tensor map into shared memory; its
// bytes complete on `bar`.
static __device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                                int c0, int c1, int c2, int row) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

// The dynamic shared memory as S, aligned to the 1 KB that the swizzled
// tiles need (the launch asks for 1 KB more than sizeof(S)).
template <typename S>
__device__ __forceinline__ S& aligned_smem(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return *reinterpret_cast<S*>(raw + ((1024 - (a & 1023)) & 1023));
}

// All DK / 32 chunks of one 64-row operand tile: operand `which` (0 q, 1 k,
// 2 v; 0 for dO) of head h at global row `row`.
template <int DK>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                          int which, int h, int per_head, int row) {
  const int c1 = per_head ? which : h, c2 = per_head ? h : which;
#pragma unroll
  for (int c = 0; c < Tile<DK>::kChunks; ++c)
    tma_load(dst + c * kChunkBytes, map, bar, c * kChunk, c1, c2, row);
}

// ---------------------------------------------------------------------------
// Warpgroup products
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptors (64-byte swizzle, layout type 2).
static __device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (2ull << 62);
}

// K-major operand: k-step kk (16 columns) of a 64-row tile.
static __device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int kk) {
  return desc(smem_u32(tile) + (kk >> 1) * kChunkBytes + (kk & 1) * 32, 16, 512);
}

// MN-major operand: k-step kk (16 rows) of a 64-row tile.
static __device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int kk) {
  return desc(smem_u32(tile) + kk * 16 * 64, kChunkBytes, 512);
}

static __device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

static __device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
static __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads of accumulators above a wgmma wait.
template <int M>
static __device__ __forceinline__ void fence_regs(float (&r)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B in shared memory (K-major).
static __device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, "
      "1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B in shared memory
// (K-major: B as 128 rows of its K lanes, as K in S = Q K^T).
static __device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                                     uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, "
      "1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 96] (+)= A[64 x 16] * B[16 x 96], A in shared memory (K-major), B in
// shared memory MN-major (row-major [K, N] with N contiguous: the transpose bit).
static __device__ __forceinline__ void wgmma_ss_mn_n96(float (&d)[48], uint64_t desc_a,
                                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, "
      "1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A in shared memory (K-major), B in
// shared memory MN-major (row-major [K, N] with N contiguous: the transpose bit).
static __device__ __forceinline__ void wgmma_ss_mn_n128(float (&d)[64], uint64_t desc_a,
                                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
      "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, "
      "1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x N] (+)= A (shared, K-major) * B (shared, MN-major), N = 96 or 128:
// the GEMM's two halves of a 192- or 256-column tile.
template <int N>
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 96) wgmma_ss_mn_n96(d, a, b, scale_d);
  else wgmma_ss_mn_n128(d, a, b, scale_d);
}

// D[64 x 32] += A[64 x 16] * B[16 x 32], A in registers, B in shared memory (MN-major).
static __device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, "
      "%18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A in registers, B in shared memory (MN-major).
static __device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, "
      "%34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 96] += A[64 x 16] * B[16 x 96], A in registers, B in shared memory (MN-major).
static __device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, "
      "%50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A in registers, B in shared memory (MN-major).
static __device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, "
      "%66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


// D[64 x N] += A (registers) * B (MN-major), N = the tile's head dim.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 32) wgmma_rs_n32(d, a, b);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else if constexpr (N == 96) wgmma_rs_n96(d, a, b);
  else wgmma_rs_n128(d, a, b);
}

// ---------------------------------------------------------------------------
// Fragments
// ---------------------------------------------------------------------------
// A warpgroup's m64nN accumulator: warp w of the group holds rows
// [16w, 16w + 16); thread (g = lane / 4, t = lane % 4) holds, for each
// 8-column block j, d[4j + e] at row g + 8 * (e >> 1), column 8j + 2t + (e & 1).

static __device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The m64n64 accumulator of 64 columns as the four k-steps (16 columns
// each) of a register A operand: the accumulator layout is the A layout.
static __device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4], const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]);
    a[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// Store a warpgroup's m64nDK accumulator: rows whose flag is set, columns
// below `dim`, to row pointers `row_ptr[0]` (row g) and `row_ptr[1]` (row
// g + 8) of this thread, times `mul`.
template <int DK>
__device__ __forceinline__ void store_acc(const float (&acc)[DK / 2], __nv_bfloat16* row0,
                                          __nv_bfloat16* row1, bool ok0, bool ok1, float mul0,
                                          float mul1, int dim) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < DK / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (c >= dim) continue;
    if (ok0)
      *reinterpret_cast<__nv_bfloat162*>(row0 + c) =
          __floats2bfloat162_rn(acc[4 * j] * mul0, acc[4 * j + 1] * mul0);
    if (ok1)
      *reinterpret_cast<__nv_bfloat162*>(row1 + c) =
          __floats2bfloat162_rn(acc[4 * j + 2] * mul1, acc[4 * j + 3] * mul1);
  }
}

template <int DK>
__device__ __forceinline__ void zero(float (&acc)[DK / 2]) {
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) acc[i] = 0.f;
}

// This thread's rows r and r + 8 of its warpgroup's 64-row tile.
__device__ __forceinline__ void thread_rows(int (&rows)[2], int r0) {
  const int r = r0 + ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);
  rows[0] = r;
  rows[1] = r + 8;
}

// ---------------------------------------------------------------------------
// The backward's tile products (self-attention, banded and flash MHA backward)
// ---------------------------------------------------------------------------
// Column x of a tile's accumulator held by this thread: x = col(i) for its
// element i, row (i >> 1) & 1 of its two rows.
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// dQ += dS K for one 64-key tile (k, v) against the block's 64 query rows (q,
// go; this thread's rows r = 0, 1 with base-2 logsumexp lse2[r] and delta[r]):
// S = Q K^T, dP = dO V^T, P = exp2(S scale_log2 - lse2), dS = P (dP - delta)
// scale, P zero where meets(key, r) is false.
template <int DK, typename Meets>
__device__ __forceinline__ void dq_products(float (&dq)[DK / 2], const uint8_t* q,
                                            const uint8_t* go, const uint8_t* k, const uint8_t* v,
                                            const float (&lse2)[2], const float (&delta)[2],
                                            float scale_log2, float scale, Meets meets) {
  float sc[32], dp[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) wgmma_ss_n64(sc, desc_k(q, kk), desc_k(k, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) wgmma_ss_n64(dp, desc_k(go, kk), desc_k(v, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  fence_regs(dp);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    const float p = meets(acc_col(i), r) ? exp2f(sc[i] * scale_log2 - lse2[r]) : 0.f;
    sc[i] = p * (dp[i] - delta[r]) * scale;  // dS
  }
  uint32_t ds[4][4];
  acc_to_a(ds, sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<DK>(dq, ds[kk], desc_mn(k, kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dq);
}

// dV += P^T dO and dK += dS^T Q for one 64-query tile (q, go, with each query
// column's lse2 -- +inf where there is no row -- and delta) against the
// block's 64 keys (k, v): S^T = K Q^T, dP^T = V dO^T, P^T = exp2(S^T
// scale_log2 - lse2), dS^T = P^T (dP^T - delta) scale, P^T zero where
// meets(query column, r) is false for this thread's key row r = 0, 1.
template <int DK, typename Meets>
__device__ __forceinline__ void dkv_products(float (&dk)[DK / 2], float (&dv)[DK / 2],
                                             const uint8_t* k, const uint8_t* v, const uint8_t* q,
                                             const uint8_t* go, const float* lse2,
                                             const float* delta, float scale_log2, float scale,
                                             Meets meets) {
  float sc[32], dp[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) wgmma_ss_n64(sc, desc_k(k, kk), desc_k(q, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) wgmma_ss_n64(dp, desc_k(v, kk), desc_k(go, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  fence_regs(dp);
#pragma unroll
  for (int i = 0; i < 32; ++i) {  // P^T
    const int x = acc_col(i);
    sc[i] = meets(x, (i >> 1) & 1) ? exp2f(sc[i] * scale_log2 - lse2[x]) : 0.f;
  }
  uint32_t pa[4][4];
  acc_to_a(pa, sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<DK>(dv, pa[kk], desc_mn(go, kk));
  wgmma_commit();  // dV runs while dS^T is formed
#pragma unroll
  for (int i = 0; i < 32; ++i) {  // dS^T
    const int x = acc_col(i);
    dp[i] = sc[i] * (dp[i] - delta[x]) * scale;
  }
  uint32_t ds[4][4];
  acc_to_a(ds, dp);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<DK>(dk, ds[kk], desc_mn(q, kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dk);
  fence_regs(dv);
}

}  // namespace sm90

// ---------------------------------------------------------------------------
// Host side: the tensor map of a packed bf16 projection
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime's
// entry-point query (so the library needs no -lcuda).
static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D bf16 map over `base`: extents gdim (innermost first), element
// strides of dims 1-3, boxes of `box` elements, 64-byte swizzle (box[0] <=
// 32), zero fill past every extent.  A box must start 16-byte aligned in
// the innermost dimension (an odd start faults on the card).  Returns 0 or
// a CUDA error.
static int encode_map_4d(CUtensorMap* map, const void* base, const long (&gdim)[4],
                         const long (&strides)[3], const int (&box)[4]) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  cuuint64_t dims[4], bytes[3];
  cuuint32_t boxes[4];
  for (int i = 0; i < 4; ++i) {
    dims[i] = (cuuint64_t)gdim[i];
    boxes[i] = (cuuint32_t)box[i];
    if (i < 3) bytes[i] = (cuuint64_t)strides[i] * 2;
  }
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        bytes, boxes, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The map {dim, n1, n2, rows} over `base` (element strides s1, s2 and
// row_elems for n1, n2 and rows), boxes of 32 x 1 x 1 x 64.
static int encode_map(CUtensorMap* map, const void* base, int dim, int n1, long s1, int n2,
                      long s2, long rows, long row_elems) {
  return encode_map_4d(map, base, {dim, n1, n2, rows}, {s1, s2, row_elems},
                       {sm90::kChunk, 1, 1, sm90::kRows});
}

// Streaming multiprocessors of the current device.
static int sm_count() {
  static int count = 0;
  if (!count) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

// Sequences per 64-row tile: at T <= 32 as many whole sequences as fit
// under the block-diagonal mask, but fewer when the (ceil(N / pack), heads)
// grid would leave SMs without a block (one a tile at worst); 1 at T > 32.
static int pack_for(int n, int len, int heads) {
  int pack = len <= sm90::kRows / 2 ? sm90::kRows / len : 1;
  while (pack > 1 && (long)((n + pack - 1) / pack) * heads < sm_count()) --pack;
  return pack;
}

// The map of a packed qkv projection [rows, 3 * heads * dim] in either
// layout (head stride and k offset as mmdiff_self_attention_fwd takes them).
static int encode_qkv_map(CUtensorMap* map, const void* qkv, long rows, int heads, int dim,
                          int head_stride, int k_off) {
  const long row = 3L * heads * dim;
  if (head_stride == dim)  // thirds: {dim, heads, q|k|v, rows}
    return encode_map(map, qkv, dim, heads, head_stride, 3, k_off, rows, row);
  return encode_map(map, qkv, dim, 3, k_off, heads, head_stride, rows, row);  // per_head
}

}  // namespace mmdiff
