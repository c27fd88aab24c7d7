// Multi-head self-attention over packed qkv [N, T, 3C] -> [N, T, C], plus the
// per-row logsumexp [N, H, T] (fp32) that a backward pass will reuse.
//
// Replaces the TPU kernel `_self_fwd_kernel` of
// mm_diffusion_tpu/ops/block_attention.py (launched by `_self_attention_pallas`
// through `self_attention_packed`).
//
// What bounds it on this card: the model's sequences are short (T <= 1024,
// head dim 64/96/128), so one (sequence, head) pair is at most ~0.5 GFLOP and
// the whole call is bound by reading qkv once per query tile and by the
// number of blocks in flight, not by the tensor cores.  The design keeps the
// traffic to one read of q and ceil(T/64) reads of k/v per (sequence, head),
// never materialises the [T, T] logits, and reads q, k and v straight out of
// the packed projection by offset and head stride, so neither the
// thirds-major order ([q | k | v], MM-UNet) nor the legacy per-head order
// ([h0: q k v | h1: q k v | ...], SR U-Net) needs a copy.  The temporal pass
// (T = 16) wastes three quarters of each 64-row query tile; packing several
// short sequences per block is left for a later change.
//
// Grid: (N, H, ceil(T / 64)); block: 128 threads (4 warps x 16 query rows).

#include "attention_common.cuh"

namespace mmdiff {

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    self_attention_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                              float* __restrict__ lse, int len, int heads, int head_stride,
                              int k_off, int v_off, float scale_log2) {
  __shared__ __align__(16) SharedTiles<D> sm;
  const int n = blockIdx.x, h = blockIdx.y;
  const int c = heads * D;
  const long stride = 3L * c;
  const T* q = qkv + (long)n * len * stride + (long)h * head_stride;
  const int row0 = blockIdx.z * kBlockQ + (threadIdx.x >> 5) * 16;

  FlashState<D> st;
  load_queries<D, T>(st, q, stride, row0, len);
  attend_sequence<D, T>(st, sm, q + k_off, q + v_off, stride, len, scale_log2);
  store_rows<D, T>(st, out + (long)n * len * c + (long)h * D, c,
                   lse + ((long)n * heads + h) * len, row0, len);
}

template <int D, typename T>
static void launch(const void* qkv, void* out, float* lse, int n, int len, int heads,
                   int head_stride, int k_off, int v_off, cudaStream_t stream) {
  const dim3 grid(n, heads, (len + kBlockQ - 1) / kBlockQ);
  const float scale_log2 = kLog2e / sqrtf((float)D);
  self_attention_fwd_kernel<D, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), lse, len, heads, head_stride, k_off,
      v_off, scale_log2);
}

template <typename T>
static int dispatch(const void* qkv, void* out, float* lse, int n, int len, int heads,
                    int head_dim, int head_stride, int k_off, int v_off, cudaStream_t stream) {
  switch (head_dim) {
    case 64: launch<64, T>(qkv, out, lse, n, len, heads, head_stride, k_off, v_off, stream); break;
    case 96: launch<96, T>(qkv, out, lse, n, len, heads, head_stride, k_off, v_off, stream); break;
    case 128: launch<128, T>(qkv, out, lse, n, len, heads, head_stride, k_off, v_off, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace mmdiff

// Head h reads q at h*head_stride, k at h*head_stride + k_off and v at
// h*head_stride + v_off within each row of 3*heads*head_dim elements:
//   thirds:   head_stride = D,   k_off = C, v_off = 2C
//   per_head: head_stride = 3D,  k_off = D, v_off = 2D
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int mmdiff_self_attention_fwd(const void* qkv, void* out, float* lse, int n, int len,
                                         int heads, int head_dim, int head_stride, int k_off,
                                         int v_off, int is_fp32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp32)
    return mmdiff::dispatch<float>(qkv, out, lse, n, len, heads, head_dim, head_stride, k_off,
                                   v_off, s);
  return mmdiff::dispatch<mmdiff::bf16>(qkv, out, lse, n, len, heads, head_dim, head_stride,
                                        k_off, v_off, s);
}
