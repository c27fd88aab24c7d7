// RS-MMA banded cross-attention over the packed qkv of two modalities:
//   q_src  [N, F, Tq, 3C]  (this modality; q = lanes [0, C))
//   kv_src [N, F, Tk, 3C]  (other modality; k = lanes [C, 2C), v = [2C, 3C))
// Query frame f attends to the kv frames (f + shift + j) % F, j < lw, under
// one joint softmax over lw * Tk keys.  Output [N, F, Tq, C], plus the
// per-row logsumexp [N, F, H, Tq] (fp32) for a later backward.
//
// Replaces both TPU kernels that compute this function in
// mm_diffusion_tpu/ops/block_attention.py: `_banded_oneshot_kernel` (lw > 1,
// launched by `_banded_oneshot_pallas`) and `_banded_fwd_kernel` (lw == 1 and
// the streamed online-softmax form, launched by `_banded_fwd_pallas`).  One
// loop over j < lw serves every window, lw == 1 included.
//
// What bounds it on this card: each (frame, head) pair is small (Tq, Tk <=
// 1024, head dim 64 in the flagship model, any multiple of 8 up to 128 on
// the kernels built for 32, 64, 96 and 128), so the call is bound by memory
// traffic and by blocks in flight.  The design reads q and k|v straight from
// both modalities' packed projections (row stride 3C, k at lane offset C, v
// at 2C), never builds the lw-frame window in memory (the frame index is
// computed per j in the kernel), and keeps the softmax online across the lw frames, so the window
// costs lw * ceil(Tk / 64) staged tiles and no extra device-memory pass.
// `shift` is a kernel argument: one build serves every shift.
//
// Grid: (N * F, H, ceil(Tq / 64)); block: 128 threads (4 warps x 16 rows).

#include "attention_common.cuh"

namespace mmdiff {

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
                   int frames, int tq, int tk, int heads, int dim, int shift, int window,
                   cudaStream_t stream) {
  const dim3 grid(n * frames, heads, (tq + kBlockQ - 1) / kBlockQ);
  const float scale_log2 = kLog2e / sqrtf((float)dim);
  banded_attention_fwd_kernel<D, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q_src), static_cast<const T*>(kv_src), static_cast<T*>(out), lse,
      frames, tq, tk, heads, dim, shift, window, scale_log2);
}

template <typename T>
static int dispatch(const void* q_src, const void* kv_src, void* out, float* lse, int n,
                    int frames, int tq, int tk, int heads, int head_dim, int kernel_dim,
                    int shift, int window, cudaStream_t stream) {
  if (head_dim % 8 || head_dim < 8 || head_dim > kernel_dim) return (int)cudaErrorInvalidValue;
#define MMDIFF_LAUNCH(D)                                                                      \
  launch<D, T>(q_src, kv_src, out, lse, n, frames, tq, tk, heads, head_dim, shift, window, \
               stream);                                                                    \
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

// `shift` must lie in [0, frames) and 1 <= window <= frames (checked by the
// Python wrapper); `head_dim` runs on the kernel built for `kernel_dim`
// (ops/block_attention.py::kernel_head_dim).  Returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int mmdiff_banded_attention_fwd(const void* q_src, const void* kv_src, void* out,
                                           float* lse, int n, int frames, int tq, int tk,
                                           int heads, int head_dim, int kernel_dim, int shift,
                                           int window, int is_fp32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp32)
    return mmdiff::dispatch<float>(q_src, kv_src, out, lse, n, frames, tq, tk, heads, head_dim,
                                   kernel_dim, shift, window, s);
  return mmdiff::dispatch<mmdiff::bf16>(q_src, kv_src, out, lse, n, frames, tq, tk, heads,
                                        head_dim, kernel_dim, shift, window, s);
}
