// Backward of RS-MMA banded cross-attention over packed qkv (the forward is
// banded_attention.cu): query frame f of q_src attended to the kv frames
// g = (f + shift + j) % F, j < lw, of kv_src under one joint softmax.
//   (q_src [N, F, Tq, 3C], kv_src [N, F, Tk, 3C], out [N, F, Tq, C],
//    dout [N, F, Tq, C], lse [N, F, H, Tq])
//   -> dq_src [N, F, Tq, 3C]  (dq in lanes [0, C), zeros elsewhere)
//      dkv_src [N, F, Tk, 3C] (dk in [C, 2C), dv in [2C, 3C), zeros in [0, C))
//
// Replaces both TPU backward kernels of mm_diffusion_tpu/ops/block_attention.py:
// `_banded_bwd_lw1_kernel` (lw == 1, launched by `_banded_bwd_lw1_pallas`) and
// `_banded_bwd_oneshot_kernel` (lw > 1, launched by `_banded_bwd_oneshot_pallas`,
// which emits lw dkv partials that the caller sums).  One kernel pair serves
// every window:
//   dq pass   one block per (clip * query frame, head, 64 query rows) loops
//             over j < lw and the key tiles of kv frame (f + shift + j) % F,
//             with P recomputed from the forward's joint logsumexp;
//   dkv pass  one block per (clip * kv frame g, head, 64 keys) loops over the
//             query frames that attended to g, f = (g - shift - j) mod F for
//             j < lw (distinct because lw <= F), and sums their dK, dV in
//             registers.
// Up to lw query frames feed one kv frame's gradient; the dkv pass sums them
// in one block, so there are no float atomics, no lw partial outputs and no
// extra summing pass, and the result is the same on every run.
//
// What bounds it on this card: each (frame, head) pair is small (Tq, Tk <=
// 1024, head dim 64 in the flagship model; any multiple of 8 up to 128 runs
// on the kernels built for 32, 64, 96 and 128), so the call is bound by blocks in flight and by the
// re-reads of K/V and Q/dO per 64-row tile, not by the tensor cores.  The
// zero lanes of both packed gradients are written by the same blocks, so
// the wrapper needs no zero-fill pass; `shift` is an argument, so one build
// serves every shift.
//
// Grids: dq pass (N * F, H, ceil(Tq / 64)), dkv pass (N * F, H, ceil(Tk / 64));
// 128 threads per block.

#include "attention_bwd_common.cuh"

namespace mmdiff {

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
                  int tq, int tk, int heads, int dim, int shift, int window, cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)dim);
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
                    int frames, int tq, int tk, int heads, int head_dim, int kernel_dim, int shift,
                    int window, cudaStream_t stream) {
  if (head_dim % 8 || head_dim < 8 || head_dim > kernel_dim) return (int)cudaErrorInvalidValue;
#define MMDIFF_LAUNCH(D)                                                                     \
  return launch<D, T>(q_src, kv_src, out, dout, lse, delta, dq_src, dkv_src, n, frames, tq, \
                      tk, heads, head_dim, shift, window, stream);
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

// `shift` must lie in [0, frames) and 1 <= window <= frames (checked by the
// Python wrapper); lse is the forward's [N, F, H, Tq] logsumexp and delta a
// scratch of the same shape; `head_dim` runs on the kernels built for
// `kernel_dim`.  Every element of dq_src and dkv_src is written.  Returns the
// first failing launch's CUDA error (0 on success).
extern "C" int mmdiff_banded_attention_bwd(const void* q_src, const void* kv_src, const void* out,
                                           const void* dout, const float* lse, float* delta,
                                           void* dq_src, void* dkv_src, int n, int frames,
                                           int tq, int tk, int heads, int head_dim,
                                           int kernel_dim, int shift, int window, int is_fp32,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp32)
    return mmdiff::dispatch<float>(q_src, kv_src, out, dout, lse, delta, dq_src, dkv_src, n,
                                   frames, tq, tk, heads, head_dim, kernel_dim, shift, window, s);
  return mmdiff::dispatch<mmdiff::bf16>(q_src, kv_src, out, dout, lse, delta, dq_src, dkv_src,
                                        n, frames, tq, tk, heads, head_dim, kernel_dim, shift,
                                        window, s);
}
