// Backward of multi-head self-attention over packed qkv [N, T, 3C]:
//   (qkv, out [N, T, C], dout [N, T, C], lse [N, H, T]) -> dqkv [N, T, 3C]
// in the caller's layout (dq, dk, dv at the lanes where q, k, v were read).
//
// Replaces both TPU backward kernels of mm_diffusion_tpu/ops/block_attention.py:
// `_self_bwd_kernel` (launched by `_self_attention_bwd_pallas`, whole [T, T]
// tiles per row block) and `_self_bwd_chunked_kernel` (launched by
// `_self_attention_bwd_chunked_pallas`, q in 256-row chunks for T = 1024).
// Neither form carries over: on Hopper no block holds a [T, T] tile, so one
// flash-style backward over 32-row tiles serves every T, T = 16 with
// thousands of sequences and ragged T = 400 included (attention_bwd_common.cuh).
//
// What bounds it on this card: like the forward, the sequences are short
// (T <= 1024, head dim 64/96/128), so each (sequence, head) pair is at most
// ~1.3 GFLOP of backward work and the call is bound by blocks in flight and
// by re-reading K/V (dq pass) and Q/dO (dkv pass) once per 64-row tile, not
// by the tensor cores.  The design reuses the forward's logsumexp instead of
// recomputing the softmax normalisation, reads q/k/v/dout in place, and writes
// dq, dk, dv straight into the packed gradient: no layout copy and no
// zero-fill pass.  The temporal sites (T = 16) waste three quarters of each
// 64-row block, as in the forward.
//
// Grids: dq pass (N, H, ceil(T / 64)), dkv pass (N, H, ceil(T / 64)); 128
// threads per block.  The dq pass writes delta = rowsum(dO * O) that the dkv
// pass reads, so the two run in this order on the caller's stream.

#include "attention_bwd_common.cuh"

namespace mmdiff {

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    self_attention_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ out,
                                 const T* __restrict__ dout, const float* __restrict__ lse,
                                 float* __restrict__ delta, T* __restrict__ dqkv, int len,
                                 int heads, int head_stride, int k_off, int v_off,
                                 float scale_log2, float scale) {
  __shared__ __align__(16) unsigned short sk[kBwdTile * (D + kPadK)];
  __shared__ __align__(16) unsigned short sv[kBwdTile * (D + kPadK)];
  const int n = blockIdx.x, h = blockIdx.y;
  const int c = heads * D;
  const long stride = 3L * c;
  const long seq = (long)n * len * stride + (long)h * head_stride;
  const long o_off = (long)n * len * c + (long)h * D;
  const long row_off = ((long)n * heads + h) * len;
  const int row0 = blockIdx.z * kBlockQ + (threadIdx.x >> 5) * 16;

  DqState<D> st;
  dq_begin<D, T>(st, qkv + seq, stride, out + o_off, dout + o_off, c, lse + row_off,
                 delta + row_off, row0, len);
  dq_sequence<D, T>(st, sk, sv, qkv + seq + k_off, qkv + seq + v_off, stride, len, scale_log2,
                    scale);
  store_frags<D, T>(st.dq, dqkv + seq, stride, row0, len);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    self_attention_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                                  const float* __restrict__ lse, const float* __restrict__ delta,
                                  T* __restrict__ dqkv, int len, int heads, int head_stride,
                                  int k_off, int v_off, float scale_log2, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DkvSmem<D> sm(smem);
  const int n = blockIdx.x, h = blockIdx.y;
  const int c = heads * D;
  const long stride = 3L * c;
  const long seq = (long)n * len * stride + (long)h * head_stride;
  const long o_off = (long)n * len * c + (long)h * D;
  const long row_off = ((long)n * heads + h) * len;
  const int key0 = blockIdx.z * kBwdKeys;
  const int keys = min(kBwdKeys, len - key0);

  stage_rows<D, T>(sm.k, qkv + seq + k_off + key0 * stride, stride, keys, kBwdKeys);
  stage_rows<D, T>(sm.v, qkv + seq + v_off + key0 * stride, stride, keys, kBwdKeys);
  DkvState<D> st;
  zero_acc<D>(st.dk);
  zero_acc<D>(st.dv);
  dkv_sequence<D, T>(st, sm, qkv + seq, stride, dout + o_off, c, lse + row_off,
                     delta + row_off, len, scale_log2, scale);
  const int row0 = key0 + (threadIdx.x >> 5) * 16;
  store_frags<D, T>(st.dk, dqkv + seq + k_off, stride, row0, len);
  store_frags<D, T>(st.dv, dqkv + seq + v_off, stride, row0, len);
}

template <int D, typename T>
static int launch(const void* qkv, const void* out, const void* dout, const float* lse,
                  float* delta, void* dqkv, int n, int len, int heads, int head_stride, int k_off,
                  int v_off, cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)D);
  const float scale_log2 = kLog2e / sqrtf((float)D);
  const T* x = static_cast<const T*>(qkv);
  const T* o = static_cast<const T*>(out);
  const T* go = static_cast<const T*>(dout);
  T* dx = static_cast<T*>(dqkv);

  const dim3 grid_q(n, heads, (len + kBlockQ - 1) / kBlockQ);
  self_attention_bwd_dq_kernel<D, T><<<grid_q, kThreads, 0, stream>>>(
      x, o, go, lse, delta, dx, len, heads, head_stride, k_off, v_off, scale_log2, scale);
  int err = (int)cudaGetLastError();
  if (err) return err;

  const size_t smem = DkvSmem<D>::bytes();
  err = set_dynamic_smem(self_attention_bwd_dkv_kernel<D, T>, smem);
  if (err) return err;
  const dim3 grid_kv(n, heads, (len + kBwdKeys - 1) / kBwdKeys);
  self_attention_bwd_dkv_kernel<D, T><<<grid_kv, kThreads, smem, stream>>>(
      x, go, lse, delta, dx, len, heads, head_stride, k_off, v_off, scale_log2, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* qkv, const void* out, const void* dout, const float* lse,
                    float* delta, void* dqkv, int n, int len, int heads, int head_dim,
                    int head_stride, int k_off, int v_off, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<64, T>(qkv, out, dout, lse, delta, dqkv, n, len, heads, head_stride, k_off,
                           v_off, stream);
    case 96:
      return launch<96, T>(qkv, out, dout, lse, delta, dqkv, n, len, heads, head_stride, k_off,
                           v_off, stream);
    case 128:
      return launch<128, T>(qkv, out, dout, lse, delta, dqkv, n, len, heads, head_stride, k_off,
                            v_off, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mmdiff

// qkv and dqkv share the layout of mmdiff_self_attention_fwd (head stride and
// k/v offsets); out and dout are [N, T, C], lse and the scratch delta
// [N, H, T] fp32.  Every element of dqkv is written.  Returns the first
// failing launch's CUDA error (0 on success).
extern "C" int mmdiff_self_attention_bwd(const void* qkv, const void* out, const void* dout,
                                         const float* lse, float* delta, void* dqkv, int n,
                                         int len, int heads, int head_dim, int head_stride,
                                         int k_off, int v_off, int is_fp32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp32)
    return mmdiff::dispatch<float>(qkv, out, dout, lse, delta, dqkv, n, len, heads, head_dim,
                                   head_stride, k_off, v_off, s);
  return mmdiff::dispatch<mmdiff::bf16>(qkv, out, dout, lse, delta, dqkv, n, len, heads,
                                        head_dim, head_stride, k_off, v_off, s);
}
