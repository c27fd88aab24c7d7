// Flash multi-head attention over strided [B, H, T, D] operands, forward and
// backward: out = softmax(Q K^T / sqrt(D)) V per (batch, head), Tq != Tk
// allowed, plus the per-row logsumexp [B, H, Tq] (fp32) that the backward
// reuses.
//
// Replaces the TPU flash kernel of JAX's library that
// mm_diffusion_tpu/ops/fused_attention.py reaches through `flash_mha_bhtd`
// (:69): jax/experimental/pallas/ops/tpu/flash_attention.py, the forward
// `pallas_call` (:758) and the backward's dkv (:1121) and dq (:1456) kernels
// behind its custom VJP (:254).
//
// What bounds it on this card: at the API's hot shapes (B*F = 128 rows, 4
// heads, head dim 64, T = 1024) the forward is 137 GFLOP against 0.13 GB of
// operands, so the tensor cores bound it (0.139 ms at 989 TFLOP/s); at
// Tq = 100 or Tk = 400 it approaches the bytes bound.  The design keeps the
// [Tq, Tk] logits out of device memory (online softmax over 64-key tiles,
// attention_common.cuh), reads q, k and v in place through their (batch,
// head, row) strides -- so [B, T, H, D] (`flash_mha`) and [B, H, T, D]
// (`flash_mha_bhtd`) go through the same kernels with no transpose copy --
// and masks the ragged ends of Tq and Tk in the kernel instead of padding
// them to 128 in device memory as the TPU path does.  The backward is the
// two-pass form of attention_bwd_common.cuh: a dq pass that also writes
// delta = rowsum(dO * O), then a dk/dv pass; every gradient is summed in
// registers by the one block that owns its rows (no float atomics, the same
// result on every run).  Speed (wgmma, TMA, pipelined K/V) is later work.
//
// Head dims: every D with D % 8 == 0 up to 256 (JAX's flash gate), on the
// kernels built for 32, 64, 96, 128, 192 and 256 (ops/fused_attention.py::
// kernel_head_dim); lanes past D are zero-filled and never stored.  At 192
// and 256 the per-warp fragments outgrow the register file and spill (see
// PERF.md), and the forward's K/V tiles (above 48 KB) take dynamic shared
// memory.
//
// Grids: forward and dq pass (ceil(Tq / 64), H, B), dk/dv pass
// (ceil(Tk / 64), H, B); 128 threads per block.

#include "attention_bwd_common.cuh"

namespace mmdiff {

// Element strides of one [B, H, T, D] operand (D is contiguous).
struct Strides {
  long long b, h, t;
};

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
extern "C" int mmdiff_flash_mha_fwd(const void* q, const void* k, const void* v, void* out,
                                    float* lse, int batch, int heads, int len_q, int len_k,
                                    int head_dim, int kernel_dim, float scale, long long q_sb,
                                    long long q_sh, long long q_st, long long k_sb,
                                    long long k_sh, long long k_st, long long o_sb,
                                    long long o_sh, long long o_st, int is_fp32, void* stream) {
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
  const mmdiff::Strides sq{q_sb, q_sh, q_st}, sk{k_sb, k_sh, k_st}, so{o_sb, o_sh, o_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp32)
    return mmdiff::dispatch_bwd<float>(q, k, v, out, dout, lse, delta, dq, dk, dv, batch, heads,
                                       len_q, len_k, head_dim, kernel_dim, scale, sq, sk, so, s);
  return mmdiff::dispatch_bwd<mmdiff::bf16>(q, k, v, out, dout, lse, delta, dq, dk, dv, batch,
                                            heads, len_q, len_k, head_dim, kernel_dim, scale, sq,
                                            sk, so, s);
}
