// The end of the image U-Net's ResBlocks in one pass over bf16 activations
// (ops/residual.py):
//
//   out = bf16(float(skip) + float(h) + b_c)
//
// skip, h and out of one layout: channels-last [N, H, W, C] (the memory of
// a torch.channels_last [N, C, H, W], the image U-Net's activations) or
// channels-first [N, C, ...]; b fp32 [C], the sum of the second conv's bias
// and the skip conv's.  The ResBlock runs both convs without a
// bias, so PyTorch's broadcast bias add after each (a whole read and write
// of its output, on the generic elementwise kernel) is gone, and this pass
// moves the bytes of the residual add it replaces: skip and h read once, out
// written once (6 bytes an element).  out may be h (the conv's temporary).
//
// It replaces no Pallas kernel: on the TPU, XLA fuses the JAX package's
// conv bias and residual add into the convolution's output.
//
// Bound: device memory.  Design: a block is rows x cols threads over rows of
// C channels, cols = C / 8, so a thread's 8 channels never change and their
// biases sit in registers; each thread keeps kUnroll 16-byte loads of each
// input in flight, then adds in fp32 and stores 16 bytes; the grid fills the
// card once (the blocks resident at once on every SM) and strides over the
// rows.  That path takes channels-last tensors with C % 8 == 0, C <= 8192
// and 16-byte aligned pointers.  Anything else -- another C, a view that
// starts off a 16-byte boundary, a channels-first [N, C, S] layout -- takes
// the strided path: one element a thread over a grid-stride loop, its
// channel (i / inner) % C, the same fp32 adds.

#include <algorithm>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mmdiff {
namespace ew {

using bf16 = __nv_bfloat16;

constexpr int kVec = 8;           // bf16 in a 16-byte vector
constexpr int kThreads = 256;     // a block's threads, about (C / 8 where that is more)
constexpr int kUnroll = 4;        // rows in flight a thread

struct ResidualArgs {
  const bf16* skip;
  const bf16* h;
  bf16* out;
  const float* bias;  // [C]
  long rows;          // N * H * W
  int cols;           // C / 8: threads along a row
  int rows_in_block;  // rows a block takes at once
};

__device__ __forceinline__ uint4 residual_vec(const uint4& s, const uint4& h, const float (&b)[kVec]) {
  const __nv_bfloat162* s2 = reinterpret_cast<const __nv_bfloat162*>(&s);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&h);
  uint4 q;
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 a = __bfloat1622float2(s2[i]);
    const float2 c = __bfloat1622float2(h2[i]);
    o2[i] = __floats2bfloat162_rn(a.x + c.x + b[2 * i], a.y + c.y + b[2 * i + 1]);
  }
  return q;
}

__global__ void __launch_bounds__(1024) residual_bias_elementwise_kernel(ResidualArgs a) {
  const int col = threadIdx.x % a.cols;
  const long row0 = (long)blockIdx.x * a.rows_in_block + threadIdx.x / a.cols;
  const long step = (long)gridDim.x * a.rows_in_block;
  const float4* bias4 = reinterpret_cast<const float4*>(a.bias + col * kVec);
  const float4 lo = __ldg(bias4), hi = __ldg(bias4 + 1);
  const float b[kVec] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const uint4* skip = reinterpret_cast<const uint4*>(a.skip) + col;
  const uint4* h = reinterpret_cast<const uint4*>(a.h) + col;  // plain loads: out may be h
  uint4* out = reinterpret_cast<uint4*>(a.out) + col;
  long r = row0;
  for (; r + (kUnroll - 1) * step < a.rows; r += kUnroll * step) {
    uint4 s[kUnroll], v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long i = (r + u * step) * a.cols;
      s[u] = __ldg(skip + i);
      v[u] = h[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) out[(r + u * step) * a.cols] = residual_vec(s[u], v[u], b);
  }
  for (; r < a.rows; r += step) {
    const long i = r * a.cols;
    out[i] = residual_vec(__ldg(skip + i), h[i], b);
  }
}

// The strided path: [outer, C, inner] memory (inner 1 for channels-last,
// the spatial size for channels-first), any C and alignment.
struct StridedArgs {
  const bf16* skip;
  const bf16* h;
  bf16* out;
  const float* bias;  // [C]
  long long n;        // outer * C * inner
  long long inner;
  int c;
};

__global__ void __launch_bounds__(kThreads) residual_bias_elementwise_strided_kernel(StridedArgs a) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += step) {
    const int ch = (int)((i / a.inner) % a.c);
    a.out[i] = __float2bfloat16_rn(__bfloat162float(a.skip[i]) + __bfloat162float(a.h[i]) + __ldg(a.bias + ch));
  }
}

}  // namespace ew
}  // namespace mmdiff

namespace {

// The blocks of `threads` threads resident at once on the whole card.
template <typename Kernel>
int card_blocks(Kernel kernel, int threads, long long needed, int* blocks) {
  static const int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev))
      return 132;
    return n;
  }();
  int per_sm = 0;
  const int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (err) return err;
  *blocks = (int)std::min<long long>(needed, (long long)sms * std::max(1, per_sm));
  return 0;
}

}  // namespace

// skip, h, out bf16 [outer, C, inner] of one layout (out may be h); bias
// [C] fp32.  inner == 1 (channels-last) with C % 8 == 0, C <= 8192 and
// 16-byte aligned pointers takes the vector path, anything else the
// strided one.  Returns the launch's error (0 on success;
// cudaErrorInvalidValue for an empty or negative shape).
extern "C" int mmdiff_residual_bias(const void* skip, const void* h, void* out, const void* bias,
                                    long long outer, int c, long long inner, void* stream) {
  using namespace mmdiff::ew;
  if (outer < 1 || c < 1 || inner < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(skip) | reinterpret_cast<uintptr_t>(h) |
                        reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(bias)) % 16 == 0;
  int blocks = 0, err = 0;
  if (inner == 1 && c % kVec == 0 && c / kVec <= 1024 && aligned) {
    ResidualArgs a;
    a.skip = static_cast<const bf16*>(skip);
    a.h = static_cast<const bf16*>(h);
    a.out = static_cast<bf16*>(out);
    a.bias = static_cast<const float*>(bias);
    a.rows = (long)outer;
    a.cols = c / kVec;
    a.rows_in_block = std::max(1, kThreads / a.cols);
    const int threads = a.cols * a.rows_in_block;
    err = card_blocks(residual_bias_elementwise_kernel, threads, (a.rows + a.rows_in_block - 1) / a.rows_in_block,
                      &blocks);
    if (err) return err;
    residual_bias_elementwise_kernel<<<(unsigned)blocks, threads, 0, s>>>(a);
  } else {
    StridedArgs a;
    a.skip = static_cast<const bf16*>(skip);
    a.h = static_cast<const bf16*>(h);
    a.out = static_cast<bf16*>(out);
    a.bias = static_cast<const float*>(bias);
    a.n = outer * c * inner;
    a.inner = inner;
    a.c = c;
    err = card_blocks(residual_bias_elementwise_strided_kernel, kThreads, (a.n + kThreads - 1) / kThreads, &blocks);
    if (err) return err;
    residual_bias_elementwise_strided_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
