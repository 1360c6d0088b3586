// The epilogue of a folded ConvBN in the detector's forward, for Hopper.
//
// Built with plain nvcc into a shared library with a C interface and bound
// from Python through ctypes (ops/epilogue.py). The launcher takes raw
// device pointers, the sizes and the caller's cudaStream_t, launches on
// that stream without synchronising, and returns cudaGetLastError().
//
// bias_silu_nhwc
//   Replaces no TPU kernel: the JAX package leaves the folded bias and
//   SiLU to XLA, which fuses them into the convolution. It exists to
//   remove PyTorch's broadcast bias add, which takes the generic,
//   unvectorised elementwise path, and the separate SiLU pass: one pass
//   over the convolution's channels-last (NHWC) output, in place,
//   y = silu(y + bias) or, for a ConvBN without activation, y = y + bias.
//   Its arithmetic is PyTorch's `y.add_(bias)` then `F.silu(y)` in the
//   activation's type T (bf16 or float32): the sum of the two T values in
//   float32, rounded to T; then x / (1 + expf(-x)) in float32 on that
//   rounded value, rounded to T. Correctly rounded adds and division and
//   libdevice's expf, with no fast-math, give the same bits.
//   Bound: bytes. It reads and writes each activation element once (2
//   bytes in bf16) and reads the bias from L2. In NHWC the channels are
//   the innermost axis and C is a multiple of 8, so every 16-byte vector
//   (8 bf16 or 4 float32) lies inside one pixel's channels. The grid's
//   stride in vectors is made a multiple of C's vectors, so a thread meets
//   the same channels on every step: it loads its bias vector once and
//   never takes a modulo in the loop. Each thread keeps four 16-byte loads
//   in flight before it stores.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// blocks launched an SM: 2048 threads' worth. The bf16 SiLU variant's 57
// registers let an SM hold 4 of them at once, so its grid runs in two
// waves; a grid of one wave (4 an SM) measured no faster on an H100.
constexpr int kBlocksPerSm = 2048 / kThreads;
constexpr int kUnroll = 4;

union Pack16 {
  uint4 u;
  float f[4];
  unsigned short h[8];
};

__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.0f, expf(-x)));
}

__device__ __forceinline__ float bf16_to_float(unsigned short h) {
  return __bfloat162float(__ushort_as_bfloat16(h));
}

__device__ __forceinline__ unsigned short float_to_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

template <bool kBf16, bool kAct>
__device__ __forceinline__ void finish(Pack16& v, const Pack16& b) {
  if (kBf16) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      unsigned short s = float_to_bf16(
          __fadd_rn(bf16_to_float(v.h[k]), bf16_to_float(b.h[k])));
      if (kAct) s = float_to_bf16(silu(bf16_to_float(s)));
      v.h[k] = s;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float s = __fadd_rn(v.f[k], b.f[k]);
      v.f[k] = kAct ? silu(s) : s;
    }
  }
}

// y: [N, H, W, C] as n_vec 16-byte vectors, C = c_vec vectors; bias: C.
// The launcher makes gridDim.x * kThreads a multiple of c_vec.
template <bool kBf16, bool kAct>
__global__ void __launch_bounds__(kThreads)
bias_silu_nhwc_kernel(uint4* __restrict__ y, const uint4* __restrict__ bias,
                      long long n_vec, int c_vec) {
  const long long step = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  Pack16 b;
  b.u = bias[i % c_vec];
  for (; i + (kUnroll - 1) * step < n_vec; i += kUnroll * step) {
    Pack16 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u].u = y[i + u * step];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      finish<kBf16, kAct>(v[u], b);
      y[i + u * step] = v[u].u;
    }
  }
  for (; i < n_vec; i += step) {
    Pack16 v;
    v.u = y[i];
    finish<kBf16, kAct>(v, b);
    y[i] = v.u;
  }
}

long long gcd(long long a, long long b) {
  while (b) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return a;
}

}  // namespace

extern "C" {

// y: bf16 (bf16 != 0) or float32, channels-last [N, C, H, W] of numel
// elements, updated in place; bias: C of the same type. Both 16-byte
// aligned, C a multiple of 8 (the wrapper checks).
int bias_silu_nhwc_launch(void* y, const void* bias, long long numel,
                          int channels, int act, int bf16, void* stream) {
  if (numel <= 0) return (int)cudaSuccess;
  const int per_vec = bf16 ? 8 : 4;
  if (channels <= 0 || channels % per_vec || numel % channels)
    return (int)cudaErrorInvalidValue;
  const long long n_vec = numel / per_vec;
  const int c_vec = channels / per_vec;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // blocks: at most kBlocksPerSm an SM, a multiple of `unit` so that the
  // grid's stride is a multiple of c_vec
  const long long unit = c_vec / gcd(kThreads, c_vec);
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * kBlocksPerSm)
    blocks = (long long)sms * kBlocksPerSm;
  blocks = (blocks + unit - 1) / unit * unit;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  uint4* yv = (uint4*)y;
  const uint4* bv = (const uint4*)bias;
  if (bf16 && act)
    bias_silu_nhwc_kernel<true, true><<<(unsigned)blocks, kThreads, 0, s>>>(
        yv, bv, n_vec, c_vec);
  else if (bf16)
    bias_silu_nhwc_kernel<true, false><<<(unsigned)blocks, kThreads, 0, s>>>(
        yv, bv, n_vec, c_vec);
  else if (act)
    bias_silu_nhwc_kernel<false, true><<<(unsigned)blocks, kThreads, 0, s>>>(
        yv, bv, n_vec, c_vec);
  else
    bias_silu_nhwc_kernel<false, false><<<(unsigned)blocks, kThreads, 0, s>>>(
        yv, bv, n_vec, c_vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
