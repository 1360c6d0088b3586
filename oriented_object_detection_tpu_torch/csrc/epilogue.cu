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
//   the innermost axis, so a vector of the widest of 16, 8, 4 and 2 bytes
//   that divides one pixel's channels (and both pointers' alignment) lies
//   inside one pixel: 16 bytes (8 bf16 or 4 float32) for C a multiple of
//   8, as every YOLO11 layer; 8 for YOLO12's MLP at x (C = 460). The
//   grid's stride in vectors is made a multiple of C's vectors, so a
//   thread meets the same channels on every step: it loads its bias vector
//   once and never takes a modulo in the loop. Each thread keeps four
//   vector loads in flight before it stores.

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

template <int kBytes>
struct Vec;
template <>
struct Vec<16> {
  using T = uint4;
};
template <>
struct Vec<8> {
  using T = uint2;
};
template <>
struct Vec<4> {
  using T = unsigned int;
};
template <>
struct Vec<2> {
  using T = unsigned short;
};

template <int kBytes>
union Pack {
  typename Vec<kBytes>::T u;
  float f[kBytes >= 4 ? kBytes / 4 : 1];
  unsigned short h[kBytes / 2];
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

template <bool kBf16, bool kAct, int kBytes>
__device__ __forceinline__ void finish(Pack<kBytes>& v,
                                       const Pack<kBytes>& b) {
  if (kBf16) {
#pragma unroll
    for (int k = 0; k < kBytes / 2; ++k) {
      unsigned short s = float_to_bf16(
          __fadd_rn(bf16_to_float(v.h[k]), bf16_to_float(b.h[k])));
      if (kAct) s = float_to_bf16(silu(bf16_to_float(s)));
      v.h[k] = s;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kBytes / 4; ++k) {
      const float s = __fadd_rn(v.f[k], b.f[k]);
      v.f[k] = kAct ? silu(s) : s;
    }
  }
}

// y: [N, H, W, C] as n_vec vectors of kBytes, C = c_vec vectors; bias: C.
// The launcher makes gridDim.x * kThreads a multiple of c_vec.
template <bool kBf16, bool kAct, int kBytes>
__global__ void __launch_bounds__(kThreads)
bias_silu_nhwc_kernel(typename Vec<kBytes>::T* __restrict__ y,
                      const typename Vec<kBytes>::T* __restrict__ bias,
                      long long n_vec, int c_vec) {
  const long long step = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  Pack<kBytes> b;
  b.u = bias[i % c_vec];
  for (; i + (kUnroll - 1) * step < n_vec; i += kUnroll * step) {
    Pack<kBytes> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u].u = y[i + u * step];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      finish<kBf16, kAct, kBytes>(v[u], b);
      y[i + u * step] = v[u].u;
    }
  }
  for (; i < n_vec; i += step) {
    Pack<kBytes> v;
    v.u = y[i];
    finish<kBf16, kAct, kBytes>(v, b);
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

template <bool kBf16, bool kAct, int kBytes>
void launch_kernel(void* y, const void* bias, long long n_vec, int c_vec,
                   long long blocks, cudaStream_t s) {
  using T = typename Vec<kBytes>::T;
  bias_silu_nhwc_kernel<kBf16, kAct, kBytes>
      <<<(unsigned)blocks, kThreads, 0, s>>>((T*)y, (const T*)bias, n_vec,
                                             c_vec);
}

template <bool kBf16, int kBytes>
void launch_act(void* y, const void* bias, long long n_vec, int c_vec,
                long long blocks, int act, cudaStream_t s) {
  if (act)
    launch_kernel<kBf16, true, kBytes>(y, bias, n_vec, c_vec, blocks, s);
  else
    launch_kernel<kBf16, false, kBytes>(y, bias, n_vec, c_vec, blocks, s);
}

}  // namespace

extern "C" {

// y: bf16 (bf16 != 0) or float32, channels-last [N, C, H, W] of numel
// elements, updated in place; bias: C of the same type; both aligned to
// their element. The vector is the widest of 16, 8, 4 and 2 bytes (at
// least one element) that divides one pixel's channels and both
// pointers' addresses.
int bias_silu_nhwc_launch(void* y, const void* bias, long long numel,
                          int channels, int act, int bf16, void* stream) {
  if (numel <= 0) return (int)cudaSuccess;
  const int elem = bf16 ? 2 : 4;
  if (channels <= 0 || numel % channels) return (int)cudaErrorInvalidValue;
  const long long row = (long long)channels * elem;
  int bytes = 16;
  while (bytes > elem && (row % bytes || (uintptr_t)y % bytes ||
                          (uintptr_t)bias % bytes))
    bytes /= 2;
  if ((uintptr_t)y % bytes || (uintptr_t)bias % bytes)
    return (int)cudaErrorMisalignedAddress;
  const long long n_vec = numel * elem / bytes;
  const int c_vec = (int)(row / bytes);
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
  if (bf16) {
    switch (bytes) {
      case 16: launch_act<true, 16>(y, bias, n_vec, c_vec, blocks, act, s);
        break;
      case 8: launch_act<true, 8>(y, bias, n_vec, c_vec, blocks, act, s);
        break;
      case 4: launch_act<true, 4>(y, bias, n_vec, c_vec, blocks, act, s);
        break;
      default: launch_act<true, 2>(y, bias, n_vec, c_vec, blocks, act, s);
    }
  } else {
    switch (bytes) {
      case 16: launch_act<false, 16>(y, bias, n_vec, c_vec, blocks, act, s);
        break;
      case 8: launch_act<false, 8>(y, bias, n_vec, c_vec, blocks, act, s);
        break;
      default: launch_act<false, 4>(y, bias, n_vec, c_vec, blocks, act, s);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
