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
//   unvectorised elementwise path, the separate SiLU pass, and, since the
//   blocks build their concatenations in place (models/layers.py), each
//   residual add and each torch.cat pass: one pass over the convolution's
//   packed channels-last (NHWC) output y,
//     v = silu(y + bias)   (or y + bias for a ConvBN without activation),
//     v = scale * v        (optional, with a residual: A2C2f's gamma),
//     v = residual + v     (optional: a residual block's input),
//   stored to one or two destinations, each a run of v's channels
//   [first, first + count) stored at a pixel stride of its own: in place
//   (y itself), a channel slice of a concatenation buffer, a packed tensor.
//   Its arithmetic is PyTorch's `y.add_(bias)`, `F.silu(y)`, `scale * y`,
//   `residual + y` in the activation's type T (bf16 or float32): each step
//   in float32 on the T operands, rounded to T; silu(x) = x / (1 + expf(-x)).
//   Correctly rounded adds, products and division (the _rn intrinsics,
//   never contracted into an FMA) and libdevice's expf, with no fast-math,
//   give the same bits.
//   Bound: bytes. It reads each element of y (and of the residual) once,
//   writes each stored element once (2 bytes in bf16), and reads bias and
//   scale from L2. In NHWC the channels are the innermost axis, so a vector
//   of the widest of 16, 8, 4 and 2 bytes that divides one pixel's
//   channels, every pixel stride and channel run, and every pointer's
//   alignment lies inside one pixel of each tensor: 16 bytes (8 bf16 or 4
//   float32) for C a multiple of 8, as every YOLO11 layer and every
//   concatenation slice; 8 for YOLO12's MLP at x (C = 460). The grid's
//   stride in vectors is made a multiple of C's vectors, so a thread meets
//   the same channels on every step: it loads its bias (and scale) vector
//   once, decides once which destinations it stores to, and never takes a
//   modulo in the loop. Each thread keeps four vector loads of y (and four
//   of the residual) in flight before it stores. A variant without a
//   residual is held to 64 registers, so that an SM holds 4 of its blocks;
//   the grid is twice what the SMs hold at once of the variant launched.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <initializer_list>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// blocks an SM holds at once of a variant without a residual (at most 64
// registers a thread); one with a residual reads twice the streams and
// takes more registers, so fewer of its blocks fit
constexpr int kResidentBlocks = 4;
// the grid: kWaves times the blocks the SMs hold at once, so it runs in
// whole waves; a grid of one wave measured no faster on an H100
constexpr int kWaves = 2;
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

template <bool kBf16, bool kAct, bool kRes, int kBytes>
__device__ __forceinline__ void finish(Pack<kBytes>& v,
                                       const Pack<kBytes>& b,
                                       const Pack<kBytes>& g, bool scaled,
                                       const Pack<kBytes>& r) {
  if (kBf16) {
#pragma unroll
    for (int k = 0; k < kBytes / 2; ++k) {
      unsigned short s = float_to_bf16(
          __fadd_rn(bf16_to_float(v.h[k]), bf16_to_float(b.h[k])));
      if (kAct) s = float_to_bf16(silu(bf16_to_float(s)));
      if (scaled)
        s = float_to_bf16(
            __fmul_rn(bf16_to_float(g.h[k]), bf16_to_float(s)));
      if (kRes)
        s = float_to_bf16(
            __fadd_rn(bf16_to_float(r.h[k]), bf16_to_float(s)));
      v.h[k] = s;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kBytes / 4; ++k) {
      float s = __fadd_rn(v.f[k], b.f[k]);
      if (kAct) s = silu(s);
      if (scaled) s = __fmul_rn(g.f[k], s);
      if (kRes) s = __fadd_rn(r.f[k], s);
      v.f[k] = s;
    }
  }
}

// A destination, in vectors: source channels [first, first + count) of
// pixel q go to p[q * stride + (channel - first)].
template <typename V>
struct Dest {
  V* p;
  long long stride;
  int first, count;
};

// y: [N, H, W, C] packed, n_vec vectors of kBytes, C = c_vec vectors;
// bias: C; res: [N, H, W, >= C] at pixel stride res_stride vectors, and
// scale: C or nullptr (kRes only). y is not restrict: in place, d0.p is y.
// The launcher makes step = gridDim.x * kThreads a multiple of c_vec, so a
// thread keeps its channel vector c and steps q_step pixels at a time: it
// walks each tensor with a pointer of its own, advanced by that tensor's
// step (each of which the launcher keeps within an int).
template <bool kBf16, bool kAct, bool kRes, int kBytes>
__global__ void __launch_bounds__(kThreads, kRes ? 1 : kResidentBlocks)
bias_silu_nhwc_kernel(const typename Vec<kBytes>::T* y,
                      const typename Vec<kBytes>::T* __restrict__ bias,
                      const typename Vec<kBytes>::T* __restrict__ scale,
                      const typename Vec<kBytes>::T* res,
                      long long res_stride,
                      Dest<typename Vec<kBytes>::T> d0,
                      Dest<typename Vec<kBytes>::T> d1, long long n_vec,
                      int c_vec) {
  using T = typename Vec<kBytes>::T;
  const int step = gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int c = (int)(i % c_vec);
  const long long q = i / c_vec;
  const int q_step = step / c_vec;
  const bool w0 = c >= d0.first && c < d0.first + d0.count;
  const bool w1 = c >= d1.first && c < d1.first + d1.count;
  if (!w0 && !w1) return;
  // the pointers of the unused destinations and residual are never read
  const int s0 = q_step * (int)d0.stride, s1 = q_step * (int)d1.stride;
  const int sr = q_step * (int)res_stride;
  const T* yp = y + i;
  T* p0 = d0.p + (w0 ? q * d0.stride + (c - d0.first) : 0);
  T* p1 = d1.p + (w1 ? q * d1.stride + (c - d1.first) : 0);
  const T* rp = kRes ? res + q * res_stride + c : res;
  const bool scaled = kRes && scale != nullptr;
  Pack<kBytes> b, g;
  b.u = bias[c];
  g.u = scaled ? scale[c] : b.u;
  for (; i + (kUnroll - 1) * step < n_vec; i += kUnroll * step,
       yp += kUnroll * step, p0 += kUnroll * s0, p1 += kUnroll * s1,
       rp += kUnroll * sr) {
    Pack<kBytes> v[kUnroll], r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u].u = yp[u * step];
    if (kRes) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) r[u].u = rp[u * sr];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      finish<kBf16, kAct, kRes, kBytes>(v[u], b, g, scaled,
                                        kRes ? r[u] : b);
      if (w0) p0[u * s0] = v[u].u;
      if (w1) p1[u * s1] = v[u].u;
    }
  }
  for (; i < n_vec; i += step, yp += step, p0 += s0, p1 += s1, rp += sr) {
    Pack<kBytes> v, r;
    v.u = *yp;
    r.u = kRes ? *rp : b.u;
    finish<kBf16, kAct, kRes, kBytes>(v, b, g, scaled, r);
    if (w0) *p0 = v.u;
    if (w1) *p1 = v.u;
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

// The kernel's arguments in elements, as the C interface takes them.
struct Args {
  const void *y, *bias, *scale, *res;
  long long res_stride;
  void* d[2];
  long long stride[2];
  int first[2], count[2];
};

// Sizes the grid of one variant and launches it: kWaves times the blocks
// the SMs hold at once (its occupancy, asked once), rounded up to a
// multiple of `unit` so that the grid's stride is a multiple of c_vec.
template <bool kBf16, bool kAct, bool kRes, int kBytes>
cudaError_t launch_kernel(const Args& a, int elem, long long n_vec, int c_vec,
                          int sms, cudaStream_t s) {
  using T = typename Vec<kBytes>::T;
  const auto kernel = bias_silu_nhwc_kernel<kBf16, kAct, kRes, kBytes>;
  static int resident = 0;
  if (!resident) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
  }
  const long long unit = c_vec / gcd(kThreads, c_vec);
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * resident * kWaves)
    blocks = (long long)sms * resident * kWaves;
  blocks = (blocks + unit - 1) / unit * unit;
  const int per = kBytes / elem;  // elements a vector
  // the kernel's steps in vectors, kUnroll of them at once, are ints
  const long long pixels = kUnroll * blocks * kThreads / c_vec;
  for (long long stride : {(long long)c_vec * per, a.stride[0], a.stride[1],
                           a.res_stride})
    if (pixels * (stride / per) > INT_MAX)
      return cudaErrorInvalidConfiguration;
  Dest<T> d[2];
  for (int k = 0; k < 2; ++k)
    d[k] = {(T*)a.d[k], a.stride[k] / per, a.first[k] / per,
            a.count[k] / per};
  kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      (const T*)a.y, (const T*)a.bias, (const T*)a.scale, (const T*)a.res,
      a.res_stride / per, d[0], d[1], n_vec, c_vec);
  return cudaGetLastError();
}

template <bool kBf16, int kBytes>
cudaError_t launch_mode(const Args& a, int elem, long long n_vec, int c_vec,
                        int sms, int act, cudaStream_t s) {
  if (act)
    return a.res ? launch_kernel<kBf16, true, true, kBytes>(
                       a, elem, n_vec, c_vec, sms, s)
                 : launch_kernel<kBf16, true, false, kBytes>(
                       a, elem, n_vec, c_vec, sms, s);
  return a.res ? launch_kernel<kBf16, false, true, kBytes>(
                     a, elem, n_vec, c_vec, sms, s)
               : launch_kernel<kBf16, false, false, kBytes>(
                     a, elem, n_vec, c_vec, sms, s);
}

bool divides(long long bytes, const Args& a, long long row, int elem) {
  if (row % bytes) return false;
  for (const void* p : {a.y, a.bias, a.scale, a.res, (const void*)a.d[0],
                        (const void*)a.d[1]})
    if ((uintptr_t)p % bytes) return false;
  if (a.res && (a.res_stride * elem) % bytes) return false;
  for (int k = 0; k < 2; ++k)
    if ((a.stride[k] * elem) % bytes || ((long long)a.first[k] * elem) %
        bytes || ((long long)a.count[k] * elem) % bytes)
      return false;
  return true;
}

}  // namespace

extern "C" {

// y: bf16 (bf16 != 0) or float32, packed channels-last [N, C, H, W] of
// numel elements; bias: C of the same type; scale: C or nullptr; res:
// nullptr or [N, C, H, W] with unit channel stride and pixels res_stride
// elements apart. Destination k (d1 == nullptr or count1 == 0: none)
// receives channels [first_k, first_k + count_k) of each pixel at pixel
// stride stride_k elements; d0 == y, stride0 == C, first0 == 0, count0 ==
// C is the in-place pass. Every pointer aligned to its element. The vector
// is the widest of 16, 8, 4 and 2 bytes (at least one element) that
// divides one pixel's channels, every stride, first channel and count in
// bytes, and every pointer's address.
int bias_silu_nhwc_launch(const void* y, const void* bias, const void* scale,
                          const void* res, long long res_stride, void* d0,
                          long long stride0, int first0, int count0,
                          void* d1, long long stride1, int first1,
                          int count1, long long numel, int channels, int act,
                          int bf16, void* stream) {
  if (numel <= 0) return (int)cudaSuccess;
  const int elem = bf16 ? 2 : 4;
  if (channels <= 0 || numel % channels || !d0 || first0 < 0 || count0 <= 0
      || first0 + count0 > channels || stride0 < count0
      || (res && res_stride < channels) || (scale && !res))
    return (int)cudaErrorInvalidValue;
  if (!d1) count1 = 0;
  if (count1 && (first1 < 0 || first1 + count1 > channels
                 || stride1 < count1))
    return (int)cudaErrorInvalidValue;
  const Args a = {y, bias, scale, res, res_stride,
                  {d0, count1 ? d1 : nullptr}, {stride0, count1 ? stride1 : 0},
                  {first0, count1 ? first1 : 0}, {count0, count1}};
  const long long row = (long long)channels * elem;
  int bytes = 16;
  while (bytes > elem && !divides(bytes, a, row, elem)) bytes /= 2;
  if (!divides(bytes, a, row, elem)) return (int)cudaErrorMisalignedAddress;
  const long long n_vec = numel * elem / bytes;
  const int c_vec = (int)(row / bytes);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    switch (bytes) {
      case 16: return (int)launch_mode<true, 16>(a, elem, n_vec, c_vec, sms,
                                                 act, s);
      case 8: return (int)launch_mode<true, 8>(a, elem, n_vec, c_vec, sms,
                                               act, s);
      case 4: return (int)launch_mode<true, 4>(a, elem, n_vec, c_vec, sms,
                                               act, s);
      default: return (int)launch_mode<true, 2>(a, elem, n_vec, c_vec, sms,
                                                act, s);
    }
  }
  switch (bytes) {
    case 16: return (int)launch_mode<false, 16>(a, elem, n_vec, c_vec, sms,
                                                 act, s);
    case 8: return (int)launch_mode<false, 8>(a, elem, n_vec, c_vec, sms,
                                              act, s);
    default: return (int)launch_mode<false, 4>(a, elem, n_vec, c_vec, sms,
                                               act, s);
  }
}

}  // extern "C"
