// The first version of the two EDT kernels, kept as the yardstick that
// chip_smoke.py times beside the redesigned ones in edt.cu, on the same
// inputs in the same run. The package never loads this file.
//
// K1: one thread per (image, column), a serial sweep down and back up.
// K2: one 256-thread block per row, the row staged in shared memory, a
// per-pixel scan that stops once delta^2 exceeds the pixel's best. It
// writes the SQUARED distance; edt.cu's K2 writes the distance.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1e9f;

__global__ void edt_v1_pass1_columns_kernel(const uint8_t* __restrict__ mask,
                                         float* __restrict__ out, int H,
                                         int W) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= W) return;
  const size_t base = (size_t)blockIdx.y * H * W + j;
  const uint8_t* m = mask + base;
  float* o = out + base;
  // distance to the nearest edge above (forward) then below (backward);
  // -1 marks "no edge seen yet"
  int d = -1;
  for (int i = 0; i < H; ++i) {
    d = m[(size_t)i * W] ? 0 : (d < 0 ? -1 : d + 1);
    o[(size_t)i * W] = d < 0 ? kInf : (float)d;
  }
  d = -1;
  for (int i = H - 1; i >= 0; --i) {
    d = m[(size_t)i * W] ? 0 : (d < 0 ? -1 : d + 1);
    if (d >= 0) {
      const float up = o[(size_t)i * W];
      o[(size_t)i * W] = fminf(up, (float)d);
    }
  }
}

__global__ void edt_v1_pass2_rows_kernel(const float* __restrict__ d0,
                                      float* __restrict__ out, int W) {
  extern __shared__ float fsq[];
  const size_t row = (size_t)blockIdx.x * W;
  for (int k = threadIdx.x; k < W; k += blockDim.x) {
    const float f = fminf(d0[row + k], kInf);
    fsq[k] = __fmul_rn(f, f);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    float best = fsq[j];
    for (int delta = 1;; ++delta) {
      // _rn intrinsics: the compiler must not contract the square and the
      // add into one fused multiply-add, whose single rounding could differ
      // from the reference's two roundings once delta^2 passes 2^24
      const float dd = __fmul_rn((float)delta, (float)delta);
      if (dd > best) break;
      const bool right = j + delta < W;
      const bool left = j - delta >= 0;
      if (!right && !left) break;
      if (right) best = fminf(best, __fadd_rn(fsq[j + delta], dd));
      if (left) best = fminf(best, __fadd_rn(fsq[j - delta], dd));
    }
    out[row + j] = best;
  }
}

}  // namespace

extern "C" {

// mask: uint8 or bool [B, H, W], nonzero = edge. out: float32 [B, H, W].
int edt_v1_pass1_columns_launch(const void* mask, void* out, int B, int H,
                             int W, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const int threads = 32;
  const dim3 grid((W + threads - 1) / threads, B);
  edt_v1_pass1_columns_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (float*)out, H, W);
  return (int)cudaGetLastError();
}

// d0: float32 [N, W] column distances. out: float32 [N, W] squared EDT.
int edt_v1_pass2_rows_launch(const void* d0, void* out, int N, int W,
                          void* stream) {
  if (N <= 0 || W <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)W * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        edt_v1_pass2_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = W < 256 ? ((W + 31) / 32) * 32 : 256;
  edt_v1_pass2_rows_kernel<<<N, threads, smem, (cudaStream_t)stream>>>(
      (const float*)d0, (float*)out, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
