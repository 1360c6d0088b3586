// Exact Euclidean distance transform, the two separable passes, for Hopper.
//
// Built with plain nvcc into a shared library with a C interface and bound
// from Python through ctypes (ops/edt.py). Every launcher takes raw device
// pointers, the shapes and the caller's cudaStream_t, launches on that
// stream without synchronising, and returns cudaGetLastError() so that a
// refused launch is reported at once.
//
// K1  edt_pass1_columns
//   Replaces oriented_object_detection_tpu/ops/edt.py:67
//   `_edt_pass1_columns_pallas` (pallas_call at :110), capped like it:
//   out[b, i, j] = min(|i - k| over edge pixels k of column j, 1e9).
//   Bound: bytes. It reads one mask byte and writes one float per pixel, a
//   few integer operations each. The TPU kernel used log-step doubling
//   because a serial scan is slow on its vector unit and VMEM capped H at
//   2048. Here one thread owns one (image, column) and runs a forward and
//   a backward linear sweep: neighbouring threads hold neighbouring
//   columns, so each row step of a warp is one coalesced access, and there
//   is no height cap.
//
// K2  edt_pass2_rows
//   Replaces oriented_object_detection_tpu/ops/edt.py:199
//   `_edt_pass2_rows_pallas` (pallas_call at :286) together with its
//   band-radius companion `_band_radius` (:154).
//   out[n, j] = min over k of fsq[n, k] + (j - k)^2, fsq = min(d0, 1e9)^2.
//   Bound: operations on rows whose pixels lie far from any edge, bytes on
//   dense rows. One block owns one row and stages fsq in shared memory
//   (W * 4 bytes); each thread owns output columns j and scans offsets
//   0, +1, -1, +2, ... until delta^2 exceeds its own best so far or both
//   sides have left the row. Every further candidate is at least delta^2,
//   so the result is exact, and the per-pixel exit takes the place of the
//   TPU's per-strip radius bound. Each candidate is fsq[k] + delta*delta
//   in float32, the same operation as the reference's `f + para`, and the
//   minimum does not depend on the order of the scan, so the output is
//   bit-equal to the brute force.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1e9f;

__global__ void edt_pass1_columns_kernel(const uint8_t* __restrict__ mask,
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

__global__ void edt_pass2_rows_kernel(const float* __restrict__ d0,
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
int edt_pass1_columns_launch(const void* mask, void* out, int B, int H,
                             int W, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const int threads = 32;
  const dim3 grid((W + threads - 1) / threads, B);
  edt_pass1_columns_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (float*)out, H, W);
  return (int)cudaGetLastError();
}

// d0: float32 [N, W] column distances. out: float32 [N, W] squared EDT.
int edt_pass2_rows_launch(const void* d0, void* out, int N, int W,
                          void* stream) {
  if (N <= 0 || W <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)W * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        edt_pass2_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = W < 256 ? ((W + 31) / 32) * 32 : 256;
  edt_pass2_rows_kernel<<<N, threads, smem, (cudaStream_t)stream>>>(
      (const float*)d0, (float*)out, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
