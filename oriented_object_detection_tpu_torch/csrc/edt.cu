// Exact Euclidean distance transform, the two separable passes, for Hopper.
//
// Built with plain nvcc into a shared library with a C interface and bound
// from Python through ctypes (ops/edt.py). Every launcher takes raw device
// pointers, the shapes and the caller's cudaStream_t, launches on that
// stream without synchronising, and returns cudaGetLastError() so that a
// refused launch is reported at once. The whole transform is these two
// launches: K2 writes the final distance.
//
// K1  edt_pass1_columns
//   Replaces oriented_object_detection_tpu/ops/edt.py:67
//   `_edt_pass1_columns_pallas` (pallas_call at :110), capped like it:
//   out[b, i, j] = min(|i - k| over edge pixels k of column j, 1e9).
//   Bound: bytes. It reads one mask byte and writes one float per pixel.
//   The TPU kernel used log-step doubling because a serial scan is slow on
//   its vector unit, and VMEM capped H at 2048. A serial sweep per column
//   has too little parallelism on this card (one thread per column is a
//   chain of 2H dependent accesses), so here a block owns a strip of 32
//   columns of one image and cuts each column into 32-row segments, one
//   warp per segment, up to 32 warps. A thread reads its segment's 32 mask
//   bytes as independent loads (a warp reads 32 neighbouring columns of one
//   row) and packs them into one 32-bit word. The segments' first and last
//   edges meet in shared memory, after which every row of the segment
//   finds its nearest edge above and below with one __clz/__ffs, and the
//   warp stores 32 neighbouring floats of each row. Columns taller than one
//   block's segments are walked in groups of segments: a bottom-up sweep
//   finds the first edge below each group and parks it, as int bits, in the
//   first output row of the group, where the same thread reads it back
//   before the top-down sweep overwrites that row. There is no height cap.
//
// K2  edt_pass2_rows
//   Replaces oriented_object_detection_tpu/ops/edt.py:199
//   `_edt_pass2_rows_pallas` (pallas_call at :286) together with its
//   band-radius companion `_band_radius` (:154) and the sqrt that follows
//   them in `edt_l2`:
//   out[n, j] = sqrt(min(min_k fsq[n, k] + (j - k)^2, 1e18)),
//   fsq = min(d0, 1e9)^2.
//   Bound: bytes on rows near edges; on rows through blank regions the
//   scan's instructions and shared-memory loads, since a pixel at distance
//   D must look at about D columns on each side. Blocks are 4 warps; a row
//   gets enough warps for about 8 pixels a lane (2 warps at width 416, so
//   a block takes 2 rows), staged in shared memory with 16-byte loads
//   where the row allows and one barrier. Neighbouring pixels sit on
//   neighbouring lanes: their distances differ by at most 1, so the lanes'
//   scans are about as long. Each lane scans offsets out from its pixel in
//   chunks of 8, both sides at once, 16 independent candidates between two
//   exit tests, which keeps the dependent chain through the running
//   minimum short. It stops once rowmin + delta^2 reaches its best so far
//   (rowmin: the row's least fsq; every candidate left is at least that),
//   which ends an edge-free row at once. Columns before the row's first
//   and after its last column with an edge in the image are capped
//   (fsq = 1e18) and can never win, so a pixel beyond them starts its scan
//   at the nearest such column: the pad of a tile that overhangs the map
//   costs nothing. Each candidate is fsq[k] + delta*delta in float32 with
//   __fmul_rn/__fadd_rn (no FMA contraction), the same operations as the
//   reference's `f + para`, and a minimum does not depend on the order of
//   the scan or on extra in-row candidates, so the result is bit-equal to
//   the brute force. __fsqrt_rn is correctly rounded, as is the
//   reference's sqrt.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1e9f;
constexpr float kInfSq = 1e18f;

// ---------------------------------------------------------------------------
// K1
// ---------------------------------------------------------------------------

constexpr int kSegRows = 32;   // rows of a segment: one bit each in a word
constexpr int kMaxSegs = 32;   // segments (warps) of a block
constexpr int kNoEdgeAbove = -1;
constexpr int kNoEdgeBelow = INT_MAX;

// Bit r is set when row row0 + r of the column at `col` is an edge.
__device__ __forceinline__ uint32_t segment_bits(
    const uint8_t* __restrict__ col, int row0, int H, int W, bool active) {
  uint32_t bits = 0;
  if (!active) return bits;
  const int n = H - row0;
#pragma unroll
  for (int r = 0; r < kSegRows; ++r)
    if (r < n && col[(size_t)(row0 + r) * W]) bits |= 1u << r;
  return bits;
}

__global__ void __launch_bounds__(kSegRows * kMaxSegs)
    edt_pass1_columns_kernel(const uint8_t* __restrict__ mask,
                             float* __restrict__ out, int H, int W,
                             int strips) {
  __shared__ int seg_first[kMaxSegs][32];
  __shared__ int seg_last[kMaxSegs][32];
  __shared__ int parked[32];
  const int lane = threadIdx.x, seg = threadIdx.y, S = blockDim.y;
  const int col = (int)(blockIdx.x % strips) * 32 + lane;
  const size_t img = blockIdx.x / strips;
  const bool active = col < W;
  const size_t base = img * H * W + col;
  const uint8_t* m = mask + base;
  float* o = out + base;
  const int group_rows = S * kSegRows;
  const int groups = (H + group_rows - 1) / group_rows;

  // Bottom-up: the first edge below group g - 1, parked in its first row.
  int below = kNoEdgeBelow;
  for (int g = groups - 1; g >= 1; --g) {
    const int row0 = g * group_rows + seg * kSegRows;
    const uint32_t bits = segment_bits(m, row0, H, W, active);
    seg_first[seg][lane] = bits ? row0 + __ffs((int)bits) - 1 : kNoEdgeBelow;
    __syncthreads();
    if (seg == 0) {
      for (int s = 0; s < S; ++s) below = min(below, seg_first[s][lane]);
      if (active) o[(size_t)(g - 1) * group_rows * W] = __int_as_float(below);
    }
    __syncthreads();
  }

  // Top-down: `above` is the last edge of the groups already written.
  int above = kNoEdgeAbove;
  for (int g = 0; g < groups; ++g) {
    const int row0 = g * group_rows + seg * kSegRows;
    const uint32_t bits = segment_bits(m, row0, H, W, active);
    seg_first[seg][lane] = bits ? row0 + __ffs((int)bits) - 1 : kNoEdgeBelow;
    seg_last[seg][lane] = bits ? row0 + 31 - __clz((int)bits) : kNoEdgeAbove;
    if (seg == 0)
      parked[lane] = g + 1 < groups && active
                         ? __float_as_int(o[(size_t)g * group_rows * W])
                         : kNoEdgeBelow;
    __syncthreads();
    int up = above, down = parked[lane];
    for (int s = 0; s < S; ++s) {
      const int last = seg_last[s][lane];
      above = max(above, last);
      if (s < seg) up = max(up, last);
      if (s > seg) down = min(down, seg_first[s][lane]);
    }
    if (active) {
#pragma unroll
      for (int r = 0; r < kSegRows; ++r) {
        const int i = row0 + r;
        if (i >= H) break;
        // edges of the segment at or above row i, and at or below it
        const uint32_t at_or_above = bits & ((2u << r) - 1u);
        const uint32_t at_or_below = bits >> r;
        const int a = at_or_above ? row0 + 31 - __clz((int)at_or_above) : up;
        const int c = at_or_below ? i + __ffs((int)at_or_below) - 1 : down;
        const int d = min(a != kNoEdgeAbove ? i - a : INT_MAX,
                          c != kNoEdgeBelow ? c - i : INT_MAX);
        o[(size_t)i * W] = d == INT_MAX ? kInf : fminf((float)d, kInf);
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 128;               // threads of a block
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kRowPixelsPerLane = 8;           // pixels a lane aims to own
constexpr int kChunk = 8;                      // offsets scanned per step
constexpr int kPad = 8;                        // +inf floats on each side
// floats of shared memory before the rows: each warp's row minimum and
// its first and last column below the cap; a multiple of 4, so that the
// rows that follow stay 16-byte aligned
constexpr int kRowHeader = 3 * kRowWarps;
static_assert(kRowHeader % 4 == 0 && kPad % 4 == 0 && kPad >= kChunk - 1,
              "row alignment and pad");

// warps of a row: enough for about kRowPixelsPerLane pixels a lane
inline int row_warps(int W) {
  int w = 1;
  while (w < kRowWarps && w * 32 * kRowPixelsPerLane < W) w *= 2;
  return w;
}

__device__ __forceinline__ float capped_square(float d) {
  const float f = fminf(d, kInf);
  return __fmul_rn(f, f);
}

__device__ __forceinline__ float candidate(const float* f, int k, int delta) {
  // _rn intrinsics: the compiler must not contract the square and the add
  // into one fused multiply-add, whose single rounding could differ from
  // the reference's two roundings once delta^2 passes 2^24
  return __fadd_rn(f[k], __fmul_rn((float)delta, (float)delta));
}

// Stages fsq of one row into f with kVec-wide loads (4: 16-byte loads,
// for a row of a multiple of 4 floats that starts 16-byte aligned; else 1)
// and returns the least value this thread staged; lo/hi take the first
// and last column whose fsq is below the cap (a column with an edge
// somewhere in its image).
template <int kVec>
__device__ __forceinline__ float stage_row(const float* __restrict__ src,
                                           float* __restrict__ f, int W,
                                           int t, int tpr, int& lo,
                                           int& hi) {
  float least = CUDART_INF_F;
  for (int k = t * kVec; k < W; k += tpr * kVec) {
    float s[kVec];
    if constexpr (kVec == 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + k);
      s[0] = capped_square(v.x), s[1] = capped_square(v.y);
      s[2] = capped_square(v.z), s[3] = capped_square(v.w);
      *reinterpret_cast<float4*>(f + k) = make_float4(s[0], s[1], s[2], s[3]);
    } else {
      s[0] = capped_square(src[k]);
      f[k] = s[0];
    }
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      least = fminf(least, s[c]);
      if (s[c] < kInfSq) lo = min(lo, k + c), hi = max(hi, k + c);
    }
  }
  if (t < kPad) f[t - kPad] = f[W + t] = CUDART_INF_F;
  return least;
}

// The exact pass-2 value of pixel j: the least fsq[k] + (j - k)^2 over the
// columns k in [lo, hi]. Columns outside it are capped (fsq = 1e18) and
// can never beat fsq[j] <= 1e18, so they are skipped. Offsets go out in
// chunks of kChunk, both sides while both have columns, then the far side
// alone; a chunk may run up to kChunk - 1 offsets past a side's end, onto
// real columns (extra candidates do not change a minimum) or the +inf pad.
// The scan stops once row_min + delta^2 reaches the best so far: every
// candidate left is at least that.
__device__ __forceinline__ float row_min_plus(const float* f, int j, int lo,
                                              int hi, float row_min) {
  float best = f[j];
  int delta, both, last, side;
  if (j > hi) {
    delta = j - hi, both = delta - 1, last = j - lo, side = -1;
  } else if (j < lo) {
    delta = lo - j, both = delta - 1, last = hi - j, side = 1;
  } else {
    delta = 1, both = min(j - lo, hi - j), last = max(j - lo, hi - j);
    side = j - lo > hi - j ? -1 : 1;
  }
  for (; delta <= both; delta += kChunk) {
    if (__fadd_rn(row_min, __fmul_rn((float)delta, (float)delta)) >= best)
      return best;
    float c = CUDART_INF_F;
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      c = fminf(c, fminf(candidate(f, j + delta + u, delta + u),
                         candidate(f, j - delta - u, delta + u)));
    best = fminf(best, c);
  }
  for (; delta <= last; delta += kChunk) {
    if (__fadd_rn(row_min, __fmul_rn((float)delta, (float)delta)) >= best)
      return best;
    float c = CUDART_INF_F;
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      c = fminf(c, candidate(f, j + side * (delta + u), delta + u));
    best = fminf(best, c);
  }
  return best;
}

template <int kVec>
__global__ void __launch_bounds__(kRowThreads)
    edt_pass2_rows_kernel(const float* __restrict__ d0,
                          float* __restrict__ out, int N, int W,
                          int warps_per_row) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* warp_least = smem;
  int* warp_lo = reinterpret_cast<int*>(smem + kRowWarps);
  int* warp_hi = warp_lo + kRowWarps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows_per_block = kRowWarps / warps_per_row;
  const int slot = warp / warps_per_row;
  const int tpr = warps_per_row * 32;                  // threads of a row
  const int t = (warp % warps_per_row) * 32 + lane;    // this one's index
  const long long n = (long long)blockIdx.x * rows_per_block + slot;
  const bool live = n < N;
  float* f = smem + kRowHeader + (size_t)slot * (W + 2 * kPad) + kPad;

  float least = CUDART_INF_F;
  int lo = INT_MAX, hi = -1;
  if (live) least = stage_row<kVec>(d0 + n * W, f, W, t, tpr, lo, hi);
  for (int off = 16; off > 0; off >>= 1) {
    least = fminf(least, __shfl_xor_sync(0xffffffffu, least, off));
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (lane == 0) warp_least[warp] = least, warp_lo[warp] = lo,
                 warp_hi[warp] = hi;
  __syncthreads();
  if (!live) return;
  const int w0 = slot * warps_per_row;
  float row_min = warp_least[w0];
  lo = warp_lo[w0], hi = warp_hi[w0];
  for (int p = 1; p < warps_per_row; ++p) {
    row_min = fminf(row_min, warp_least[w0 + p]);
    lo = min(lo, warp_lo[w0 + p]), hi = max(hi, warp_hi[w0 + p]);
  }

  float* dst = out + n * W;
  for (int j = t; j < W; j += tpr)
    dst[j] = __fsqrt_rn(fminf(row_min_plus(f, j, lo, hi, row_min), kInfSq));
}

size_t row_smem_bytes(int W) {
  const int rows = kRowWarps / row_warps(W);
  return (kRowHeader + (size_t)rows * (W + 2 * kPad)) * sizeof(float);
}

template <int kVec>
int launch_rows(const float* d0, float* out, int N, int W, int warps_per_row,
                unsigned blocks, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        edt_pass2_rows_kernel<kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  edt_pass2_rows_kernel<kVec><<<blocks, kRowThreads, smem, stream>>>(
      d0, out, N, W, warps_per_row);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// mask: uint8 or bool [B, H, W], nonzero = edge. out: float32 [B, H, W].
int edt_pass1_columns_launch(const void* mask, void* out, int B, int H,
                             int W, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const int strips = (W + 31) / 32;
  const long long blocks = (long long)B * strips;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const dim3 block(32, min((H + kSegRows - 1) / kSegRows, kMaxSegs));
  edt_pass1_columns_kernel<<<(unsigned)blocks, block, 0,
                             (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (float*)out, H, W, strips);
  return (int)cudaGetLastError();
}

// Bytes of shared memory a block of K2 takes for rows of W pixels.
size_t edt_pass2_rows_smem_bytes(int W) { return row_smem_bytes(W); }

// d0: float32 [N, W] column distances. out: float32 [N, W] distances.
int edt_pass2_rows_launch(const void* d0, void* out, int N, int W,
                          void* stream) {
  if (N <= 0 || W <= 0) return (int)cudaSuccess;
  // the wrapper refuses rows whose block would pass the shared memory
  const int warps_per_row = row_warps(W);
  const int rows = kRowWarps / warps_per_row;
  const long long blocks = ((long long)N + rows - 1) / rows;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = row_smem_bytes(W);
  const uintptr_t at = (uintptr_t)d0;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* in = (const float*)d0;
  if (W % 4 == 0 && at % 16 == 0)
    return launch_rows<4>(in, (float*)out, N, W, warps_per_row,
                          (unsigned)blocks, smem, s);
  return launch_rows<1>(in, (float*)out, N, W, warps_per_row,
                        (unsigned)blocks, smem, s);
}

}  // extern "C"
