// Epipolar-gated 2-nearest-neighbour descriptor matching, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of sat_bundleadjust_tpu/ops/pallas_match.py:
//   * nn2_match_i8  <- pallas_2nn_batched_i8 (body _kernel_b_i8): int8
//     descriptors (value - 128), int8 dot with s32 accumulation;
//   * nn2_match_f32 <- pallas_2nn_batched (body _kernel_b) and, with B = 1,
//     pallas_2nn (body _kernel): f32 descriptors and an f32 dot.
//
// For each pair b and row i of image i, over the columns j of image j:
//
//   dist(i, j) = max((sq_i + sq_j) - 2 * cross(i, j), 0)
//   ok(i, j)   = valid_i > 0 && valid_j > 0 && num * num <= (thr * thr) * denom
//                with num = l_i . h_j, denom = l0^2 + l1^2 (one-sided gate;
//                thr = 1e9 turns it off)
//   d          = ok ? dist : 1e12
//
// and out[b] = (d1, d2, idx): the smallest d, the smallest d over every
// column but the argmin (so d2 == d1 when two columns tie), and the lowest
// column reaching d1 (0 when no column is valid).
//
// Exactness: on integer descriptors every value after the cross term is an
// integer below 2^24, so the f32 arithmetic is exact and both entry points
// give the same bits as each other, as the plain PyTorch version and as the
// JAX kernels. The gate is computed with explicit round-to-nearest intrinsics
// in the order ((l0*h0)+(l1*h1))+(l2*h2), so that FMA contraction cannot move
// a gate decision at its boundary.
//
// Tie rule: each thread scans its row's columns in increasing order with a
// strict '<' (new minimum: d2 <- d1, d1 <- d, idx <- j; else d2 <- min(d2, d)).
// That is the TPU kernel's per-tile argmin (lowest column of the minimum) and
// its merge (a later tile wins only with a strictly smaller value).
//
// Design. A block of 128 threads owns 128 rows of one pair; each thread keeps
// its row's descriptor (32 int8x4 words, or 128 floats), its line, its
// validity and its running (d1, d2, idx) in registers. The block walks the
// columns of image j in tiles staged in shared memory (descriptors, points,
// validity, and the column norms the block computes once per tile with warp
// reductions); every thread reads the same column at once, so the shared
// loads are broadcasts. No atomics, no cross-block state: one launch, and two
// launches give the same bits.
//
// What bounds it on an H100: arithmetic issue. Per (row, column) the int8
// kernel does 32 dp4a on CUDA cores plus ~15 scalar ops for the gate and the
// top-2, against 256 int8 operations that tensor cores would do at 1979
// TOP/s; the bytes (each descriptor read once per row block) are far below
// the memory rate. This first kernel stays on CUDA cores (dp4a, f32 FMA),
// where it reaches about 65 TOP/s (45 pairs of 11k x 11k keypoints in 21 ms
// on an H100 SXM at 700 W), 30x the tensor-core bound; tensor-core s8
// products (mma.sync, then wgmma) with the top-2 fused into the epilogue are
// the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;       // rows (threads) per block
constexpr int kTileI8 = 128;     // columns per shared-memory tile, int8
constexpr int kTileF32 = 64;     // columns per shared-memory tile, f32
constexpr float kBig = 1e12f;

template <bool I8>
struct Traits;

template <>
struct Traits<true> {
  using Word = int;               // four int8 values
  static constexpr int kWords = 32;
  static constexpr int kTile = kTileI8;
};

template <>
struct Traits<false> {
  using Word = float;
  static constexpr int kWords = 128;
  static constexpr int kTile = kTileF32;
};

__device__ __forceinline__ int sq_word(int w) { return __dp4a(w, w, 0); }

template <typename Wd>
__device__ __forceinline__ Wd from_bits(unsigned u);
template <>
__device__ __forceinline__ int from_bits<int>(unsigned u) { return static_cast<int>(u); }
template <>
__device__ __forceinline__ float from_bits<float>(unsigned u) { return __uint_as_float(u); }

template <bool I8>
__global__ void __launch_bounds__(kRows)
nn2_kernel(const typename Traits<I8>::Word* __restrict__ di,
           const typename Traits<I8>::Word* __restrict__ dj,
           const float* __restrict__ li, const float* __restrict__ hj,
           const float* __restrict__ vi, const float* __restrict__ vj,
           const float* __restrict__ thr, float* __restrict__ out,
           int N1, int N2) {
  using Word = typename Traits<I8>::Word;
  constexpr int W = Traits<I8>::kWords;
  constexpr int T = Traits<I8>::kTile;

  __shared__ __align__(16) Word s_desc[T * W];
  __shared__ float s_h[T * 3];
  __shared__ float s_sq[T];
  __shared__ float s_ok[T];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = blockIdx.x * kRows + tid;
  const bool live = row < N1;
  const long rrow = static_cast<long>(b) * N1 + (live ? row : 0);

  // this thread's row: descriptor, squared norm, line, validity
  Word r[W];
  {
    const uint4* src = reinterpret_cast<const uint4*>(di + rrow * W);
#pragma unroll
    for (int k = 0; k < W / 4; ++k) {
      uint4 v = src[k];
      r[4 * k + 0] = from_bits<Word>(v.x);
      r[4 * k + 1] = from_bits<Word>(v.y);
      r[4 * k + 2] = from_bits<Word>(v.z);
      r[4 * k + 3] = from_bits<Word>(v.w);
    }
  }
  float sq_i;
  if constexpr (I8) {
    int s = 0;
#pragma unroll
    for (int k = 0; k < W; ++k) s = __dp4a(r[k], r[k], s);
    sq_i = static_cast<float>(s);
  } else {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < W; ++k) s = __fadd_rn(s, __fmul_rn(r[k], r[k]));
    sq_i = s;
  }
  const float l0 = li[rrow * 3 + 0], l1 = li[rrow * 3 + 1], l2 = li[rrow * 3 + 2];
  const float t = thr[b];
  const float gate_rhs = __fmul_rn(__fmul_rn(t, t), __fadd_rn(__fmul_rn(l0, l0), __fmul_rn(l1, l1)));
  const bool row_ok = live && vi[rrow] > 0.f;

  float d1 = kBig, d2 = kBig;
  int idx = 0;

  const Word* dj_b = dj + static_cast<long>(b) * N2 * W;
  for (int c0 = 0; c0 < N2; c0 += T) {
    const int n = min(T, N2 - c0);
    __syncthreads();  // the previous tile is no longer read
    {
      const uint4* src = reinterpret_cast<const uint4*>(dj_b + static_cast<long>(c0) * W);
      uint4* dst = reinterpret_cast<uint4*>(s_desc);
      for (int v = tid; v < n * (W / 4); v += kRows) dst[v] = src[v];
      for (int c = tid; c < n; c += kRows) {
        const long g = static_cast<long>(b) * N2 + c0 + c;
        s_h[3 * c + 0] = hj[g * 3 + 0];
        s_h[3 * c + 1] = hj[g * 3 + 1];
        s_h[3 * c + 2] = hj[g * 3 + 2];
        s_ok[c] = vj[g];
      }
    }
    __syncthreads();
    // column norms: one warp per column, one word (int8) or four floats
    // (f32) per lane, then a shuffle tree
    for (int c = warp; c < n; c += kRows / 32) {
      if constexpr (I8) {
        int s = sq_word(s_desc[c * W + lane]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) s_sq[c] = static_cast<float>(s);
      } else {
        const float4 v = reinterpret_cast<const float4*>(s_desc + c * W)[lane];
        float s = __fadd_rn(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)),
                            __fadd_rn(__fmul_rn(v.z, v.z), __fmul_rn(v.w, v.w)));
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
        if (lane == 0) s_sq[c] = s;
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int c = 0; c < n; ++c) {
      float cross;
      if constexpr (I8) {
        const int4* col = reinterpret_cast<const int4*>(s_desc + c * W);
        int acc = 0;
#pragma unroll
        for (int k = 0; k < W / 4; ++k) {
          const int4 v = col[k];
          acc = __dp4a(r[4 * k + 0], v.x, acc);
          acc = __dp4a(r[4 * k + 1], v.y, acc);
          acc = __dp4a(r[4 * k + 2], v.z, acc);
          acc = __dp4a(r[4 * k + 3], v.w, acc);
        }
        cross = static_cast<float>(acc);
      } else {
        const float4* col = reinterpret_cast<const float4*>(s_desc + c * W);
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < W / 4; ++k) {
          const float4 v = col[k];
          acc = fmaf(r[4 * k + 0], v.x, acc);
          acc = fmaf(r[4 * k + 1], v.y, acc);
          acc = fmaf(r[4 * k + 2], v.z, acc);
          acc = fmaf(r[4 * k + 3], v.w, acc);
        }
        cross = acc;
      }
      const float dist = fmaxf(__fsub_rn(__fadd_rn(sq_i, s_sq[c]), __fmul_rn(2.f, cross)), 0.f);
      const float num = __fadd_rn(__fadd_rn(__fmul_rn(l0, s_h[3 * c + 0]), __fmul_rn(l1, s_h[3 * c + 1])),
                                  __fmul_rn(l2, s_h[3 * c + 2]));
      const bool ok = row_ok && s_ok[c] > 0.f && __fmul_rn(num, num) <= gate_rhs;
      const float d = ok ? dist : kBig;
      if (d < d1) {
        d2 = d1;
        d1 = d;
        idx = c0 + c;
      } else if (d < d2) {
        d2 = d;
      }
    }
  }
  if (live) {
    const long o = static_cast<long>(b) * 3 * N1 + row;
    out[o] = d1;
    out[o + N1] = d2;
    out[o + 2L * N1] = static_cast<float>(idx);
  }
}

template <bool I8>
int launch(const void* di, const void* dj, const void* li, const void* hj, const void* vi,
           const void* vj, const void* thr, void* out, int B, int N1, int N2, void* stream) {
  using Word = typename Traits<I8>::Word;
  if (B <= 0 || N1 <= 0) return 0;
  dim3 grid((N1 + kRows - 1) / kRows, B);
  nn2_kernel<I8><<<grid, kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Word*>(di), static_cast<const Word*>(dj),
      static_cast<const float*>(li), static_cast<const float*>(hj),
      static_cast<const float*>(vi), static_cast<const float*>(vj),
      static_cast<const float*>(thr), static_cast<float*>(out), N1, N2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// di (B, N1, 128) int8, dj (B, N2, 128) int8, li (B, N1, 3), hj (B, N2, 3),
// vi (B, N1), vj (B, N2), thr (B,) float32; out (B, 3, N1) float32. All
// contiguous on the device, descriptor pointers 16-byte aligned. Returns the
// launch's CUDA error (0 on success).
int nn2_match_i8(const void* di, const void* dj, const void* li, const void* hj,
                 const void* vi, const void* vj, const void* thr, void* out,
                 int B, int N1, int N2, void* stream) {
  return launch<true>(di, dj, li, hj, vi, vj, thr, out, B, N1, N2, stream);
}

// The same with float32 descriptors (B, N1, 128) and (B, N2, 128).
int nn2_match_f32(const void* di, const void* dj, const void* li, const void* hj,
                  const void* vi, const void* vj, const void* thr, void* out,
                  int B, int N1, int N2, void* stream) {
  return launch<false>(di, dj, li, hj, vi, vj, thr, out, B, N1, N2, stream);
}

}  // extern "C"
