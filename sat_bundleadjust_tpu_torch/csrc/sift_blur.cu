// SIFT's scale space on Hopper (sm_90a): the separable Gaussian blur of a
// level and the 2x bilinear upsample of the input, each one launch for the
// whole (B, H, W) batch.
//
// Replaces no TPU kernel: the JAX package writes these as jnp slices that
// XLA fuses (sat_bundleadjust_tpu/ops/sift.py, _blur, _blur_dynamic,
// _upsample2). The port's plain PyTorch version (ops/sift.py, _blur_plain,
// _upsample_plain) emulates XLA's single-rounding float32 multiply-add in
// float64 temporaries, ~1 000 launches a blur level on the card; these
// kernels compute the same bits with one launch a level.
//
// Numerical contract (the plain version's, step for step):
//   blur, along rows (dim 1) first, then along columns (dim 2), edge
//   padding by clamping the index, the intermediate rounded to float32:
//     acc = __fmul_rn(taps[0], x[i]);
//     acc = __fmaf_rn(taps[t], x[i + t], acc), t = 1 .. 2r, in tap order;
//   upsample, columns first, then rows (half-pixel centres):
//     out[2j]     = __fmaf_rn(0.75f, x[j],     __fmul_rn(0.25f, x[j - 1])), x[0] at j = 0;
//     out[2j + 1] = __fmaf_rn(0.25f, x[j + 1], __fmul_rn(0.75f, x[j])),     x[n - 1] at j = n - 1.
// Every product and sum is an explicit intrinsic, so nvcc's -fmad=true has
// nothing to contract, and the build has no fast-math or -ftz: subnormals
// survive as on the CPU.
//
// What bounds it on an H100: a blur level reads and writes each pixel once,
// 8 B a pixel (1.28 GB at the 10 x 4000 x 4000 first octave of a 10-view
// 2000x2000 batch, 0.38 ms at 3.35 TB/s), against 2 (2r + 1) float32 fmas
// a pixel (54 at r = 13, 0.26 ms at 67 TFLOP/s): bytes, then the CUDA
// cores. The design: one block per 32 x 64 output tile; the tile and its
// r-halo copied once into shared memory with clamped indices (each input
// byte read from device memory about once, the halo from L2); the vertical
// pass, a thread per (column, 16 rows), keeps a sliding window in registers
// (2.6 shared loads a result at r = 13) and writes the intermediate
// transposed, so that the horizontal pass, a thread per (row, 8 columns),
// reads it without bank conflicts; the output tile goes back through shared
// memory and is written once, in whole rows. The vertical pass computes the
// halo's columns too: (64 + 2r) / 64 of the output's, 1.4x at r = 13. The radius is a template
// parameter (1 .. kMaxRadius), so the taps and the windows live in
// registers and every loop is unrolled.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxRadius = 16;
constexpr int kTileW = 64;    // output columns of a block
constexpr int kTileH = 32;    // output rows of a block: the lanes of the horizontal pass
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsV = 16;    // vertical pass: output rows of a thread
constexpr int kColsH = 8;     // horizontal pass: output columns of a thread
constexpr int kMidPitch = kTileH + 1;  // the transposed intermediate's row pitch
constexpr int kOutPitch = kTileW + 1;  // the output tile's row pitch

static_assert(kTileH == 32 && kTileH % kRowsV == 0, "a lane per output row");
static_assert(kWarps * kColsH == kTileW && kTileW % 32 == 0, "a warp per kColsH columns");

template <int R>
__global__ void __launch_bounds__(kThreads)
    sift_blur_kernel(const float* __restrict__ in, long long in_batch, float* __restrict__ out,
                     long long out_batch, const float* __restrict__ taps, int H, int W) {
  constexpr int K = 2 * R + 1;
  constexpr int PW = kTileW + 2 * R;  // the input tile's columns, halo included
  constexpr int PH = kTileH + 2 * R;  // its rows
  constexpr int kLaneCols = (PW + 31) / 32;
  static_assert(kTileH * kOutPitch <= PH * PW, "the output tile reuses the input tile");
  __shared__ float s_in[PH * PW];          // input tile, row-major; then the output tile
  __shared__ float s_mid[PW * kMidPitch];  // vertical pass, transposed: [column][row]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const float* src = in + static_cast<long long>(blockIdx.z) * in_batch;
  float* dst = out + static_cast<long long>(blockIdx.z) * out_batch;

  float tap[K];
#pragma unroll
  for (int t = 0; t < K; ++t) tap[t] = __ldg(taps + t);

  // the tile and its halo, edge-padded by clamping: a warp per row, the
  // loads of a thread all issued before their stores
  int xs[kLaneCols];
#pragma unroll
  for (int j = 0; j < kLaneCols; ++j) xs[j] = min(max(x0 - R + lane + 32 * j, 0), W - 1);
#pragma unroll
  for (int k = 0; k < (PH + kWarps - 1) / kWarps; ++k) {
    const int r = warp + kWarps * k;
    if (r < PH) {
      const float* line = src + static_cast<long long>(min(max(y0 - R + r, 0), H - 1)) * W;
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j) {
        if (lane + 32 * j < PW) s_in[r * PW + lane + 32 * j] = __ldg(line + xs[j]);
      }
    }
  }
  __syncthreads();

  // vertical pass: rows r0 .. r0 + kRowsV - 1 of padded column c
  for (int item = tid; item < PW * (kTileH / kRowsV); item += kThreads) {
    const int c = item % PW;
    const int r0 = (item / PW) * kRowsV;
    float acc[kRowsV];
#pragma unroll
    for (int k = 0; k < kRowsV + 2 * R; ++k) {
      const float v = s_in[(r0 + k) * PW + c];
#pragma unroll
      for (int i = 0; i < kRowsV; ++i) {
        const int t = k - i;
        if (t == 0) {
          acc[i] = __fmul_rn(tap[0], v);
        } else if (t > 0 && t < K) {
          acc[i] = __fmaf_rn(tap[t], v, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsV; ++i) s_mid[c * kMidPitch + r0 + i] = acc[i];
  }
  __syncthreads();

  // horizontal pass: output row `lane`, columns c0 .. c0 + kColsH - 1
  const int c0 = warp * kColsH;
  float acc[kColsH];
#pragma unroll
  for (int k = 0; k < kColsH + 2 * R; ++k) {
    const float v = s_mid[(c0 + k) * kMidPitch + lane];
#pragma unroll
    for (int i = 0; i < kColsH; ++i) {
      const int t = k - i;
      if (t == 0) {
        acc[i] = __fmul_rn(tap[0], v);
      } else if (t > 0 && t < K) {
        acc[i] = __fmaf_rn(tap[t], v, acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kColsH; ++i) s_in[lane * kOutPitch + c0 + i] = acc[i];
  __syncthreads();

  // the output tile, written once: a warp per row
#pragma unroll
  for (int k = 0; k < kTileH / kWarps; ++k) {
    const int r = warp + kWarps * k;
    if (y0 + r < H) {
#pragma unroll
      for (int j = 0; j < kTileW / 32; ++j) {
        const int c = lane + 32 * j;
        if (x0 + c < W) dst[static_cast<long long>(y0 + r) * W + x0 + c] = s_in[r * kOutPitch + c];
      }
    }
  }
}

// the column pass of the upsample on one input row, at output column X
__device__ __forceinline__ float upsample_cols(const float* __restrict__ row, int X, int w) {
  const int j = X >> 1;
  if (X & 1) {
    return j == w - 1 ? __ldg(row + j)
                      : __fmaf_rn(0.25f, __ldg(row + j + 1), __fmul_rn(0.75f, __ldg(row + j)));
  }
  return j == 0 ? __ldg(row) : __fmaf_rn(0.75f, __ldg(row + j), __fmul_rn(0.25f, __ldg(row + j - 1)));
}

// output rows 2i and 2i + 1 of image blockIdx.z at column X: a thread each,
// the input rows from L1
__global__ void __launch_bounds__(256)
    sift_upsample2_kernel(const float* __restrict__ in, float* __restrict__ out, int h, int w) {
  const int X = blockIdx.x * blockDim.x + threadIdx.x;
  const int W2 = 2 * w;
  if (X >= W2) return;
  const float* src = in + static_cast<long long>(blockIdx.z) * h * w;
  float* dst = out + static_cast<long long>(blockIdx.z) * 4 * h * w;
  for (int i = blockIdx.y; i < h; i += gridDim.y) {
    const float mid = upsample_cols(src + static_cast<long long>(i) * w, X, w);
    const float even = i == 0 ? mid
        : __fmaf_rn(0.75f, mid, __fmul_rn(0.25f, upsample_cols(src + static_cast<long long>(i - 1) * w, X, w)));
    const float odd = i == h - 1 ? mid
        : __fmaf_rn(0.25f, upsample_cols(src + static_cast<long long>(i + 1) * w, X, w), __fmul_rn(0.75f, mid));
    dst[static_cast<long long>(2 * i) * W2 + X] = even;
    dst[static_cast<long long>(2 * i + 1) * W2 + X] = odd;
  }
}

template <int R>
int launch_blur(const float* in, long long in_batch, float* out, long long out_batch,
                const float* taps, int B, int H, int W, cudaStream_t s) {
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  sift_blur_kernel<R><<<grid, kThreads, 0, s>>>(in, in_batch, out, out_batch, taps, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[b] = the blur of in[b] with the 2 radius + 1 taps (device memory), for
// b < B; each image (H, W) row-major, images in_batch / out_batch floats
// apart. One launch on `stream`, no allocation, no synchronisation. Returns
// a CUDA error code (0 = success).
extern "C" int sift_blur(const float* in, long long in_batch, float* out, long long out_batch,
                         const float* taps, int radius, int B, int H, int W, void* stream) {
  if (radius < 1 || radius > kMaxRadius || B < 1 || H < 1 || W < 1 || B > 65535 ||
      (H + kTileH - 1) / kTileH > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 1: return launch_blur<1>(in, in_batch, out, out_batch, taps, B, H, W, s);
    case 2: return launch_blur<2>(in, in_batch, out, out_batch, taps, B, H, W, s);
    case 3: return launch_blur<3>(in, in_batch, out, out_batch, taps, B, H, W, s);
    case 4: return launch_blur<4>(in, in_batch, out, out_batch, taps, B, H, W, s);
    case 5: return launch_blur<5>(in, in_batch, out, out_batch, taps, B, H, W, s);
    case 6: return launch_blur<6>(in, in_batch, out, out_batch, taps, B, H, W, s);
    case 7: return launch_blur<7>(in, in_batch, out, out_batch, taps, B, H, W, s);
    case 8: return launch_blur<8>(in, in_batch, out, out_batch, taps, B, H, W, s);
    case 9: return launch_blur<9>(in, in_batch, out, out_batch, taps, B, H, W, s);
    case 10: return launch_blur<10>(in, in_batch, out, out_batch, taps, B, H, W, s);
    case 11: return launch_blur<11>(in, in_batch, out, out_batch, taps, B, H, W, s);
    case 12: return launch_blur<12>(in, in_batch, out, out_batch, taps, B, H, W, s);
    case 13: return launch_blur<13>(in, in_batch, out, out_batch, taps, B, H, W, s);
    case 14: return launch_blur<14>(in, in_batch, out, out_batch, taps, B, H, W, s);
    case 15: return launch_blur<15>(in, in_batch, out, out_batch, taps, B, H, W, s);
    case 16: return launch_blur<16>(in, in_batch, out, out_batch, taps, B, H, W, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out (B, 2h, 2w) = the 2x bilinear upsample of in (B, h, w), both
// contiguous. One launch on `stream`. Returns a CUDA error code.
extern "C" int sift_upsample2(const float* in, float* out, int B, int h, int w, void* stream) {
  if (B < 1 || h < 1 || w < 1 || B > 65535 || w > (1 << 29)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((2 * w + 255) / 256, h < 65535 ? h : 65535, B);
  sift_upsample2_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(in, out, h, w);
  return static_cast<int>(cudaGetLastError());
}
