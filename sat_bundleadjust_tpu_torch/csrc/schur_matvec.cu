// Schur-complement CG operator of the BA solve, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sat_bundleadjust_tpu/ops/pallas_matvec.py
// (_matvec_kernel, called through schur_wz). For x (M, P) it computes
//
//   wz[m] = sum_{k: cam(k)=m} What_k ( sum_{k' in track(k)} What_k'^T x[cam(k')] )
//
// with What = W chol(V^-1) folded once per LM step by the caller, laid out
// twice: track-major w_pt (N, Tp, P, 3) with camera ids cam_ind_pt (N, Tp),
// and camera-major w_cm (M, Tc, P, 3) with track ids pts_ind_cam (M, Tc).
// Empty slots hold the sentinel id M (resp. N) and are skipped.
//
// Numerical contract (the CG at 1000-camera conditioning needs it):
//   * the operator is exact f32 arithmetic (no reduced-precision products);
//   * each track's inner sum is f32, in fixed slot order;
//   * the camera-side sum is f64 and a fixed-shape tree, so the result does
//     not depend on the order of the observations and two launches give the
//     same bits. No atomics.
//
// Two launches:
//   1. point pass, one thread per track: what[n] = sum_t w_pt[n,t]^T x[cam];
//   2. camera pass, one block per camera: f64 partials over a strided slot
//      loop, then a shared-memory tree; f32 result.
//
// What bounds it on an H100: memory. Per call it must read both What
// layouts (2 * 36 B per observation at P = 3) and the two index tables
// (4 B per slot), and it does 18 flops per observation — at 1000 cameras /
// 800k observations about 64 MB, i.e. >= 19 us at 3.35 TB/s, against
// ~0.1 us of arithmetic. The design reads each layout once, contiguously
// per thread (point pass) or per block (camera pass), and keeps the track
// sums in a small (N, 3) scratch that stays in the 50 MB L2 between the
// two launches. At 50 cameras the camera pass has only 50 blocks for 132
// SMs, and the two launches' latency dominates.

#include <cuda_runtime.h>

namespace {

constexpr int kPointThreads = 256;
constexpr int kCamThreads = 256;

__global__ void point_pass(const float* __restrict__ x,
                           const float* __restrict__ w_pt,
                           const int* __restrict__ cam_ind_pt,
                           float* __restrict__ what,
                           int M, int N, int P, int Tp) {
  const long n = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int* ci = cam_ind_pt + n * Tp;
  const float* w = w_pt + n * static_cast<long>(Tp) * P * 3;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (int t = 0; t < Tp; ++t) {
    const int c = ci[t];
    if (c < 0 || c >= M) continue;
    const float* wt = w + static_cast<long>(t) * P * 3;
    const float* xc = x + static_cast<long>(c) * P;
    for (int p = 0; p < P; ++p) {
      const float xv = xc[p];
      a0 += wt[p * 3 + 0] * xv;
      a1 += wt[p * 3 + 1] * xv;
      a2 += wt[p * 3 + 2] * xv;
    }
  }
  what[n * 3 + 0] = a0;
  what[n * 3 + 1] = a1;
  what[n * 3 + 2] = a2;
}

template <int P>
__global__ void camera_pass(const float* __restrict__ w_cm,
                            const int* __restrict__ pts_ind_cam,
                            const float* __restrict__ what,
                            float* __restrict__ wz,
                            int N, int Tc) {
  __shared__ double red[kCamThreads][P];
  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  double acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.0;

  const float* wm = w_cm + static_cast<long>(m) * Tc * P * 3;
  const int* pi = pts_ind_cam + static_cast<long>(m) * Tc;
  for (int t = tid; t < Tc; t += kCamThreads) {
    const int n = pi[t];
    if (n < 0 || n >= N) continue;
    const double h0 = what[static_cast<long>(n) * 3 + 0];
    const double h1 = what[static_cast<long>(n) * 3 + 1];
    const double h2 = what[static_cast<long>(n) * 3 + 2];
    const float* wt = wm + static_cast<long>(t) * P * 3;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      acc[p] += static_cast<double>(wt[p * 3 + 0]) * h0 +
                static_cast<double>(wt[p * 3 + 1]) * h1 +
                static_cast<double>(wt[p * 3 + 2]) * h2;
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) red[tid][p] = acc[p];
  __syncthreads();
  for (int s = kCamThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
#pragma unroll
      for (int p = 0; p < P; ++p) red[tid][p] += red[tid + s][p];
    }
    __syncthreads();
  }
  if (tid < P) wz[static_cast<long>(m) * P + tid] = static_cast<float>(red[0][tid]);
}

template <int P>
void launch_camera_pass(const float* w_cm, const int* pts_ind_cam,
                        const float* what, float* wz, int M, int N, int Tc,
                        cudaStream_t stream) {
  camera_pass<P><<<M, kCamThreads, 0, stream>>>(w_cm, pts_ind_cam, what, wz, N, Tc);
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 = success). `what` is
// caller-allocated (N, 3) f32 scratch; wz is the (M, P) f32 output.
extern "C" int schur_wz_f32(const float* x, const float* w_pt,
                            const int* cam_ind_pt, const float* w_cm,
                            const int* pts_ind_cam, float* what, float* wz,
                            int M, int N, int P, int Tp, int Tc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P < 1 || P > 9 || M < 0 || N < 0 || Tp < 0 || Tc < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N > 0) {
    const int blocks = (N + kPointThreads - 1) / kPointThreads;
    point_pass<<<blocks, kPointThreads, 0, s>>>(x, w_pt, cam_ind_pt, what, M, N, P, Tp);
  }
  if (M > 0) {
    switch (P) {
      case 1: launch_camera_pass<1>(w_cm, pts_ind_cam, what, wz, M, N, Tc, s); break;
      case 2: launch_camera_pass<2>(w_cm, pts_ind_cam, what, wz, M, N, Tc, s); break;
      case 3: launch_camera_pass<3>(w_cm, pts_ind_cam, what, wz, M, N, Tc, s); break;
      case 4: launch_camera_pass<4>(w_cm, pts_ind_cam, what, wz, M, N, Tc, s); break;
      case 5: launch_camera_pass<5>(w_cm, pts_ind_cam, what, wz, M, N, Tc, s); break;
      case 6: launch_camera_pass<6>(w_cm, pts_ind_cam, what, wz, M, N, Tc, s); break;
      case 7: launch_camera_pass<7>(w_cm, pts_ind_cam, what, wz, M, N, Tc, s); break;
      case 8: launch_camera_pass<8>(w_cm, pts_ind_cam, what, wz, M, N, Tc, s); break;
      default: launch_camera_pass<9>(w_cm, pts_ind_cam, what, wz, M, N, Tc, s); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
