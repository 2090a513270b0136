// The RPC altitude search of the tie-point triangulation on Hopper (sm_90a):
// one thread a duo (an observation in camera a, its match in camera b), the
// whole batch in one launch.
//
// Replaces no TPU kernel: the JAX package runs this search as a
// lax.while_loop that XLA fuses (sat_bundleadjust_tpu/ops/triangulate.py,
// rpc_triangulation). The port's plain PyTorch version (ops/triangulate.py,
// rpc_triangulation through models/rpc.py, rpc_localization) runs every
// Newton step of every localization as separate launches over the batch:
// three (D, 20) monomial bases stacked, 12 products and 12 sums, ~100
// launches a step and ~7 500 a batch, with converged duos computed until
// the slowest one stops and one read of the device a secant step.
//
// Per duo, exactly what rpc_triangulation does:
//   h = 0; for at most `iters` secant steps:
//     p = b's pixel of a's (x, y) localized at altitude h, q the same at
//     h + hstep (a localization: `newton` Newton steps from the normalized
//     origin on the forward rational model with its exact 2x2 Jacobian, a
//     |det| < 1e-30 guard; a projection: the rational model of b);
//     a = q - p, lam = a . (pb - p) / (|a|^2, or 1 where it is 0);
//     err = |p + lam a - pb|; h += lam hstep;
//     stop once |lam| < stop (the step just taken is kept, as the plain
//     version's frozen mask keeps it);
//   then (lon, lat) = a's (x, y) localized at the final h.
// Every duo stops on its own; none waits for the slowest of its batch.
// The divisions are IEEE double divisions, as on the CPU; nvcc may contract
// a product and a sum into one fma, so results differ from the plain
// version's in their last bits (and, where |lam| lands within rounding of
// `stop`, by one secant step: a change of h below stop * hstep).
//
// What bounds it on an H100: float64 arithmetic. A Newton step evaluates
// four 20-term polynomials and their two partial derivatives (~150 fmas,
// ~25 products and 8 divisions); a duo of the robust BA cell's linear RPCs
// takes 2 secant steps, 75 Newton steps in all, ~25 000 float64
// operations: ~28 GFLOP for its 1.13 M duos, ~0.8 ms at 34 TFLOP/s
// (float64 outside the tensor cores), against ~100 B a duo of reads and
// writes, 0.03 ms at 3.35 TB/s.
// The design: the monomials, the 12 sums and the whole search in
// registers, no (D, 20) temporaries; the coefficients (a camera's record of
// 90 doubles, the table of 1 000 cameras 0.7 MB, in L2) read through the
// read-only path; the wrapper hands the duos to the threads in the order of
// camera a (`order`), so that a warp's reads of camera a's coefficients,
// ~94% of all its reads, are one broadcast address; the outputs go back to
// each duo's own index.

#include <cuda_runtime.h>

namespace {

// a camera's record in the table: the fields of models/rpc.RPCModel in order
constexpr int kLineNum = 0;
constexpr int kLineDen = 20;
constexpr int kSampNum = 40;
constexpr int kSampDen = 60;
constexpr int kRowOff = 80;
constexpr int kColOff = 81;
constexpr int kLatOff = 82;
constexpr int kLonOff = 83;
constexpr int kAltOff = 84;
constexpr int kRowScale = 85;
constexpr int kColScale = 86;
constexpr int kLatScale = 87;
constexpr int kLonScale = 88;
constexpr int kAltScale = 89;
constexpr int kRecord = 90;
constexpr int kThreads = 128;

__device__ __forceinline__ double ld(const double* p) { return __ldg(p); }

// The RPC00B monomials at x = normalized lat, y = lon, z = alt (the order
// of models/rpc.poly20_basis).
struct Monomials {
  double x, y, z, xx, yy, zz, xy, xz, yz;
  __device__ __forceinline__ Monomials(double x_, double y_, double z_)
      : x(x_), y(y_), z(z_), xx(x_ * x_), yy(y_ * y_), zz(z_ * z_), xy(x_ * y_), xz(x_ * z_),
        yz(y_ * z_) {}
};

// sum_k c[k] m_k
__device__ __forceinline__ double poly(const double* c, const Monomials& m) {
  double v = ld(c);
  v = fma(ld(c + 1), m.y, v);
  v = fma(ld(c + 2), m.x, v);
  v = fma(ld(c + 3), m.z, v);
  v = fma(ld(c + 4), m.xy, v);
  v = fma(ld(c + 5), m.yz, v);
  v = fma(ld(c + 6), m.xz, v);
  v = fma(ld(c + 7), m.yy, v);
  v = fma(ld(c + 8), m.xx, v);
  v = fma(ld(c + 9), m.zz, v);
  v = fma(ld(c + 10), m.xy * m.z, v);
  v = fma(ld(c + 11), m.yy * m.y, v);
  v = fma(ld(c + 12), m.y * m.xx, v);
  v = fma(ld(c + 13), m.y * m.zz, v);
  v = fma(ld(c + 14), m.yy * m.x, v);
  v = fma(ld(c + 15), m.xx * m.x, v);
  v = fma(ld(c + 16), m.x * m.zz, v);
  v = fma(ld(c + 17), m.yy * m.z, v);
  v = fma(ld(c + 18), m.xx * m.z, v);
  v = fma(ld(c + 19), m.zz * m.z, v);
  return v;
}

// sum_k c[k] m_k and its derivatives along x (lat) and y (lon)
// (models/rpc.poly20_basis_dx, poly20_basis_dy)
__device__ __forceinline__ void poly_d(const double* c, const Monomials& m, double& v,
                                       double& dx, double& dy) {
  v = poly(c, m);
  dx = ld(c + 2);
  dx = fma(ld(c + 4), m.y, dx);
  dx = fma(ld(c + 6), m.z, dx);
  dx = fma(ld(c + 8), 2.0 * m.x, dx);
  dx = fma(ld(c + 10), m.yz, dx);
  dx = fma(ld(c + 12), 2.0 * m.xy, dx);
  dx = fma(ld(c + 14), m.yy, dx);
  dx = fma(ld(c + 15), 3.0 * m.xx, dx);
  dx = fma(ld(c + 16), m.zz, dx);
  dx = fma(ld(c + 18), 2.0 * m.xz, dx);
  dy = ld(c + 1);
  dy = fma(ld(c + 4), m.x, dy);
  dy = fma(ld(c + 5), m.z, dy);
  dy = fma(ld(c + 7), 2.0 * m.y, dy);
  dy = fma(ld(c + 10), m.xz, dy);
  dy = fma(ld(c + 11), 3.0 * m.yy, dy);
  dy = fma(ld(c + 12), m.xx, dy);
  dy = fma(ld(c + 13), m.zz, dy);
  dy = fma(ld(c + 14), 2.0 * m.xy, dy);
  dy = fma(ld(c + 17), 2.0 * m.yz, dy);
}

// num / den and its derivatives along lon and lat, by the quotient rule
// (models/rpc._normalized_forward's `rational`)
__device__ __forceinline__ void rational(const double* num, const double* den,
                                         const Monomials& m, double& v, double& v_dlon,
                                         double& v_dlat) {
  double p, p_dlat, p_dlon, q, q_dlat, q_dlon;
  poly_d(num, m, p, p_dlat, p_dlon);
  poly_d(den, m, q, q_dlat, q_dlon);
  v = p / q;
  v_dlon = (p_dlon - v * q_dlon) / q;
  v_dlat = (p_dlat - v * q_dlat) / q;
}

// Image (col, row) of camera r at altitude alt -> ground (lon, lat):
// models/rpc.rpc_localization.
__device__ __forceinline__ void localize(const double* r, double col, double row, double alt,
                                         int newton, double& lon, double& lat) {
  const double tcol = (col - ld(r + kColOff)) / ld(r + kColScale);
  const double trow = (row - ld(r + kRowOff)) / ld(r + kRowScale);
  const double nalt = (alt - ld(r + kAltOff)) / ld(r + kAltScale);
  double nlon = 0.0, nlat = 0.0;
  for (int it = 0; it < newton; ++it) {
    const Monomials m(nlat, nlon, nalt);
    double c, c_dlon, c_dlat, w, w_dlon, w_dlat;
    rational(r + kSampNum, r + kSampDen, m, c, c_dlon, c_dlat);
    rational(r + kLineNum, r + kLineDen, m, w, w_dlon, w_dlat);
    const double fx = c - tcol;
    const double fy = w - trow;
    const double det = c_dlon * w_dlat - c_dlat * w_dlon;
    const double safe = fabs(det) < 1e-30 ? 1.0 : det;
    const double dlon = (w_dlat * fx - c_dlat * fy) / safe;
    const double dlat = (-w_dlon * fx + c_dlon * fy) / safe;
    nlon -= dlon;
    nlat -= dlat;
  }
  lon = nlon * ld(r + kLonScale) + ld(r + kLonOff);
  lat = nlat * ld(r + kLatScale) + ld(r + kLatOff);
}

// Ground (lon, lat, alt) -> image (col, row) of camera r:
// models/rpc.rpc_projection.
__device__ __forceinline__ void project(const double* r, double lon, double lat, double alt,
                                        double& col, double& row) {
  const Monomials m((lat - ld(r + kLatOff)) / ld(r + kLatScale),
                    (lon - ld(r + kLonOff)) / ld(r + kLonScale),
                    (alt - ld(r + kAltOff)) / ld(r + kAltScale));
  col = poly(r + kSampNum, m) / poly(r + kSampDen, m) * ld(r + kColScale) + ld(r + kColOff);
  row = poly(r + kLineNum, m) / poly(r + kLineDen, m) * ld(r + kRowScale) + ld(r + kRowOff);
}

// Pixel (x, y) of camera a at altitude h, seen in camera b:
// ops/triangulate._pair_correspondence.
__device__ __forceinline__ void correspond(const double* a, const double* b, double x, double y,
                                           double h, int newton, double& col, double& row) {
  double lon, lat;
  localize(a, x, y, h, newton, lon, lat);
  project(b, lon, lat, h, col, row);
}

__global__ void __launch_bounds__(kThreads)
    rpc_triangulate_kernel(const double* __restrict__ table, long long n_cam,
                           const long long* __restrict__ order,
                           const long long* __restrict__ cam_a,
                           const long long* __restrict__ cam_b,
                           const double* __restrict__ pts_a, const double* __restrict__ pts_b,
                           long long n, int iters, int newton, double hstep, double stop,
                           double* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n) return;
  const long long d = order[t];
  const long long ia = cam_a[d];
  const long long ib = cam_b[d];
  if (ia < 0 || ia >= n_cam || ib < 0 || ib >= n_cam) {  // no such camera: no point
    for (int k = 0; k < 5; ++k) out[k * n + d] = __longlong_as_double(0x7ff8000000000000LL);
    return;
  }
  const double* A = table + ia * kRecord;
  const double* B = table + ib * kRecord;
  const double xa = pts_a[2 * d], ya = pts_a[2 * d + 1];
  const double xb = pts_b[2 * d], yb = pts_b[2 * d + 1];

  double h = 0.0, err = 0.0;
  int steps = 0;
  while (steps < iters) {
    double px, py, qx, qy;
    correspond(A, B, xa, ya, h, newton, px, py);
    correspond(A, B, xa, ya, h + hstep, newton, qx, qy);
    const double ax = qx - px, ay = qy - py;
    const double bx = xb - px, by = yb - py;
    const double a2 = ax * ax + ay * ay;
    const double lam = (ax * bx + ay * by) / (a2 == 0.0 ? 1.0 : a2);
    err = hypot(px + lam * ax - xb, py + lam * ay - yb);
    h = h + lam * hstep;
    ++steps;
    if (fabs(lam) < stop) break;
  }
  double lon, lat;
  localize(A, xa, ya, h, newton, lon, lat);
  out[d] = lon;
  out[n + d] = lat;
  out[2 * n + d] = h;
  out[3 * n + d] = err;
  out[4 * n + d] = static_cast<double>(steps);
}

}  // namespace

// Triangulates the n duos of the camera table (n_cam records of 90 doubles,
// the fields of models/rpc.RPCModel in order) by the RPC altitude search:
// duo d is pts_a[d] (x, y) in camera cam_a[d] and pts_b[d] in cam_b[d]; thread
// t takes duo order[t]. out (5, n): lon, lat (degrees), h (m), err (px) and
// the secant steps taken, at each duo's own index; NaN for a duo whose
// camera index lies outside the table. One launch on `stream`, no
// allocation, no synchronisation. Returns a CUDA error code (0 = success).
extern "C" int rpc_triangulate(const double* table, long long n_cam, const long long* order,
                               const long long* cam_a, const long long* cam_b,
                               const double* pts_a, const double* pts_b, long long n, int iters,
                               int newton, double hstep, double stop, double* out,
                               void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (n < 1 || n_cam < 1 || iters < 0 || newton < 0 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rpc_triangulate_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      table, n_cam, order, cam_a, cam_b, pts_a, pts_b, n, iters, newton, hstep, stop, out);
  return static_cast<int>(cudaGetLastError());
}
