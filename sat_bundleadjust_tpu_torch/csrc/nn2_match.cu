// Epipolar-gated 2-nearest-neighbour descriptor matching, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of sat_bundleadjust_tpu/ops/pallas_match.py:
//   * nn2_match_i8  <- pallas_2nn_batched_i8 (:240, body _kernel_b_i8 :162):
//     int8 descriptors (value - 128), the cross term on the tensor cores;
//   * nn2_match_f32 <- pallas_2nn_batched (body _kernel_b) and, with B = 1,
//     pallas_2nn (body _kernel): f32 descriptors and an f32 dot on CUDA cores.
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
// Exactness: on integer descriptors every distance is an integer at most
// 128 * 255^2 < 2^24, so both entry points give the same bits as each other,
// as the plain PyTorch version and as the JAX kernels. The gate is computed
// with explicit round-to-nearest intrinsics in the order
// ((l0*h0)+(l1*h1))+(l2*h2), so that FMA contraction cannot move a gate
// decision at its boundary.
//
// Tie rule: a scan of columns in increasing order with a strict '<' (new
// minimum: d2 <- d1, d1 <- d, idx <- j; else d2 <- min(d2, d)) is the TPU
// kernel's per-tile argmin (lowest column of the minimum) and its merge (a
// later tile wins only with a strictly smaller value). Two partial results
// (a1, a2, ia) and (b1, b2, ib) of disjoint column sets merge into
// d1 = min(a1, b1), idx = the index of the smaller d1 (the lower one when
// a1 == b1), d2 = min(max(a1, b1), a2, b2): the plain version's bits for any
// partition of the columns.
//
// The int8 entry point: nn2_i8_columns, then nn2_i8_kernel. What bounds it
// on an H100: operations. At slice C's chunk (45 pairs of 11k x 11k
// keypoints) the cross term is 1.4e12 int8 operations, 0.7 ms at the
// 1979 TOP/s tensor-core peak, against 0.04 ms for the bytes; with the
// products on tensor cores, a per-(row, column) epilogue in f32 (distance,
// gate, validity, top-2) would cost more than the products. The design:
//   * Cross term: mma.sync m16n8k32 s8 x s8 -> s32 (exact). A block of 4
//     warps owns 128 rows of one pair; each warp keeps its 32 rows (two m16
//     tiles) in registers as A fragments for the whole column range. The
//     reduction index k is permuted so that every fragment comes from plain
//     16-byte loads: in k-step s, lane (g, t) (g = lane / 4, t = lane % 4)
//     holds bytes 32t + 8s .. 32t + 8s + 7 of its rows and columns, in A and
//     B alike.
//   * Columns stream through a ring of 3 shared-memory stages of 64 columns
//     (cp.async, 16 bytes a copy, zero-filled past N2), so the copy of tile
//     t + 2 overlaps the products of tile t. A staged column takes 144 bytes
//     (128 + 16 of padding): the 16-byte fragment loads of the 8 lanes of a
//     phase then fall on distinct banks (128 bytes would give a 2-way
//     conflict). Beside each column its record (sq_j, h0, h1, h2) is staged,
//     written once per call by nn2_i8_columns into a scratch of the wrapper
//     (16-byte aligned, which hpts_j's 12-byte rows are not). Made in the
//     kernel instead, every row block would recompute every column's norm:
//     that took 15% longer at slice C's chunk (PERF.md).
//   * Epilogue in integers. Each lane keeps, per row, e1 = d1 - sq_i and
//     e2 = d2 - sq_i, with 2^29 for "none" (BIG; every distance is below
//     2^24). A column's v = sq_j - 2 cross (one IMAD) is a candidate only if
//     v < thr (one compare), thr <= e2: a column with dist >= d2 changes
//     neither d1, d2 nor idx, whether its gate passes or not. The clamp
//     max(., 0) is dropped: dist = |a - b|^2 is a sum of squares of
//     integers, never negative. Invalid and padding columns get sq_j = 2^30,
//     so their v (at least 2^30 - 2^22) is never a candidate; invalid rows get
//     thr = INT_MIN. The gate is evaluated only in the m16 x n8 tiles where
//     some lane of the warp has a candidate, from registers (the row's line,
//     the column's record), without a branch per value: with a narrow gate
//     the distance bound lets through far more columns than the gate keeps,
//     and a divergent branch per candidate would serialise the warp.
//   * The top-2 across lanes. A row's columns are split over the 4 lanes of a
//     quad by the m16n8 accumulator layout (lane t holds columns 8n + 2t and
//     8n + 2t + 1). Each lane scans its own columns in increasing order; at
//     the start of each tile the quad merges its (e1, e2) into Q, the second
//     value of the columns seen so far (Q <= e2), and a lane prunes v >= Q
//     (thr = Q, then min(thr, e2) as e2 falls): Q is the larger of two values
//     at distinct columns of earlier tiles, so the final d1 and d2 are at
//     most Q, and a column of this tile, higher than those, cannot take idx
//     on a tie. After the last tile the quad merges (e1, e2, idx) with the
//     rule above (lane xor 1, then xor 2).
//   * No atomics, no cross-block state: two launches give the same bits.
//   * What sets the pace: the products with their loads, and the epilogue's
//     instruction issue (mostly the gate's f32 arithmetic on the tiles with
//     candidates), in about equal parts at slice C's chunk (PERF.md).
//
// The f32 kernel (nn2_f32_kernel) stays on CUDA cores: one thread per row,
// its descriptor in registers, column tiles in shared memory read as
// broadcasts. TF32 products would not be exact.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e12f;

// ---- int8 (tensor cores) ----
constexpr int kI8Warps = 4;
constexpr int kI8Rows = kI8Warps * 32;  // two m16 tiles per warp
constexpr int kI8Threads = kI8Warps * 32;
constexpr int kI8Tile = 64;             // columns per stage
constexpr int kI8Stages = 3;
constexpr int kI8Stride = 144;          // bytes per staged column
constexpr int kNone = 1 << 29;          // e of "no column yet" (BIG)
constexpr int kDead = INT_MIN;          // e2 and thr of an invalid row
constexpr int kColOff = 1 << 30;        // sq_j of an invalid or padding column

__device__ __forceinline__ int cols_padded(int N2) {
  return (N2 + kI8Tile - 1) / kI8Tile * kI8Tile;
}

// One warp per column of the padded range: its record (sq_j, h0, h1, h2),
// with sq_j = 2^30 for an invalid column and for the padding past N2.
__global__ void __launch_bounds__(256)
nn2_i8_columns(const int* __restrict__ dj, const float* __restrict__ hj,
               const float* __restrict__ vj, int4* __restrict__ cols, int N2) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int N2p = cols_padded(N2);
  if (c >= N2p) return;  // whole warps
  int4 rec = make_int4(kColOff, 0, 0, 0);
  if (c < N2) {
    const long g = static_cast<long>(b) * N2 + c;
    const int w = dj[g * 32 + lane];
    int s = __dp4a(w, w, 0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (vj[g] > 0.f) rec.x = s;
    rec.y = __float_as_int(hj[g * 3 + 0]);
    rec.z = __float_as_int(hj[g * 3 + 1]);
    rec.w = __float_as_int(hj[g * 3 + 2]);
  }
  if (lane == 0) cols[static_cast<long>(b) * N2p + c] = rec;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2, int a3, int b0,
                                       int b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (a1, a2) <- the first two values of the union of this lane's and lane ^ x's
__device__ __forceinline__ void merge2(int& a1, int& a2, int x) {
  const int b1 = __shfl_xor_sync(0xffffffffu, a1, x);
  const int b2 = __shfl_xor_sync(0xffffffffu, a2, x);
  a2 = min(max(a1, b1), min(a2, b2));
  a1 = min(a1, b1);
}

// the same with the index of the first (the lower one on a tie)
__device__ __forceinline__ void merge3(int& a1, int& a2, int& ia, int x) {
  const int b1 = __shfl_xor_sync(0xffffffffu, a1, x);
  const int b2 = __shfl_xor_sync(0xffffffffu, a2, x);
  const int ib = __shfl_xor_sync(0xffffffffu, ia, x);
  if (b1 < a1 || (b1 == a1 && ib < ia)) ia = ib;
  a2 = min(max(a1, b1), min(a2, b2));
  a1 = min(a1, b1);
}

// The products of n8 column block nb of the stage: acc[m] for row tile m, and
// the records of this lane's two columns.
__device__ __forceinline__ void block_products(const unsigned char* sd, const int4* sc,
                                               const int (&a)[2][16], int nb, int g, int t,
                                               int (&acc)[2][4], int4& c0, int4& c1) {
  const uint4* bp = reinterpret_cast<const uint4*>(sd + (8 * nb + g) * kI8Stride + 32 * t);
  const uint4 bl = bp[0], bh = bp[1];
  c0 = sc[8 * nb + 2 * t];
  c1 = sc[8 * nb + 2 * t + 1];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0;
    mma_s8(acc[m], a[m][0], a[m][1], a[m][2], a[m][3], (int)bl.x, (int)bl.y);
    mma_s8(acc[m], a[m][4], a[m][5], a[m][6], a[m][7], (int)bl.z, (int)bl.w);
    mma_s8(acc[m], a[m][8], a[m][9], a[m][10], a[m][11], (int)bh.x, (int)bh.y);
    mma_s8(acc[m], a[m][12], a[m][13], a[m][14], a[m][15], (int)bh.z, (int)bh.w);
  }
}

// The epilogue of row tile m of one n8 column block: acc[k] is (row slot
// 2m + k / 2, column c + k % 2), c the lane's first column of the block. A
// value is a candidate if v < thr of its row. Where some lane of the warp has
// one, the gate of the tile's 4 values is evaluated from registers, without
// a branch per value; a value that passes both updates its row's top-2, in
// column order.
__device__ __forceinline__ void tile_epilogue(const int (&acc)[4], int m, int4 c0, int4 c1,
                                              int c, const float (&L)[4][4], int (&e1)[4],
                                              int (&e2)[4], int (&idx)[4], int (&thr)[4]) {
  int v[4];
  bool cand = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = ((k & 1) ? c1.x : c0.x) - 2 * acc[k];
    cand |= v[k] < thr[2 * m + (k >> 1)];
  }
  if (!__any_sync(0xffffffffu, cand)) return;
  bool ok[4];
  bool any = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = 2 * m + (k >> 1);
    const int4 h = (k & 1) ? c1 : c0;
    const float num = __fadd_rn(__fadd_rn(__fmul_rn(L[r][0], __int_as_float(h.y)),
                                          __fmul_rn(L[r][1], __int_as_float(h.z))),
                                __fmul_rn(L[r][2], __int_as_float(h.w)));
    ok[k] = (v[k] < thr[r]) & (__fmul_rn(num, num) <= L[r][3]);
    any |= ok[k];
  }
  if (!any) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = 2 * m + (k >> 1);
    if (ok[k] && v[k] < thr[r]) {  // thr may have fallen at k - 1
      if (v[k] < e1[r]) {
        e2[r] = e1[r];
        e1[r] = v[k];
        idx[r] = c + (k & 1);
      } else {
        e2[r] = v[k];
      }
      thr[r] = min(thr[r], e2[r]);
    }
  }
}

__global__ void __launch_bounds__(kI8Threads, 4)
nn2_i8_kernel(const int8_t* __restrict__ di, const int8_t* __restrict__ dj,
              const float* __restrict__ li, const int4* __restrict__ cols,
              const float* __restrict__ vi, const float* __restrict__ thr_b,
              float* __restrict__ out, int N1, int N2) {
  __shared__ __align__(16) unsigned char s_desc[kI8Stages][kI8Tile * kI8Stride];
  __shared__ __align__(16) int4 s_cols[kI8Stages][kI8Tile];
  __shared__ int s_sq[kI8Rows];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * kI8Rows + warp * 32;
  const int N2p = cols_padded(N2);

  // Row slot r = 2m + h is row row0 + 16m + g + 8h. A fragments: a[m][4s + 2q + h]
  // is word 8t + 2s + q of row slot 2m + h. L[r]: l0, l1, l2, thr^2 (l0^2 + l1^2).
  int a[2][16];
  float L[4][4];
  int e1[4], e2[4], idx[4], thr[4];  // thr: a candidate has v < thr <= e2
  const float tb = thr_b[b];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + 16 * (r >> 1) + g + 8 * (r & 1);
    const bool live = row < N1;
    const long grow = static_cast<long>(b) * N1 + (live ? row : 0);
    uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
    L[r][0] = L[r][1] = L[r][2] = L[r][3] = 0.f;
    if (live) {
      const uint4* src = reinterpret_cast<const uint4*>(di + grow * 128 + 32 * t);
      lo = src[0];
      hi = src[1];
      L[r][0] = li[grow * 3 + 0];
      L[r][1] = li[grow * 3 + 1];
      L[r][2] = li[grow * 3 + 2];
      L[r][3] = __fmul_rn(__fmul_rn(tb, tb),
                          __fadd_rn(__fmul_rn(L[r][0], L[r][0]), __fmul_rn(L[r][1], L[r][1])));
    }
    const int w[8] = {(int)lo.x, (int)lo.y, (int)lo.z, (int)lo.w,
                      (int)hi.x, (int)hi.y, (int)hi.z, (int)hi.w};
    int s = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      a[r >> 1][4 * (k >> 1) + 2 * (k & 1) + (r & 1)] = w[k];
      s = __dp4a(w[k], w[k], s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (t == 0) s_sq[warp * 32 + 16 * (r >> 1) + g + 8 * (r & 1)] = s;
    e1[r] = kNone;
    e2[r] = (live && vi[grow] > 0.f) ? kNone : kDead;
    idx[r] = 0;
    thr[r] = e2[r];
  }

  const int8_t* dj_b = dj + static_cast<long>(b) * N2 * 128;
  const int4* cols_b = cols + static_cast<long>(b) * N2p;
  auto load = [&](int tile, int stage) {
    const int c0 = tile * kI8Tile;
    for (int k = tid; k < kI8Tile * 8; k += kI8Threads) {
      const int c = k >> 3, q = k & 7;
      const bool in = c0 + c < N2;
      const int8_t* src = in ? dj_b + static_cast<long>(c0 + c) * 128 + 16 * q : dj;
      cp_async16(&s_desc[stage][c * kI8Stride + 16 * q], src, in ? 16 : 0);
    }
    if (tid < kI8Tile) cp_async16(&s_cols[stage][tid], cols_b + c0 + tid, 16);
  };

  const int n_tiles = N2p / kI8Tile;
#pragma unroll
  for (int s = 0; s < kI8Stages - 1; ++s) {
    if (s < n_tiles) load(s, s);
    cp_async_commit();
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kI8Stages - 2>();
    __syncthreads();  // tile landed for every thread; tile - 1's stage is free
    if (tile + kI8Stages - 1 < n_tiles) load(tile + kI8Stages - 1, (tile + kI8Stages - 1) % kI8Stages);
    cp_async_commit();

    // the quad's bound: prune v >= Q (the second value of the quad's columns)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      int q1 = e1[r], q2 = e2[r];
      merge2(q1, q2, 1);
      merge2(q1, q2, 2);
      thr[r] = q2;
    }

    const unsigned char* sd = s_desc[tile % kI8Stages];
    const int4* sc = s_cols[tile % kI8Stages];
#pragma unroll 1
    for (int nb = 0; nb < kI8Tile / 8; ++nb) {
      int acc[2][4];
      int4 c0, c1;
      block_products(sd, sc, a, nb, g, t, acc, c0, c1);
      const int c = tile * kI8Tile + 8 * nb + 2 * t;  // this lane's first column
#pragma unroll
      for (int m = 0; m < 2; ++m) tile_epilogue(acc[m], m, c0, c1, c, L, e1, e2, idx, thr);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    merge3(e1[r], e2[r], idx[r], 1);
    merge3(e1[r], e2[r], idx[r], 2);
    const int row = row0 + 16 * (r >> 1) + g + 8 * (r & 1);
    if (row < N1 && t < 3) {
      const bool ok = e2[r] != kDead;
      const int sq = s_sq[warp * 32 + 16 * (r >> 1) + g + 8 * (r & 1)];
      float val;
      if (t == 0) val = (ok && e1[r] != kNone) ? static_cast<float>(e1[r] + sq) : kBig;
      else if (t == 1) val = (ok && e2[r] != kNone) ? static_cast<float>(e2[r] + sq) : kBig;
      else val = ok ? static_cast<float>(idx[r]) : 0.f;
      out[static_cast<long>(b) * 3 * N1 + static_cast<long>(t) * N1 + row] = val;
    }
  }
}

// ---- f32 (CUDA cores) ----
constexpr int kF32Rows = 128;  // rows (threads) per block
constexpr int kF32Tile = 64;   // columns per shared-memory tile

__global__ void __launch_bounds__(kF32Rows)
nn2_f32_kernel(const float* __restrict__ di, const float* __restrict__ dj,
               const float* __restrict__ li, const float* __restrict__ hj,
               const float* __restrict__ vi, const float* __restrict__ vj,
               const float* __restrict__ thr, float* __restrict__ out, int N1, int N2) {
  constexpr int W = 128;
  constexpr int T = kF32Tile;
  __shared__ __align__(16) float s_desc[T * W];
  __shared__ float s_h[T * 3];
  __shared__ float s_sq[T];
  __shared__ float s_ok[T];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = blockIdx.x * kF32Rows + tid;
  const bool live = row < N1;
  const long rrow = static_cast<long>(b) * N1 + (live ? row : 0);

  // this thread's row: descriptor, squared norm, line, validity
  float r[W];
  {
    const float4* src = reinterpret_cast<const float4*>(di + rrow * W);
#pragma unroll
    for (int k = 0; k < W / 4; ++k) {
      const float4 v = src[k];
      r[4 * k + 0] = v.x;
      r[4 * k + 1] = v.y;
      r[4 * k + 2] = v.z;
      r[4 * k + 3] = v.w;
    }
  }
  float sq_i = 0.f;
#pragma unroll
  for (int k = 0; k < W; ++k) sq_i = __fadd_rn(sq_i, __fmul_rn(r[k], r[k]));
  const float l0 = li[rrow * 3 + 0], l1 = li[rrow * 3 + 1], l2 = li[rrow * 3 + 2];
  const float t = thr[b];
  const float gate_rhs = __fmul_rn(__fmul_rn(t, t), __fadd_rn(__fmul_rn(l0, l0), __fmul_rn(l1, l1)));
  const bool row_ok = live && vi[rrow] > 0.f;

  float d1 = kBig, d2 = kBig;
  int idx = 0;

  const float* dj_b = dj + static_cast<long>(b) * N2 * W;
  for (int c0 = 0; c0 < N2; c0 += T) {
    const int n = min(T, N2 - c0);
    __syncthreads();  // the previous tile is no longer read
    {
      const float4* src = reinterpret_cast<const float4*>(dj_b + static_cast<long>(c0) * W);
      float4* dst = reinterpret_cast<float4*>(s_desc);
      for (int v = tid; v < n * (W / 4); v += kF32Rows) dst[v] = src[v];
      for (int c = tid; c < n; c += kF32Rows) {
        const long g = static_cast<long>(b) * N2 + c0 + c;
        s_h[3 * c + 0] = hj[g * 3 + 0];
        s_h[3 * c + 1] = hj[g * 3 + 1];
        s_h[3 * c + 2] = hj[g * 3 + 2];
        s_ok[c] = vj[g];
      }
    }
    __syncthreads();
    // column norms: one warp per column, four floats per lane, then a
    // shuffle tree
    for (int c = warp; c < n; c += kF32Rows / 32) {
      const float4 v = reinterpret_cast<const float4*>(s_desc + c * W)[lane];
      float s = __fadd_rn(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)),
                          __fadd_rn(__fmul_rn(v.z, v.z), __fmul_rn(v.w, v.w)));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
      if (lane == 0) s_sq[c] = s;
    }
    __syncthreads();
    if (!live) continue;
    for (int c = 0; c < n; ++c) {
      const float4* col = reinterpret_cast<const float4*>(s_desc + c * W);
      float cross = 0.f;
#pragma unroll
      for (int k = 0; k < W / 4; ++k) {
        const float4 v = col[k];
        cross = fmaf(r[4 * k + 0], v.x, cross);
        cross = fmaf(r[4 * k + 1], v.y, cross);
        cross = fmaf(r[4 * k + 2], v.z, cross);
        cross = fmaf(r[4 * k + 3], v.w, cross);
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

}  // namespace

extern "C" {

// Bytes of the scratch nn2_match_i8 needs: one 16-byte column record per
// column of each pair, N2 rounded up to the column tile.
long nn2_match_i8_scratch_bytes(int B, int N2) {
  return 16L * B * ((N2 + kI8Tile - 1) / kI8Tile * kI8Tile);
}

// di (B, N1, 128) int8, dj (B, N2, 128) int8, li (B, N1, 3), hj (B, N2, 3),
// vi (B, N1), vj (B, N2), thr (B,) float32; out (B, 3, N1) float32; scratch
// of nn2_match_i8_scratch_bytes(B, N2) bytes. All contiguous on the device,
// descriptor and scratch pointers 16-byte aligned. Two launches: the column
// records, then the matching. Returns the first CUDA error (0 on success).
int nn2_match_i8(const void* di, const void* dj, const void* li, const void* hj,
                 const void* vi, const void* vj, const void* thr, void* out, void* scratch,
                 int B, int N1, int N2, void* stream) {
  if (B <= 0 || N1 <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N2p = (N2 + kI8Tile - 1) / kI8Tile * kI8Tile;
  if (N2p > 0) {
    nn2_i8_columns<<<dim3(N2p / 8, B), 256, 0, st>>>(
        static_cast<const int*>(dj), static_cast<const float*>(hj),
        static_cast<const float*>(vj), static_cast<int4*>(scratch), N2);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((N1 + kI8Rows - 1) / kI8Rows, B);
  nn2_i8_kernel<<<grid, kI8Threads, 0, st>>>(
      static_cast<const int8_t*>(di), static_cast<const int8_t*>(dj),
      static_cast<const float*>(li), static_cast<const int4*>(scratch),
      static_cast<const float*>(vi), static_cast<const float*>(thr),
      static_cast<float*>(out), N1, N2);
  return static_cast<int>(cudaGetLastError());
}

// The same with float32 descriptors (B, N1, 128) and (B, N2, 128), on CUDA
// cores; one launch.
int nn2_match_f32(const void* di, const void* dj, const void* li, const void* hj,
                  const void* vi, const void* vj, const void* thr, void* out,
                  int B, int N1, int N2, void* stream) {
  if (B <= 0 || N1 <= 0) return 0;
  dim3 grid((N1 + kF32Rows - 1) / kF32Rows, B);
  nn2_f32_kernel<<<grid, kF32Rows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(di), static_cast<const float*>(dj),
      static_cast<const float*>(li), static_cast<const float*>(hj),
      static_cast<const float*>(vi), static_cast<const float*>(vj),
      static_cast<const float*>(thr), static_cast<float*>(out), N1, N2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
