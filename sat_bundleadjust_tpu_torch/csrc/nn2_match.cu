// Epipolar-gated 2-nearest-neighbour descriptor matching, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of sat_bundleadjust_tpu/ops/pallas_match.py:
//   * nn2_match_i8  <- pallas_2nn_batched_i8 (:240, body _kernel_b_i8 :162):
//     int8 descriptors (value - 128), the cross term on the tensor cores;
//   * nn2_match_f32 <- pallas_2nn_batched (:294, body _kernel_b :99) and,
//     with B = 1, pallas_2nn (:353, body _kernel :34): f32 descriptors, the
//     cross term on the tensor cores as a three-product TF32 split.
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
// The f32 entry point: nn2_tf32_columns, nn2_tf32_kernel and, where the
// columns are split, nn2_merge_splits. It replaces pallas_2nn_batched (:294,
// call :318, body _kernel_b :99) and, with B = 1, pallas_2nn (:353,
// _call_kernel :382, call :383, body _kernel :34). What bounds it on an
// H100: operations. At slice C's chunk the cross term is 1.4e12 operations,
// 2.78 ms at the 495 TFLOP/s TF32 tensor-core rate, and the three products
// of the split below make that 8.3 ms, against ~0.3 ms for the bytes. The
// design:
//   * Cross term: wgmma m64n32k8 TF32 with f32 accumulation (mma.sync
//     m16n8k8 issues at about half of wgmma's rate), and a split a = a_hi +
//     a_lo with a_hi = tf32(a), a_lo = tf32(a - a_hi) (cvt.rna): a.b ~
//     a_hi.b_hi + (a_hi.b_lo + a_lo.b_hi). The tensor cores truncate toward
//     zero where they add, so on positive descriptors a sum they carry comes
//     out low and every distance high, by about half an ulp of the running
//     sum at each add: main products summed in two chains of 8 k-steps gave
//     d1 a mean bias of 1.3-2.8 eps * S (S below; PERF.md), which the plain
//     version does not have. So each k-step's main products (a sum of 8) go
//     into a fresh accumulator and are added to the row's f32 sum on the
//     CUDA cores, round-to-nearest, in k order: the truncation then acts on
//     sums of 8 products only, about 1/16 of the cross term each, and the
//     adds are unbiased. Two accumulator sets take turns, so that the next
//     k-step's products run while this one's are added. The corrections,
//     2^-11 of the main products, keep one chain in the tensor cores, and
//     cross = main + cc in f32. TF32 keeps 11 significant bits, so every
//     integer up to 2047 is exact in it: on descriptor values in 0..255,
//     a_hi = a, a_lo = 0, every product is an exact integer and every
//     partial sum of 128 of them an integer below 2^24, exact in f32 in
//     whatever order it is added (and so never truncated). So integer
//     descriptors give the same bits as the int8 kernel, the plain version
//     and JAX. On other values the split drops a_lo.b_lo and the rounding
//     of a_lo and b_lo (about 2^-22 |a||b| a product) and the tensor cores
//     truncate each k-step's sum: distances stay within 16 ulp of
//     S = max sq_i + max sq_j of exact ones, and d1's mean error within
//     half an ulp, the bars of chip_smoke.py and tests/test_torch_cuda.py.
//   * A block of two warpgroups owns 128 rows of one pair; each warp keeps
//     its 16 rows in registers as A fragments, hi and lo (128 registers a
//     lane), for the whole column range; the columns' hi and lo come from
//     shared memory, read by the tensor cores themselves. The k order is
//     fixed by the shapes: k-step s takes elements 8s .. 8s + 7 in A and B,
//     the sums above in that order, so a given (i, j) always gets the same
//     products in the same order, whatever the grid.
//   * nn2_tf32_columns writes, once per call, each 32-column tile of a pair
//     as one 33 KB block: the columns' hi and lo in the tensor cores'
//     canonical K-major layout without swizzle (core matrices of 8 columns x
//     16 bytes) and their records (sq_j, h0, h1, h2); sq_j = +inf marks an
//     invalid or padding column, whose dist is then +inf. Tiles stream
//     through a ring of 4 shared-memory stages, one bulk asynchronous copy
//     a tile and an mbarrier a stage. Blocks of adjacent rows run in
//     clusters of 2 and each copies half of every tile to both (multicast):
//     at 1 KB a column, blocks that each read their own tiles move 44 GB
//     through the L2 at slice C's chunk, and that traffic set their pace.
//     A split cluster barrier frees a stage for the next copy: each thread
//     arrives when it is done with a tile and waits while the tensor cores
//     run the next one.
//   * Epilogue in f32: dist = max((sq_i + sq_j) - 2 cross, 0), rounded as
//     the plain version rounds it (2 cross is exact, so one fma gives the
//     subtraction's bits). A value is a candidate only if dist < thr of its
//     row, thr <= d2, with the quad's bound Q per tile as in the int8 kernel
//     and on the rounded dist itself: Q is the larger of two values at
//     distinct earlier columns, so a later column with dist >= Q changes
//     neither d1, d2 nor idx. The gate is evaluated only in the m16 x n8
//     tiles where some lane has a candidate.
//   * Column split: grid (row blocks, B, S). Split z takes the whole tiles
//     of columns [z C, (z + 1) C) and writes its (d1, d2, idx) to a scratch;
//     nn2_merge_splits then merges the S partials in increasing z with the
//     rule above. The distance of a given (i, j) does not depend on the
//     split, and the merge gives the plain version's bits for any partition
//     of the columns, so the result does not depend on S. The wrapper takes
//     S from nn2_match_f32_splits, about two waves of blocks (S = 1 at slice
//     C's chunk of 45 pairs; S = 3 for one pair of 11k rows on 132 SMs);
//     nn2_match_f32 derives C from S. No atomics: two launches give the
//     same bits.
//   * What sets the pace: a warpgroup's epilogue of a tile runs after its
//     own products, and the two warpgroups of a block queue theirs at the
//     same time, so the tensor cores idle for part of each tile (PERF.md).

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

// N2 rounded up to a whole number of column tiles
template <int Tile>
__host__ __device__ __forceinline__ int cols_padded(int N2) {
  return (N2 + Tile - 1) / Tile * Tile;
}

// The record (sq_j, h0, h1, h2) of column g, sq_j = off for an invalid column.
__device__ __forceinline__ float4 column_record(float sq, float off, const float* vj,
                                                const float* hj, long g) {
  return make_float4(vj[g] > 0.f ? sq : off, hj[g * 3 + 0], hj[g * 3 + 1], hj[g * 3 + 2]);
}

// One warp per column of the padded range: its record (sq_j, h0, h1, h2),
// with sq_j = 2^30 for an invalid column and for the padding past N2.
__global__ void __launch_bounds__(256)
nn2_i8_columns(const int* __restrict__ dj, const float* __restrict__ hj,
               const float* __restrict__ vj, int4* __restrict__ cols, int N2) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int N2p = cols_padded<kI8Tile>(N2);
  if (c >= N2p) return;  // whole warps
  float4 rec = make_float4(__int_as_float(kColOff), 0.f, 0.f, 0.f);
  if (c < N2) {
    const long g = static_cast<long>(b) * N2 + c;
    const int w = dj[g * 32 + lane];
    int s = __dp4a(w, w, 0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    rec = column_record(__int_as_float(s), __int_as_float(kColOff), vj, hj, g);
  }
  if (lane == 0) reinterpret_cast<float4*>(cols)[static_cast<long>(b) * N2p + c] = rec;
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
// (T: int for the int8 kernel, float for the f32 one)
template <typename T>
__device__ __forceinline__ void merge2(T& a1, T& a2, int x) {
  const T b1 = __shfl_xor_sync(0xffffffffu, a1, x);
  const T b2 = __shfl_xor_sync(0xffffffffu, a2, x);
  a2 = min(max(a1, b1), min(a2, b2));
  a1 = min(a1, b1);
}

// (a1, a2, ia) <- the merge of (a1, a2, ia) and (b1, b2, ib), the top-2 of
// two disjoint column sets, by the rule at the head of this file
template <typename T, typename I>
__device__ __forceinline__ void merge_top2(T& a1, T& a2, I& ia, T b1, T b2, I ib) {
  if (b1 < a1 || (b1 == a1 && ib < ia)) ia = ib;
  a2 = min(max(a1, b1), min(a2, b2));
  a1 = min(a1, b1);
}

// the same as merge2 with the index of the first (the lower one on a tie)
template <typename T>
__device__ __forceinline__ void merge3(T& a1, T& a2, int& ia, int x) {
  const T b1 = __shfl_xor_sync(0xffffffffu, a1, x);
  const T b2 = __shfl_xor_sync(0xffffffffu, a2, x);
  const int ib = __shfl_xor_sync(0xffffffffu, ia, x);
  merge_top2(a1, a2, ia, b1, b2, ib);
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
  const int N2p = cols_padded<kI8Tile>(N2);

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

// ---- f32 (TF32 tensor cores: wgmma, three-product split) ----
constexpr int kFWarps = 8;             // two warpgroups
constexpr int kFRows = kFWarps * 16;   // 16 rows a warp
constexpr int kFThreads = kFWarps * 32;
constexpr int kFTile = 32;             // columns per stage: one m64n32k8 product a k-step
constexpr int kFStages = 4;
constexpr int kFCluster = 2;           // blocks of adjacent rows that share each column tile
constexpr int kFHalf = kFTile * 128 * 4;          // hi (or lo) of a tile: 16 KB
constexpr int kFTileBytes = 2 * kFHalf + kFTile * 16;  // hi, lo, then the column records
constexpr int kFSmem = kFStages * kFTileBytes + kFStages * 8;
constexpr int kLBO = 128;              // bytes between core matrices adjacent in k
constexpr int kSBO = 32 * kLBO;        // bytes between core matrices adjacent in columns

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// cvt.rna.tf32.f32 (nearest, ties away from zero), its low 13 bits cleared
__device__ __forceinline__ float tf32_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

// One warp per column of the padded range: the column's hi and lo in the
// tensor cores' canonical K-major layout (element k of column n of a tile at
// byte (n / 8) * kSBO + (k / 4) * kLBO + (n % 8) * 16 + (k % 4) * 4 of its
// hi or lo block) and its record (sq_j, h0, h1, h2), with zeros and sq_j =
// +inf past N2 and sq_j = +inf for an invalid column. Pair b's tile T is
// kFTileBytes at tiles + (b * N2p / kFTile + T) * kFTileBytes.
__global__ void __launch_bounds__(256)
nn2_tf32_columns(const float* __restrict__ dj, const float* __restrict__ hj,
                 const float* __restrict__ vj, unsigned char* __restrict__ tiles, int N2) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int N2p = cols_padded<kFTile>(N2);
  if (c >= N2p) return;  // whole warps
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 rec = make_float4(inf_f(), 0.f, 0.f, 0.f);
  if (c < N2) {
    const long g = static_cast<long>(b) * N2 + c;
    v = reinterpret_cast<const float4*>(dj + g * 128)[lane];
    float s = __fadd_rn(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)),
                        __fadd_rn(__fmul_rn(v.z, v.z), __fmul_rn(v.w, v.w)));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    rec = column_record(s, inf_f(), vj, hj, g);
  }
  const float4 hi = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
  const float4 lo = make_float4(tf32_rna(__fsub_rn(v.x, hi.x)), tf32_rna(__fsub_rn(v.y, hi.y)),
                                tf32_rna(__fsub_rn(v.z, hi.z)), tf32_rna(__fsub_rn(v.w, hi.w)));
  const int n = c % kFTile;
  unsigned char* tile =
      tiles + (static_cast<long>(b) * (N2p / kFTile) + c / kFTile) * kFTileBytes;
  const int o = (n >> 3) * kSBO + lane * kLBO + (n & 7) * 16;
  *reinterpret_cast<float4*>(tile + o) = hi;
  *reinterpret_cast<float4*>(tile + kFHalf + o) = lo;
  if (lane == 0) reinterpret_cast<float4*>(tile + 2 * kFHalf)[n] = rec;
}

// Shared-memory descriptor of a K-major operand without swizzle: core
// matrices of 8 columns x 16 bytes, kLBO bytes apart along k, kSBO along
// the columns.
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  const uint64_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(kLBO >> 4) << 16) |
         (static_cast<uint64_t>(kSBO >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N committed groups of this warpgroup's products run
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from touching an accumulator while a product runs
__device__ __forceinline__ void wg_hold(float (&d)[16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) asm volatile("" : "+f"(d[k])::"memory");
}

// d (+)= a . b, m64n32k8: A (the warp's 16 rows) in registers, B from shared
// memory; scale_d = 0 starts from zero.
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const unsigned (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(bar), "r"(parity) : "memory");
}

// The tile block at src into stage `stage` of every block of the cluster:
// each block copies 1 / kFCluster of its bytes to all of them (one bulk
// copy, multicast) and expects the whole tile on its own barrier `bar`.
__device__ __forceinline__ void issue_tile(const unsigned char* src, unsigned char* smem,
                                           uint32_t bar, int stage, uint32_t rank) {
  constexpr int part = kFTileBytes / kFCluster;
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem + stage * kFTileBytes))
                       + rank * part;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(kFTileBytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst), "l"(src + rank * part), "r"(part), "r"(bar),
      "h"(static_cast<uint16_t>((1 << kFCluster) - 1)) : "memory");
}

// The candidates of one m16 x n8 tile: dist[k] of (row slot k / 2, column
// c + k % 2), c the lane's first column of the block, rec its two columns'
// records. As the second half of tile_epilogue, on the rounded f32 dist.
__device__ __forceinline__ void tf32_update(const float (&dist)[4], const float4* rec, int c,
                                            const float (&L)[2][4], float (&d1)[2],
                                            float (&d2)[2], int (&idx)[2], float (&thr)[2]) {
  bool cand = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) cand |= dist[k] < thr[k >> 1];
  if (!__any_sync(0xffffffffu, cand)) return;
  const float4 r0 = rec[0], r1 = rec[1];
  bool ok[4];
  bool any = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = k >> 1;
    const float4 h = (k & 1) ? r1 : r0;
    const float num = __fadd_rn(__fadd_rn(__fmul_rn(L[r][0], h.y), __fmul_rn(L[r][1], h.z)),
                                __fmul_rn(L[r][2], h.w));
    ok[k] = (dist[k] < thr[r]) & (__fmul_rn(num, num) <= L[r][3]);
    any |= ok[k];
  }
  if (!any) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = k >> 1;
    if (ok[k] && dist[k] < thr[r]) {  // thr may have fallen at k - 1
      if (dist[k] < d1[r]) {
        d2[r] = d1[r];
        d1[r] = dist[k];
        idx[r] = c + (k & 1);
      } else {
        d2[r] = dist[k];
      }
      thr[r] = fminf(thr[r], d2[r]);
    }
  }
}

// Grid (row blocks rounded up to the cluster, B, S), clusters of kFCluster
// blocks along x: split z scans the tiles of columns [z * split_cols,
// min((z + 1) * split_cols, N2p)) and writes its (d1, d2, idx) to
// dst[((z * B + b) * 3 + k) * N1 + row] (the packed output when S = 1).
__global__ void __cluster_dims__(kFCluster, 1, 1) __launch_bounds__(kFThreads, 1)
nn2_tf32_kernel(const float* __restrict__ di, const unsigned char* __restrict__ tiles,
                const float* __restrict__ li, const float* __restrict__ vi,
                const float* __restrict__ thr_b, float* __restrict__ dst, int N1, int N2,
                int split_cols) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bars =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem + kFStages * kFTileBytes));

  const int b = blockIdx.y;
  const int z = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * kFRows + warp * 16;
  const int N2p = cols_padded<kFTile>(N2);
  const int c_begin = z * split_cols;
  const int n_tiles = (min(N2p, c_begin + split_cols) - c_begin) / kFTile;
  uint32_t rank;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));

  if (tid == 0) {
    for (int s = 0; s < kFStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bars + 8 * s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every block's barriers are ready before any copy signals them
  const unsigned char* tiles_b =
      tiles + (static_cast<long>(b) * (N2p / kFTile) + c_begin / kFTile) * kFTileBytes;
  if (tid == 0)
    for (int s = 0; s < kFStages && s < n_tiles; ++s)
      issue_tile(tiles_b + static_cast<long>(s) * kFTileBytes, smem, bars + 8 * s, s, rank);

  // Row slot r is row row0 + g + 8r. A fragments of k-step s (elements 8s ..
  // 8s + 7): ahi[s][r] is element 8s + t of row slot r, ahi[s][2 + r] element
  // 8s + t + 4 (alo the same for the low parts). L[r]: l0, l1, l2,
  // thr^2 (l0^2 + l1^2).
  unsigned ahi[16][4], alo[16][4];
  float sq[2], L[2][4], d1[2], d2[2], thr[2];
  int idx[2];
  const float tb = thr_b[b];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const bool live = row < N1;
    const long grow = static_cast<long>(b) * N1 + (live ? row : 0);
    const float* src = di + grow * 128 + t;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float w = live ? src[8 * k + 4 * h] : 0.f;
        s = __fmaf_rn(w, w, s);
        const float hi = tf32_rna(w);
        ahi[k][2 * h + r] = __float_as_uint(hi);
        alo[k][2 * h + r] = __float_as_uint(tf32_rna(__fsub_rn(w, hi)));
      }
    }
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
    sq[r] = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
    L[r][0] = L[r][1] = L[r][2] = L[r][3] = 0.f;
    if (live) {
      L[r][0] = li[grow * 3 + 0];
      L[r][1] = li[grow * 3 + 1];
      L[r][2] = li[grow * 3 + 2];
      L[r][3] = __fmul_rn(__fmul_rn(tb, tb),
                          __fadd_rn(__fmul_rn(L[r][0], L[r][0]), __fmul_rn(L[r][1], L[r][1])));
    }
    d1[r] = kBig;
    d2[r] = (live && vi[grow] > 0.f) ? kBig : -inf_f();  // -inf: an invalid row
    idx[r] = 0;
    thr[r] = d2[r];
  }

  // The main products of each k-step in a fresh accumulator (pa for even
  // steps, pb for odd ones: the next step's products run while this one's
  // are added), added with round-to-nearest f32 adds into msum in k order;
  // the corrections in one chain, cc. cross = msum + cc.
  float pa[16], pb[16], msum[16], cc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) pa[k] = pb[k] = cc[k] = 0.f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile % kFStages;
    mbar_wait(bars + 8 * stage, (tile / kFStages) & 1);
    __syncwarp();  // converged for the warpgroup's products

    unsigned char* st = smem + stage * kFTileBytes;
    const uint64_t dh = wg_desc(st), dl = wg_desc(st + kFHalf);
#pragma unroll
    for (int k = 0; k < 16; ++k) msum[k] = 0.f;
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const uint64_t o = (2 * s * kLBO) >> 4;  // k-step s: core matrices 2s and 2s + 1
      float(&cur)[16] = (s & 1) ? pb : pa;
      float(&prev)[16] = (s & 1) ? pa : pb;
      wg_hold(cur);
      wg_hold(cc);
      wg_fence();
      wgmma_tf32(cur, ahi[s], dh + o, 0);
      wgmma_tf32(cc, ahi[s], dl + o, s != 0);
      wgmma_tf32(cc, alo[s], dh + o, 1);
      wg_commit();
      if (s > 0) {
        wg_wait<1>();  // k-step s - 1 is done; s runs on
        wg_hold(prev);
#pragma unroll
        for (int k = 0; k < 16; ++k) msum[k] = __fadd_rn(msum[k], prev[k]);
      }
    }
    // while the tensor cores run the last k-step: every block of the cluster
    // is done with tile - 1, whose stage thread 0 refills with tile - 1 + kFStages
    if (tile > 0) {
      cluster_wait();
      if (tid == 0 && tile - 1 + kFStages < n_tiles)
        issue_tile(tiles_b + static_cast<long>(tile - 1 + kFStages) * kFTileBytes, smem,
                   bars + 8 * ((tile - 1) % kFStages), (tile - 1) % kFStages, rank);
      __syncwarp();
    }
    wg_wait<0>();
    wg_hold(pb);
    wg_hold(cc);
#pragma unroll
    for (int k = 0; k < 16; ++k) msum[k] = __fadd_rn(msum[k], pb[k]);

    // the quad's bound: prune dist >= Q (the second value of the quad's columns)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float q1 = d1[r], q2 = d2[r];
      merge2(q1, q2, 1);
      merge2(q1, q2, 2);
      thr[r] = q2;
    }
    // dist of the tile's 16 values of this lane, (row slot k / 2, column
    // c0 + 8 nb + k % 2): dist[nb][k] = max((sq_i + sq_j) - 2 cross, 0)
    const float4* sr = reinterpret_cast<const float4*>(st + 2 * kFHalf) + 2 * t;
    const int c0 = c_begin + tile * kFTile + 2 * t;  // this lane's first column
    float dist[4][4];
    bool cand = false;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = k >> 1;
        const float cross = __fadd_rn(msum[4 * nb + k], cc[4 * nb + k]);
        const float s = __fadd_rn(sq[r], sr[8 * nb + (k & 1)].x);
        dist[nb][k] = fmaxf(__fmaf_rn(-2.f, cross, s), 0.f);
        cand |= dist[nb][k] < thr[r];
      }
    }
    if (__any_sync(0xffffffffu, cand)) {
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
        tf32_update(dist[nb], sr + 8 * nb, c0 + 8 * nb, L, d1, d2, idx, thr);
    }
    cluster_arrive();  // this block reads this stage no more
  }
  if (n_tiles > 0) cluster_wait();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    merge3(d1[r], d2[r], idx[r], 1);
    merge3(d1[r], d2[r], idx[r], 2);
    const int row = row0 + g + 8 * r;
    if (row < N1 && t < 3) {
      const bool ok = d2[r] != -inf_f();
      float val;
      if (t == 0) val = ok ? d1[r] : kBig;
      else if (t == 1) val = ok ? d2[r] : kBig;
      else val = ok ? static_cast<float>(idx[r]) : 0.f;
      dst[((static_cast<long>(z) * gridDim.y + b) * 3 + t) * N1 + row] = val;
    }
  }
}

// out[b] <- the S partials part[z][b] merged in increasing z.
__global__ void __launch_bounds__(256)
nn2_merge_splits(const float* __restrict__ part, float* __restrict__ out, int B, int N1,
                 int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= N1) return;
  const long n = static_cast<long>(N1);
  const float* p = part + static_cast<long>(b) * 3 * n + i;
  float a1 = p[0], a2 = p[n];
  float ia = p[2 * n];
  for (int z = 1; z < S; ++z) {
    const float* q = p + static_cast<long>(z) * B * 3 * n;
    merge_top2(a1, a2, ia, q[0], q[n], q[2 * n]);
  }
  float* o = out + static_cast<long>(b) * 3 * n + i;
  o[0] = a1;
  o[n] = a2;
  o[2 * n] = ia;
}

}  // namespace

extern "C" {

// Bytes of the scratch nn2_match_i8 needs: one 16-byte column record per
// column of each pair, N2 rounded up to the column tile.
long nn2_match_i8_scratch_bytes(int B, int N2) {
  return 16L * B * cols_padded<kI8Tile>(N2);
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
  const int N2p = cols_padded<kI8Tile>(N2);
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

// Bytes of the scratch nn2_match_f32 needs: per column of each pair, N2
// rounded up to the column tile, its hi and lo (1 KB) and its 16-byte record.
long nn2_match_f32_scratch_bytes(int B, int N2) {
  return static_cast<long>(kFTileBytes) * B * (cols_padded<kFTile>(N2) / kFTile);
}

// The number of column splits nn2_match_f32 takes for B pairs of N1 x N2 on
// a card of `sms` SMs: about two waves of blocks (one block an SM), at most
// one split a column tile; 1 once the pairs' row blocks fill two waves.
int nn2_match_f32_splits(int B, int N1, int N2, int sms) {
  const long blocks = static_cast<long>(B) * ((N1 + kFRows - 1) / kFRows);
  const long s = 2L * sms / (blocks > 0 ? blocks : 1);
  const int n_tiles = cols_padded<kFTile>(N2) / kFTile;
  return static_cast<int>(s < 1 ? 1 : (s < n_tiles ? s : n_tiles > 0 ? n_tiles : 1));
}

// The same with float32 descriptors (B, N1, 128) and (B, N2, 128), on the
// tensor cores (TF32 split), the columns cut into at most S splits of whole
// column tiles, the last one ragged and none empty. part: (S, B, 3, N1)
// float32 for S > 1, else unused. Scratch of nn2_match_f32_scratch_bytes
// (B, N2) bytes, 16-byte aligned. Two launches (column tiles, matching),
// three with more than one split (the merge). Returns the first CUDA error
// (0 on success).
int nn2_match_f32(const void* di, const void* dj, const void* li, const void* hj,
                  const void* vi, const void* vj, const void* thr, void* out, void* scratch,
                  void* part, int B, int N1, int N2, int S, void* stream) {
  if (B <= 0 || N1 <= 0) return 0;
  if (S < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N2p = cols_padded<kFTile>(N2);
  // per tiles a split, and the splits that S of them leave non-empty
  const int n_tiles = N2p / kFTile;
  const int per = (n_tiles + S - 1) / S;
  const int splits = per > 0 ? (n_tiles + per - 1) / per : 1;
  unsigned char* tiles = static_cast<unsigned char*>(scratch);
  if (N2p > 0) {
    nn2_tf32_columns<<<dim3(N2p / 8, B), 256, 0, st>>>(
        static_cast<const float*>(dj), static_cast<const float*>(hj),
        static_cast<const float*>(vj), tiles, N2);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaError_t e = cudaFuncSetAttribute(nn2_tf32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kFSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  float* dst = static_cast<float*>(splits > 1 ? part : out);
  const int blocks = (N1 + kFRows - 1) / kFRows;
  dim3 grid((blocks + kFCluster - 1) / kFCluster * kFCluster, B, splits);
  nn2_tf32_kernel<<<grid, kFThreads, kFSmem, st>>>(
      static_cast<const float*>(di), tiles, static_cast<const float*>(li),
      static_cast<const float*>(vi), static_cast<const float*>(thr), dst, N1, N2, per * kFTile);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  nn2_merge_splits<<<dim3((N1 + 255) / 256, B), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(out), B, N1, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
