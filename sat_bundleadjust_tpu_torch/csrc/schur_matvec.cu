// Schur-complement CG operator of the BA solve, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sat_bundleadjust_tpu/ops/pallas_matvec.py
// (schur_wz, :263; its pallas_call :282, body _matvec_kernel :167). For
// x (M, P) it computes
//
//   wz[m] = sum_{k: cam(k)=m} What_k ( sum_{k' in track(k)} What_k'^T x[cam(k')] )
//
// with What = W chol(V^-1) folded once per LM step by the caller, laid out
// twice: track-major w_pt (N, Tp, P, 3) with camera ids cam_ind_pt (N, Tp),
// and camera-major w_cm (M, Tc, P, 3) with track ids pts_ind_cam (M, Tc).
// Empty slots hold the sentinel id M (resp. N) and are skipped.
// P, the parameters a camera, is 1..11 (one template instance each: rpc R
// 3, R T 6; affine R T K 8; perspective R T K 11); any other P is refused.
//
// Numerical contract (the CG at 1000-camera conditioning needs it):
//   * exact f32 products, no fused multiply-adds (__fmul_rn/__fadd_rn);
//   * each track's sum in f32, in slot order;
//   * each camera's sum in f64 in a fixed tree whose shape depends on
//     (M, Tc) only (ops/schur_matvec.plan): G chunks of L slots per
//     camera; in a chunk, thread t of 128 sums slots t, t+128, ...; then a
//     warp xor-butterfly, the 4 warps in order, the G chunks in order. It
//     does not depend on the SM count, the grid or occupancy, so two calls
//     or two cards give the same bits. No atomics.
//
// Two kernels, chained on the caller's stream:
//   1. schur_points: one CTA per slab of T contiguous tracks; the slab's
//      w_pt and cam_ind_pt rows are one contiguous range, copied into
//      shared memory by 1-D bulk async copies (cp.async.bulk + mbarrier;
//      the ragged words around the 16-byte aligned body by plain loads);
//      one thread per track sums from shared memory, x through L1, into
//      what (16-byte rows).
//   2. schur_cameras: one CTA per (camera, chunk), M*G CTAs, launched as a
//      programmatic dependent launch: the chunk's w_cm rows and track ids
//      are copied the same way before the kernel waits for schur_points;
//      each thread requests its what rows (L2) as soon as the ids land,
//      while the rows are still in flight, then sums in f64. With G > 1
//      the G CTAs of a camera form one thread-block cluster, and rank 0
//      sums the chunk partials in rank order through distributed shared
//      memory; with G = 1 the CTA writes wz itself.
//
// What bounds it on an H100 (bytes: both What layouts, 2 * 36 B per
// observation at P = 3, the index tables and x; 18 f32 + 18 f64 flops per
// observation):
//   * 1000 cameras, 800k observations: HBM, ~64 MB per call, >= 19 us at
//     3.35 TB/s. Bulk copies of whole slabs keep every load a full line;
//     pieces of at most 20 KB keep every camera CTA resident beside the
//     point CTAs, so the w_cm copies run during the point phase and the
//     what gathers during the w_cm copies.
//   * 50 cameras of 1700 slots (6.4 MB, resident in the 50 MB L2 across CG
//     iterations): latency and parallelism. 8 chunks a camera give 400
//     camera CTAs instead of 50 blocks on 132 SMs; the tree is shuffles and
//     one shared-memory stage; the dependent launch hides the launch gap.
//   * 10 cameras of 10 929 slots (8.7 MB, in L2): the same, and one block
//     per camera would serialise 10 929 slots on 10 SMs; 16 chunks give 160
//     CTAs of 684 slots, combined by a cluster of 16.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxP = 11;  // perspective R, T, K: 3 + 3 + 5
constexpr int kCamThreads = 128;  // the tree's CTA shape: ops/schur_matvec.CAM_THREADS
constexpr int kCamWarps = kCamThreads / 32;
constexpr int kPointThreadsMax = 128;
constexpr int kGather = 4;  // what rows a camera-phase thread has in flight
constexpr int kPointPieceBytes = 32 * 1024;
constexpr int kCamPieceBytes = 20 * 1024;

// ---- bulk async copies into shared memory -------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Programmatic dependent launch: let the next kernel of the stream start,
// and wait until the previous one has finished and its writes are visible.
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// Words [src, src + n) of a 4-byte array, staged so that src[i] lands at
// dst[off + i] with off = (src / 4) % 4: then the 16-byte aligned body of
// the range lands 16-byte aligned in shared memory (dst is). `dst` holds
// n + 8 words.
struct Stage {
  const char* body;   // aligned body in global memory (nullptr: none)
  uint32_t bytes;     // its size, a multiple of 16
  int off;            // dst offset of word 0
  long head;          // words [0, head) and [tail, n) are loaded plainly
  long tail;
};

__device__ __forceinline__ Stage stage_plan(const void* src, long n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t e = a + 4 * static_cast<uintptr_t>(n);
  const uintptr_t lo = (a + 15) & ~static_cast<uintptr_t>(15);
  const uintptr_t hi = e & ~static_cast<uintptr_t>(15);
  Stage s;
  s.off = static_cast<int>((a & 15) >> 2);
  if (hi > lo) {
    s.body = reinterpret_cast<const char*>(lo);
    s.bytes = static_cast<uint32_t>(hi - lo);
    s.head = static_cast<long>((lo - a) >> 2);
    s.tail = static_cast<long>((hi - a) >> 2);
  } else {
    s.body = nullptr;
    s.bytes = 0;
    s.head = n;
    s.tail = n;
  }
  return s;
}

// A slot range's rows (range 0) and ids (range 1): word i of range r
// lands at dst[r][off[r] + i].
struct Piece {
  const unsigned* src[2];
  unsigned* dst[2];
  long n[2];
  int off[2];
};

// Start staging a piece: thread 0 starts the bulk copies of the aligned
// bodies, range r counted by bars[r]; every thread loads its share of the
// ragged words. A thread reads range r after waiting on bars[r] and a
// __syncthreads (for the ragged words).
__device__ __forceinline__ void stage_start(Piece& pc, uint64_t* bars) {
  const int tid = threadIdx.x, nt = blockDim.x;
  Stage st[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st[r] = stage_plan(pc.src[r], pc.n[r]);
    pc.off[r] = st[r].off;
  }
  if (tid == 0) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mbar_arrive_expect_tx(bars + r, st[r].bytes);
      if (st[r].bytes) {
        bulk_copy(pc.dst[r] + st[r].off + st[r].head, st[r].body, st[r].bytes, bars + r);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long rag = st[r].head + (pc.n[r] - st[r].tail);
    for (long i = tid; i < rag; i += nt) {
      const long w = i < st[r].head ? i : st[r].tail + (i - st[r].head);
      pc.dst[r][st[r].off + w] = pc.src[r][w];
    }
  }
}

__host__ __device__ constexpr size_t round16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

// Shared memory of a piece: `piece` slot rows (P*3 f32) and their ids, each
// with 8 words of room for the staging offset.
__host__ __device__ constexpr size_t rows_bytes(int piece, int P) {
  return round16((static_cast<size_t>(piece) * P * 3 + 8) * 4);
}
__host__ __device__ constexpr size_t ids_bytes(int piece) {
  return round16((static_cast<size_t>(piece) + 8) * 4);
}

// ---- 1. the point phase --------------------------------------------------

template <int P>
__global__ void __launch_bounds__(kPointThreadsMax)
    schur_points(const float* __restrict__ x, const float* __restrict__ w_pt,
                 const int* __restrict__ cam_ind_pt, float4* __restrict__ what, int M, int N,
                 int Tp, int T, int piece) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // w rows, ids
  unsigned* sw = reinterpret_cast<unsigned*>(smem + 16);
  unsigned* si = reinterpret_cast<unsigned*>(smem + 16 + rows_bytes(piece, P));
  if (threadIdx.x < 2) mbar_init(bars + threadIdx.x);
  __syncthreads();
  pdl_launch_dependents();

  uint32_t phase = 0;
  const long n0 = static_cast<long>(blockIdx.x) * T;
  const long n1 = n0 + T < N ? n0 + T : N;
  const long my = n0 + threadIdx.x;
  const long my_b = my * Tp, my_e = my_b + Tp;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (long s0 = n0 * Tp; s0 < n1 * Tp; s0 += piece) {
    const long s1 = s0 + piece < n1 * Tp ? s0 + piece : n1 * Tp;
    __syncthreads();  // the previous piece is consumed
    Piece pc = {{reinterpret_cast<const unsigned*>(w_pt + s0 * (P * 3)),
                 reinterpret_cast<const unsigned*>(cam_ind_pt + s0)},
                {sw, si},
                {(s1 - s0) * (P * 3), s1 - s0},
                {0, 0}};
    stage_start(pc, bars);
    mbar_wait(bars, phase);
    mbar_wait(bars + 1, phase);
    phase ^= 1u;
    __syncthreads();
    const float* wv = reinterpret_cast<const float*>(sw + pc.off[0]);
    const int* iv = reinterpret_cast<const int*>(si + pc.off[1]);
    if (my < n1) {
      const long a = my_b > s0 ? my_b : s0;
      const long b = my_e < s1 ? my_e : s1;
      for (long s = a; s < b; ++s) {
        const int c = iv[s - s0];
        if (c < 0 || c >= M) continue;
        const float* wt = wv + (s - s0) * (P * 3);
        // x (M*P f32) stays in L1 for every CTA of the SM
        const float* xc = x + static_cast<long>(c) * P;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float xv = __ldg(xc + p);
          a0 = __fadd_rn(a0, __fmul_rn(wt[p * 3 + 0], xv));
          a1 = __fadd_rn(a1, __fmul_rn(wt[p * 3 + 1], xv));
          a2 = __fadd_rn(a2, __fmul_rn(wt[p * 3 + 2], xv));
        }
      }
    }
  }
  if (my < n1) what[my] = make_float4(a0, a1, a2, 0.f);
}

// ---- 2. the camera phase -------------------------------------------------

template <int P>
__global__ void __launch_bounds__(kCamThreads)
    schur_cameras(const float* __restrict__ w_cm, const int* __restrict__ pts_ind_cam,
                  const float4* __restrict__ what, float* __restrict__ wz,
                  int N, int Tc, int G, int L, int piece) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double red[kCamWarps][P];
  __shared__ double cta_part[P];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // w rows, ids
  unsigned* sw = reinterpret_cast<unsigned*>(smem + 16);
  unsigned* si = reinterpret_cast<unsigned*>(smem + 16 + rows_bytes(piece, P));
  const int tid = threadIdx.x;
  const int m = blockIdx.x / G;
  const int r = blockIdx.x % G;
  if (tid < 2) mbar_init(bars + tid);
  __syncthreads();
  pdl_launch_dependents();

  const long base = static_cast<long>(m) * Tc;
  const long lo = static_cast<long>(r) * L < Tc ? static_cast<long>(r) * L : Tc;
  const long hi = lo + L < Tc ? lo + L : Tc;
  double acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.0;

  uint32_t phase = 0;
  bool waited = false;
  for (long s0 = lo; s0 < hi; s0 += piece) {
    const long s1 = s0 + piece < hi ? s0 + piece : hi;
    __syncthreads();  // the previous piece is consumed
    // w_cm and pts_ind_cam are constant during the CG: stage them before
    // waiting for what
    Piece pc = {{reinterpret_cast<const unsigned*>(w_cm + (base + s0) * (P * 3)),
                 reinterpret_cast<const unsigned*>(pts_ind_cam + base + s0)},
                {sw, si},
                {(s1 - s0) * (P * 3), s1 - s0},
                {0, 0}};
    stage_start(pc, bars);
    if (!waited) {
      pdl_wait();
      waited = true;
    }
    mbar_wait(bars + 1, phase);
    __syncthreads();  // the ids, and the ragged words of both ranges
    const float* wv = reinterpret_cast<const float*>(sw + pc.off[0]);
    const int* iv = reinterpret_cast<const int*>(si + pc.off[1]);
    // kGather slots a step, their what rows requested before any is used
    // (the first step's while the w rows are still in flight); the sums
    // stay in slot order t, t+128, ...
    bool w_ready = false;
    for (long s = s0 + tid; s < s1; s += kGather * kCamThreads) {
      float4 h[kGather];
      bool ok[kGather];
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const long su = s + u * kCamThreads;
        const int n = su < s1 ? iv[su - s0] : -1;
        ok[u] = n >= 0 && n < N;
        // L2 only: what was written by the previous kernel
        h[u] = ok[u] ? __ldcg(what + n) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (!w_ready) {
        mbar_wait(bars, phase);
        w_ready = true;
      }
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        if (!ok[u]) continue;
        const float* wt = wv + (s + u * kCamThreads - s0) * (P * 3);
        const double h0 = h[u].x, h1 = h[u].y, h2 = h[u].z;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const double t = __dadd_rn(__dadd_rn(__dmul_rn(wt[p * 3 + 0], h0),
                                               __dmul_rn(wt[p * 3 + 1], h1)),
                                     __dmul_rn(wt[p * 3 + 2], h2));
          acc[p] = __dadd_rn(acc[p], t);
        }
      }
    }
    if (!w_ready) mbar_wait(bars, phase);  // every thread waits every phase
    phase ^= 1u;
  }
  if (!waited) pdl_wait();

  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    double v = acc[p];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, d));
    if (lane == 0) red[warp][p] = v;
  }
  __syncthreads();
  if (tid < P) {
    double s = red[0][tid];
#pragma unroll
    for (int w = 1; w < kCamWarps; ++w) s = __dadd_rn(s, red[w][tid]);
    cta_part[tid] = s;
  }

  if (G > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (r == 0 && tid < P) {
      double s = cta_part[tid];
      for (int q = 1; q < G; ++q) s = __dadd_rn(s, cluster.map_shared_rank(cta_part, q)[tid]);
      wz[static_cast<long>(m) * P + tid] = __double2float_rn(s);
    }
    cluster.sync();  // the partials stay until rank 0 has read them
  } else if (tid < P) {
    wz[static_cast<long>(m) * P + tid] = __double2float_rn(cta_part[tid]);
  }
}

}  // namespace

// The argument block the Python binding fills once per bind
// (ops/schur_matvec.SchurOperator): the operands, the what scratch, the
// shapes and the shape-only geometry (T tracks per point slab, G chunks of
// L slots per camera: the f64 tree). schur_wz_prepare sets the pieces and
// the shared memory sizes.
struct SchurArgs {
  const float* w_pt;
  const int* cam_ind_pt;
  const float* w_cm;
  const int* pts_ind_cam;
  float* what;  // (N, 4) f32 scratch: a track's sum and a pad word
  int M, N, P, Tp, Tc;
  int T, G, L;
  int point_piece, point_smem, cam_piece, cam_smem;
};

namespace {

template <int P>
struct Kernels {
  static constexpr auto points = schur_points<P>;
  static constexpr auto cameras = schur_cameras<P>;
};

template <int P>
int prepare_p(SchurArgs* a) {
  const size_t rec = static_cast<size_t>(P) * 12 + 4;  // bytes per slot
  long slab = static_cast<long>(a->T) * a->Tp;
  long pp = static_cast<long>(kPointPieceBytes / rec);
  a->point_piece = static_cast<int>(slab < pp ? (slab > 0 ? slab : 1) : pp);
  a->point_smem = static_cast<int>(16 + rows_bytes(a->point_piece, P) + ids_bytes(a->point_piece));
  cudaError_t e = cudaFuncSetAttribute(Kernels<P>::points,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, a->point_smem);
  if (e != cudaSuccess) return static_cast<int>(e);

  // camera pieces: a multiple of the CTA's 128 threads, so that a thread's
  // slots (t, t+128, ... of the chunk) do not depend on the piece
  // and at most kGather slots a thread, so that its what rows are all
  // requested before the piece's w rows are needed
  long cp = static_cast<long>(kCamPieceBytes / rec) / kCamThreads * kCamThreads;
  if (cp > kGather * kCamThreads) cp = kGather * kCamThreads;
  long want = (static_cast<long>(a->L) + kCamThreads - 1) / kCamThreads * kCamThreads;
  if (want < kCamThreads) want = kCamThreads;
  a->cam_piece = static_cast<int>(want < cp ? want : cp);
  a->cam_smem = static_cast<int>(16 + rows_bytes(a->cam_piece, P) + ids_bytes(a->cam_piece));
  e = cudaFuncSetAttribute(Kernels<P>::cameras, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           a->cam_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (a->G > 8) {
    e = cudaFuncSetAttribute(Kernels<P>::cameras, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

template <int P>
int run_p(const SchurArgs* a, const float* x, float* wz, cudaStream_t s) {
  if (a->N > 0) {
    const unsigned slabs = static_cast<unsigned>((static_cast<long>(a->N) + a->T - 1) / a->T);
    schur_points<P><<<slabs, a->T, a->point_smem, s>>>(
        x, a->w_pt, a->cam_ind_pt, reinterpret_cast<float4*>(a->what), a->M, a->N, a->Tp, a->T,
        a->point_piece);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (a->M == 0) return 0;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = a->G;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a->M) * a->G);
  cfg.blockDim = dim3(kCamThreads);
  cfg.dynamicSmemBytes = a->cam_smem;
  cfg.stream = s;
  cfg.attrs = attrs;
  cfg.numAttrs = a->G > 1 ? 2 : 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, schur_cameras<P>, a->w_cm, a->pts_ind_cam,
                                     reinterpret_cast<const float4*>(a->what), wz, a->N, a->Tc,
                                     a->G, a->L, a->cam_piece);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Checks the argument block, sets the kernels' shared memory (and cluster)
// attributes and fills in the pieces and shared memory sizes. Returns a
// CUDA error code (0 = success).
extern "C" int schur_wz_prepare(SchurArgs* a) {
  if (a->P < 1 || a->P > kMaxP || a->M < 0 || a->N < 0 || a->Tp < 0 || a->Tc < 0 ||
      a->T < 32 || a->T > kPointThreadsMax || a->T % 32 != 0 || a->G < 1 || a->G > 16 ||
      a->L < 0 || static_cast<long>(a->G) * a->L < a->Tc) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (a->P) {
    case 1: return prepare_p<1>(a);
    case 2: return prepare_p<2>(a);
    case 3: return prepare_p<3>(a);
    case 4: return prepare_p<4>(a);
    case 5: return prepare_p<5>(a);
    case 6: return prepare_p<6>(a);
    case 7: return prepare_p<7>(a);
    case 8: return prepare_p<8>(a);
    case 9: return prepare_p<9>(a);
    case 10: return prepare_p<10>(a);
    case 11: return prepare_p<11>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One operator application on `stream`: two launches, no allocation, no
// synchronisation. Returns the first CUDA error of the launches (0 =
// success).
extern "C" int schur_wz_run(const SchurArgs* a, const float* x, float* wz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->P) {
    case 1: return run_p<1>(a, x, wz, s);
    case 2: return run_p<2>(a, x, wz, s);
    case 3: return run_p<3>(a, x, wz, s);
    case 4: return run_p<4>(a, x, wz, s);
    case 5: return run_p<5>(a, x, wz, s);
    case 6: return run_p<6>(a, x, wz, s);
    case 7: return run_p<7>(a, x, wz, s);
    case 8: return run_p<8>(a, x, wz, s);
    case 9: return run_p<9>(a, x, wz, s);
    case 10: return run_p<10>(a, x, wz, s);
    case 11: return run_p<11>(a, x, wz, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One operator application captured into a CUDA graph on a stream of its
// own, which is then destroyed: nothing runs. out[0] = the graph's nodes,
// out[1] = its edges, out[2] = the programmatic ones (the dependent launch
// of schur_cameras kept as such in a graph). Returns the first CUDA error
// (0 = success).
extern "C" int schur_wz_graph_edges(const SchurArgs* a, const float* x, float* wz, int* out) {
  cudaStream_t s;
  cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraph_t g = nullptr;
  e = cudaStreamBeginCapture(s, cudaStreamCaptureModeThreadLocal);
  int err = e != cudaSuccess ? static_cast<int>(e) : schur_wz_run(a, x, wz, s);
  if (e == cudaSuccess) {
    const cudaError_t end = cudaStreamEndCapture(s, &g);
    if (err == 0 && end != cudaSuccess) err = static_cast<int>(end);
  }
  size_t nodes = 0, edges = 0;
  int programmatic = 0;
  if (err == 0 && g != nullptr) {
    e = cudaGraphGetNodes(g, nullptr, &nodes);
    cudaGraphNode_t from[8], to[8];
    cudaGraphEdgeData data[8];
    edges = 8;
#if CUDART_VERSION >= 13000
    if (e == cudaSuccess) e = cudaGraphGetEdges(g, from, to, data, &edges);
#else
    if (e == cudaSuccess) e = cudaGraphGetEdges_v2(g, from, to, data, &edges);
#endif
    if (e != cudaSuccess) err = static_cast<int>(e);
    for (size_t i = 0; i < edges && i < 8; ++i)
      programmatic += data[i].type == cudaGraphDependencyTypeProgrammatic;
  }
  if (g != nullptr) cudaGraphDestroy(g);
  cudaStreamDestroy(s);
  out[0] = static_cast<int>(nodes);
  out[1] = static_cast<int>(edges);
  out[2] = programmatic;
  return err;
}
