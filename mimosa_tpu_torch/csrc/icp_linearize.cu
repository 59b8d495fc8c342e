// Point-to-plane ICP linearization for Hopper (sm_90a): one launch of one
// thread-block cluster that returns the whole result.
//
// Replaces mimosa_tpu/ops/icp_pallas.py::linearize_pallas: the Pallas
// kernel (_kernel :50-126, pl.pallas_call at :169) together with the XLA
// tail of that wrapper (:188-232: unpacking, eigh3 of the two 3x3 blocks,
// the localizability projection counts, the degeneracy flags). It computes
// what lidar/geometric.py::linearize_with computes (the plain PyTorch
// version): rotation degeneracy against loc_count_thresh_rot, and the
// 4-DoF projection H <- P H P^T, b <- P b when g_dir is given.
//
// Per point p with its matched plane (n, m) at the pose (R, t): the world
// point Rp + t, the residual r = n.(Rp + t - m), the gates |r| <= max_dist
// and 1 - 0.9|r|/sqrt(|p|) >= s_gate_min, the Huber weight, and the
// Jacobian row J = [p x R^T n, R^T n].
//
// What bounds it: at N = 8192 it must read 311,296 B (points, normals and
// means as [N,3] f32, two byte masks), 0.093 us at 3.35 TB/s, and it does
// ~210 flop a point, 0.026 us at 67 TFLOP/s in f32. Both are far below one
// launch, so the design minimises launches, host work and serial steps:
//
// - One cluster of kCluster CTAs, one launch. CTA k takes a contiguous
//   chunk of the points (a multiple of 16, for the bulk copy's alignment).
//   Where the chunk fits in shared memory (N <= ~43000) one thread stages
//   it with cp.async.bulk on an mbarrier; pass 1 reads it there and leaves
//   each point's Jacobian row and inlier flag in its place for pass 2.
//   Past that both passes read device memory (L2) in a strided loop.
// - Pass 1: per-thread register sums (40 f32: the 21 + 6 entries of H and
//   b, the 6 + 6 of the unweighted rotation and translation blocks, sum
//   |r|; 4 int32 status counts), a reduce-scatter shuffle butterfly in each
//   warp (~45 shuffles for the 40 sums, not 200) and the warps in a fixed
//   order into the CTA's shared memory.
// - cluster.sync; every CTA sums the CTAs' sums in rank order through
//   distributed shared memory (cluster.map_shared_rank), so all hold the
//   same bits, and runs the eigen-analysis of both blocks itself (a
//   transcription of core/eigh3.py, branch for branch, in f64): no second
//   round trip to hand the eigenvectors out. CTA 0 also writes H and b
//   (with the 4-DoF projection, one thread an entry), the counts and
//   mean |r|. No partials go through device memory and there are no float
//   atomics: a replay repeats bit for bit.
// - Pass 2 counts |j_rot . V_r[:,k]| >= cutoff and |R^T n . V_t[:,k]| >=
//   cutoff over the CTA's inliers; each CTA stores its int32 counts into
//   CTA 0's shared memory, cluster.sync, and CTA 0 sums them in rank order
//   and writes the counts and the flags. Two cluster syncs in all.
//
// No tensor cores: the work is ~1.2 MFLOP at N = 8192, and TF32 would
// break the precision the window's Schur marginalization needs (the
// package pins f32 products, mimosa_tpu_torch/__init__.py).
//
// Outputs go to three small buffers the caller allocates (f32, int32,
// uint8) in the layout of kLayout, which icp_layout() reports. An optional
// trace records the SM clock at each phase boundary. Plain C interface
// (bound with ctypes): the launch is on the given stream, allocates
// nothing, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kFSums = 40;        // f32 sums of pass 1: 32 + 8 (butterflies)
constexpr int kNStatus = 4;       // int32 status counts of pass 1
constexpr int kCounts = 6;        // int32 projection counts of pass 2
constexpr int kChunkAlign = 16;   // points; 16 B alignment of every chunk
constexpr int kStageBytesPerPoint = 3 * 12 + 2;
constexpr int kMaxStageBytes = 200 * 1024;

// Output layout: sizes of the three buffers, then each ICPResult field's
// offset in its buffer (field order of lidar/geometric.py::ICPResult),
// then the unweighted blocks [2,3,3] beside them in the f32 buffer.
enum : int {
  kOutF = 85, kOutI = 10, kOutU = 6,
  kH = 0, kB = 36, kMeanAbs = 42, kLamR = 43, kLamT = 46, kVR = 49,
  kVT = 58, kBlocks = 67,
  kStatus = 0, kCntR = 4, kCntT = 7,
  kDegR = 0, kDegT = 3,
};
constexpr int kLayout[] = {
    kOutF, kOutI, kOutU,
    kH, kB, kStatus /* num_inlier */, kStatus, kMeanAbs, kCntR, kCntT,
    kLamR, kLamT, kVR, kVT, kDegR, kDegT,
    kBlocks};

// Phase boundaries that the optional trace records (clock64 of CTA 0's
// thread 0): entry, points staged, pass 1 done, CTA sums, cluster sync 1,
// cluster sums, eigen-analysis and outputs, pass 2 and its CTA sums,
// cluster sync 2, flags written.
constexpr int kTracePoints = 10;

struct Params {
  const float* pts;
  const float* nrm;
  const float* mean;
  const uint8_t* valid;
  const uint8_t* found;
  const float* q;       // [4] w x y z
  const float* t;       // [3]
  const float* g_dir;   // [3], or null: no 4-DoF projection
  int n;
  int chunk;            // points per CTA, a multiple of kChunkAlign
  int staged;           // chunk staged in shared memory
  float sigma2, huber_delta, s_gate_min, max_dist;
  float cutoff, thresh_rot, thresh_trans;
  float* out_f;
  int* out_i;
  uint8_t* out_u;
  long long* trace;     // [kTracePoints], or null
};

// A CTA's points: in its shared memory when staged, else in device memory.
struct Src {
  const float* pts;
  const float* nrm;
  const float* mean;
  const uint8_t* valid;
  const uint8_t* found;
};

struct Point {
  float J[6];
  float r;
  float ar;
  bool inlier;
  bool valid;
  bool found;
  bool in_dist;
  bool in_s;
};

// core/lie.py::quat_to_mat, row-major
__device__ __forceinline__ void quat_to_mat(const float* q, float* R) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  R[0] = 1.0f - 2.0f * (yy + zz);
  R[1] = 2.0f * (xy - wz);
  R[2] = 2.0f * (xz + wy);
  R[3] = 2.0f * (xy + wz);
  R[4] = 1.0f - 2.0f * (xx + zz);
  R[5] = 2.0f * (yz - wx);
  R[6] = 2.0f * (xz - wy);
  R[7] = 2.0f * (yz + wx);
  R[8] = 1.0f - 2.0f * (xx + yy);
}

__device__ __forceinline__ Point point_terms(int i, const Src& s,
                                             const float* R, const float* t,
                                             const Params& g) {
  Point o;
  const float px = s.pts[3 * i], py = s.pts[3 * i + 1], pz = s.pts[3 * i + 2];
  const float nx = s.nrm[3 * i], ny = s.nrm[3 * i + 1], nz = s.nrm[3 * i + 2];
  const float mx = s.mean[3 * i], my = s.mean[3 * i + 1],
              mz = s.mean[3 * i + 2];
  o.valid = s.valid[i] != 0;
  o.found = s.found[i] != 0;

  const float wx = R[0] * px + R[1] * py + R[2] * pz + t[0];
  const float wy = R[3] * px + R[4] * py + R[5] * pz + t[1];
  const float wz = R[6] * px + R[7] * py + R[8] * pz + t[2];
  o.r = nx * (wx - mx) + ny * (wy - my) + nz * (wz - mz);
  o.ar = fabsf(o.r);
  o.in_dist = o.ar <= g.max_dist;
  const float pn = sqrtf(sqrtf(px * px + py * py + pz * pz) + 1e-12f);
  o.in_s = (1.0f - 0.9f * o.ar / pn) >= g.s_gate_min;
  o.inlier = o.valid && o.found && o.in_dist && o.in_s;

  // nR = R^T n ; j_rot = p x nR ; j_trans = nR
  const float nrx = R[0] * nx + R[3] * ny + R[6] * nz;
  const float nry = R[1] * nx + R[4] * ny + R[7] * nz;
  const float nrz = R[2] * nx + R[5] * ny + R[8] * nz;
  o.J[0] = py * nrz - pz * nry;
  o.J[1] = pz * nrx - px * nrz;
  o.J[2] = px * nry - py * nrx;
  o.J[3] = nrx;
  o.J[4] = nry;
  o.J[5] = nrz;
  return o;
}

// ---- block reductions in a fixed order -------------------------------------

// One reduce-scatter step over lanes l and l ^ o: of v[0..N) each lane
// keeps a half (the upper one where bit o of its lane is set) with the
// partner's same half added, in v[0..N/2).
template <int N, typename T, int K>
__device__ __forceinline__ void halve(T (&v)[K], int lane, int o) {
  const bool up = (lane & o) != 0;
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const T send = up ? v[j] : v[j + N / 2];
    const T keep = up ? v[j + N / 2] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

// The warp's total of v[lane / (32 / K)] in each lane (K a power of two,
// at most 32): halving steps while several values remain, then a plain
// xor tree. K - 1 + log2(32 / K) shuffles in all, not 5 K.
template <typename T, int K>
__device__ __forceinline__ T warp_reduce_scatter(T (&v)[K], int lane) {
  static_assert(K >= 1 && K <= 32 && (K & (K - 1)) == 0, "K: 1, 2, ..., 32");
  if constexpr (K >= 2) halve<K>(v, lane, 16);
  if constexpr (K >= 4) halve<K / 2>(v, lane, 8);
  if constexpr (K >= 8) halve<K / 4>(v, lane, 4);
  if constexpr (K >= 16) halve<K / 8>(v, lane, 2);
  if constexpr (K >= 32) halve<K / 16>(v, lane, 1);
  T s = v[0];
#pragma unroll
  for (int o = 16 / K; o > 0; o >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// The warp's totals of v[0..K) into row[0..K) (shared memory) by the
// butterfly; v is spent.
template <typename T, int K>
__device__ __forceinline__ void warp_totals(T (&v)[K], int lane, T* row) {
  const T s = warp_reduce_scatter(v, lane);
  constexpr int group = 32 / K;
  if (lane % group == 0) row[lane / group] = s;
}

// Column k of warp_buf [kWarps][W] summed over the warps in order: after a
// barrier, the CTA's total.
template <typename T, int W>
__device__ __forceinline__ T warps_sum(const T (*warp_buf)[W], int k) {
  T s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += warp_buf[w][k];
  return s;
}

// ---- core/eigh3.py, branch for branch, in f64 -----------------------------
//
// The trigonometric closed form loses half its digits where two eigenvalues
// meet (a rank-deficient block: a single plane, a corridor): r sits within
// a few ulps of +-1 and acos turns that into an error of ~sqrt(eps)|lambda|,
// 1e-4 |lambda| in f32. The f32 block sums are eigen-analysed in f64; the
// branches and thresholds are eigh3's.

__device__ __forceinline__ void cross3(const double* a, const double* b,
                                       double* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ double dot3(const double* a, const double* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// eigvalsh3: trigonometric eigenvalues, ascending
__device__ __forceinline__ void eigvalsh3(const double* A, double* lam) {
  const double q = (A[0] + A[4] + A[8]) * (1.0 / 3.0);
  const double b0 = A[0] - q, b4 = A[4] - q, b8 = A[8] - q;
  const double p2 = (b0 * b0 + b4 * b4 + b8 * b8
                     + 2.0 * (A[1] * A[1] + A[2] * A[2] + A[5] * A[5]))
                    * (1.0 / 6.0);
  // isotropic case: p ~ 0 -> all eigenvalues = q
  if (p2 < 1e-28) {
    lam[0] = lam[1] = lam[2] = q;
    return;
  }
  const double p = sqrt(fmax(p2, 1e-30));
  const double det = b0 * (b4 * b8 - A[5] * A[7])
                   - A[1] * (A[3] * b8 - A[5] * A[6])
                   + A[2] * (A[3] * A[7] - b4 * A[6]);
  const double r = fmin(fmax(det / fmax(2.0 * p * p * p, 1e-30), -1.0), 1.0);
  double sin_phi, cos_phi;
  sincos(acos(r) * (1.0 / 3.0), &sin_phi, &cos_phi);
  const double e1 = q + 2.0 * p * cos_phi;
  // cos(phi + 2 pi / 3)
  const double e3 = q + 2.0 * p * (-0.5 * cos_phi
                                   - 0.86602540378443865 * sin_phi);
  lam[0] = e3;
  lam[1] = 3.0 * q - e1 - e3;
  lam[2] = e1;
}

// _eigvec_for: the largest cross product of two rows of (A - lam I);
// ``fallback`` where all vanish
__device__ __forceinline__ void eigvec_for(const double* A, double lam,
                                           const double* fallback,
                                           double* v) {
  const double r0[3] = {A[0] - lam, A[1], A[2]};
  const double r1[3] = {A[3], A[4] - lam, A[5]};
  const double r2[3] = {A[6], A[7], A[8] - lam};
  double c01[3], c02[3], c12[3];
  cross3(r0, r1, c01);
  cross3(r0, r2, c02);
  cross3(r1, r2, c12);
  const double n01 = dot3(c01, c01), n02 = dot3(c02, c02),
               n12 = dot3(c12, c12);
  const bool first = n01 >= n02 && n01 >= n12;
  const bool second = n02 >= n12;
  const double nbest = fmax(fmax(n01, n02), n12);
  const double inv = rsqrt(fmax(nbest, 1e-30));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double best = first ? c01[k] : (second ? c02[k] : c12[k]);
    v[k] = nbest > 1e-24 ? best * inv : fallback[k];
  }
}

// eigh3 of the symmetric A (row-major) by two lanes of a warp: lane pair
// (2j, 2j + 1) analyses A_j; both compute the eigenvalues, lane 2j the
// eigenvector of the smallest and lane 2j + 1 of the largest. Every lane
// of the warp calls it. Lane 2j returns true with lam ascending and V
// row-major (V[:, k] the k-th eigenvector).
__device__ bool eigh3_pair(const float* Af, int lane, float* lam_out,
                           float* V) {
  double A[9], lam[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) A[k] = Af[k];
  eigvalsh3(A, lam);
  const bool largest = lane & 1;
  const double fallback[3] = {largest ? 0.0 : 1.0, 0.0, largest ? 1.0 : 0.0};
  double v[3], v2[3];
  eigvec_for(A, largest ? lam[2] : lam[0], fallback, v);
#pragma unroll
  for (int k = 0; k < 3; ++k) v2[k] = __shfl_xor_sync(0xffffffffu, v[k], 1);
  if (largest) return false;
  const double* v0 = v;
  // make v2 orthogonal to v0, then complete the right-handed frame
  const double d = dot3(v2, v0);
#pragma unroll
  for (int k = 0; k < 3; ++k) v2[k] -= d * v0[k];
  const double v2n = sqrt(dot3(v2, v2));
  if (v2n > 1e-12) {
    const double inv = 1.0 / fmax(v2n, 1e-30);
#pragma unroll
    for (int k = 0; k < 3; ++k) v2[k] *= inv;
  } else {
    // _any_orthogonal(v0): v0 x ([0,1,0] where |v0_x| > 0.9, else [1,0,0])
    const bool c = fabs(v0[0]) > 0.9;
    const double e[3] = {c ? 0.0 : 1.0, c ? 1.0 : 0.0, 0.0};
    double u[3];
    cross3(v0, e, u);
    const double inv = 1.0 / sqrt(dot3(u, u));
#pragma unroll
    for (int k = 0; k < 3; ++k) v2[k] = u[k] * inv;
  }
  double v1[3];
  cross3(v2, v0, v1);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    lam_out[i] = static_cast<float>(lam[i]);
    V[3 * i] = static_cast<float>(v0[i]);
    V[3 * i + 1] = static_cast<float>(v1[i]);
    V[3 * i + 2] = static_cast<float>(v2[i]);
  }
  return true;
}

// index of entry (i, j) of a symmetric [n,n] in its row-major upper
// triangle
__device__ __forceinline__ int tri(int i, int j, int n) {
  const int a = min(i, j), b = max(i, j);
  return a * n - a * (a - 1) / 2 + (b - a);
}

// ---- the bulk copy into shared memory --------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Waits for the barrier's phase ``parity`` to complete; traps (a launch
// error, not a hung card) if the copies have not landed in ~10 s.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    if (clock64() - t0 > 20000000000LL) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// A CTA's staged chunk: the inputs, and after pass 1 each point's J (j_rot
// over pts, j_trans over nrm) and inlier flag (over valid).
struct Stage {
  float* pts;
  float* nrm;
  float* mean;
  uint8_t* valid;
  uint8_t* found;
};

// Stage this CTA's cnt points at src into shared memory: the first
// multiple of 16 by five bulk copies on one mbarrier, the ragged rest
// (< 16 points, the last CTA's) by plain loads.
__device__ Stage stage_chunk(unsigned char* smem, int chunk, int cnt,
                             const Src& src, uint64_t* bar) {
  Stage s;
  s.pts = reinterpret_cast<float*>(smem);
  s.nrm = s.pts + 3 * chunk;
  s.mean = s.nrm + 3 * chunk;
  s.valid = reinterpret_cast<uint8_t*>(s.mean + 3 * chunk);
  s.found = s.valid + chunk;
  const int nb = cnt & ~(kChunkAlign - 1);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)),
                    "r"(static_cast<uint32_t>(nb * kStageBytesPerPoint))
                 : "memory");
    if (nb > 0) {
      bulk_load(s.pts, src.pts, nb * 12, bar);
      bulk_load(s.nrm, src.nrm, nb * 12, bar);
      bulk_load(s.mean, src.mean, nb * 12, bar);
      bulk_load(s.valid, src.valid, nb, bar);
      bulk_load(s.found, src.found, nb, bar);
    }
  }
  for (int i = nb + threadIdx.x; i < cnt; i += kThreads) {
    for (int k = 0; k < 3; ++k) {
      s.pts[3 * i + k] = src.pts[3 * i + k];
      s.nrm[3 * i + k] = src.nrm[3 * i + k];
      s.mean[3 * i + k] = src.mean[3 * i + k];
    }
    s.valid[i] = src.valid[i];
    s.found[i] = src.found[i];
  }
  __syncthreads();          // the barrier is initialised before any wait
  mbar_wait(bar, 0);
  __syncthreads();          // the ragged rest is visible
  return s;
}

// ---- the kernel -------------------------------------------------------------

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
icp_linearize_kernel(const Params g) {
  extern __shared__ __align__(128) unsigned char stage_mem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ float warp_f[kWarps][kFSums];
  __shared__ int warp_i[kWarps][8];
  __shared__ float blk_f[kFSums];        // this CTA's pass 1 sums
  __shared__ int blk_st[kNStatus];
  __shared__ float tot_f[kFSums];        // the cluster's pass 1 sums
  __shared__ int tot_st[kNStatus];
  __shared__ float vecs[18];             // V_r then V_t, row-major
  __shared__ int counts_of[kCluster][kCounts];   // CTA 0: every CTA's counts

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool tracer = g.trace != nullptr && rank == 0 && threadIdx.x == 0;
  int tp = 0;
  auto mark = [&]() {
    if (tracer) g.trace[tp] = clock64();
    ++tp;
  };
  mark();
  const int start = rank * g.chunk;
  const int cnt = max(0, min(g.n - start, g.chunk));

  float R[9], t[3];
  quat_to_mat(g.q, R);
  t[0] = g.t[0];
  t[1] = g.t[1];
  t[2] = g.t[2];

  Src src{g.pts + 3 * static_cast<size_t>(start),
          g.nrm + 3 * static_cast<size_t>(start),
          g.mean + 3 * static_cast<size_t>(start), g.valid + start,
          g.found + start};
  Stage st{};
  if (g.staged) {
    st = stage_chunk(stage_mem, g.chunk, cnt, src, &bar);
    src = Src{st.pts, st.nrm, st.mean, st.valid, st.found};
  }
  mark();

  // pass 1: the sums
  float acc[kFSums];
  int stat[kNStatus];
#pragma unroll
  for (int k = 0; k < kFSums; ++k) acc[k] = 0.0f;
#pragma unroll
  for (int k = 0; k < kNStatus; ++k) stat[k] = 0;
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    const Point o = point_terms(i, src, R, t, g);
    if (g.staged) {
      // J and the inlier flag replace the point, which nothing reads again
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        st.pts[3 * i + k] = o.J[k];
        st.nrm[3 * i + k] = o.J[3 + k];
      }
      st.valid[i] = o.inlier;
    }
    const float inl = o.inlier ? 1.0f : 0.0f;
    const float wh = o.ar <= g.huber_delta
                         ? 1.0f : g.huber_delta / fmaxf(o.ar, 1e-12f);
    const float w = o.inlier ? wh / g.sigma2 : 0.0f;
    int s = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int b = a; b < 6; ++b) acc[s++] += w * o.J[a] * o.J[b];
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[s++] += w * o.J[a] * o.r;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = a; b < 3; ++b) acc[s++] += inl * o.J[a] * o.J[b];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = a; b < 3; ++b) acc[s++] += inl * o.J[3 + a] * o.J[3 + b];
    acc[s++] += o.ar * inl;
    stat[0] += o.inlier;
    stat[1] += o.valid && !o.found;
    stat[2] += o.valid && o.found && !o.in_dist;
    stat[3] += o.valid && o.found && o.in_dist && !o.in_s;
  }
  mark();
  {
    float lo[32], hi[8];
#pragma unroll
    for (int k = 0; k < 32; ++k) lo[k] = acc[k];
#pragma unroll
    for (int k = 0; k < 8; ++k) hi[k] = acc[32 + k];
    warp_totals(lo, lane, warp_f[warp]);
    warp_totals(hi, lane, warp_f[warp] + 32);
    warp_totals(stat, lane, warp_i[warp]);
  }
  __syncthreads();
  if (threadIdx.x < kFSums)
    blk_f[threadIdx.x] = warps_sum(warp_f, threadIdx.x);
  else if (threadIdx.x < kFSums + kNStatus)
    blk_st[threadIdx.x - kFSums] = warps_sum(warp_i, threadIdx.x - kFSums);
  mark();
  cluster.sync();       // also the CTA's barrier for blk_f and blk_st
  mark();

  // every CTA: the cluster's sums in rank order (the same bits in all)
  if (threadIdx.x < kFSums) {
    float v = 0.0f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
      v += cluster.map_shared_rank(blk_f, r)[threadIdx.x];
    tot_f[threadIdx.x] = v;
  } else if (rank == 0 && threadIdx.x < kFSums + kNStatus) {
    const int k = threadIdx.x - kFSums;
    int v = 0;
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
      v += cluster.map_shared_rank(blk_st, r)[k];
    tot_st[k] = v;
  }
  __syncthreads();
  mark();

  if (threadIdx.x < 32) {
    // warp 0: eigen-analysis of the unweighted rotation (lanes 0, 1) and
    // translation (lanes 2, 3) blocks; the other lanes repeat lanes 0-3
    const int blk = (lane >> 1) & 1;
    float A[9], lam[3], V[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) A[3 * i + j] = tot_f[27 + 6 * blk + tri(i, j, 3)];
    if (eigh3_pair(A, lane, lam, V) && lane < 4) {
#pragma unroll
      for (int i = 0; i < 9; ++i) vecs[9 * blk + i] = V[i];
      if (rank == 0) {
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          g.out_f[(blk ? kVT : kVR) + i] = V[i];
          g.out_f[kBlocks + 9 * blk + i] = A[i];
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) g.out_f[(blk ? kLamT : kLamR) + i] = lam[i];
      }
    }
  } else if (rank == 0 && threadIdx.x < 32 + 36) {
    // H [6,6] entry (i, j) and, where j = 0, b[i]; with the 4-DoF
    // projection as four_dof_projection computes it: (P H) P^T and P b,
    // P = diag(a a^T, I), a = R^T g_dir normalized
    const int e = threadIdx.x - 32, i = e / 6, j = e % 6;
    float h, bi = tot_f[21 + i];
    if (g.g_dir != nullptr) {
      float a[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        a[k] = R[k] * g.g_dir[0] + R[3 + k] * g.g_dir[1]
             + R[6 + k] * g.g_dir[2];
      const float an =
          fmaxf(sqrtf(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]), 1e-9f);
#pragma unroll
      for (int k = 0; k < 3; ++k) a[k] /= an;
      auto P = [&](int r, int c) {
        return r < 3 ? (c < 3 ? a[r] * a[c] : 0.0f) : (r == c ? 1.0f : 0.0f);
      };
      h = 0.0f;
#pragma unroll
      for (int l = 0; l < 6; ++l) {
        float ph = 0.0f;       // (P H)[i, l]
#pragma unroll
        for (int k = 0; k < 6; ++k) ph += P(i, k) * tot_f[tri(k, l, 6)];
        h += ph * P(j, l);
      }
      float pb = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) pb += P(i, k) * tot_f[21 + k];
      bi = pb;
    } else {
      h = tot_f[tri(i, j, 6)];
    }
    g.out_f[kH + e] = h;
    if (j == 0) g.out_f[kB + i] = bi;
  } else if (rank == 0 && threadIdx.x == 32 + 64) {
    g.out_f[kMeanAbs] = tot_f[39] / fmaxf(static_cast<float>(tot_st[0]), 1.0f);
#pragma unroll
    for (int k = 0; k < kNStatus; ++k) g.out_i[kStatus + k] = tot_st[k];
  }
  __syncthreads();
  mark();

  // pass 2: the localizability counts
  float V[18];
#pragma unroll
  for (int k = 0; k < 18; ++k) V[k] = vecs[k];
  int c[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) c[k] = 0;
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    float J[6];
    bool inlier;
    if (g.staged) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        J[k] = st.pts[3 * i + k];
        J[3 + k] = st.nrm[3 * i + k];
      }
      inlier = st.valid[i] != 0;
    } else {
      const Point o = point_terms(i, src, R, t, g);
#pragma unroll
      for (int k = 0; k < 6; ++k) J[k] = o.J[k];
      inlier = o.inlier;
    }
    if (!inlier) continue;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float pr = J[0] * V[k] + J[1] * V[3 + k] + J[2] * V[6 + k];
      const float pt = J[3] * V[9 + k] + J[4] * V[12 + k] + J[5] * V[15 + k];
      c[k] += fabsf(pr) >= g.cutoff;
      c[3 + k] += fabsf(pt) >= g.cutoff;
    }
  }
  warp_totals(c, lane, warp_i[warp]);
  __syncthreads();
  if (threadIdx.x < kCounts)
    cluster.map_shared_rank(&counts_of[0][0], 0)[rank * kCounts + threadIdx.x] =
        warps_sum(warp_i, threadIdx.x);
  mark();
  cluster.sync();
  mark();

  if (rank == 0 && threadIdx.x < kCounts) {
    const int k = threadIdx.x;
    int v = 0;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) v += counts_of[r][k];
    g.out_i[(k < 3 ? kCntR : kCntT - 3) + k] = v;
    g.out_u[(k < 3 ? kDegR : kDegT - 3) + k] =
        static_cast<float>(v) < (k < 3 ? g.thresh_rot : g.thresh_trans);
  }
  if (rank == 0) __syncthreads();
  mark();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

int icp_trace_points() { return kTracePoints; }

// kLayout[k], or -1 past its end
int icp_layout(int k) {
  const int n = static_cast<int>(sizeof(kLayout) / sizeof(kLayout[0]));
  return (k >= 0 && k < n) ? kLayout[k] : -1;
}

// Once per device, when the library loads (not per launch, so a launch
// makes no call besides the kernel's and can be captured in a CUDA
// graph): dynamic plus static shared memory may pass the 48 KB default.
int icp_init() {
  return static_cast<int>(cudaFuncSetAttribute(
      icp_linearize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxStageBytes));
}

int icp_linearize(const float* pts, const float* nrm, const float* mean,
                  const uint8_t* valid, const uint8_t* found, const float* q,
                  const float* t, const float* g_dir, int n, float sigma2,
                  float huber_delta, float s_gate_min, float max_dist,
                  float cutoff, float thresh_rot, float thresh_trans,
                  float* out_f, int* out_i, uint8_t* out_u,
                  long long* trace, void* stream) {
  const int per_cta = (n + kCluster - 1) / kCluster;
  const int chunk =
      (per_cta + kChunkAlign - 1) / kChunkAlign * kChunkAlign;
  const size_t stage_bytes =
      static_cast<size_t>(chunk) * kStageBytesPerPoint;
  const bool staged = stage_bytes <= kMaxStageBytes && aligned16(pts)
                      && aligned16(nrm) && aligned16(mean)
                      && aligned16(valid) && aligned16(found);
  const size_t smem = staged ? stage_bytes : 0;
  const Params g{pts, nrm, mean, valid, found, q, t, g_dir, n, chunk,
                 staged ? 1 : 0, sigma2, huber_delta, s_gate_min, max_dist,
                 cutoff, thresh_rot, thresh_trans, out_f, out_i, out_u,
                 trace};
  icp_linearize_kernel<<<kCluster, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
