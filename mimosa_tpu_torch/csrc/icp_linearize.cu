// Fused point-to-plane ICP reduction for Hopper (sm_90a).
//
// Replaces mimosa_tpu/ops/icp_pallas.py::linearize_pallas (the Pallas TPU
// kernel, pl.pallas_call at icp_pallas.py:169). For each point p with its
// matched plane (n, m) at the pose (R, t): the world point Rp + t, the
// residual r = n.(Rp + t - m), the gates |r| <= max_p2p_dist and
// 1 - 0.9|r|/sqrt(|p|) >= s_gate_min, the Huber weight, and the Jacobian
// row J = [p x R^T n, R^T n]. It accumulates 45 f32 sums in one pass: the
// 21 upper-triangle entries of sum w J J^T / sigma^2, the 6 of
// sum w J r / sigma^2, 6 each of the unweighted rotation and translation
// blocks over inliers, 4 status counts, sum |r| over inliers and the
// inlier count.
//
// What bounds it: at N = 8192 points it reads about 330 KB (points,
// normals, means as [N,3] f32 and two byte masks) and does ~150 flops a
// point, so it is bound by launch latency and occupancy, not by bytes or
// arithmetic. The design is therefore one pass with enough blocks to fill
// the SMs and no tiling to tune: one thread per point in a grid-stride
// loop (the loop replaces the TPU's sequential grid axis; nothing carries
// between CUDA blocks), per-thread register sums, a warp-shuffle + shared
// memory block reduction into one row of partials[G, 45], and a second
// one-block launch that sums the rows in a fixed order. No float atomics:
// the same inputs give the same bits on every run.
//
// icp_loc_counts runs after the caller's eigendecomposition of the two
// 3x3 blocks: it recomputes each point's inlier gate (the same device
// function as the reduction) and counts |j_rot . V_r[:,k]| >= cutoff and
// |R^T n . V_t[:,k]| >= cutoff into int32[6] with integer atomics, which
// are order-free and so deterministic too.
//
// Plain C interface (bound with ctypes): every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSums = 45;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

struct Gates {
  float sigma2;
  float huber_delta;
  float s_gate_min;
  float max_dist;
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

// rt: R row-major [9] then t [3], read from device memory.
__device__ __forceinline__ Point point_terms(
    int i, const float* __restrict__ pts, const float* __restrict__ nrm,
    const float* __restrict__ mean, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ found, const float* rt, const Gates& g) {
  Point o;
  const float px = pts[3 * i], py = pts[3 * i + 1], pz = pts[3 * i + 2];
  const float nx = nrm[3 * i], ny = nrm[3 * i + 1], nz = nrm[3 * i + 2];
  const float mx = mean[3 * i], my = mean[3 * i + 1], mz = mean[3 * i + 2];
  o.valid = valid[i] != 0;
  o.found = found[i] != 0;

  const float wx = rt[0] * px + rt[1] * py + rt[2] * pz + rt[9];
  const float wy = rt[3] * px + rt[4] * py + rt[5] * pz + rt[10];
  const float wz = rt[6] * px + rt[7] * py + rt[8] * pz + rt[11];
  o.r = nx * (wx - mx) + ny * (wy - my) + nz * (wz - mz);
  o.ar = fabsf(o.r);
  o.in_dist = o.ar <= g.max_dist;
  const float pn = sqrtf(sqrtf(px * px + py * py + pz * pz) + 1e-12f);
  o.in_s = (1.0f - 0.9f * o.ar / pn) >= g.s_gate_min;
  o.inlier = o.valid && o.found && o.in_dist && o.in_s;

  // nR = R^T n ; j_rot = p x nR ; j_trans = nR
  const float nrx = rt[0] * nx + rt[3] * ny + rt[6] * nz;
  const float nry = rt[1] * nx + rt[4] * ny + rt[7] * nz;
  const float nrz = rt[2] * nx + rt[5] * ny + rt[8] * nz;
  o.J[0] = py * nrz - pz * nry;
  o.J[1] = pz * nrx - px * nrz;
  o.J[2] = px * nry - py * nrx;
  o.J[3] = nrx;
  o.J[4] = nry;
  o.J[5] = nrz;
  return o;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads) icp_partials_kernel(
    const float* __restrict__ pts, const float* __restrict__ nrm,
    const float* __restrict__ mean, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ found, const float* __restrict__ rt_dev,
    int n, Gates g, float* __restrict__ partials) {
  float rt[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) rt[k] = __ldg(rt_dev + k);

  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;

  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const Point o = point_terms(i, pts, nrm, mean, valid, found, rt, g);
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
    acc[s++] += inl;
    acc[s++] += (o.valid && !o.found) ? 1.0f : 0.0f;
    acc[s++] += (o.valid && o.found && !o.in_dist) ? 1.0f : 0.0f;
    acc[s++] += (o.valid && o.found && o.in_dist && !o.in_s) ? 1.0f : 0.0f;
    acc[s++] += o.ar * inl;
    acc[s++] += inl;
  }

  // block reduction: warp shuffles, then the warps in a fixed order
  __shared__ float warp_acc[kWarps][kSums];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    const float v = warp_sum(acc[k]);
    if (lane == 0) warp_acc[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float v = 0.0f;
    for (int w = 0; w < kWarps; ++w) v += warp_acc[w][threadIdx.x];
    partials[blockIdx.x * kSums + threadIdx.x] = v;
  }
}

__global__ void icp_finalize_kernel(const float* __restrict__ partials,
                                    int rows, float* __restrict__ out) {
  const int k = threadIdx.x;
  if (k >= kSums) return;
  float v = 0.0f;
  for (int r = 0; r < rows; ++r) v += partials[r * kSums + k];
  out[k] = v;
}

__global__ void __launch_bounds__(kThreads) icp_loc_counts_kernel(
    const float* __restrict__ pts, const float* __restrict__ nrm,
    const float* __restrict__ mean, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ found, const float* __restrict__ rt_dev,
    const float* __restrict__ vecs_dev, int n, Gates g, float cutoff,
    int* __restrict__ counts) {
  float rt[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) rt[k] = __ldg(rt_dev + k);
  // V_r then V_t, each [3,3] row-major with eigenvectors as columns
  float V[18];
#pragma unroll
  for (int k = 0; k < 18; ++k) V[k] = __ldg(vecs_dev + k);

  int c[6] = {0, 0, 0, 0, 0, 0};
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const Point o = point_terms(i, pts, nrm, mean, valid, found, rt, g);
    if (!o.inlier) continue;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float pr = o.J[0] * V[k] + o.J[1] * V[3 + k] + o.J[2] * V[6 + k];
      const float pt = o.J[3] * V[9 + k] + o.J[4] * V[12 + k]
                       + o.J[5] * V[15 + k];
      c[k] += fabsf(pr) >= cutoff ? 1 : 0;
      c[3 + k] += fabsf(pt) >= cutoff ? 1 : 0;
    }
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const int v = warp_sum_int(c[k]);
    if ((threadIdx.x & 31) == 0 && v != 0) atomicAdd(counts + k, v);
  }
}

}  // namespace

extern "C" {

int icp_threads_per_block() { return kThreads; }

int icp_num_sums() { return kSums; }

int icp_partials(const float* pts, const float* nrm, const float* mean,
                 const uint8_t* valid, const uint8_t* found, const float* rt,
                 int n, float sigma2, float huber_delta, float s_gate_min,
                 float max_dist, float* partials, int grid, void* stream) {
  const Gates g{sigma2, huber_delta, s_gate_min, max_dist};
  icp_partials_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pts, nrm, mean, valid, found, rt, n, g, partials);
  return static_cast<int>(cudaGetLastError());
}

int icp_finalize(const float* partials, int rows, float* out, void* stream) {
  icp_finalize_kernel<<<1, 64, 0, static_cast<cudaStream_t>(stream)>>>(
      partials, rows, out);
  return static_cast<int>(cudaGetLastError());
}

int icp_loc_counts(const float* pts, const float* nrm, const float* mean,
                   const uint8_t* valid, const uint8_t* found, const float* rt,
                   const float* vecs, int n, float s_gate_min, float max_dist,
                   float cutoff, int* counts, int grid, void* stream) {
  const Gates g{1.0f, 0.0f, s_gate_min, max_dist};
  icp_loc_counts_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pts, nrm, mean, valid, found, rt, vecs, n, g, cutoff, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
