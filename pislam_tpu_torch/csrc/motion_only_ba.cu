// Motion-only BA (backend/pnp.py motion_only_ba_plain): a camera pose refined
// against matched map points by Gauss-Newton on the reprojection error, a
// fixed number of iterations, Huber weights, in one launch.
//
// Replaces no Pallas kernel: the JAX package's motion_only_ba
// (pislam_tpu/backend/pnp.py) is plain JAX, which XLA compiles into one
// program. In eager PyTorch the same iterations were ~800 launches a call
// and two host reads a solve (linalg_lu_solve's status), a third of a SLAM
// frame's host time; this kernel is that chain in one launch.
//
// Bound: the dependent chain's latency. The work is ~22 KB in, 1 KB out and
// ~1.2 MFLOP at 1000 points and 8 iterations, nanoseconds at the card's
// rates; every iteration waits on the previous one's pose, and each is a
// pass over the points, a block reduction and a 6x6 solve on one thread.
//
// Design: one block of 256 threads. Thread k takes points k, k + 256, ...
// in that order in every pass, reading them through L1 (21 KB at 1000
// points). A pass computes each point's camera coordinates, residual, Huber
// weight and 2x6 Jacobian with motion_only_ba_plain's rules (the depth
// divisor is 1 at or behind 1e-6, where the weight is 0) and adds its terms
// to the thread's 28 sums: the 21 upper entries of J^T W J, the 6 of J^T W r
// and the cost. Every point enters every sum multiplied by its weight, as in
// the plain version, so a non-finite point makes the pose NaN there too. The
// sums reduce by xor shuffles within each warp, then over the 8 warps in
// warp order through shared memory: no atomics, so two launches on the same
// inputs give the same bits. Thread 0 adds the damping, solves by LU with
// partial pivoting (LAPACK getrf's order: pivot, reciprocal, rank-1 update),
// applies se3_exp (geometry/se3.py _coefficients' forms, Taylor below
// theta^2 = 5e-3) on the left and writes the pass's cost. A last pass writes
// the inliers at the final pose and counts them. The pose lives in shared
// memory from the start (R0 and t0 read on the card): the host reads
// nothing.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 28;      // J^T W J's upper triangle (21), J^T W r (6), the cost
constexpr float kMinDepth = 1e-6f;

struct Point {
  float x, y, z, u, v;
  bool ok;
};

__device__ __forceinline__ Point load_point(const float* __restrict__ xyz,
                                            const float* __restrict__ uv,
                                            const uint8_t* __restrict__ valid, int i) {
  return {xyz[3 * i], xyz[3 * i + 1], xyz[3 * i + 2], uv[2 * i], uv[2 * i + 1], valid[i] != 0};
}

// The point in the camera's frame under pose (R row-major, t): xyz @ R.T + t.
__device__ __forceinline__ void camera(const float (&R)[9], const float (&t)[3], const Point& p,
                                       float& xc, float& yc, float& zc) {
  xc = R[0] * p.x + R[1] * p.y + R[2] * p.z + t[0];
  yc = R[3] * p.x + R[4] * p.y + R[5] * p.z + t[1];
  zc = R[6] * p.x + R[7] * p.y + R[8] * p.z + t[2];
}

// One point's terms added to a thread's sums (pnp.py _camera_points,
// _jacobian and the loop body of motion_only_ba_plain).
__device__ __forceinline__ void accumulate(const float (&R)[9], const float (&t)[3],
                                           const Point& p, float huber, float (&acc)[kSums]) {
  float xc, yc, zc;
  camera(R, t, p, xc, yc, zc);
  const bool front = zc > kMinDepth;
  const float zs = front ? zc : 1.0f;
  const float inv = 1.0f / zs;
  const float r0 = xc / zs - p.u;
  const float r1 = yc / zs - p.v;
  const float rn = sqrtf(r0 * r0 + r1 * r1);
  float w = rn > huber ? huber / fmaxf(rn, 1e-12f) : 1.0f;
  w = (p.ok && front) ? w : 0.0f;
  const float f = front ? 1.0f : 0.0f;
  // d(residual)/d[rho, w]: [jpi, jpi @ -hat(xc)], jpi = [[inv, 0, a], [0, inv, b]]
  const float a = -xc * inv * inv * f;
  const float b = -yc * inv * inv * f;
  const float j0[6] = {inv, 0.0f, a, a * yc, inv * zc - a * xc, -inv * yc};
  const float j1[6] = {0.0f, inv, b, b * yc - inv * zc, -b * xc, inv * xc};
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float w0 = j0[i] * w, w1 = j1[i] * w;
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] += w0 * j0[j] + w1 * j1[j];
    acc[21 + i] += w0 * r0 + w1 * r1;
  }
  acc[27] += w * rn * rn;
}

// (R, t) <- se3_exp(xi) (R, t), se3.py's se3_exp and _coefficients.
__device__ void apply_twist(const float (&xi)[6], float* pose) {
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const bool small = th2 < 5e-3f;
  const float ts = small ? 1.0f : sqrtf(fmaxf(th2, 1e-24f));
  const float sh = sinf(0.5f * ts);
  const float s = sinf(ts);
  const float th4 = th2 * th2;
  const float ca = small ? 1.0f - th2 / 6.0f + th4 / 120.0f : s / ts;
  const float cb = small ? 0.5f - th2 / 24.0f + th4 / 720.0f : 2.0f * sh * sh / (ts * ts);
  const float cc = small ? 1.0f / 6.0f - th2 / 120.0f + th4 / 5040.0f : (ts - s) / (ts * ts * ts);
  const float K[9] = {0.0f, -w2, w1, w2, 0.0f, -w0, -w1, w0, 0.0f};
  float K2[9], dR[9], V[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      K2[3 * i + j] = K[3 * i] * K[j] + K[3 * i + 1] * K[3 + j] + K[3 * i + 2] * K[6 + j];
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    const float eye = (e % 4 == 0) ? 1.0f : 0.0f;
    dR[e] = eye + ca * K[e] + cb * K2[e];
    V[e] = eye + cb * K[e] + cc * K2[e];
  }
  float R[9], t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      R[3 * i + j] = dR[3 * i] * pose[j] + dR[3 * i + 1] * pose[3 + j] + dR[3 * i + 2] * pose[6 + j];
    t[i] = dR[3 * i] * pose[9] + dR[3 * i + 1] * pose[10] + dR[3 * i + 2] * pose[11]
           + (V[3 * i] * xi[0] + V[3 * i + 1] * xi[1] + V[3 * i + 2] * xi[2]);
  }
#pragma unroll
  for (int e = 0; e < 9; ++e) pose[e] = R[e];
#pragma unroll
  for (int i = 0; i < 3; ++i) pose[9 + i] = t[i];
}

// xi = (J^T W J + damping I)^-1 (-J^T W r) from the 28 sums, by LU with
// partial pivoting (the first largest pivot, LAPACK's isamax). Every index
// is known at compile time, so the matrix stays in registers.
__device__ void solve(const float* sums, float damping, float (&xi)[6]) {
  float A[6][6];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) A[i][j] = A[j][i] = sums[k++];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    A[i][i] += damping;
    xi[i] = -sums[21 + i];
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    int p = j;
    float best = fabsf(A[j][j]);
#pragma unroll
    for (int i = j + 1; i < 6; ++i)
      if (fabsf(A[i][j]) > best) {
        best = fabsf(A[i][j]);
        p = i;
      }
#pragma unroll
    for (int r = j + 1; r < 6; ++r)
      if (r == p) {
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          const float x = A[j][c];
          A[j][c] = A[r][c];
          A[r][c] = x;
        }
        const float x = xi[j];
        xi[j] = xi[r];
        xi[r] = x;
      }
    if (A[j][j] != 0.0f) {
      const float rcp = 1.0f / A[j][j];
#pragma unroll
      for (int i = j + 1; i < 6; ++i) A[i][j] *= rcp;
    }
#pragma unroll
    for (int i = j + 1; i < 6; ++i)
#pragma unroll
      for (int c = j + 1; c < 6; ++c) A[i][c] -= A[i][j] * A[j][c];
  }
#pragma unroll
  for (int j = 0; j < 6; ++j)
#pragma unroll
    for (int i = j + 1; i < 6; ++i) xi[i] -= xi[j] * A[i][j];
#pragma unroll
  for (int j = 5; j >= 0; --j) {
    xi[j] /= A[j][j];
#pragma unroll
    for (int i = 0; i < j; ++i) xi[i] -= xi[j] * A[i][j];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
motion_only_ba_kernel(const float* __restrict__ R0, const float* __restrict__ t0,
                      const float* __restrict__ xyz, const float* __restrict__ uv,
                      const uint8_t* __restrict__ valid, int n, int iters, float huber,
                      float inlier_threshold, float damping, float* __restrict__ R_out,
                      float* __restrict__ t_out, float* __restrict__ costs,
                      uint8_t* __restrict__ inliers, long long* __restrict__ num_inliers) {
  __shared__ float pose[12];                 // R row-major, then t
  __shared__ float partial[kWarps][kSums];
  __shared__ float sums[kSums];
  __shared__ int count;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < 9) pose[tid] = R0[tid];
  else if (tid < 12) pose[tid] = t0[tid - 9];
  if (tid == 0) count = 0;
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    float R[9], t[3];
#pragma unroll
    for (int e = 0; e < 9; ++e) R[e] = pose[e];
#pragma unroll
    for (int e = 0; e < 3; ++e) t[e] = pose[9 + e];
    float acc[kSums];
#pragma unroll
    for (int s = 0; s < kSums; ++s) acc[s] = 0.0f;
    for (int i = tid; i < n; i += kThreads)
      accumulate(R, t, load_point(xyz, uv, valid, i), huber, acc);
    // a + b == b + a in float, so every lane ends with the same bits
#pragma unroll
    for (int s = 0; s < kSums; ++s)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[s] += __shfl_xor_sync(kFullWarp, acc[s], off);
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < kSums; ++s) partial[warp][s] = acc[s];
    }
    __syncthreads();
    if (tid < kSums) {
      float v = partial[0][tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += partial[w][tid];
      sums[tid] = v;
    }
    __syncthreads();
    if (tid == 0) {
      float xi[6];
      solve(sums, damping, xi);
      apply_twist(xi, pose);
      costs[it] = sums[27];
    }
    __syncthreads();
  }

  // the inliers at the final pose (pnp.py _project_residuals)
  float R[9], t[3];
#pragma unroll
  for (int e = 0; e < 9; ++e) R[e] = pose[e];
#pragma unroll
  for (int e = 0; e < 3; ++e) t[e] = pose[9 + e];
  auto inlier = [&](const Point& p) {
    float xc, yc, zc;
    camera(R, t, p, xc, yc, zc);
    const float zs = zc > kMinDepth ? zc : 1.0f;
    const float r0 = xc / zs - p.u;
    const float r1 = yc / zs - p.v;
    return p.ok && zc > kMinDepth && sqrtf(r0 * r0 + r1 * r1) < inlier_threshold;
  };
  int mine = 0;
  for (int i = tid; i < n; i += kThreads) {
    const bool in = inlier(load_point(xyz, uv, valid, i));
    inliers[i] = in;
    mine += in;
  }
  mine = __reduce_add_sync(kFullWarp, mine);
  if (lane == 0) atomicAdd(&count, mine);  // integers: the order does not matter
  __syncthreads();
  if (tid < 9) R_out[tid] = pose[tid];
  else if (tid < 12) t_out[tid - 9] = pose[tid];
  else if (tid == 12) *num_inliers = count;
}

}  // namespace

PISLAM_API int pislam_motion_only_ba(const float* R0, const float* t0, const float* xyz,
                                     const float* uv, const uint8_t* valid, int n, int iters,
                                     float huber, float inlier_threshold, float damping,
                                     float* R, float* t, float* costs, uint8_t* inliers,
                                     long long* num_inliers, cudaStream_t stream) {
  motion_only_ba_kernel<<<1, kThreads, 0, stream>>>(R0, t0, xyz, uv, valid, n, iters, huber,
                                                     inlier_threshold, damping, R, t, costs,
                                                     inliers, num_inliers);
  return (int)cudaGetLastError();
}
