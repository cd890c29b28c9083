// Dense RGB-D odometry: one Gauss-Newton step of the tracker per launch.
//
// Replaces: onepiece_tpu/ops/dense_odometry.py:80 normal_equations together
// with :173 solve_and_update, the body of the tracker's iteration loop
// (onepiece_tpu/odometry/dense.py:146-152, a `lax.fori_loop` that XLA runs as
// one program). In the JAX package this is XLA-fused code, not Pallas; it is
// the hot loop of the frame (28 steps per frame pair at iters = (16, 8, 4)).
//
// One launch computes, at the pose T it reads from device memory:
//   1. the hybrid-term normal equations (21 upper-triangle terms of J^T W J,
//      6 of J^T W r, the cost and the inlier count) over every source pixel;
//   2. the solve (JTJ + damping I) xi = -JTr by LU with partial pivoting;
//   3. the gate: xi finite, more than 6 inliers, no zero pivot;
//   4. the update T <- se3_exp(xi) T, in place.
// It writes the 44 floats of the normal equations (36 JTJ, 6 JTr, cost,
// count) for the caller's cost, inliers and rmse. With `update` = 0 it stops
// after writing them and leaves T alone (the `normal_equations` wrapper).
//
// What bounds it on Hopper: memory. Each source pixel is 16 bytes (x, y, z,
// gray) and each target pixel 24 bytes of six planes, ~12.3 MB at 640x480,
// ~3.7 us at 3.35 TB/s; the arithmetic is ~200 flops per inlier pixel (~1 us
// at 67 TFLOP/s). Before this kernel the host spent ~0.9 ms per step on the
// eager 6x6 solve and se3_exp between two launches.
//
// Design:
// - The source is packed once per pyramid level as float4 (x, y, z, gray);
//   a pixel is valid when z > 0 (dense.py:110). The target is packed
//   channels-last as (H, W, 8): gray, dx, dy, depth, zdx, zdy, 0, 0, so a
//   bilinear tap is two 16-byte loads and the two horizontal taps are one
//   64-byte run.
// - A grid of at most kMaxBlocks CTAs walks the pixels with a grid stride and
//   accumulates the 29 terms in registers; each CTA reduces them with warp
//   shuffles and shared memory in a fixed order and writes its partials.
// - The finish is fused: each CTA fences its partials and takes a ticket with
//   atomicAdd. The CTA that draws the last ticket sums the partials in CTA
//   order with all its threads (deterministic, no float atomics), and its
//   thread 0 expands the triangle, solves, gates, exponentiates and writes T,
//   then resets the ticket counter for the next launch. T is safe to update
//   in place: every CTA has read it before it takes its ticket.
// - Per-pixel arithmetic keeps the plain version's operation order (built
//   with --fmad=false), so pixel terms and inlier counts are bit-equal to it;
//   only the order of the sums differs.
// Only the main path's energy is supported: the hybrid term without Huber
// weights (the wrappers take no other).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 264;  // two CTAs on each of the H100's 132 SMs
constexpr int kTerms = 29;  // 21 JTJ (upper, row-major) + 6 JTr + cost + count
constexpr int kTex = 8;     // floats per target texel

// Sum each of the kTerms values over the CTA (fixed order) into dst[0..kTerms).
__device__ void block_reduce(float (&acc)[kTerms], float* __restrict__ dst) {
  __shared__ float red[kWarps][kTerms];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kTerms; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kTerms) {
    float s = 0.0f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) s += red[wp][threadIdx.x];
    dst[threadIdx.x] = s;
  }
}

__device__ __forceinline__ int upper_index(int a, int c) {  // a <= c
  return a * 6 - a * (a - 1) / 2 + (c - a);
}

// Solve A x = b (6x6) by LU with partial pivoting, in place. Returns false on
// an exactly zero pivot. The plain version (`solve6_reference`) makes the
// same operations in the same order. All indices are compile-time constants
// after unrolling, so A stays in registers; a row swap is a predicated swap.
__device__ bool solve6(float (&A)[6][6], float (&b)[6], float (&x)[6]) {
  bool nonsingular = true;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float v = fabsf(A[i][k]);
      if (v > best) {  // strict: the first row of the largest |pivot|
        best = v;
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (p == i) {
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float t = A[k][j];
          A[k][j] = A[i][j];
          A[i][j] = t;
        }
        const float t = b[k];
        b[k] = b[i];
        b[i] = t;
      }
    }
    const float piv = A[k][k];
    nonsingular = nonsingular && piv != 0.0f;
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = A[i][k] / piv;
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[i][j] = A[i][j] - l * A[k][j];
      b[i] = b[i] - l * b[k];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = b[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s = s - A[i][j] * x[j];
    x[i] = s / A[i][i];
  }
  return nonsingular;
}

// T <- se3_exp(xi) T with geometry/se3.py's formulas: xi = (rho, phi),
// Rodrigues with the Taylor switch at theta^2 < 1e-8 and _EPS = 1e-8.
__device__ void se3_exp_left_multiply(const float (&xi)[6], float* T) {
  const float p0 = xi[3], p1 = xi[4], p2 = xi[5];
  const float theta2 = (p0 * p0 + p1 * p1) + p2 * p2;
  const float theta = sqrtf(theta2 + 1e-16f);
  const bool taylor = theta2 < 1e-8f;
  const float s = sinf(theta), c = cosf(theta);
  const float a = taylor ? 1.0f - theta2 / 6.0f : s / theta;
  const float bb = taylor ? 0.5f - theta2 / 24.0f : (1.0f - c) / (theta2 + 1e-16f);
  const float cc = taylor ? 1.0f / 6.0f - theta2 / 120.0f
                          : (theta - s) / (theta2 * theta + 1e-24f);
  const float K[3][3] = {{0.0f, -p2, p1}, {p2, 0.0f, -p0}, {-p1, p0, 0.0f}};
  float R[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float k2 = (K[i][0] * K[0][j] + K[i][1] * K[1][j]) + K[i][2] * K[2][j];
      const float eye = i == j ? 1.0f : 0.0f;
      R[i][j] = (eye + a * K[i][j]) + bb * k2;
      V[i][j] = (eye + bb * K[i][j]) + cc * k2;
    }
  }
  float E[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) E[i][j] = R[i][j];
    E[i][3] = (V[i][0] * xi[0] + V[i][1] * xi[1]) + V[i][2] * xi[2];
  }
  float out[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[i][j] = ((E[i][0] * T[j] + E[i][1] * T[4 + j]) + E[i][2] * T[8 + j]) +
                  E[i][3] * T[12 + j];
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) T[4 * i + j] = out[i][j];
  }
  // the bottom row [0, 0, 0, 1] of exp(xi) times T is T's bottom row
}

// The last CTA's thread 0: normal equations out, solve, gate, update.
__device__ void finish(const float* __restrict__ tot, float damping, bool update, float* T,
                       float* __restrict__ out) {
  float A[6][6], b[6], xi[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const float v = tot[upper_index(r < c ? r : c, r < c ? c : r)];
      out[r * 6 + c] = v;
      A[r][c] = r == c ? v + damping : v;
    }
    out[36 + r] = tot[21 + r];
    b[r] = -tot[21 + r];
  }
  out[42] = tot[27];
  out[43] = tot[28];
  if (!update) return;
  const bool nonsingular = solve6(A, b, xi);
  bool ok = nonsingular && tot[28] > 6.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) ok = ok && isfinite(xi[k]);
  if (ok) se3_exp_left_multiply(xi, T);  // else xi = 0: T stays as it is
}

__global__ void __launch_bounds__(kThreads, 2) gn_step_kernel(
    const float4* __restrict__ src,  // (N,) x, y, z, gray; valid where z > 0
    int n,
    const float* __restrict__ tex,  // (H, W, 8): gray, dx, dy, depth, zdx, zdy, 0, 0
    int h, int w,
    float* T,  // (4, 4) row-major; read by every CTA, written by the last
    float fx, float fy, float cx, float cy,
    float wi, float wz, float depth_diff_max, float damping, int update,
    float* __restrict__ partials,       // (gridDim.x, kTerms)
    unsigned int* __restrict__ counter,  // ticket counter, 0 between launches
    float* __restrict__ out) {           // (44,): 36 JTJ + 6 JTr + cost + count
  float acc[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) acc[k] = 0.0f;

  const float R00 = T[0], R01 = T[1], R02 = T[2], t0 = T[3];
  const float R10 = T[4], R11 = T[5], R12 = T[6], t1 = T[7];
  const float R20 = T[8], R21 = T[9], R22 = T[10], t2 = T[11];
  const int row = w * kTex;

  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
    const float4 sp = __ldg(src + i);
    if (!(sp.z > 0.0f)) continue;
    const float x = sp.x, y = sp.y, zs = sp.z;
    // operation order matches the plain version (built with --fmad=false)
    const float px = R00 * x + R01 * y + R02 * zs + t0;
    const float py = R10 * x + R11 * y + R12 * zs + t1;
    const float z = R20 * x + R21 * y + R22 * zs + t2;
    if (!(z > 1e-6f)) continue;
    const float u = px / z * fx + cx;
    const float v = py / z * fy + cy;
    const float u0 = floorf(u), v0 = floorf(v);
    const float fu = u - u0, fv = v - v0;
    const int u0i = (int)u0, v0i = (int)v0;
    if (!(u0i >= 0 && u0i < w - 1 && v0i >= 0 && v0i < h - 1)) continue;
    const float4* p = reinterpret_cast<const float4*>(tex + (size_t)v0i * row + u0i * kTex);
    const float4* q = reinterpret_cast<const float4*>(tex + (size_t)(v0i + 1) * row + u0i * kTex);
    const float4 a00 = __ldg(p), b00 = __ldg(p + 1), a01 = __ldg(p + 2), b01 = __ldg(p + 3);
    const float4 a10 = __ldg(q), b10 = __ldg(q + 1), a11 = __ldg(q + 2), b11 = __ldg(q + 3);
    if (!(a00.w > 0.0f && a01.w > 0.0f && a10.w > 0.0f && a11.w > 0.0f)) continue;
    const float wu0 = 1 - fu, wu1 = fu, wv0 = 1 - fv, wv1 = fv;
#define OP_BILINEAR(P00, P01, P10, P11) \
  ((P00) * wu0 * wv0 + (P01) * wu1 * wv0 + (P10) * wu0 * wv1 + (P11) * wu1 * wv1)
    const float s_gray = OP_BILINEAR(a00.x, a01.x, a10.x, a11.x);
    const float s_dx = OP_BILINEAR(a00.y, a01.y, a10.y, a11.y);
    const float s_dy = OP_BILINEAR(a00.z, a01.z, a10.z, a11.z);
    const float s_depth = OP_BILINEAR(a00.w, a01.w, a10.w, a11.w);
    const float s_zdx = OP_BILINEAR(b00.x, b01.x, b10.x, b11.x);
    const float s_zdy = OP_BILINEAR(b00.y, b01.y, b10.y, b11.y);
#undef OP_BILINEAR
    const float r_i = s_gray - sp.w;
    const float r_z = s_depth - z;
    if (!(fabsf(r_z) < depth_diff_max)) continue;

    const float inv_z = 1.0f / z;
    const float du0 = fx * inv_z, du2 = -fx * px * inv_z * inv_z;
    const float dv1 = fy * inv_z, dv2 = -fy * py * inv_z * inv_z;
    // photometric and geometric rows through the warp, then [g | p x g]
    const float gi0 = s_dx * du0, gi1 = s_dy * dv1, gi2 = s_dx * du2 + s_dy * dv2;
    const float gz0 = s_zdx * du0, gz1 = s_zdy * dv1, gz2 = s_zdx * du2 + s_zdy * dv2 - 1.0f;
    const float Ji[6] = {gi0, gi1, gi2, py * gi2 - z * gi1, z * gi0 - px * gi2,
                         px * gi1 - py * gi0};
    const float Jz[6] = {gz0, gz1, gz2, py * gz2 - z * gz1, z * gz0 - px * gz2,
                         px * gz1 - py * gz0};
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const float wja = wi * Ji[a], wza = wz * Jz[a];
#pragma unroll
      for (int c = a; c < 6; ++c) acc[k++] += wja * Ji[c] + wza * Jz[c];
      acc[21 + a] += wja * r_i + wza * r_z;
    }
    acc[27] += wi * r_i * r_i + wz * r_z * r_z;
    acc[28] += 1.0f;
  }
  block_reduce(acc, partials + (size_t)blockIdx.x * kTerms);

  // ticket: the CTA that finishes last sums the partials and takes the step
  __shared__ unsigned int ticket;
  __threadfence();  // this CTA's partials are visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(counter, 1u);
  __syncthreads();
  if (ticket != gridDim.x - 1) return;
  __threadfence();

#pragma unroll
  for (int k = 0; k < kTerms; ++k) acc[k] = 0.0f;
  for (int b = threadIdx.x; b < gridDim.x; b += kThreads) {
#pragma unroll
    for (int k = 0; k < kTerms; ++k) acc[k] += __ldcg(partials + (size_t)b * kTerms + k);
  }
  __shared__ float tot[kTerms];
  block_reduce(acc, tot);
  __syncthreads();
  if (threadIdx.x == 0) {
    finish(tot, damping, update != 0, T, out);
    *counter = 0u;
  }
}

}  // namespace

// `iters` Gauss-Newton steps back to back on one stream (update = 1), or one
// linearisation at T (update = 0, iters = 1). `partials` holds
// partial_rows * 29 floats, `counter` one zeroed unsigned int.
extern "C" int dense_gn(
    const void* src, int n, const float* tex, int h, int w, float* T,
    float fx, float fy, float cx, float cy, float wi, float wz, float depth_diff_max,
    float damping, int update, int iters,
    float* partials, int partial_rows, unsigned int* counter, float* out, void* stream) {
  const int num_blocks = max(1, min((n + kThreads - 1) / kThreads, kMaxBlocks));
  if (n < 0 || partial_rows < num_blocks) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  for (int it = 0; it < iters; ++it) {
    gn_step_kernel<<<num_blocks, kThreads, 0, s>>>(
        (const float4*)src, n, tex, h, w, T, fx, fy, cx, cy, wi, wz, depth_diff_max,
        damping, update, partials, counter, out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
