// Dense RGB-D odometry: one Gauss-Newton linearisation, fused into one pass.
//
// Replaces: onepiece_tpu/ops/dense_odometry.py:80 normal_equations, the body
// of the tracker's iteration loop (onepiece_tpu/odometry/dense.py:146-152).
// In the JAX package this is XLA-fused code, not Pallas; it is the hot loop
// of the frame (28 linearisations per frame pair at iters = (16, 8, 4)).
//
// What bounds it on Hopper: memory and the bilinear gathers. Per source
// pixel it reads 20 bytes of source data (xyz, gray, valid) and 4 taps of 6
// target planes (96 bytes, mostly cache hits because neighbouring pixels
// sample neighbouring targets); it does ~200 flops. At 640x480 that is
// ~35 MB per linearisation, a few microseconds of bandwidth, so launch
// overhead and the reduction's tail matter as much as the pass itself.
//
// Design: per source pixel, transform and project by T, bilinearly sample
// gray, dx, dy, depth (with the 2x2 valid-depth gate), zdx and zdy, form the
// photometric and geometric residuals and their 6-row Jacobians (left
// perturbation, T <- exp(xi) T), and accumulate the 29 numbers of the normal
// equations in registers: 21 upper-triangle terms of J^T W J, 6 of J^T W r,
// the cost and the inlier count. Each CTA reduces its threads' sums with
// warp shuffles and shared memory in a fixed order and writes 29 floats; a
// second launch sums the CTA partials in a fixed order and expands the
// triangle to the full 6x6. No float atomics: the result is deterministic.
// Only the main path's energy is supported: the hybrid term without Huber
// weights (the wrapper raises on anything else).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTerms = 29;  // 21 JTJ (upper, row-major) + 6 JTr + cost + count
constexpr int kOut = 44;    // 36 JTJ + 6 JTr + cost + count

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

__global__ void __launch_bounds__(kThreads) normal_eq_partials(
    const float* __restrict__ xyz,         // (N, 3) source camera-frame points
    const float* __restrict__ src_gray,    // (N,)
    const uint8_t* __restrict__ src_valid, // (N,) bool
    int n,
    const float* __restrict__ planes,  // (6, H, W): gray, dx, dy, depth, zdx, zdy
    int h, int w,
    const float* __restrict__ T,  // (4, 4) row-major
    float fx, float fy, float cx, float cy,
    float wi, float wz, float depth_diff_max,
    float* __restrict__ partials) {  // (gridDim.x, kTerms)
  float acc[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) acc[k] = 0.0f;

  const float R00 = T[0], R01 = T[1], R02 = T[2], t0 = T[3];
  const float R10 = T[4], R11 = T[5], R12 = T[6], t1 = T[7];
  const float R20 = T[8], R21 = T[9], R22 = T[10], t2 = T[11];
  const int hw = h * w;
  const int chunk = (n + gridDim.x - 1) / gridDim.x;
  const int start = blockIdx.x * chunk;
  const int end = min(start + chunk, n);

  for (int i = start + threadIdx.x; i < end; i += kThreads) {
    if (!src_valid[i]) continue;
    const float x = xyz[3 * i], y = xyz[3 * i + 1], zs = xyz[3 * i + 2];
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
    const int b = v0i * w + u0i;
    float s[6];
    bool taps_valid = true;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const float* p = planes + c * hw + b;
      const float p00 = p[0], p01 = p[1], p10 = p[w], p11 = p[w + 1];
      s[c] = p00 * (1 - fu) * (1 - fv) + p01 * fu * (1 - fv) + p10 * (1 - fu) * fv +
             p11 * fu * fv;
      if (c == 3) taps_valid = p00 > 0.0f && p01 > 0.0f && p10 > 0.0f && p11 > 0.0f;
    }
    if (!taps_valid) continue;
    const float r_i = s[0] - src_gray[i];
    const float r_z = s[3] - z;
    if (!(fabsf(r_z) < depth_diff_max)) continue;

    const float inv_z = 1.0f / z;
    const float du0 = fx * inv_z, du2 = -fx * px * inv_z * inv_z;
    const float dv1 = fy * inv_z, dv2 = -fy * py * inv_z * inv_z;
    // photometric and geometric rows through the warp, then [g | p x g]
    const float gi0 = s[1] * du0, gi1 = s[2] * dv1, gi2 = s[1] * du2 + s[2] * dv2;
    const float gz0 = s[4] * du0, gz1 = s[5] * dv1, gz2 = s[4] * du2 + s[5] * dv2 - 1.0f;
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
}

__global__ void __launch_bounds__(kThreads) normal_eq_finish(
    const float* __restrict__ partials, int num_blocks, float* __restrict__ out) {
  __shared__ float tot[kTerms];
  float acc[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) acc[k] = 0.0f;
  for (int b = threadIdx.x; b < num_blocks; b += kThreads) {
#pragma unroll
    for (int k = 0; k < kTerms; ++k) acc[k] += partials[(size_t)b * kTerms + k];
  }
  block_reduce(acc, tot);
  __syncthreads();
  if (threadIdx.x < 36) {  // full symmetric JTJ from the upper triangle
    const int r = threadIdx.x / 6, c = threadIdx.x % 6;
    const int a = min(r, c), bb = max(r, c);
    out[threadIdx.x] = tot[a * 6 - a * (a - 1) / 2 + (bb - a)];
  } else if (threadIdx.x < kOut) {
    out[threadIdx.x] = tot[21 + (threadIdx.x - 36)];
  }
}

}  // namespace

extern "C" int dense_normal_eq(
    const float* xyz, const float* src_gray, const uint8_t* src_valid, int n,
    const float* planes, int h, int w, const float* T,
    float fx, float fy, float cx, float cy, float wi, float wz, float depth_diff_max,
    float* partials, int num_blocks, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  normal_eq_partials<<<num_blocks, kThreads, 0, s>>>(
      xyz, src_gray, src_valid, n, planes, h, w, T, fx, fy, cx, cy, wi, wz,
      depth_diff_max, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  normal_eq_finish<<<1, kThreads, 0, s>>>(partials, num_blocks, out);
  return (int)cudaGetLastError();
}
