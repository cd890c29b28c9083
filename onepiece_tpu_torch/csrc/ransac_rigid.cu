// Rigid RANSAC's hypotheses in one launch: fit and score every hypothesis
// and pick the best, with no host read.
//
// Replaces: onepiece_tpu/ops/ransac.py:42 ransac_rigid from the draw to the
// best hypothesis (XLA, not Pallas): the batched quaternion fits
// (geometry/transforms.py kabsch_fast), the scoring and the argmax. The
// port's plain route in ops/ransac.py issues ~145 small PyTorch ops for
// them. The refit of the best on its inliers stays the plain route's
// (`transforms.kabsch` and the library's 3x3 SVD), so that every refit
// keeps the library's float32 rounding: a float64 SVD here moved the
// refits by up to ~3e-6, and bundle adjustment carried that to gaps and
// graph changes beyond the benchmark's comparison in 11 of 29 BA scans.
//
// What it computes, the plain route's mathematics step for step:
//   1. per hypothesis h, over its S samples with uniform weights w = 1/S:
//      the centroids, the centred covariance S_ij = sum (sc_i w) dc_j and
//      E0 = (sum |sc|^2 w + sum |dc|^2 w) / 2; Horn's 4x4 K from S, shifted
//      by E0; K^4 = ((K + E0 I)^2)^2 over its Frobenius norm; `products`
//      products K^4 v from v = (1, 0.01, 0.02, 0.03), normalised; the
//      quaternion's R, and t = mu_d - R mu_s;
//   2. d2 = |R p + t - q|^2 per correspondence; an inlier has d2 < gate and
//      is valid, where gate is thr2 or (threshold z)^2 with depths z;
//      count[h] = its inliers;
//   3. best = the first maximum of count (torch.argmax); its T, inlier
//      mask, count and d2, and every correspondence's gate, written for the
//      refit.
//
// What bounds it on Hopper: latency. At the sparse tracker's shapes (N 1,000
// correspondences, H 256 hypotheses of S 8) the work is ~7 M float
// operations and ~50 KB, a fraction of a microsecond at the card's peaks;
// the chain of dependent reductions sets the time. Its aim is the host: one
// launch in place of ~145.
//
// Design:
// - A CTA of kWarps warps; a warp owns a hypothesis (grid-strided over H
//   in rounds, the same number in every CTA). Every lane fits it alone,
//   over the S samples (a few hundred operations, the same loads in every
//   lane), so all lanes hold the same T with no broadcast; the warp then
//   strides over the correspondences to count.
// - The CTA stages the correspondences in shared memory, 32 B each: src
//   and the gate (-inf where invalid), dst. N <= kTile is staged once;
//   a larger N is walked tile by tile in each round.
// - The finish uses the ticket of csrc/dense_normal_eq.cu: each CTA fences
//   its T[h] and count[h] and takes a ticket with atomicAdd; the CTA that
//   draws the last ticket takes the argmax, writes the best's outputs and
//   resets the counter.
// - The fit keeps the plain route's operations and their order as PyTorch
//   runs them on the card, fused multiply-adds where the library fuses them
//   (explicit __fmaf_rn; the build has --fmad=false), so each hypothesis is
//   the plain route's bit for bit: the refit and the outputs then follow
//   the same bits as the plain route, and bundle adjustment downstream
//   sees what it sees there.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;        // correspondences staged at once: 32 KB
constexpr int kMaxBlocks = 264;    // two CTAs on each of the H100's 132 SMs
constexpr unsigned kFull = 0xffffffffu;

// Correspondence i's gate: thr2, or (threshold z_i)^2 with depths.
__device__ __forceinline__ float gate_at(const float* __restrict__ z, int z_stride, float threshold, float thr2,
                                         int i) {
  if (z == nullptr) return thr2;
  const float g = threshold * __ldg(z + (size_t)i * z_stride);
  return g * g;
}

// Correspondence i as (src, gate) and (dst, 0), the gate -inf where
// invalid, so no d2 passes it.
__device__ __forceinline__ void load_point(const float* __restrict__ src, const float* __restrict__ dst,
                                           const unsigned char* __restrict__ valid, const float* __restrict__ z,
                                           int z_stride, float threshold, float thr2, int i, float4& a, float4& b) {
  const float gate = __ldg(valid + i) ? gate_at(z, z_stride, threshold, thr2, i) : -INFINITY;
  a = make_float4(__ldg(src + 3 * i), __ldg(src + 3 * i + 1), __ldg(src + 3 * i + 2), gate);
  b = make_float4(__ldg(dst + 3 * i), __ldg(dst + 3 * i + 1), __ldg(dst + 3 * i + 2), 0.0f);
}

// |R p + t - q|^2 as the plain route computes it (a product over 3, the
// squares summed as (x + z) + y); T = R (row-major), t.
__device__ __forceinline__ float dist2(const float (&T)[12], float4 a, float4 b) {
  const float ex = __fmaf_rn(T[2], a.z, __fmaf_rn(T[1], a.y, T[0] * a.x)) + T[9] - b.x;
  const float ey = __fmaf_rn(T[5], a.z, __fmaf_rn(T[4], a.y, T[3] * a.x)) + T[10] - b.y;
  const float ez = __fmaf_rn(T[8], a.z, __fmaf_rn(T[7], a.y, T[6] * a.x)) + T[11] - b.z;
  return (ex * ex + ez * ez) + ey * ey;
}

// The plain route's small reductions as PyTorch runs them on an H100
// (found by comparing every candidate order with the card's results, bit
// for bit): a sum over a strided dimension keeps four accumulators, term k
// in accumulator k % 4, and adds them as ((a0 + a1) + a2) + a3; a sum over
// the last, contiguous dimension (S <= 8 terms) adds them as
// (a0 + a2) + (a1 + a3); a batched matrix product is a chain of fused
// multiply-adds over k from 0; a 4-vector product is
// fma(a1, b1, a0 b0) + fma(a3, b3, a2 b2), a 3-vector one
// fma(a1, b1, a0 b0) + a2 b2.
__device__ __forceinline__ float sum_strided(const float (&a)[4]) { return ((a[0] + a[1]) + a[2]) + a[3]; }
__device__ __forceinline__ float sum_last(const float (&a)[4]) { return (a[0] + a[2]) + (a[1] + a[3]); }

__device__ __forceinline__ void mat4_mul(const float (&A)[4][4], const float (&B)[4][4], float (&C)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc = __fmaf_rn(A[i][k], B[k][j], acc);
      C[i][j] = acc;
    }
  }
}

// Horn's quaternion fit of hypothesis h, transforms.kabsch_fast with uniform
// weights in the plain route's order of operations: every lane of the warp
// runs it alone over the S samples and returns the same T.
__device__ void fit_hypothesis(const float* __restrict__ src, const float* __restrict__ dst,
                               const long long* __restrict__ samples, int h, int s, int products, float (&T)[12]) {
  const long long* idx = samples + (size_t)h * s;
  const float w = 1.0f / (float)s;
  float acc[4][6];  // mu_s, mu_d: term k in accumulator k % 4
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int d = 0; d < 6; ++d) acc[j][d] = 0.0f;
  }
  for (int k = 0; k < s; ++k) {
    const long long i = __ldg(idx + k);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      acc[k & 3][d] += __ldg(src + 3 * i + d) * w;
      acc[k & 3][3 + d] += __ldg(dst + 3 * i + d) * w;
    }
  }
  float m[6];
#pragma unroll
  for (int d = 0; d < 6; ++d) {
    const float a[4] = {acc[0][d], acc[1][d], acc[2][d], acc[3][d]};
    m[d] = sum_strided(a);
  }
  float S[3][3];  // row: src axis, column: dst axis; a chain of FMAs over the samples
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) S[a][b] = 0.0f;
  }
  float es[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ed[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // |sc|^2 w, |dc|^2 w by k % 4
  for (int k = 0; k < s; ++k) {
    const long long i = __ldg(idx + k);
    float sc[3], dc[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      sc[d] = __ldg(src + 3 * i + d) - m[d];
      dc[d] = __ldg(dst + 3 * i + d) - m[3 + d];
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float sw = sc[a] * w;
#pragma unroll
      for (int b = 0; b < 3; ++b) S[a][b] = __fmaf_rn(sw, dc[b], S[a][b]);
    }
    es[k & 3] += ((sc[0] * sc[0] + sc[2] * sc[2]) + sc[1] * sc[1]) * w;
    ed[k & 3] += ((dc[0] * dc[0] + dc[2] * dc[2]) + dc[1] * dc[1]) * w;
  }
  const float sxx = S[0][0], sxy = S[0][1], sxz = S[0][2], syx = S[1][0], syy = S[1][1], syz = S[1][2];
  const float szx = S[2][0], szy = S[2][1], szz = S[2][2];
  const float e0 = 0.5f * (sum_last(es) + sum_last(ed));
  float K[4][4] = {
      {sxx + syy + szz, syz - szy, szx - sxz, sxy - syx},
      {syz - szy, sxx - syy - szz, sxy + syx, szx + sxz},
      {szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy},
      {sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz},
  };
#pragma unroll
  for (int d = 0; d < 4; ++d) K[d][d] = K[d][d] + e0;
  float K2[4][4], K4[4][4];
  mat4_mul(K, K, K2);
  mat4_mul(K2, K2, K4);
  // the Frobenius norm's 16 squares, as the library sums them
  float q[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) q[k] = K4[k >> 2][k & 3] * K4[k >> 2][k & 3];
#pragma unroll
  for (int k = 0; k < 8; ++k) q[k] = q[k] + q[k + 8];
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = q[k] + q[k + 4];
  const float fro = fmaxf(sqrtf((q[0] + q[2]) + (q[1] + q[3])), 1e-30f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) K4[i][j] = K4[i][j] / fro;
  }
  float v[4] = {1.0f, 0.01f, 0.02f, 0.03f};  // transforms._start_vector
  for (int it = 0; it < products; ++it) {
    float u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      u[i] = __fmaf_rn(K4[i][1], v[1], K4[i][0] * v[0]) + __fmaf_rn(K4[i][3], v[3], K4[i][2] * v[2]);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = u[i];
  }
  const float nv = fmaxf(sqrtf((v[0] * v[0] + v[2] * v[2]) + (v[1] * v[1] + v[3] * v[3])), 1e-30f);
  const float qw = v[0] / nv, qx = v[1] / nv, qy = v[2] / nv, qz = v[3] / nv;
  T[0] = 1.0f - 2.0f * (qy * qy + qz * qz);
  T[1] = 2.0f * (qx * qy - qz * qw);
  T[2] = 2.0f * (qx * qz + qy * qw);
  T[3] = 2.0f * (qx * qy + qz * qw);
  T[4] = 1.0f - 2.0f * (qx * qx + qz * qz);
  T[5] = 2.0f * (qy * qz - qx * qw);
  T[6] = 2.0f * (qx * qz - qy * qw);
  T[7] = 2.0f * (qy * qz + qx * qw);
  T[8] = 1.0f - 2.0f * (qx * qx + qy * qy);
#pragma unroll
  for (int r = 0; r < 3; ++r)
    T[9 + r] = m[3 + r] - (__fmaf_rn(T[3 * r + 1], m[1], T[3 * r] * m[0]) + T[3 * r + 2] * m[2]);
}

__global__ void __launch_bounds__(kThreads) ransac_rigid_kernel(
    const float* __restrict__ src,            // (N, 3)
    const float* __restrict__ dst,            // (N, 3)
    const unsigned char* __restrict__ valid,  // (N,)
    const float* __restrict__ z,              // depths, every z_stride floats; null: a fixed gate
    int z_stride, int n,
    const long long* __restrict__ samples,    // (H, S)
    int h_count, int s, float threshold, float thr2, int products,
    float* __restrict__ hyp_T,                // (H, 12) scratch: R row-major, t
    int* __restrict__ hyp_count,              // (H + 1,): the counts, then the best's index
    unsigned int* __restrict__ counter,       // ticket counter, 0 between launches
    float* __restrict__ T_best,               // (4, 4)
    unsigned char* __restrict__ inl_best,     // (N,)
    long long* __restrict__ count_best,       // ()
    float* __restrict__ d2_best,              // (N,)
    float* __restrict__ gate_out) {           // (N,)
  __shared__ float4 s_a[kTile];  // src, gate
  __shared__ float4 s_b[kTile];  // dst
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool staged = n <= kTile;
  const int per_round = gridDim.x * kWarps;
  const int rounds = (h_count + per_round - 1) / per_round;

  auto stage = [&](int first, int count) {
    for (int i = threadIdx.x; i < count; i += kThreads)
      load_point(src, dst, valid, z, z_stride, threshold, thr2, first + i, s_a[i], s_b[i]);
  };
  auto count_staged = [&](const float (&T)[12], int count) {
    int c = 0;
    for (int i = lane; i < count; i += 32) c += dist2(T, s_a[i], s_b[i]) < s_a[i].w;
    return c;
  };

  if (staged) {
    stage(0, n);
    __syncthreads();
  }
  for (int r = 0; r < rounds; ++r) {
    const int h = (r * gridDim.x + blockIdx.x) * kWarps + warp;
    const bool active = h < h_count;
    float T[12];
    if (active) fit_hypothesis(src, dst, samples, h, s, products, T);
    int c = 0;
    if (staged) {
      if (active) c = count_staged(T, n);
    } else {
      for (int first = 0; first < n; first += kTile) {
        const int count = min(kTile, n - first);
        __syncthreads();
        stage(first, count);
        __syncthreads();
        if (active) c += count_staged(T, count);
      }
    }
    if (active) {
      c = __reduce_add_sync(kFull, c);
      if (lane == 0) {
        hyp_count[h] = c;
#pragma unroll
        for (int k = 0; k < 12; ++k) hyp_T[(size_t)h * 12 + k] = T[k];
      }
    }
  }

  // ticket: the CTA that finishes last refits the best and writes the outputs
  __shared__ unsigned int ticket;
  __threadfence();  // this CTA's T[h] and count[h] are visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(counter, 1u);
  __syncthreads();
  if (ticket != gridDim.x - 1) return;
  __threadfence();

  // the first maximum of the counts
  __shared__ int best_c[kWarps], best_h[kWarps];
  int bc = -1, bh = 0;
  for (int h = threadIdx.x; h < h_count; h += kThreads) {
    const int c = __ldcg(hyp_count + h);
    if (c > bc) {
      bc = c;
      bh = h;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int oc = __shfl_xor_sync(kFull, bc, o), oh = __shfl_xor_sync(kFull, bh, o);
    if (oc > bc || (oc == bc && oh < bh)) {
      bc = oc;
      bh = oh;
    }
  }
  if (lane == 0) {
    best_c[warp] = bc;
    best_h[warp] = bh;
  }
  __syncthreads();
  bc = best_c[0];
  bh = best_h[0];
  for (int w = 1; w < kWarps; ++w) {
    if (best_c[w] > bc || (best_c[w] == bc && best_h[w] < bh)) {
      bc = best_c[w];
      bh = best_h[w];
    }
  }
  float Tb[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) Tb[k] = __ldcg(hyp_T + (size_t)bh * 12 + k);

  if (threadIdx.x == 0) {
    hyp_count[h_count] = bh;
    *count_best = bc;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) T_best[4 * r + c] = Tb[3 * r + c];
      T_best[4 * r + 3] = Tb[9 + r];
    }
    T_best[12] = 0.0f;
    T_best[13] = 0.0f;
    T_best[14] = 0.0f;
    T_best[15] = 1.0f;
    *counter = 0u;
  }
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float4 a, b;
    if (staged) {
      a = s_a[i];
      b = s_b[i];
    } else {
      load_point(src, dst, valid, z, z_stride, threshold, thr2, i, a, b);
    }
    const float d2 = dist2(Tb, a, b);
    inl_best[i] = d2 < a.w;
    d2_best[i] = d2;
    gate_out[i] = gate_at(z, z_stride, threshold, thr2, i);
  }
}

}  // namespace

// One launch. `z` null: the fixed gate thr2; else the gate (threshold z_i)^2
// with z_i at z[i * z_stride]. `hyp_T` holds H * 12 floats, `hyp_count` H + 1
// ints, `counter` one zeroed unsigned int (the kernel leaves it at 0).
extern "C" int ransac_rigid(const float* src, const float* dst, const unsigned char* valid, const float* z,
                            int z_stride, int n, const long long* samples, int h, int s, float threshold,
                            float thr2, int products, float* hyp_T, int* hyp_count, unsigned int* counter,
                            float* T_best, unsigned char* inl_best, long long* count_best, float* d2_best,
                            float* gate, void* stream) {
  if (n < 1 || h < 1 || s < 1) return (int)cudaErrorInvalidValue;
  const int blocks = min((h + kWarps - 1) / kWarps, kMaxBlocks);
  ransac_rigid_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      src, dst, valid, z, z_stride, n, samples, h, s, threshold, thr2, products, hyp_T, hyp_count, counter,
      T_best, inl_best, count_best, d2_best, gate);
  return (int)cudaGetLastError();
}
