// The bundle-adjustment step's Schur reduction and point back-substitution.
//
// Replaces: onepiece_tpu/optimization/bundle.py:232 _ba_step_masked, lines
// :246-280 (residuals, Jacobians, damped U and V, V^-1, S = U - W V^-1 W^T,
// rhs_c = b_c - W V^-1 b_p) and :293-294 (dp = -V^-1 (b_p + W^T dc)), for
// both observation models (`_residuals_jacobians` :74, the 2-D reprojection;
// `_residuals_jacobians_3d` :205, the RGB-D camera-frame point). XLA on the
// TPU, not Pallas: the JAX package scatters one 6x3 block per observation
// into a dense (F, 6, P, 3) tensor and contracts (6F, 3P) x (3P, 6F) on the
// MXU.
//
// What it computes. Per valid observation o of frame f and point p, with
// scalar weight w: r, J_c (k x 6), J_p (k x 3), k = 2 or 3 rows; U_o = J_c^T
// w J_c, g_o = J_c^T w r, W_o = J_c^T w J_p, V_o = J_p^T w J_p, e_o = J_p^T
// w r. V_p = damp(sum V_o), b_p = sum e_o, Y_o = W_o V_p^-1; then S's block
// (f, g) = -sum over pairs (o1 of f, o2 of the same point in frame g) of
// Y_o1 W_o2^T, plus damp(sum U_o) on the diagonal block, and rhs_c,f = sum
// g_o - sum Y_o b_p. Two observations of one point in one frame give the same
// sums as the dense form: (W1 + W2) V^-1 (W1 + W2)^T expands to the pairs.
// damp(M) adds lam |M_ii| + (1e-6 tr(M) / n + 1e-9) to each diagonal entry.
//
// What bounds it on Hopper: neither rate. A pair of observations of one
// point costs 216 float operations (a 6x6 block of 3-term dots), an
// observation ~300 (its Jacobians and products), and the inputs are a few
// hundred kilobytes; the S written is 36 F^2 floats (2.4 MB at F = 128). At
// the path's sizes (a few thousand observations, F = 64-128) that is
// microseconds of work: the time is launch latency and the serial walks.
// The design keeps it simple and exact:
//   - No atomics. Every sum is taken in a fixed order (the observation
//     lists are stable sorts, made once per LM loop on the device), so two
//     calls are bit-equal.
//   - Launch A, one warp per point: the lanes take the point's observations
//     lane-strided, linearise them, write W_o, U_o and g_o, and reduce V
//     and b_p with an xor butterfly (every lane ends with the same sum);
//     each lane inverts the damped V by cofactors (no LU, no host check)
//     and writes Y_o for its observations. A point with no observation
//     damps to 1e-9 I, as in the dense form, and its step is 0.
//   - Launch B, one CTA per frame f: S's 6 x 6F strip of rows lives in
//     shared memory (144 F bytes, dynamic above 48 KB). The CTA's threads
//     form groups of 36, one thread per entry of a 6x6 block; group q walks
//     every pair (o1 of f in list order, o2 of o1's point in list order) and
//     adds only blocks (f, g) with g = q mod (groups), so each entry is
//     written by one thread, in pair order. Then U_f, its damping and
//     rhs_c,f, each a sequential sum over f's list, and the strip goes out
//     in coalesced rows.
//   - Launch C (ba_back_substitute), one thread per point: its observations
//     in list order, dp = -V^-1 (b_p + sum W_o^T dc_f).
// Built with --fmad=false, as every kernel of the port: the per-observation
// arithmetic rounds as the plain version's separate operations do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kSigmaA = 0.0015f;  // m
constexpr float kSigmaB = 0.0019f;  // m^-1
constexpr float kHuber = 3.0f;
constexpr int kObsStride = 18 + 18 + 36 + 6;  // per observation: W, Y, U_o, g_o
constexpr int kWarpsA = 8;
constexpr int kThreadsB = 256;
constexpr int kThreadsC = 128;

struct Obs {
    float r[3];
    float Jc[3][6];
    float Jp[3][3];
    float w;
    int rows;
};

// r, J and w of observation o (model 0: reprojection, 1: RGB-D point).
__device__ void linearize(const float* __restrict__ poses, const float* __restrict__ points,
                          const int64_t* __restrict__ frame, const int64_t* __restrict__ point,
                          const float* __restrict__ meas, int model, float fx, float fy, float cx,
                          float cy, int64_t o, Obs& ob) {
    const float* T = poses + frame[o] * 16;
    const float* pw = points + point[o] * 3;
    float R[3][3], pc[3];
    for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) R[i][j] = T[i * 4 + j];
        pc[i] = ((R[i][0] * pw[0] + R[i][1] * pw[1]) + R[i][2] * pw[2]) + T[i * 4 + 3];
    }
    // -[pc]_x
    const float nsk[3][3] = {{0.f, pc[2], -pc[1]}, {-pc[2], 0.f, pc[0]}, {pc[1], -pc[0], 0.f}};
    if (model == 0) {
        const float z = pc[2];
        const float zs = z > 1e-6f ? z : 1.0f;
        const float u = pc[0] / zs * fx + cx;
        const float v = pc[1] / zs * fy + cy;
        ob.r[0] = u - meas[o * 2];
        ob.r[1] = v - meas[o * 2 + 1];
        ob.r[2] = 0.f;
        ob.w = z > 1e-6f ? 1.0f : 0.0f;
        const float iz = 1.0f / zs;
        const float Jpc[2][3] = {{fx * iz, 0.f, -fx * pc[0] * iz * iz}, {0.f, fy * iz, -fy * pc[1] * iz * iz}};
        for (int k = 0; k < 2; ++k) {
            for (int i = 0; i < 3; ++i) {
                ob.Jc[k][i] = Jpc[k][i];
                ob.Jc[k][3 + i] = (Jpc[k][0] * nsk[0][i] + Jpc[k][1] * nsk[1][i]) + Jpc[k][2] * nsk[2][i];
                ob.Jp[k][i] = (Jpc[k][0] * R[0][i] + Jpc[k][1] * R[1][i]) + Jpc[k][2] * R[2][i];
            }
        }
        ob.rows = 2;
    } else {
        const float* po = meas + o * 3;
        for (int i = 0; i < 3; ++i) ob.r[i] = pc[i] - po[i];
        const float zo = fmaxf(po[2], 0.f);
        const float dz = fmaxf(zo - 0.4f, 0.f);
        const float sigma = kSigmaA + kSigmaB * (dz * dz);
        const float rn = sqrtf((ob.r[0] * ob.r[0] + ob.r[1] * ob.r[1]) + ob.r[2] * ob.r[2]) / sigma;
        const float wh = fminf(kHuber / fmaxf(rn, 1e-9f), 1.0f);
        ob.w = wh / (sigma * sigma);
        for (int k = 0; k < 3; ++k) {
            for (int i = 0; i < 3; ++i) {
                ob.Jc[k][i] = k == i ? 1.f : 0.f;
                ob.Jc[k][3 + i] = nsk[k][i];
                ob.Jp[k][i] = R[k][i];
            }
        }
        ob.rows = 3;
    }
}

// 3x3 inverse by cofactors (the plain version's `inv3`, operation for operation)
__device__ void inv3(const float m[3][3], float out[3][3]) {
    const float c00 = m[1][1] * m[2][2] - m[1][2] * m[2][1];
    const float c01 = m[1][2] * m[2][0] - m[1][0] * m[2][2];
    const float c02 = m[1][0] * m[2][1] - m[1][1] * m[2][0];
    const float det = (m[0][0] * c00 + m[0][1] * c01) + m[0][2] * c02;
    out[0][0] = c00 / det;
    out[0][1] = (m[0][2] * m[2][1] - m[0][1] * m[2][2]) / det;
    out[0][2] = (m[0][1] * m[1][2] - m[0][2] * m[1][1]) / det;
    out[1][0] = c01 / det;
    out[1][1] = (m[0][0] * m[2][2] - m[0][2] * m[2][0]) / det;
    out[1][2] = (m[0][2] * m[1][0] - m[0][0] * m[1][2]) / det;
    out[2][0] = c02 / det;
    out[2][1] = (m[0][1] * m[2][0] - m[0][0] * m[2][1]) / det;
    out[2][2] = (m[0][0] * m[1][1] - m[0][1] * m[1][0]) / det;
}

// Launch A: one warp per point.
__global__ void __launch_bounds__(kWarpsA * 32)
ba_points_kernel(const float* __restrict__ poses, const float* __restrict__ points,
                 const int64_t* __restrict__ frame, const int64_t* __restrict__ point,
                 const float* __restrict__ meas, int model, const float* __restrict__ lam_p, float fx,
                 float fy, float cx, float cy, const int64_t* __restrict__ point_ptr,
                 const int64_t* __restrict__ point_obs, int P, float* __restrict__ Vinv_out,
                 float* __restrict__ bp_out, float* __restrict__ per_obs) {
    const int p = blockIdx.x * kWarpsA + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (p >= P) return;  // whole warps leave together
    const int64_t beg = point_ptr[p], end = point_ptr[p + 1];
    float V[3][3] = {}, bp[3] = {};
    for (int64_t q = beg + lane; q < end; q += 32) {
        const int64_t o = point_obs[q];
        Obs ob;
        linearize(poses, points, frame, point, meas, model, fx, fy, cx, cy, o, ob);
        float* rec = per_obs + o * kObsStride;
        float wJc[3][6], wJp[3][3];
        for (int k = 0; k < ob.rows; ++k) {
            for (int i = 0; i < 6; ++i) wJc[k][i] = ob.Jc[k][i] * ob.w;
            for (int i = 0; i < 3; ++i) wJp[k][i] = ob.Jp[k][i] * ob.w;
        }
        for (int i = 0; i < 6; ++i) {
            for (int j = 0; j < 3; ++j) {  // W_o
                float s = 0.f;
                for (int k = 0; k < ob.rows; ++k) s += wJc[k][i] * ob.Jp[k][j];
                rec[i * 3 + j] = s;
            }
            for (int j = 0; j < 6; ++j) {  // U_o
                float s = 0.f;
                for (int k = 0; k < ob.rows; ++k) s += wJc[k][i] * ob.Jc[k][j];
                rec[36 + i * 6 + j] = s;
            }
            float s = 0.f;  // g_o
            for (int k = 0; k < ob.rows; ++k) s += wJc[k][i] * ob.r[k];
            rec[72 + i] = s;
        }
        for (int i = 0; i < 3; ++i) {
            for (int j = 0; j < 3; ++j) {
                float s = 0.f;
                for (int k = 0; k < ob.rows; ++k) s += wJp[k][i] * ob.Jp[k][j];
                V[i][j] += s;
            }
            float s = 0.f;
            for (int k = 0; k < ob.rows; ++k) s += wJp[k][i] * ob.r[k];
            bp[i] += s;
        }
    }
    // xor butterfly: a + b == b + a, so every lane ends with the same sums
    for (int off = 16; off > 0; off >>= 1) {
        for (int i = 0; i < 3; ++i) {
            for (int j = 0; j < 3; ++j) V[i][j] += __shfl_xor_sync(0xffffffffu, V[i][j], off);
            bp[i] += __shfl_xor_sync(0xffffffffu, bp[i], off);
        }
    }
    const float lam = *lam_p;
    const float d = ((V[0][0] + V[1][1]) + V[2][2]) / 3.0f;
    const float base = 1e-6f * d + 1e-9f;
    for (int i = 0; i < 3; ++i) V[i][i] = V[i][i] + (lam * fabsf(V[i][i]) + base);
    float Vi[3][3];
    inv3(V, Vi);
    if (lane == 0) {
        for (int i = 0; i < 3; ++i) {
            for (int j = 0; j < 3; ++j) Vinv_out[p * 9 + i * 3 + j] = Vi[i][j];
            bp_out[p * 3 + i] = bp[i];
        }
    }
    for (int64_t q = beg + lane; q < end; q += 32) {
        float* rec = per_obs + point_obs[q] * kObsStride;
        for (int i = 0; i < 6; ++i) {
            const float w0 = rec[i * 3], w1 = rec[i * 3 + 1], w2 = rec[i * 3 + 2];
            for (int l = 0; l < 3; ++l) rec[18 + i * 3 + l] = (w0 * Vi[0][l] + w1 * Vi[1][l]) + w2 * Vi[2][l];
        }
    }
}

// Launch B: one CTA per frame; S's rows 6f..6f+5 in shared memory.
__global__ void __launch_bounds__(kThreadsB)
ba_frames_kernel(const int64_t* __restrict__ frame, const int64_t* __restrict__ point,
                 const float* __restrict__ lam_p, const int64_t* __restrict__ frame_ptr,
                 const int64_t* __restrict__ frame_obs, const int64_t* __restrict__ point_ptr,
                 const int64_t* __restrict__ point_obs, int F, const float* __restrict__ bp,
                 const float* __restrict__ per_obs, float* __restrict__ S, float* __restrict__ rhs) {
    extern __shared__ float smem[];
    const int f = blockIdx.x;
    const int n = 6 * F;  // strip row length
    float* strip = smem;  // [6][6F]
    float* Us = smem + 6 * n;  // [36]
    const int tid = threadIdx.x;
    for (int i = tid; i < 6 * n; i += kThreadsB) strip[i] = 0.f;
    __syncthreads();
    const int64_t beg = frame_ptr[f], end = frame_ptr[f + 1];
    constexpr int kGroups = kThreadsB / 36;
    const int grp = tid / 36, e = tid % 36, bi = e / 6, bj = e % 6;
    if (grp < kGroups) {
        for (int64_t a = beg; a < end; ++a) {
            const int64_t o1 = frame_obs[a];
            const float* y = per_obs + o1 * kObsStride + 18 + bi * 3;
            const float y0 = y[0], y1 = y[1], y2 = y[2];
            const int64_t p = point[o1];
            for (int64_t b = point_ptr[p]; b < point_ptr[p + 1]; ++b) {
                const int64_t o2 = point_obs[b];
                const int64_t g = frame[o2];
                if (g % kGroups != grp) continue;
                const float* w = per_obs + o2 * kObsStride + bj * 3;
                strip[bi * n + 6 * g + bj] -= (y0 * w[0] + y1 * w[1]) + y2 * w[2];
            }
        }
    }
    if (tid < 36) {  // U_f, entry e
        float u = 0.f;
        for (int64_t a = beg; a < end; ++a) u += per_obs[frame_obs[a] * kObsStride + 36 + e];
        Us[e] = u;
    } else if (tid < 42) {  // rhs_c, row i
        const int i = tid - 36;
        float bc = 0.f, yb = 0.f;
        for (int64_t a = beg; a < end; ++a) {
            const int64_t o = frame_obs[a];
            const float* rec = per_obs + o * kObsStride;
            const float* b = bp + point[o] * 3;
            bc += rec[72 + i];
            yb += (rec[18 + i * 3] * b[0] + rec[18 + i * 3 + 1] * b[1]) + rec[18 + i * 3 + 2] * b[2];
        }
        rhs[6 * f + i] = bc - yb;
    }
    __syncthreads();
    if (tid < 36) {
        const float d = (((((Us[0] + Us[7]) + Us[14]) + Us[21]) + Us[28]) + Us[35]) / 6.0f;
        float u = Us[e];
        if (bi == bj) u = u + (*lam_p * fabsf(u) + (1e-6f * d + 1e-9f));
        strip[bi * n + 6 * f + bj] += u;
    }
    __syncthreads();
    for (int i = tid; i < 6 * n; i += kThreadsB) S[(int64_t)(6 * f + i / n) * n + i % n] = strip[i];
}

// Launch C: one thread per point.
__global__ void __launch_bounds__(kThreadsC)
ba_back_substitute_kernel(const int64_t* __restrict__ frame, const int64_t* __restrict__ point_ptr,
                          const int64_t* __restrict__ point_obs, const float* __restrict__ per_obs,
                          const float* __restrict__ Vinv, const float* __restrict__ bp,
                          const float* __restrict__ dc, int P, float* __restrict__ dp) {
    const int p = blockIdx.x * kThreadsC + threadIdx.x;
    if (p >= P) return;
    float t[3] = {};
    for (int64_t q = point_ptr[p]; q < point_ptr[p + 1]; ++q) {
        const int64_t o = point_obs[q];
        const float* W = per_obs + o * kObsStride;
        const float* x = dc + 6 * frame[o];
        for (int j = 0; j < 3; ++j) {
            float s = 0.f;
            for (int i = 0; i < 6; ++i) s += W[i * 3 + j] * x[i];
            t[j] += s;
        }
    }
    float v[3];
    for (int j = 0; j < 3; ++j) v[j] = bp[p * 3 + j] + t[j];
    const float* M = Vinv + p * 9;
    for (int i = 0; i < 3; ++i) dp[p * 3 + i] = -((M[i * 3] * v[0] + M[i * 3 + 1] * v[1]) + M[i * 3 + 2] * v[2]);
}

}  // namespace

extern "C" int ba_schur(const float* poses, const float* points, const int64_t* frame, const int64_t* point,
                        const float* meas, int model, const float* lam, float fx, float fy, float cx, float cy,
                        const int64_t* frame_ptr, const int64_t* frame_obs, const int64_t* point_ptr,
                        const int64_t* point_obs, int F, int P, int O, float* S, float* rhs, float* Vinv,
                        float* bp, float* per_obs, cudaStream_t stream) {
    (void)O;
    ba_points_kernel<<<(P + kWarpsA - 1) / kWarpsA, kWarpsA * 32, 0, stream>>>(
        poses, points, frame, point, meas, model, lam, fx, fy, cx, cy, point_ptr, point_obs, P, Vinv, bp, per_obs);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t smem = (size_t)(36 * F + 36) * sizeof(float);
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(ba_frames_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    ba_frames_kernel<<<F, kThreadsB, smem, stream>>>(frame, point, lam, frame_ptr, frame_obs, point_ptr, point_obs, F,
                                                     bp, per_obs, S, rhs);
    return cudaGetLastError();
}

extern "C" int ba_back_substitute(const int64_t* frame, const int64_t* point_ptr, const int64_t* point_obs,
                                  const float* per_obs, const float* Vinv, const float* bp, const float* dc, int P,
                                  float* dp, cudaStream_t stream) {
    ba_back_substitute_kernel<<<(P + kThreadsC - 1) / kThreadsC, kThreadsC, 0, stream>>>(
        frame, point_ptr, point_obs, per_obs, Vinv, bp, dc, P, dp);
    return cudaGetLastError();
}
