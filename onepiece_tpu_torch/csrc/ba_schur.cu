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
// (f, g) = -sum over the points p that f and g share of (sum of Y_o1 over
// f's observations of p) (sum of W_o2 over g's observations of p)^T, plus
// damp(sum U_o) on the diagonal block, and rhs_c,f = sum g_o - sum Y_o b_p.
// Two observations of one point in one frame give the same sums as the
// dense form: (W1 + W2) V^-1 (W1 + W2)^T expands to the pairs.
// damp(M) adds lam |M_ii| + (1e-6 tr(M) / n + 1e-9) to each diagonal entry.
//
// What bounds it on Hopper: neither rate. A pair of observations of one
// point costs 216 float operations (a 6x6 block of 3-term dots), an
// observation ~700, and the inputs are a few hundred kilobytes; the S
// written is 36 F^2 floats (2.4 MB at F = 128, 0.6 GB at F = 2,048). At the
// path's sizes (a few thousand observations, F = 64-128, a few dozen live
// keyframes) that is about a microsecond of bytes. What the time is made
// of: chains of dependent loads (list -> observation -> its row), each
// several hundred cycles, and the load/store unit's throughput where every
// lane gathers its own row (each scalar load of a warp then touches 32
// lines). Only at F = 2,048 does the S write itself bound it. The design:
//   - No atomics. Every sum is taken in a fixed order (the observation
//     lists are stable sorts made once per LM loop on the device, and
//     every cross-lane sum is a fixed xor pattern), so two calls are
//     bit-equal.
//   - float32 on the CUDA cores. A block is 6x6 with a depth of 3 per shared
//     point, far below an mma tile, and TF32, the only float32 path into
//     the tensor cores, keeps about 3 digits: outside the 1e-4 the reduced
//     system is held to.
//   - Per-observation rows of 84 floats (W_o, Y_o, U_o, g_o, each at a
//     16-byte boundary), moved by float4 loads and stores: a quarter of the
//     load/store instructions of scalar rows.
//   - Launch A (ba_points_kernel), one warp per point: the lanes take the
//     point's observations lane-strided, linearise them (every loop over
//     the 2 or 3 residual rows has constant bounds, so nothing spills to
//     local memory), write W_o, U_o and g_o, and reduce V and b_p with an
//     xor butterfly (every lane ends with the same sum); each lane inverts
//     the damped V by cofactors (no LU, no host check) and writes Y_o from
//     the W_o it kept in registers. A point with no observation damps to
//     1e-9 I, as in the dense form, and its step is 0.
//   - Launch B (ba_blocks_kernel), one 512-thread CTA per frame f of the
//     capacity, writing S's rows 6f..6f+5 straight to device memory: no
//     strip in shared memory, so F is limited by device memory alone. A
//     frame with no observation writes its zero strip and its damped
//     diagonal (1e-9) and stops. A live frame stages its observations, in
//     chunks of kChunk, as (point, observation) keys sorted by point and
//     their Y rows (loaded into registers, then stored to shared memory:
//     the rows are gathered by observation index). Warps 2-15 take the
//     live frames g (`live_frames`, made with the lists) as columns; a
//     warp's lanes take g's observations (sorted by point) 32 x 4 at a
//     time, all loads in flight together, find each one's point in f's
//     keys by binary lifting in shared memory (a run of equal keys: two
//     observations of one point in f), then serve their hits in rounds,
//     one hit per lane a round (not one entry slot at a time), keeping the
//     block's 36 partial sums in registers. A reduce-scatter over xor
//     partners merges the lanes (62 shuffles, a third of a butterfly's,
//     spelled out so that it stays in registers) and 18 lanes write the
//     block; a column with no shared point writes nothing over the zeros.
//     Each walker loads its next column's list bounds while it walks the
//     current one. Warps 0-1 sum U_f, b_c,f and Y b_p over f's staged
//     observations into thread-private shared memory; warp 0 merges them
//     by the same reduce-scatter, damps U_f and adds it to the diagonal
//     block last.
//   - Launch C (ba_back_substitute_kernel), one warp per point: its
//     observations lane-strided, W_o^T dc_f summed by the butterfly,
//     dp = -V^-1 (b_p + sum W_o^T dc_f).
// Built with --fmad=false, as every kernel of the port: the per-observation
// arithmetic rounds as the plain version's separate operations do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kSigmaA = 0.0015f;  // m
constexpr float kSigmaB = 0.0019f;  // m^-1
constexpr float kHuber = 3.0f;
// A row of 84 floats per observation, each part at a 16-byte boundary so
// that it moves in vector loads and stores: W_o (18), Y_o (18), U_o (36), g_o (6)
constexpr int kW = 0, kY = 20, kU = 40, kG = 76, kObsStride = 84;
constexpr int kWarpsA = 8;
constexpr int kThreadsB = 16 * 32;
constexpr int kWalkers = 14;  // warps 2-15 of launch B; warps 0-1 sum U_f and rhs_c,f
constexpr int kChunk = 448;  // observations of f staged at once
constexpr int kUnroll = 4;  // entries of a column a lane searches at once
constexpr int kWarpsC = 8;
constexpr unsigned kFull = 0xffffffffu;

struct Obs {
    float r[3];
    float Jc[3][6];
    float Jp[3][3];
    float w;
    int rows;
};

// N floats (N even) to or from a 16-byte aligned address, 4 at a time
template <int N>
__device__ void load_row(const float* __restrict__ p, float (&v)[N]) {
#pragma unroll
    for (int i = 0; i + 4 <= N; i += 4) {
        const float4 x = *reinterpret_cast<const float4*>(p + i);
        v[i] = x.x, v[i + 1] = x.y, v[i + 2] = x.z, v[i + 3] = x.w;
    }
    if (N % 4) {
        const float2 x = *reinterpret_cast<const float2*>(p + N - 2);
        v[N - 2] = x.x, v[N - 1] = x.y;
    }
}

template <int N>
__device__ void store_row(float* __restrict__ p, const float (&v)[N]) {
#pragma unroll
    for (int i = 0; i + 4 <= N; i += 4) *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    if (N % 4) *reinterpret_cast<float2*>(p + N - 2) = make_float2(v[N - 2], v[N - 1]);
}

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
        for (int i = 0; i < 6; ++i) ob.Jc[2][i] = 0.f;
        for (int i = 0; i < 3; ++i) ob.Jp[2][i] = 0.f;
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

// Observation o's W, U_o and g_o into its row `rec`, W also into `W`; its
// V_o and e_o added to V and bp.
__device__ void observation_terms(const float* __restrict__ poses, const float* __restrict__ points,
                                  const int64_t* __restrict__ frame, const int64_t* __restrict__ point,
                                  const float* __restrict__ meas, int model, float fx, float fy, float cx,
                                  float cy, int64_t o, float* __restrict__ rec, float (&W)[18], float V[3][3],
                                  float bp[3]) {
    Obs ob;
    linearize(poses, points, frame, point, meas, model, fx, fy, cx, cy, o, ob);
    // every loop over the rows k runs to 3 and skips k >= rows: constant
    // indices keep Obs in registers
    float wJc[3][6], wJp[3][3], U[36], g[6];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        for (int i = 0; i < 6; ++i) wJc[k][i] = ob.Jc[k][i] * ob.w;
        for (int i = 0; i < 3; ++i) wJp[k][i] = ob.Jp[k][i] * ob.w;
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {  // W_o
            float s = 0.f;
#pragma unroll
            for (int k = 0; k < 3; ++k)
                if (k < ob.rows) s += wJc[k][i] * ob.Jp[k][j];
            W[i * 3 + j] = s;
        }
#pragma unroll
        for (int j = 0; j < 6; ++j) {  // U_o
            float s = 0.f;
#pragma unroll
            for (int k = 0; k < 3; ++k)
                if (k < ob.rows) s += wJc[k][i] * ob.Jc[k][j];
            U[i * 6 + j] = s;
        }
        float s = 0.f;  // g_o
#pragma unroll
        for (int k = 0; k < 3; ++k)
            if (k < ob.rows) s += wJc[k][i] * ob.r[k];
        g[i] = s;
    }
    store_row(rec + kW, W);
    store_row(rec + kU, U);
    store_row(rec + kG, g);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            float s = 0.f;
#pragma unroll
            for (int k = 0; k < 3; ++k)
                if (k < ob.rows) s += wJp[k][i] * ob.Jp[k][j];
            V[i][j] += s;
        }
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < 3; ++k)
            if (k < ob.rows) s += wJp[k][i] * ob.r[k];
        bp[i] += s;
    }
}

// Y_o = W_o V^-1 into the row `rec`.
__device__ void write_Y(const float (&W)[18], const float Vi[3][3], float* __restrict__ rec) {
    float Y[18];
    for (int i = 0; i < 6; ++i) {
        for (int l = 0; l < 3; ++l)
            Y[i * 3 + l] = (W[i * 3] * Vi[0][l] + W[i * 3 + 1] * Vi[1][l]) + W[i * 3 + 2] * Vi[2][l];
    }
    store_row(rec + kY, Y);
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

// xor butterfly over the warp: a + b == b + a, so every lane ends with the same N sums
template <int N>
__device__ void warp_sum(float (&v)[N]) {
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(kFull, v[i], off);
    }
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
    const int64_t q0 = beg + lane;
    const int64_t o0 = q0 < end ? point_obs[q0] : 0;
    float V[3][3] = {}, bp[3] = {};
    float W0[18];  // W of the lane's first observation, kept for its Y
    if (q0 < end)
        observation_terms(poses, points, frame, point, meas, model, fx, fy, cx, cy, o0, per_obs + o0 * kObsStride,
                          W0, V, bp);
    for (int64_t q = q0 + 32; q < end; q += 32) {
        const int64_t o = point_obs[q];
        float W[18];
        observation_terms(poses, points, frame, point, meas, model, fx, fy, cx, cy, o, per_obs + o * kObsStride, W,
                          V, bp);
    }
    float vb[12];
    for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) vb[i * 3 + j] = V[i][j];
        vb[9 + i] = bp[i];
    }
    warp_sum(vb);
    for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) V[i][j] = vb[i * 3 + j];
    }
    const float lam = *lam_p;
    const float d = ((V[0][0] + V[1][1]) + V[2][2]) / 3.0f;
    const float base = 1e-6f * d + 1e-9f;
    for (int i = 0; i < 3; ++i) V[i][i] = V[i][i] + (lam * fabsf(V[i][i]) + base);
    float Vi[3][3];
    inv3(V, Vi);
#pragma unroll
    for (int e = 0; e < 12; ++e) {  // lane e writes entry e: V^-1, then b_p
        if (lane == e) {
            if (e < 9) Vinv_out[p * 9 + e] = Vi[e / 3][e % 3];
            else bp_out[p * 3 + e - 9] = vb[e];
        }
    }
    if (q0 < end) write_Y(W0, Vi, per_obs + o0 * kObsStride);
    for (int64_t q = q0 + 32; q < end; q += 32) {
        float* rec = per_obs + point_obs[q] * kObsStride;
        float W[18];
        load_row(rec + kW, W);
        write_Y(W, Vi, rec);
    }
}

// One step of warp_reduce_scatter: lanes keep the half of their 4 OFF
// entries that bit OFF of the lane selects, adding the partner's.
template <int OFF>
__device__ __forceinline__ void reduce_scatter_step(float (&a)[64], int lane) {
    const bool up = lane & OFF;
#pragma unroll
    for (int i = 0; i < 2 * OFF; ++i) {
        const float send = up ? a[i] : a[i + 2 * OFF];
        const float keep = up ? a[i + 2 * OFF] : a[i];
        a[i] = keep + __shfl_xor_sync(kFull, send, OFF);
    }
}

// Merges the 32 lanes' N <= 64 partial sums by a reduce-scatter over xor
// partners (62 shuffles, against 5 N for a butterfly): lane L ends with the
// sums of entries 2L and 2L + 1 (0 past N), each in a fixed order. The
// steps are spelled out so that every index is a constant and `a` stays in
// registers.
template <int N>
__device__ void warp_reduce_scatter(const float (&v)[N], int lane, float& lo, float& hi) {
    float a[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) a[i] = i < N ? v[i] : 0.f;
    reduce_scatter_step<16>(a, lane);
    reduce_scatter_step<8>(a, lane);
    reduce_scatter_step<4>(a, lane);
    reduce_scatter_step<2>(a, lane);
    reduce_scatter_step<1>(a, lane);
    lo = a[0];
    hi = a[1];
}

// A live column g of launch B: its list [b0, b1) and where its block goes.
struct Column {
    int64_t g, b0, b1;
};

__device__ Column column(const int64_t* __restrict__ frame_ptr, const int64_t* __restrict__ live_frames, int j,
                         int n_live) {
    if (j >= n_live) return {0, 0, 0};
    const int64_t g = live_frames[j];
    return {g, frame_ptr[g], frame_ptr[g + 1]};
}

// Launch B, warps 0 and 1 (lanes t = 0..63): this chunk's U_o, g_o and
// Y_o b_p summed per t into column t of `acc` (48 rows of 64 floats).
__device__ void frame_terms(const int* __restrict__ s_key, const int* __restrict__ s_obs, const float* __restrict__ s_Y,
                            int n, const float* __restrict__ bp, const float* __restrict__ per_obs,
                            float* __restrict__ acc, int t) {
    float u[36] = {}, gs[6] = {}, ys[6] = {};
#pragma unroll 2
    for (int i = t; i < n; i += 2 * 32) {
        const float* rec = per_obs + (int64_t)s_obs[i] * kObsStride;
        const float* b = bp + (int64_t)s_key[i] * 3;
        const float* y = s_Y + i * 18;
        float uo[36], go[6];
        load_row(rec + kU, uo);
        load_row(rec + kG, go);
        for (int k = 0; k < 36; ++k) u[k] += uo[k];
        for (int k = 0; k < 6; ++k) {
            gs[k] += go[k];
            ys[k] += (y[k * 3] * b[0] + y[k * 3 + 1] * b[1]) + y[k * 3 + 2] * b[2];
        }
    }
    for (int k = 0; k < 36; ++k) acc[k * 64 + t] += u[k];
    for (int k = 0; k < 6; ++k) {
        acc[(36 + k) * 64 + t] += gs[k];
        acc[(42 + k) * 64 + t] += ys[k];
    }
}

// Launch B, warps 2..: the blocks (f, g) of the live columns j = warp - 2,
// warp - 2 + kWalkers, ..., over this chunk of f's keys; `col` is the first
// one's, loaded before the chunk was staged.
__device__ void column_blocks(const int* __restrict__ s_key, const float* __restrict__ s_Y, int n, bool first,
                              Column col, const int64_t* __restrict__ frame_ptr, const int64_t* __restrict__ frame_obs,
                              const int64_t* __restrict__ frame_point, const int64_t* __restrict__ live_frames,
                              int n_live, const float* __restrict__ per_obs, float* __restrict__ rows, int64_t n6,
                              int warp, int lane) {
    const int top = 1 << (31 - __clz(n));  // the largest power of two <= n
    for (int j = warp - 2; j < n_live; j += kWalkers) {
        const Column next = column(frame_ptr, live_frames, j + kWalkers, n_live);  // in flight meanwhile
        float acc[36] = {};
        bool hit = false;
        for (int64_t base = col.b0; base < col.b1; base += 32 * kUnroll) {  // the same rounds for every lane
            int q[kUnroll], pos[kUnroll];
            int64_t o2[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {  // the loads of all kUnroll entries in flight together
                const int64_t b = base + 32 * u + lane;
                q[u] = b < col.b1 ? (int)frame_point[b] : -1;
                o2[u] = b < col.b1 ? frame_obs[b] : 0;
                pos[u] = 0;
            }
            // pos = the number of f's keys below q (binary lifting; the steps
            // are the same for every lane and entry)
            for (int step = top; step > 0; step >>= 1) {
#pragma unroll
                for (int u = 0; u < kUnroll; ++u)
                    if (pos[u] + step <= n && s_key[pos[u] + step - 1] < q[u]) pos[u] += step;
            }
            unsigned pending = 0;  // the lane's entries whose point f has
#pragma unroll
            for (int u = 0; u < kUnroll; ++u)
                if (q[u] >= 0 && pos[u] < n && s_key[pos[u]] == q[u]) pending |= 1u << u;
            hit |= pending != 0;
            // each lane takes its own hits one a round, so a round serves every
            // lane that has one left (not one entry index at a time)
            while (__any_sync(kFull, pending)) {
                if (!pending) continue;
                const int v = __ffs(pending) - 1;
                pending &= pending - 1;
                int qv = q[0], pv = pos[0];
                int64_t ov = o2[0];
#pragma unroll
                for (int u = 1; u < kUnroll; ++u) {
                    if (v == u) {
                        qv = q[u];
                        pv = pos[u];
                        ov = o2[u];
                    }
                }
                float w[18];
                load_row(per_obs + ov * kObsStride + kW, w);
                for (int i = pv; i < n && s_key[i] == qv; ++i) {  // f's observations of this point
                    const float* y = s_Y + i * 18;
                    for (int a = 0; a < 6; ++a) {
                        for (int c = 0; c < 6; ++c)
                            acc[a * 6 + c] += (y[a * 3] * w[c * 3] + y[a * 3 + 1] * w[c * 3 + 1]) +
                                              y[a * 3 + 2] * w[c * 3 + 2];
                    }
                }
            }
        }
        if (__any_sync(kFull, hit)) {  // else no shared point: the zeros stand
            float lo, hi;
            warp_reduce_scatter(acc, lane, lo, hi);
            if (lane < 18) {  // entries 2 lane, 2 lane + 1: row lane / 3, columns 2 (lane % 3) + 0, 1
                float* s = rows + (lane / 3) * n6 + 6 * col.g + 2 * (lane % 3);
                s[0] = (first ? 0.f : s[0]) - lo;
                s[1] = (first ? 0.f : s[1]) - hi;
            }
        }
        col = next;
    }
}

// Launch B: one CTA per frame f, S's rows 6f..6f+5 and rhs_c,f.
__global__ void __launch_bounds__(kThreadsB)
ba_blocks_kernel(const float* __restrict__ lam_p, const int64_t* __restrict__ frame_ptr,
                 const int64_t* __restrict__ frame_obs, const int64_t* __restrict__ frame_point,
                 const int64_t* __restrict__ live_frames, const int64_t* __restrict__ num_live, int F,
                 const float* __restrict__ bp, const float* __restrict__ per_obs, float* __restrict__ S,
                 float* __restrict__ rhs) {
    __shared__ int s_key[kChunk];  // f's points, ascending
    __shared__ int s_obs[kChunk];  // their observations
    __shared__ float s_Y[kChunk * 18];  // their Y rows
    __shared__ float s_acc[48 * 64];  // warps 0-1: U_f, b_c,f, Y b_p, a column per thread
    const int f = blockIdx.x;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int64_t beg = frame_ptr[f], end = frame_ptr[f + 1];
    const int n_live = (int)*num_live;
    const Column col = warp > 1 && beg < end ? column(frame_ptr, live_frames, warp - 2, n_live) : Column{0, 0, 0};
    const int64_t n6 = 6 * (int64_t)F;  // a row of S
    float* rows = S + 6 * f * n6;
    for (int64_t i = tid; i < 6 * n6; i += kThreadsB) rows[i] = 0.f;
    if (warp < 2) {
        for (int k = 0; k < 48; ++k) s_acc[k * 64 + tid] = 0.f;
    }
    for (int64_t c0 = beg; c0 < end; c0 += kChunk) {
        const int n = (int)(end - c0 < kChunk ? end - c0 : kChunk);
        if (c0 != beg) __syncthreads();  // the last chunk's readers are done
        for (int i = tid; i < n; i += kThreadsB) {
            const int64_t o = frame_obs[c0 + i];
            s_key[i] = (int)frame_point[c0 + i];
            s_obs[i] = (int)o;
            float y[18];
            load_row(per_obs + o * kObsStride + kY, y);
            for (int k = 0; k < 18; ++k) s_Y[i * 18 + k] = y[k];
        }
        __syncthreads();
        if (warp < 2)
            frame_terms(s_key, s_obs, s_Y, n, bp, per_obs, s_acc, tid);
        else
            column_blocks(s_key, s_Y, n, c0 == beg, col, frame_ptr, frame_obs, frame_point, live_frames, n_live,
                          per_obs, rows, n6, warp, lane);
    }
    __syncthreads();  // the blocks are written (or the zeros, for a frame with no observation)
    if (warp != 0) return;
    float t[48], lo, hi;
    for (int k = 0; k < 48; ++k) t[k] = s_acc[k * 64 + lane] + s_acc[k * 64 + 32 + lane];
    warp_reduce_scatter(t, lane, lo, hi);  // lane L: entries 2L, 2L + 1 of U_f (L < 18), b_c,f (18-20), Y b_p (21-23)
    // the trace of U_f: entries 0, 7, 14, 21, 28, 35 at lanes 0, 3, 7, 10, 14, 17
    const float d = (((((__shfl_sync(kFull, lo, 0) + __shfl_sync(kFull, hi, 3)) + __shfl_sync(kFull, lo, 7)) +
                       __shfl_sync(kFull, hi, 10)) + __shfl_sync(kFull, lo, 14)) + __shfl_sync(kFull, hi, 17)) / 6.0f;
    const float y_lo = __shfl_down_sync(kFull, lo, 3), y_hi = __shfl_down_sync(kFull, hi, 3);
    if (lane < 18) {
        const float lam = *lam_p, base = 1e-6f * d + 1e-9f;
        const int e = 2 * lane, r = e / 6, c = e % 6;  // entries (r, c) and (r, c + 1)
        float u0 = lo, u1 = hi;
        if (r == c) u0 = u0 + (lam * fabsf(u0) + base);
        if (r == c + 1) u1 = u1 + (lam * fabsf(u1) + base);
        float* s = rows + r * n6 + 6 * f + c;
        s[0] = s[0] + u0;
        s[1] = s[1] + u1;
    } else if (lane < 21) {
        rhs[6 * f + 2 * (lane - 18)] = lo - y_lo;
        rhs[6 * f + 2 * (lane - 18) + 1] = hi - y_hi;
    }
}

// Launch C: one warp per point.
__global__ void __launch_bounds__(kWarpsC * 32)
ba_back_substitute_kernel(const int64_t* __restrict__ frame, const int64_t* __restrict__ point_ptr,
                          const int64_t* __restrict__ point_obs, const float* __restrict__ per_obs,
                          const float* __restrict__ Vinv, const float* __restrict__ bp,
                          const float* __restrict__ dc, int P, float* __restrict__ dp) {
    const int p = blockIdx.x * kWarpsC + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (p >= P) return;  // whole warps leave together
    float t[3] = {};
    for (int64_t q = point_ptr[p] + lane; q < point_ptr[p + 1]; q += 32) {
        const int64_t o = point_obs[q];
        float W[18];
        load_row(per_obs + o * kObsStride + kW, W);
        const float* x = dc + 6 * frame[o];
        for (int j = 0; j < 3; ++j) {
            float s = 0.f;
            for (int i = 0; i < 6; ++i) s += W[i * 3 + j] * x[i];
            t[j] += s;
        }
    }
    warp_sum(t);
    float v[3];
    for (int j = 0; j < 3; ++j) v[j] = bp[p * 3 + j] + t[j];
    const float* M = Vinv + p * 9;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        if (lane == i) dp[p * 3 + i] = -((M[i * 3] * v[0] + M[i * 3 + 1] * v[1]) + M[i * 3 + 2] * v[2]);
    }
}

}  // namespace

extern "C" int ba_schur(const float* poses, const float* points, const int64_t* frame, const int64_t* point,
                        const float* meas, int model, const float* lam, float fx, float fy, float cx, float cy,
                        const int64_t* frame_ptr, const int64_t* frame_obs, const int64_t* point_ptr,
                        const int64_t* point_obs, const int64_t* frame_point, const int64_t* live_frames,
                        const int64_t* num_live, int F, int P, float* S, float* rhs, float* Vinv, float* bp,
                        float* per_obs, cudaStream_t stream) {
    ba_points_kernel<<<(P + kWarpsA - 1) / kWarpsA, kWarpsA * 32, 0, stream>>>(
        poses, points, frame, point, meas, model, lam, fx, fy, cx, cy, point_ptr, point_obs, P, Vinv, bp, per_obs);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ba_blocks_kernel<<<F, kThreadsB, 0, stream>>>(lam, frame_ptr, frame_obs, frame_point, live_frames, num_live, F,
                                                  bp, per_obs, S, rhs);
    return cudaGetLastError();
}

extern "C" int ba_back_substitute(const int64_t* frame, const int64_t* point_ptr, const int64_t* point_obs,
                                  const float* per_obs, const float* Vinv, const float* bp, const float* dc, int P,
                                  float* dp, cudaStream_t stream) {
    ba_back_substitute_kernel<<<(P + kWarpsC - 1) / kWarpsC, kWarpsC * 32, 0, stream>>>(
        frame, point_ptr, point_obs, per_obs, Vinv, bp, dc, P, dp);
    return cudaGetLastError();
}
