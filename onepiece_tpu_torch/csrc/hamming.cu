// Hamming distances of 256-bit binary descriptors: descriptor matching and
// the MILD loop-closure feature scores.
//
// Replaces: onepiece_tpu/ops/hamming.py:41 hamming_table (XLA, not Pallas: a
// +-1 bf16 matmul on the MXU) and its consumers :52 match_descriptors, :78
// match_descriptors_windowed and lcdetection/mild.py:55 _similarity_scores.
//
// What it computes. Descriptors are 8 words of 32 bits (int32 in the port,
// the JAX package's uint32 words bit for bit); d(a, b) = sum over the words
// of __popc(a ^ b).
//   hamming_match: per query, over the M targets in index order, the best
//     target (lowest index on ties), the best distance and the second
//     distance (the second entry of the sorted row: equal to the best on a
//     tie, as `top_k(-d, 2)` gives it). A target that is invalid, or
//     outside the query's window when one is given (|du| <= w and |dv| <= w
//     with du = uv_pred - uv_b in float32), counts as 257.
//   hamming_table: the whole (N, M) int32 table.
//   mild_feature_scores: fs[n, k] = sum over f of lut[d(q_n, db_kf)] where
//     db_valid[k, f], k < g and d < 64, and 0 where q_valid[n] is false;
//     lut holds exp(-max(d, 10)^2 / 900) as the host computed it, so every
//     term is bit-equal to the plain version's (the sums run in f order).
//
// What bounds it on Hopper: the popcounts. A pair costs 8 XOR, 8 __popc and
// 7 adds; the inputs are 32 bytes a descriptor (the MILD database at 128
// keyframes x 1000 features is 4 MB), the outputs 12 bytes a query or 4
// bytes a (query, keyframe). __popc issues at 16 a clock on an SM, a
// quarter of the integer ALU rate, so it sets the bound.
//
// Design: a thread per query keeps the query's 8 words in registers and a
// running best / second; the targets (or one keyframe's features) stream
// through shared memory in tiles, and every thread of the block reads the
// same target at once (a broadcast, no bank conflicts). Nothing of the
// distance table is written except by hamming_table. mild_feature_scores
// runs a 2-d grid of (query block, keyframe) CTAs; a CTA of a keyframe at or
// past g (read from device memory) writes zeros and returns, so growing the
// database needs no host read. A simple kernel: speed work (more queries a
// thread, TMA tiles) is for later.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;      // queries per hamming_match block
constexpr int kTile = 512;        // targets per shared tile (16 KB of words)
constexpr int kMildThreads = 128;  // queries per mild_feature_scores block
constexpr int kMasked = 257;      // HAMMING_MAX + 1
constexpr int kLut = 64;          // MILD: distances below 64 contribute
constexpr int kBig = 0x7fffffff;

__device__ __forceinline__ int distance(const int (&q)[8], const int* t) {
  int d = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) d += __popc(static_cast<unsigned>(q[w] ^ t[w]));
  return d;
}

__global__ void __launch_bounds__(kThreads) hamming_match_kernel(
    const int* __restrict__ a,             // (N, 8)
    const int* __restrict__ b,             // (M, 8)
    const unsigned char* __restrict__ vb,  // (M,) bool
    const float* __restrict__ uv_pred,     // (N, 2) or null
    const float* __restrict__ uv_b,        // (M, 2) or null
    float window, int n, int m,
    int* __restrict__ best_out,   // (N,)
    int* __restrict__ dist_out) {  // (2, N): best, second
  __shared__ int tw[kTile * 8];
  __shared__ float tuv[kTile * 2];
  __shared__ unsigned char tv[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool windowed = uv_pred != nullptr;
  int q[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) q[w] = i < n ? a[i * 8 + w] : 0;
  float pu = 0.f, pv = 0.f;
  if (windowed && i < n) {
    pu = uv_pred[i * 2];
    pv = uv_pred[i * 2 + 1];
  }
  int best = kBig, second = kBig, arg = 0;
  for (int base = 0; base < m; base += kTile) {
    const int count = min(kTile, m - base);
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < count * 8; e += kThreads) tw[e] = b[base * 8 + e];
    for (int e = threadIdx.x; e < count; e += kThreads) tv[e] = vb[base + e];
    if (windowed)
      for (int e = threadIdx.x; e < count * 2; e += kThreads) tuv[e] = uv_b[base * 2 + e];
    __syncthreads();
    for (int j = 0; j < count; ++j) {
      bool use = tv[j] != 0;
      if (windowed) use = use && fabsf(pu - tuv[2 * j]) <= window && fabsf(pv - tuv[2 * j + 1]) <= window;
      const int d = use ? distance(q, &tw[j * 8]) : kMasked;
      // strict < over increasing indices: the lowest index wins a tie, and a
      // tie with the best moves it into second
      if (d < best) {
        second = best;
        best = d;
        arg = base + j;
      } else if (d < second) {
        second = d;
      }
    }
  }
  if (i < n) {
    best_out[i] = arg;
    dist_out[i] = best;
    dist_out[n + i] = second;
  }
}

__global__ void hamming_table_kernel(const int* __restrict__ a, const int* __restrict__ b, int n, int m,
                                     int* __restrict__ out) {  // (N, M)
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  if (j >= m) return;
  int q[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) q[w] = a[i * 8 + w];
  int t[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) t[w] = b[j * 8 + w];
  out[static_cast<long long>(i) * m + j] = distance(q, t);
}

__global__ void __launch_bounds__(kMildThreads) mild_feature_scores_kernel(
    const int* __restrict__ q_desc,             // (N, 8)
    const unsigned char* __restrict__ q_valid,  // (N,)
    const int* __restrict__ db,                 // (N_CAP, F, 8)
    const unsigned char* __restrict__ db_valid,  // (N_CAP, F)
    const int* __restrict__ g,                  // () keyframes in use
    const float* __restrict__ lut,              // (64,)
    int n, int n_cap, int f,
    float* __restrict__ fs) {  // (N, N_CAP)
  __shared__ int tw[kTile * 8];
  __shared__ unsigned char tv[kTile];
  __shared__ float slut[kLut];
  const int i = blockIdx.x * kMildThreads + threadIdx.x;
  const int k = blockIdx.y;
  if (k >= *g) {  // the whole block takes this branch
    if (i < n) fs[static_cast<long long>(i) * n_cap + k] = 0.f;
    return;
  }
  const bool live = i < n && q_valid[i] != 0;
  int q[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) q[w] = live ? q_desc[i * 8 + w] : 0;
  if (threadIdx.x < kLut) slut[threadIdx.x] = lut[threadIdx.x];
  const int* row = db + static_cast<long long>(k) * f * 8;
  const unsigned char* vrow = db_valid + static_cast<long long>(k) * f;
  float acc = 0.f;
  for (int base = 0; base < f; base += kTile) {
    const int count = min(kTile, f - base);
    __syncthreads();
    for (int e = threadIdx.x; e < count * 8; e += kMildThreads) tw[e] = row[base * 8 + e];
    for (int e = threadIdx.x; e < count; e += kMildThreads) tv[e] = vrow[base + e];
    __syncthreads();
    if (live) {
      for (int j = 0; j < count; ++j) {
        if (!tv[j]) continue;
        const int d = distance(q, &tw[j * 8]);
        if (d < kLut) acc += slut[d];
      }
    }
  }
  if (i < n) fs[static_cast<long long>(i) * n_cap + k] = acc;
}

}  // namespace

extern "C" int hamming_match(const int* a, const int* b, const unsigned char* valid_b, const float* uv_pred,
                             const float* uv_b, float window, int n, int m, int* best, int* dist, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if ((uv_pred == nullptr) != (uv_b == nullptr)) return (int)cudaErrorInvalidValue;
  hamming_match_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      a, b, valid_b, uv_pred, uv_b, window, n, m, best, dist);
  return (int)cudaGetLastError();
}

extern "C" int hamming_table(const int* a, const int* b, int n, int m, int* out, void* stream) {
  if (n == 0 || m == 0) return (int)cudaSuccess;
  if (n > 65535) return (int)cudaErrorInvalidValue;  // gridDim.y
  const dim3 grid((m + 255) / 256, n);
  hamming_table_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(a, b, n, m, out);
  return (int)cudaGetLastError();
}

extern "C" int mild_feature_scores(const int* q_desc, const unsigned char* q_valid, const int* db,
                                   const unsigned char* db_valid, const int* g, const float* lut, int n,
                                   int n_cap, int f, float* fs, void* stream) {
  if (n == 0 || n_cap == 0) return (int)cudaSuccess;
  if (n_cap > 65535) return (int)cudaErrorInvalidValue;  // gridDim.y
  const dim3 grid((n + kMildThreads - 1) / kMildThreads, n_cap);
  mild_feature_scores_kernel<<<grid, kMildThreads, 0, (cudaStream_t)stream>>>(
      q_desc, q_valid, db, db_valid, g, lut, n, n_cap, f, fs);
  return (int)cudaGetLastError();
}
