// Exact 1-nearest-neighbour of 3-d points: ICP's correspondence search.
//
// Replaces: onepiece_tpu/ops/knn_pallas.py:69 nn1_pallas (Pallas body
// `_nn_kernel` :37).
//
// What it computes: for each query point, the index and squared distance of
// the nearest VALID reference point, d2 = (dx*dx + dy*dy) + dz*dz with
// d = q - r, in float32 in that order (the Pallas kernel's difference form,
// not the |a|^2 + |b|^2 - 2ab expansion of ops/knn.py). Ties go to the
// lowest index; a query with no valid reference gets (0, 1e30), the Pallas
// kernel's initial value.
//
// What bounds it on Hopper: arithmetic. Every (query, valid reference) pair
// costs 3 subtractions, 3 multiplications and 2 additions (8 flops), then a
// compare and two selects; the data (the two clouds) is under a megabyte.
// Nothing of the (N, M) distance block ever leaves registers.
//
// Design: a 2-d grid of (query block, reference chunk) CTAs, so that even
// N = 16384 fills the 132 SMs several times over (32 x 16 = 512 CTAs at
// 16384 x 16384). Each CTA first compacts the valid references of its chunk
// of kChunk points into shared memory, in index order, as float4 (x, y, z,
// index): the inner loop has no validity branch and never spends work on an
// invalid point. Each thread then keeps kQ queries, so every broadcast
// 16-byte shared load feeds kQ independent distance chains, each with a
// running (best_d2, best_idx); a strict `<` over increasing indices keeps
// the lowest index on ties. The chunk's (d2, idx) per query goes to scratch.
// A second kernel in the same call merges the chunks of each query in
// increasing chunk order with the same strict `<`, which keeps the lowest
// index across chunk boundaries too; every chunk starts from (1e30, 0), so a
// query with no valid reference ends at (0, 1e30). Any N and M work as they
// are, with the ragged query tail masked and the ragged reference tail cut
// from the last chunk. Built with --fmad=false, so d2 rounds exactly as the
// plain PyTorch version's separate elementwise ops do and both agree bit for
// bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kQ = 4;                            // queries per thread
constexpr int kQueriesPerBlock = kThreads * kQ;  // 512
constexpr int kChunk = 1024;                     // references per chunk (16 KB of float4)
constexpr int kPerThread = kChunk / kThreads;    // references each thread compacts
constexpr int kMaxChunks = 65535;                // gridDim.y
constexpr float kLarge = 1e30f;

__global__ void __launch_bounds__(kThreads) nn1_chunk_kernel(
    const float* __restrict__ query,     // (N, 3)
    const float* __restrict__ ref,       // (M, 3)
    const bool* __restrict__ ref_valid,  // (M,)
    int n, int m,
    float* __restrict__ part_d2,  // (chunks, N)
    int* __restrict__ part_idx) {  // (chunks, N)
  __shared__ float4 tile[kChunk];
  __shared__ int warp_total[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = blockIdx.y * kChunk;
  const int count = min(kChunk, m - base);

  // stable compaction of the chunk's valid references: each thread takes
  // kPerThread consecutive points, and a block-wide exclusive scan of the
  // per-thread counts gives each its place in the tile
  const int first = threadIdx.x * kPerThread;
  unsigned int mine = 0u;  // bit e: reference first + e is valid
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int j = first + e;
    if (j < count && ref_valid[base + j]) mine |= 1u << e;
  }
  const int c = __popc(mine);
  int incl = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int offset = incl - c, total = 0;
#pragma unroll
  for (int wp = 0; wp < kThreads / 32; ++wp) {
    if (wp < warp) offset += warp_total[wp];
    total += warp_total[wp];
  }
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    if (mine & (1u << e)) {
      const int r = base + first + e;
      tile[offset++] = make_float4(ref[3 * r], ref[3 * r + 1], ref[3 * r + 2], __int_as_float(r));
    }
  }
  __syncthreads();

  float qx[kQ], qy[kQ], qz[kQ], best_d2[kQ];
  int best_idx[kQ];
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int qi = blockIdx.x * kQueriesPerBlock + k * kThreads + threadIdx.x;
    qx[k] = qy[k] = qz[k] = 0.0f;  // a query past N computes and is not written
    if (qi < n) {
      qx[k] = query[3 * qi];
      qy[k] = query[3 * qi + 1];
      qz[k] = query[3 * qi + 2];
    }
    best_d2[k] = kLarge;
    best_idx[k] = 0;
  }
#pragma unroll 4
  for (int j = 0; j < total; ++j) {
    const float4 p = tile[j];
#pragma unroll
    for (int k = 0; k < kQ; ++k) {
      const float dx = qx[k] - p.x;
      const float dy = qy[k] - p.y;
      const float dz = qz[k] - p.z;
      const float d2 = (dx * dx + dy * dy) + dz * dz;
      if (d2 < best_d2[k]) {
        best_d2[k] = d2;
        best_idx[k] = __float_as_int(p.w);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int qi = blockIdx.x * kQueriesPerBlock + k * kThreads + threadIdx.x;
    if (qi < n) {
      part_d2[(size_t)blockIdx.y * n + qi] = best_d2[k];
      part_idx[(size_t)blockIdx.y * n + qi] = best_idx[k];
    }
  }
}

__global__ void __launch_bounds__(kThreads) nn1_merge_kernel(
    const float* __restrict__ part_d2, const int* __restrict__ part_idx, int n, int chunks,
    int* __restrict__ out_idx, float* __restrict__ out_d2) {
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  if (qi >= n) return;
  float best = kLarge;
  int idx = 0;
  for (int s = 0; s < chunks; ++s) {
    const float d2 = part_d2[(size_t)s * n + qi];
    if (d2 < best) {  // strict, in chunk order: the lowest index on ties
      best = d2;
      idx = part_idx[(size_t)s * n + qi];
    }
  }
  out_idx[qi] = idx;
  out_d2[qi] = best;
}

}  // namespace

// `part_d2` and `part_idx` hold chunks * N values each, where chunks is
// ceil(M / kChunk) (checked).
extern "C" int nn1(const float* query, const float* ref, const bool* ref_valid,
                   int n, int m, int* out_idx, float* out_d2,
                   float* part_d2, int* part_idx, int chunks, void* stream) {
  if (chunks != (m + kChunk - 1) / kChunk || chunks > kMaxChunks) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (chunks > 0) {
    const dim3 grid((n + kQueriesPerBlock - 1) / kQueriesPerBlock, chunks);
    nn1_chunk_kernel<<<grid, kThreads, 0, s>>>(query, ref, ref_valid, n, m, part_d2, part_idx);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  nn1_merge_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      part_d2, part_idx, n, chunks, out_idx, out_d2);
  return (int)cudaGetLastError();
}
