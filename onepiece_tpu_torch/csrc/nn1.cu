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
// What bounds it on Hopper: arithmetic and shared-memory issue. Every
// (query, reference) pair costs 3 subtractions, 3 multiplications, 2
// additions and a compare; at N = M = 32768 that is ~1e10 instructions,
// while the data (the two clouds) is under a megabyte. Nothing of the (N, M)
// distance block ever leaves registers.
//
// Design: one thread per query, keeping a running (best_d2, best_idx) in
// registers. The reference cloud streams through shared memory in tiles of
// kTile points, stored as float4 (x, y, z, valid) so that each reference
// costs one 16-byte broadcast load for the whole warp. Every thread of a
// block walks the same references in increasing index order, so the skip
// of an invalid reference is uniform (no divergence) and a strict `<`
// keeps the lowest index on ties. The Pallas kernel's (4, M) lane layout,
// 256 x 2048 grid, padding to those sizes and float-index two-pass argmin
// exist for VMEM and Mosaic; here any N and M work as they are, with the
// ragged query tail masked and the ragged reference tail cut from the last
// tile. Built with --fmad=false, so d2 rounds exactly as the plain PyTorch
// version's separate elementwise ops do and both agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 2048;  // reference points per shared-memory tile (32 KB)
constexpr float kLarge = 1e30f;

__global__ void __launch_bounds__(kThreads) nn1_kernel(
    const float* __restrict__ query,  // (N, 3)
    const float* __restrict__ ref,    // (M, 3)
    const bool* __restrict__ ref_valid,  // (M,)
    int n, int m,
    int* __restrict__ out_idx,     // (N,)
    float* __restrict__ out_d2) {  // (N,)
  __shared__ float4 tile[kTile];
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool active = qi < n;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (active) {
    qx = query[3 * qi];
    qy = query[3 * qi + 1];
    qz = query[3 * qi + 2];
  }
  float best_d2 = kLarge;
  int best_idx = 0;

  for (int base = 0; base < m; base += kTile) {
    const int count = min(kTile, m - base);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < count; j += kThreads) {
      const int r = base + j;
      tile[j] = make_float4(ref[3 * r], ref[3 * r + 1], ref[3 * r + 2],
                            ref_valid[r] ? 1.0f : 0.0f);
    }
    __syncthreads();
    if (active) {
#pragma unroll 8
      for (int j = 0; j < count; ++j) {
        const float4 p = tile[j];
        if (p.w == 0.0f) continue;  // invalid reference: never a match
        const float dx = qx - p.x;
        const float dy = qy - p.y;
        const float dz = qz - p.z;
        const float d2 = (dx * dx + dy * dy) + dz * dz;
        if (d2 < best_d2) {
          best_d2 = d2;
          best_idx = base + j;
        }
      }
    }
  }
  if (active) {
    out_idx[qi] = best_idx;
    out_d2[qi] = best_d2;
  }
}

}  // namespace

extern "C" int nn1(const float* query, const float* ref, const bool* ref_valid,
                   int n, int m, int* out_idx, float* out_d2, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    nn1_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        query, ref, ref_valid, n, m, out_idx, out_d2);
  }
  return (int)cudaGetLastError();
}
