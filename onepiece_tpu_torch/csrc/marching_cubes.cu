// Marching cubes over TSDF voxel blocks, read from the voxel-block pool.
//
// Replaces: onepiece_tpu/ops/marching_cubes.py:82 extract_block_triangles +
// :192 compact_triangles (XLA, not Pallas; the JAX package runs them over
// chunks of blocks in onepiece_tpu/integration/blocks.py:71
// _extract_all_chunks).
//
// What bounds it on Hopper: memory. The function must read the sdf and
// weight of every block's pool row (4,096 B; a halo corner is a neighbour
// row's voxel, read there), the colour (12 B per voxel) only of the blocks
// that hold a triangle and of the halo faces they take from their
// neighbours, and write 72 B per triangle (3 vertices and 3 colours of 3
// floats); the arithmetic is a few dozen flops per voxel and per triangle
// vertex.
//
// Design (two passes over the same tiles, one CTA of 512 threads per block,
// one voxel per thread):
//  - The CTA loads its block's five channels and the +1 halo from its 7
//    neighbour rows into a 9x9x9x5 float tile in shared memory (14.6 KB); an
//    absent neighbour (slot outside [0, rows)) gives sdf EMPTY_SDF, weight 0
//    and colour 0, and so does an absent own slot. Each thread has all of
//    its 8 loads in flight before it stores one: the passes are bound by the
//    latency of the tile, not by its bytes (PERF.md).
//  - Pass 1 (mc_count_kernel, a tile of sdf and weight only, 5.8 KB): each
//    voxel's triangle count, TRI_COUNTS[case] or 0 when the voxel is not
//    meshable (a corner weight <= 0 or a corner |sdf| >= 1.5); the CTA's sum
//    goes to counts[b]. The wrapper takes the inclusive prefix sum of the
//    counts and reads the total once, to size the output, as the JAX package
//    reads its counts once.
//  - Pass 2 (mc_emit_kernel): a block without triangles returns at once;
//    the others load the whole tile, and a CTA-wide exclusive scan of the
//    counts gives each voxel its first row, so the triangles land in (block,
//    voxel i-j-k row-major, triangle) order, the order of the plain version
//    and of the JAX package's jnp.nonzero compaction. Nothing is capped.
//  - The triangle table, its counts and the edge corners sit in __constant__
//    memory, uploaded from ops/mc_tables.py once per device (mc_set_tables).
//  - Each vertex's arithmetic is the plain version's, operation for operation
//    (the same divisions and clamps, the library is built with --fmad=false),
//    so its output equals the plain version's bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kCube = 8;
constexpr int kVox = kCube * kCube * kCube;  // 512 voxels per block, one per thread
constexpr int kHalo = kCube + 1;             // 9 corners per axis
constexpr int kTile = kHalo * kHalo * kHalo;  // 729 corner positions
constexpr int kChannels = 5;                 // sdf, weight, r, g, b
constexpr int kMaxTris = 5;                  // triangles per case, at most
constexpr int kWarps = kVox / 32;
constexpr float kEmptySdf = 999.0f;

__constant__ signed char c_tri[256 * kMaxTris * 3];  // edge ids, -1 padding
__constant__ unsigned char c_count[256];
__constant__ signed char c_edge[12 * 2];  // the corners of each edge

// neighbour index (NEIGHBOR_OFFSETS order) of the halo region whose axes at
// 8 are the bits of `code` (x = 1, y = 2, z = 4); code 0 is the block itself
__constant__ int c_region_nbr[8] = {-1, 0, 1, 3, 2, 4, 5, 6};

struct Params {
  const float* vox;  // (rows, 5, 512)
  const int* slots;  // (B,)
  const int* nbr;    // (B, 7)
  const int* coords;  // (B, 3)
  int num_blocks, num_rows;
  float voxel_size, iso;
  const int* ends;  // (B,) inclusive prefix sum of the counts
  float* verts;     // (T, 3, 3)
  float* colors;    // (T, 3, 3)
  int* counts;      // (B,)
};

// The block's 9x9x9 tile of its first C channels, channel-major:
// tile[c * 729 + (x * 81 + y * 9 + z)]. Each thread issues all of its
// loads (C * 729 / 512, rounded up) before it stores any of them.
template <int C>
__device__ void load_tile(const Params& p, int b, float* tile) {
  constexpr int kLoads = (C * kTile + kVox - 1) / kVox;
  __shared__ int s_src[8];  // pool row of each halo region, -1 = absent
  if (threadIdx.x < 8) {
    const int code = threadIdx.x;
    const int s = code == 0 ? p.slots[b] : p.nbr[b * 7 + c_region_nbr[code]];
    s_src[code] = (s >= 0 && s < p.num_rows) ? s : -1;
  }
  __syncthreads();
  float v[kLoads];
#pragma unroll
  for (int it = 0; it < kLoads; ++it) {
    const int e = threadIdx.x + it * kVox;
    const int c = e / kTile;
    const int pos = e - c * kTile;
    const int x = pos / (kHalo * kHalo);
    const int y = (pos / kHalo) % kHalo;
    const int z = pos % kHalo;
    const int slot = e < C * kTile ? s_src[(x == kCube) | ((y == kCube) << 1) | ((z == kCube) << 2)] : -1;
    v[it] = c == 0 ? kEmptySdf : 0.0f;
    if (slot >= 0) v[it] = __ldg(p.vox + ((size_t)slot * kChannels + c) * kVox + ((x & 7) * kCube + (y & 7)) * kCube + (z & 7));
  }
#pragma unroll
  for (int it = 0; it < kLoads; ++it) {
    const int e = threadIdx.x + it * kVox;
    if (e < C * kTile) tile[e] = v[it];
  }
  __syncthreads();
}

// This thread's voxel: its case and its triangle count (0 if not meshable).
struct Voxel {
  int i, j, k;
  int corner[8];  // tile positions of the 8 cube corners
  int config, count;
};

__device__ __forceinline__ Voxel classify(const float* tile, float iso) {
  Voxel v;
  const int t = threadIdx.x;
  v.i = t / (kCube * kCube);
  v.j = (t / kCube) % kCube;
  v.k = t % kCube;
  bool ok = true;
  v.config = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    v.corner[c] = (v.i + (c & 1)) * kHalo * kHalo + (v.j + ((c >> 1) & 1)) * kHalo + (v.k + ((c >> 2) & 1));
    const float s = tile[v.corner[c]];
    ok = ok && tile[kTile + v.corner[c]] > 0.0f && fabsf(s) < 1.5f;
    v.config |= (s < iso ? 1 : 0) << c;
  }
  v.count = ok ? (int)c_count[v.config] : 0;
  return v;
}

// Inclusive scan of `x` over the CTA's 512 threads; *total gets the sum.
__device__ __forceinline__ int cta_inclusive_scan(int x, int* total) {
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  *total = s_warp[kWarps - 1];
  return x + (warp > 0 ? s_warp[warp - 1] : 0);
}

__global__ void __launch_bounds__(kVox) mc_count_kernel(Params p) {
  __shared__ float tile[2 * kTile];  // sdf and weight: the count needs no colour
  const int b = blockIdx.x;
  load_tile<2>(p, b, tile);
  const Voxel v = classify(tile, p.iso);
  int total = 0;
  cta_inclusive_scan(v.count, &total);
  if (threadIdx.x == 0) p.counts[b] = total;
}

__global__ void __launch_bounds__(kVox) mc_emit_kernel(Params p) {
  __shared__ float tile[kChannels * kTile];
  const int b = blockIdx.x;
  const int start = b == 0 ? 0 : p.ends[b - 1];  // this block's first row
  if (p.ends[b] == start) return;                // no triangle: skip the tile
  load_tile<kChannels>(p, b, tile);
  const Voxel v = classify(tile, p.iso);
  int total = 0;
  const int incl = cta_inclusive_scan(v.count, &total);
  if (v.count == 0) return;
  const long long first = (long long)start + (incl - v.count);
  const int ijk[3] = {v.i, v.j, v.k};
  float base[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) base[d] = (float)p.coords[b * 3 + d] * (float)kCube + (float)ijk[d];

  for (int t = 0; t < v.count; ++t) {
    float* out_v = p.verts + (first + t) * 9;
    float* out_c = p.colors + (first + t) * 9;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int e = c_tri[(v.config * kMaxTris + t) * 3 + q];
      const int ca = c_edge[2 * e];
      const int cb = c_edge[2 * e + 1];
      const float va = tile[v.corner[ca]];
      const float vb = tile[v.corner[cb]];
      const float den = va - vb;
      const bool cut = fabsf(den) > 1e-9f;
      float tp = cut ? (va - p.iso) / den : 0.5f;
      tp = fminf(fmaxf(tp, 0.0f), 1.0f);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float pa = (float)((ca >> d) & 1);
        const float pb = (float)((cb >> d) & 1);
        const float local = pa + tp * (pb - pa);
        out_v[q * 3 + d] = ((base[d] + local) + 0.5f) * p.voxel_size;
        const float cola = tile[(2 + d) * kTile + v.corner[ca]];
        const float colb = tile[(2 + d) * kTile + v.corner[cb]];
        out_c[q * 3 + d] = cola + tp * (colb - cola);
      }
    }
  }
}

}  // namespace

extern "C" int mc_set_tables(const void* tri, const void* counts, const void* edges) {
  cudaError_t err = cudaMemcpyToSymbol(c_tri, tri, sizeof(c_tri));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(c_count, counts, sizeof(c_count));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(c_edge, edges, sizeof(c_edge));
  return (int)err;
}

extern "C" int mc_count(const float* vox, const int* slots, const int* nbr, int num_blocks, int num_rows,
                        float iso, int* counts, void* stream) {
  Params p{};
  p.vox = vox;
  p.slots = slots;
  p.nbr = nbr;
  p.num_blocks = num_blocks;
  p.num_rows = num_rows;
  p.iso = iso;
  p.counts = counts;
  mc_count_kernel<<<num_blocks, kVox, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int mc_emit(const float* vox, const int* slots, const int* nbr, const int* coords, int num_blocks,
                       int num_rows, float voxel_size, float iso, const int* ends, float* verts, float* colors,
                       void* stream) {
  Params p{};
  p.vox = vox;
  p.slots = slots;
  p.nbr = nbr;
  p.coords = coords;
  p.num_blocks = num_blocks;
  p.num_rows = num_rows;
  p.voxel_size = voxel_size;
  p.iso = iso;
  p.ends = ends;
  p.verts = verts;
  p.colors = colors;
  mc_emit_kernel<<<num_blocks, kVox, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
