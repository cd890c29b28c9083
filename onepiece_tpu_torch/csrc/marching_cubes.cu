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
// Design: two passes with a prefix sum and one host read between them.
//  - Tiles: a block's channels with the +1 halo from its 7 neighbour rows
//    (NEIGHBOR_OFFSETS) as a 9x9x9 grid per channel in shared memory, laid
//    out so that the own row and the x and y faces arrive as 16-byte
//    cp.async copies of 4 floats along z (the z face, two edges and the
//    corner as 4-byte ones), every copy of a tile in flight at once. An
//    absent row (slot outside [0, rows)) gives sdf EMPTY_SDF, weight 0 and
//    colour 0, and so does an absent own slot.
//  - A voxel is meshable when its 8 corner weights are > 0 and their |sdf|
//    < 1.5; it then has TRI_COUNTS[case] triangles, the case from its
//    corner signs.
//  - Pass 1 (mc_count_kernel): one warp per block, 4 blocks per CTA, so
//    that many blocks are in flight on each SM (a whole CTA per block waits
//    on its loads and barriers with little else to run). A lane counts two
//    columns of 8 voxels along x, reading each plane of 4 corners once. It
//    writes the block's count, and appends a block that holds a triangle to
//    a list (in no particular order).
//  - The wrapper takes the inclusive prefix sum of the counts and reads the
//    total and the list's length once: the output's size and the emit grid.
//  - Pass 2 (mc_emit_kernel): one 256-thread CTA per listed block. It copies
//    the five-channel tile, classifies two voxels a thread (consecutive
//    along z), and a CTA scan of their counts gives each voxel its first
//    row, so the triangles land in (block, voxel i-j-k row-major, triangle)
//    order, the order of the plain version and of the JAX package's
//    jnp.nonzero compaction. Nothing is capped. Then the work goes by
//    triangle, not by voxel: each voxel writes its id into a row -> voxel
//    map for the round's rows, and thread r computes row r, so all lanes
//    are busy however the triangles fall on the voxels.
//  - Output: a block's triangles are one contiguous range of rows. A round
//    of up to 256 is staged in shared memory in that order, at the output's
//    alignment modulo 16 bytes, and copied out with 16-byte stores (scalar
//    stores only for the partial first and last 16 bytes of the range).
//  - The triangle table (as the corner pairs of each triangle's edges) and
//    its counts sit in __constant__ memory, uploaded from ops/mc_tables.py
//    once per device (mc_set_tables).
//  - Each vertex's arithmetic is the plain version's, operation for operation
//    (the same divisions and clamps, the library is built with --fmad=false),
//    so its output equals the plain version's bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kCube = 8;
constexpr int kVox = kCube * kCube * kCube;  // 512 voxels per block
constexpr int kHalo = kCube + 1;             // 9 corners per axis
// A channel's tile: corner (x, y, z) at x * 108 + y * 12 + z, so that every
// run of 4 along z that starts at z = 0 or 4 is 16-byte aligned.
constexpr int kYStride = 12;
constexpr int kXStride = kHalo * kYStride;  // 108
constexpr int kTile = kHalo * kXStride;     // 972 floats a channel (729 corners and padding)
// Copies of a channel's tile: own row 128 x 16 B, x face 16 x 16 B, y face
// 16 x 16 B, xy edge 2 x 16 B; z face 64 x 4 B, xz and yz edges 8 x 4 B
// each, corner 4 B.
constexpr int kCopies = 243;
constexpr int kChannels = 5;                 // sdf, weight, r, g, b
constexpr int kMaxTris = 5;                  // triangles per case, at most
constexpr int kLanes = 32;
constexpr int kCountWarps = 4;                // count pass: warps per CTA, a block each at a time
constexpr int kEmitThreads = 256;             // emit pass: a CTA per block, two voxels a thread
constexpr int kStage = kEmitThreads;          // emit pass: triangles staged per round, one a thread
constexpr int kStageFloats = kStage * 9 + 4;  // + room for the output's alignment offset
constexpr float kEmptySdf = 999.0f;

// Triangle k of case c: its 3 vertices' edges as corner pairs, corner a |
// corner b << 3 in bits 6 q.. of c_tri_corners[c * 5 + k] for vertex q, so
// that a triangle reads one word (lanes read different cases, and the
// constant cache serves their different addresses one after the other).
__constant__ unsigned int c_tri_corners[256 * kMaxTris];
__constant__ unsigned char c_count[256];

// neighbour index (NEIGHBOR_OFFSETS order) of the halo region whose axes at
// 8 are the bits of `code` (x = 1, y = 2, z = 4); code 0 is the block itself
__constant__ int c_region_nbr[8] = {-1, 0, 1, 3, 2, 4, 5, 6};

struct Params {
  const float* vox;   // (rows, 5, 512)
  const int* slots;   // (B,)
  const int* nbr;     // (B, 7)
  const int* coords;  // (B, 3)
  int num_blocks, num_rows;
  float voxel_size, iso;
  int* counts;      // (B,)
  int* list;        // (B,) the blocks that hold a triangle, in no order
  int* list_len;    // their number (0 before the count pass)
  const int* ends;  // (B,) inclusive prefix sum of the counts
  float* verts;     // (T, 3, 3)
  float* colors;    // (T, 3, 3)
};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// Wait until this thread's copies have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// Pool row of halo region `code` of block b (-1 = absent).
__device__ __forceinline__ int region_row(const Params& p, int b, int code) {
  const int s = code == 0 ? p.slots[b] : p.nbr[b * 7 + c_region_nbr[code]];
  return (s >= 0 && s < p.num_rows) ? s : -1;
}

// Start the copies of the first nc channels of a block's tile (channel c at
// tile + c * 972), from the pool rows of its 8 halo regions (indexed by
// region code), spread over `nthreads` threads. An absent region's part is
// filled at once. (A pool row stores voxel (x, y, z) at x * 64 + y * 8 + z.)
__device__ void issue_tile(const Params& p, const int* rows, int nc, float* tile, int tid, int nthreads) {
  constexpr int kFar = 8 * kXStride + 8 * kYStride;  // the tile's corner (8, 8, 0)
  for (int e = tid; e < nc * kCopies; e += nthreads) {
    const int c = e / kCopies;
    const int r = e - c * kCopies;
    int code, src, dst;
    bool wide = true;
    if (r < 128) {  // own row, 4 along z: x = q / 16, y = q / 2 % 8, z = 4 (q % 2)
      const int q = r;
      code = 0, src = q * 4, dst = (q >> 4) * kXStride + ((q >> 1) & 7) * kYStride + (q & 1) * 4;
    } else if (r < 144) {  // x face from the x = 0 slice of neighbour (1, 0, 0): y = q / 2
      const int q = r - 128;
      code = 1, src = q * 4, dst = 8 * kXStride + (q >> 1) * kYStride + (q & 1) * 4;
    } else if (r < 160) {  // y face from the y = 0 slice of neighbour (0, 1, 0): x = q / 2
      const int q = r - 144;
      code = 2, src = (q >> 1) * 64 + (q & 1) * 4, dst = (q >> 1) * kXStride + 8 * kYStride + (q & 1) * 4;
    } else if (r < 162) {  // xy edge from neighbour (1, 1, 0)
      const int q = r - 160;
      code = 3, src = q * 4, dst = kFar + q * 4;
    } else {
      wide = false;
      if (r < 226) {  // z face from the z = 0 slice of neighbour (0, 0, 1): x = q / 8, y = q % 8
        const int q = r - 162;
        code = 4, src = q * 8, dst = (q >> 3) * kXStride + (q & 7) * kYStride + 8;
      } else if (r < 234) {  // xz edge from neighbour (1, 0, 1): y = q
        const int q = r - 226;
        code = 5, src = q * 8, dst = 8 * kXStride + q * kYStride + 8;
      } else if (r < 242) {  // yz edge from neighbour (0, 1, 1): x = q
        const int q = r - 234;
        code = 6, src = q * 64, dst = q * kXStride + 8 * kYStride + 8;
      } else {  // corner from neighbour (1, 1, 1)
        code = 7, src = 0, dst = kFar + 8;
      }
    }
    float* d = tile + c * kTile + dst;
    const int row = rows[code];
    if (row >= 0) {
      const float* g = p.vox + ((size_t)row * kChannels + c) * kVox + src;
      if (wide) cp_async16(d, g);
      else cp_async4(d, g);
    } else {
      const float fill = c == 0 ? kEmptySdf : 0.0f;
      if (wide) *reinterpret_cast<float4*>(d) = make_float4(fill, fill, fill, fill);
      else *d = fill;
    }
  }
}

// Tile position of voxel v (i-j-k row-major), and of its cube corner c from there.
__device__ __forceinline__ int tile_pos(int v) {
  return (v >> 6) * kXStride + ((v >> 3) & 7) * kYStride + (v & 7);
}

__device__ __forceinline__ int corner_offset(int c) {
  return (c & 1) * kXStride + ((c >> 1) & 1) * kYStride + ((c >> 2) & 1);
}

// The case and triangle count (0 if not meshable) of the voxel at tile
// position t, from a tile of sdf and weight.
__device__ __forceinline__ int classify(const float* tile, int t, float iso, int* config) {
  bool ok = true;
  int cfg = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float s = tile[t + corner_offset(c)];
    ok = ok && tile[kTile + t + corner_offset(c)] > 0.0f && fabsf(s) < 1.5f;
    cfg |= (s < iso ? 1 : 0) << c;
  }
  *config = cfg;
  return ok ? (int)c_count[cfg] : 0;
}

// The 4 corners (dy, dz) of an x plane at tile position t: their signs as
// case bits 2 (dy + 2 dz), and whether all 4 are meshable corners.
__device__ __forceinline__ void plane(const float* tile, int t, float iso, int* sign, bool* ok) {
  int sg = 0;
  bool good = true;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int o = (q & 1) * kYStride + (q >> 1);
    const float s = tile[t + o];
    good = good && tile[kTile + t + o] > 0.0f && fabsf(s) < 1.5f;
    sg |= (s < iso ? 1 : 0) << (2 * q);
  }
  *sign = sg;
  *ok = good;
}

// A lane's share of a block's triangle count: the 2 x columns (y, z) =
// (c / 8, c % 8) for c = lane and lane + 32, each plane read once (a voxel's
// case is its low plane's bits | its high plane's bits << 1).
__device__ __forceinline__ int count_columns(const float* tile, int lane, float iso) {
  int sum = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = lane + kLanes * h;
    const int t = (c >> 3) * kYStride + (c & 7);
    int lo_sign;
    bool lo_ok;
    plane(tile, t, iso, &lo_sign, &lo_ok);
    for (int x = 1; x <= kCube; ++x) {
      int hi_sign;
      bool hi_ok;
      plane(tile, t + x * kXStride, iso, &hi_sign, &hi_ok);
      if (lo_ok && hi_ok) sum += c_count[lo_sign | (hi_sign << 1)];
      lo_sign = hi_sign;
      lo_ok = hi_ok;
    }
  }
  return sum;
}

__global__ void __launch_bounds__(kCountWarps * kLanes) mc_count_kernel(Params p) {
  __shared__ __align__(16) float tiles[kCountWarps][2 * kTile];  // sdf and weight: the count needs no colour
  __shared__ int rows[kCountWarps][8];
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int b = blockIdx.x * kCountWarps + warp;
  if (b >= p.num_blocks) return;  // a whole warp; no CTA barrier follows
  if (lane < 8) rows[warp][lane] = region_row(p, b, lane);
  __syncwarp();
  issue_tile(p, rows[warp], 2, tiles[warp], lane, kLanes);
  cp_async_wait_all();
  __syncwarp();
  int sum = count_columns(tiles[warp], lane, p.iso);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) {
    p.counts[b] = sum;
    if (sum > 0) p.list[atomicAdd(p.list_len, 1)] = b;
  }
}

// Inclusive scan of `x` over the emit pass's CTA; *total gets the sum.
__device__ __forceinline__ int cta_inclusive_scan(int x, int* total) {
  constexpr int kWarps = kEmitThreads / kLanes;
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
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  *total = s_warp[kWarps - 1];
  return x + (warp > 0 ? s_warp[warp - 1] : 0);
}

// Triangle k of voxel v (case `config`) into sv[0..9) and sc[0..9).
__device__ __forceinline__ void triangle(const Params& p, const float* tile, const float* base, int v, int config,
                                        int k, float* sv, float* sc) {
  const float* col = tile + 2 * kTile;
  const int t0 = tile_pos(v);
  const int ijk[3] = {v >> 6, (v >> 3) & 7, v & 7};
  const unsigned int corners = c_tri_corners[config * kMaxTris + k];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int ca = (corners >> (6 * q)) & 7;
    const int cb = (corners >> (6 * q + 3)) & 7;
    const int ia = t0 + corner_offset(ca);
    const int ib = t0 + corner_offset(cb);
    const float va = tile[ia];
    const float vb = tile[ib];
    const float den = va - vb;
    const bool cut = fabsf(den) > 1e-9f;
    float tp = cut ? (va - p.iso) / den : 0.5f;
    tp = fminf(fmaxf(tp, 0.0f), 1.0f);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float pa = (float)((ca >> d) & 1);
      const float pb = (float)((cb >> d) & 1);
      const float local = pa + tp * (pb - pa);
      sv[q * 3 + d] = (((base[d] + (float)ijk[d]) + local) + 0.5f) * p.voxel_size;
      const float cola = col[d * kTile + ia];
      const float colb = col[d * kTile + ib];
      sc[q * 3 + d] = cola + tp * (colb - cola);
    }
  }
}

// Copy `nf` staged floats to out[g0, g0 + nf); the stage holds float f at
// stage[(g0 & 3) + f], so whole 16-byte groups move as one load and store.
__device__ __forceinline__ void copy_out(float* out, const float* stage, long long g0, int nf) {
  const int a = (int)(g0 & 3);
  float* base = out + (g0 - a);
  const int end = a + nf;
  for (int q = threadIdx.x; q < (end + 3) >> 2; q += kEmitThreads) {
    const int x0 = 4 * q;
    if (x0 >= a && x0 + 4 <= end) {
      reinterpret_cast<float4*>(base)[q] = reinterpret_cast<const float4*>(stage)[q];
    } else {
      for (int x = max(x0, a); x < min(x0 + 4, end); ++x) base[x] = stage[x];
    }
  }
}

__global__ void __launch_bounds__(kEmitThreads) mc_emit_kernel(Params p) {
  __shared__ __align__(16) float tile[kChannels * kTile];
  __shared__ __align__(16) float stage_v[kStageFloats];
  __shared__ __align__(16) float stage_c[kStageFloats];
  __shared__ unsigned char s_cfg[kVox];  // each voxel's case
  __shared__ short s_first[kVox];        // each voxel's first row in the block
  __shared__ short s_map[kStage];        // the voxel of each staged row
  __shared__ int s_rows[8];
  __shared__ float s_base[3];  // the block's first voxel, coords * 8, as the plain version rounds it
  const int b = p.list[blockIdx.x];
  const int t = threadIdx.x;
  if (t < 8) s_rows[t] = region_row(p, b, t);
  if (t < 3) s_base[t] = (float)p.coords[b * 3 + t] * (float)kCube;
  const long long first = b == 0 ? 0 : p.ends[b - 1];  // the block's first row
  __syncthreads();
  issue_tile(p, s_rows, kChannels, tile, t, kEmitThreads);
  cp_async_wait_all();
  __syncthreads();
  const int v = 2 * t;  // this thread's voxels: v and v + 1 (the next along z)
  int cfg0, cfg1;
  const int n0 = classify(tile, tile_pos(v), p.iso, &cfg0);
  const int n1 = classify(tile, tile_pos(v) + 1, p.iso, &cfg1);
  int total = 0;
  const int r = cta_inclusive_scan(n0 + n1, &total) - n0 - n1;  // voxel v's first row in the block
  s_cfg[v] = (unsigned char)cfg0;
  s_cfg[v + 1] = (unsigned char)cfg1;
  s_first[v] = (short)r;
  s_first[v + 1] = (short)(r + n0);
  for (int r0 = 0; r0 < total; r0 += kStage) {  // rounds of at most kStage rows
    const int n = min(kStage, total - r0);
    for (int x = max(r, r0); x < min(r + n0 + n1, r0 + n); ++x) s_map[x - r0] = (short)(x < r + n0 ? v : v + 1);
    __syncthreads();
    const long long g0 = (first + r0) * 9;
    const int a = (int)(g0 & 3);
    if (t < n) {
      const int u = s_map[t];
      triangle(p, tile, s_base, u, s_cfg[u], r0 + t - s_first[u], stage_v + a + t * 9, stage_c + a + t * 9);
    }
    __syncthreads();
    copy_out(p.verts, stage_v, g0, n * 9);
    copy_out(p.colors, stage_c, g0, n * 9);
    __syncthreads();
  }
}

}  // namespace

// tri: (256, 5, 3) int8 edge ids (-1 padding), counts: (256,) uint8, edges:
// (12, 2) int8 corners, all on the host.
extern "C" int mc_set_tables(const void* tri, const void* counts, const void* edges) {
  const signed char* t = static_cast<const signed char*>(tri);
  const signed char* e = static_cast<const signed char*>(edges);
  unsigned int corners[256 * kMaxTris];
  for (int i = 0; i < 256 * kMaxTris; ++i) {
    corners[i] = 0;
    for (int q = 0; q < 3; ++q) {
      const int edge = t[i * 3 + q];
      if (edge >= 0) corners[i] |= (unsigned int)(e[2 * edge] | (e[2 * edge + 1] << 3)) << (6 * q);
    }
  }
  cudaError_t err = cudaMemcpyToSymbol(c_tri_corners, corners, sizeof(corners));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(c_count, counts, sizeof(c_count));
  return (int)err;
}

// list: (B + 1) int32, its last entry 0 (the list's length, counted here).
extern "C" int mc_count(const float* vox, const int* slots, const int* nbr, int num_blocks, int num_rows,
                        float iso, int* counts, int* list, void* stream) {
  Params p{};
  p.vox = vox;
  p.slots = slots;
  p.nbr = nbr;
  p.num_blocks = num_blocks;
  p.num_rows = num_rows;
  p.iso = iso;
  p.counts = counts;
  p.list = list;
  p.list_len = list + num_blocks;
  mc_count_kernel<<<(num_blocks + kCountWarps - 1) / kCountWarps, kCountWarps * kLanes, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int mc_emit(const float* vox, const int* slots, const int* nbr, const int* coords, int num_rows,
                       float voxel_size, float iso, const int* list, int num_listed, const int* ends, float* verts,
                       float* colors, void* stream) {
  Params p{};
  p.vox = vox;
  p.slots = slots;
  p.nbr = nbr;
  p.coords = coords;
  p.num_rows = num_rows;
  p.voxel_size = voxel_size;
  p.iso = iso;
  p.list = const_cast<int*>(list);
  p.ends = ends;
  p.verts = verts;
  p.colors = colors;
  mc_emit_kernel<<<num_listed, kEmitThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
