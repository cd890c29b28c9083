// TSDF integration of one frame into the touched rows of the voxel-block pool.
//
// Replaces: onepiece_tpu/ops/tsdf_pallas.py:253 integrate_slots_pallas
// (Pallas body `_kernel` :81 / `_integrate_body` :130), in its gray and its
// rgb form.
//
// What bounds it on Hopper: memory. For each voxel that updates, the
// function writes the five f32 channels of its pool row (sdf, weight, r, g,
// b: 20 B) and needs its old weight, and its old sdf and colour (16 B more)
// only if that weight is > 0. It also gathers the image at the voxel's
// pixel; the arithmetic is a few dozen flops per voxel.
//
// Design:
//  - A persistent grid of as many 128-thread CTAs as the card holds at once
//    (SMs x the occupancy the runtime reports, asked once per device). CTA b
//    owns entries b, b + G, b + 2G, ... It loads 128 of them at once, one per
//    thread, keeps the real ones (key != INVALID_KEY, slot in [0, B]) in
//    shared memory in entry order, and then integrates them one after the
//    other. Padding keys and out-of-pool slots cost one load wherever they sit
//    in the array. Entries that share the trash row B race there; its content
//    is garbage by design, as in the plain version.
//  - Each thread owns 4 consecutive voxels along k (same i, j): one float4
//    of each pool channel (a channel row is 2,048 B and a pool row 10,240 B,
//    so every float4 is 16-byte aligned). It issues the image gathers of its
//    4 voxels together; then, if any of them updates, the five float4 loads of
//    weight, sdf and colour together, and selects `w_old > 0 ? x : 0` after
//    the loads. So it also reads the old sdf and colour of a voxel of weight
//    0, which the function does not need: loading them only after the
//    weights, where some weight is > 0, adds a dependent round trip to every
//    other group and ran slower on the main path (PERF.md). A float4 group in
//    which no voxel updates is neither read nor written; in one that does,
//    the voxels that do not update are written back unchanged.
//  - The image is channels-first f32: (2, H, W) [depth, gray], gray written to
//    r, g and b, or (4, H, W) [depth, r, g, b]; the channel count is a
//    template parameter.
//  - Each voxel's arithmetic is the plain version's, operation for operation:
//    the same explicit fmaf chain for the rigid transform (the x and y terms
//    are shared by a thread's 4 voxels, and computed once), rintf, the same
//    divisions, and no other FMA (the library is built with --fmad=false).
//    Weights therefore equal the plain version's and the exact oracle's.

#include <cuda_runtime.h>

namespace {

constexpr int kCube = 8;
constexpr int kVox = kCube * kCube * kCube;  // 512 voxels per block
constexpr int kChannels = 5;                 // sdf, weight, r, g, b
constexpr int kPerThread = 4;                // consecutive voxels along k: one float4
constexpr int kThreads = kVox / kPerThread;  // 128: one pool row per CTA step
constexpr int kWarps = kThreads / 32;
constexpr int kInvalidKey = 1 << 30;
constexpr int kMaxDevices = 64;

struct Params {
  float* vox;  // (B + 1, 5, 512); row B is the trash row
  const int* keys;
  const int* slots;
  int num_slots, num_rows;
  const float* img;  // (C, H, W)
  int h, w;
  const float* T;  // (4, 4) world-to-camera, row-major
  float fx, fy, cx, cy, voxel_size, truncation, max_weight;
};

// One pool row: this thread's 4 voxels of block `key`, updated in place.
template <int C>
__device__ __forceinline__ void integrate_row(const Params& p, const float (&R)[12], int key, int slot,
                                              int ii, int jj, int kk0, int lin0) {
  const int bx = ((key >> 20) & 1023) - 512;
  const int by = ((key >> 10) & 1023) - 512;
  const int bz = (key & 1023) - 512;
  const float xw = ((float)(bx * kCube + ii) + 0.5f) * p.voxel_size;
  const float yw = ((float)(by * kCube + jj) + 0.5f) * p.voxel_size;
  // the first product and FMA of each transform row, shared by the 4 voxels
  const float ax = fmaf(R[1], yw, R[0] * xw);
  const float ay = fmaf(R[5], yw, R[4] * xw);
  const float az = fmaf(R[9], yw, R[8] * xw);

  int pix[kPerThread];
  bool inb[kPerThread];
  float zc[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const float zw = ((float)(bz * kCube + kk0 + q) + 0.5f) * p.voxel_size;
    const float xc = fmaf(R[2], zw, ax) + R[3];
    const float yc = fmaf(R[6], zw, ay) + R[7];
    zc[q] = fmaf(R[10], zw, az) + R[11];
    const float zsafe = zc[q] > 1e-6f ? zc[q] : 1.0f;
    const int ui = (int)rintf(xc / zsafe * p.fx + p.cx);  // round half to even
    const int vi = (int)rintf(yc / zsafe * p.fy + p.cy);
    inb[q] = ui >= 0 && ui < p.w && vi >= 0 && vi < p.h && zc[q] > 1e-6f;
    pix[q] = inb[q] ? vi * p.w + ui : 0;
  }

  // the gathers of all 4 voxels, depth and colour, in flight together
  const size_t plane = (size_t)p.h * p.w;
  float d[kPerThread], col[kPerThread][C - 1];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    d[q] = inb[q] ? __ldg(p.img + pix[q]) : 0.0f;  // 0: no update
#pragma unroll
    for (int c = 0; c < C - 1; ++c) col[q][c] = inb[q] ? __ldg(p.img + (c + 1) * plane + pix[q]) : 0.0f;
  }

  bool upd[kPerThread];
  float tsdf_new[kPerThread];
  bool any = false;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const float sdf_m = d[q] - zc[q];
    upd[q] = inb[q] && d[q] > 0.0f && sdf_m > -p.truncation;
    tsdf_new[q] = fminf(fmaxf(sdf_m / p.truncation, -1.0f), 1.0f);
    any |= upd[q];
  }
  if (!any) return;  // this float4 group is neither read nor written

  float4* row = reinterpret_cast<float4*>(p.vox + (size_t)slot * kChannels * kVox + lin0);
  float4 v[kChannels];  // the five loads in flight together
#pragma unroll
  for (int c = 0; c < kChannels; ++c) v[c] = row[c * (kVox / 4)];
  float* sdf = &v[0].x;
  float* wgt = &v[1].x;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    if (!upd[q]) continue;
    const float w_old = wgt[q];
    const bool has = w_old > 0.0f;
    const float denom = fmaxf(w_old + 1.0f, 1.0f);
    sdf[q] = ((has ? sdf[q] : 0.0f) * w_old + tsdf_new[q]) / denom;
    wgt[q] = fminf(w_old + 1.0f, p.max_weight);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float* x = &v[2 + c].x;
      x[q] = ((has ? x[q] : 0.0f) * w_old + col[q][C == 2 ? 0 : c]) / denom;  // gray: r = g = b
    }
  }
#pragma unroll
  for (int c = 0; c < kChannels; ++c) row[c * (kVox / 4)] = v[c];
}

template <int C>  // image channels: 2 = [depth, gray], 4 = [depth, r, g, b]
__global__ void __launch_bounds__(kThreads) tsdf_integrate_kernel(Params p) {
  __shared__ int s_key[kThreads];
  __shared__ int s_slot[kThreads];
  __shared__ int s_count[kWarps];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int lin0 = t * kPerThread;
  const int ii = lin0 / (kCube * kCube);
  const int jj = (lin0 / kCube) % kCube;
  const int kk0 = lin0 % kCube;
  float R[12];  // rows 0-2 of T_cw
#pragma unroll
  for (int i = 0; i < 12; ++i) R[i] = __ldg(p.T + i);

  const long long stride = gridDim.x;
  for (long long first = blockIdx.x; first < p.num_slots; first += stride * kThreads) {
    // this CTA's next 128 entries, one per thread; keep the real ones, in order
    const long long e = first + t * stride;
    int key = kInvalidKey, slot = -1;
    if (e < p.num_slots) {
      key = p.keys[e];
      slot = p.slots[e];
    }
    const bool real = key != kInvalidKey && slot >= 0 && slot < p.num_rows;
    const unsigned mask = __ballot_sync(0xffffffffu, real);
    if (lane == 0) s_count[warp] = __popc(mask);
    __syncthreads();
    int offset = 0, total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      offset += i < warp ? s_count[i] : 0;
      total += s_count[i];
    }
    if (real) {
      const int pos = offset + __popc(mask & ((1u << lane) - 1u));
      s_key[pos] = key;
      s_slot[pos] = slot;
    }
    __syncthreads();
    for (int n = 0; n < total; ++n) integrate_row<C>(p, R, s_key[n], s_slot[n], ii, jj, kk0, lin0);
    __syncthreads();  // the next batch overwrites the lists
  }
}

// CTAs of the kernel that the current device holds at once (asked once per device)
template <int C>
cudaError_t resident_ctas(int* out) {
  static int cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tsdf_integrate_kernel<C>, kThreads, 0);
    if (err != cudaSuccess) return err;
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *out = cached[dev];
  return cudaSuccess;
}

template <int C>
int launch(const Params& p, cudaStream_t stream) {
  int resident = 0;
  const cudaError_t err = resident_ctas<C>(&resident);
  if (err != cudaSuccess) return (int)err;
  const int grid = p.num_slots < resident ? p.num_slots : resident;
  tsdf_integrate_kernel<C><<<grid, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tsdf_integrate(
    float* vox, const int* keys, const int* slots, int num_slots, int num_rows,
    const float* img, int channels, int h, int w, const float* T_cw,
    float fx, float fy, float cx, float cy,
    float voxel_size, float truncation, float max_weight, void* stream) {
  const Params p{vox, keys, slots, num_slots, num_rows, img, h, w, T_cw,
                 fx, fy, cx, cy, voxel_size, truncation, max_weight};
  if (channels == 2) return launch<2>(p, (cudaStream_t)stream);
  if (channels == 4) return launch<4>(p, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
