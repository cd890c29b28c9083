// TSDF integration of one frame into the touched rows of the voxel-block pool.
//
// Replaces: onepiece_tpu/ops/tsdf_pallas.py:253 integrate_slots_pallas
// (Pallas body `_kernel` :81 / `_integrate_body` :130).
//
// What bounds it on Hopper: memory. Per touched block it reads and writes one
// (5, 512) f32 pool row (10 KB read + up to 10 KB written) and gathers 2 x 512
// image pixels; the arithmetic is ~60 flops per voxel. At K = 8192 slots that
// is ~160 MB of pool traffic per frame against 3.35 TB/s.
//
// Design: one CTA per slot, 512 threads, one voxel per thread. Each block
// reads its packed key and pool slot from global memory (the TPU kernel
// scalar-prefetched them to drive its BlockSpec index maps). Padding keys
// (INVALID_KEY) and slots outside the pool return at once and touch no row,
// as in the plain version. Each thread loads the f32
// depth and gray at its voxel's rounded pixel directly: the TPU kernel's
// one-hot selection matmuls, bf16 hi/lo depth split and 128x256 image window
// exist only because a TPU gather is slow and Mosaic needs aligned slices, so
// this kernel matches the exact oracle `ops/tsdf.py:integrate_blocks` (it
// differs from the Pallas kernel only on voxels of very near blocks that fall
// outside that window). The pool row is updated in place; the threads of a
// warp touch neighbouring floats of each channel row, so loads and stores
// coalesce. Only voxels that update are written.

#include <cuda_runtime.h>

namespace {

constexpr int kCube = 8;
constexpr int kVox = kCube * kCube * kCube;  // 512 voxels per block
constexpr int kChannels = 5;                 // sdf, weight, r, g, b
constexpr int kInvalidKey = 1 << 30;

__global__ void __launch_bounds__(kVox) tsdf_integrate_kernel(
    float* __restrict__ vox,  // (B + 1, 5, 512); row B is the trash row
    const int* __restrict__ keys, const int* __restrict__ slots, int num_rows,
    const float* __restrict__ img,  // (2, H, W): depth, gray
    int h, int w,
    const float* __restrict__ T,  // (4, 4) world-to-camera, row-major
    float fx, float fy, float cx, float cy,
    float voxel_size, float truncation, float max_weight) {
  const int key = keys[blockIdx.x];
  if (key == kInvalidKey) return;
  const int slot = slots[blockIdx.x];
  if (slot < 0 || slot >= num_rows) return;  // outside the pool: no update

  const int lin = threadIdx.x;
  const int ii = lin / (kCube * kCube);
  const int jj = (lin / kCube) % kCube;
  const int kk = lin % kCube;
  const int bx = ((key >> 20) & 1023) - 512;
  const int by = ((key >> 10) & 1023) - 512;
  const int bz = (key & 1023) - 512;
  // same operation order as the plain version (built with --fmad=false, so
  // the only fused multiply-adds are the explicit ones of the transform)
  const float xw = ((float)(bx * kCube + ii) + 0.5f) * voxel_size;
  const float yw = ((float)(by * kCube + jj) + 0.5f) * voxel_size;
  const float zw = ((float)(bz * kCube + kk) + 0.5f) * voxel_size;
  const float xc = fmaf(T[2], zw, fmaf(T[1], yw, T[0] * xw)) + T[3];
  const float yc = fmaf(T[6], zw, fmaf(T[5], yw, T[4] * xw)) + T[7];
  const float zc = fmaf(T[10], zw, fmaf(T[9], yw, T[8] * xw)) + T[11];

  const float zsafe = zc > 1e-6f ? zc : 1.0f;
  const int ui = (int)rintf(xc / zsafe * fx + cx);  // round half to even
  const int vi = (int)rintf(yc / zsafe * fy + cy);
  if (!(ui >= 0 && ui < w && vi >= 0 && vi < h && zc > 1e-6f)) return;
  const int pix = vi * w + ui;
  const float d = img[pix];
  const float sdf_m = d - zc;
  if (!(d > 0.0f && sdf_m > -truncation)) return;

  const float tsdf_new = fminf(fmaxf(sdf_m / truncation, -1.0f), 1.0f);
  float* row = vox + (size_t)slot * kChannels * kVox;
  const float w_old = row[kVox + lin];
  const float denom = fmaxf(w_old + 1.0f, 1.0f);
  const float sdf_safe = w_old > 0.0f ? row[lin] : 0.0f;
  row[lin] = (sdf_safe * w_old + tsdf_new) / denom;
  row[kVox + lin] = fminf(w_old + 1.0f, max_weight);
  const float g = img[h * w + pix];  // gray input: r = g = b
#pragma unroll
  for (int c = 2; c < kChannels; ++c) {
    const float c_safe = w_old > 0.0f ? row[c * kVox + lin] : 0.0f;
    row[c * kVox + lin] = (c_safe * w_old + g) / denom;
  }
}

}  // namespace

extern "C" int tsdf_integrate(
    float* vox, const int* keys, const int* slots, int num_slots, int num_rows,
    const float* img, int h, int w, const float* T_cw,
    float fx, float fy, float cx, float cy,
    float voxel_size, float truncation, float max_weight, void* stream) {
  if (num_slots > 0) {
    tsdf_integrate_kernel<<<num_slots, kVox, 0, (cudaStream_t)stream>>>(
        vox, keys, slots, num_rows, img, h, w, T_cw, fx, fy, cx, cy,
        voxel_size, truncation, max_weight);
  }
  return (int)cudaGetLastError();
}
