"""onepiece_tpu_torch — the PyTorch + CUDA port of onepiece_tpu.

Mirrors the JAX package's layout (`onepiece_tpu/ops/tsdf.py` <->
`onepiece_tpu_torch/ops/tsdf.py`) and never imports jax or the JAX package;
the numpy-only helpers it needs are copied. Tensors carry their device:
every kernelled function runs its hand-written CUDA kernel
(`csrc/*.cu`, built by `_build.py`) on a CUDA tensor and its plain PyTorch
version on a CPU tensor. There is no fallback from one to the other.

Layout (the slices so far: the dense fusion loop `systems/fused_slam.py`,
DenseSlam `systems/dense_slam.py`, meshing with the pipelined loop
`systems/pipeline.py`, sparse FBAFusion `systems/fused_sparse.py`, bundle
adjustment `systems/fused_ba.py`, real input and state `io/tum.py`,
`io/png.py`, `utils/checkpoint.py`, the prefetch ring
`io/native_loader.py` with the remaining I/O and tool modules, the
host-loop systems, scene analysis and visualisation, the multi-device
layer `parallel/`, and ScanNet input `io/scannet.py`):
  geometry/      SE(3) math, pinhole camera (+ presets), Kabsch and normal
                 fitting, fixed-capacity point clouds, triangle meshes
                 (normals, clustering / QEM simplification, pruning)
  algorithm/     clustering, plane / line region growing, line arrangements,
                 room segmentation
  native/        mesh_native.cpp (QEM, pruning), jpeg_decode.cpp (baseline
                 JPEG), remap.cpp (bilinear remap): host C++ built by `_native.py`
  viz/           software mesh renderer, mesh / gray / depth / trajectory PNGs
  ops/           image ops, dense Gauss-Newton steps (kernel), TSDF keys and
                 pool integration (kernel), brute-force kNN, exact 1-NN
                 (kernel), batched RANSAC, marching cubes (kernel) and its
                 triangle table, Hamming matching of binary descriptors (kernel)
  odometry/      frame pyramids + multi-scale dense tracking; FAST/BRIEF
                 features and sparse (feature-based) tracking
  lcdetection/   MILD loop-closure candidates on the device (kernel)
  integration/   device block hash, TSDFVolume (allocate, integrate,
                 extract_mesh), volume_ops (save / load / merge / transform)
  registration/  ICP, FPFH, global (feature + RANSAC) registration
  optimization/  pose-graph Gauss-Newton, bundle adjustment (Schur kernel)
  systems/       FusedDenseFusion, DenseSlam, PipelinedDenseFusion, FusedFBASlam,
                 FusedBASlam
  io/            trajectory IO, ATE / RPE, PLY meshes, PNG codec (zlib + numpy),
                 TUM RGB-D sequences read through the prefetch ring (decoder
                 processes), live-stream replay, the C++ reference's cube
                 format, OBJ meshes, ScanNet exports (with the port's JPEG
                 and PGM readers)
  utils/         synthetic SDF renderer with exact ground-truth poses;
                 checkpoint / resume of the device-resident systems; the
                 configuration tree, timers, logging
"""

import torch

# Geometry (SE3 chains, 6x6 normal equations) must run float32 matmuls in
# full float32: TF32 keeps ~3 decimal digits. Counterpart of the JAX
# package's `jax_default_matmul_precision = "highest"`.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
