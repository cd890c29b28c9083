"""The framework's configuration tree.

Port of `onepiece_tpu/utils/config.py`: every constant the reference
scatters over #defines and parameter structs (OdometryPredefined.h,
ICP.h, GlobalRegistration.h, CubeHandler.h, VoxelCube.h, DenseSlam.h,
KeyframeBasedSlam.h) lives in one dataclass tree, with the reference's
value as the default; `from_json` layers a file's values on top. The JAX
package's `dense.stencil_radii` is left out: only its TPU tracker reads it
(the prewarp + stencil form, a TPU workaround the port does not carry), so
`from_json` accepts it in a file the JAX package wrote and drops it.
"""

from __future__ import annotations

import dataclasses
import json

# keys of the JAX package's tree that the port reads no value of
_JAX_ONLY = {("dense", "stencil_radii")}


@dataclasses.dataclass
class DenseOdometryConfig:
    min_depth: float = 0.5  # ref: OdometryPredefined.h MIN_DEPTH
    max_depth: float = 4.0  # ref: OdometryPredefined.h MAX_DEPTH
    sobel_scale: float = 0.125  # ref: OdometryPredefined.h SOBEL_SCALE
    lambda_depth: float = 0.5  # ref: OdometryPredefined.h LAMBDA_HYBRID
    depth_diff_max: float = 0.07  # depth-consistency gate (z-buffer analogue)
    levels: int = 3  # ref: Odometry.cpp CreateImagePyramid 3 levels
    iters: tuple = (16, 8, 4)  # ref: Odometry.cpp MultiScaleComputing


@dataclasses.dataclass
class SparseOdometryConfig:
    max_keypoints: int = 1000
    fast_threshold: float = 0.05
    ransac_threshold: float = 0.05  # ref: SparseOdometryFunction.cpp RANSAC3d
    ransac_hypotheses: int = 400  # ref: 400 iterations
    ransac_samples: int = 8  # ref: 8-point samples
    ransapc_rounds: int = 5  # ref: Odometry.cpp:400-404
    min_inliers: int = 20


@dataclasses.dataclass
class ICPConfig:
    max_iterations: int = 30  # ref: ICP.h ICPParameter
    threshold: float = 0.1
    point_to_plane: bool = False


@dataclasses.dataclass
class GlobalRegistrationConfig:
    voxel_size: float = 0.05  # ref: GlobalRegistration.h RANSACParameter
    fpfh_radius: float = 0.25
    fpfh_neighbors: int = 32
    threshold: float = 0.075
    hypotheses: int = 4096  # batched equivalent of ref 40000 sequential iters
    sample_size: int = 4


@dataclasses.dataclass
class IntegrationConfig:
    voxel_size: float = 0.0125  # ref: CubeHandler.h voxel resolution
    truncation: float = 0.1  # ref: Integrator default truncation
    cube_size: int = 8  # ref: VoxelCube.h CUBE_SIZE
    max_weight: float = 100.0
    initial_capacity: int = 4096


@dataclasses.dataclass
class SlamConfig:
    keyframe_disparity: float = 30.0  # ref: FBASlam.cpp:36-37
    submap_size: int = 50  # ref: DenseSlam.h:123
    cloud_stride: int = 3  # ref: DenseSlam.h:19-33 every-3rd-frame fusion
    posegraph_iters: int = 5  # ref: SimpleBA.cpp 5 GN iterations
    ba_max_iters: int = 20  # ref: BundleAdjustment.cpp LM iterations


@dataclasses.dataclass
class Config:
    dense: DenseOdometryConfig = dataclasses.field(default_factory=DenseOdometryConfig)
    sparse: SparseOdometryConfig = dataclasses.field(default_factory=SparseOdometryConfig)
    icp: ICPConfig = dataclasses.field(default_factory=ICPConfig)
    registration: GlobalRegistrationConfig = dataclasses.field(default_factory=GlobalRegistrationConfig)
    integration: IntegrationConfig = dataclasses.field(default_factory=IntegrationConfig)
    slam: SlamConfig = dataclasses.field(default_factory=SlamConfig)

    @staticmethod
    def from_json(path: str) -> "Config":
        """The defaults with a JSON file's {section: {key: value}} on top; a
        key that names no field raises KeyError."""
        with open(path) as f:
            data = json.load(f)
        cfg = Config()
        for section, values in data.items():
            sub = getattr(cfg, section)
            for k, v in values.items():
                if (section, k) in _JAX_ONLY:
                    continue
                if not hasattr(sub, k):
                    raise KeyError(f"unknown config key {section}.{k}")
                setattr(sub, k, tuple(v) if isinstance(v, list) else v)
        return cfg

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)
