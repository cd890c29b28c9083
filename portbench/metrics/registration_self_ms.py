"""Self time of DenseSlam's submap registration spans (`registration.*`:
a kept frame's cloud, merge, downsample, normals and FPFH, ICP, global
registration and its refinement, the pose graph, the re-anchoring) in the
traced scan, over its frames."""

from portbench.metrics import _spans

KIND = "per_layer"
UNIT = "ms/frame"


def read(ctx):
    return _spans.layer_ms(ctx, "registration")
