"""A frozen copy of the port's sparse BAFusion path on its plain versions:
`systems/fused_ba.py` and what it imports (`systems/fused_sparse.py`,
`odometry/{features,sparse}.py`, `ops/{hamming,ransac,ba_schur}.py`,
`lcdetection/mild.py`, `optimization/{bundle,posegraph}.py`,
`geometry/{camera,se3,transforms}.py`). Each file keeps its source's text
but for the kernels: their wrappers are gone and each dispatch runs the
plain PyTorch version on every device. Nothing of the program is imported.
"""
