"""The benchmark's frozen copies against their sources in the port, at
80x60: the input generator bit for bit, and the reference, which must read
every number of the comparison as 0 on the port's plain (CPU) path."""

from __future__ import annotations

import numpy as np
import torch
from conftest import TINY_CAMERA, tiny

from onepiece_tpu_torch.utils import synthetic as port_synthetic
from portbench import run
from portbench.inputs import synthetic
from portbench.reference import fused_dense_fusion as judge
from portbench.systems import fused_dense_fusion as system
from portbench.traffic import closed_scans


def test_trajectories_are_the_ports():
    for n in (16, 100):
        assert np.array_equal(synthetic.loop_trajectory(n), port_synthetic.loop_trajectory(n))


def test_render_and_sensor_model_are_the_ports():
    c = TINY_CAMERA
    poses = synthetic.loop_trajectory(100)[[0, 37, 71]]
    d, g = synthetic.render_batch(synthetic.default_scene(), torch.from_numpy(poses), c["fx"], c["fy"], c["cx"],
                                  c["cy"], c["height"], c["width"], num_steps=48)
    for i, pose in enumerate(poses):
        dp, gp = port_synthetic.render(port_synthetic.default_scene(), torch.from_numpy(pose), c["fx"], c["fy"],
                                       c["cx"], c["cy"], c["height"], c["width"], num_steps=48)
        assert torch.equal(d[i], dp) and torch.equal(g[i], gp)
    seed = 2**31 + 5
    gq, dq = port_synthetic.corrupt_sequence(g.numpy(), d.numpy(), seed=seed)
    gb, db = synthetic.corrupt_batch(g, d, seed)
    assert np.array_equal(gq, gb.numpy()) and np.array_equal(dq, db.numpy())
    gc, dc = synthetic.corrupt_sequence(g.numpy(), d.numpy(), seed=seed)
    assert np.array_equal(gq, gc) and np.array_equal(dq, dc)


def test_reference_reads_zero_on_the_ports_plain_path():
    _, cfg, mix = tiny(*run.load_cell("dense.loop"))
    dev = torch.device("cpu")
    frames = closed_scans.make_frames(cfg, mix, 2**31 + 3, dev)
    g, d, c = frames.scan(5, mix["scan_frames"])
    scan = system.Scan(cfg, dev)
    for i in range(0, mix["scan_frames"], mix["chunk"]):
        scan.feed(g[i : i + mix["chunk"]], d[i : i + mix["chunk"]], c[i : i + mix["chunk"]])
        scan.grow()
    out = scan.finish()
    readings = judge.judge(out, g, d, c, {**cfg, **mix})
    assert readings == {k: 0.0 for k in readings}, readings
    assert out.faces.shape[0] > 1000 and out.coords.shape[0] > 500
