"""The port's `parallel/` against the JAX package's, on the CPU.

JAX runs its sharded functions on a `Mesh` of 2 and of 4 of the virtual CPU
devices that `tests/conftest.py` forces, with the Pallas TSDF kernel in
interpret mode (as `tests/test_parallel.py` runs it). The port runs the
same modules over 2 and 4 gloo processes (`parallel/launch.spawn`, one
spawn of 4 ranks for the whole module, each world over the subgroup of its
first ranks: `parallel/drive.run_modules`), on the same inputs. Tolerances:

  - dense (80x60 pair): T against JAX's sharded T within 1e-5, inliers
    equal; every rank's T equal;
  - tsdf (64 blocks): sdf, weight and colour within 1e-6 of JAX's;
  - fused (3 frames of the orbit at 80x60): the {key -> pool row} maps
    equal to JAX's; the gathered pool bit-equal to the port's unsharded
    pool (`ops/tsdf_slots.integrate_slots` on one pool, the same keys and
    slots); in the band that `tests/test_torch_fused_slam.py` holds the
    port's TSDF to: weights equal to JAX's exact oracle and sdf / colour
    within 1e-6 of it, and against JAX's Pallas rows (weights equal, sdf <
    5e-4, colour < 5e-3) agreeing exactly where the oracle does (over 99.9
    % of the updated voxels);
  - mc (JAX's sharded pool, under its 96-a-block cap): sorted triangle
    rows within 1e-6 of JAX's `extract_mesh_sharded_host`; after
    `reshard_blocks` num_active equal, overflow 0, the mesh unchanged as a
    sorted set;
  - ba (JAX's `dryrun` problem and one with P = 64 x world): new poses and
    points within 1e-4 relative to JAX's;
  - posegraph (the ring of `tests/test_parallel.py:61`): within 1e-5 of
    JAX's, bit-identical across ranks.

Also: the two faults of the JAX reference the port does not copy (the
fused step's silent `kmax` cap, the 96-a-block triangle cap), `spawn`
raising with a failing rank's traceback, and every new module, tool and
`chip_smoke.py` importing where `jax` and `onepiece_tpu` cannot be
imported. Torch is pinned to one intra-op thread while the module runs (the
ranks pin themselves).
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from onepiece_tpu.geometry import se3 as jse3
from onepiece_tpu.geometry.camera import PinholeCamera as JCam
from onepiece_tpu.integration import device_hash as jdh
from onepiece_tpu.odometry import dense as jdense
from onepiece_tpu.ops import tsdf as jtsdf
from onepiece_tpu.optimization import posegraph as jpg
from onepiece_tpu.parallel import ba as jpba
from onepiece_tpu.parallel import dense as jpdense
from onepiece_tpu.parallel import fused as jpfused
from onepiece_tpu.parallel import mc as jpmc
from onepiece_tpu.parallel import posegraph as jppg
from onepiece_tpu.parallel import tsdf as jptsdf
from onepiece_tpu_torch.geometry import se3 as tse3
from onepiece_tpu_torch.geometry.camera import PinholeCamera as TCam
from onepiece_tpu_torch.integration import device_hash as tdh
from onepiece_tpu_torch.ops import tsdf as ttsdf
from onepiece_tpu_torch.ops import tsdf_slots
from onepiece_tpu_torch.ops.image import bilateral_filter
from onepiece_tpu_torch.parallel import drive, launch
from onepiece_tpu_torch.utils import synthetic
from torch_parallel_ranks import collectives, expected_collectives, failing_rank, parallel_checks

REPO = Path(__file__).resolve().parent.parent
CAM = dict(fx=50.0, fy=50.0, cx=39.5, cy=29.5, width=80, height=60, depth_scale=1000.0)
WORLDS = (2, 4)
FUSED = dict(capacity=512 * 4, table_size=1 << 13, voxel_size=0.05, truncation=0.2, kmax=1024, stride=4,
             claim_rounds=(6, 6))  # JAX's fused step inserts with its default 6 rounds
N_FUSED = 3
KMAX_SMALL = 64  # a touched-key cap the first frame's few hundred blocks overfill
INVALID = ttsdf.INVALID_KEY


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ba_problem(P: int, F: int = 4, Omax: int = 3, seed: int = 0) -> dict:
    """JAX's `parallel/ba.dryrun` problem at P points (its own seed and draws)."""
    rng = np.random.default_rng(seed)
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (F, 4, 4)).copy()
    pts = (rng.uniform(-0.5, 0.5, (P, 3)) + np.array([0, 0, 2.0])).astype(np.float32)
    frame_pp = rng.integers(0, F, (P, Omax)).astype(np.int64)
    z = pts[:, 2:3]
    uv = np.stack([pts[:, 0:1] / z * 300.0 + 160.0 + rng.normal(0, 1, (P, 1)),
                   pts[:, 1:2] / z * 300.0 + 120.0 + rng.normal(0, 1, (P, 1))], -1).repeat(Omax, 1)
    return dict(poses=poses, points=pts, frame_pp=frame_pp, uv_pp=uv.astype(np.float32),
                mask_pp=np.ones((P, Omax), bool), lam=1e-4, intr=(300.0, 300.0, 160.0, 120.0))


@pytest.fixture(scope="module")
def inputs():
    tcam = TCam(**CAM)
    scene = synthetic.default_scene()
    poses = synthetic.orbit_trajectory(16)[:N_FUSED]
    frames = [synthetic.render(scene, torch.from_numpy(p), tcam.fx, tcam.fy, tcam.cx, tcam.cy, tcam.height,
                               tcam.width, num_steps=48) for p in poses]
    # the orbit's own poses: a general pose even at frame 0, so that no voxel
    # centre projects onto a pixel boundary (an identity pose puts whole rows there)
    fused = dict(FUSED, depths=np.stack([bilateral_filter(d).numpy() for d, _ in frames]),
                 grays=np.stack([g.numpy() for _, g in frames]), poses=poses.astype(np.float32))
    return dict(camera=tcam, dense=drive.render_pair(tcam), tsdf=drive.tsdf_inputs(tcam, fused["depths"][0], 64),
                fused=fused, posegraph=drive.ring_posegraph())


def jax_fused(mesh, inp):
    """JAX's sharded fused steps over the frames, the step under one `jit`
    (eager `shard_map` runs op by op: the same pool and table, twice the
    time): (sharded pool, table)."""
    c, f = JCam(**CAM), inp["fused"]
    n = mesh.shape["d"]
    vox = jpfused.make_sharded_pool(mesh, f["capacity"] // n)
    table = jdh.make_table(f["table_size"], f["capacity"])
    step = jax.jit(functools.partial(
        jpfused.fused_tsdf_step_sharded, mesh=mesh, fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, voxel_size=f["voxel_size"],
        truncation=f["truncation"], kmax=f["kmax"], stride=f["stride"], interpret=True))
    for d, g, T in zip(f["depths"], f["grays"], f["poses"]):
        vox, table = step(vox, table, jnp.asarray(d), jnp.asarray(g), jnp.asarray(T))
    return vox, table


def checkerboard_pool():
    """Two blocks of a checkerboard sdf (1,000+ triangles each) at slots 0
    and 1 of a 4-slot pool, and its table: JAX's 96-a-block cap bites."""
    i, j, k = np.meshgrid(*[np.arange(8)] * 3, indexing="ij")
    checker = np.where((i + j + k) % 2 == 0, 0.5, -0.5).astype(np.float32).reshape(512)
    pool = np.zeros((4, 5, 512), np.float32)
    pool[:, 0] = ttsdf.EMPTY_SDF
    pool[:2, 0], pool[:2, 1], pool[:2, 2:5] = checker, 1.0, 0.5
    keys = ttsdf.pack_block_keys(torch.tensor([[0, 0, 2], [3, 0, 2]])).to(torch.int32)
    table, _ = tdh.insert(tdh.make_table(64, 4, "cpu"), keys)
    return pool, tuple(a.numpy() for a in table)


@pytest.fixture(scope="module")
def runs(inputs):
    """Both packages at each world size: JAX on a mesh of that many virtual
    devices, the port over that many gloo processes. One spawn of
    max(WORLDS) ranks runs every world, each over the subgroup of its first
    ranks (`torch_parallel_ranks.parallel_checks`); at the smallest world it
    also runs the checks of the JAX faults."""
    out, inps, wide = {}, {}, {}
    for n in WORLDS:
        mesh = Mesh(np.array(jax.devices()[:n]), ("d",))
        vox_j, table_j = jax_fused(mesh, inputs)
        pool_j = np.asarray(jpfused.gather_pool(vox_j))
        dry = ba_problem(8 * n)
        bas = {"dryrun": {k: v.astype(np.float64) if k in ("poses", "points", "uv_pp") else v
                          for k, v in dry.items()}, "wide": ba_problem(64 * n)}
        inps[n] = dict(inputs, ba=bas["dryrun"], mc=dict(pool=pool_j[:-1], table=tuple(np.asarray(a) for a in table_j),
                                                         voxel_size=FUSED["voxel_size"]))
        wide[n] = bas["wide"]
        out[n] = dict(n=n, mesh=mesh, bas=bas, vox_j=vox_j, table_j=table_j, pool_j=pool_j)
    pool, table = checkerboard_pool()
    faults = dict(kmax=KMAX_SMALL, mc=dict(pool=pool, table=table, voxel_size=0.05))
    ranks = launch.spawn(max(WORLDS), parallel_checks, inps, wide, faults, backend="gloo", device="cpu", timeout=300)
    for n in WORLDS:
        out[n]["ranks"] = [r[n] for r in ranks if n in r]
        assert len(out[n]["ranks"]) == n
    return out


@pytest.fixture(params=WORLDS)
def world(request, runs):
    return runs[request.param]


def test_psum_and_dense(world, inputs):
    c = JCam(**CAM)
    d = inputs["dense"]
    src = jdense.preprocess_frame(jnp.asarray(d["src_gray"]), jnp.asarray(d["src_depth"]), c)
    tgt = jdense.preprocess_frame(jnp.asarray(d["tgt_gray"]), jnp.asarray(d["tgt_depth"]), c)
    res = jpdense.dense_tracking_sharded(src, tgt, c, world["mesh"])
    for r in world["ranks"]:
        assert float(r["psum"]["value"][0]) == world["n"] * (world["n"] + 1) / 2
        np.testing.assert_array_equal(r["dense"]["T"], world["ranks"][0]["dense"]["T"])
        assert r["dense"]["comm"]["psum"]["calls"] == sum(jdense.DEFAULT_ITERS)
    got = world["ranks"][0]["dense"]
    assert np.abs(got["T"] - np.asarray(res.T_ts)).max() <= 1e-5
    assert float(got["inliers"]) == float(res.num_inliers)


def test_tsdf_matches_jax(world, inputs):
    c, t = JCam(**CAM), inputs["tsdf"]
    b = len(t["coords"])
    sdf, w, col = jptsdf.integrate_blocks_sharded(
        jnp.full((b, 512), ttsdf.EMPTY_SDF), jnp.zeros((b, 512)), jnp.zeros((b, 512, 3)), jnp.asarray(t["coords"]),
        jnp.ones((b,), bool), jnp.asarray(t["depth"]), jnp.asarray(t["rgb"]), jnp.asarray(t["T_cw"]),
        world["mesh"], c.fx, c.fy, c.cx, c.cy, t["voxel_size"], t["truncation"])
    got = world["ranks"][0]["tsdf"]
    assert got["updated"] > 1000
    for name, want in (("sdf", sdf), ("weight", w), ("color", col)):
        assert np.abs(got[name] - np.asarray(want)).max() <= 1e-6, name


def _block_slots(keys, slots):
    ok = (keys != INVALID) & (slots >= 0)
    return dict(zip(keys[ok].tolist(), slots[ok].tolist()))


def test_fused_matches_jax_and_the_unsharded_pool(world, inputs):
    got = world["ranks"][0]["fused"]
    f = inputs["fused"]
    assert got["key_saturated_frames"] == 0 and got["overflow"] == 0
    maps = _block_slots(got["table"].table_keys, got["table"].table_slots)
    t = world["table_j"]
    assert maps == _block_slots(np.asarray(t.table_keys), np.asarray(t.table_slots)) and len(maps) > 50
    # the port's unsharded pool: the same key pass and insert, one pool
    c = inputs["camera"]
    pool = tsdf_slots.make_pool(f["capacity"], "cpu")
    table = tdh.make_table(f["table_size"], f["capacity"], "cpu")
    for d, g, T in zip(*(torch.from_numpy(f[k]) for k in ("depths", "grays", "poses"))):
        keys = ttsdf.touched_block_keys(d, T, c.fx, c.fy, c.cx, c.cy, f["voxel_size"], f["truncation"],
                                        max_blocks=f["kmax"], stride=f["stride"])
        table, slots = tdh.insert(table, keys, claim_rounds=6)
        tsdf_slots.integrate_slots(pool, keys, torch.where(slots < 0, f["capacity"], slots).to(torch.int32),
                                   torch.stack([d, g]), tse3.inverse_T(T), c.fx, c.fy, c.cx, c.cy,
                                   f["voxel_size"], f["truncation"])
    np.testing.assert_array_equal(got["pool"], pool[:-1].numpy())
    # against JAX's Pallas rows (same slots), in the band of the port's TSDF
    # tests: the port is the exact oracle's (JAX `integrate_blocks` on each
    # frame's touched blocks), and strays from the Pallas rows exactly where
    # the oracle does (its transform rounds a few voxels to a neighbouring pixel)
    oracle = jax_oracle_pool(inputs, world["table_j"])
    port, pallas = got["pool"], world["pool_j"][:-1]
    close = (port[:, 1] == oracle[:, 1]) & (np.abs(port - oracle)[:, [0, 2, 3, 4]].max(1) <= 1e-6)
    assert close.all(), (~close).sum()
    def agrees(x):
        return ((x[:, 1] == pallas[:, 1]) & (np.abs(x[:, 0] - pallas[:, 0]) < 5e-4)
                & (np.abs(x[:, 2:5] - pallas[:, 2:5]).max(1) < 5e-3))

    upd = pallas[:, 1] > 0
    np.testing.assert_array_equal(agrees(port)[upd], agrees(oracle)[upd])
    assert upd.sum() > 10000 and agrees(port)[upd].mean() > 0.999


def jax_oracle_pool(inputs, table_j) -> np.ndarray:
    """The fused frames through JAX's exact oracle `integrate_blocks`, each
    frame on the blocks its key pass touches, at their slots in `table_j`."""
    c, f = JCam(**CAM), inputs["fused"]
    keys_all = np.asarray(table_j.table_keys)
    slot_of = _block_slots(keys_all, np.asarray(table_j.table_slots))
    pool = np.zeros((f["capacity"] + 1, 5, 512), np.float32)
    pool[:, 0] = ttsdf.EMPTY_SDF
    for d, g, T in zip(f["depths"], f["grays"], f["poses"]):
        keys = np.asarray(jtsdf.touched_block_keys(jnp.asarray(d), jnp.asarray(T), c.fx, c.fy, c.cx, c.cy,
                                                   f["voxel_size"], f["truncation"], max_blocks=f["kmax"],
                                                   stride=f["stride"]))
        real = keys != INVALID  # the padding rows are inactive and read the spare last row
        rows = np.array([slot_of[k] if ok else f["capacity"] for k, ok in zip(keys.tolist(), real)])
        s, w, col = jtsdf.integrate_blocks(
            jnp.asarray(pool[rows, 0]), jnp.asarray(pool[rows, 1]), jnp.asarray(np.moveaxis(pool[rows, 2:5], 1, -1)),
            jdh.unpack_keys(jnp.asarray(keys, jnp.int32)), jnp.asarray(real), jnp.asarray(d),
            jnp.asarray(np.repeat(g[..., None], 3, -1)), jse3.inverse_T(jnp.asarray(T)), c.fx, c.fy, c.cx, c.cy,
            f["voxel_size"], f["truncation"])
        rows, s, w, col = rows[real], np.asarray(s)[real], np.asarray(w)[real], np.asarray(col)[real]
        pool[rows, 0], pool[rows, 1], pool[rows, 2:5] = s, w, np.moveaxis(col, -1, 1)
    return pool[:-1]


def _sorted(a):
    f = a.reshape(len(a), -1)
    return f[np.lexsort(f.T[::-1])]


def test_mc_and_migration_match_jax(world):
    got = world["ranks"][0]["mc"]
    verts, cols = jpmc.extract_mesh_sharded_host(world["vox_j"], world["table_j"], world["mesh"],
                                                 FUSED["voxel_size"])
    want = np.stack([verts, cols], 1)
    assert len(got["tri"]) == len(want) > 1000
    assert np.abs(_sorted(got["tri"]) - _sorted(want)).max() <= 1e-6
    assert got["num_active_after"] == int(world["table_j"].num_active) and got["overflow_after"] == 0
    np.testing.assert_array_equal(_sorted(got["tri_after"]), _sorted(got["tri"]))
    blocks = [r["mc"]["blocks_here_after"] for r in world["ranks"]]
    assert sum(blocks) == got["num_active_after"] and min(blocks) > 0  # spread over every rank


@pytest.mark.parametrize("problem", ["dryrun", "wide"])
def test_ba_matches_jax(world, problem):
    """JAX's `dryrun` problem sees every point from one camera centre thrice
    (all poses the identity), so its depths are unobservable and its damped
    V blocks reach condition 6.6e5: there the float32 step is set by
    rounding (the port 3.2e-4 from JAX's float64 step, JAX 3.7e-8: their
    roundings differ) and both packages run it in float64, as
    `tests/test_torch_bundle.py` compares the 2-D model (the port's float64
    step is JAX's to 1e-12). The wider problem runs in float32."""
    b = world["bas"][problem]
    key = "ba" if problem == "dryrun" else "wide_ba"
    with jax.enable_x64(problem == "dryrun"):
        # under one `jit`, as a caller runs a `shard_map` (eager, it runs op by op: 30x the time)
        step = jax.jit(functools.partial(jpba.distributed_ba_step, mesh=world["mesh"], lam=b["lam"]))
        poses, points, cost = step(jnp.asarray(b["poses"]), jnp.asarray(b["points"]),
                                   jnp.asarray(b["frame_pp"], jnp.int32), jnp.asarray(b["uv_pp"]),
                                   jnp.asarray(b["mask_pp"]))
    got = world["ranks"][0][key]
    assert got["poses"].dtype == b["poses"].dtype
    for r in world["ranks"]:
        np.testing.assert_array_equal(r[key]["poses"], got["poses"])
    for name, want in (("poses", poses), ("points", points)):
        want = np.asarray(want)
        assert np.abs(got[name] - want).max() <= 1e-4 * np.abs(want).max(), name
    assert abs(float(got["cost"]) - float(cost)) <= 1e-4 * abs(float(cost))
    assert np.abs(got["points"] - b["points"]).max() > 1e-3  # the step moved the points


def test_posegraph_matches_jax(world, inputs):
    g = inputs["posegraph"]
    edges = jpg.PoseGraphEdges(*(jnp.asarray(g[k]) for k in ("src", "dst", "p_src", "p_dst", "valid", "edge_valid")))
    want, _ = jppg.optimize_pose_graph_sharded(jnp.asarray(g["poses"]), jppg.shard_edges(edges, world["mesh"]),
                                               world["mesh"], iters=g["iters"])
    got = world["ranks"][0]["posegraph"]["poses"]
    for r in world["ranks"]:
        np.testing.assert_array_equal(r["posegraph"]["poses"], got)
    assert np.abs(got - np.asarray(want)).max() <= 1e-5
    assert np.abs(got - g["gt"]).max() <= 1e-3


# ---- faults of the JAX reference that the port does not copy ---------------


def test_fused_step_does_not_drop_keys_past_kmax(runs, inputs):
    """JAX's sharded fused step passes `kmax` (4,096 by default) to its key
    pass (`parallel/fused.py:52`), which keeps the first `kmax` keys and
    drops the rest without a word. The port's redoes the pass at twice the
    cap and counts the frame: at kmax = 64 (the first frame touches a few
    hundred blocks) every block is allocated, the pool is the one a cap
    that fits gives, and the frame counts as saturated."""
    small, fits = runs[min(WORLDS)]["ranks"][0]["faults"]["fused"]
    assert small["saturated"] and not fits["saturated"] and small["kmax"] >= 2 * KMAX_SMALL
    assert small["num_active"] == fits["num_active"] > KMAX_SMALL
    assert small["pool_digest"] == fits["pool_digest"]
    c, f = JCam(**CAM), inputs["fused"]
    keys = np.asarray(jtsdf.touched_block_keys(jnp.asarray(f["depths"][0]), jnp.asarray(f["poses"][0]), c.fx, c.fy,
                                               c.cx, c.cy, f["voxel_size"], f["truncation"], max_blocks=KMAX_SMALL,
                                               stride=f["stride"]))
    assert (keys != INVALID).sum() == KMAX_SMALL < small["num_active"]  # JAX keeps 64 of them


def test_mc_does_not_cap_triangles_per_block(runs):
    """JAX's sharded extraction sizes each shard's output at `cap_per_block`
    (96) triangles a block and drops what is past it. Two blocks of a
    checkerboard sdf hold 1,000+ triangles each: JAX's extraction over 2
    devices keeps 2 x 96 on the shard holding them; the port's (its kernel
    caps nothing) keeps every one, as the unsharded plain version finds."""
    from onepiece_tpu_torch.ops import marching_cubes as tmc

    pool, table = checkerboard_pool()
    want, _ = tmc.extract_triangles(torch.from_numpy(np.concatenate([pool, np.zeros_like(pool[:1])])),
                                    torch.arange(2, dtype=torch.int32), torch.full((2, 7), -1, dtype=torch.int32),
                                    torch.from_numpy(table[2][:2]), 0.05)
    assert len(want) > 2 * 96 * 2
    got = runs[min(WORLDS)]["ranks"][0]["faults"]["mc"]
    assert got["triangles"] == len(want)
    np.testing.assert_array_equal(got["tri"][:, 0], want.numpy())
    mesh = Mesh(np.array(jax.devices()[:2]), ("d",))
    vox_sh = jnp.asarray(np.concatenate([pool.reshape(2, 2, 5, 512), np.zeros((2, 1, 5, 512), np.float32)], 1))
    verts, _ = jpmc.extract_mesh_sharded_host(vox_sh, jdh.BlockHashTable(*map(jnp.asarray, table)), mesh, 0.05)
    assert len(verts) == 2 * 96 < got["triangles"]


# ---- the launcher ------------------------------------------------------------


def test_collectives_at_world_3():
    """The four collectives' values on every rank of an odd world (the ring
    wraps unevenly), with the bytes each rank put in counted and nothing
    staged (CPU tensors)."""
    for r, got in enumerate(launch.spawn(3, collectives, backend="gloo", device="cpu", timeout=120)):
        for name, want in expected_collectives(r, 3).items():
            np.testing.assert_array_equal(got[name], want)
            assert got["stats"][name]["calls"] == 1 and got["stats"][name]["staged_bytes"] == 0
        assert got["stats"]["psum"]["bytes"] == 24 and got["stats"]["all_to_all"]["bytes"] == 72


def test_spawn_raises_with_the_failing_ranks_traceback():
    with pytest.raises(RuntimeError) as err:
        launch.spawn(2, failing_rank, backend="gloo", device="cpu", timeout=120)
    msg = str(err.value)
    assert "of failing_rank failed" in msg and "--- rank 1 ---" in msg
    assert "ValueError: rank 1 fails on purpose" in msg.split("--- rank 1 ---")[1]


def test_spawn_refuses_what_cannot_run_as_asked():
    with pytest.raises(ValueError, match="backend='gloo'"):
        launch.spawn(1, failing_rank, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        launch.spawn(1, failing_rank, backend="mpi", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch.spawn(1, failing_rank, backend="gloo", device="cuda")


# ---- no JAX -----------------------------------------------------------------

_NO_JAX = (
    "import sys, importlib.abc\n"
    "class NoJax(importlib.abc.MetaPathFinder):\n"
    "    def find_spec(self, name, path, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'onepiece_tpu'):\n"
    "            raise ImportError(name + ' is blocked')\n"
    "sys.meta_path.insert(0, NoJax())\n"
)


def run_without_jax(code: str, cwd, timeout: float = 240) -> subprocess.CompletedProcess:
    """`code` in a fresh interpreter where `jax`, `jaxlib` and `onepiece_tpu`
    cannot be imported; spawned ranks inherit `sys.path`, whose first entry
    is a folder of stand-in packages that raise on import."""
    block = Path(cwd) / "no_jax"
    for name in ("jax", "jaxlib", "onepiece_tpu"):
        (block / name).mkdir(parents=True, exist_ok=True)
        (block / name / "__init__.py").write_text(f"raise ImportError('{name} is blocked')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    prelude = _NO_JAX + f"sys.path.insert(0, {str(REPO)!r}); sys.path.insert(0, {str(block)!r})\n"
    return subprocess.run([sys.executable, "-c", prelude + code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_parallel_and_chip_smoke_import_without_jax(tmp_path):
    code = (
        "import importlib\n"
        "for m in ('comm', 'launch', 'dense', 'tsdf', 'fused', 'mc', 'posegraph', 'ba', 'submap', 'drive'):\n"
        "    importlib.import_module('onepiece_tpu_torch.parallel.' + m)\n"
        f"sys.path.insert(0, {str(REPO / 'tools')!r})\n"
        "import chip_smoke, torch_launch_distributed, torch_scaling_test, torch_oppo_to_tum\n"
        "assert 'jax' not in sys.modules and 'onepiece_tpu' not in sys.modules\n"
        "print('imported')\n"
    )
    res = run_without_jax(code, tmp_path)
    assert res.returncode == 0 and "imported" in res.stdout, res.stderr


def test_launch_and_scaling_tools_on_the_cpu_without_jax(tmp_path):
    """`tools/torch_launch_distributed.py --device cpu --backend gloo` and
    `tools/torch_scaling_test.py --device cpu` where `jax` cannot be imported
    (the ranks import neither, or they would fail)."""
    code = "import runpy\n" + "".join(
        f"sys.argv = {[f'tools/{tool}.py', *args]!r}\n"
        f"try:\n    runpy.run_path({str(REPO / 'tools' / (tool + '.py'))!r}, run_name='__main__')\n"
        "except SystemExit as e:\n    assert e.code in (0, None), e.code\n"
        for tool, args in (("torch_launch_distributed", ["--device", "cpu", "--backend", "gloo"]),
                           ("torch_scaling_test", ["--device", "cpu", "--worlds", "1", "2", "--submap-world", "2"]))
    ) + "assert 'jax' not in sys.modules and 'onepiece_tpu' not in sys.modules\n"
    res = run_without_jax(code, tmp_path, timeout=400)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "2/2 workers ok" in res.stdout, res.stdout
    assert "scaling test ok" in res.stdout and "200 GB/s" not in res.stdout and "efficiency" not in res.stdout
