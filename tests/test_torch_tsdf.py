"""Parity of the port's block keys, device hash table and TSDF pool
integration with the JAX package.

Tolerances:
  - touched_block_keys: equal at the identity pose; at a general pose the
    key sets differ on <= 0.5 % (float32 `floor` at block edges after a
    matmul summed in another order);
  - hash insert / insert_at / lookup: exactly equal given equal keys;
  - integrate_slots_reference (and the port's `integrate_blocks`) vs the
    exact oracle `integrate_blocks`: weights equal, sdf and colour <= 1e-6;
  - vs `integrate_slots_pallas(interpret=True)`: weights equal, sdf < 5e-4
    (its bf16 hi/lo depth split), colour < 5e-3 (bf16 gray or rgb), on an
    image no larger than the Pallas window so the window clips nothing.
Both image forms are held: gray ((2, H, W) [depth, gray], r = g = b) and
rgb ((4, H, W) [depth, r, g, b]; the Pallas kernel takes it packed by
`pack_image`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepiece_tpu.geometry import se3 as jse3
from onepiece_tpu.integration import device_hash as jdh
from onepiece_tpu.ops import tsdf as jtsdf
from onepiece_tpu.ops import tsdf_pallas as jtp
from onepiece_tpu.utils import synthetic as jsyn
from onepiece_tpu_torch.integration import device_hash as tdh
from onepiece_tpu_torch.ops import tsdf as ttsdf
from onepiece_tpu_torch.ops import tsdf_slots as tts

H, W = 120, 160
FX = FY = 80.0
CX, CY = 79.5, 59.5
VOX, TRUNC = 0.0125, 0.1
INVALID = ttsdf.INVALID_KEY


@pytest.fixture(scope="module")
def frame():
    """A rendered 160x120 frame of the default scene: (depth, gray)."""
    d, g = jsyn.render(jsyn.default_scene(), jnp.eye(4), FX, FY, CX, CY, H, W, num_steps=48)
    return np.array(d), np.array(g)


def _colour(frame, form):
    """(H, W, 3) colour of the frame: gray repeated, or seeded uniform rgb."""
    depth, gray = frame
    if form == "gray":
        return np.repeat(gray[..., None], 3, -1)
    return np.random.default_rng(1).uniform(0, 1, (H, W, 3)).astype(np.float32)


def _image(frame, form):
    """The port's channels-first image of the form."""
    depth, gray = frame
    if form == "gray":
        return np.stack([depth, gray])
    return np.concatenate([depth[None], np.moveaxis(_colour(frame, form), -1, 0)])


def _pose(xi):
    return np.array(jse3.se3_exp(jnp.asarray(xi, jnp.float32)))


def _keys(depth, T, max_blocks, stride):
    kt = ttsdf.touched_block_keys(
        torch.from_numpy(depth), torch.from_numpy(T), FX, FY, CX, CY, VOX, TRUNC,
        max_blocks=max_blocks, stride=stride,
    ).numpy()
    kj = np.asarray(jtsdf.touched_block_keys(
        jnp.asarray(depth), jnp.asarray(T), FX, FY, CX, CY, VOX, TRUNC,
        max_blocks=max_blocks, stride=stride,
    ))
    return kt, kj


@pytest.mark.parametrize("stride", [1, 3])
def test_touched_block_keys_equal_at_identity(frame, stride):
    kt, kj = _keys(frame[0], np.eye(4, dtype=np.float32), 8192, stride)
    assert kt.dtype == np.int32
    np.testing.assert_array_equal(kt, kj)
    assert 100 < (kt != INVALID).sum() < 8192


def test_touched_block_keys_general_pose(frame):
    kt, kj = _keys(frame[0], _pose([0.13, -0.07, 0.21, 0.11, -0.23, 0.05]), 4096, 2)
    st, sj = set(kt[kt != INVALID]), set(kj[kj != INVALID])
    assert len(st ^ sj) <= 0.005 * len(st | sj)
    # truncation at max_blocks keeps the smallest keys, saturating the buffer
    kt, kj = _keys(frame[0], np.eye(4, dtype=np.float32), 64, 2)
    np.testing.assert_array_equal(kt, kj)
    assert kt[-1] != INVALID


def test_unique_padded_matches_jnp_unique():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 300, 2000).astype(np.int32)
    keys[rng.uniform(size=2000) < 0.3] = INVALID
    for size in (50, 301, 400):
        np.testing.assert_array_equal(
            ttsdf.unique_padded(torch.from_numpy(keys), size).numpy(),
            np.asarray(jnp.unique(jnp.asarray(keys), size=size, fill_value=INVALID)),
        )
    np.testing.assert_array_equal(
        ttsdf.unpack_block_keys(keys[:50]), jtsdf.unpack_block_keys(jnp.asarray(keys[:50]))
    )


def _tables_equal(tt, tj):
    for name, a, b in zip(tj._fields, tt, tj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def _insert_both(tt, tj, keys, **kw):
    tt, st = tdh.insert(tt, torch.from_numpy(keys), **kw)
    tj, sj = jdh.insert(tj, jnp.asarray(keys), **kw)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    _tables_equal(tt, tj)
    return tt, tj, st.numpy()


def _frame_keys(depth, T, kmax=2048):
    return np.asarray(jtsdf.touched_block_keys(
        jnp.asarray(depth), jnp.asarray(T), FX, FY, CX, CY, VOX, TRUNC, max_blocks=kmax, stride=2))


def test_hash_insert_steady_state_matches_jax(frame):
    tt, tj = tdh.make_table(1 << 13, 4096, "cpu"), jdh.make_table(1 << 13, 4096)
    k0 = _frame_keys(frame[0], np.eye(4, dtype=np.float32))
    tt, tj, s0 = _insert_both(tt, tj, k0, claim_rounds=12)
    assert int(tt.num_active) == (k0 != INVALID).sum() and int(tt.overflow) == 0
    k1 = _frame_keys(frame[0], _pose([0.05, 0.0, 0.02, 0.0, 0.05, 0.0]))
    tt, tj, s1 = _insert_both(tt, tj, k1, claim_rounds=2)
    assert int(tt.num_active) > (k0 != INVALID).sum()
    for keys in (k0, k1):  # lookup finds every inserted key
        np.testing.assert_array_equal(
            tdh.lookup(tt, torch.from_numpy(keys)).numpy(), np.asarray(jdh.lookup(tj, jnp.asarray(keys))))
    np.testing.assert_array_equal(tdh.lookup(tt, torch.from_numpy(k1)).numpy(), s1)


def _colliding_keys(n, size):
    """n distinct packed keys whose hashes all land in a few cells."""
    cand = np.arange(1, 200000, dtype=np.int64)
    h = (cand * 2654435761) & 0xFFFFFFFF
    cell = (h ^ (h >> 15)) & (size - 1)
    keys = np.concatenate([cand[cell == c][: n // 2] for c in (5, 6)])
    keys = np.sort(keys[:n]).astype(np.int32)
    return np.concatenate([keys, np.full(8, INVALID, np.int32)])


def test_hash_insert_forced_collisions_match_jax():
    keys = _colliding_keys(24, 64)
    tt, tj = tdh.make_table(64, 64, "cpu"), jdh.make_table(64, 64)
    tt, tj, slots = _insert_both(tt, tj, keys, max_probes=16, claim_rounds=3)
    # 24 keys into a 16-probe window of 2 neighbouring cells: probe and round
    # exhaustion drops some, counted in overflow
    assert int(tt.overflow) == (slots[:24] < 0).sum() > 0
    # a second insert of the same keys resolves more of them
    _insert_both(tt, tj, keys, max_probes=16, claim_rounds=6)


def test_hash_insert_capacity_overflow_matches_jax(frame):
    keys = _frame_keys(frame[0], np.eye(4, dtype=np.float32))
    tt, tj = tdh.make_table(1 << 12, 100, "cpu"), jdh.make_table(1 << 12, 100)
    tt, tj, slots = _insert_both(tt, tj, keys, claim_rounds=6)
    n = (keys != INVALID).sum()
    assert int(tt.num_active) == 100 and int(tt.overflow) == n - 100 == (slots[:n] < 0).sum()


def test_hash_insert_at_matches_jax(frame):
    keys = _frame_keys(frame[0], np.eye(4, dtype=np.float32))
    slots = np.random.default_rng(0).permutation(len(keys)).astype(np.int32)
    tt = tdh.insert_at(tdh.make_table(1 << 12, 2048, "cpu"), torch.from_numpy(keys), torch.from_numpy(slots))
    tj = jdh.insert_at(jdh.make_table(1 << 12, 2048), jnp.asarray(keys), jnp.asarray(slots))
    _tables_equal(tt, tj)
    with pytest.raises(ValueError, match="power of 2"):
        tdh.make_table(100, 10, "cpu")


def _pool_and_slots(depth, T, nb_max, pad):
    """A pool with random prior content for the blocks a frame touches."""
    keys = _frame_keys(depth, T)
    keys = keys[keys != INVALID][:nb_max]
    nb = len(keys)
    rng = np.random.default_rng(1)
    vox = np.zeros((nb + 1, 5, 512), np.float32)
    vox[:, 0] = rng.uniform(-1, 1, (nb + 1, 512))
    vox[:, 1] = rng.uniform(0, 3, (nb + 1, 512)).round()
    vox[:, 1, ::7] = 0.0
    vox[:, 2:5] = rng.uniform(0, 1, (nb + 1, 3, 512))
    keys_p = np.full(nb + pad, INVALID, np.int32)
    keys_p[:nb] = keys
    slots = np.full(nb + pad, nb, np.int32)
    slots[:nb] = rng.permutation(nb)
    return vox, keys_p, slots, nb


@pytest.mark.parametrize("form", ["gray", "rgb"])
def test_integrate_slots_reference_matches_oracle(frame, form):
    depth, _ = frame
    rgb = _colour(frame, form)
    T_wc = _pose([0.02, -0.01, 0.03, 0.01, 0.02, -0.01])
    T_cw = np.linalg.inv(T_wc).astype(np.float32)
    vox, keys, slots, nb = _pool_and_slots(depth, T_wc, 400, 50)
    out = tts.integrate_slots(
        torch.from_numpy(vox.copy()), torch.from_numpy(keys), torch.from_numpy(slots),
        torch.from_numpy(_image(frame, form)), torch.from_numpy(T_cw), FX, FY, CX, CY, VOX, TRUNC,
    ).numpy()
    rows = slots[:nb]
    bc = jdh.unpack_keys(jnp.asarray(keys[:nb]))
    s1, w1, c1 = jtsdf.integrate_blocks(
        jnp.asarray(vox[rows, 0]), jnp.asarray(vox[rows, 1]), jnp.asarray(np.moveaxis(vox[rows, 2:5], 1, -1)),
        bc, jnp.ones(nb, bool), jnp.asarray(depth), jnp.asarray(rgb),
        jnp.asarray(T_cw), FX, FY, CX, CY, VOX, TRUNC,
    )
    assert (np.asarray(w1) != vox[rows, 1]).sum() > 20000, "must exercise real updates"
    np.testing.assert_array_equal(out[rows, 1], np.asarray(w1))
    assert np.abs(out[rows, 0] - np.asarray(s1)).max() <= 1e-6
    assert np.abs(np.moveaxis(out[rows, 2:5], 1, -1) - np.asarray(c1)).max() <= 1e-6
    # the port's own copy of the oracle
    s2, w2, c2 = ttsdf.integrate_blocks(
        torch.from_numpy(vox[rows, 0]), torch.from_numpy(vox[rows, 1]),
        torch.from_numpy(np.moveaxis(vox[rows, 2:5], 1, -1)), torch.from_numpy(np.asarray(bc)),
        torch.ones(nb, dtype=torch.bool), torch.from_numpy(depth),
        torch.from_numpy(rgb), torch.from_numpy(T_cw), FX, FY, CX, CY, VOX, TRUNC,
    )
    np.testing.assert_array_equal(w2.numpy(), np.asarray(w1))
    assert np.abs(s2.numpy() - np.asarray(s1)).max() <= 1e-6
    assert np.abs(c2.numpy() - np.asarray(c1)).max() <= 1e-6


@pytest.mark.parametrize("form", ["gray", "rgb"])
def test_integrate_slots_reference_matches_pallas_kernel(frame, form):
    depth, _ = frame
    assert H <= jtp.WIN_R and W <= jtp.WIN_C  # the Pallas window clips nothing
    T_wc = _pose([0.01, 0.02, -0.02, -0.01, 0.015, 0.0])
    T_cw = np.linalg.inv(T_wc).astype(np.float32)
    vox, keys, slots, nb = _pool_and_slots(depth, T_wc, 48, 16)
    img = _image(frame, form)
    out_t = tts.integrate_slots_reference(
        torch.from_numpy(vox.copy()), torch.from_numpy(keys), torch.from_numpy(slots),
        torch.from_numpy(img), torch.from_numpy(T_cw), FX, FY, CX, CY, VOX, TRUNC,
    ).numpy()
    # the Pallas kernel's gray form is the f32 (2, H, W) image; its rgb form the bf16 packing
    img_j = jnp.asarray(img) if form == "gray" else jtp.pack_image(jnp.asarray(depth), jnp.asarray(_colour(frame, form)))
    out_j = np.asarray(jtp.integrate_slots_pallas(
        jnp.asarray(vox), jnp.asarray(keys), jnp.asarray(slots), img_j,
        jnp.asarray(T_cw), FX, FY, CX, CY, VOX, TRUNC, interpret=True,
    ))
    rows = slots[:nb]
    assert (out_t[rows, 1] != vox[rows, 1]).sum() > 2000
    np.testing.assert_array_equal(out_t[rows, 1], out_j[rows, 1])
    assert np.abs(out_t[rows, 0] - out_j[rows, 0]).max() < 5e-4
    assert np.abs(out_t[rows, 2:5] - out_j[rows, 2:5]).max() < 5e-3


def test_integrate_slots_skips_slots_outside_the_pool(frame):
    """A slot outside [0, B] changes nothing, as a padding key does (the
    kernel skips such slots; it cannot raise without a host sync)."""
    depth, gray = frame
    T_wc = _pose([0.01, 0.02, -0.02, -0.01, 0.015, 0.0])
    vox, keys, slots, nb = _pool_and_slots(depth, T_wc, 48, 16)
    args = (torch.from_numpy(np.stack([depth, gray])),
            torch.from_numpy(np.linalg.inv(T_wc).astype(np.float32)), FX, FY, CX, CY, VOX, TRUNC)
    bad = slots.copy()
    bad[:2] = [-3, nb + 7]
    padded = keys.copy()
    padded[:2] = INVALID
    out_bad = tts.integrate_slots(torch.from_numpy(vox.copy()), torch.from_numpy(keys),
                                  torch.from_numpy(bad), *args).numpy()
    out_pad = tts.integrate_slots(torch.from_numpy(vox.copy()), torch.from_numpy(padded),
                                  torch.from_numpy(slots), *args).numpy()
    np.testing.assert_array_equal(out_bad[:nb], out_pad[:nb])
    np.testing.assert_array_equal(out_bad[slots[:2]], vox[slots[:2]])
    assert (out_bad[:nb, 1] != vox[:nb, 1]).sum() > 2000


@pytest.mark.parametrize("case", ["three_channels", "float64", "two_dims"])
def test_integrate_slots_rejects_other_images(frame, case):
    """Only (2, H, W) and (4, H, W) float32 images are taken, on every device."""
    depth, gray = frame
    vox, keys, slots, _ = _pool_and_slots(depth, np.eye(4, dtype=np.float32), 8, 2)
    img = {"three_channels": np.stack([depth, gray, gray]), "float64": np.stack([depth, gray]).astype(np.float64),
           "two_dims": depth}[case]
    with pytest.raises(ValueError, match="expected \\(2, H, W\\)"):
        tts.integrate_slots(torch.from_numpy(vox), torch.from_numpy(keys), torch.from_numpy(slots),
                            torch.from_numpy(img), torch.eye(4), FX, FY, CX, CY, VOX, TRUNC)


def test_pool_layout_matches_jax():
    vox = np.random.default_rng(2).normal(size=(4, 5, 512)).astype(np.float32)
    for a, b in zip(tts.pool_to_blocks(torch.from_numpy(vox)), jtp.pool_to_blocks(jnp.asarray(vox))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tts.make_pool(3, "cpu").numpy(), np.asarray(jtp.make_pool(3)))
