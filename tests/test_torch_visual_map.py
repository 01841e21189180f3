"""Port parity: the visual map against the JAX package.

One op stream (image pushes past the pool's depth, point batches that
collide in a small voxel hash and overflow the point pool, observation
appends past a full ring, compaction, lookups) goes through both
packages. Integer fields must be array-equal, float fields within 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastlivo_tpu import visual_map as jvm

from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch import visual_map as tvm

NP, KO, T, VC, R, H, W = 64, 3, 32, 4, 4, 24, 32
INT_FIELDS = ("n_obs", "n_pts", "obs_slot", "obs_fid", "obs_level",
              "vox_keys", "vox_count", "vox_idx", "img_fid", "imgs")


def maps():
    kw = dict(n_points=NP, n_obs=KO, table_size=T, voxel_cap=VC, ring=R,
              height=H, width=W)
    mj = jvm.empty_visual_map(**kw, img_dtype=jnp.uint8)
    mt = tvm.empty_visual_map(**kw, img_dtype=torch.uint8, device="cpu")
    return mj, mt


def assert_same(mj, mt):
    a = {f: np.asarray(v) for f, v in mj._asdict().items()}
    b = convert.visual_map_to_arrays(mt)
    for f in tvm.VisualMap._fields:
        assert a[f].dtype == b[f].dtype and a[f].shape == b[f].shape, f
        if f in INT_FIELDS:
            np.testing.assert_array_equal(b[f], a[f], err_msg=f)
        else:
            np.testing.assert_allclose(b[f], a[f], rtol=1e-6, atol=1e-6, err_msg=f)


def test_jax_keeps_the_last_duplicate_scatter_update():
    """The rule the port reproduces for duplicate-index `set` scatters
    (depth image, voxel-slot claims): XLA on the CPU keeps the last."""
    got = jnp.zeros(4, jnp.int32).at[jnp.asarray([1, 3, 1, 1, 3])].set(
        jnp.asarray([5, 6, 7, 8, 9], jnp.int32))
    assert np.asarray(got).tolist() == [0, 8, 0, 9]
    idx = torch.tensor([1, 3, 1, 1, 3])
    win = tvm._last_wins(idx, torch.ones(5, dtype=torch.bool), 4)
    assert win.tolist() == [False, False, False, True, True]


def test_two_voxels_claiming_one_slot_match_jax():
    """Two new voxels whose probe chains start at the same free slot, in
    one batch: one claims it (the later in sorted order, as XLA keeps the
    last duplicate update), the other moves on to the next slot."""
    from fastlivo_tpu.ops.voxel_map import _slot_check as jslot

    grid = np.stack(np.meshgrid(*[np.arange(-6, 6)] * 3, indexing="ij"), -1).reshape(-1, 3)
    slot, check = (np.asarray(a) for a in jslot(jnp.asarray(grid, jnp.int32), T - 1))
    a = 0
    b = next(i for i in range(1, len(grid)) if slot[i] == slot[a] and check[i] != check[a])
    pts = ((np.stack([grid[a], grid[b], grid[a]]) + 0.5) * 0.5).astype(np.float32)
    px = np.zeros((3, 2), np.float32)
    val = np.ones(3, np.float32)
    rot, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    mask = np.ones(3, bool)
    mj, mt = maps()
    mj = jvm.add_points(mj, *(jnp.asarray(x) for x in (pts, px, rot, t, val)),
                        jnp.int32(0), jnp.asarray(mask))
    mt = tvm.add_points(mt, *(torch.from_numpy(x) for x in (pts, px, rot, t, val)),
                        0, torch.from_numpy(mask))
    assert_same(mj, mt)
    keys = np.asarray(mj.vox_keys)
    s0 = slot[a]
    assert {keys[s0], keys[(s0 + 1) % T]} == {check[a], check[b]}
    assert np.asarray(mj.vox_count)[[s0, (s0 + 1) % T]].tolist() in ([2, 1], [1, 2])


def rand_pose(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    rot = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                    [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                    [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
    return rot.astype(np.float32), rng.normal(0, 2, 3).astype(np.float32)


def stream(mj, mt, rng, frames, fid0, B=12):
    for f in range(fid0, fid0 + frames):
        img = rng.uniform(-20, 280, (H, W)).astype(np.float32)
        img[0, :3] = [0.5, 1.5, 2.5]  # round half to even
        fid = np.int32(f)
        mj = jvm.push_image(mj, jnp.asarray(img), jnp.int32(fid))
        mt = tvm.push_image(mt, torch.from_numpy(img), int(fid))
        assert_same(mj, mt)
        rot, t = rand_pose(rng)
        pts = rng.uniform(-2, 2, (B, 3)).astype(np.float32)
        pts[3] = pts[2]  # two points in one voxel
        px = rng.uniform(0, W, (B, 2)).astype(np.float32)
        val = rng.uniform(0, 50, B).astype(np.float32)
        mask = rng.random(B) < 0.85
        mj = jvm.add_points(mj, *(jnp.asarray(a) for a in (pts, px, rot, t, val)),
                            jnp.int32(fid), jnp.asarray(mask))
        mt = tvm.add_points(mt, *(torch.from_numpy(a) for a in (pts, px, rot, t, val)),
                            int(fid), torch.from_numpy(mask))
        assert_same(mj, mt)
        n = int(mj.n_pts)
        K = min(n, 10)
        idx = rng.permutation(n)[:K].astype(np.int32)
        rot, t = rand_pose(rng)
        opx = rng.uniform(0, W, (K, 2)).astype(np.float32)
        oval = rng.uniform(0, 50, K).astype(np.float32)
        lvl = rng.integers(0, 3, K).astype(np.int32)
        omask = rng.random(K) < 0.8
        mj = jvm.add_observations(mj, *(jnp.asarray(a) for a in (idx, opx, rot, t, oval)),
                                  jnp.int32(fid), jnp.asarray(lvl), jnp.asarray(omask))
        mt = tvm.add_observations(mt, *(torch.from_numpy(a) for a in (idx, opx, rot, t, oval)),
                                  int(fid), torch.from_numpy(lvl), torch.from_numpy(omask))
        assert_same(mj, mt)
    return mj, mt


def test_op_stream_matches_jax():
    rng = np.random.default_rng(0)
    mj, mt = maps()
    mj, mt = stream(mj, mt, rng, frames=7, fid0=0)
    # the stream filled the point pool, rings and hash
    assert int(mj.n_pts) == NP
    assert np.asarray(mj.n_obs).max() == KO
    assert (np.asarray(mj.vox_keys) != jvm.EMPTY).sum() > T // 2
    center = np.array([0.5, -0.5, 0.0], np.float32)
    mj = jvm.compact(mj, jnp.asarray(center), jnp.float32(1.2))
    mt = tvm.compact(mt, torch.from_numpy(center), 1.2)
    assert_same(mj, mt)
    assert 0 < int(mt.n_pts) < NP
    mj, mt = stream(mj, mt, rng, frames=3, fid0=7)
    assert_same(mj, mt)


def test_lookups_match_jax():
    rng = np.random.default_rng(1)
    mj, mt = stream(*maps(), rng, frames=5, fid0=0)
    stored = np.floor(np.asarray(mj.pos)[:30] / 0.5).astype(np.int32)
    vox = np.concatenate([stored, rng.integers(-4, 4, (10, 3)).astype(np.int32)])
    vmask = rng.random(40) < 0.9
    ij, vj = jvm.gather_voxel_points(mj, jnp.asarray(vox), jnp.asarray(vmask))
    it, vt = tvm.gather_voxel_points(mt, torch.from_numpy(vox), torch.from_numpy(vmask))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(it.numpy()[vt.numpy()], np.asarray(ij)[np.asarray(vj)])
    assert np.asarray(vj).sum() >= 20
    idx = np.arange(int(mj.n_pts), dtype=np.int32)
    campos = np.array([0.3, -1.0, 2.0], np.float32)
    rj = jvm.close_view_obs(mj, jnp.asarray(idx), jnp.asarray(campos))
    rt = tvm.close_view_obs(mt, torch.from_numpy(idx), torch.from_numpy(campos))
    for k in rj:
        a, b = np.asarray(rj[k]), rt[k].numpy()
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(tvm._live_slot_refs(mt).numpy(),
                                  np.asarray(jvm._live_slot_refs(mj)))


@pytest.mark.parametrize("fid", [2, 9])
def test_push_slot_matches_jax(fid):
    rng = np.random.default_rng(2)
    mj, mt = stream(*maps(), rng, frames=6, fid0=0)
    assert int(tvm.push_slot(mt, torch.tensor(fid, dtype=torch.int32))) == \
        int(jvm.push_slot(mj, jnp.int32(fid)))
