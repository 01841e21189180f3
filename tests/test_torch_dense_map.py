"""Port parity: the dense rolling-grid map backend (`map_backend: dense`).

The same seeded numpy streams go through the JAX package's
ops/dense_map.py and through fastlivo_tpu_torch's on the CPU, into a
small grid (16 x 16 x 8 cells of 0.5 m, so a 24 m wide stream aliases:
voxels a grid period apart share a cell and evict each other). After
every insert and deletion the two maps are array-identical; the
candidate blocks and k-nearest results are equal; `build_host` equals
the JAX package's and one bulk insert into an empty map.
"""
import numpy as np
import torch
import jax.numpy as jnp

from fastlivo_tpu.ops import dense_map as jdm

from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch.ops import dense_map as tdm

from test_torch_voxel_map import _batch

DIMS, VOX = (16, 16, 8), 0.5


def assert_maps_equal(mt, mj):
    got = convert.dense_map_to_arrays(mt)
    want = {k: np.array(v) for k, v in mj._asdict().items()}
    assert got.keys() == want.keys()
    for f in want:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def _both(seed, n_batches=3):
    rng = np.random.default_rng(seed)
    mt, mj = tdm.empty_dense_map(DIMS, VOX, device="cpu"), jdm.empty_dense_map(DIMS, VOX)
    assert_maps_equal(mt, mj)
    for _ in range(n_batches):
        p, v = _batch(rng)
        mt = tdm.insert(mt, torch.from_numpy(p), torch.from_numpy(v))
        mj = jdm.insert(mj, jnp.asarray(p), jnp.asarray(v))
        assert_maps_equal(mt, mj)
    return mt, mj, rng


def test_insert_with_aliased_eviction_array_identical():
    mt, mj, _ = _both(1)
    # a point one grid period (8 m in x) from a stored one takes its cell
    pts, _ = tdm.extract_points(mt)
    moved = pts[:50] + np.float32([DIMS[0] * VOX, 0, 0])
    keep = tdm.voxel_of(torch.from_numpy(moved), mt.voxel_size)
    before = int(mt.count)
    mt = tdm.insert(mt, torch.from_numpy(moved), torch.ones(50, dtype=torch.bool))
    mj = jdm.insert(mj, jnp.asarray(moved), jnp.ones(50, bool))
    assert_maps_equal(mt, mj)
    assert int(mt.count) == before  # evictions, not new cells
    cell, chk = tdm._cell_check(mt, keep)
    assert torch.equal(mt.check[cell.long()], chk)


def test_knn_candidates_knn_and_delete_boxes_equal():
    mt, mj, rng = _both(2)
    q = np.stack([rng.uniform(-14, 14, 600), rng.uniform(-14, 14, 600),
                  rng.uniform(-1.5, 1.5, 600)], 1).astype(np.float32)
    for radius in (1, 2):
        ct, ft = tdm.knn_candidates(mt, torch.from_numpy(q), radius)
        cj, fj = jdm.knn_candidates(mj, jnp.asarray(q), radius=radius)
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        assert 0 < ft.numpy().mean() < 0.9
    nt, dt, vt = tdm.knn(mt, torch.from_numpy(q), 5, 1)
    nj, dj, vj = jdm.knn(mj, jnp.asarray(q), k=5, radius=1)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)
    lo = np.array([[-12, -12, -5], [2, -3, -5], [1, 1, 1]], np.float32)
    hi = np.array([[-2, 12, 5], [12, 3, 5], [0, 0, 0]], np.float32)  # last inert
    n0 = int(mt.count)
    mt = tdm.delete_boxes(mt, torch.from_numpy(lo), torch.from_numpy(hi))
    mj = jdm.delete_boxes(mj, jnp.asarray(lo), jnp.asarray(hi))
    assert_maps_equal(mt, mj)
    assert 0 < int(mt.count) < n0


def test_build_host_matches_jax_and_one_bulk_insert():
    rng = np.random.default_rng(3)
    p = np.concatenate([_batch(rng)[0] for _ in range(3)])
    mt = tdm.build_host(p, DIMS, VOX, device="cpu")
    assert_maps_equal(mt, jdm.build_host(p, DIMS, VOX))
    bulk = tdm.insert(tdm.empty_dense_map(DIMS, VOX, device="cpu"), torch.from_numpy(p),
                      torch.ones(len(p), dtype=torch.bool))
    for a, b in zip(bulk, mt):
        assert torch.equal(a, b)
    pt, nt = tdm.extract_points(mt)
    pj, nj = jdm.extract_points(jdm.build_host(p, DIMS, VOX))
    assert nt == nj == int(mt.count) > 500
    np.testing.assert_array_equal(pt, pj)
