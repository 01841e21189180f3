"""Port parity: the voxel hash, the tiled map and the scan voxel filter.

The same seeded numpy streams go through the JAX package and through
fastlivo_tpu_torch on the CPU. The hash is bit-identical; the map after
the same insert stream is array-identical, field by field; kNN,
delete_boxes and compact are equal; the device voxel filter gives equal
masks and centroids within rtol 1e-6 (a segment's float32 sum).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fastlivo_tpu.ops import tiled_map as jtm
from fastlivo_tpu.ops import voxel_filter as jvf
from fastlivo_tpu.ops import voxel_map as jvm

from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch.ops import tiled_map as ttm
from fastlivo_tpu_torch.ops import voxel_filter as tvf
from fastlivo_tpu_torch.ops import voxel_map as tvm

DIMS, POOL, VOX = (32, 32, 16), 1024, 0.5


def _arrays(nt):
    return {k: np.array(v) for k, v in nt._asdict().items()}


def assert_maps_equal(mt, mj):
    got, want = convert.tiled_map_to_arrays(mt), _arrays(mj)
    for f in want:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_mix64_bit_identical():
    rng = np.random.default_rng(0)
    keys = rng.integers(-2**31, 2**31 - 1, (20000, 3), dtype=np.int64).astype(np.int32)
    keys[:1000] = rng.integers(-40, 40, (1000, 3))  # small negative coords
    keys[1000] = [-1, -1, -1]
    keys[1001] = [-2**31, 2**31 - 1, 0]
    want = tvm._mix64_np(keys)
    got = tvm._mix64(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(want, jvm._mix64_np(keys))
    np.testing.assert_array_equal(want, np.asarray(jvm._mix64(jnp.asarray(keys))))
    np.testing.assert_array_equal(tvm._neighbor_offsets(1), jvm._neighbor_offsets(1))


def _stream(seed, n_batches=4, n=1500):
    """Surface-like point batches around the origin (negative voxel and
    tile coordinates included), with invalid rows and duplicates."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        p = np.stack([rng.uniform(-30, 30, n), rng.uniform(-30, 30, n),
                      np.abs(np.sin(0.2 * rng.uniform(-30, 30, n))) * 2 - 1], 1)
        p[: n // 10] = p[n // 10: n // 5] + rng.normal(0, 0.05, (n // 10, 3))
        valid = rng.random(n) > 0.05
        out.append((p.astype(np.float32), valid))
    return out


def _both_maps(seed, pool=POOL, dims=DIMS):
    mj = jtm.empty_tiled_map(dims, pool, VOX)
    mt = ttm.empty_tiled_map(dims, pool, VOX, device="cpu")
    assert_maps_equal(mt, mj)
    for p, v in _stream(seed):
        mj = jtm.insert(mj, jnp.asarray(p), jnp.asarray(v))
        mt = ttm.insert(mt, torch.from_numpy(p), torch.from_numpy(v))
    return mt, mj


@pytest.mark.parametrize("pool", [POOL, 24])  # 24 tiles: pool exhaustion
def test_insert_stream_array_identical(pool):
    mt, mj = _both_maps(1, pool)
    assert_maps_equal(mt, mj)
    if pool == 24:
        assert int(mt.n_dropped) > 0 and int(mt.n_alloc) == 24
    # small directory: aliased tiles evict each other
    mt, mj = _both_maps(2, dims=(2, 2, 2))
    assert_maps_equal(mt, mj)


def test_build_host_and_extract_match_jax():
    p = np.concatenate([b[0] for b in _stream(3)])
    mt = ttm.build_host(p, DIMS, POOL, VOX, device="cpu")
    mj = jtm.build_host(p, DIMS, POOL, VOX)
    assert_maps_equal(mt, mj)
    pt, nt = ttm.extract_points(mt)
    pj, nj = jtm.extract_points(mj)
    assert nt == nj and nt > 1000
    np.testing.assert_array_equal(pt, pj)


def test_knn_candidates_and_knn_equal():
    mt, mj = _both_maps(4)
    rng = np.random.default_rng(5)
    q = np.stack([rng.uniform(-30, 30, 800), rng.uniform(-30, 30, 800),
                  rng.uniform(-1, 1, 800)], 1).astype(np.float32)
    for radius in (1, 2):
        ct, ft = ttm.knn_candidates(mt, torch.from_numpy(q), radius=radius)
        cj, fj = jtm.knn_candidates(mj, jnp.asarray(q), radius=radius)
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    nt, dt, vt = ttm.knn(mt, torch.from_numpy(q), k=5, radius=1)
    nj, dj, vj = jtm.knn(mj, jnp.asarray(q), k=5, radius=1)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)


def test_delete_boxes_and_compact_equal():
    mt, mj = _both_maps(6)
    lo = np.array([[-30, -30, -5], [5, -2, -5], [1, 1, 1]], np.float32)
    hi = np.array([[-5, 30, 5], [30, 2, 5], [0, 0, 0]], np.float32)  # last inert
    mt = ttm.delete_boxes(mt, torch.from_numpy(lo), torch.from_numpy(hi))
    mj = jtm.delete_boxes(mj, jnp.asarray(lo), jnp.asarray(hi))
    assert_maps_equal(mt, mj)
    ct = ttm.compact(mt)
    cj = jtm.compact(mj)
    assert_maps_equal(ct, cj)
    assert int(ct.n_alloc) < int(mt.n_alloc)
    # the compacted map answers queries like before compaction
    q = torch.from_numpy(np.random.default_rng(7).uniform(-30, 30, (500, 3))
                         .astype(np.float32))
    np.testing.assert_array_equal(ttm.knn(ct, q)[0].numpy(), ttm.knn(mt, q)[0].numpy())


def _scan(seed, n=3000):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    p[: n // 3] = p[n // 3: 2 * (n // 3)] + rng.normal(0, 0.05, (n // 3, 3))
    p[5, 0] = np.nan
    p[6, 1] = np.inf
    valid = rng.random(n) > 0.05
    return p, valid


@pytest.mark.parametrize("max_out", [4096, 700])  # 700: capacity overflow
def test_voxel_downsample_device_matches_jax(max_out):
    p, valid = _scan(8)
    ot, mt = tvf.voxel_downsample_device(
        torch.from_numpy(p), torch.from_numpy(valid),
        torch.tensor(0.5, dtype=torch.float32), max_out)
    oj, mj = jvf.voxel_downsample_device(jnp.asarray(p), jnp.asarray(valid),
                                         jnp.float32(0.5), max_out)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-6, atol=1e-6)
    assert np.isfinite(ot.numpy()).all()


def test_voxel_downsample_host_matches_jax():
    p, _ = _scan(9)
    pi = np.concatenate([p, np.arange(len(p), dtype=np.float32)[:, None]], 1)
    for max_out in (None, 512):
        ot, mt = tvf.voxel_downsample(pi, 0.3, max_out)
        oj, mj = jvf.voxel_downsample(pi, 0.3, max_out)
        np.testing.assert_array_equal(mt, mj)
        np.testing.assert_array_equal(ot, oj)
