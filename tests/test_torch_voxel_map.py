"""Port parity: the voxel-hash map backend (`map_backend: hash`).

The same seeded numpy streams go through the JAX package's
ops/voxel_map.py and through fastlivo_tpu_torch's on the CPU, into
small tables (2^12 slots, so probe chains are long). After every insert,
deletion and rebuild the two maps are array-identical, field by field;
the candidate blocks and k-nearest results are equal, the not-found rows
included; the exported points are equal.
"""
import numpy as np
import torch
import jax.numpy as jnp

from fastlivo_tpu.ops import voxel_map as jvm

from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch.ops import voxel_map as tvm

T, VOX = 1 << 12, 0.5


def assert_maps_equal(mt, mj):
    got = convert.voxel_map_to_arrays(mt)
    want = {k: np.array(v) for k, v in mj._asdict().items()}
    assert got.keys() == want.keys()
    for f in want:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def _batch(rng, n=1500, span=12.0):
    """Surface-like points (negative voxel coordinates included), a tenth
    of them near-duplicates of others (several points per voxel), some
    rows invalid."""
    p = np.stack([rng.uniform(-span, span, n), rng.uniform(-span, span, n),
                  np.abs(np.sin(0.2 * rng.uniform(-span, span, n))) * 2 - 1], 1)
    p[: n // 10] = p[n // 10: n // 5] + rng.normal(0, 0.05, (n // 10, 3))
    return p.astype(np.float32), rng.random(n) > 0.05


def _insert_both(mt, mj, p, v, max_probe=12):
    mt = tvm.insert(mt, torch.from_numpy(p), torch.from_numpy(v), max_probe)
    mj = jvm.insert(mj, jnp.asarray(p), jnp.asarray(v), max_probe=max_probe)
    return mt, mj


def _colliding_voxels():
    """Two voxel coordinates whose first probe slot is the same."""
    k = np.stack(np.meshgrid(*[np.arange(-6, 6)] * 3, indexing="ij"), -1).reshape(-1, 3)
    slot, _ = tvm._slot_check(torch.from_numpy(k.astype(np.int32)), T - 1)
    slot = slot.numpy()
    order = np.argsort(slot, kind="stable")
    dup = np.nonzero(slot[order][1:] == slot[order][:-1])[0][0]
    return k[order[dup]], k[order[dup + 1]], int(slot[order[dup]])


def test_duplicate_claim_keeps_the_later_voxel():
    """Two voxels claim one free slot in the same round: the voxel later
    in (z, y, x) order keeps it, the other probes on, and both are
    stored; the maps are identical."""
    ka, kb, s = _colliding_voxels()
    p = (np.stack([ka, kb]).astype(np.float32) + 0.5) * VOX
    mt, mj = _insert_both(tvm.empty_map(T, VOX, device="cpu"), jvm.empty_map(T, VOX),
                          p, np.ones(2, bool))
    assert_maps_equal(mt, mj)
    assert int(mt.count) == 2
    later = max((ka, kb), key=lambda k: (k[2], k[1], k[0]))
    chk = (tvm._mix64(torch.from_numpy(later.astype(np.int32)[None])) & 0x7FFFFFFF)
    assert int(mt.check[s]) == int(chk[0])


def test_insert_stream_delete_and_reinsert_array_identical():
    rng = np.random.default_rng(1)
    mt, mj = tvm.empty_map(T, VOX, device="cpu"), jvm.empty_map(T, VOX)
    assert_maps_equal(mt, mj)
    batches = [_batch(rng) for _ in range(3)]
    for p, v in batches:
        mt, mj = _insert_both(mt, mj, p, v)
        assert_maps_equal(mt, mj)
    assert 0.3 * T < int(mt.count) < T
    lo = np.array([[-12, -12, -5], [2, -3, -5], [1, 1, 1]], np.float32)
    hi = np.array([[-2, 12, 5], [12, 3, 5], [0, 0, 0]], np.float32)  # last inert
    n0 = int(mt.count)
    mt = tvm.delete_boxes(mt, torch.from_numpy(lo), torch.from_numpy(hi))
    mj = jvm.delete_boxes(mj, jnp.asarray(lo), jnp.asarray(hi))
    assert_maps_equal(mt, mj)
    assert int(mt.count) < 0.6 * n0
    # insert after delete: the holes break probe chains, so some stored
    # voxels are claimed a second time (the benign duplicates rebuild drops)
    for p, v in batches[:2]:
        mt, mj = _insert_both(mt, mj, p, v, max_probe=6)
        assert_maps_equal(mt, mj)
    rt, rj = tvm.rebuild(mt), jvm.rebuild(mj)
    assert_maps_equal(rt, rj)
    assert int(rt.count) < int(mt.count)  # the duplicates are gone
    pt, nt = tvm.extract_points(rt)
    pj, nj = jvm.extract_points(rj)
    assert nt == nj == int(rt.count)
    np.testing.assert_array_equal(pt, pj)
    assert rt.voxel_size is mt.voxel_size


def test_knn_candidates_and_knn_equal():
    rng = np.random.default_rng(4)
    mt, mj = tvm.empty_map(T, VOX, device="cpu"), jvm.empty_map(T, VOX)
    for _ in range(2):
        mt, mj = _insert_both(mt, mj, *_batch(rng))
    q = np.stack([rng.uniform(-14, 14, 600), rng.uniform(-14, 14, 600),
                  rng.uniform(-1.5, 1.5, 600)], 1).astype(np.float32)
    for radius, probe in ((1, 12), (2, 4)):
        ct, ft = tvm.knn_candidates(mt, torch.from_numpy(q), radius, probe)
        cj, fj = jvm.knn_candidates(mj, jnp.asarray(q), radius=radius, max_probe=probe)
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))  # not-found rows too
        assert 0 < ft.numpy().mean() < 0.9
    nt, dt, vt = tvm.knn(mt, torch.from_numpy(q), 5, 1, 12)
    nj, dj, vj = jvm.knn(mj, jnp.asarray(q), k=5, radius=1, max_probe=12)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)
