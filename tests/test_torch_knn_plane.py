"""The fused 5-NN + plane-fit kernel (fastlivo_tpu_torch/ops/knn_plane.py).

On the CPU: `knn5_plane_plain` against the JAX package's Pallas kernel
(interpret mode) and against top-5 + fit_plane, under the kernel's
contract (tests/test_pallas_lio.py): nd2 at rtol 1e-5; planes at rtol
5e-3 / atol 5e-4 up to sign where both gates pass; gate mismatches
under 1%. The CUDA kernel itself is tested on the card by
tests/test_torch_cuda.py.

The fused search `knn5_plane_tiled` (map in, planes out): on the CPU its
wrapper is its plain composition knn5_plane_plain(knn_candidates(...)),
bit for bit, and that composition meets the JAX package's tiled search
(knn_candidates, then the Pallas kernel in interpret mode) under the
contract above, on maps with negative tile coordinates and with aliased
tiles (a 2x2x2 directory), for queries on voxel boundaries.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fastlivo_tpu.ops import pallas_lio
from fastlivo_tpu.ops import plane as jplane
from fastlivo_tpu.ops import tiled_map as jtm
from fastlivo_tpu.ops.voxel_map import topk_from_candidates

from fastlivo_tpu_torch.ops import knn_plane

from fastlivo_tpu_torch.ops import tiled_map as ttm

from test_torch_cuda import assert_contract, random_block, search_queries, surface


def _plain(cand, found, q):
    out = knn_plane.knn5_plane_plain(torch.from_numpy(cand), torch.from_numpy(found),
                                     torch.from_numpy(q))
    return [t.numpy() for t in out]


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_pallas_kernel(seed):
    cand, found, q = random_block(seed=seed)
    pj = pallas_lio.knn5_plane(jnp.asarray(cand), jnp.asarray(found), jnp.asarray(q),
                               interpret=True)
    pj = [np.asarray(a) for a in pj]
    pt = _plain(cand, found, q)
    assert_contract(*pt, *pj)
    # the plain version runs the exact acos, so where both gates pass it
    # also matches the XLA top-5 + fit_plane chain
    neigh, nd2, _ = topk_from_candidates(jnp.asarray(cand), jnp.asarray(found),
                                         jnp.asarray(q), 5)
    pab_x, ok_x = jplane.fit_plane(neigh, threshold=0.1)
    nd2_x = np.asarray(nd2[:, -1])
    nd2_x = np.where(nd2_x >= 0.5e30, np.float32(knn_plane.BIG), nd2_x)  # its mask is 1e30
    assert_contract(*pt, np.asarray(pab_x), np.asarray(ok_x), nd2_x)


def test_plain_edge_cases():
    cand, found, q = random_block(n=64)
    pab, ok, nd2 = _plain(cand, found, q)
    assert (nd2[:5] >= knn_plane.BIG * 0.5).all() and not ok[:5].any()
    np.testing.assert_array_equal(pab[:5], np.tile([0, 0, 1, 0], (5, 1)))
    # fewer than five neighbours: the fifth distance stays masked
    assert (nd2[5:10] >= knn_plane.BIG * 0.5).all()
    # ties pick the lowest row: duplicated rows are both selected
    d2 = np.where(found, ((cand - q[:, None]) ** 2).sum(-1), np.inf)
    np.testing.assert_allclose(nd2[20:], np.sort(d2, 1)[20:, 4], rtol=1e-5)


def test_wrapper_cpu_is_plain_and_uncounted():
    cand, found, q = random_block(n=300, seed=3)
    before = knn_plane.knn5_plane.launches
    got = knn_plane.knn5_plane(torch.from_numpy(cand), torch.from_numpy(found),
                               torch.from_numpy(q))
    for a, b in zip(got, _plain(cand, found, q)):
        np.testing.assert_array_equal(a.numpy(), b)
    assert knn_plane.knn5_plane.launches == before


def test_wrapper_checks_inputs():
    cand, found, q = (torch.from_numpy(a) for a in random_block(n=16))
    with pytest.raises(TypeError):
        knn_plane._check(cand.double(), found, q)
    with pytest.raises(TypeError):
        knn_plane._check(cand, found.int(), q)
    with pytest.raises(ValueError):
        knn_plane._check(cand[:, :20].contiguous(), found[:, :20].contiguous(), q)
    with pytest.raises(ValueError):
        knn_plane._check(cand, found, q[:8])
    with pytest.raises(ValueError):
        knn_plane._check(cand.transpose(0, 1).contiguous().transpose(0, 1), found, q)
    knn_plane._check(cand, found, q)


def both_maps(dims):
    p = surface(40000, 3)
    return (ttm.build_host(p, dims, 256, 0.5, device="cpu"),
            jtm.build_host(p, dims, 256, 0.5))


@pytest.mark.parametrize("dims", [(32, 32, 16), (2, 2, 2)])  # (2, 2, 2): aliased tiles
def test_tiled_search_wrapper_is_plain_and_matches_jax(dims):
    mt, mj = both_maps(dims)
    q = search_queries()
    qt = torch.from_numpy(q)
    assert (q[:300, 0] % 0.5 == 0).all() and (q < 0).any()
    before = knn_plane.knn5_plane_tiled.launches
    for radius in (1, 2):
        got = knn_plane.knn5_plane_tiled(mt, qt, radius, 0.1)
        want = knn_plane.knn5_plane_plain(*ttm.knn_candidates(mt, qt, radius), qt, 0.1)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert knn_plane.knn5_plane_tiled.launches == before
    cand, found = jtm.knn_candidates(mj, jnp.asarray(q), 1)
    pj = pallas_lio.knn5_plane(cand, found, jnp.asarray(q), interpret=True)
    got = [t.numpy() for t in knn_plane.knn5_plane_tiled(mt, qt, 1, 0.1)]
    assert_contract(*got, *[np.asarray(a) for a in pj], min_both=100)


def test_tiled_search_checks_inputs():
    mt, _ = both_maps((32, 32, 16))
    q = torch.from_numpy(search_queries(n=16))
    with pytest.raises(ValueError):
        knn_plane._check_tiled(mt, q, 3)
    with pytest.raises(ValueError):
        knn_plane._check_tiled(mt, q[:, :2].contiguous(), 1)
    with pytest.raises(TypeError):
        knn_plane._check_tiled(mt, q.double(), 1)
    with pytest.raises(TypeError):
        knn_plane._check_tiled(mt._replace(pts=mt.pts.double()), q, 1)
    with pytest.raises(ValueError):
        knn_plane._check_tiled(mt._replace(pts=mt.pts[:-1]), q, 1)
    with pytest.raises(ValueError):
        knn_plane._check_tiled(mt, q.t().contiguous().t(), 1)
    knn_plane._check_tiled(mt, q, 1)
