"""Patch sizes past 16 on the camera path, and the LIO cascade's routing
over the three maps.

Against the JAX package at P = 17 and 24, through the plain versions the
CPU runs (each camera kernel's oracle on the card): the selection
(`vio.select_tracked`), one photometric measurement
(`photometric_err_H_plain`, per-point errors within rtol 1e-4, the mean
error within 1e-5, G = K·HᵀH within 1e-3 and the step's pose within 2e-6
/ 1e-6) and the whole `vio_frame_step` (tracked and added counts and
iterations equal, the posterior position within 1e-5 m, i.e. well
inside LIVO's 2 mm).

The sums' orders that the card's kernels take, in numpy: the wide tree
of csrc/vio_common.cuh::warp_tree_wide (vio_select past P = 16) gives
image.halving_sum's bits at vio._patch_sum's width, and
ops/photometric.point_sums is the measuring block's per-point order
(csrc/photometric_measure.cuh: a thread's pixels in turn, a butterfly
in each warp, the warps in order), bit for bit, at P from 1 to 48.

`lio.cascade_applies` over the tiled, hash and dense maps, the device,
the plane fit, `cache_knn` and a mesh.
"""
from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastlivo_tpu import vio as jvio
from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch import lio as tlio
from fastlivo_tpu_torch import vio as tvio
from fastlivo_tpu_torch.ops import dense_map as dm
from fastlivo_tpu_torch.ops import image, linalg, photometric, so3
from fastlivo_tpu_torch.ops import tiled_map as tm
from fastlivo_tpu_torch.ops import voxel_map as vm
from test_torch_vio import frame_step_both, scene, stage_inputs, tstate  # noqa: F401

WIDE = (17, 24)


def tracked_both(sc, P):
    """The frame's tracked set at patch size P from the JAX package and
    from the port's plain selection."""
    (pg, pm, vox, vmask), _ = stage_inputs(sc)
    jv, tv = sc["jv"], sc["tv"]
    kw = dict(grid_size=jv.grid_size, patch_size=P, gw=jv.gw, gh=jv.gh)
    tj = jvio.select_tracked(jv.vmap, jv.cam, jnp.asarray(sc["rcw"]), jnp.asarray(sc["pcw"]),
                             jnp.asarray(sc["gray"]), jnp.asarray(pg), jnp.asarray(pm),
                             jnp.asarray(vox), jnp.asarray(vmask),
                             outlier_threshold=jv._out_thre_dev, ncc_thre=jv._ncc_thre_dev, **kw)
    t = torch.from_numpy
    tt = tvio.select_tracked(tv.vmap, tv.cam, t(sc["rcw"]), t(sc["pcw"]), t(sc["gray"]),
                             t(pg), t(pm), t(vox), t(vmask), tv._out_thre_dev,
                             tv._ncc_thre_dev, **kw)
    return tj, tt


@pytest.mark.parametrize("P", WIDE)
def test_select_tracked_matches_jax_past_16(scene, P):  # noqa: F811
    tj, tt = tracked_both(scene, P)
    valid = np.asarray(tj.valid)
    assert valid.sum() > 5 and tt.patch.shape[-2:] == (P, P)
    np.testing.assert_array_equal(tt.valid.numpy(), valid)
    np.testing.assert_array_equal(tt.idx.numpy(), np.asarray(tj.idx))
    np.testing.assert_array_equal(tt.search_level.numpy(), np.asarray(tj.search_level))
    np.testing.assert_allclose(tt.patch.numpy()[valid], np.asarray(tj.patch)[valid], atol=1e-3)
    np.testing.assert_allclose(tt.errors.numpy()[valid], np.asarray(tj.errors)[valid],
                               rtol=1e-4, atol=1e-2)
    np.testing.assert_array_equal(tt.cell_value.numpy(), np.asarray(tj.cell_value))


@pytest.mark.parametrize("P", WIDE)
@pytest.mark.parametrize("robust", ["none", "huber"])
def test_photometric_err_H_plain_matches_jax_past_16(scene, P, robust):  # noqa: F811
    """As test_torch_vio's measurement test at P = 8: the JAX package's
    first iteration of level 0 (max_iter 1) against the port's plain
    measurement at the same prior."""
    tj, tt = tracked_both(scene, P)
    jv, tv = scene["jv"], scene["tv"]
    prior = scene["prior"]
    sj, Gj, perr_j, err_j, itj = jvio.photometric_update_levels(
        prior, prior, jv.cam, jnp.asarray(scene["gray"]), tj.pos, tj.patch,
        tj.search_level, tj.valid, jv.Rci, jv.Pci, jv.Jdphi_dR, jv.Jdp_dR,
        img_point_cov=jv._ipc_dev, patch_size=P, levels=(0,), max_iter=1, robust=robust)
    assert int(itj) == 1
    pt = tstate(prior)
    err, HTH6, HTz, perr = photometric.photometric_err_H_plain(
        torch.from_numpy(scene["gray"]), tt.pos, tt.patch[:, 0], tt.search_level, tt.valid,
        pt.rot, pt.pos, tv.Rci, tv.Pci, tv.Jdphi_dR, tv.Jdp_dR, tv.cam, 0, P, robust)
    assert tt.valid.sum() > 5 and float(err) > 0
    np.testing.assert_allclose(perr.numpy(), np.asarray(perr_j), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(float(err), float(err_j), rtol=1e-5)
    P_ = pt.cov / float(tv.cfg.img_point_cov)
    H64 = HTH6.double()
    K = linalg.kalman_gain6_f64(P_, H64)
    # the kernels' fixed f32 order (a point's 289-576 pixels a thread,
    # warp and block at a time) rounds HᵀH further from the JAX package's
    # matmul than the P = 8 test's 1e-4 allows: 2.8e-4 and 5.8e-4 here
    np.testing.assert_allclose((K @ H64).numpy(), np.asarray(Gj), atol=1e-3)
    dx = -(K @ HTz.double())
    np.testing.assert_allclose((pt.pos + dx[3:6]).numpy(), np.asarray(sj.pos), atol=2e-6)
    rot = pt.rot @ so3.exp(dx[0:3])
    np.testing.assert_allclose(rot.numpy(), np.asarray(sj.rot), atol=1e-6)


@pytest.mark.parametrize("P", WIDE)
def test_vio_frame_step_matches_jax_past_16(scene, P):  # noqa: F811
    tmap = convert.visual_map_from_arrays(
        {f: np.asarray(v) for f, v in scene["jv"].vmap._asdict().items()}, "cpu")
    oj, ot, _ = frame_step_both(scene, scene["jv"].vmap, tmap, P)
    assert int(ot[7]) == int(oj[7]) > 5  # n_tracked
    assert int(ot[8]) == int(oj[8])  # n_added
    assert ot[9] == int(oj[9])  # iterations
    sj = oj[0]
    np.testing.assert_allclose(ot[0].pos.numpy(), np.asarray(sj.pos), atol=1e-5)
    cj, ct = np.asarray(sj.cov), ot[0].cov.numpy()
    np.testing.assert_allclose(np.diag(ct), np.diag(cj), rtol=1e-3, atol=1e-10)
    assert int(ot[1].n_pts) == int(oj[1].n_pts)


def sample(n, values, rng):
    """n f32 values: random magnitudes, or values whose sum depends on the
    order (1e-30 to 1e30 mixed, with cancellation)."""
    if values == "random":
        x = rng.normal(0, 1, n) * 10.0 ** rng.integers(-3, 4, n)
    else:
        x = rng.choice([1e30, -1e30, 1e-30, 1.0, -1.0, 3.0e7, 0.1, 2.0 ** -24, 0.0, -0.0], n)
        x = x * rng.uniform(0.5, 2.0, n)
    return x.astype(np.float32)


def wide_tree(x, width):
    """csrc/vio_common.cuh's warp_tree_wide in numpy f32 over the n = len(x)
    values (width / 2 < n <= width): tmp[k] = f(k) + f(k + width / 2) with
    zeros past n, the levels down to 64 in place, then warp_tree<64>
    (lane l: tmp[l] + tmp[l + 32], then the shuffle tree, lane l adding
    lane l + off, off 16 .. 1, a lane past 31 reading its own value)."""
    n, half = len(x), width // 2
    f = np.concatenate([x, np.zeros(width - n, np.float32)])
    tmp = (f[:half] + f[half:]).astype(np.float32)
    m = half
    while m > 64:
        tmp[:m // 2] = tmp[:m // 2] + tmp[m // 2:m]
        m //= 2
    s = tmp[:32] + tmp[32:64]
    off = 16
    while off:
        down = s.copy()
        down[:32 - off] = s[off:]
        s = s + down
        off //= 2
    return s[0]


@pytest.mark.parametrize("values", ["random", "adversarial"])
@pytest.mark.parametrize("P", [17, 20, 22, 23, 24, 32, 33, 45, 48, 64])
def test_wide_trees_keep_halving_sums_order(P, values):
    """vio_select's wide tree (P * P > 256) gives the bits of
    image.halving_sum at vio._patch_sum's width (512 at P 17-22, 1024 at
    23-32, then 2048 and 4096), zeros padding the patch to the width."""
    PP = P * P
    width = max(64, 1 << (PP - 1).bit_length())
    assert width >= 512
    rng = np.random.default_rng(P + 1000 * len(values))
    for _ in range(10):
        x = sample(PP, values, rng)
        want = image.halving_sum(torch.from_numpy(x)[None], width)[0]
        assert tvio._patch_sum(torch.from_numpy(x)[None])[0].view(torch.int32) == \
            want.view(torch.int32)
        got = np.float32(wide_tree(x, width))
        assert got.view(np.int32) == want.numpy().view(np.int32), (P, x)


def block_sums(terms, nt):
    """csrc/photometric_measure.cuh::measure_point's per-point sums in
    numpy f32, written as the block runs them: terms (P*P, K) pixel-major;
    thread t sums pixels t, t + nt, ... in turn (the first as it is, zeros
    without one); each warp's butterfly (lane l adds lane l ^ m, m 16 ..
    1); lane 0 of each warp, the warps added in order."""
    PP, K = terms.shape
    acc = np.zeros((nt, K), np.float32)
    for t in range(nt):
        for k, p in enumerate(range(t, PP, nt)):
            acc[t] = terms[p] if k == 0 else acc[t] + terms[p]
    warps = []
    for w in range(nt // 32):
        v = acc[32 * w:32 * w + 32].copy()
        for m in (16, 8, 4, 2, 1):
            v = v + v[np.arange(32) ^ m]
        warps.append(v[0])
    t = warps[0]
    for s in warps[1:]:
        t = t + s
    return t


@pytest.mark.parametrize("values", ["random", "adversarial"])
@pytest.mark.parametrize("P", [1, 4, 8, 13, 16, 17, 19, 24, 32, 48])
def test_point_sums_are_the_measuring_blocks_order(P, values):
    """photometric.point_sums against the measuring block written out
    thread by thread, for three points of 43 terms; the threads at P <= 16
    are the previous launch's ((P+3)^2 rounded up to warps, at least 64:
    one thread a pixel), capped at MEAS_MAX_THREADS past it."""
    nt = photometric.meas_threads(P)
    if P <= 16:
        assert nt == 32 * max(-(-(P + 3) ** 2 // 32), 2) and nt >= P * P
    else:
        assert nt == photometric.MEAS_MAX_THREADS
    rng = np.random.default_rng(P + 100 * len(values))
    terms = sample(P * P * 3 * 43, values, rng).reshape(P * P, 3, 43)
    got = photometric.point_sums(torch.from_numpy(terms), P).numpy()
    for g in range(3):
        want = block_sums(terms[:, g], nt)
        np.testing.assert_array_equal(got[g].view(np.int32), want.view(np.int32))


@pytest.fixture(scope="module")
def three_maps():
    pts = np.random.default_rng(3).uniform(-4, 4, (300, 3)).astype(np.float32)
    return {"tiled": tm.build_host(pts, (16, 16, 8), 64, 0.5, device="cpu"),
            "hash": vm.empty_map(1 << 10, 0.5, device="cpu"),
            "dense": dm.empty_dense_map((16, 16, 8), 0.5, device="cpu")}


@pytest.mark.parametrize("kind,device,plane_fit,cache_knn,mesh", list(itertools.product(
    ("tiled", "hash", "dense"), ("cuda", "cpu"), ("tls", "ref"), (False, True),
    (False, True))))
def test_cascade_applies_truth_table(three_maps, kind, device, plane_fit, cache_knn, mesh):
    """One lio_cascade launch on one CUDA device with no mesh, on any of
    the three maps, with either fit and with or without cache_knn; the
    host loop everywhere else."""
    m = three_maps[kind]
    want = device == "cuda" and not mesh
    got = tlio.cascade_applies(m, torch.device(device), plane_fit, cache_knn,
                               object() if mesh else None)
    assert got == want
    assert not tlio.cascade_applies(object(), torch.device(device), plane_fit, cache_knn)
