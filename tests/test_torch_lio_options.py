"""The LIO options inside the one-launch cascade: `cache_knn` and `plane_fit: ref`.

On one card `lio_update` runs every option as one lio_cascade launch: the
block `cache_knn` needs is written by that launch's first search (the map
walk's gather form) and re-ranked by csrc/knn5_cached_walk.cuh at every
later one, and the reference's plane is fitted by csrc/plane_fit.cuh's
plane5_fit_ref, both held bit for bit against the host loop
`lio.lio_loop` with `lio.host_search` on the block the backend's
knn_candidates gathers in torch ops (tests/test_torch_cuda.py, `-m
cuda`). Here, on the CPU, on seeded inputs (numpy):
  - `plane.fit_plane_ref`, its sums written out in the kernel's order,
    against the JAX package's `fit_plane_ref` in f64 within 1e-12 of each
    entry's magnitude (at least 1), gates equal: random neighbourhoods,
    missing picks (zero rows), all five missing, collinear picks, one point
    five times, and a `valid` mask;
  - the five picks of the kernels' lowest-row min-select (a numpy
    transcription of knn5_select.cuh's group_top5 rule) equal to
    `topk_from_candidates`' stable sort, the points and the distances, at
    exact ties and with fewer than five candidates found (the markers of a
    pick not found differ, 1e30 and 3e37, and fail the 5th-NN gate alike):
    the reference fit's loop picks through the sort, the cascade through
    the min-select;
  - `lio_update` with `cache_knn`, with `plane_fit: ref` and with both, on
    the dense map and at radius 2 (tests/test_torch_lio.py holds the rest),
    against the JAX package at test_torch_lio's tolerances; with
    `cache_knn` on the CPU one knn_candidates gather a call, on every map;
  - `host_search`, the loop's search, the same on the CPU with and without
    `plain`;
  - `lio_update` at `knn_voxel_radius` 0 (one candidate: no plane is
    fitted) and 3 (343 candidates, the kernels' generic form on the card)
    on the tiled, hash and dense maps, with `cache_knn` and with
    `plane_fit: ref` at radius 3, against the JAX package at
    test_torch_lio's tolerances;
  - the wrapper's refusals, with no launch counted: CPU tensors on every
    route, a negative or non-integer radius, a block handed in without
    `cache_knn`, and block buffers of the wrong shape (a block of another
    radius's M), dtype, device or layout (`check_block`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lio import _arrays, _compare_result, _compare_state, _maps, _scene

from fastlivo_tpu import lio as jlio
from fastlivo_tpu.ops import plane as jplane
from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch import lio as tlio
from fastlivo_tpu_torch.ops import dense_map as tdm
from fastlivo_tpu_torch.ops import lio_cascade as lc
from fastlivo_tpu_torch.ops import plane as tplane
from fastlivo_tpu_torch.ops import tiled_map as ttm
from fastlivo_tpu_torch.ops import voxel_map as tvm

PLANE_CASES = ["random", "missing_picks", "all_missing", "collinear", "repeated", "masked"]


def plane_sets(case, n=4000, seed=0):
    """(pts (n, 5, 3) f64 holding f32 values, as the search's picks are,
    valid (n, 5) bool or None): neighbourhoods of 5 points on noisy planes
    up to 20 m from the origin, then the case's degenerate rows."""
    rng = np.random.default_rng(seed + PLANE_CASES.index(case))
    c = rng.uniform(-20, 20, (n, 1, 3))
    pts = c + rng.normal(size=(n, 5, 3)) * np.array([0.3, 0.3, 0.01])
    valid = None
    if case == "missing_picks":  # the last one to three picks not found: zeros
        k = rng.integers(2, 5, n)
        pts[np.arange(5)[None, :] >= k[:, None]] = 0.0
    elif case == "all_missing":
        pts[: n // 2] = 0.0
    elif case == "collinear":
        pts = c + np.linspace(0.0, 1.0, 5)[None, :, None] * rng.normal(size=(n, 1, 3))
    elif case == "repeated":
        pts[: n // 2] = c[: n // 2]
    elif case == "masked":
        valid = rng.random((n, 5)) > 0.15
    return pts.astype(np.float32).astype(np.float64), valid


@pytest.mark.parametrize("case", PLANE_CASES)
def test_fit_plane_ref_matches_jax(case):
    pts, valid = plane_sets(case)
    got, ok = tplane.fit_plane_ref(torch.from_numpy(pts),
                                   None if valid is None else torch.from_numpy(valid))
    want, ok_j = jplane.fit_plane_ref(jnp.asarray(pts),
                                      None if valid is None else jnp.asarray(valid))
    want, ok_j = np.asarray(want), np.asarray(ok_j)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(ok.numpy(), ok_j)
    got = got.numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    err = np.abs(got[fin] - want[fin]) / np.maximum(1.0, np.abs(want[fin]))
    assert err.max(initial=0.0) <= 1e-12, err.max()
    if case == "random":
        assert ok.sum() > 0.9 * len(ok)
    if case == "all_missing":
        assert not ok[: len(ok) // 2].any()


def test_fit_plane_ref_on_f32_picks_rounds_once():
    """On f32 picks (the search's) the plane is the f64 fit cast down once:
    the f64 result of the same values, rounded to f32."""
    pts, _ = plane_sets("random")
    got, ok = tplane.fit_plane_ref(torch.from_numpy(pts.astype(np.float32)))
    want, ok64 = tplane.fit_plane_ref(torch.from_numpy(pts))
    assert got.dtype == torch.float32
    assert torch.equal(got, want.float()) and torch.equal(ok, ok64)


def min_select(cand, found, q):
    """The kernels' selection (knn5_select.cuh's group_top5, knn5_plane.cu):
    five rounds, each the lowest row holding the least squared distance
    (dx dx + dy dy) + dz dz, BIG for a row not found; a pick whose
    distance is BIG is the point 0. Returns (neigh (N, 5, 3), nd2 (N, 5))."""
    big = np.float32(3.0e37)
    diff = cand - q[:, None, :]
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]
    d2 = np.where(found, d2, big).astype(np.float32)
    rows = np.arange(len(q))
    neigh, nd2 = [], []
    for _ in range(5):
        pick = np.argmin(d2, axis=1)  # the first (lowest) row of the minimum
        dmin = d2[rows, pick]
        v = dmin < big * np.float32(0.5)
        neigh.append(np.where(v[:, None], cand[rows, pick], np.float32(0.0)))
        nd2.append(dmin)
        d2[rows, pick] = big
    return np.stack(neigh, 1), np.stack(nd2, 1)


def lattice_block(case, radius=1):
    """A tiled map of 0.5 m voxel centres and queries against it: "ties"
    (one full layer, queries at its squares' corners: four picks at one
    distance, then four tied for the fifth), "sparse" (12% of a 3D block,
    queries near its points: most neighbourhoods hold fewer than five)."""
    from fastlivo_tpu_torch.ops import tiled_map as ttm

    rng = np.random.default_rng(5)
    if case == "ties":
        g = np.stack(np.meshgrid(np.arange(-12, 12), np.arange(-12, 12), [-1],
                                 indexing="ij"), -1).reshape(-1, 3)
    else:
        g = np.stack(np.meshgrid(np.arange(-12, 12), np.arange(-12, 12), np.arange(-2, 2),
                                 indexing="ij"), -1).reshape(-1, 3)
        g = g[rng.random(len(g)) < 0.12]
    pts = ((g + 0.5) * 0.5).astype(np.float32)
    m = ttm.build_host(pts, (32, 32, 8), 1024, 0.5, device="cpu")
    q = pts + (np.float32([0.25, 0.25, 0.0]) if case == "ties"
               else rng.normal(0, 0.05, pts.shape).astype(np.float32))
    q = torch.from_numpy(q)
    cand, found = ttm.knn_candidates(m, q, radius)
    return cand, found, q


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("case", ["ties", "sparse"])
def test_min_select_picks_what_the_stable_sort_picks(case, radius):
    cand, found, q = lattice_block(case, radius)
    neigh, nd2, _ = tvm.topk_from_candidates(cand, found, q, 5)
    neigh_k, nd2_k = min_select(cand.numpy(), found.numpy(), q.numpy())
    np.testing.assert_array_equal(neigh.numpy(), neigh_k)
    # a pick not found: the sort's BIG is 1e30, the kernels' 3e37; both
    # fail the 5th-NN gate alike
    miss = nd2.numpy() >= 1e29
    np.testing.assert_array_equal(miss, nd2_k >= 1e29)
    np.testing.assert_array_equal(nd2.numpy()[~miss], nd2_k[~miss])
    assert miss.any() and not (nd2.numpy()[miss] <= tlio.SQ_DIST_GATE).any()
    d2 = np.sort(np.where(found.numpy(), ((cand - q[:, None]) ** 2).sum(-1).numpy(), np.inf), 1)
    if case == "ties":
        assert int((d2[:, 4] == d2[:, 5]).sum()) > 300
    elif radius == 1:
        assert int((found.sum(1) < 5).sum()) > 100


def _lio_both(backend, radius, **opts):
    world, scan, s = _scene()
    mj, mt = _maps(backend, world)
    pmask = np.ones(len(scan), bool)
    pmask[::17] = False
    kw = dict(laser_point_cov=0.001, max_iter=4, knn_radius=radius, **opts)
    rj = jlio.lio_update(s, mj, jnp.asarray(scan), jnp.asarray(pmask),
                         jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32),
                         pallas_knn=opts.get("plane_fit", "tls") == "tls", **kw)
    st = convert.state_from_arrays(_arrays(s), "cpu")
    rt = tlio.lio_update(st, mt, torch.from_numpy(scan), torch.from_numpy(pmask),
                         torch.eye(3), torch.zeros(3), **kw)
    return rt, rj, pmask


@pytest.mark.parametrize("option", ["cache_knn", "ref", "cache_knn_ref"])
@pytest.mark.parametrize("backend,radius", [("dense", 1), ("tiled", 2), ("hash", 2)])
def test_lio_update_with_options_matches_jax(backend, radius, option):
    opts = {"cache_knn": dict(cache_knn=True), "ref": dict(plane_fit="ref"),
            "cache_knn_ref": dict(cache_knn=True, plane_fit="ref")}[option]
    _compare_result(*_lio_both(backend, radius, max_probe=12, **opts))


RADIUS_CASES = [("tiled", 0, "plain"), ("hash", 0, "plain"), ("dense", 0, "cache_knn"),
                ("tiled", 3, "plain"), ("hash", 3, "plain"), ("dense", 3, "plain"),
                ("hash", 3, "cache_knn"), ("tiled", 3, "ref"), ("dense", 3, "cache_knn_ref")]


@pytest.mark.parametrize("backend,radius,option", RADIUS_CASES)
def test_lio_update_at_radius_0_and_3_matches_jax(backend, radius, option):
    """Any `knn_voxel_radius` the JAX package takes: at radius 0 each query
    has one candidate (fewer than five: every plane gate fails, so the
    update keeps the prior), at radius 3 343 of them; the port's
    lio_update matches the JAX package's at test_torch_lio's tolerances on
    every map, with and without the options."""
    opts = {"plain": {}, "cache_knn": dict(cache_knn=True), "ref": dict(plane_fit="ref"),
            "cache_knn_ref": dict(cache_knn=True, plane_fit="ref")}[option]
    rt, rj, pmask = _lio_both(backend, radius, max_probe=12, **opts)
    if radius == 0:  # _compare_result's tolerances; nothing is active
        _compare_state(rt.state, rj.state)
        np.testing.assert_allclose(rt.state.cov.numpy(), np.asarray(rj.state.cov),
                                   rtol=1e-4, atol=1e-9)
        assert rt.iters == int(rj.iters)
        assert int(rt.n_active) == int(rj.n_active) == 0
        np.testing.assert_allclose(rt.pts_world.numpy(), np.asarray(rj.pts_world), atol=1e-5)
    else:
        _compare_result(rt, rj, pmask)


@pytest.mark.parametrize("backend", ["tiled", "hash", "dense"])
def test_lio_update_cache_knn_on_the_cpu_gathers_once(backend, monkeypatch):
    """On the CPU `cache_knn` is the host loop on the block the backend's
    knn_candidates gathers once a call, at the prior pose (the card's
    cascade writes it at its first search instead); the result matches
    the JAX package at test_torch_lio's tolerances."""
    mod = {"tiled": ttm, "hash": tvm, "dense": tdm}[backend]
    calls = []
    real = mod.knn_candidates

    def spied(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(mod, "knn_candidates", spied)
    n0 = lc.lio_cascade.launches
    rt, rj, pmask = _lio_both(backend, 1, max_probe=12, cache_knn=True)
    assert len(calls) == 1 and lc.lio_cascade.launches == n0
    assert isinstance(rt.iters, int) and rt.iters >= 2
    _compare_result(rt, rj, pmask)


@pytest.mark.parametrize("fit", ["tls", "ref"])
@pytest.mark.parametrize("cached", [False, True])
def test_host_search_plain_is_the_cpu_search(cached, fit):
    """On the CPU the kernels' wrappers run their plain versions, so the
    loop's search with and without `plain` gives the same bits."""
    world, scan, _ = _scene()
    _, m = _maps("hash", world)
    q = torch.from_numpy(scan)
    cand = found = None
    if cached:
        cand, found = tvm.knn_candidates(m, q, 1, 12)
    q = q + 0.01
    outs = [tlio.host_search(m, 1, tlio.PLANE_THRESH, 12, fit, cand, found, plain)(q)
            for plain in (False, True)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert int(outs[0][1].sum()) > 1000


def test_lio_cascade_refuses_cpu_tensors_and_bad_blocks():
    """The wrapper refuses CPU tensors on every route (walk and gather, either
    fit), a negative or non-integer radius and a block without
    `cache_knn`, launching nothing; `check_block` refuses block buffers of
    the wrong shape (a block of another radius's M), dtype, device or
    layout."""
    world, scan, s = _scene()
    _, m = _maps("tiled", world)
    st = convert.state_from_arrays(_arrays(s), "cpu")
    x = torch.cat([st.pos, st.vel, st.bg, st.ba, st.grav])
    q = torch.from_numpy(scan)
    n = len(scan)

    cand, found = ttm.knn_candidates(m, q, 1)
    n0 = lc.lio_cascade.launches

    def call(radius=1, cache_knn=True, fit="tls", block=None):
        lc.lio_cascade(m, q, torch.ones(n), torch.ones(n, dtype=torch.bool), st.rot, x,
                       st.rot, x, st.cov, 4, radius, tlio.PLANE_THRESH, tlio.GATES, tlio.CONV,
                       12, cache_knn, fit, block)

    for fit in ("tls", "ref"):
        for cache_knn in (False, True):
            with pytest.raises(ValueError, match="CUDA"):
                call(cache_knn=cache_knn, fit=fit)
        for radius in (-1, 1.0, True):
            with pytest.raises(ValueError, match="radius"):
                call(radius=radius, fit=fit)
    with pytest.raises(ValueError, match="cache_knn"):
        call(cache_knn=False, block=(cand, found))
    assert lc.lio_cascade.launches == n0
    cpu = torch.device("cpu")
    lc.check_block(cand, found, n, 1, cpu)  # the good block passes
    for bad, err in (((cand[:, :26].contiguous(), found, n, 1), ValueError),
                     ((cand, found, n, 2), ValueError), ((cand, found, n, 3), ValueError),
                     ((cand, found, n, 0), ValueError), ((cand, found, n, -1), ValueError),
                     ((cand[:-1], found, n, 1), ValueError),
                     ((cand.double(), found, n, 1), TypeError),
                     ((cand, found.to(torch.uint8), n, 1), TypeError),
                     ((cand.transpose(0, 1).contiguous().transpose(0, 1), found, n, 1),
                      ValueError)):
        with pytest.raises(err):
            lc.check_block(*bad, cpu)
    with pytest.raises(ValueError):
        lc.check_block(cand, found, n, 1, torch.device("meta"))
