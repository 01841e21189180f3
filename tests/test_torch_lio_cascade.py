"""The LIO cascade's plain pieces against the JAX package and each other.

On one card the LIO iterations are one launch of
ops/lio_cascade.lio_cascade; its plain version is the host loop
`lio.lio_loop`, which the CPU runs. Both take the world points, plane
distances and H rows as explicit 3-term sums and [HᵀH₆ | Hᵀz] in one fixed
order (`fixed_order_sum`). Here, on seeded inputs (numpy):
  - `lio_update` on the CPU (the host loop) against the JAX package's
    `lio_update(pallas_knn=True)` (its Pallas kernel in interpret mode) on
    the 32x32x8 tiled map of tests/test_torch_lio.py, at knn radius 1 and
    2 and max_iter 2 and 4: the tolerances of test_torch_lio's
    `_compare_result` (state, `iters` equal, cov rtol 1e-4, points 1e-5);
  - `fixed_order_sum` of the per-row products against `hw.T @ [h | -pd2]`
    in f64 (1e-6 of the largest entry), and bit for bit against a numpy
    transcription of its order;
  - the LIO step (laserMapping.cpp:1663-1683, sol = vec + K (Hᵀz -
    HᵀH₆ vec₆), the LIO thresholds) against `photometric_step_plain` fed
    -Hᵀz: bit-equal;
  - the dispatch: on the CPU `lio_update` never reaches the cascade; on a
    CUDA device it would with the tiled map only, never with hash, dense,
    `cache_knn`, `plane_fit: ref` or a mesh; the wrapper refuses CPU
    tensors.
The cascade itself runs only on the card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lio import _arrays, _compare_result, _maps, _scene
from test_torch_photometric_cascade import step_inputs

from fastlivo_tpu import lio as jlio
from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch import lio as tlio
from fastlivo_tpu_torch.ops import lio_cascade as lc
from fastlivo_tpu_torch.ops import linalg, photometric, so3


@pytest.fixture
def no_cascade(monkeypatch):
    """lio_update with a cascade that fails if reached, and a count of the
    host loop's runs."""
    runs = []
    loop = tlio.lio_loop

    def counted(*a, **kw):
        runs.append(1)
        return loop(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("lio_update reached the cascade")

    monkeypatch.setattr(tlio, "lio_loop", counted)
    monkeypatch.setattr(tlio, "lio_cascade", refuse)
    return runs


@pytest.mark.parametrize("max_iter", [4, 2])
@pytest.mark.parametrize("radius", [1, 2])
def test_lio_loop_matches_jax(no_cascade, radius, max_iter):
    world, scan, s = _scene(seed=4, n_scan=3000)
    mj, mt = _maps("tiled", world)
    pmask = np.ones(len(scan), bool)
    pmask[::13] = False
    kw = dict(laser_point_cov=0.001, max_iter=max_iter, knn_radius=radius)
    rj = jlio.lio_update(s, mj, jnp.asarray(scan), jnp.asarray(pmask),
                         jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32),
                         pallas_knn=True, **kw)
    st = convert.state_from_arrays(_arrays(s), "cpu")
    rt = tlio.lio_update(st, mt, torch.from_numpy(scan), torch.from_numpy(pmask),
                         torch.eye(3), torch.zeros(3), **kw)
    assert no_cascade == [1] and isinstance(rt.iters, int)
    _compare_result(rt, rj, pmask)


def tree_np(rows: np.ndarray) -> np.ndarray:
    """fixed_order_sum's order in numpy float32: chunks of 64 rows, each
    by a halving tree, then the chunk sums grouped by 64 the same way."""
    x = rows.astype(np.float32)
    if len(x) == 0:
        return np.zeros(rows.shape[1], np.float32)
    while True:
        g = -(-len(x) // 64)
        x = np.concatenate([x, np.zeros((g * 64 - len(x), x.shape[1]), np.float32)])
        sums = []
        for k in range(g):
            t = x[64 * k:64 * k + 64]
            while len(t) > 1:
                t = t[:len(t) // 2] + t[len(t) // 2:]
            sums.append(t[0])
        x = np.stack(sums)
        if g == 1:
            return x[0]


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 4097, 5000])
def test_fixed_order_sum(n):
    """[HᵀH₆ | Hᵀz] from the per-row products summed in the fixed order
    against the f64 product hw.T @ [h | -pd2], and bit for bit against
    the numpy transcription of the order (one, several and 79 chunks, so
    two levels of groups)."""
    rng = np.random.default_rng(n)
    h = rng.normal(size=(n, 6)).astype(np.float32) * np.float32(3.0)
    pd2 = rng.normal(size=n).astype(np.float32) * np.float32(0.05)
    act = rng.random(n) < 0.8
    hw = h * act[:, None].astype(np.float32)
    rhs = np.concatenate([h, -pd2[:, None]], 1)
    prods = (hw[:, :, None] * rhs[:, None, :]).reshape(n, 42)
    got = lc.fixed_order_sum(torch.from_numpy(prods))
    assert got.dtype == torch.float32 and got.shape == (42,)
    np.testing.assert_array_equal(got.numpy(), tree_np(prods))
    want = hw.astype(np.float64).T @ rhs.astype(np.float64)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    assert np.abs(got.numpy().reshape(6, 7) - want).max() <= 1e-6 * scale


def lio_step_reference(rot, x, prior_rot, prior_x, P_, HT):
    """The LIO step as laserMapping.cpp:1663-1688 writes it:
    sol = vec + K (Hᵀz - HᵀH₆ vec₆), converged at 0.01 deg and 0.015 cm."""
    HTH6, HTz = HT[:, 0:6].to(torch.float64), HT[:, 6].to(torch.float64)
    K16 = linalg.kalman_gain6_f64(P_, HTH6)
    vec = torch.cat([so3.log(rot.T @ prior_rot), prior_x - x])
    sol = vec + K16 @ (HTz - HTH6 @ vec[0:6])
    conv = ((torch.linalg.norm(sol[0:3]) * 57.3 < tlio.CONV_ROT_DEG)
            & (torch.linalg.norm(sol[3:6]) * 100.0 < tlio.CONV_POS_CM))
    return rot @ so3.exp(sol[0:3]), x + sol[3:18], conv, K16 @ HTH6


@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "at_prior"])
def test_lio_step_is_the_photometric_step_fed_minus_HTz(case):
    rot, x, prior_rot, prior_x, P_, HT = (
        torch.from_numpy(np.ascontiguousarray(a)) for a in step_inputs(
            int(case[-1]) if case != "at_prior" else 5))
    if case == "at_prior":  # a zero step: converged
        prior_rot, prior_x = rot, x
        HT[:, 6] = 0.0
    want = lio_step_reference(rot, x, prior_rot, prior_x, P_, HT)
    HTn = torch.cat([HT[:, 0:6], -HT[:, 6:7]], dim=1)
    got = photometric.photometric_step_plain(rot, x, prior_rot, prior_x, P_, HTn,
                                             (tlio.CONV_ROT_DEG, tlio.CONV_POS_CM))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[2]) == (case == "at_prior")


def test_dispatch():
    """The cascade runs on one CUDA device on any map with the TLS fit and
    no cache, and nowhere else; its wrapper refuses CPU tensors."""
    world, scan, s = _scene()
    _, tiled = _maps("tiled", world)
    _, dense = _maps("dense", world)
    _, hashed = _maps("hash", world)
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert tlio.cascade_applies(tiled, cuda)
    assert not tlio.cascade_applies(tiled, cpu)
    for m in (dense, hashed):
        assert tlio.cascade_applies(m, cuda)
        assert not tlio.cascade_applies(m, cpu)
    assert not tlio.cascade_applies(tiled, cuda, plane_fit="ref")
    assert not tlio.cascade_applies(tiled, cuda, cache_knn=True)
    assert not tlio.cascade_applies(tiled, cuda, mesh=object())
    st = convert.state_from_arrays(_arrays(s), "cpu")
    x = torch.cat([st.pos, st.vel, st.bg, st.ba, st.grav])
    n0 = lc.lio_cascade.launches
    with pytest.raises(ValueError, match="CUDA"):
        lc.lio_cascade(tiled, torch.from_numpy(scan), torch.ones(len(scan)),
                       torch.ones(len(scan), dtype=torch.bool), st.rot, x, st.rot, x,
                       st.cov, 4, 1, tlio.PLANE_THRESH, tlio.GATES, tlio.CONV)
    assert lc.lio_cascade.launches == n0


@pytest.mark.parametrize("backend", ["tiled", "hash", "dense"])
def test_lio_update_on_the_cpu_runs_the_host_loop(no_cascade, backend):
    world, scan, s = _scene()
    _, mt = _maps(backend, world)
    st = convert.state_from_arrays(_arrays(s), "cpu")
    res = tlio.lio_update(st, mt, torch.from_numpy(scan),
                          torch.ones(len(scan), dtype=torch.bool), torch.eye(3),
                          torch.zeros(3), 0.001, max_iter=3)
    assert no_cascade == [1] and isinstance(res.iters, int) and 1 <= res.iters <= 4
