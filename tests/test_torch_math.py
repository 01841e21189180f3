"""Port parity: SO(3), the navigation state, the plane fit and the f64 gain.

The same seeded numpy inputs go through the JAX package and through
fastlivo_tpu_torch on the CPU. Tolerances: f64 atol 1e-12, f32 rtol 1e-5
(elementwise arithmetic in the same order; only library transcendentals
and reduction orders differ), gain rtol 1e-10. Plane normals get the
same base tolerance scaled by the scatter's condition number, which
amplifies the rounding of the smallest eigenvalue (see _row_tol).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fastlivo_tpu import state as jstate
from fastlivo_tpu.ops import linalg as jlinalg
from fastlivo_tpu.ops import plane as jplane
from fastlivo_tpu.ops import so3 as jso3

from fastlivo_tpu_torch import convert, state as tstate
from fastlivo_tpu_torch.ops import linalg as tlinalg
from fastlivo_tpu_torch.ops import plane as tplane
from fastlivo_tpu_torch.ops import so3 as tso3

TOL = {np.float64: dict(rtol=0, atol=1e-12), np.float32: dict(rtol=1e-5, atol=1e-6)}


def _phis(rng, n, dtype):
    # random angles plus the small-angle branches of exp and log
    phi = rng.normal(0, 1.0, (n, 3))
    phi[:8] *= 1e-9
    phi[8:16] *= 1e-4
    return phi.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_so3_matches_jax(dtype):
    rng = np.random.default_rng(0)
    phi = _phis(rng, 256, dtype)
    t = torch.from_numpy(phi)
    np.testing.assert_allclose(tso3.skew(t).numpy(),
                               np.asarray(jso3.skew(jnp.asarray(phi))), **TOL[dtype])
    R_j = np.array(jso3.exp(jnp.asarray(phi)))
    R_t = tso3.exp(t).numpy()
    np.testing.assert_allclose(R_t, R_j, **TOL[dtype])
    np.testing.assert_allclose(tso3.log(torch.from_numpy(R_j)).numpy(),
                               np.asarray(jso3.log(jnp.asarray(R_j))), **TOL[dtype])


def _random_state(rng):
    A = rng.normal(size=(18, 18)) * 0.01
    return jstate.NavState(
        rot=jso3.exp(jnp.asarray(rng.normal(size=3))),
        pos=jnp.asarray(rng.normal(size=3)),
        vel=jnp.asarray(rng.normal(size=3)),
        bg=jnp.asarray(rng.normal(size=3) * 1e-3),
        ba=jnp.asarray(rng.normal(size=3) * 1e-2),
        grav=jnp.asarray([0.0, 0.0, -9.81]) + jnp.asarray(rng.normal(size=3) * 1e-2),
        cov=jnp.asarray(A @ A.T + np.eye(18) * 1e-3),
    )


def _arrays(nt):
    return {k: np.array(v) for k, v in nt._asdict().items()}


def test_state_ops_match_jax():
    rng = np.random.default_rng(1)
    sj = _random_state(rng)
    st = convert.state_from_arrays(_arrays(sj), "cpu")
    delta = rng.normal(size=18) * 0.1
    pj = jstate.boxplus(sj, jnp.asarray(delta))
    pt = tstate.boxplus(st, torch.from_numpy(delta))
    for f in jstate.NavState._fields:
        np.testing.assert_allclose(getattr(pt, f).numpy(),
                                   np.asarray(getattr(pj, f)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tstate.boxminus(pt, st).numpy(),
                               np.asarray(jstate.boxminus(pj, sj)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tstate.boxminus(pt, st).numpy(), delta, atol=1e-12)
    np.testing.assert_array_equal(tstate.pack24(st).numpy(),
                                  np.asarray(jstate.pack24(sj)))
    ident = convert.state_to_arrays(tstate.identity_state("cpu"))
    for f, v in _arrays(jstate.identity_state()).items():
        np.testing.assert_array_equal(ident[f], v)
        assert ident[f].dtype == v.dtype


def _neighbour_sets(rng, n, dtype):
    # near-planar 5-point sets (f32: far from the origin, where a
    # non-centred fit would lose precision), plus degenerate ones
    span = 50.0 if dtype == np.float32 else 5.0
    c = rng.uniform(-span, span, (n, 1, 3))
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    p = c + rng.normal(0, 0.3, (n, 5, 3))
    off = np.sum((p - c) * nrm[:, None], -1)
    p -= (off * 0.98)[..., None] * nrm[:, None]
    p[:4] = c[:4]  # coincident points: isotropic scatter -> +z fallback
    return p.astype(dtype)


def _row_tol(pts, valid, base, dtype):
    """Per-set tolerance of a smallest-eigenvector: `base` for a
    well-conditioned scatter, growing with its condition number
    lambda_max / (lambda_2 - lambda_1), which amplifies the rounding of
    lambda_min (eps * cond: the eigenvector's first-order sensitivity)."""
    w = valid[..., None].astype(np.float64)
    c = (pts * w).sum(1) / np.maximum(w.sum(1), 1.0)
    e = (pts - c[:, None]) * w
    ev = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", e, e))
    cond = ev[:, 2] / np.maximum(ev[:, 1] - ev[:, 0], 1e-300)
    tol_n = base + 64 * np.finfo(dtype).eps * np.minimum(cond, 1e30)
    return tol_n, tol_n * (1.0 + np.linalg.norm(c, axis=1))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plane_fit_matches_jax(dtype):
    """Normals and offsets within 1e-12 (f64) / 1e-5 (f32) of the JAX
    fit, scaled up by the scatter's condition number (see _row_tol)."""
    rng = np.random.default_rng(2)
    pts = _neighbour_sets(rng, 512, dtype)
    valid = rng.random((512, 5)) > 0.1
    base = 1e-12 if dtype == np.float64 else 1e-5
    for v in (np.ones((512, 5), bool), valid):
        pj, okj = jplane.fit_plane(jnp.asarray(pts), jnp.asarray(v))
        pt, okt = tplane.fit_plane(torch.from_numpy(pts), torch.from_numpy(v))
        pj, pt = np.asarray(pj), pt.numpy()
        tol_n, tol_d = _row_tol(pts.astype(np.float64), v, base, dtype)
        assert np.all(np.abs(pt[:, :3] - pj[:, :3]).max(1) <= tol_n)
        assert np.all(np.abs(pt[:, 3] - pj[:, 3]) <= tol_d)
        np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    # the default (valid=None) is the all-valid fit
    np.testing.assert_array_equal(
        tplane.fit_plane(torch.from_numpy(pts))[0].numpy(),
        tplane.fit_plane(torch.from_numpy(pts),
                         torch.ones(512, 5, dtype=torch.bool))[0].numpy())
    q = rng.normal(size=(512, 3)).astype(dtype)
    np.testing.assert_allclose(
        tplane.point_to_plane(torch.from_numpy(pt), torch.from_numpy(q)).numpy(),
        np.asarray(jplane.point_to_plane(jnp.asarray(pt), jnp.asarray(q))),
        **TOL[dtype])


def test_kalman_gain_matches_jax_f64():
    rng = np.random.default_rng(3)
    for _ in range(5):
        A = rng.normal(size=(18, 18))
        P = (A @ A.T + np.eye(18)) * 1e-3 / 0.001
        H = rng.normal(size=(400, 6)) * np.array([3, 3, 3, 1, 1, 1])
        HTH = H.T @ H
        want = np.asarray(jlinalg.kalman_gain6_f64(jnp.asarray(P), jnp.asarray(HTH)))
        got = tlinalg.kalman_gain6_f64(torch.from_numpy(P), torch.from_numpy(HTH)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)
