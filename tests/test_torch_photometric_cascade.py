"""The photometric cascade's step and host loop against the JAX package.

The card runs the coarse-to-fine cascade in one launch
(ops/photometric.photometric_cascade); its plain version is the host loop
`vio.photometric_loop` with `photometric_step_plain`, which the CPU runs.
Here, on seeded inputs (numpy) and the camera scene of test_torch_vio:
  - `photometric_step_plain` against the same step composed from the JAX
    package's own functions (ops/linalg.kalman_gain6_f64, ops/so3.log /
    exp, the expressions of vio.py:669-691) on the same f64 inputs:
    within 1e-12 (two f64 solves of a 6x6 system, LU there and
    Gauss-Jordan here, agree to a few ulp of the gain);
  - the same at the branch edges of Log and Exp (the rotation between the
    pose and the prior at 0, on both sides of θ = 1e-3 and of trace 3 -
    1e-6, at 0.5 and near π; |sol[:3]|² on both sides of 1e-12);
  - `photometric.partials_sum`, the order in which the measurement kernels
    sum the per-point partials, bit for bit against a numpy transcription
    at G = 1, 7, 8 (the eight chains), 192 and 193;
  - `linalg.gj_solve6`, the plain mirror of the step kernel's elimination,
    against the JAX package's `gj_solve` on well-conditioned systems and
    on ones that need pivoting: within 1e-13;
  - `photometric_update_levels` on the CPU (the host loop) against the
    JAX package's while_loop at every robust mode and 1-3 levels: equal
    iterations, positions within 1e-6 m;
  - the wrappers' devices: the step on a CPU tensor is its plain version,
    the cascade takes CUDA tensors only.
The card's own checks are in tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastlivo_tpu import vio as jvio
from fastlivo_tpu.ops import linalg as jlinalg
from fastlivo_tpu.ops import so3 as jso3
from test_torch_vio import scene, tracked_both, tstate  # noqa: F401  (scene: a fixture)

from fastlivo_tpu_torch import vio as tvio
from fastlivo_tpu_torch.ops import linalg as tlinalg
from fastlivo_tpu_torch.ops import photometric


def step_inputs(seed):
    """A pose, a prior a few mm and mrad away, P' = cov / img_point_cov of
    a covariance as the filter holds it, and [HᵀH₆ | Hᵀz] in f32 as the
    measurement gives it (HᵀH₆ symmetric positive semi-definite)."""
    rng = np.random.default_rng(seed)
    rot = np.array(jso3.exp(jnp.asarray(rng.normal(size=3) * 0.8)))
    prior_rot = rot @ np.array(jso3.exp(jnp.asarray(rng.normal(size=3) * 3e-3)))
    x = rng.normal(size=15)
    prior_x = x + rng.normal(size=15) * 5e-3
    A = rng.normal(size=(18, 18)) * np.concatenate([np.full(6, 1e-2), np.full(12, 3e-2)])
    P_ = (A @ A.T + np.eye(18) * 1e-4) / 100.0
    J = rng.normal(size=(200, 6)) * rng.uniform(10.0, 300.0, 6)
    HTH = J.T @ J
    HTz = J.T @ rng.normal(size=200) * 20.0
    HT = np.concatenate([HTH, HTz[:, None]], 1).astype(np.float32)
    return rot, x, prior_rot, prior_x, P_, HT


def jax_step(rot, x, prior_rot, prior_x, P_, HT):
    """The JAX package's while_loop body (vio.py:669-691) with its exact
    f64 gain."""
    HT = jnp.asarray(HT)
    HTH6, HTz = HT[:, 0:6].astype(jnp.float64), HT[:, 6].astype(jnp.float64)
    K16 = jlinalg.kalman_gain6_f64(jnp.asarray(P_), HTH6)
    vec = jnp.concatenate([jso3.log(jnp.asarray(rot).T @ jnp.asarray(prior_rot)),
                           jnp.asarray(prior_x) - jnp.asarray(x)])
    sol = vec - K16 @ (HTz + HTH6 @ vec[0:6])
    n_rot = jnp.asarray(rot) @ jso3.exp(sol[0:3])
    conv = (jnp.linalg.norm(sol[0:3]) * 57.3 < 0.001) & (jnp.linalg.norm(sol[3:6]) * 100.0
                                                           < 0.001)
    return n_rot, jnp.asarray(x) + sol[3:18], conv, K16 @ HTH6


@pytest.mark.parametrize("seed", range(6))
def test_step_plain_matches_jax(seed):
    args = step_inputs(seed)
    want = [np.asarray(a) for a in jax_step(*args)]
    got = photometric.photometric_step_plain(*(torch.from_numpy(np.ascontiguousarray(a))
                                               for a in args))
    for g, w, name in zip(got, want, ("rot", "x", "conv", "G")):
        if name == "conv":
            assert bool(g) == bool(w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-12, err_msg=name)


# the rotation angle between the pose and the prior (about one axis):
# Log's branches (trace above 3 - 1e-6: θ = 0; θ below 1e-3: scale 0.5)
# and, with no measurement and the prior's x (sol = vec), Exp's (|sol[:3]|²
# below 1e-12: the Taylor forms)
EDGE_ANGLES = {"identity": 0.0, "theta_5e-4": 5e-4, "theta_below_1e-3": 0.999e-3,
               "theta_above_1e-3": 1.001e-3, "theta_3e-3": 3e-3, "theta_half": 0.5,
               "theta_near_pi": np.pi - 1e-2, "sol_below_1e-6": 0.999e-6,
               "sol_above_1e-6": 1.001e-6}


def edge_inputs(case):
    """step_inputs(5) with the prior's rotation EDGE_ANGLES[case] from the
    pose's; for the "sol_" cases [HᵀH₆ | Hᵀz] = 0 and prior_x = x, so that
    sol = vec and |sol[:3]| is that angle."""
    rot, x, _, prior_x, P_, HT = step_inputs(5)
    axis = np.array([0.3, -0.5, 0.8]) / np.linalg.norm([0.3, -0.5, 0.8])
    prior_rot = rot @ np.array(jso3.exp(jnp.asarray(axis * EDGE_ANGLES[case])))
    if case.startswith("sol_"):
        HT, prior_x = np.zeros_like(HT), x.copy()
    return rot, x, prior_rot, prior_x, P_, HT


@pytest.mark.parametrize("case", list(EDGE_ANGLES))
def test_step_plain_matches_jax_at_log_exp_edges(case):
    args = edge_inputs(case)
    want = [np.asarray(a) for a in jax_step(*args)]
    got = photometric.photometric_step_plain(*(torch.from_numpy(np.ascontiguousarray(a))
                                               for a in args))
    for g, w, name in zip(got, want, ("rot", "x", "conv", "G")):
        if name == "conv":
            assert bool(g) == bool(w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-12, err_msg=name)
    if case.startswith("sol_"):  # the step is the Log: sol[:3]·sol[:3] on its side of 1e-12
        sol = np.asarray(jso3.log(jnp.asarray(args[0].T @ args[2])))
        assert (float(sol @ sol) < 1e-12) == (case == "sol_below_1e-6")
        assert bool(got[2])


def partials_sum_numpy(p):
    """The kernels' order, written out per quantity in float32 scalars."""
    G, K = p.shape
    G8 = G - G % 8
    out = np.empty(K, np.float32)
    for q in range(K):
        t = [np.float32(0.0)] * 8
        for g in range(G8):
            t[g % 8] = np.float32(t[g % 8] + p[g, q])
        for g in range(G8, G):
            t[0] = np.float32(t[0] + p[g, q])
        out[q] = np.float32(np.float32(np.float32(t[0] + t[1]) + np.float32(t[2] + t[3]))
                            + np.float32(np.float32(t[4] + t[5]) + np.float32(t[6] + t[7])))
    return out


@pytest.mark.parametrize("G", [1, 7, 8, 192, 193])
def test_partials_sum_is_the_kernels_order(G):
    """Bit for bit against the numpy transcription, on rows whose sums
    depend on the order (magnitudes 1e-3 to 1e4, a column of -0.0 that
    the chains' +0.0 start turns into +0.0); and near the f32 sum."""
    rng = np.random.default_rng(G)
    p = (rng.normal(size=(G, 44)) * 10.0 ** rng.uniform(-3, 4, (G, 44))).astype(np.float32)
    p[:, 5] = -0.0
    got = photometric.partials_sum(torch.from_numpy(p)).numpy()
    want = partials_sum_numpy(p)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert not np.signbit(got[5])
    np.testing.assert_allclose(got, p.astype(np.float64).sum(0), rtol=1e-4,
                               atol=1e-6 * np.abs(p).sum(0).max())


def test_step_plain_converges_on_the_prior():
    """At the prior with Hᵀz = 0 the step is zero and converged; with
    HᵀH = 0 it lands on the prior and G = 0 exactly."""
    rot, x, _, _, P_, HT = step_inputs(7)
    t = torch.from_numpy
    HT0 = HT.copy()
    HT0[:, 6] = 0.0
    n_rot, n_x, conv, _ = photometric.photometric_step_plain(t(rot), t(x), t(rot), t(x),
                                                             t(P_), t(HT0))
    assert bool(conv)
    np.testing.assert_allclose(n_x.numpy(), x, atol=1e-15)
    _, prior_x = step_inputs(8)[2:4]
    n_rot, n_x, conv, G = photometric.photometric_step_plain(
        t(rot), t(x), t(rot), t(prior_x), t(P_), torch.zeros((6, 7)))
    assert torch.equal(G, torch.zeros((18, 6), dtype=torch.float64))
    np.testing.assert_allclose(n_x.numpy(), prior_x, atol=1e-14)


def gj_systems():
    rng = np.random.default_rng(11)
    out = []
    for _ in range(3):  # diagonally dominant: no row swap at any column
        S = rng.normal(size=(6, 6)) + np.eye(6) * 8.0
        out.append((S, rng.normal(size=(6, 18))))
    for k in range(3):  # zero or tiny diagonals: every column pivots
        S = rng.normal(size=(6, 6))
        perm = np.roll(np.arange(6), k + 1)
        S = (S + np.eye(6) * 8.0)[perm]
        S[0, 0] = 0.0 if k == 0 else 1e-9
        out.append((S, rng.normal(size=(6, 18))))
    Pp = step_inputs(3)[4]  # a gain system: (HᵀH₆ P'[:6, :6] + I)ᵀ Kᵀ = P'[:, :6]ᵀ
    HTH = step_inputs(3)[5][:, 0:6].astype(np.float64)
    out.append(((HTH @ Pp[0:6, 0:6] + np.eye(6)).T, Pp[:, 0:6].T))
    out.append((rng.normal(size=(6, 6)), rng.normal(size=6)))  # a vector right-hand side
    return out


@pytest.mark.parametrize("k", range(8))
def test_gj_solve6_matches_jax(k):
    S, B = gj_systems()[k]
    want = np.asarray(jlinalg.gj_solve(jnp.asarray(S), jnp.asarray(B)))
    got = tlinalg.gj_solve6(torch.from_numpy(S), torch.from_numpy(B)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
    np.testing.assert_allclose(S @ got, B, atol=1e-9)


@pytest.fixture(scope="module")
def tracked(scene):  # noqa: F811
    return tracked_both(scene)


@pytest.mark.parametrize("levels", [(2,), (2, 1), (2, 1, 0)])
@pytest.mark.parametrize("robust", ["none", "huber", "tukey"])
def test_update_levels_cpu_matches_jax(scene, tracked, levels, robust):  # noqa: F811
    tj, tt, _, _ = tracked
    jv, tv = scene["jv"], scene["tv"]
    prior = scene["prior"]
    args_j = (jv.Rci, jv.Pci, jv.Jdphi_dR, jv.Jdp_dR)
    fj = jax.jit(lambda s, p, tp, tpa, ts, tva: jvio.photometric_update_levels(
        s, p, jv.cam, jnp.asarray(scene["gray"]), tp, tpa, ts, tva, *args_j,
        img_point_cov=jv._ipc_dev, patch_size=8, levels=levels, max_iter=6,
        robust=robust))
    sj, _, _, _, itj = fj(prior, prior, tj.pos, tj.patch, tj.search_level, tj.valid)
    pt = tstate(prior)
    st, _, _, _, itt = tvio.photometric_update_levels(
        pt, pt, tv.cam, torch.from_numpy(scene["gray"]), tt.pos, tt.patch,
        tt.search_level, tt.valid, tv.Rci, tv.Pci, tv.Jdphi_dR, tv.Jdp_dR,
        tv._ipc_dev, 8, levels=levels, max_iter=6, robust=robust)
    assert isinstance(itt, int) and itt == int(itj) >= len(levels)
    np.testing.assert_allclose(st.pos.numpy(), np.asarray(sj.pos), rtol=0, atol=1e-6)
    np.testing.assert_allclose(st.rot.numpy(), np.asarray(sj.rot), rtol=0, atol=1e-6)


def test_step_wrapper_runs_plain_on_the_cpu():
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in step_inputs(2)]
    n0 = photometric.photometric_step.launches
    got = photometric.photometric_step(*args)
    want = photometric.photometric_step_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert photometric.photometric_step.launches == n0


def test_cascade_takes_cuda_only(scene, tracked):  # noqa: F811
    """No CPU path in the cascade's wrapper: on a CPU tensor it raises
    and launches nothing; `photometric_update_levels` runs the host loop
    there."""
    _, tt, _, _ = tracked
    tv = scene["tv"]
    pt = tstate(scene["prior"])
    x = torch.cat([pt.pos, pt.vel, pt.bg, pt.ba, pt.grav])
    n0 = photometric.photometric_cascade.launches
    with pytest.raises(ValueError, match="CUDA"):
        photometric.photometric_cascade(
            torch.from_numpy(scene["gray"]), tt.pos, tt.patch, tt.search_level, tt.valid,
            pt.rot, x, pt.rot, x, pt.cov, tv.Rci, tv.Pci, tv.Jdphi_dR, tv.Jdp_dR, tv.cam,
            (2, 1, 0), 8, 6)
    assert photometric.photometric_cascade.launches == n0
