"""Port parity: IMU initialization, propagation, pose-table merge and
scan undistortion.

Same seeded numpy IMU streams through both packages on the CPU.
Tolerances: propagated state atol 1e-10 (f64 recursion; f32 inputs),
undistorted points atol 1e-5 (f32 batched 3x3 products in another
summation order).
"""
import numpy as np
import torch
import jax.numpy as jnp

from fastlivo_tpu import imu as jimu
from fastlivo_tpu import state as jstate

from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch import imu as timu
from fastlivo_tpu_torch import state as tstate


def _arrays(nt):
    return {k: np.array(v) for k, v in nt._asdict().items()}


def _imu_samples(rng, t0, t1, hz=200.0):
    t = np.arange(t0, t1, 1.0 / hz) + rng.uniform(0, 1e-3)
    acc = np.array([0.1, -0.2, 9.81]) + rng.normal(0, 0.3, (len(t), 3))
    gyr = np.array([0.2, -0.1, 0.3]) + rng.normal(0, 0.05, (len(t), 3))
    return t, acc, gyr


def _calibs(rng):
    init_j, init_t = jimu.ImuInitializer(), timu.ImuInitializer()
    _, acc, gyr = _imu_samples(rng, 0.0, 1.1)
    for a, g in zip(acc, gyr):
        init_j.push(a, g)
        init_t.push(a, g)
    assert init_j.done and init_t.done
    lid_rot = jstate.so3.exp(jnp.asarray([0.01, -0.02, 0.03]))
    lid_off = np.array([0.05, -0.02, 0.1])
    cj = init_j.calib(1.0, 1.0, np.asarray(lid_rot), lid_off)
    ct = init_t.calib(1.0, 1.0, np.asarray(lid_rot), lid_off, device="cpu")
    for f, v in _arrays(cj).items():
        np.testing.assert_array_equal(getattr(ct, f).numpy(), v, err_msg=f)
    np.testing.assert_array_equal(init_t.gravity(), init_j.gravity())
    return cj, ct


def _state(rng):
    A = rng.normal(size=(18, 18)) * 0.01
    return jstate.identity_state()._replace(
        rot=jstate.so3.exp(jnp.asarray(rng.normal(size=3) * 0.3)),
        pos=jnp.asarray(rng.normal(size=3)),
        vel=jnp.asarray(rng.normal(size=3) * 0.5),
        bg=jnp.asarray(rng.normal(size=3) * 1e-3),
        grav=jnp.asarray([0.0, 0.0, -9.81]),
        cov=jnp.asarray(A @ A.T + np.eye(18) * 1e-3),
    )


def test_propagate_merge_undistort_match_jax():
    rng = np.random.default_rng(0)
    cj, ct = _calibs(rng)
    sj = _state(rng)
    st = convert.state_from_arrays(_arrays(sj), "cpu")
    a_j = a_t = np.zeros(3, np.float32)
    g_j = g_t = np.zeros(3, np.float32)
    a_t, g_t = torch.from_numpy(a_t), torch.from_numpy(g_t)
    packs_j, packs_t, flat = [], [], []
    beg, last_end, off = 10.0, 9.98, 0
    # two groups of one scan: an image-time segment, then the scan end;
    # bucket 32 leaves padded (invalid) pairs in each
    for end in (10.04, 10.1):
        t, acc, gyr = _imu_samples(rng, last_end - 0.004, end + 0.001)
        pp = jimu.prepare_pairs(t, acc, gyr, beg, end, last_end, 32)
        pp_t = timu.prepare_pairs(t, acc, gyr, beg, end, last_end, 32)
        for x, y in zip(pp, pp_t):
            np.testing.assert_array_equal(x, y)
        wire = jimu.pack_pairs_wire(*pp)
        np.testing.assert_array_equal(wire, timu.pack_pairs_wire(*pp_t))
        sj, pk_j, a_j, g_j = jimu.propagate_wire(sj, jnp.asarray(wire), jnp.asarray(a_j),
                                                 jnp.asarray(g_j), cj)
        st, pk_t, a_t, g_t = timu.propagate_wire(st, torch.from_numpy(wire), a_t, g_t, ct)
        for f in jstate.NavState._fields:
            np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(sj, f)),
                                       rtol=0, atol=1e-10, err_msg=f)
        np.testing.assert_allclose(pk_t.numpy(), np.asarray(pk_j), rtol=0, atol=1e-10)
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=0, atol=1e-10)
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=0, atol=1e-10)
        packs_j.append(pk_j)
        packs_t.append(pk_t)
        keep = np.nonzero(np.concatenate([[True], pp[4]]))[0]
        flat.append(keep + off)
        off += pk_j.shape[0] - 1
        last_end = end

    flat = np.concatenate(flat)
    M = 128
    idx = np.full(M, flat[-1], np.int32)
    idx[:len(flat)] = flat
    valid = np.arange(M) < len(flat)
    pose_j = jimu.merge_pose_packs(tuple(packs_j), jnp.asarray(idx), jnp.asarray(valid), m_out=M)
    pose_t = timu.merge_pose_packs(packs_t, torch.from_numpy(idx), torch.from_numpy(valid), M)
    for f, v in _arrays(pose_j).items():
        np.testing.assert_allclose(getattr(pose_t, f).numpy(), v, rtol=1e-6, atol=1e-6,
                                   err_msg=f)

    # undistortion on the JAX pose table (so only undistort differs)
    pose_tj = convert.pose_table_from_arrays(_arrays(pose_j), "cpu")
    N = 4000
    pts = rng.uniform(-20, 20, (N, 3)).astype(np.float32)
    t_rel = np.sort(rng.uniform(-0.01, 0.12, N)).astype(np.float32)
    pmask = rng.random(N) > 0.1
    uj = jimu.undistort(sj, pose_j, jnp.asarray(pts), jnp.asarray(t_rel),
                        jnp.asarray(pmask), cj)
    ut = timu.undistort(st, pose_tj, torch.from_numpy(pts), torch.from_numpy(t_rel),
                        torch.from_numpy(pmask), ct)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ut.numpy()[~pmask], pts[~pmask])


def test_stateful_initializer_and_skipped_pairs():
    """Leading pairs before the segment start alias pose row 0 and a
    group with no valid pair only extrapolates the tail."""
    rng = np.random.default_rng(1)
    cj, ct = _calibs(rng)
    sj = _state(rng)
    st = convert.state_from_arrays(_arrays(sj), "cpu")
    t = np.array([9.90, 9.95, 9.99])
    acc = rng.normal(size=(3, 3))
    gyr = rng.normal(size=(3, 3))
    pp = jimu.prepare_pairs(t, acc, gyr, 10.0, 10.1, 10.0, 8)
    assert not pp[4].any()
    wire = jimu.pack_pairs_wire(*pp)
    z = np.array([0.1, 0.2, 9.7], np.float32)
    out_j = jimu.propagate_wire(sj, jnp.asarray(wire), jnp.asarray(z), jnp.asarray(z), cj)
    out_t = timu.propagate_wire(st, torch.from_numpy(wire), torch.from_numpy(z),
                                torch.from_numpy(z), ct)
    for f in jstate.NavState._fields:
        np.testing.assert_allclose(getattr(out_t[0], f).numpy(),
                                   np.asarray(getattr(out_j[0], f)), rtol=0, atol=1e-10)
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]), rtol=0, atol=1e-10)
    assert tstate.pack24(out_t[0]).dtype == torch.float64
