"""IMU initialization, forward propagation and scan undistortion.

Port of the JAX package's imu.py (the reference's ImuProcess,
src/IMU_Processing.cpp):

  - static initialization (IMU_init, :137-181): host-side numpy;
  - forward state+covariance propagation (UndistortPcl :657-755) over
    padded IMU sample pairs with a validity mask; the 18x18 transition
    F_x and process noise blocks are the reference's (:701-717). On a
    CUDA state one launch of the kernel in csrc/imu_propagate.cu
    (ops/imu_scan.py) runs a whole group, as the JAX package's one
    `lax.scan`; on a CPU state the plain loop `propagate_plain`, which is
    also the kernel's oracle;
  - backward per-point undistortion (:774-808), vectorized: each point
    finds its IMU pose interval by searchsorted and applies the
    closed-form compensation transform. On CUDA points one launch of the
    kernel in csrc/undistort.cu; on the CPU the plain version
    `undistort_plain`, the kernel's oracle, whose sums and products are
    written out in the kernel's order.

Absolute timestamps never reach the device: the host computes per-pair
dt and per-sample offsets (relative to the scan begin) in float64 and
ships small float32 quantities. The state is float64; where a float32
batch meets it, the float64 operand is a tensor of the same rank class,
so torch promotes exactly as JAX does (a 0-d float64 tensor would not).

Deviation from the reference (kept from the JAX package): point offsets
and pose offsets share one origin (the scan begin), and points earlier
than the pose table are extrapolated backward from the first pose.
"""
from __future__ import annotations

import ctypes
import functools
import warnings
from typing import NamedTuple

import numpy as np
import torch

from .ops import imu_scan, linalg, so3
from .ops.photometric import _require
from .state import DIM_STATE, G_M_S2, NavState, pack24

BIG_T = 1e30
# the largest pose table csrc/undistort.cu stages in shared memory (its
# STAGE_M): the merged table of Pipeline.max_scan_poses = 8
# (max_imu_per_group + 1) rows at max_imu_per_group 512; a larger table is
# searched in global memory in the same launch
UNDISTORT_STAGE_M = 4104
MAX_INI_COUNT = 200  # reference: IMU_Processing.h:36


class ImuCalib(NamedTuple):
    """Per-run IMU calibration constants (float32 tensors)."""

    acc_scale: torch.Tensor  # () G / |mean_acc| (IMU_Processing.cpp:685)
    cov_acc: torch.Tensor  # (3,) scaled accel noise
    cov_gyr: torch.Tensor  # (3,) scaled gyro noise
    cov_bias_acc: torch.Tensor  # (3,)
    cov_bias_gyr: torch.Tensor  # (3,)
    lid_rot: torch.Tensor  # (3, 3) R: lidar frame -> IMU frame
    lid_off: torch.Tensor  # (3,) t: lidar origin in IMU frame


class PoseTable(NamedTuple):
    """IMU-rate pose samples for undistortion (Pose6D equivalent,
    common_lib.h:396-411). Row 0 is the segment-start state."""

    offs: torch.Tensor  # (M,) seconds from segment begin; BIG_T if invalid
    rot: torch.Tensor  # (M, 3, 3)
    pos: torch.Tensor  # (M, 3)
    vel: torch.Tensor  # (M, 3)
    acc: torch.Tensor  # (M, 3) world-frame specific acceleration
    gyr: torch.Tensor  # (M, 3) bias-corrected body angular velocity


def _pack_pose(pose: PoseTable, state: NavState) -> torch.Tensor:
    """PoseTable (+ the segment-end state) as one (M+1, 24) f64 array:
    rows 0..M-1 are [offs, rot9, pos3, vel3, acc3, gyr3, 0, 0]; the last
    row is the propagated state's pack24."""
    M = pose.offs.shape[0]
    f = torch.float64
    base = torch.cat(
        [pose.offs[:, None].to(f), pose.rot.reshape(M, 9).to(f),
         pose.pos.to(f), pose.vel.to(f), pose.acc.to(f), pose.gyr.to(f),
         torch.zeros((M, 2), dtype=f, device=pose.offs.device)], dim=1)
    return torch.cat([base, pack24(state)[None, :]], dim=0)


def merge_pose_packs(packs, flat_idx: torch.Tensor, row_valid: torch.Tensor,
                     m_out: int) -> PoseTable:
    """Merge per-group pose packs (from `propagate_packed`) into the
    fixed-size per-scan PoseTable on the device.

    packs: sequence of (Bi+1, 24) f64 packs; the last row of each (the
    segment-end state) is dropped. flat_idx (m_out,) indexes the row
    concatenation of the packs' base rows (the host pads it by repeating
    the last kept index); row_valid (m_out,) marks real rows, padded
    rows get offs = BIG_T. Output fields are f32."""
    base = torch.cat([p[:-1] for p in packs], dim=0)
    rows = base[flat_idx.to(torch.int64)].to(torch.float32)  # (m_out, 24)
    offs = torch.where(row_valid, rows[:, 0],
                       torch.full_like(rows[:, 0], BIG_T))
    return PoseTable(
        offs=offs.contiguous(),
        rot=rows[:, 1:10].reshape(m_out, 3, 3),
        pos=rows[:, 10:13],
        vel=rows[:, 13:16],
        acc=rows[:, 16:19],
        gyr=rows[:, 19:22],
    )


def pose_views(pack: torch.Tensor) -> PoseTable:
    """The PoseTable in rows 0..M-1 of an (M+1, 24) pose pack
    (`_pack_pose`'s layout), its fields f64 views of the pack's columns."""
    base = pack[:-1]
    return PoseTable(offs=base[:, 0], rot=base[:, 1:10].reshape(-1, 3, 3),
                     pos=base[:, 10:13], vel=base[:, 13:16], acc=base[:, 16:19],
                     gyr=base[:, 19:22])


def _wire(acc_avg, gyr_avg, dt, offs, pair_valid, tail_dt, row0_off):
    """`pack_pairs_wire` of `propagate`'s arguments, built on their device
    (no host copy). The kernel reads row0_off as the wire's f32, so a
    Python float must be one exactly."""
    if isinstance(row0_off, torch.Tensor):
        row0 = row0_off.reshape(1)
    elif float(np.float32(row0_off)) == row0_off:
        row0 = torch.full((1,), row0_off, dtype=acc_avg.dtype, device=acc_avg.device)
    else:
        raise ValueError(f"row0_off {row0_off!r} is not a float32 value")
    last = torch.cat([tail_dt.reshape(1), row0, acc_avg.new_zeros(7)])
    return torch.cat([torch.cat([acc_avg, gyr_avg, dt[:, None], offs[:, None],
                                 pair_valid[:, None].to(acc_avg.dtype)], dim=1),
                      last[None]])


def propagate_packed(s, acc_avg, gyr_avg, dt, offs, pair_valid, tail_dt,
                     acc_s_last, angvel_last, calib, row0_off=0.0):
    """`propagate` returning (state, (M+1, 24) pose pack, acc_s_last',
    angvel_last')."""
    if s.pos.device.type == "cpu":
        st, pose, a_last, g_last = propagate_plain(
            s, acc_avg, gyr_avg, dt, offs, pair_valid, tail_dt,
            acc_s_last, angvel_last, calib, row0_off,
        )
        return st, _pack_pose(pose, st), a_last, g_last
    return imu_scan.imu_propagate(
        s, _wire(acc_avg, gyr_avg, dt, offs, pair_valid, tail_dt, row0_off),
        acc_s_last, angvel_last, calib)


def pack_pairs_wire(acc_avg, gyr_avg, dt, offs, valid, tail_dt, row0_off):
    """Host-side: everything `prepare_pairs` returned in ONE (P+1, 9) f32
    array, so a measurement group is one host-to-device copy."""
    P = len(dt)
    w = np.zeros((P + 1, 9), np.float32)
    w[:P, 0:3] = acc_avg
    w[:P, 3:6] = gyr_avg
    w[:P, 6] = dt
    w[:P, 7] = offs
    w[:P, 8] = valid
    w[P, 0] = tail_dt
    w[P, 1] = row0_off
    return w


def propagate_wire(s, wire: torch.Tensor, acc_s_last, angvel_last, calib):
    """`propagate_packed` fed from one `pack_pairs_wire` array: on a CUDA
    state one kernel launch, on a CPU state the plain loop."""
    if s.pos.device.type == "cpu":
        return propagate_wire_plain(s, wire, acc_s_last, angvel_last, calib)
    return imu_scan.imu_propagate(s, wire, acc_s_last, angvel_last, calib)


def propagate_wire_plain(s, wire: torch.Tensor, acc_s_last, angvel_last, calib):
    """`propagate_wire` through the plain loop, on any device."""
    P = wire.shape[0] - 1
    st, pose, a_last, g_last = propagate_plain(
        s, wire[:P, 0:3], wire[:P, 3:6], wire[:P, 6], wire[:P, 7],
        wire[:P, 8] > 0.5, wire[P, 0], acc_s_last, angvel_last, calib,
        row0_off=wire[P, 1],
    )
    return st, _pack_pose(pose, st), a_last, g_last


class ImuInitializer:
    """Host-side static initializer (IMU_init, IMU_Processing.cpp:137-181).

    Accumulates running mean/variance of accel & gyro over the first
    MAX_INI_COUNT samples, then yields gravity, gyro bias and the noise
    covariances (scaled per Process2, :830-835)."""

    def __init__(self):
        self.n = 0
        self.mean_acc = np.array([0.0, 0.0, -1.0])
        self.mean_gyr = np.zeros(3)
        self.cov_acc = np.full(3, 0.1)
        self.cov_gyr = np.full(3, 0.1)

    def push(self, acc: np.ndarray, gyr: np.ndarray) -> None:
        if self.n == 0:
            # b_first_frame_ branch (:144-152): seed the means with the
            # first sample; with N = 1 the reference's first pass scales
            # the 0.1 Reset() covariance seed by (N-1)/N = 0
            self.mean_acc = np.asarray(acc, dtype=np.float64).copy()
            self.mean_gyr = np.asarray(gyr, dtype=np.float64).copy()
            self.cov_acc = np.zeros(3)
            self.cov_gyr = np.zeros(3)
            self.n = 1
            return
        # the reference processes the i-th sample with divisor N = i
        n = self.n + 1
        da = acc - self.mean_acc
        dg = gyr - self.mean_gyr
        self.mean_acc += da / n
        self.mean_gyr += dg / n
        self.cov_acc = self.cov_acc * (n - 1.0) / n + (acc - self.mean_acc) * (
            acc - self.mean_acc
        ) * (n - 1.0) / (n * n)
        self.cov_gyr = self.cov_gyr * (n - 1.0) / n + (gyr - self.mean_gyr) * (
            gyr - self.mean_gyr
        ) * (n - 1.0) / (n * n)
        self.n += 1

    @property
    def done(self) -> bool:
        # init completes after MAX_INI_COUNT samples (laserMapping gate)
        return self.n + 1 > MAX_INI_COUNT

    def gravity(self) -> np.ndarray:
        return -self.mean_acc / np.linalg.norm(self.mean_acc) * G_M_S2

    def calib(self, acc_cov_scale: float, gyr_cov_scale: float,
              lid_rot: np.ndarray, lid_off: np.ndarray, device,
              bias_cov: float = 1e-5, dtype=torch.float32) -> ImuCalib:
        norm = np.linalg.norm(self.mean_acc)
        cov_acc = self.cov_acc * (G_M_S2 / norm) ** 2 * acc_cov_scale
        cov_gyr = self.cov_gyr * gyr_cov_scale

        def t(v):
            return torch.as_tensor(np.array(v, np.float64), dtype=dtype,
                                   device=device)

        return ImuCalib(
            acc_scale=t(G_M_S2 / norm),
            cov_acc=t(cov_acc),
            cov_gyr=t(cov_gyr),
            cov_bias_acc=t(np.full(3, bias_cov)),
            cov_bias_gyr=t(np.full(3, bias_cov)),
            lid_rot=t(lid_rot),
            lid_off=t(lid_off),
        )


def propagate(s: NavState, acc_avg, gyr_avg, dt, offs, pair_valid, tail_dt,
              acc_s_last, angvel_last, calib: ImuCalib, row0_off=0.0):
    """Forward propagation over one measurement group (`propagate_plain`'s
    arguments and results). On a CUDA state the arrays go into one wire on
    the device and through one kernel launch; the PoseTable's fields are
    then f64 views of the kernel's pose pack."""
    args = (s, acc_avg, gyr_avg, dt, offs, pair_valid, tail_dt, acc_s_last, angvel_last,
            calib, row0_off)
    if s.pos.device.type == "cpu":
        return propagate_plain(*args)
    st, pack, a_last, g_last = propagate_packed(*args)
    return st, pose_views(pack), a_last, g_last


def propagate_plain(
    s: NavState,
    acc_avg: torch.Tensor,  # (P, 3) raw pairwise-averaged accelerometer
    gyr_avg: torch.Tensor,  # (P, 3) raw pairwise-averaged gyro
    dt: torch.Tensor,  # (P,) seconds (host-computed in f64)
    offs: torch.Tensor,  # (P,) tail offset from segment begin; BIG_T pad
    pair_valid: torch.Tensor,  # (P,) bool
    tail_dt: torch.Tensor,  # () signed seconds: segment end - last imu
    acc_s_last: torch.Tensor,  # (3,) world acc at segment start
    angvel_last: torch.Tensor,  # (3,) body gyro at segment start
    calib: ImuCalib,
    row0_off=0.0,  # segment-start offset from scan begin
):
    """Forward propagation over one measurement group, as a plain loop
    (one eager iteration per pair, ~150 small kernels on a card): the CPU
    path and, on any device, the kernel's oracle.

    Returns (state at segment end, PoseTable of P+1 rows, acc_s_last',
    angvel_last'). Mirrors IMU_Processing.cpp:657-755 (state/cov
    recursion) including the signed tail extrapolation to the segment
    end time (:739-755). Invalid pairs carry the state unchanged."""
    dtype = s.pos.dtype
    dev = s.pos.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    zero3 = torch.zeros(3, dtype=dtype, device=dev)
    rot, pos, vel, cov = s.rot, s.pos, s.vel, s.cov
    rots, poss, vels, accs, gyrs = [], [], [], [], []
    for i in range(acc_avg.shape[0]):
        a_raw, w_raw, dti, valid = acc_avg[i], gyr_avg[i], dt[i], pair_valid[i]
        w = w_raw - s.bg
        a = a_raw * calib.acc_scale - s.ba

        exp_f = so3.exp(w * dti)
        a_skew = so3.skew(a)

        # F_x blocks (IMU_Processing.cpp:704-710)
        F = torch.eye(DIM_STATE, dtype=dtype, device=dev)
        F[0:3, 0:3] = so3.exp(-w * dti)
        F[0:3, 9:12] = -eye3 * dti
        F[3:6, 6:9] = eye3 * dti
        F[6:9, 0:3] = -(rot @ a_skew) * dti
        F[6:9, 12:15] = -rot * dti
        F[6:9, 15:18] = eye3 * dti

        Q = torch.zeros((DIM_STATE, DIM_STATE), dtype=dtype, device=dev)
        dt2 = dti * dti
        Q[0:3, 0:3] = torch.diag(calib.cov_gyr) * dt2
        Q[6:9, 6:9] = (rot * calib.cov_acc[None, :]) @ rot.T * dt2
        Q[9:12, 9:12] = torch.diag(calib.cov_bias_gyr) * dt2
        Q[12:15, 12:15] = torch.diag(calib.cov_bias_acc) * dt2

        cov_n = F @ cov @ F.T + Q
        rot_n = rot @ exp_f
        acc_w = rot_n @ a + s.grav
        pos_n = pos + vel * dti + 0.5 * acc_w * dt2
        vel_n = vel + acc_w * dti

        rot = torch.where(valid, rot_n, rot)
        pos = torch.where(valid, pos_n, pos)
        vel = torch.where(valid, vel_n, vel)
        cov = torch.where(valid, cov_n, cov)
        rots.append(rot)
        poss.append(pos)
        vels.append(vel)
        accs.append(torch.where(valid, acc_w, zero3))
        gyrs.append(torch.where(valid, w, zero3))

    # rows for invalid pairs repeat the carried state; the host set their
    # offsets (row0_off for leading skipped pairs, BIG_T for padding).
    # Their acc/gyr alias the segment-start values.
    acc0 = acc_s_last.to(dtype)
    gyr0 = angvel_last.to(dtype)
    accs = torch.where(pair_valid[:, None], torch.stack(accs), acc0[None])
    gyrs = torch.where(pair_valid[:, None], torch.stack(gyrs), gyr0[None])
    row0 = torch.as_tensor(row0_off, dtype=dtype, device=dev).reshape(1)
    pose = PoseTable(
        offs=torch.cat([row0, offs.to(dtype)]),
        rot=torch.cat([s.rot[None], torch.stack(rots)]),
        pos=torch.cat([s.pos[None], torch.stack(poss)]),
        vel=torch.cat([s.vel[None], torch.stack(vels)]),
        acc=torch.cat([acc0[None], accs]),
        gyr=torch.cat([gyr0[None], gyrs]),
    )

    # carry forward the world acc / body gyro at the last valid pair
    any_valid = torch.any(pair_valid)
    idxs = torch.arange(pair_valid.shape[0], device=dev)
    last_idx = torch.clamp(
        torch.max(torch.where(pair_valid, idxs, torch.full_like(idxs, -1))),
        min=0)
    acc_last = torch.where(any_valid, accs[last_idx], acc0)
    gyr_last = torch.where(any_valid, gyrs[last_idx], gyr0)

    # signed tail extrapolation to the exact segment end time (:739-755)
    sdt = tail_dt.to(dtype)
    adt = torch.abs(sdt)
    rot_e = rot @ so3.exp(gyr_last * sdt)
    pos_e = pos + vel * sdt + 0.5 * acc_last * sdt * adt
    vel_e = vel + acc_last * sdt

    out_state = NavState(rot_e, pos_e, vel_e, s.bg, s.ba, s.grav, cov)
    return out_state, pose, acc_last, gyr_last


def _exp32(phi: torch.Tensor) -> torch.Tensor:
    """so3.exp for (N, 3) f32 rotation vectors with every 3-term sum and
    3x3 product written out in csrc/undistort.cu's order: t^2 = (x^2 +
    y^2) + z^2 and I + a K + b (K K), with so3.exp's Taylor branch."""
    t2 = (phi[:, 0] * phi[:, 0] + phi[:, 1] * phi[:, 1]) + phi[:, 2] * phi[:, 2]
    t = torch.sqrt(torch.clamp(t2, min=so3._SMALL ** 2))
    small = t2 < (so3._SMALL * 10.0) ** 2
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / (t * t))
    k = so3.skew(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return (eye + a[:, None, None] * k) + b[:, None, None] * linalg.mat3(k, k)


def undistort_plain(s_end: NavState, pose: PoseTable, pts: torch.Tensor,
                    t_rel: torch.Tensor, pmask: torch.Tensor,
                    calib: ImuCalib) -> torch.Tensor:
    """`undistort` in torch ops, on any device, every sum and product in
    the kernel's order (the CPU's path and the kernel's oracle).

    Vectorized backward pass (IMU_Processing.cpp:774-808):
      P' = (R_li^T R_e^T) (R_i (R_li P + t_li) + T_ei) - R_li^T t_li
    with R_i, T_ei extrapolated from the pose row whose offset precedes
    the point's timestamp."""
    dtype = pts.dtype
    offs = pose.offs.to(dtype).contiguous()
    k = torch.searchsorted(offs, t_rel.contiguous(), right=False) - 1
    k = torch.clamp(k, 0, offs.shape[0] - 1)
    dt = (t_rel - offs[k])[:, None]  # (N, 1)

    # HEAD-row convention: the reference extrapolates interval k with the
    # HEAD row's acc/gyr (IMU_Processing.cpp:779-784), which row k stores
    # as the PREVIOUS pair's averages; reproduced deliberately. Do not
    # "fix" to pose.gyr[k+1].
    R_head = pose.rot[k].to(dtype)  # (N, 3, 3)
    R_i = linalg.mat3(R_head, _exp32(pose.gyr[k].to(dtype) * dt))
    T_ei = (
        pose.pos[k].to(dtype)
        + pose.vel[k].to(dtype) * dt
        + 0.5 * pose.acc[k].to(dtype) * dt * dt
        - s_end.pos.to(dtype)
    )

    p_imu = linalg.matvec3(calib.lid_rot, pts) + calib.lid_off
    p_world_rel = linalg.matvec3(R_i, p_imu) + T_ei
    ext = linalg.mat3(calib.lid_rot.T, s_end.rot.to(dtype).T)
    p_out = (linalg.matvec3(ext, p_world_rel)
             - linalg.matvec3(calib.lid_rot.T, calib.lid_off))
    return torch.where(pmask[:, None], p_out, pts)


def _pose_rows(t: torch.Tensor, dtype, inner: tuple):
    """(tensor, row stride) of a pose field whose rows the kernel reads:
    each row's values contiguous, rows any stride apart (the f64 views of
    a pose pack, the f32 views of a merged table) or copied if not."""
    t = t.to(dtype)
    if t.shape[1:] != inner:
        raise ValueError(f"undistort: pose field of shape {tuple(t.shape)}")
    want = [1] * len(inner)
    for j in range(len(inner) - 2, -1, -1):
        want[j] = want[j + 1] * inner[j + 1]
    if list(t.stride()[1:]) != want or t.stride(0) < 0:
        t = t.contiguous()
    return t, t.stride(0)


@functools.cache
def _undistort_launcher():
    from .ops import _build

    fn = _build.load("undistort").undistort_launch
    P = ctypes.c_void_p
    fn.argtypes = [P, P, ctypes.c_int, ctypes.c_int] + [P] * 8 + [ctypes.c_int, P]
    fn.restype = ctypes.c_int
    return _build.profiled("undistort", fn)


def undistort(s_end: NavState, pose: PoseTable, pts: torch.Tensor,
              t_rel: torch.Tensor, pmask: torch.Tensor,
              calib: ImuCalib) -> torch.Tensor:
    """Motion-compensate points (N, 3) to the segment-end lidar frame
    (`undistort_plain`'s arguments and result). CUDA points take one
    launch of csrc/undistort.cu on the current stream (counted in
    `undistort.launches`), with no host read: the pose table's fields as
    they lie (f32 or f64, rows any stride apart; up to UNDISTORT_STAGE_M
    rows staged in shared memory, a larger table searched in place), the
    state f64, the rest f32; CPU points run `undistort_plain`. No other
    device is taken and nothing falls back."""
    dev = pts.device
    if dev.type == "cpu":
        return undistort_plain(s_end, pose, pts, t_rel, pmask, calib)
    if dev.type != "cuda":
        raise ValueError(f"undistort: unsupported device {dev}")
    N, M = pts.shape[0], pose.offs.shape[0]
    f64 = torch.float64
    for name, t, shape, dtype in (("pts", pts, (N, 3), torch.float32),
                                  ("t_rel", t_rel, (N,), torch.float32),
                                  ("pmask", pmask, (N,), torch.bool),
                                  ("lid_rot", calib.lid_rot, (3, 3), torch.float32),
                                  ("lid_off", calib.lid_off, (3,), torch.float32),
                                  ("state rot", s_end.rot, (3, 3), f64),
                                  ("state pos", s_end.pos, (3,), f64)):
        _require(f"undistort: {name}", t, shape, dtype, dev)
    fields = (pose.offs, pose.rot, pose.pos, pose.vel, pose.acc, pose.gyr)
    pdt = torch.float32 if all(f.dtype == torch.float32 for f in fields) else f64
    rows = [_pose_rows(f, pdt, inner) for f, inner in zip(
        fields, ((), (3, 3), (3,), (3,), (3,), (3,)))]
    for f, _ in rows:
        if f.device != dev or f.shape[0] != M:
            raise ValueError(f"undistort: pose field of {f.shape[0]} rows on {f.device}, "
                             f"want {M} on {dev}")
    out = torch.empty_like(pts)
    if N == 0:
        return out
    if not 0 < M < 1 << 31:
        raise ValueError(f"undistort: a pose table of {M} rows (1 .. 2^31 - 1, the kernel's "
                         "int row index)")
    ptrs = (ctypes.c_void_p * 6)(*[f.data_ptr() for f, _ in rows])
    strides = (ctypes.c_longlong * 6)(*[s for _, s in rows])
    err = _undistort_launcher()(
        ptrs, strides, M, int(pdt == f64), s_end.rot.data_ptr(), s_end.pos.data_ptr(),
        calib.lid_rot.data_ptr(), calib.lid_off.data_ptr(), pts.data_ptr(), t_rel.data_ptr(),
        pmask.data_ptr(), out.data_ptr(), N, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"undistort: kernel launch failed (cudaError {err})")
    undistort.launches += 1
    return out


undistort.launches = 0


def prepare_pairs(imu_t: np.ndarray, imu_acc: np.ndarray, imu_gyr: np.ndarray,
                  beg_time: float, end_time: float, last_end_time: float,
                  max_pairs: int):
    """Host-side (float64) preparation of the scan inputs for `propagate`.

    imu_* include the previous group's last sample prepended (the
    reference's v_imu.push_front(last_imu_), IMU_Processing.cpp:618).
    Returns f32 numpy arrays padded to `max_pairs`."""
    imu_t = np.asarray(imu_t, dtype=np.float64)
    P = max_pairs
    n = max(len(imu_t) - 1, 0)
    if n > P:
        # only in anomalies (a lidar stall stretched the segment):
        # subsample the sample grid, endpoints kept, so integration
        # proceeds at reduced IMU rate across the stall
        k = -(-n // (P - 1))  # ceil; P-1 leaves room for the forced end
        keep = np.arange(0, len(imu_t), k)
        if keep[-1] != len(imu_t) - 1:
            keep = np.append(keep, len(imu_t) - 1)
        warnings.warn(
            f"IMU group of {n} pairs exceeds capacity {P} (sensor "
            f"stall?); merging every {k} intervals to fit. Raise "
            "capacity.max_imu_per_group to integrate at full rate.",
            RuntimeWarning,
        )
        imu_t = imu_t[keep]
        imu_acc = np.asarray(imu_acc)[keep]
        imu_gyr = np.asarray(imu_gyr)[keep]
        n = len(imu_t) - 1
    acc_avg = np.zeros((P, 3), np.float32)
    gyr_avg = np.zeros((P, 3), np.float32)
    dt = np.zeros(P, np.float32)
    offs = np.full(P, BIG_T, np.float32)
    valid = np.zeros(P, bool)
    row0_off = np.float32(last_end_time - beg_time)
    for i in range(n):
        th, tt = imu_t[i], imu_t[i + 1]
        if tt < last_end_time:
            offs[i] = row0_off  # leading skipped pair: aliases pose row 0
            continue
        acc_avg[i] = 0.5 * (imu_acc[i] + imu_acc[i + 1])
        gyr_avg[i] = 0.5 * (imu_gyr[i] + imu_gyr[i + 1])
        dt[i] = (tt - last_end_time) if th < last_end_time else (tt - th)
        offs[i] = tt - beg_time
        valid[i] = True
    imu_end = imu_t[-1] if len(imu_t) else last_end_time
    # signed tail dt (reference :740-747), from the time the propagated
    # state has reached to the segment end time
    origin = max(imu_end, last_end_time)
    tail_dt = np.float32(end_time - origin)
    return acc_avg, gyr_avg, dt, offs, valid, tail_dt, row0_off
