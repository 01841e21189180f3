"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout
(one nvcc per source, all started together), holds each against its
plain PyTorch version on the card, and drives two paths through
`Pipeline` on `Config()`'s shipped capacities with 24000-point scans:
the LiDAR-inertial path (LIO, camera off) and the LiDAR-inertial-visual
path (LIVO, a 640x512 camera). Each path's trajectory is checked
against the synthetic ground truth, and the port on the card against
the port on the CPU on a small input. Both paths are profiled.

Prints the card and its power limit, the build time, each kernel's
time beside its bound, each path's time per frame, a `{"kernels": ...}`
line, the `nvidia-smi` name and power limit, and as its last line
`{"ok": true, "device": {...}}`. Any failure raises: the exit code is
then not 0 and no result line is printed. Without CUDA, or without the
package beside it, it fails the same way.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32, outside the tensor cores
CUDA_SOURCES = ["knn5_plane", "patches_and_grads"]  # every csrc/*.cu of the port
# camera of the LIVO paths: z forward = body +x, x right = body -y,
# y down = body -z (looks at the synthetic room's walls)
RCL = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def build_all() -> float:
    """One nvcc per source, all started together."""
    from fastlivo_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(CUDA_SOURCES)) as ex:
        for path in ex.map(_build.build, CUDA_SOURCES):
            print(f"built {path.name}")
    return time.perf_counter() - t0


def time_ms(fn, reps: int = 30) -> float:
    """Median device time of one call over `reps` calls. The stream is
    first held by a spin kernel, so the host queues a batch of calls,
    each between two CUDA events, before the device runs them: the
    intervals then hold device time only, not the host's launch latency.
    A batch counts only if the device was still spinning when its last
    call was queued; otherwise the batch halves (a call of many small
    kernels fills the driver's launch queue), and at one call the spin
    doubles."""
    t0 = time.perf_counter()
    for _ in range(3):  # warm-up; also the host's enqueue time per call
        fn()
    host_s = (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    batch, slack, times = reps, 2.0, []
    for _ in range(60):
        if len(times) >= reps:
            return float(np.median(times))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(batch + 1)]
        spin_s = slack * batch * host_s + 0.01
        torch.cuda._sleep(int(2e9 * spin_s))  # cycles; clocks are <= 2 GHz
        ev[0].record()
        for i in range(batch):
            fn()
            ev[i + 1].record()
        held = not ev[0].query()
        torch.cuda.synchronize()
        if held:
            times += [ev[i].elapsed_time(ev[i + 1]) for i in range(batch)]
        elif batch > 1:
            batch //= 2
        elif slack < 64:
            slack *= 2
        else:
            break
    raise AssertionError("could not queue the timed calls ahead of the device")


def random_block(n, m=27, seed=0, drop=0.3):
    """Candidate blocks around each query, most candidates flattened onto
    a local plane; some rows without neighbours and with distance ties."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    cand = (q[:, None, :] + rng.normal(0, 0.8, (n, m, 3))).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    d = -np.sum(nrm * q, axis=1)
    off = np.sum(cand * nrm[:, None, :], axis=-1) + d[:, None]
    cand -= (off * (rng.random((n, m)) < 0.8))[:, :, None] * nrm[:, None, :]
    found = rng.random((n, m)) > drop
    found[:5] = False
    cand[10:20, 1] = cand[10:20, 0]
    return cand, found, q


def knn5_contract(got, want, min_both):
    """The kernel contract (tests/test_torch_knn_plane.py): nd2 rtol 1e-5;
    planes rtol 5e-3 / atol 5e-4 up to sign where both gates pass; gate
    mismatches under 1%. Returns the max abs error of the compared
    values."""
    from fastlivo_tpu_torch.lio import SQ_DIST_GATE
    from fastlivo_tpu_torch.ops.knn_plane import BIG

    pab_a, ok_a, nd2_a = (t.cpu().numpy() for t in got)
    pab_b, ok_b, nd2_b = (t.cpu().numpy() for t in want)
    np.testing.assert_allclose(nd2_a, nd2_b, rtol=1e-5, atol=1e-6)
    sel = nd2_b <= SQ_DIST_GATE
    flip = np.sign(np.sum(pab_a[:, :3] * pab_b[:, :3], axis=1))[:, None]
    both = sel & ok_a & ok_b
    if both.sum() < min_both:
        raise AssertionError(f"only {both.sum()} fitted planes to compare")
    np.testing.assert_allclose(pab_a[both], (pab_b * flip)[both],
                               rtol=5e-3, atol=5e-4)
    mism = sel & (ok_a != ok_b)
    if mism.mean() >= 0.01:
        raise AssertionError(f"{mism.sum()} gate mismatches")
    live = nd2_b < BIG * 0.5
    return float(max(np.abs(nd2_a - nd2_b)[live].max(),
                     np.abs(pab_a - pab_b * flip)[both].max()))


def knn5_bound_ms(n: int, m: int):
    """Least time for the kernel's work at (n, m): bytes read once and
    written once over HBM bandwidth vs its float32 operations over the
    float32 rate; returns (ms, "bytes" | "operations")."""
    nbytes = n * (m * 12 + m + 12 + 16 + 1 + 4)
    # per query: 8 ops per candidate distance, 5 compare rounds, ~200 for
    # the fit and the gates
    ops = n * (8 * m + 5 * m + 200)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def patches_inputs(dev, K=192, H=512, W=640, seed=0):
    """A textured 512x640 image and K centres (a quarter of them within
    2*16 px of a border, so the tap clamps run) with scales 1..16."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = (100 + 50 * np.sin(0.21 * xx) * np.cos(0.17 * yy)
           + 20 * np.sin(0.05 * xx * yy / 7) + rng.normal(0, 5, (H, W)))
    pc = np.stack([rng.uniform(0, W - 1, K), rng.uniform(0, H - 1, K)], 1)
    q = K // 4
    pc[:q, 0] = rng.uniform(0, 32, q)
    pc[q:2 * q, 1] = rng.uniform(H - 33, H - 1, q)
    scale = rng.choice([1, 2, 4, 8, 16], K)
    return (torch.from_numpy(img.astype(np.float32)).to(dev),
            torch.from_numpy(pc.astype(np.float32)).to(dev),
            torch.from_numpy(scale.astype(np.int32)).to(dev))


def patches_bound_ms(K: int, P: int):
    """Least time for patches_and_grads at (K, P): per point the (P+3)^2
    f32 taps, its centre and scale read once and 3 P*P f32 outputs
    written once, over HBM bandwidth; its ~30 float32 operations per
    output pixel over the float32 rate. Returns (ms, "bytes" |
    "operations")."""
    nbytes = K * ((P + 3) ** 2 * 4 + 12 + 3 * P * P * 4)
    ops = K * P * P * 30
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def patches_phase(dev):
    """patches_and_grads against its plain version at the photometric
    path's shape (K = 192 grid cells of a 640x512 image, P = 8) and at
    P = 4; tolerance 1e-4 (expected 0: both round every product). Times
    the kernel and the plain version at P = 8. These launches are not
    the path's."""
    from fastlivo_tpu_torch.ops import image, patches_grads

    err = 0.0
    for P in (8, 4):
        img, pc, scale = patches_inputs(dev, seed=P)
        got = patches_grads.patches_and_grads(img, pc, P, scale)
        torch.cuda.synchronize()
        want = image.patches_and_grads(img, pc, P, scale)
        e = max(float((g - w).abs().max()) for g, w in zip(got, want))
        print(f"patches_and_grads K=192 P={P} scales 1..16: max_abs_err={e:.3g}")
        if not e <= 1e-4:
            raise AssertionError(f"patches_and_grads P={P} differs by {e}")
        err = max(err, e)
    img, pc, scale = patches_inputs(dev, seed=8)
    ms = time_ms(lambda: patches_grads.patches_and_grads(img, pc, 8, scale))
    plain_ms = time_ms(lambda: image.patches_and_grads(img, pc, 8, scale))
    bound_ms, bound_by = patches_bound_ms(192, 8)
    print(f"patches_and_grads K=192 P=8: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.5f} ms ({bound_by}), library none; {nvidia_smi_line()}")
    return err, ms, plain_ms, bound_ms, bound_by


def kernel_phase(dev, n=16384, m=27):
    """knn5_plane against knn5_plane_plain on a seeded block at the main
    path's shape. These launches are not the path's."""
    from fastlivo_tpu_torch.ops import knn_plane

    cand, found, q = (torch.from_numpy(a).to(dev) for a in random_block(n, m))
    got = knn_plane.knn5_plane(cand, found, q)
    torch.cuda.synchronize()
    want = knn_plane.knn5_plane_plain(cand, found, q)
    err = knn5_contract(got, want, min_both=n // 4)
    print(f"knn5_plane random block N={n} M={m}: contract ok, max_abs_err={err:.3g}")
    return err


def path_phase(dev, duration=6.0, points_per_scan=24000):
    """Pipeline(Config()) at its shipped capacities on `dev`; the kernel's
    launch count is read around this run only."""
    from fastlivo_tpu_torch.config import Config
    from fastlivo_tpu_torch.io.synthetic import SyntheticDataset
    from fastlivo_tpu_torch.ops import knn_plane
    from fastlivo_tpu_torch.pipeline import Pipeline

    cfg = Config()
    cfg.img_enable = False
    cap = cfg.capacity
    print(f"config: tiled map {cap.tiled_dir_dims} x {cap.tiled_pool} tiles, "
          f"max_points {cap.max_points}, max_raw_points {cap.max_raw_points}, "
          f"max_iteration {cfg.max_iteration}, knn_voxel_radius {cap.knn_voxel_radius}")
    ds = SyntheticDataset(duration=duration, points_per_scan=points_per_scan,
                          lidar_noise=0.004, seed=0)
    scans = ds.lidar_scans_fast()
    imu = ds.imu_stream()
    pipe = Pipeline(cfg, device=dev)
    for beg, pts, t_rel in scans:
        pipe.push_lidar(beg, pts, t_rel)
    for t, acc, gyr in imu:
        pipe.push_imu(t, acc, gyr)
    torch.cuda.synchronize()
    knn_plane.knn5_plane.launches = 0
    t0 = time.perf_counter()
    outs = pipe.spin()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = knn_plane.knn5_plane.launches

    steady = [o for o in outs if o.iters > 0]
    pos = np.array([o.pos for o in outs])
    base = ds.traj.base_pos
    errs = [np.linalg.norm(o.pos - (ds.traj.pose(o.t)[1] - base))
            for o in outs if o.t >= ds.traj.t_static + 0.5]
    ate = float(np.sqrt(np.mean(np.square(errs))))
    frame_ms = [1e3 * o.timing["total"] for o in steady]
    print(f"path: {len(outs)} frames ({len(steady)} steady) in {wall:.2f} s, "
          f"knn5_plane launches {launches}, ATE {ate * 1e3:.3f} mm, "
          f"median steady frame {np.median(frame_ms):.2f} ms "
          f"(p90 {np.percentile(frame_ms, 90):.2f} ms), "
          f"n_active median {int(np.median([o.n_active for o in steady]))}; "
          f"{nvidia_smi_line()}")
    if len(outs) < 40 or len(steady) < 30:
        raise AssertionError(f"too few frames: {len(outs)} ({len(steady)} steady)")
    if launches < len(steady):
        raise AssertionError(f"knn5_plane launched {launches}x for {len(steady)} frames")
    if not (np.isfinite(pos).all() and torch.isfinite(pipe.state.cov).all()):
        raise AssertionError("non-finite state")
    if not ate < 0.02:
        raise AssertionError(f"ATE {ate:.4f} m >= 2 cm")
    return pipe, steady, launches


def livo_config(cfg=None, W=640, H=512, F=400.0):
    """`Config()` (or `cfg`) with a W x H pinhole camera looking at the
    walls, and tests/test_pipeline_livo.py's photometric gates."""
    from fastlivo_tpu_torch.config import CameraConfig, Config

    cfg = cfg or Config()
    cfg.img_enable = True
    cfg.camera = CameraConfig(width=W, height=H, fx=F, fy=F, cx=(W - 1) / 2.0,
                              cy=(H - 1) / 2.0, d=[0.0, 0.0, 0.0, 0.0])
    cfg.Rcl = RCL.ravel().tolist()
    cfg.Pcl = [0.0, 0.0, 0.0]
    cfg.outlier_threshold = 300.0
    cfg.img_point_cov = 100.0
    return cfg


def livo_dataset(cfg, **kw):
    from fastlivo_tpu_torch.io.synthetic import SyntheticDataset

    cam = cfg.camera
    return SyntheticDataset(cam_hz=10.0, cam_size=(cam.width, cam.height),
                            cam_f=cam.fx, cam_c=(cam.cx, cam.cy), Rcl=RCL, **kw)


def push_all(pipe, ds, t_max=None, t_min=None):
    """Push the dataset's scans, IMU samples and images with
    t_min <= t < t_max."""
    inside = lambda t: (t_min is None or t >= t_min) and (t_max is None or t < t_max)  # noqa: E731
    for beg, pts, t_rel in ds.lidar_scans_fast():
        if inside(beg):
            pipe.push_lidar(beg, pts, t_rel)
    for t, acc, gyr in ds.imu_stream():
        if inside(t):
            pipe.push_imu(t, acc, gyr)
    for t, img in ds.images():
        if inside(t):
            pipe.push_img(t, img)


def livo_path_phase(dev, duration=6.0, points_per_scan=24000):
    """Pipeline(Config()) with the camera on, at its shipped capacities
    (visual map 65536 points x 20 observations, 2^18 hash slots, a u8
    pool of 256 images of 640x512). Both kernels' launch counts are read
    around this run only. Camera-frame time: host wall of Vio.update,
    its stats read included."""
    from fastlivo_tpu_torch.ops import knn_plane, patches_grads
    from fastlivo_tpu_torch.pipeline import Pipeline

    cfg = livo_config()
    cap = cfg.capacity
    print(f"livo config: camera {cfg.camera.width}x{cfg.camera.height} f={cfg.camera.fx}, "
          f"grid {cfg.grid_size}, patch {cfg.patch_size}, max_iteration {cfg.max_iteration}, "
          f"visual map {cap.vmap_points} pts x {cap.vmap_obs} obs, {cap.vmap_table_size} "
          f"slots x {cap.vmap_voxel_cap}, pool {cap.frame_ring} x u8={cap.frame_ring_u8}")
    ds = livo_dataset(cfg, duration=duration, points_per_scan=points_per_scan,
                      lidar_noise=0.004, seed=0)
    pipe = Pipeline(cfg, device=dev)
    push_all(pipe, ds)
    vio = pipe.vio
    cam_ms = []
    update = vio.update

    def timed_update(*a):
        steps = vio.steps
        t0 = time.perf_counter()
        out = update(*a)
        if vio.steps > steps:
            cam_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    vio.update = timed_update
    torch.cuda.synchronize()
    knn_plane.knn5_plane.launches = 0
    patches_grads.patches_and_grads.launches = 0
    t0 = time.perf_counter()
    outs = pipe.spin()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"knn5_plane": knn_plane.knn5_plane.launches,
                "patches_and_grads": patches_grads.patches_and_grads.launches}
    vio.update = update

    steady = [o for o in outs if o.iters > 0]
    pos = np.array([o.pos for o in outs])
    base = ds.traj.base_pos
    errs = [np.linalg.norm(o.pos - (ds.traj.pose(o.t)[1] - base))
            for o in outs if o.t >= ds.traj.t_static + 0.5]
    ate = float(np.sqrt(np.mean(np.square(errs))))
    lid_ms = [1e3 * o.timing["total"] for o in steady]
    n_pts = int(vio.vmap.n_pts)
    print(f"livo path: {len(outs)} lidar frames ({len(steady)} steady), {vio.fid} camera "
          f"frames ({vio.steps} ran the frame step) in {wall:.2f} s; launches {launches}; "
          f"ATE {ate * 1e3:.3f} mm; visual map {n_pts} points, last {vio.last_stats}")
    print(f"livo path: camera frame median {np.median(cam_ms):.2f} ms (p90 "
          f"{np.percentile(cam_ms, 90):.2f} ms) over {len(cam_ms)}; lidar frame median "
          f"{np.median(lid_ms):.2f} ms (p90 {np.percentile(lid_ms, 90):.2f} ms) over "
          f"{len(lid_ms)}; {nvidia_smi_line()}")
    if len(steady) < 30 or vio.steps < 30:
        raise AssertionError(f"too few frames: {len(steady)} steady, {vio.steps} camera")
    if n_pts <= 50 or vio.last_stats.get("tracked", 0) <= 5:
        raise AssertionError(f"visual map {n_pts} points, last {vio.last_stats}")
    if launches["patches_and_grads"] < 3 * vio.steps or launches["knn5_plane"] < len(steady):
        raise AssertionError(f"launches {launches} for {vio.steps} camera and "
                             f"{len(steady)} lidar frames")
    if not (np.isfinite(pos).all() and torch.isfinite(pipe.state.cov).all()):
        raise AssertionError("non-finite state")
    if not ate < 0.06:
        raise AssertionError(f"LIVO ATE {ate:.4f} m >= 6 cm")
    return launches


def livo_cpu_agreement(dev):
    """A small LIVO input (320x256 camera, 4096-point scans) through the
    port on the card and on the CPU: every lidar frame within 2 mm."""
    from fastlivo_tpu_torch.config import CapacityConfig, Config
    from fastlivo_tpu_torch.pipeline import Pipeline

    res = []
    for d in (dev, "cpu"):
        cfg = Config()
        cfg.grid_size = 32
        cfg.capacity = CapacityConfig(max_points=4096, max_raw_points=8192,
                                      tiled_dir_dims=(32, 32, 16), tiled_pool=1024,
                                      vmap_points=8192, vmap_table_size=1 << 15,
                                      frame_ring=16, max_cands=4096)
        cfg = livo_config(cfg, W=320, H=256, F=200.0)
        ds = livo_dataset(cfg, duration=4.0, points_per_scan=4096, lidar_noise=0.004, seed=5)
        pipe = Pipeline(cfg, device=d)
        push_all(pipe, ds)
        res.append((pipe.spin(), pipe.vio))
    (a, va), (b, vb) = res
    if len(a) != len(b) or len(a) < 25 or va.steps != vb.steps:
        raise AssertionError(f"frames {len(a)}/{va.steps} on {dev} vs {len(b)}/{vb.steps} on cpu")
    dmax = max(np.linalg.norm(x.pos - y.pos) for x, y in zip(a, b))
    print(f"small LIVO input, {dev} vs cpu: {len(a)} lidar frames, {va.steps} camera "
          f"steps, max position difference {dmax * 1e3:.4f} mm, visual map "
          f"{int(va.vmap.n_pts)} vs {int(vb.vmap.n_pts)} points")
    if not dmax < 2e-3:
        raise AssertionError(f"{dev} and cpu differ by {dmax:.2e} m")


def real_block(pipe, n):
    """The search leg's input at the path's shape: the final map's
    candidate block for the last scan's points at the posterior."""
    from fastlivo_tpu_torch.ops import tiled_map as tm

    down, _active = pipe.last_effect
    rot = pipe.state.rot.to(torch.float32)
    pw = (down @ pipe.calib.lid_rot.T + pipe.calib.lid_off) @ rot.T \
        + pipe.state.pos.to(torch.float32)
    if pw.shape[0] != n:
        raise AssertionError(f"EKF batch {pw.shape[0]} != {n}")
    cand, found = tm.knn_candidates(pipe.map, pw.contiguous(),
                                    pipe.cfg.capacity.knn_voxel_radius)
    return cand.contiguous(), found.contiguous(), pw.contiguous()


def profile_phase(dev, n_warm=30, duration=4.5, points_per_scan=24000):
    """Where a steady frame's time goes: torch.profiler over the frames
    after the first `n_warm` scans of a second shipped-capacity run.
    Prints the device busy share of the window and the device time and
    launch count per frame of the largest kernel names."""
    from torch.profiler import ProfilerActivity, profile

    from fastlivo_tpu_torch.config import Config
    from fastlivo_tpu_torch.io.synthetic import SyntheticDataset
    from fastlivo_tpu_torch.pipeline import Pipeline

    cfg = Config()
    cfg.img_enable = False
    ds = SyntheticDataset(duration=duration, points_per_scan=points_per_scan,
                          lidar_noise=0.004, seed=1)
    scans = ds.lidar_scans_fast()
    pipe = Pipeline(cfg, device=dev)
    for t, acc, gyr in ds.imu_stream():
        pipe.push_imu(t, acc, gyr)
    for beg, pts, t_rel in scans[:n_warm]:
        pipe.push_lidar(beg, pts, t_rel)
    pipe.spin()
    for beg, pts, t_rel in scans[n_warm:]:
        pipe.push_lidar(beg, pts, t_rel)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        outs = pipe.spin()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = len(outs)
    if n == 0 or not all(o.iters > 0 for o in outs):
        raise AssertionError("profiled window holds no steady frames")
    evs = prof.key_averages()
    stage = ("frame.", "lio.")  # the named ranges of frame_step/lio/pipeline
    # device kernels only: the ranges also appear as device-side spans
    kernels = [e for e in evs if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0 and not e.key.startswith(stage)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(f"profile: {n} steady frames, {1e3 * wall / n:.2f} ms/frame wall "
          f"(profiler on), device busy {busy_ms / n:.3f} ms/frame = "
          f"{100 * busy_ms / (1e3 * wall):.1f}% of wall, "
          f"{launches / n:.0f} device kernels/frame")
    if not kernels:
        print("profile: the profiler saw no device time")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3 / n:8.4f} ms/frame "
              f"{e.count / n:7.1f} launches/frame  {e.key[:80]}")
    # host time and device time under each named stage range
    for e in sorted((e for e in evs if e.key.startswith(stage)
                     and str(e.device_type).endswith("CPU")),
                    key=lambda e: -e.cpu_time_total):
        print(f"  stage {e.key:20s} host {e.cpu_time_total / 1e3 / n:8.3f} ms/frame, "
              f"device {e.device_time_total / 1e3 / n:8.3f} ms/frame, "
              f"{e.count / n:.1f} calls/frame")


def kernels_under(e) -> int:
    """Device kernels launched inside a profiler event and its children."""
    return len(getattr(e, "kernels", [])) + sum(kernels_under(c) for c in e.cpu_children)


def livo_profile_phase(dev, t_warm=3.0, duration=4.5, points_per_scan=24000):
    """Where a camera frame's time goes: torch.profiler over the LIVO
    frames after `t_warm` s of a second shipped-capacity LIVO run. Prints
    each `vio.*` stage's host and device ms per camera frame and the
    device kernels launched per camera frame."""
    from torch.profiler import ProfilerActivity, profile

    from fastlivo_tpu_torch.pipeline import Pipeline

    cfg = livo_config()
    ds = livo_dataset(cfg, duration=duration, points_per_scan=points_per_scan,
                      lidar_noise=0.004, seed=1)
    pipe = Pipeline(cfg, device=dev)
    push_all(pipe, ds, t_max=t_warm)
    pipe.spin()
    push_all(pipe, ds, t_min=t_warm)
    torch.cuda.synchronize()
    steps0 = pipe.vio.steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        outs = pipe.spin()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_cam = pipe.vio.steps - steps0
    if n_cam == 0 or not outs:
        raise AssertionError("profiled LIVO window holds no camera frame")
    evs = prof.key_averages()
    stages = sorted((e for e in evs if e.key.startswith("vio.")
                     and str(e.device_type).endswith("CPU")),
                    key=lambda e: -e.cpu_time_total)
    n_k = sum(kernels_under(e) for e in prof.events()
              if e.name.startswith("vio.") and str(e.device_type).endswith("CPU"))
    busy = sum(e.self_device_time_total for e in evs if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0
               and not e.key.startswith(("frame.", "lio.", "vio."))) / 1e3
    per_cam = f"{n_k / n_cam:.0f}" if n_k else "not measured"
    print(f"livo profile: {n_cam} camera frames, {len(outs)} lidar frames, "
          f"{1e3 * wall:.1f} ms wall (profiler on), device busy {busy:.2f} ms = "
          f"{100 * busy / (1e3 * wall):.1f}% of wall; device kernels per camera "
          f"frame {per_cam}")
    for e in stages:
        print(f"  stage {e.key:20s} host {e.cpu_time_total / 1e3 / n_cam:8.3f} ms/camera frame, "
              f"device {e.device_time_total / 1e3 / n_cam:8.3f} ms/camera frame, "
              f"{e.count / n_cam:.1f} calls/camera frame")


def cpu_agreement(dev):
    """A small input through the port on the card and on the CPU (its
    plain versions): every frame within 1 mm."""
    from fastlivo_tpu_torch.config import CapacityConfig, Config
    from fastlivo_tpu_torch.io.synthetic import SyntheticDataset
    from fastlivo_tpu_torch.pipeline import Pipeline

    res = []
    for d in (dev, "cpu"):
        cfg = Config()
        cfg.img_enable = False
        cfg.capacity = CapacityConfig(max_points=4096, max_raw_points=8192,
                                      tiled_dir_dims=(32, 32, 16), tiled_pool=1024)
        ds = SyntheticDataset(duration=4.0, points_per_scan=4096,
                              lidar_noise=0.004, seed=3)
        pipe = Pipeline(cfg, device=d)
        for beg, pts, t_rel in ds.lidar_scans_fast():
            pipe.push_lidar(beg, pts, t_rel)
        for t, acc, gyr in ds.imu_stream():
            pipe.push_imu(t, acc, gyr)
        res.append(pipe.spin())
    a, b = res
    if len(a) != len(b) or len(a) < 25:
        raise AssertionError(f"frames {len(a)} on {dev} vs {len(b)} on cpu")
    dmax = max(np.linalg.norm(x.pos - y.pos) for x, y in zip(a, b))
    print(f"small input, {dev} vs cpu: {len(a)} frames, max position "
          f"difference {dmax * 1e3:.4f} mm")
    if not dmax < 1e-3:
        raise AssertionError(f"{dev} and cpu differ by {dmax:.2e} m")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import fastlivo_tpu_torch  # noqa: F401  (fails outside the checkout)
    from fastlivo_tpu_torch.device import resolve_device
    from fastlivo_tpu_torch.ops import knn_plane

    dev = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"device: {name} ({torch.cuda.device_count()} visible); nvidia-smi: {smi}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"build: {build_all():.2f} s")

    n, m = 16384, 27  # the main path's EKF batch at max_points, radius 1
    err_random = kernel_phase(dev, n, m)
    pg_err, pg_ms, pg_plain_ms, pg_bound_ms, pg_bound_by = patches_phase(dev)
    pipe, steady, launches = path_phase(dev)

    # the kernel on the path's own input: compare, then time it
    cand, found, q = real_block(pipe, n)
    got = knn_plane.knn5_plane(cand, found, q)
    torch.cuda.synchronize()
    want = knn_plane.knn5_plane_plain(cand, found, q)
    err = max(err_random, knn5_contract(got, want, min_both=1000))
    ms = time_ms(lambda: knn_plane.knn5_plane(cand, found, q))
    plain_ms = time_ms(lambda: knn_plane.knn5_plane_plain(cand, found, q))
    bound_ms, bound_by = knn5_bound_ms(n, m)
    print(f"knn5_plane N={n} M={m}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}), library none; {smi}")

    del pipe
    torch.cuda.empty_cache()
    livo_launches = livo_path_phase(dev)

    cpu_agreement(dev)
    livo_cpu_agreement(dev)
    profile_phase(dev)
    livo_profile_phase(dev)

    print(json.dumps({"kernels": [{
        "name": "knn5_plane", "route": "cuda",
        "source": "fastlivo_tpu_torch/csrc/knn5_plane.cu",
        "replaces": "fastlivo_tpu/ops/pallas_lio.py:219",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "patches_and_grads", "route": "cuda",
        "source": "fastlivo_tpu_torch/csrc/patches_and_grads.cu",
        "replaces": "fastlivo_tpu/ops/pallas_image.py:180",
        "launches": livo_launches["patches_and_grads"], "max_abs_err": pg_err,
        "ms": pg_ms, "plain_ms": pg_plain_ms, "bound_ms": pg_bound_ms,
        "bound_by": pg_bound_by, "library_ms": None,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
