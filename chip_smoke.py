"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout
(one nvcc per source, all started together), holds each against its
plain PyTorch version on the card, and drives two paths through
`Pipeline` on `Config()`'s shipped capacities with 24000-point scans:
the LiDAR-inertial path (LIO, camera off) and the LiDAR-inertial-visual
path (LIVO, a 640x512 camera). The paths run the fused kernels: the LIO
search in one launch (`knn5_plane_tiled`) and each photometric
iteration's measurement in one launch (`photometric_err_H`); the
standalone `knn5_plane` and `patches_and_grads` are held against their
plain versions but are not on the paths. Each path's trajectory is
checked against the synthetic ground truth, and the port on the card
against the port on the CPU on a small input. Both paths are profiled,
and so is the unfused composition they replaced, for the kernel counts
under `lio.search` and `vio.photometric` before and after.

Prints the card and its power limit, the build time, each kernel's
time beside its bound and beside the unfused pair it replaced, each
path's time per frame, a `{"kernels": ...}` line, the `nvidia-smi` name
and power limit, and as its last line `{"ok": true, "device": {...}}`.
Any failure raises: the exit code is then not 0 and no result line is
printed. Without CUDA, or without the package beside it, it fails the
same way.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32, outside the tensor cores
# every csrc/*.cu of the port
CUDA_SOURCES = ["knn5_plane_tiled", "knn5_plane", "photometric_err_H", "patches_and_grads"]
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


@contextlib.contextmanager
def swapped(module, name, value):
    """module.<name> = value for the duration; yields the original."""
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield real
    finally:
        setattr(module, name, real)


def unsampled_plain():
    """The plain measurement sampling through the standalone
    patches_and_grads kernel: the unfused pair the fused measurement
    replaced."""
    from fastlivo_tpu_torch.ops import image, patches_grads

    return swapped(image, "patches_and_grads", patches_grads.patches_and_grads)


@contextlib.contextmanager
def unfused():
    """The paths as they ran before the fused kernels: the LIO search as
    tiled_map.knn_candidates + the standalone knn5_plane kernel, each
    photometric measurement as the plain body sampling through the
    standalone patches_and_grads kernel."""
    from fastlivo_tpu_torch import lio, vio
    from fastlivo_tpu_torch.ops import knn_plane, photometric
    from fastlivo_tpu_torch.ops import tiled_map as tm

    def search(m, pw, radius, threshold):
        return knn_plane.knn5_plane(*tm.knn_candidates(m, pw, radius), pw, threshold)

    with contextlib.ExitStack() as stack:
        stack.enter_context(swapped(lio, "knn5_plane_tiled", search))
        stack.enter_context(swapped(vio, "photometric_err_H",
                                    photometric.photometric_err_H_plain))
        stack.enter_context(unsampled_plain())
        yield


def spy(module, name, calls: list):
    """Record the arguments of every call of module.<name>."""
    real = getattr(module, name)

    def wrapped(*a):
        calls.append(a)
        return real(*a)

    return swapped(module, name, wrapped)


def reset_counts():
    from fastlivo_tpu_torch.ops import knn_plane, patches_grads, photometric

    for fn in (knn_plane.knn5_plane_tiled, knn_plane.knn5_plane,
               photometric.photometric_err_H, patches_grads.patches_and_grads):
        fn.launches = 0


def read_counts() -> dict:
    from fastlivo_tpu_torch.ops import knn_plane, patches_grads, photometric

    return {fn.__name__: fn.launches for fn in (
        knn_plane.knn5_plane_tiled, knn_plane.knn5_plane,
        photometric.photometric_err_H, patches_grads.patches_and_grads)}


def tiled_check(m, q, label):
    """knn5_plane_tiled against its plain composition
    knn5_plane_plain(knn_candidates(...)) at radius 1 and 2 (M = 27, 125):
    bit-exact, i.e. max_abs_err 0 and identical plane_ok. These launches
    are not the path's."""
    from fastlivo_tpu_torch.ops import knn_plane

    err = 0.0
    for radius in (1, 2):
        got = knn_plane.knn5_plane_tiled(m, q, radius, 0.1)
        torch.cuda.synchronize()
        want = knn_plane.knn5_plane_tiled_plain(m, q, radius, 0.1)
        e = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"knn5_plane_tiled {label} N={q.shape[0]} M={(2 * radius + 1) ** 3}: "
              f"max_abs_err={e:.3g}, bit-exact {same}, {int(want[1].sum())} planes")
        if not same:
            raise AssertionError(f"knn5_plane_tiled {label} radius {radius} differs by {e}")
        err = max(err, e)
    return err


def random_map(dev, n=16384):
    """A tiled map holding random_block's found candidates (most of them
    on local planes around the queries), and the queries."""
    from fastlivo_tpu_torch.ops import tiled_map as tm

    cand, found, q = random_block(n, 27, seed=1)
    m = tm.build_host(cand[found], (128, 128, 64), 2048, 0.5, device=dev)
    return m, torch.from_numpy(q).to(dev)


def tiled_bound_ms(m, q, radius: int = 1):
    """Least time for the fused search on these inputs: the queries, each
    distinct directory entry (8 B), pool-cell hash behind a matching entry
    (4 B) and live point (12 B) that the neighbourhoods touch read once,
    21 B written per query, over HBM bandwidth; against the operations
    these inputs need, counted from the kernel's source, over the float32
    rate (integer operations run no faster): per query its voxel (6) and
    the fit and gate of plane_fit.cuh (260); per candidate row its voxel,
    tile, cell and directory indices (20), the directory test and slot
    clamp (3) and one compare in each of the 5 selection rounds; per row
    whose tile is in the directory the pool index and cell test (3); per
    live row its squared distance (8); the 31-bit tile hash (30) once per
    distinct tile of a neighbourhood. Returns (ms, "bytes" | "operations",
    the distinct directory entries, pool cells, live points and tiles)."""
    from fastlivo_tpu_torch.ops import tiled_map as tm

    dir_idx, pool_idx, tile_ok, chk = tm.candidate_cells(m, q, radius)
    live = tile_ok & (m.cell_check[pool_idx] == chk)
    n, M = dir_idx.shape
    # a neighbourhood (radius <= 2) stays within one tile of its query's
    # on each axis: code its tiles 0..26 and count the distinct ones
    base = tm.voxel_of(q, m.voxel_size)
    d = ((base[:, None, :] + tm.neighbor_offsets(radius, q.device)) >> 3) \
        - (base[:, None, :] >> 3) + 1
    code = torch.sort(d[..., 0] * 9 + d[..., 1] * 3 + d[..., 2], dim=1).values
    tiles = n + int((code[:, 1:] != code[:, :-1]).sum())
    uniq = (torch.unique(dir_idx).numel(), torch.unique(pool_idx[tile_ok]).numel(),
            torch.unique(pool_idx[live]).numel(), tiles)
    nbytes = n * (12 + 21) + uniq[0] * 8 + uniq[1] * 4 + uniq[2] * 12 + M * 12
    ops = (n * (6 + 260) + n * M * (20 + 3 + 5) + 3 * int(tile_ok.sum())
           + 8 * int(live.sum()) + 30 * tiles)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), uniq


def photometric_bound_ms(args):
    """Least time for one photometric measurement on these inputs
    (photometric_err_H's arguments): the distinct image pixels of the
    (P+3)^2 tap grids (4 B each; the grids from the plain version's own
    sampling call), per point its level of tr_patch, tr_pos, search level
    and valid flag read and its perr written, the pose, extrinsics,
    Jacobian blocks and camera (248 B) read and the 44 outputs written,
    each once, over HBM bandwidth; against the operations counted from the
    kernel's source over the float32 rate: per pixel 5 bilinear samples
    (7 each), du and dv (3 each), the residual, h (6 x 3), res_w and its
    square, the robust weight (none 0, Huber 6, Tukey 9), the 48 products
    of [h·wr·h | h·wr·res] and the 43 terms' sums; per point the
    projection through world2cam (48), the anchor and weights (18), Jdpi,
    Mg and N (132), 12 index operations per tap and 44 sums of the final
    reduction; per launch the pose (75). Returns (ms, "bytes" |
    "operations", distinct tap pixels)."""
    from fastlivo_tpu_torch.ops import image
    from fastlivo_tpu_torch.ops import photometric as ph

    calls = []
    with spy(image, "patches_and_grads", calls):
        ph.photometric_err_H_plain(*args)
    img, pc, P, scale = calls[0]
    (H, W), G, n = img.shape, pc.shape[0], P + 3
    u_i, v_i, _ = image._anchor_weights(pc, scale)
    ext = torch.arange(n, device=pc.device) - (P // 2 + 1)
    rows = (v_i[:, None].long() + ext * scale[:, None]).clamp(0, H - 1)
    cols = (u_i[:, None].long() + ext * scale[:, None]).clamp(0, W - 1)
    taps = torch.unique(rows[:, :, None] * W + cols[:, None, :]).numel()
    nbytes = taps * 4 + G * (P * P * 4 + 12 + 4 + 1 + 4) + 248 + 44 * 4
    per_px = (5 * 7 + 2 * 3 + 1 + 6 * 3 + 2 + {"none": 0, "huber": 6, "tukey": 9}[args[14]]
              + 48 + 43)
    ops = G * (P * P * per_px + 48 + 18 + 132 + 12 * n * n + 44) + 75
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), taps


def photometric_phase(dev, args):
    """photometric_err_H against its plain version on the inputs of the
    LIVO path's last measurement (G = 192 cells of a 640x512 image,
    P = 8), at every robust mode: HᵀH and Hᵀz each within 1e-4 of its
    largest entry, err and perr within rtol 1e-5; with every point
    invalid, err and HT exactly 0. Times the kernel, the unfused pair it
    replaced (the plain body sampling through the standalone
    patches_and_grads kernel) and the plain version. These launches are
    not the path's. Returns the max abs error over all outputs and the
    times."""
    from fastlivo_tpu_torch.ops import photometric as ph

    args = list(args)
    G, P, level = args[1].shape[0], args[13], args[12]
    err = 0.0
    for robust in ("none", "huber", "tukey"):
        a = args[:14] + [robust, args[15]]
        got = ph.photometric_err_H(*a)
        torch.cuda.synchronize()
        want = ph.photometric_err_H_plain(*a)
        rel = []
        for name, g, w, tol in (("HTH", got[1], want[1], 1e-4), ("HTz", got[2], want[2], 1e-4)):
            d = float((g - w).abs().max()) / float(w.abs().max())
            rel.append(f"{name} {d:.3g} of max")
            if not d <= tol:
                raise AssertionError(f"photometric_err_H {robust} {name} off by {d:.3g} of max")
        for name, g, w in (("err", got[0], want[0]), ("perr", got[3], want[3])):
            d = float(((g - w).abs() / w.abs().clamp(min=1e-30)).max())
            rel.append(f"{name} rel {d:.3g}")
            if not d <= 1e-5:
                raise AssertionError(f"photometric_err_H {robust} {name} off by rel {d:.3g}")
        e = max(float((g - w).abs().max()) for g, w in zip(got, want))
        print(f"photometric_err_H G={G} P={P} level {level} robust {robust}: "
              f"{', '.join(rel)}; max_abs_err={e:.3g} (|HT| up to "
              f"{float(want[1].abs().max()):.3g})")
        err = max(err, e)
    a = args[:4] + [torch.zeros_like(args[4])] + args[5:]
    got = ph.photometric_err_H(*a)
    if float(got[0]) != 0.0 or got[1].any() or got[2].any():
        raise AssertionError("photometric_err_H with nothing valid is not exactly 0")
    print("photometric_err_H with every point invalid: err = 0, HT = 0 exactly")
    ms = time_ms(lambda: ph.photometric_err_H(*args))
    with unsampled_plain():
        pair_ms = time_ms(lambda: ph.photometric_err_H_plain(*args))
    plain_ms = time_ms(lambda: ph.photometric_err_H_plain(*args))
    bound_ms, bound_by, taps = photometric_bound_ms(args)
    print(f"photometric_err_H G={G} P={P}: kernel {ms:.4f} ms, unfused pair (plain body + "
          f"patches_and_grads kernel) {pair_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.6f} ms ({bound_by}; {taps} distinct tap pixels), library none; "
          f"{nvidia_smi_line()}")
    return err, ms, pair_ms, plain_ms, bound_ms, bound_by


def path_phase(dev, duration=6.0, points_per_scan=24000):
    """Pipeline(Config()) at its shipped capacities on `dev`; the kernels'
    launch counts are read around this run only. The fused search must
    launch once per search, the standalone kernels never."""
    from fastlivo_tpu_torch import lio
    from fastlivo_tpu_torch.config import Config
    from fastlivo_tpu_torch.io.synthetic import SyntheticDataset
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
    searches = []
    torch.cuda.synchronize()
    reset_counts()
    with spy(lio, "knn5_plane_tiled", searches):
        t0 = time.perf_counter()
        outs = pipe.spin()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_counts()

    steady = [o for o in outs if o.iters > 0]
    pos = np.array([o.pos for o in outs])
    base = ds.traj.base_pos
    errs = [np.linalg.norm(o.pos - (ds.traj.pose(o.t)[1] - base))
            for o in outs if o.t >= ds.traj.t_static + 0.5]
    ate = float(np.sqrt(np.mean(np.square(errs))))
    frame_ms = [1e3 * o.timing["total"] for o in steady]
    print(f"path: {len(outs)} frames ({len(steady)} steady) in {wall:.2f} s, "
          f"{len(searches)} searches, launches {launches}, ATE {ate * 1e3:.3f} mm, "
          f"median steady frame {np.median(frame_ms):.2f} ms "
          f"(p90 {np.percentile(frame_ms, 90):.2f} ms), "
          f"n_active median {int(np.median([o.n_active for o in steady]))}; "
          f"{nvidia_smi_line()}")
    if len(outs) < 40 or len(steady) < 30:
        raise AssertionError(f"too few frames: {len(outs)} ({len(steady)} steady)")
    if (launches["knn5_plane_tiled"] != len(searches) or len(searches) < len(steady)
            or launches["knn5_plane"] or launches["patches_and_grads"]):
        raise AssertionError(f"launches {launches} for {len(searches)} searches, "
                             f"{len(steady)} steady frames")
    if not (np.isfinite(pos).all() and torch.isfinite(pipe.state.cov).all()):
        raise AssertionError("non-finite state")
    if not ate < 0.02:
        raise AssertionError(f"ATE {ate:.4f} m >= 2 cm")
    return pipe, launches


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


def livo_path_phase(dev, duration=6.0, points_per_scan=24000, fused=True):
    """Pipeline(Config()) with the camera on, at its shipped capacities
    (visual map 65536 points x 20 observations, 2^18 hash slots, a u8
    pool of 256 images of 640x512). The kernels' launch counts are read
    around this run only: with `fused` the fused kernels launch once per
    search and once per photometric iteration and the standalone ones
    never; without it the run takes the unfused composition, for its
    frame times. Camera-frame time: host wall of Vio.update, its stats
    read included. Returns (launches, the last photometric call's
    arguments, camera and lidar frame medians in ms)."""
    from fastlivo_tpu_torch import lio, vio as vio_mod
    from fastlivo_tpu_torch.pipeline import Pipeline

    cfg = livo_config()
    cap = cfg.capacity
    label = "livo path" if fused else "livo path, unfused"
    if fused:
        print(f"livo config: camera {cfg.camera.width}x{cfg.camera.height} f={cfg.camera.fx}, "
              f"grid {cfg.grid_size}, patch {cfg.patch_size}, max_iteration "
              f"{cfg.max_iteration}, visual map {cap.vmap_points} pts x {cap.vmap_obs} obs, "
              f"{cap.vmap_table_size} slots x {cap.vmap_voxel_cap}, pool "
              f"{cap.frame_ring} x u8={cap.frame_ring_u8}")
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
    searches, measurements = [], []
    torch.cuda.synchronize()
    reset_counts()
    with contextlib.ExitStack() as stack:
        if not fused:
            stack.enter_context(unfused())
        stack.enter_context(spy(lio, "knn5_plane_tiled", searches))
        stack.enter_context(spy(vio_mod, "photometric_err_H", measurements))
        t0 = time.perf_counter()
        outs = pipe.spin()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_counts()
    vio.update = update

    steady = [o for o in outs if o.iters > 0]
    pos = np.array([o.pos for o in outs])
    base = ds.traj.base_pos
    errs = [np.linalg.norm(o.pos - (ds.traj.pose(o.t)[1] - base))
            for o in outs if o.t >= ds.traj.t_static + 0.5]
    ate = float(np.sqrt(np.mean(np.square(errs))))
    lid_ms = [1e3 * o.timing["total"] for o in steady]
    n_pts = int(vio.vmap.n_pts)
    print(f"{label}: {len(outs)} lidar frames ({len(steady)} steady), {vio.fid} camera "
          f"frames ({vio.steps} ran the frame step) in {wall:.2f} s; {len(searches)} "
          f"searches, {len(measurements)} photometric iterations; launches {launches}; "
          f"ATE {ate * 1e3:.3f} mm; visual map {n_pts} points, last {vio.last_stats}")
    print(f"{label}: camera frame median {np.median(cam_ms):.2f} ms (p90 "
          f"{np.percentile(cam_ms, 90):.2f} ms) over {len(cam_ms)}; lidar frame median "
          f"{np.median(lid_ms):.2f} ms (p90 {np.percentile(lid_ms, 90):.2f} ms) over "
          f"{len(lid_ms)}; {nvidia_smi_line()}")
    if len(steady) < 30 or vio.steps < 30:
        raise AssertionError(f"too few frames: {len(steady)} steady, {vio.steps} camera")
    if n_pts <= 50 or vio.last_stats.get("tracked", 0) <= 5:
        raise AssertionError(f"visual map {n_pts} points, last {vio.last_stats}")
    if len(measurements) < 3 * vio.steps or len(searches) < len(steady):
        raise AssertionError(f"{len(measurements)} measurements, {len(searches)} searches")
    want = ({"knn5_plane_tiled": len(searches), "knn5_plane": 0,
             "photometric_err_H": len(measurements), "patches_and_grads": 0} if fused else
            {"knn5_plane_tiled": 0, "knn5_plane": len(searches),
             "photometric_err_H": 0, "patches_and_grads": len(measurements)})
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want}")
    if not (np.isfinite(pos).all() and torch.isfinite(pipe.state.cov).all()):
        raise AssertionError("non-finite state")
    if not ate < 0.06:
        raise AssertionError(f"LIVO ATE {ate:.4f} m >= 6 cm")
    return launches, measurements[-1], float(np.median(cam_ms)), float(np.median(lid_ms))


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


def real_queries(pipe, n):
    """The search leg's input at the path's shape: the last scan's points
    in the world frame at the posterior."""
    down, _active = pipe.last_effect
    rot = pipe.state.rot.to(torch.float32)
    pw = (down @ pipe.calib.lid_rot.T + pipe.calib.lid_off) @ rot.T \
        + pipe.state.pos.to(torch.float32)
    if pw.shape[0] != n:
        raise AssertionError(f"EKF batch {pw.shape[0]} != {n}")
    return pw.contiguous()


def kernel_names(e) -> list:
    """Device kernels the profiler links to an event and its children."""
    return [k.name for k in getattr(e, "kernels", [])] + [
        name for c in e.cpu_children for name in kernel_names(c)]


def kernels_in(prof, stages, launched: int):
    """Device kernels launched under the ranges whose names start with
    `stages`: those the profiler links to them, plus those of the
    `launched` hand-written kernels (their launch counters over the
    profiled window, all launched under these ranges) that it does not
    link. Returns (count, hand-written launches it linked)."""
    names = [name for e in prof.events()
             if e.name.startswith(stages) and str(e.device_type).endswith("CPU")
             for name in kernel_names(e)]
    linked = sum(any(f"{s}_kernel" in name for s in CUDA_SOURCES) for name in names)
    return len(names) + max(launched - linked, 0), linked


def profile_phase(dev, n_warm=30, duration=4.5, points_per_scan=24000, fused=True):
    """Where a steady frame's time goes: torch.profiler over the frames
    after the first `n_warm` scans of a second shipped-capacity run
    (without `fused`, of the unfused composition: only its kernel count
    under `lio.search` is printed). Prints the device busy share of the
    window, the device time and launch count per frame of the largest
    kernel names and the kernels under `lio.search` per frame."""
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
    reset_counts()
    with contextlib.ExitStack() as stack:
        if not fused:
            stack.enter_context(unfused())
        prof = stack.enter_context(
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        t0 = time.perf_counter()
        outs = pipe.spin()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_counts()
    n = len(outs)
    if n == 0 or not all(o.iters > 0 for o in outs):
        raise AssertionError("profiled window holds no steady frames")
    launched = counts["knn5_plane_tiled"] + counts["knn5_plane"]
    n_k, linked = kernels_in(prof, "lio.search", launched)
    per_frame = n_k / n
    print(f"profile ({'fused' if fused else 'unfused'}): {per_frame:.1f} device kernels "
          f"under lio.search per steady frame (the profiler linked {linked} of its "
          f"{launched} hand-written launches to the range)")
    if not fused:
        return per_frame
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
    return per_frame


def livo_profile_phase(dev, t_warm=3.0, duration=4.5, points_per_scan=24000, fused=True):
    """Where a camera frame's time goes: torch.profiler over the LIVO
    frames after `t_warm` s of a second shipped-capacity LIVO run
    (without `fused`, of the unfused composition). Prints each `vio.*`
    stage's host and device ms per camera frame, the device kernels
    launched per camera frame and those under `vio.photometric`."""
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
    reset_counts()
    with contextlib.ExitStack() as stack:
        if not fused:
            stack.enter_context(unfused())
        prof = stack.enter_context(
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        t0 = time.perf_counter()
        outs = pipe.spin()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_counts()
    n_cam = pipe.vio.steps - steps0
    if n_cam == 0 or not outs:
        raise AssertionError("profiled LIVO window holds no camera frame")
    evs = prof.key_averages()
    stages = sorted((e for e in evs if e.key.startswith("vio.")
                     and str(e.device_type).endswith("CPU")),
                    key=lambda e: -e.cpu_time_total)
    launched = counts["photometric_err_H"] + counts["patches_and_grads"]
    n_k, _ = kernels_in(prof, "vio.", launched)
    n_photo, linked = kernels_in(prof, "vio.photometric", launched)
    busy = sum(e.self_device_time_total for e in evs if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0
               and not e.key.startswith(("frame.", "lio.", "vio."))) / 1e3
    photo = n_photo / n_cam
    print(f"livo profile ({'fused' if fused else 'unfused'}): {n_cam} camera frames, "
          f"{len(outs)} lidar frames, "
          f"{1e3 * wall:.1f} ms wall (profiler on), device busy {busy:.2f} ms = "
          f"{100 * busy / (1e3 * wall):.1f}% of wall; device kernels per camera "
          f"frame {n_k / n_cam:.0f}, under vio.photometric {photo:.1f} (the profiler "
          f"linked {linked} of its {launched} hand-written launches to the range)")
    for e in stages:
        print(f"  stage {e.key:20s} host {e.cpu_time_total / 1e3 / n_cam:8.3f} ms/camera frame, "
              f"device {e.device_time_total / 1e3 / n_cam:8.3f} ms/camera frame, "
              f"{e.count / n_cam:.1f} calls/camera frame")
    return photo


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
    from fastlivo_tpu_torch.ops import tiled_map as tm

    dev = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"device: {name} ({torch.cuda.device_count()} visible); nvidia-smi: {smi}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"build: {build_all():.2f} s")
    # what time_ms reads for a kernel that does nothing: the floor under
    # every kernel time below
    print(f"launch floor: an empty kernel {time_ms(lambda: torch.cuda._sleep(0)):.4f} ms")

    n, m = 16384, 27  # the main path's EKF batch at max_points, radius 1
    err_random = kernel_phase(dev, n, m)
    pg_err, pg_ms, pg_plain_ms, pg_bound_ms, pg_bound_by = patches_phase(dev)
    tiled_err = tiled_check(*random_map(dev, n), "random-block map")
    pipe, lio_launches = path_phase(dev)

    # the search on the path's own map and queries: compare, then time
    q = real_queries(pipe, n)
    tiled_err = max(tiled_err, tiled_check(pipe.map, q, "path map"))
    cand, found = tm.knn_candidates(pipe.map, q, 1)
    got = knn_plane.knn5_plane(cand, found, q)
    torch.cuda.synchronize()
    want = knn_plane.knn5_plane_plain(cand, found, q)
    err = max(err_random, knn5_contract(got, want, min_both=1000))
    ms = time_ms(lambda: knn_plane.knn5_plane(cand, found, q))
    plain_ms = time_ms(lambda: knn_plane.knn5_plane_plain(cand, found, q))
    bound_ms, bound_by = knn5_bound_ms(n, m)
    print(f"knn5_plane N={n} M={m}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}), library none; {smi}")
    t_ms = time_ms(lambda: knn_plane.knn5_plane_tiled(pipe.map, q, 1, 0.1))
    pair_ms = time_ms(lambda: knn_plane.knn5_plane(*tm.knn_candidates(pipe.map, q, 1), q, 0.1))
    t_plain_ms = time_ms(lambda: knn_plane.knn5_plane_tiled_plain(pipe.map, q, 1, 0.1))
    t_bound_ms, t_bound_by, uniq = tiled_bound_ms(pipe.map, q, 1)
    print(f"knn5_plane_tiled N={n} M={m} on the path map: kernel {t_ms:.4f} ms, unfused pair "
          f"(knn_candidates + knn5_plane kernel) {pair_ms:.4f} ms, plain {t_plain_ms:.4f} ms, "
          f"bound {t_bound_ms:.5f} ms ({t_bound_by}; distinct directory entries, pool cells, "
          f"live points, neighbourhood tiles {uniq}), library none; {smi}")

    del pipe, cand, found, got, want
    torch.cuda.empty_cache()
    livo_launches, last_call, cam_fused, lid_fused = livo_path_phase(dev)
    ph_err, ph_ms, ph_pair_ms, ph_plain_ms, ph_bound_ms, ph_bound_by = \
        photometric_phase(dev, last_call)
    del last_call
    # frame times of the unfused composition against the fused path, in
    # turns (fused, unfused, unfused, fused): a process's earlier runs
    # tend to be slower
    cam, lid = {True: [cam_fused], False: []}, {True: [lid_fused], False: []}
    for fused in (False, False, True):
        _, _, c, l_ = livo_path_phase(dev, fused=fused)
        cam[fused].append(c)
        lid[fused].append(l_)
    print(f"camera frame median per run: fused {cam[True]} ms, unfused {cam[False]} ms; "
          f"lidar frame median per run: fused {lid[True]} ms, unfused {lid[False]} ms; {smi}")

    cpu_agreement(dev)
    livo_cpu_agreement(dev)
    search_k = [profile_phase(dev, fused=f) for f in (False, True)]
    photo_k = [livo_profile_phase(dev, fused=f) for f in (False, True)]
    print(f"device kernels under lio.search per steady lidar frame: unfused {search_k[0]:.1f}, "
          f"fused {search_k[1]:.1f}; under vio.photometric per camera frame: unfused "
          f"{photo_k[0]:.1f}, fused {photo_k[1]:.1f}")
    if not (search_k[1] < search_k[0] and photo_k[1] < photo_k[0]):
        raise AssertionError("the fused kernels did not cut the kernel counts")

    print(json.dumps({"kernels": [{
        "name": "knn5_plane_tiled", "route": "cuda",
        "source": "fastlivo_tpu_torch/csrc/knn5_plane_tiled.cu",
        "replaces": "fastlivo_tpu/ops/pallas_lio.py:219",
        "launches": lio_launches["knn5_plane_tiled"], "max_abs_err": tiled_err,
        "ms": t_ms, "plain_ms": t_plain_ms, "bound_ms": t_bound_ms,
        "bound_by": t_bound_by, "library_ms": None,
    }, {
        "name": "photometric_err_H", "route": "cuda",
        "source": "fastlivo_tpu_torch/csrc/photometric_err_H.cu",
        "replaces": "fastlivo_tpu/ops/pallas_image.py:180",
        "launches": livo_launches["photometric_err_H"], "max_abs_err": ph_err,
        "ms": ph_ms, "plain_ms": ph_plain_ms, "bound_ms": ph_bound_ms,
        "bound_by": ph_bound_by, "library_ms": None,
    }, {
        "name": "knn5_plane", "route": "cuda",
        "source": "fastlivo_tpu_torch/csrc/knn5_plane.cu",
        "replaces": "fastlivo_tpu/ops/pallas_lio.py:219",
        "launches": lio_launches["knn5_plane"], "max_abs_err": err, "ms": ms,
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
