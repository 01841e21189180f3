"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout
(one nvcc per source) and the native host library (native/ingest.cpp,
one g++), all started together, holds each kernel against its plain
PyTorch version on the card, runs a few frames of a discarded pipeline
(so that no timed path is the process's first), and drives two paths
through `Pipeline` on `Config()`'s shipped capacities with 24000-point
scans: the LiDAR-inertial path (LIO, camera off) and the
LiDAR-inertial-visual path (LIVO, a 640x512 camera). The first 24 frames
of the same LIO dataset then run through the other map backends and LIO
options (the hash map, the dense grid, `cache_knn`, `plane_fit: ref`,
`profile_every` and `BlockReplayer(8)` on the hash map; the hash and
dense estimators are checkpointed), and the whole dataset through the
slice's other paths: block replay (`BlockReplayer(8)` and
`LivoBlockReplayer(8)`), a `serve.Server` on a Unix socket with
`--autosave` and a second server warm-started from that file, and a bag
of Avia scans replayed by `run.main --bag --block 8`; the LIVO dataset
runs through `LivoBlockReplayer(8)` and is checkpointed. Then (g) the
LIVO dataset with `debug` and `pcd_save_en` (the overlay, `colorize`
on the card against the CPU, the RGB cloud through `run.save_pcd` and
`viz._load_pcd`), (h) `Vio.update_staged` against `Vio.update` on forked
states at the same width, and (i) the native library against its numpy
and Python twins, and a bootstrap frame through it, (j) LIO over a
device mesh on the first 16 LIO frames: a world of one on NCCL in this
process and a world of two sharing the card under gloo (spawned by
`parallel.launch`), each with the map replicated and block-sharded,
against the per-frame path, and (k) LIVO over a device mesh on the
first 10 lidar frames of the LIVO dataset, the same two worlds with the
map replicated and with the map sharded and the camera's image pool and
observation rings in per-rank slabs, against the single-device prefix,
`photometric_err_H`'s partials (what a mesh sums) held against their
plain version on one rank's slab, then `run.main --mesh 1 --sharded-map`
with the camera and its checkpoint, (l) a LIO run with a 4 kHz IMU
in 512-pair groups on the card against the CPU, with the first frame
where the card's and the CPU's downsampled scans or EKF iterations
differ, and (m) LIVO at patch size 12, grid 10 (3264 cells on the
640x512 camera) and max_imu_per_group 1024 (8200-row pose tables) with
a 2 kHz IMU, on the card against the CPU: every layout past the
kernels' shared-memory stages on a path, each camera frame's vio_select
and vio_observations and each photometric cascade held against their
plain versions, and the changed kernels timed at those sizes, and (n)
a LIO run at `knn_voxel_radius: 3` (343 candidates a query, the walks'
generic form) on the card against the CPU. The cascade also runs at
radius 0 (one candidate) and 3 on the last calls of the tiled, hash and
dense paths, walking and under `cache_knn`, and with `plane_fit: ref`
at radius 3, each held bit for bit against the host loop (its search
the host-loop kernels' generic route, and the plain search) and timed
beside its bound. The tiled map's box delete (`tiled_delete_boxes`) and the voxel
filter's segmented centroid (`voxel_centroids`) launch once per tracker
update and once per filtered scan or camera cloud on every single-card
path, and so does the filter's keys and stable sort (`voxel_sort`: every
call of the LIO and LIVO per-frame paths replayed against torch's sort of
the plain keys, and timed beside that route, with no library sort kernel
under either filter's range in the profiles); both are held against
their plain versions on the LIO path's final map and on its last scan
and the LIVO path's last camera cloud (the centroid bit for bit against
the plain version run on the CPU), with
overflow, NaN and -0.0 rows, and timed beside their bounds and, for the
centroid, torch.segment_reduce. The tiled-map paths
run the fused kernels: each scan's LIO iterated EKF in one launch
(`lio_cascade`: every iteration's search, the walk of `knn5_plane_tiled`,
the gates and rows, the fixed-order [HᵀH | Hᵀz] and the f64 step on the
card; each call of the LIO and LIVO per-frame paths recorded with a copy
of the map's search arrays and held after the run against the host loop
`lio.lio_loop` on its inputs: bit-equal with the step kernel, equal
iterations with the plain step; then timed beside the loop and given its
bound), and each camera frame's coarse-to-fine photometric cascade in one launch
(`photometric_cascade`: every iteration's measurement, f64 step and
carry on the card; the staged path launches it once per level), each
recorded cascade held after its path's run against the host loop on its
inputs (bit-equal with the step kernel, equal iterations with the plain
step); over a mesh the cascade is a host loop of one `photometric_err_H`
(the measurement's partials) and one `photometric_step` launch per
iteration in every rank, and the LIO EKF the host loop of one
`knn5_plane_tiled` launch per search and one `photometric_step` launch
(the shared step kernel, fed -Hᵀz) per iteration. On one card every
map and LIO option runs its EKF as one `lio_cascade` launch: the hash
and dense paths walk their maps inside it (the walk of
`knn5_plane_hashed`), `cache_knn` re-ranks its one gather per frame
inside it (the re-rank of the standalone `knn5_plane`, slab-staged
through TMA bulk copies, which stays the oracle), and `plane_fit: ref`
fits the reference's plane inside it; each of those cascades is held
against the host loop on its inputs and the last one timed beside its
bound; each path's launches are counted around it. IMU propagation runs as one launch of
`imu_propagate` per measurement group on every path (every rank of the
mesh runs included); the kernel is held against the plain loop at 8, 32,
64, 256, 300 and 512 pairs, and the LIO and LIVO per-frame paths run
again with the plain loop swapped in, for the positions and frame times
before and after. The cascade is held against the host loop at every
robust mode on the LIVO path's last camera frame and timed beside it, and
the step kernel against its plain version. The fused hash and dense searches and
`knn5_plane` are also held against their plain versions on those
paths' maps and timed there. The standalone `patches_and_grads` is held
against its plain version but is not on the paths. The hash and dense
maps' operations run on the card and on the CPU on the same seeded
points and must agree in every array; `rebuild`
is timed at the shipped table. Their writes are hand-written kernels on
the card: the hash insert's two launches and no sort (`hash_insert_keys`:
each voxel's head, compact in row order; `hash_insert_probe`: every
probe round over the heads in one launch), the dense grid's one (`dense_insert`) and the box delete of both
(`flat_delete_boxes`), each launched once per insert or box set on the
hash, dense and hash `BlockReplayer(8)` paths with no call of a plain
version, and held against its plain version and timed on those paths'
own maps, last batches and box sets. Each path's trajectory is checked against
the per-frame path and the synthetic ground truth, and the port on the
card against the port on the CPU on a small input. Both per-frame paths
are profiled, and so is the unfused composition they replaced (the plain
IMU loop and the photometric host loop with its plain step included),
for the device kernels per frame, the kernel counts under `lio.search`,
`frame.lio_update`, `vio.photometric` and `frame.propagate` and the host
time of `frame.lio_update`, `frame.propagate` and `vio.photometric`
before and after, and the host and device time of `frame.map_insert`,
`frame.delete_boxes`, `frame.voxel_filter` and `vio.voxel_filter`.

Prints the card and its power limit, the build time, each phase's
seconds, each kernel's time beside its bound and beside the unfused pair
it replaced, each path's time per frame (for the server, the gaps
between odometry lines) and launches in a `{"paths": ...}` line, a
`{"kernels": ...}` line, the `nvidia-smi` name and power limit, and as
its last line `{"ok": true, "device": {...}}`.
Any failure raises: the exit code is then not 0 and no result line is
printed. Without CUDA, or without the package beside it, it fails the
same way.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32, outside the tensor cores
F64_OPS_PER_S = 34e12  # H100 SXM float64, outside the tensor cores (NVIDIA data sheet)
# every csrc/*.cu of the port
CUDA_SOURCES = ["knn5_plane_tiled", "knn5_plane_hashed", "knn5_plane", "photometric_err_H",
                "photometric_cascade", "patches_and_grads", "imu_propagate", "lio_cascade",
                "vio_select", "vio_observations", "tiled_delete_boxes", "voxel_centroids",
                "tiled_insert", "undistort", "hash_insert", "dense_insert", "flat_delete_boxes",
                "lio_cascade_125", "lio_cascade_any", "voxel_keys", "vio_dedup", "vio_push"]
# the hand-written kernels' names are <stem>_kernel...: a source's own name,
# or another kernel of it
KERNEL_STEMS = (*CUDA_SOURCES, "voxel_sort")
# camera of the LIVO paths: z forward = body +x, x right = body -y,
# y down = body -z (looks at the synthetic room's walls)
RCL = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def build_all() -> float:
    """One nvcc per source and g++ for the native host library
    (native/ingest.cpp), all started together."""
    from fastlivo_tpu_torch import native
    from fastlivo_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(CUDA_SOURCES) + 1) as ex:
        host = ex.submit(native.build)
        for path in ex.map(_build.build, CUDA_SOURCES):
            print(f"built {path.name}")
        print(f"built {host.result().name}")
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


def event_ms(fn, reps: int = 10) -> float:
    """Median time of one call alone between two CUDA events, the device
    idle before it: the call's device timeline, with the gaps where the
    device waited for the host's launches. For calls of more small
    kernels than the CUDA launch queue holds, which `time_ms` cannot
    queue ahead of the device."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


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


# f64 operations of imu_propagate.cu, counted from its source: per valid
# pair thread 0's step (w, a, two Exp, the F and Q blocks, rot, acc_w,
# pos, vel: 404) and the two products on F's nonzeros with Q's entries
# (1242 + 1260); once per group the tail (160)
IMU_OPS_PER_PAIR = 2906
IMU_OPS_TAIL = 160


def imu_inputs(dev, B, n_valid, seed):
    """One measurement group as the pipeline stages it: a 200 Hz IMU
    stream over `n_valid` intervals through imu.prepare_pairs into a
    B-pair wire (the pairs past n_valid padded), the calibration of
    ImuInitializer over 200 static samples, and a random f64 state (SPD
    covariance); acc_s_last and angvel_last f64, as after the first
    group. Returns (state, wire, acc_s_last, angvel_last, calib)."""
    from fastlivo_tpu_torch import imu
    from fastlivo_tpu_torch.ops import so3
    from fastlivo_tpu_torch.state import NavState

    rng = np.random.default_rng(seed)
    init = imu.ImuInitializer()
    for _ in range(imu.MAX_INI_COUNT):
        init.push(np.array([0.1, -0.2, 9.79]) + rng.normal(0, 0.02, 3),
                  rng.normal(0, 0.003, 3))
    calib = init.calib(1.0, 1.0, np.eye(3), np.zeros(3), device=dev)
    t = 10.0 + np.arange(n_valid + 1) * 0.005 + rng.uniform(-2e-4, 2e-4, n_valid + 1)
    acc = np.array([0.1, -0.2, 9.79]) + rng.normal(0, 0.5, (n_valid + 1, 3))
    gyr = np.array([0.3, -0.2, 0.5]) + rng.normal(0, 1.0, (n_valid + 1, 3))
    pairs = imu.prepare_pairs(t, acc, gyr, beg_time=t[0] - 0.02, end_time=t[-1] + 0.002,
                              last_end_time=t[0], max_pairs=B)
    wire = torch.from_numpy(imu.pack_pairs_wire(*pairs)).to(dev)
    A = rng.normal(size=(18, 18)) * 0.01
    f64 = dict(dtype=torch.float64, device=dev)
    state = NavState(
        rot=so3.exp(torch.as_tensor(rng.normal(size=3) * 0.5, **f64)),
        pos=torch.as_tensor(rng.normal(size=3), **f64),
        vel=torch.as_tensor(rng.normal(size=3) * 0.5, **f64),
        bg=torch.as_tensor(init.mean_gyr, **f64), ba=torch.zeros(3, **f64),
        grav=torch.as_tensor(init.gravity(), **f64),
        cov=torch.as_tensor(A @ A.T + np.eye(18) * 1e-3, **f64))
    return (state, wire, torch.as_tensor(acc[0], **f64), torch.as_tensor(gyr[0], **f64),
            calib)


def imu_bound_ms(B: int, n_valid: int):
    """Least time for one group's propagation: the (B+1, 9) f32 wire, the
    f64 state, covariance and segment-start acc / gyro, the f32
    calibration read once, the f64 end state, covariance, (B+2, 24) pose
    pack and carried acc / gyro written once, over HBM bandwidth; against
    the f64 operations these `n_valid` pairs need over the f64 rate.
    Neither counts the chain of B dependent steps, which bounds the
    kernel. Returns (ms, "bytes" | "operations")."""
    nbytes = ((B + 1) * 9 * 4 + (9 + 5 * 3 + 18 * 18 + 6) * 8 + 13 * 4
              + (9 + 3 + 3 + 18 * 18 + (B + 2) * 24 + 6) * 8)
    ops = n_valid * IMU_OPS_PER_PAIR + IMU_OPS_TAIL
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F64_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def imu_phase(dev):
    """imu_propagate against the plain loop (imu.propagate_wire_plain, its
    18x18 products through cuBLAS) on the card at B = 8 (8 valid pairs),
    32 (21 valid: a 10 Hz lidar group at 200 Hz in the pipeline's bucket),
    64 (64 valid), and past the old 256-pair cap and the kernel's 64-pair
    chunk: 256 (256 valid), 300 (300 valid, not a power of two) and 512
    (400 valid: a 10 Hz group of a 4 kHz IMU): every output within 1e-10,
    two launches bit-equal. Times both at each B: the kernel between queued
    CUDA events (time_ms), the plain loop alone between two events
    (event_ms: its ~150 small kernels per pair overflow the launch queue;
    one call at B >= 256). These launches are not the path's. Returns {B:
    numbers}."""
    from fastlivo_tpu_torch import imu
    from fastlivo_tpu_torch.ops import imu_scan

    def flat(out):  # (state, pack, acc, gyr) -> its tensors
        return (*out[0], *out[1:])

    res = {}
    for B, nv in ((8, 8), (32, 21), (64, 64), (256, 256), (300, 300), (512, 400)):
        s, w, a, g, calib = imu_inputs(dev, B, nv, seed=B)
        got = flat(imu_scan.imu_propagate(s, w, a, g, calib))
        torch.cuda.synchronize()
        want = flat(imu.propagate_wire_plain(s, w, a, g, calib))
        err = max(float((x - y).abs().max()) for x, y in zip(got, want))
        again = flat(imu_scan.imu_propagate(s, w, a, g, calib))
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        ms = time_ms(lambda: imu_scan.imu_propagate(s, w, a, g, calib))
        plain_ms = event_ms(lambda: imu.propagate_wire_plain(s, w, a, g, calib),
                            reps=5 if B <= 64 else 1)
        bound_ms, bound_by = imu_bound_ms(B, nv)
        print(f"imu_propagate B={B} ({nv} valid pairs): max_abs_err={err:.3g} against the "
              f"plain loop, two launches bit-equal {same}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}; the chain is {B} "
              f"dependent steps), library none; {nvidia_smi_line()}")
        if not (err <= 1e-10 and same):
            raise AssertionError(f"imu_propagate B={B}: {err} from the plain loop, "
                                 f"repeatable {same}")
        res[B] = {"valid_pairs": nv, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by}
    return res


def kernel_phase(dev, n=16384, m=27):
    """knn5_plane against knn5_plane_plain on seeded blocks at the main
    path's shape, M = 27, and at M = 125 with a ragged last slab (N - 5
    queries): bit-exact, so also within the contract. These launches are
    not the path's."""
    from fastlivo_tpu_torch.ops import knn_plane

    err = 0.0
    for mm, nn in ((m, n), (125, n - 5)):
        cand, found, q = (torch.from_numpy(a).to(dev) for a in random_block(nn, mm))
        got = knn_plane.knn5_plane(cand, found, q)
        torch.cuda.synchronize()
        want = knn_plane.knn5_plane_plain(cand, found, q)
        err = max(err, knn5_contract(got, want, min_both=nn // 4))
        exact = all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"knn5_plane random block N={nn} M={mm}: contract ok, bit-exact {exact}, "
              f"max_abs_err={err:.3g}")
        if not exact:
            raise AssertionError(f"knn5_plane M={mm} is not bit-exact")
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


def check_composition(counts, fused, pairs, where):
    """In a run of the fused composition every (fused, standalone) kernel
    pair launched only its fused kernel; in one of the unfused composition
    only its standalone kernel."""
    for fk, sk in pairs:
        on, off = (fk, sk) if fused else (sk, fk)
        if counts[on] == 0 or counts[off] != 0:
            raise AssertionError(f"{where}: {counts[on]} launches of {on}, "
                                 f"{counts[off]} of {off}")


@contextlib.contextmanager
def plain_propagation():
    """IMU propagation as the plain loop (imu.propagate_plain, ~150 small
    kernels per pair), as the paths ran it before imu_propagate.cu."""
    from fastlivo_tpu_torch import imu

    with swapped(imu, "propagate_wire", imu.propagate_wire_plain), \
            swapped(imu, "propagate", imu.propagate_plain):
        yield


@contextlib.contextmanager
def photometric_host_loop():
    """The photometric cascade as the paths ran it before
    photometric_cascade.cu: the host loop vio.photometric_loop, one
    photometric_err_H launch and the f64 step in torch ops
    (photometric_step_plain) per iteration, two flags read back
    (scripts/torch_lidar_frame_ab.py runs the LIVO path both ways)."""
    from fastlivo_tpu_torch import vio
    from fastlivo_tpu_torch.ops import photometric

    with swapped(vio, "photometric_cascade", vio.photometric_loop), \
            swapped(vio, "photometric_step", photometric.photometric_step_plain):
        yield


@contextlib.contextmanager
def timed_camera_frames(vio, cam_ms: list):
    """Append the host wall (ms) of each Vio.update that runs the frame
    step, its stats read included, to cam_ms."""
    update = vio.update

    def timed(*a):
        steps = vio.steps
        t0 = time.perf_counter()
        out = update(*a)
        if vio.steps > steps:
            cam_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    vio.update = timed
    try:
        yield
    finally:
        vio.update = update


@contextlib.contextmanager
def lio_host_loop():
    """The LIO EKF as the paths ran it before lio_cascade.cu: the host loop
    lio.lio_loop on every map, one search launch an iteration with search
    and the f64 step in torch ops (photometric_step_plain), one flag read
    an iteration."""
    from fastlivo_tpu_torch import lio
    from fastlivo_tpu_torch.ops import photometric

    with swapped(lio, "cascade_applies", lambda *a, **kw: False), \
            swapped(lio, "photometric_step", photometric.photometric_step_plain):
        yield


@contextlib.contextmanager
def unfused():
    """The paths as they ran before the fused kernels, the IMU kernel and
    the two cascades: the LIO EKF as the host loop (lio_host_loop) with
    its search the map's knn_candidates + the standalone knn5_plane kernel
    (tiled, hash and dense), the photometric cascade as the host loop with
    each measurement the plain body sampling through the standalone
    patches_and_grads kernel and each step photometric_step_plain, IMU
    propagation as the plain loop, the camera frame's selection and map
    upkeep as their torch code (no vio_select, no vio_observations), the
    box delete, the voxel filter's key pass and centroid, the map insert,
    the undistortion, the camera cloud's voxel dedup and the image-pool
    push as their torch code (no tiled_delete_boxes, no voxel_sort, no
    voxel_centroids, no tiled_insert_*, no undistort, no vio_dedup, no
    vio_push)."""
    from fastlivo_tpu_torch import imu as imu_mod
    from fastlivo_tpu_torch import lio, vio
    from fastlivo_tpu_torch import visual_map as vmap_mod
    from fastlivo_tpu_torch.ops import knn_plane, photometric
    from fastlivo_tpu_torch.ops import tiled_map as tm
    from fastlivo_tpu_torch.ops import voxel_filter as vf

    def search(m, pw, radius, threshold, max_probe):
        mod = lio.map_module(m)
        return knn_plane.knn5_plane(*mod.knn_candidates(m, pw, radius, max_probe), pw,
                                    threshold)

    with contextlib.ExitStack() as stack:
        stack.enter_context(lio_host_loop())
        stack.enter_context(swapped(lio, "knn5_plane_search", search))
        stack.enter_context(photometric_host_loop())
        stack.enter_context(swapped(vio, "photometric_err_H",
                                    photometric.photometric_err_H_plain))
        stack.enter_context(unsampled_plain())
        stack.enter_context(plain_propagation())
        stack.enter_context(swapped(vio, "frame_kernels_apply", lambda *a, **kw: False))
        stack.enter_context(swapped(tm, "delete_boxes", tm.delete_boxes_plain))
        stack.enter_context(swapped(vf, "voxel_centroids", vf.voxel_centroids_plain))
        stack.enter_context(swapped(tm, "insert", lambda m, p, v, max_probe=0:
                                    tm.insert_plain(m, p, v)))
        stack.enter_context(swapped(imu_mod, "undistort", imu_mod.undistort_plain))
        stack.enter_context(swapped(vf, "_sorted_keys", vf._sorted_keys_plain))
        stack.enter_context(swapped(vio, "_dedup_voxels", vio._dedup_voxels_plain))
        stack.enter_context(swapped(vmap_mod, "push_image", vmap_mod.push_image_plain))
        yield


def spy(module, name, calls: list):
    """Record the arguments of every call of module.<name>."""
    real = getattr(module, name)

    def wrapped(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    return swapped(module, name, wrapped)


@contextlib.contextmanager
def recorded_boxes(pipe, sets: list):
    """Append the boxes (B, 2, 3) f32 of every tracker update that the
    pipeline deletes (the map built); the counted wrapper
    tiled_map.delete_boxes itself is not replaced."""
    tracker = pipe.tracker
    update = tracker.update

    def wrapped(pos):
        boxes = update(pos)
        if boxes and pipe.map_built:
            sets.append(np.asarray(boxes, np.float32))
        return boxes

    tracker.update = wrapped
    try:
        yield
    finally:
        tracker.update = update


@contextlib.contextmanager
def recorded_calls(module, rec: dict, name="voxel_downsample_device", first=False):
    """Count the calls of module.<name> in rec["n"] and keep the last
    one's arguments in rec["last"]: a reference while the context is open
    (nothing copied or read in a timed window), its tensors copied on the
    card when it closes; with `first`, the first call's arguments copied
    on the card in rec["first"] when it is made. Never a counted kernel
    wrapper: each counts through its own module-level name."""
    real = getattr(module, name)
    rec.setdefault("n", 0)
    cp = lambda v: v.clone() if isinstance(v, torch.Tensor) else v  # noqa: E731

    def wrapped(*a, **kw):
        rec["n"] += 1
        rec["last"] = (a, kw)
        if first and "first" not in rec:
            rec["first"] = ([cp(v) for v in a], {k: cp(v) for k, v in kw.items()})
        return real(*a, **kw)

    with swapped(module, name, wrapped):
        yield
    if "last" in rec:
        a, kw = rec["last"]
        rec["last"] = ([cp(v) for v in a], {k: cp(v) for k, v in kw.items()})


@contextlib.contextmanager
def recorded_cascades(calls: list):
    """Record every photometric_cascade call of the paths (vio's) as
    (arguments, outputs), the outputs left on the card: no host read."""
    from fastlivo_tpu_torch import vio

    real = vio.photometric_cascade

    def wrapped(*a):
        out = real(*a)
        calls.append((a, out))
        return out

    with swapped(vio, "photometric_cascade", wrapped):
        yield


def check_cascades(calls, label) -> dict:
    """Each recorded cascade against the host loop vio.photometric_loop on
    its own inputs, after the path's run (these launches are not the
    path's; the counts are restored): with the step kernel every output
    bit-equal, with photometric_step_plain the same iterations, rot and x
    within 1e-9 and G within 1e-9 of its largest entry. Returns numbers."""
    from fastlivo_tpu_torch import vio
    from fastlivo_tpu_torch.ops import photometric as ph

    counts = read_counts()
    iters, pose_d, g_d = [], 0.0, 0.0
    for k, (a, out) in enumerate(calls):
        its = int(out[5])
        loop = vio.photometric_loop(*a)
        same = loop[5] == its and all(torch.equal(x, y) for x, y in zip(out[:5], loop[:5]))
        with swapped(vio, "photometric_step", ph.photometric_step_plain):
            plain = vio.photometric_loop(*a)
        d = max(float((out[0] - plain[0]).abs().max()), float((out[1] - plain[1]).abs().max()))
        g = float((out[2] - plain[2]).abs().max())
        scale = float(plain[2].abs().max())
        if not (same and plain[5] == its and d <= 1e-9 and g <= 1e-9 * scale):
            raise AssertionError(f"{label} cascade {k}: {its} iterations, the host loop "
                                 f"{loop[5]} (bit-equal {same}), with the plain step "
                                 f"{plain[5]}, pose {d:.3g}, G {g:.3g} of {scale:.3g}")
        iters.append(its)
        pose_d, g_d = max(pose_d, d), max(g_d, g / max(scale, 1e-300))
    for fn in counted_wrappers():
        fn.launches = counts[fn.__name__]
    nums = {"cascades": len(calls), "iterations": sum(iters),
            "iterations_min_max": [min(iters, default=0), max(iters, default=0)],
            "bit_equal_to_the_host_loop": True, "plain_step_pose_max_diff": pose_d,
            "plain_step_G_max_rel_diff": g_d}
    print(f"{label}: {len(calls)} photometric_cascade calls, {sum(iters)} iterations "
          f"({nums['iterations_min_max']} a call), each bit-equal to the host loop with the "
          f"step kernel and of equal iterations with photometric_step_plain (pose within "
          f"{pose_d:.3g}, G within {g_d:.3g} of its largest entry)")
    return nums


def search_snapshot(m):
    """A copy on the card of the arrays the LIO search reads of a tiled,
    hash or dense map."""
    from fastlivo_tpu_torch.ops import tiled_map as tm

    if isinstance(m, tm.TiledMap):
        return m._replace(dir_check=m.dir_check.clone(), dir_slot=m.dir_slot.clone(),
                          cell_check=m.cell_check.clone(), pts=m.pts.clone())
    return m._replace(check=m.check.clone(), pts=m.pts.clone())


def reserve_snapshots(m, n: int):
    """Leave n copies' worth of the map's search arrays (search_snapshot)
    in the caching allocator, allocated and freed here, so that
    recorded_lio's copies inside a timed run take cached blocks instead of
    waiting on cudaMalloc (a copy of the shipped tiled map is 143 MB)."""
    snaps = [search_snapshot(m) for _ in range(n)]
    del snaps


@contextlib.contextmanager
def recorded_lio(calls: list):
    """Record every lio_cascade call of the paths (lio's) as (arguments,
    outputs): the map's search arrays copied on the card first (the insert
    after the EKF writes the map in place), the outputs left there; no
    host read."""
    from fastlivo_tpu_torch import lio

    real = lio.lio_cascade

    def wrapped(m, *a):
        snap = search_snapshot(m)
        out = real(m, *a)
        calls.append(((snap, *a), out))
        return out

    with swapped(lio, "lio_cascade", wrapped):
        yield


def map_search(a, plain_search=False):
    """The search of a lio_cascade call's arguments `a` alone, as the host
    loop runs it (lio.host_search), as a function of the world points:
    with the TLS fit the kernel that runs the cascade's walk
    (knn5_plane_tiled, knn5_plane_hashed on the hash or dense map, or,
    under cache_knn, knn5_plane on the block that the backend's
    knn_candidates gathers in torch ops at the call's start pose:
    gathered_block) or, with `plain_search`, its plain version
    (knn5_plane_plain on the map's knn_candidates or on the block: torch
    ops, bit-exact with the walk); with the reference's fit the backend's
    knn (topk_from_candidates on the block) and fit_plane_ref, torch ops
    either way."""
    from fastlivo_tpu_torch import lio

    o = cascade_options(a)
    cand, found = gathered_block(a) if o["cache_knn"] else (None, None)
    return lio.host_search(a[0], a[10], a[11], o["max_probe"], o["plane_fit"], cand, found,
                           plain_search)


def gathered_block(a):
    """The candidate block of a lio_cascade call's arguments `a` under
    cache_knn, as the host loop gathers it: the backend's knn_candidates
    (torch ops) at the world points of the start pose (a[4], a[5]), which
    the cascade's first search must write bit for bit."""
    from fastlivo_tpu_torch import lio

    m, body, rot, x, radius = a[0], a[1], a[4], a[5], a[10]
    return lio.map_module(m).knn_candidates(m, lio.world_points(body, rot, x[0:3]), radius,
                                            cascade_options(a)["max_probe"])


def cascade_options(a) -> dict:
    """The options of a lio_cascade call's arguments `a` past the
    convergence thresholds (max_probe, cache_knn, plane_fit), each its
    default where `a` stops."""
    names = ("max_probe", "cache_knn", "plane_fit")
    return {"max_probe": 12, "cache_knn": False, "plane_fit": "tls",
            **dict(zip(names, a[14:17]))}


def with_options(a, **options):
    """A lio_cascade call's arguments `a` with some of its options changed."""
    return (*a[:14], *{**cascade_options(a), **options}.values())


def lio_loop_on(a, plain_search=False):
    """lio.lio_loop on a lio_cascade call's arguments `a`, its search
    map_search(a, plain_search)."""
    from fastlivo_tpu_torch import lio

    return lio.lio_loop(map_search(a, plain_search), *a[1:10])


def lio_same(out, loop) -> bool:
    """A lio_cascade's outputs bit-equal to a host loop's, iterations too."""
    return loop[6] == int(out[6]) and all(torch.equal(x, y) for x, y in zip(out[:6], loop[:6]))


def max_abs_diff(got, want) -> float:
    """The largest |got - want| over pairs of tensors of any dtype."""
    return max((float((x.double() - y.double()).abs().max()) for x, y in zip(got, want)
                if x.numel()), default=0.0)


def check_lio_cascades(calls, label) -> dict:
    """Each recorded LIO cascade against the host loop lio.lio_loop on its
    own inputs, after the path's run (these launches are not the path's;
    the counts are restored): with the step kernel every output (rot, x,
    G, sel, pabcd, plane_ok, iterations) bit-equal, the loop's search
    (map_search) the kernel that runs the cascade's walk (knn5_plane_tiled,
    knn5_plane_hashed, or under cache_knn knn5_plane on the block that
    knn_candidates gathers in torch ops; with the reference's fit the
    backend's knn or topk_from_candidates and fit_plane_ref) and also its
    plain version (torch ops, so the walk is
    held against plain code at every iteration's pose); all plain (that
    search and photometric_step_plain) the same iterations and rot and x
    within 1e-9. Returns numbers."""
    from fastlivo_tpu_torch import lio
    from fastlivo_tpu_torch.ops import photometric as ph

    counts = read_counts()
    iters, err, pose_d = [], 0.0, 0.0
    for k, (a, out) in enumerate(calls):
        its = int(out[6])
        loop = lio_loop_on(a)
        loop_ps = lio_loop_on(a, plain_search=True)
        same, same_ps = lio_same(out, loop), lio_same(out, loop_ps)
        e = max(max_abs_diff(out[:6], loop[:6]), max_abs_diff(out[:6], loop_ps[:6]))
        with swapped(lio, "photometric_step", ph.photometric_step_plain):
            plain = lio_loop_on(a, plain_search=True)
        d = max(float((out[0] - plain[0]).abs().max()), float((out[1] - plain[1]).abs().max()))
        if not (same and same_ps and plain[6] == its and d <= 1e-9):
            raise AssertionError(f"{label} lio_cascade {k}: {its} iterations, the host loop "
                                 f"{loop[6]} (bit-equal {same}), with the plain search "
                                 f"{loop_ps[6]} (bit-equal {same_ps}; max_abs_err {e:.3g}), "
                                 f"all plain {plain[6]}, pose {d:.3g}")
        iters.append(its)
        err, pose_d = max(err, e), max(pose_d, d)
    for fn in counted_wrappers():
        fn.launches = counts[fn.__name__]
    nums = {"cascades": len(calls), "iterations": sum(iters),
            "iterations_min_max": [min(iters, default=0), max(iters, default=0)],
            "bit_equal_to_the_host_loop": True, "max_abs_err": err,
            "plain_step_pose_max_diff": pose_d}
    print(f"{label}: {len(calls)} lio_cascade calls, {sum(iters)} iterations "
          f"({nums['iterations_min_max']} a call), each bit-equal to the host loop with the "
          f"step kernel (its search the map's kernel, and its plain version) and of "
          f"equal iterations all plain (pose within {pose_d:.3g})")
    return nums


def clone_map(vm):
    return vm._replace(**{f: getattr(vm, f).clone() for f in vm._fields})


@contextlib.contextmanager
def recorded_vio(calls: list):
    """Record every camera frame's vio_select call (vio's) with a copy of
    the visual map on the card, the image pool included (the next frames
    write it in place), and the same frame's vio_observations arguments
    and outputs (the map it starts from is that copy: vio_select writes no
    map field). No host read."""
    from fastlivo_tpu_torch import vio

    real_sel, real_obs = vio.vio_select, vio.vio_observations
    seen = [0]

    def sel(vm, *a, **kw):
        frame = seen[0]
        seen[0] += 1
        snap = clone_map(vm)
        out = real_sel(vm, *a, **kw)
        calls.append({"select": (snap, a, kw, out), "frame": frame})
        return out

    def obs(vm, *a):
        out = real_obs(vm, *a)
        if calls and "obs" not in calls[-1]:
            calls[-1]["obs"] = (a, out)
        return out

    with swapped(vio, "vio_select", sel), swapped(vio, "vio_observations", obs):
        yield


def bits_diff(x, y) -> float:
    """0.0 where x and y have equal bits (NaN where both are NaN), else the
    largest |x - y| (inf for a shape, type or NaN mismatch)."""
    if x.shape != y.shape or x.dtype != y.dtype:
        return float("inf")
    if not x.dtype.is_floating_point:
        return float((x.long() - y.long()).abs().max()) if x.numel() else 0.0
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
    same = (x.view(bits) == y.view(bits)) | (torch.isnan(x) & torch.isnan(y))
    if bool(same.all()):
        return 0.0
    if bool((torch.isnan(x) != torch.isnan(y)).any()):
        return float("inf")
    return float((x.double() - y.double()).abs().max())


def check_vio_calls(calls, label) -> dict:
    """Each recorded camera frame after the path's run (these launches
    are not the path's; the counts are restored): vio_select against
    vio_select_plain on its copy of the map, every output bit-equal; then
    vio_observations launched again on one copy of that map and its plain
    version on another, every map field, the pixels and the scores
    bit-equal, and the replayed launch's pixels, scores and point count
    equal to the path's own. Returns numbers."""
    from fastlivo_tpu_torch.ops import vio_observations as vo
    from fastlivo_tpu_torch.ops import vio_select as vs
    from fastlivo_tpu_torch.vio import TrackedSet
    from fastlivo_tpu_torch.visual_map import VisualMap

    counts = read_counts()
    err, tracked, added, frames = 0.0, 0, 0, []
    for k, rec in enumerate(calls):
        snap, a, kw, out = rec["select"]
        plain = vs.vio_select_plain(snap, *a, **kw)
        names = list(TrackedSet._fields) + ["new_pos", "new_px", "new_score", "new_add",
                                            "rcw", "pcw"]
        d = {n: bits_diff(x, y) for n, x, y in zip(
            names, [*out[0], *out[1], *out[2]], [*plain[0], *plain[1], *plain[2]])}
        oa, oout = rec["obs"]
        got = vo.vio_observations(clone_map(snap), *oa)
        want = vo.vio_observations_plain(clone_map(snap), *oa)
        d.update({f: bits_diff(getattr(got[0], f), getattr(want[0], f))
                  for f in VisualMap._fields})
        d.update(opc=bits_diff(got[1], want[1]), oscore=bits_diff(got[2], want[2]),
                 rcw2=bits_diff(got[3][0], want[3][0]), pcw2=bits_diff(got[3][1], want[3][1]),
                 path_opc=bits_diff(oout[1], got[1]), path_oscore=bits_diff(oout[2], got[2]),
                 path_n_pts=bits_diff(oout[0].n_pts, got[0].n_pts),
                 path_pcw2=bits_diff(oout[3][1], got[3][1]))
        bad = {n: v for n, v in d.items() if v != 0.0}
        if bad:
            raise AssertionError(f"{label} camera frame {rec['frame']}: not bit-equal to the "
                                 f"plain versions: {bad}")
        tracked += int(out[0].valid.sum())
        added += int(out[1][3].sum())
        frames.append(rec["frame"])
        err = max(err, max(d.values()))
    for fn in counted_wrappers():
        fn.launches = counts[fn.__name__]
    nums = {"camera_frames_checked": len(calls), "frames": frames, "tracked": tracked,
            "added": added, "bit_equal_to_plain": True, "max_abs_err": err}
    print(f"{label}: vio_select and vio_observations of {len(calls)} camera frames "
          f"({tracked} cells tracked, {added} points added) bit-equal to their plain "
          f"versions on copies of the map")
    return nums


def need_vio(label, launches, steps):
    """One vio_select and one vio_observations launch per camera frame step."""
    if not launches["vio_select"] == launches["vio_observations"] == steps:
        raise AssertionError(f"{label}: launches {launches}, want one vio_select and one "
                             f"vio_observations for each of {steps} camera steps")


def need_cascade(label, launches, ekfs=None):
    """The LIO EKF on one card: lio_cascade launched (once per EKF where
    their number `ekfs` is given), knn5_plane_tiled never."""
    n = launches["lio_cascade"]
    if n == 0 or launches["knn5_plane_tiled"] or (ekfs is not None and n != ekfs):
        raise AssertionError(f"{label}: launches {launches}, want one lio_cascade for each "
                             f"of {ekfs} EKFs and no knn5_plane_tiled")


def cloned(v):
    if isinstance(v, torch.Tensor):
        return v.clone()
    return tuple(map(cloned, v)) if isinstance(v, tuple) else v


@contextlib.contextmanager
def recorded_all(module, name, calls: list):
    """Append every call of module.<name> as (arguments, outputs), each
    tensor copied on the card: no host read. Never a counted kernel
    wrapper (each counts through its own module-level name): the voxel
    keys and their sort are recorded through `voxel_filter._sorted_keys`,
    the dedup through `vio._dedup_voxels` (the insert's keys and sort
    through recorded_insert_sorts)."""
    real = getattr(module, name)

    def wrapped(*a, **kw):
        out = real(*a, **kw)
        calls.append((cloned(a), cloned(kw), cloned(out)))
        return out

    with swapped(module, name, wrapped):
        yield


@contextlib.contextmanager
def recorded_insert_sorts(calls: list):
    """Append every tiled_map._sorted_keys call (the insert's keys and
    their sort) as ((map, pts, valid), {}, outputs), the points, mask and
    outputs copied on the card, the map itself not: the sort reads only
    its voxel size and directory dims, which no insert changes. No host
    read."""
    from fastlivo_tpu_torch.ops import tiled_map as tm

    real = tm._sorted_keys

    def wrapped(m, pts, valid):
        out = real(m, pts, valid)
        calls.append(((m, pts.clone(), valid.clone()), {}, cloned(out)))
        return out

    with swapped(tm, "_sorted_keys", wrapped):
        yield


PUSH_FIELDS = ("obs_slot", "obs_fid", "n_pts", "img_fid")


@contextlib.contextmanager
def recorded_pushes(calls: list):
    """Append every visual_map.push_image call of one card's map (no slab
    layout): the fields the push reads, copied before it (the rings, the
    point count, the pool's ids), the image and the frame id, and the
    pool's ids after it. No host read."""
    from fastlivo_tpu_torch import visual_map as vmap_mod

    real = vmap_mod.push_image

    def wrapped(m, img, fid, mesh=None):
        if mesh is not None:
            return real(m, img, fid, mesh)
        before = {f: getattr(m, f).clone() for f in PUSH_FIELDS}
        out = real(m, img, fid, mesh)
        calls.append({"before": before, "img": img.clone(), "fid": cloned(fid),
                      "after": out.img_fid.clone(), "dtype": m.imgs.dtype})
        return out

    with swapped(vmap_mod, "push_image", wrapped):
        yield


def push_map(rec, pool):
    """A map for one recorded push: its rings, point count and pool ids as
    the push found them, `pool` (a copy) for the images."""
    from fastlivo_tpu_torch import visual_map as vmap_mod

    b = rec["before"]
    NP, KO = b["obs_fid"].shape
    empty = vmap_mod.empty_visual_map(n_points=1, n_obs=1, table_size=1, voxel_cap=1, ring=1,
                                      height=1, width=1, device=pool.device)
    return empty._replace(**{f: b[f].clone() for f in PUSH_FIELDS}, imgs=pool.clone())


def check_stage_calls(keys, dedups, pushes, isorts, label) -> dict:
    """The path's recorded voxel sorts, dedups, pushes and insert sorts
    after its run (these launches are not the path's; the counts are
    restored): each voxel sort replayed by voxel_sort and by
    _sorted_keys_plain on its inputs, keys and order bit-equal to each
    other and to the path's, and its key pass by voxel_keys, bit-equal to
    voxel_keys_plain; each insert sort replayed by insert_sort and by
    insert_sort_plain (insert_keys_plain and torch.sort) on its inputs (the
    map's voxel size and directory), sorted keys, order and rows bit-equal
    to each other and to the path's; each dedup replayed
    by vio_dedup and vio._dedup_voxels_plain, bit-equal to each other and
    to the path's outputs; each push replayed
    by vio_push and visual_map.push_image_plain on copies of one pool (as
    the push found the rings and ids), img_fid and imgs bit-equal, the
    pool ids the path's. Returns numbers."""
    from fastlivo_tpu_torch import vio
    from fastlivo_tpu_torch import visual_map as vmap_mod
    from fastlivo_tpu_torch.ops import tiled_map as tm
    from fastlivo_tpu_torch.ops import vio_dedup, vio_push
    from fastlivo_tpu_torch.ops import voxel_filter as vf

    counts = read_counts()
    bad = []
    for k, (a, kw, out) in enumerate(isorts):
        got = tm.insert_sort(*a, **kw)
        want = tm.insert_sort_plain(*a, **kw)
        if not all(torch.equal(x, y) and torch.equal(x, z) for x, y, z in zip(got, want, out)):
            bad.append(f"insert sort {k}")
    for k, (a, kw, out) in enumerate(keys):
        got = vf.voxel_sort(*a, **kw)
        want = vf._sorted_keys_plain(*a, **kw)
        if not all(torch.equal(x, y) and torch.equal(x, z) for x, y, z in zip(got, want, out)):
            bad.append(f"sort {k}")
        if not torch.equal(vf.voxel_keys(*a, **kw), vf.voxel_keys_plain(*a, **kw)):
            bad.append(f"key pass {k}")
    for k, (a, kw, out) in enumerate(dedups):
        got = vio_dedup.vio_dedup(*a, **kw)
        want = vio._dedup_voxels_plain(*a, **kw)
        if not all(torch.equal(x, y) and torch.equal(x, z) for x, y, z in zip(got, want, out)):
            bad.append(f"dedup {k}")
    pool = None
    for k, rec in enumerate(pushes):
        if pool is None or pool.shape[1:] != rec["img"].shape or pool.dtype != rec["dtype"]:
            pool = torch.zeros((rec["after"].shape[0], *rec["img"].shape), dtype=rec["dtype"],
                               device=rec["img"].device)
        m1, m2 = push_map(rec, pool), push_map(rec, pool)
        vio_push.vio_push(m1, rec["img"], rec["fid"])
        vmap_mod.push_image_plain(m2, rec["img"], rec["fid"])
        if not (torch.equal(m1.img_fid, m2.img_fid) and torch.equal(m1.imgs, m2.imgs)
                and torch.equal(m1.img_fid, rec["after"])):
            bad.append(f"push {k}")
        del m1, m2
    torch.cuda.synchronize()
    for fn in counted_wrappers():
        fn.launches = counts[fn.__name__]
    if bad:
        raise AssertionError(f"{label}: not bit-equal to the plain versions: {bad}")
    nums = {"sorts_checked": len(keys), "dedups_checked": len(dedups),
            "pushes_checked": len(pushes), "insert_sorts_checked": len(isorts),
            "bit_equal_to_plain": True, "max_abs_err": 0.0}
    print(f"{label}: {len(keys)} voxel sorts (and their key passes), {len(isorts)} insert "
          f"sorts, {len(dedups)} voxel dedups and {len(pushes)} image-pool pushes replayed by "
          f"their kernels and plain versions, bit-equal to each other and to the path's")
    return nums


# the flat maps' write kernels (the hash map's and the dense grid's), by
# their wrappers' names
FLAT_KERNELS = ("hash_insert_keys", "hash_insert_probe", "dense_insert", "flat_delete_boxes")


def flat_plain() -> list:
    """(module, name) of the flat maps' plain write versions, which a map
    on the card never runs."""
    from fastlivo_tpu_torch.ops import dense_map, voxel_map

    return [(voxel_map, n) for n in ("insert_keys_plain", "insert_probe_plain", "sort_order",
                                     "insert_heads_plain", "insert_heads_probe_plain",
                                     "_probe_rounds", "delete_boxes_plain")] + [
        (dense_map, "insert_plain")]


def counted_wrappers():
    """Every kernel wrapper of the port, each with its launch count."""
    from fastlivo_tpu_torch.ops import imu_scan, knn_plane, lio_cascade, patches_grads
    from fastlivo_tpu_torch import imu
    from fastlivo_tpu_torch.ops import photometric, tiled_map, vio_observations, vio_select
    from fastlivo_tpu_torch.ops import dense_map, vio_dedup, vio_push, voxel_filter, voxel_map

    return (knn_plane.knn5_plane_tiled, knn_plane.knn5_plane_hashed, knn_plane.knn5_plane,
            photometric.photometric_err_H, photometric.photometric_cascade,
            photometric.photometric_step, patches_grads.patches_and_grads,
            imu_scan.imu_propagate, lio_cascade.lio_cascade, vio_select.vio_select,
            vio_observations.vio_observations, tiled_map.delete_boxes,
            voxel_filter.voxel_centroids, tiled_map.insert_keys, tiled_map.insert_tiles,
            imu.undistort, voxel_map.hash_insert_keys, voxel_map.hash_insert_probe,
            dense_map.dense_insert, voxel_map.flat_delete_boxes, voxel_filter.voxel_keys,
            vio_dedup.vio_dedup, vio_push.vio_push, voxel_filter.voxel_sort,
            tiled_map.insert_sort)


def reset_counts():
    from fastlivo_tpu_torch.ops import lio_cascade

    for fn in counted_wrappers():
        fn.launches = 0
    for counts in (lio_cascade.lio_cascade.by_map, lio_cascade.lio_cascade.by_search,
                   lio_cascade.lio_cascade.by_fit):
        for k in counts:
            counts[k] = 0


def read_counts() -> dict:
    return {fn.__name__: fn.launches for fn in counted_wrappers()}


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
    """Least time for the fused search on these inputs: the queries (12 B)
    read and 21 B written per query, and the map bytes of tiled_work, over
    HBM bandwidth; against tiled_work's operations over the float32 rate.
    Returns (ms, "bytes" | "operations", the distinct directory entries,
    pool cells, live points and tiles)."""
    map_bytes, ops, uniq = tiled_work(m, q, radius)
    nbytes = q.shape[0] * (12 + 21) + map_bytes
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), uniq


def tiled_work(m, q, radius: int = 1):
    """The map bytes and the operations of the tiled search of the queries
    q: each distinct directory entry (8 B), pool-cell hash behind a
    matching entry (4 B) and live point (12 B) that the neighbourhoods
    touch, and the offsets, read once; the operations these inputs need,
    counted from knn5_tiled_walk.cuh (integer operations run no faster
    than float32 ones): per query its voxel (6) and the fit and gate of
    plane_fit.cuh (260); per candidate row its voxel, tile, cell and
    directory indices (20), the directory test and slot clamp (3) and one
    compare in each of the 5 selection rounds; per row whose tile is in
    the directory the pool index and cell test (3); per live row its
    squared distance (8); the 31-bit tile hash (30) once per distinct tile
    of a neighbourhood. Returns (map bytes, operations, the distinct
    directory entries, pool cells, live points and tiles)."""
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
    map_bytes = uniq[0] * 8 + uniq[1] * 4 + uniq[2] * 12 + M * 12
    ops = (n * (6 + 260) + n * M * (20 + 3 + 5) + 3 * int(tile_ok.sum())
           + 8 * int(live.sum()) + 30 * tiles)
    return map_bytes, ops, uniq


# f32 operations of one row of one LIO cascade iteration (lio_cascade.cu,
# counted from its source): the world point (18), the plane distance (6),
# the s score (4), the gates (4), Rᵀn (15), the cross product (9), z (1),
# the weighted row (6), its 42 products and their share of the chunk tree
# (42)
LIO_ROW_OPS = 147


# f64 operations of one reference plane fit (plane_fit.cuh's plane5_fit_ref,
# counted from its source): the 15 picks widened, AᵀA and Aᵀb (66), the
# negation (3), the cofactors (27), det and its guard (9), the solve (18),
# |n| and d (9), the normal (3), the finite tests (4), the five distances
# and their gates (40), the casts down (4), the norm gate (1)
REF_FIT_OPS = 199
TLS_FIT_OPS = 260  # f32 operations of plane5_fit (tiled_work, hashed_work, cached_work)


def cached_work(cand, found, q):
    """The cached walk's work (knn5_cached_walk.cuh) for the queries q
    (the stacked world points of the searches that re-rank the block, each
    of the block's rows n once per search): the block's bytes (12 B a
    candidate and its found byte: N·M·13 B); per query the fit and gate (TLS_FIT_OPS),
    per candidate row its found test and one compare in each of the 5
    selection rounds (6), per found row its squared distance (8). Returns
    (bytes, operations, (candidates, found rows))."""
    n, M = found.shape
    searches = q.shape[0] // max(n, 1)
    nfound = int(found.sum())
    ops = searches * (n * TLS_FIT_OPS + n * M * 6 + 8 * nfound)
    return cand.numel() * 4 + found.numel(), ops, (n * M, nfound)


def lio_cascade_bound_ms(m, pws, n, iters, radius, max_probe=12, cache_knn=False,
                         plane_fit="tls"):
    """Least time for one LIO cascade on these inputs: `pws` are the world
    points of each of its search iterations, stacked (the host loop's on
    the same inputs), n the scan's points, `iters` its iterations. Bytes:
    the map entries all the searches touch (tiled_work, or hashed_work on
    the hash or dense map, over the stacked points: the union of the
    searches' entries) or, under cache_knn, those of the first search and
    the candidate block it writes (13 B a candidate: cached_work) written
    once and read again at each later search; each point's p_imu,
    |p|^(1/2) and mask (17 B), P', the prior and the start pose read once;
    sel, the plane and plane_ok (18 B a point), rot, x, G and the count
    written once. Operations: the searches' (tiled_work, hashed_work; under
    cache_knn the first search's walk and the later searches' re-ranks,
    cached_work) and each iteration's rows (LIO_ROW_OPS) over the float32
    rate, plus each iteration's f64 step (STEP_OPS) over the f64 rate; with
    the reference's fit each search's fits are REF_FIT_OPS f64 operations a
    query in place of the TLS fit's f32 ones. Returns (ms, "bytes" |
    "operations", the entries the searches touch: tiled_work's directory
    entries, pool cells, live points and tiles, or hashed_work's probed
    words, found points, probes taken and found rows; under cache_knn
    those of the first search, then the block's candidates and found
    rows)."""
    from fastlivo_tpu_torch import lio
    from fastlivo_tpu_torch.ops import tiled_map as tm

    def walk(q):
        if isinstance(m, tm.TiledMap):
            return tiled_work(m, q, radius)
        return hashed_work(m, q, radius, max_probe)

    if cache_knn:
        first = pws[:n]
        map_bytes, ops32, uniq = walk(first)
        cand, found = lio.map_module(m).knn_candidates(m, first, radius, max_probe)
        block_bytes, rerank_ops, block = cached_work(cand, found, pws[n:])
        map_bytes += block_bytes * (pws.shape[0] // max(n, 1))
        ops32 += rerank_ops
        uniq = (*uniq, *block)
    else:
        map_bytes, ops32, uniq = walk(pws)
    ops64 = iters * STEP_OPS
    if plane_fit == "ref":
        ops32 -= pws.shape[0] * TLS_FIT_OPS
        ops64 += pws.shape[0] * REF_FIT_OPS
    nbytes = (map_bytes + n * (17 + 18) + (324 + 2 * (9 + 15)) * 8 + (9 + 15 + 108) * 8
              + 4)
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = (ops32 + iters * n * LIO_ROW_OPS) / F32_OPS_PER_S + ops64 / F64_OPS_PER_S
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
    taps, ops = photometric_taps_ops(args)
    G, P = args[1].shape[0], args[13]
    nbytes = taps.numel() * 4 + G * (P * P * 4 + 12 + 4 + 1 + 4) + 248 + 44 * 4
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), taps.numel()


def photometric_taps_ops(args):
    """One measurement's distinct tap pixels (flat image indices of the
    (P+3)^2 grids, from the plain version's own sampling call) and its
    float32 operations (photometric_bound_ms's count)."""
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
    taps = torch.unique(rows[:, :, None] * W + cols[:, None, :])
    per_px = (5 * 7 + 2 * 3 + 1 + 6 * 3 + 2 + {"none": 0, "huber": 6, "tukey": 9}[args[14]]
              + 48 + 43)
    return taps, G * (P * P * per_px + 48 + 18 + 132 + 12 * n * n + 44) + 75


# f64 operations of one photometric step (step_warp in
# photometric_cascade.cu, counted from its source): widening HT (42), A =
# HᵀH₆ P' + I (402), the 6x6 elimination with its 24-wide rows (1656),
# rotᵀ prior.rot and Log (65), vec (15), t (72), sol (216), G = K HᵀH₆
# (1188), Exp and rot' (105), the norms (12), x' (15)
STEP_OPS = 3788
# its bytes: P' (18, 18), the prior's and the pose's rot and x (f64), HT
# (42 f32) read; rot', x', G (f64) and the flag written
STEP_BYTES = (324 + 2 * (9 + 15)) * 8 + 42 * 4 + (9 + 15 + 108) * 8 + 1


def step_bound_ms():
    t_b, t_o = STEP_BYTES / HBM_BYTES_PER_S, STEP_OPS / F64_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def cascade_bound_ms(measurements, levels_used):
    """Least time for one cascade on these inputs: `measurements` are the
    photometric_err_H arguments of each of its iterations (the host loop's
    on the same inputs). Bytes: the distinct image pixels of all the
    iterations' tap grids, the reference patches of the levels used, each
    point's position, search level and valid flag, the pose, prior, P'
    and camera read once, and the pose, G, per-point errors, mean error and
    count written once. Operations: each iteration's float32 measurement
    (photometric_taps_ops) over the f32 rate plus its f64 step (STEP_OPS)
    over the f64 rate. Returns (ms, "bytes" | "operations", distinct
    pixels)."""
    taps, ops32 = [], 0
    for a in measurements:
        t, o = photometric_taps_ops(a)
        taps.append(t)
        ops32 += o
    n_taps = torch.unique(torch.cat(taps)).numel()
    G, P = measurements[0][1].shape[0], measurements[0][13]
    nbytes = (n_taps * 4 + levels_used * G * P * P * 4 + G * (12 + 4 + 1) + 248
              + (324 + 2 * (9 + 15)) * 8 + (9 + 15 + 108) * 8 + G * 4 + 8 + 4)
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = ops32 / F32_OPS_PER_S + len(measurements) * STEP_OPS / F64_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), n_taps


def cascade_phase(dev, a):
    """photometric_cascade on the LIVO path's last cascade call `a`, at
    every robust mode, against the host loop vio.photometric_loop on the
    same inputs: with the step kernel every output bit-equal; with
    photometric_step_plain equal iterations, rot and x within 1e-9, G
    within 1e-9 of its largest entry, perr and err within rtol 1e-5. The
    step kernel against photometric_step_plain on the call's first
    iteration (rot', x', G within 1e-12, the same flag). Times, on the
    path's own robust mode: the cascade (queued CUDA events) against the
    host loop with the kernels, with the plain step, and with everything
    plain (one call alone between two events: the loop reads two flags an
    iteration), and the host wall of a cascade call and of the loop; the
    step kernel against its plain version. These launches are not the
    path's. Returns {"cascade": numbers, "step": numbers}."""
    from fastlivo_tpu_torch import vio
    from fastlivo_tpu_torch.ops import photometric as ph

    a = list(a)
    loop = vio.photometric_loop
    err, iters = 0.0, {}
    for robust in ("none", "huber", "tukey"):
        ar = a[:18] + [robust, a[19]]
        got = ph.photometric_cascade(*ar)
        its = int(got[5])
        want = loop(*ar)
        same = want[5] == its and all(torch.equal(x, y) for x, y in zip(got[:5], want[:5]))
        with swapped(vio, "photometric_step", ph.photometric_step_plain):
            plain = loop(*ar)
        d = max(float((got[0] - plain[0]).abs().max()), float((got[1] - plain[1]).abs().max()))
        g = float((got[2] - plain[2]).abs().max()) / max(float(plain[2].abs().max()), 1e-300)
        rp = float(((got[3] - plain[3]).abs() / plain[3].abs().clamp(min=1e-30)).max())
        re = abs(float(got[4]) - float(plain[4])) / max(abs(float(plain[4])), 1e-300)
        print(f"photometric_cascade robust {robust}: {its} iterations, bit-equal to the host "
              f"loop with the step kernel {same}; with photometric_step_plain {plain[5]} "
              f"iterations, pose {d:.3g}, G {g:.3g} of max, perr rel {rp:.3g}, err rel "
              f"{re:.3g}; grid {ph.photometric_cascade.grid} blocks")
        if not (same and plain[5] == its and d <= 1e-9 and g <= 1e-9 and rp <= 1e-5
                and re <= 1e-5):
            raise AssertionError(f"photometric_cascade {robust} disagrees with the host loop")
        err = max(err, d)
        iters[robust] = its
    robust = a[18]
    its = iters[robust]
    ms = time_ms(lambda: ph.photometric_cascade(*a))
    loop_ms = event_ms(lambda: loop(*a), reps=5)
    with swapped(vio, "photometric_step", ph.photometric_step_plain):
        loop_plain_step_ms = event_ms(lambda: loop(*a), reps=5)
    with swapped(vio, "photometric_step", ph.photometric_step_plain), \
            swapped(vio, "photometric_err_H", ph.photometric_err_H_plain):
        plain_ms = event_ms(lambda: loop(*a), reps=5)
        loop_host_ms = host_ms(lambda: loop(*a))
    cascade_host_ms = host_ms(lambda: ph.photometric_cascade(*a))
    meas = []
    with spy(vio, "photometric_err_H", meas):
        loop(*a)
    bound, by, n_taps = cascade_bound_ms([list(m) for m in meas], len(set(a[15])))

    # the step on the call's first iteration
    m0 = measurement_args(a)
    HT = ph.photometric_err_H(*m0, partials=True)[0][:42].view(6, 7)
    sargs = (a[5], a[6], a[7], a[8], a[9], HT)
    got = ph.photometric_step(*sargs)
    want = ph.photometric_step_plain(*sargs)
    s_err = max(float((x - y).abs().max()) for x, y in zip(
        (got[0], got[1], got[3]), (want[0], want[1], want[3])))
    if not (s_err <= 1e-12 and bool(got[2]) == bool(want[2])):
        raise AssertionError(f"photometric_step: {s_err:.3g} from its plain version")
    s_ms = time_ms(lambda: ph.photometric_step(*sargs))
    s_plain_ms = event_ms(lambda: ph.photometric_step_plain(*sargs), reps=10)
    s_bound, s_by = step_bound_ms()
    smi = nvidia_smi_line()
    print(f"photometric_cascade G={a[1].shape[0]} P={a[16]} levels {tuple(a[15])} robust "
          f"{robust}: {its} iterations in {ms:.4f} ms ({ms / its:.4f} ms an iteration; host "
          f"{cascade_host_ms:.3f} ms a call); the host loop {loop_ms:.4f} ms with the kernels "
          f"({loop_ms / its:.4f} an iteration), {loop_plain_step_ms:.4f} with the plain step, "
          f"{plain_ms:.4f} all plain (host {loop_host_ms:.3f} ms); bound {bound:.6f} ms "
          f"({by}; {n_taps} distinct tap pixels over the iterations), library none; {smi}")
    print(f"photometric_step: max_abs_err={s_err:.3g} against its plain version; kernel "
          f"{s_ms:.4f} ms, plain {s_plain_ms:.4f} ms, bound {s_bound:.7f} ms ({s_by}), "
          f"library none; {smi}")
    return {"cascade": {"max_abs_err": err, "iterations": iters, "ms": ms,
                        "ms_per_iteration": ms / its, "host_ms": cascade_host_ms,
                        "loop_ms": loop_ms, "loop_ms_per_iteration": loop_ms / its,
                        "loop_plain_step_ms": loop_plain_step_ms, "plain_ms": plain_ms,
                        "plain_host_ms": loop_host_ms, "bound_ms": bound, "bound_by": by},
            "step": {"max_abs_err": s_err, "ms": s_ms, "plain_ms": s_plain_ms,
                     "bound_ms": s_bound, "bound_by": s_by}}


# f32 operations, counted from the kernels' expressions: a scan row's
# transform, projection and gates; its Shi-Tomasi score (64 taps x 7, three
# 63-add trees, the eigenvalue); a gathered candidate; a cell's chain (three
# 8-step undistortions, three projections, the warp), a patch pixel at one
# level and at the level-0 gates; an observation's view cosine; a tracked
# row's prep stage and its ring's eviction distances
SEL_ROW_OPS, SEL_ST_OPS, SEL_CAND_OPS = 60, 649, 60
SEL_CELL_OPS, SEL_PIXEL_OPS, SEL_OBS_OPS = 850, 30, 40
OBS_ROW_OPS, OBS_RING_OPS = 120 + 649, 20
# a kernel's pose: the state's rot (3, 3) and pos (3,) f64 and Rci, Pci
# f32 read, the camera pose rcw (3, 3), pcw (3,) f32 written
POSE_BYTES = 72 + 24 + 36 + 12 + 36 + 12


def window_pixels(H, W, px, size) -> int:
    """Distinct pixels of an H x W image under size x size windows around
    floor(px) (rows of (K, 2) pixels): the taps a kernel reads once each."""
    import torch.nn.functional as F

    ind = torch.zeros((1, 1, H, W), device=px.device)
    u = torch.clamp(torch.floor(px[:, 0]).long(), 0, W - 1)
    v = torch.clamp(torch.floor(px[:, 1]).long(), 0, H - 1)
    ind[0, 0, v, u] = 1.0
    half = size // 2
    pad = F.pad(ind, (half, size - 1 - half, half, size - 1 - half))
    return int(F.max_pool2d(pad, size, stride=1).sum())


def vio_select_bound_ms(snap, a, kw, out):
    """The least time of vio_select on a recorded call (bytes, each input
    read once, each output written once, counted from this call's data:
    the scan cloud and voxel set; the image pixels under the in-frame
    rows' 10x10 Shi-Tomasi windows and the tracked cells' (P+1)^2 current
    patches; the voxel slots probed up to the first hit, the found slots'
    counts and index rows, the valid candidates' positions and values;
    the candidate cells' winners, their KO-entry rings and image ids and
    3 x (P+1)^2 pool taps; the state's pose, the extrinsics and the
    outputs, the camera pose among them) over HBM bandwidth, against the
    f32 operations (the SEL_* counts) over the f32 rate. Returns (ms,
    "bytes" or "operations", bytes, operations)."""
    from fastlivo_tpu_torch import camera as cam_mod
    from fastlivo_tpu_torch import vio as vio_mod
    from fastlivo_tpu_torch import visual_map as vmap_mod
    from fastlivo_tpu_torch.ops.photometric import _rows_times
    from fastlivo_tpu_torch.ops.voxel_map import _slot_check

    cam, _, _, _, _, img, pg, pg_mask, vox, vox_mask = a[:10]
    rcw, pcw = out[2]
    P, G = kw["patch_size"], kw["gw"] * kw["gh"]
    H, W = img.shape
    M, Nv = pg.shape[0], vox.shape[0]
    T, VC = snap.vox_idx.shape
    KO = snap.obs_fid.shape[1]
    pool_b = snap.imgs.element_size()
    border = (P // 2 + 1) * 8
    p_cam = _rows_times(pg, rcw) + pcw
    pc = cam_mod.world2cam(cam, p_cam)
    ok = pg_mask & (p_cam[:, 2] > 0) & cam_mod.is_in_frame(cam, pc, border)
    tracked, new = out[:2]
    # the candidates, and the cells that hold one
    cidx, cvalid = (t.reshape(-1) for t in vmap_mod.gather_voxel_points(snap, vox, vox_mask))
    c_cam = _rows_times(snap.pos[torch.clamp(cidx, 0, snap.pos.shape[0] - 1).long()],
                        rcw) + pcw
    cpc = cam_mod.world2cam(cam, c_cam)
    cok = cvalid & (c_cam[:, 2] > 0) & cam_mod.is_in_frame(cam, cpc, border)
    has_map = torch.zeros(G, dtype=torch.bool, device=img.device)
    has_map[vio_mod._cells(cpc[cok], kw["grid_size"], kw["gh"], G).long()] = True
    wpc = cam_mod.world2cam(cam, _rows_times(tracked.pos, rcw) + pcw)
    pix = window_pixels(H, W, torch.cat([pc[ok], wpc[has_map]]), 10)
    slot, check = _slot_check(vox, T - 1)
    probes = (slot[:, None] + torch.arange(12, device=vox.device)) & (T - 1)
    hit = snap.vox_keys[probes.long()] == check[:, None]
    found = hit.any(1) & vox_mask
    n_probe = torch.where(found, torch.argmax(hit.int(), 1) + 1, 12)[vox_mask].sum()
    n_found, n_cand, n_cells = int(found.sum()), int(cvalid.sum()), int(has_map.sum())
    n_ok = int(ok.sum())
    byts = (13 * (M + Nv) + 4 * pix + 4 * int(n_probe) + n_found * 4 * (1 + VC)
            + n_cand * 16 + n_cells * (12 + 8 + KO * 60 + 3 * (P + 1) ** 2 * pool_b)
            + G * (4 + 12 + 12 * P * P + 4 + 1 + 4 + 4 + 12 + 8 + 4 + 1) + POSE_BYTES)
    ops = (n_ok * (SEL_ROW_OPS + SEL_ST_OPS) + n_cand * SEL_CAND_OPS
           + n_cells * (SEL_CELL_OPS + 4 * P * P * SEL_PIXEL_OPS + KO * SEL_OBS_OPS))
    t_b, t_o = 1e3 * byts / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations", byts, ops


def vio_observations_bound_ms(snap, oa, out):
    """The least time of vio_observations on a recorded call: the rows'
    inputs (34 bytes a row), their points, ring ids and most recent
    observation, the image pixels under their Shi-Tomasi windows, the
    image ids (for the pool slot), the full rings' poses where a kept
    observation evicts, the kept observations' and new points' writes,
    one probed slot, the count and an index entry for each new point, the
    state's pose, the extrinsics and the outputs (the posterior camera
    pose among them), over HBM bandwidth, against the f32 operations
    (OBS_*) over the f32 rate. Returns (ms, bound_by, bytes, operations)."""
    vm2, opc = out[:2]
    img, t_idx, t_valid = oa[1], oa[6], oa[7]
    B = t_idx.shape[0]
    H, W = img.shape
    KO = snap.obs_fid.shape[1]
    R = snap.img_fid.shape[0]
    safe = torch.clamp(t_idx, 0, snap.pos.shape[0] - 1).long()
    obs_fid_after = vm2.obs_fid[safe]
    kept = (obs_fid_after != snap.obs_fid[safe]).any(1) & t_valid
    full = snap.n_obs[safe] >= KO
    n_new = int(vm2.n_pts) - int(snap.n_pts)
    n_kept, n_evict = int(kept.sum()), int((kept & full).sum())
    pix = window_pixels(H, W, opc, 10)
    byts = (34 * B + B * (12 + 4 * KO + 56 + 4) + 4 * pix + 4 * R + n_evict * KO * 48
            + n_kept * 76 + n_new * (88 + 4 + 8 + 4) + 12 * B + 4 + POSE_BYTES)
    ops = B * OBS_ROW_OPS + n_evict * KO * OBS_RING_OPS
    t_b, t_o = 1e3 * byts / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations", byts, ops


def vio_kernels_phase(rec, label="the LIVO path's last camera frame"):
    """vio_select and vio_observations timed at the main path's shapes on a
    recorded camera frame (rec: recorded_vio's), each against its plain
    version and its bound. The kernels: median of 30 queued calls between
    CUDA events (time_ms); vio_observations runs on one copy of the map,
    which each call writes again (the same rows, the rings one entry on).
    The plain versions: one call alone between two CUDA events, the device
    idle before it (event_ms: their host reads stall the queue), the
    observations' on another copy. No library call computes either. Also
    each wrapper's host wall a call (host_ms: the checks, the allocations
    and the launch, not waiting for the device).
    Returns {"vio_select": {...}, "vio_observations": {...}}."""
    from fastlivo_tpu_torch.ops import vio_observations as vo
    from fastlivo_tpu_torch.ops import vio_select as vs

    counts = read_counts()
    snap, a, kw, out = rec["select"]
    oa, oout = rec["obs"]
    res = {}
    ms = time_ms(lambda: vs.vio_select(snap, *a, **kw))
    host = host_ms(lambda: vs.vio_select(snap, *a, **kw), reps=30)
    grid = vs.vio_select.grid
    plain_ms = event_ms(lambda: vs.vio_select_plain(snap, *a, **kw), reps=10)
    bound, by, byts, ops = vio_select_bound_ms(snap, a, kw, out)
    res["vio_select"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                         "bytes": byts, "ops": ops, "grid": grid, "host_ms": host,
                         "tracked": int(out[0].valid.sum()), "added": int(out[1][3].sum())}
    after = vo.vio_observations_plain(clone_map(snap), *oa)
    m1, m2 = clone_map(snap), clone_map(snap)
    ms = time_ms(lambda: vo.vio_observations(m1, *oa))
    host = host_ms(lambda: vo.vio_observations(m1, *oa), reps=30)
    plain_ms = event_ms(lambda: vo.vio_observations_plain(m2, *oa), reps=10)
    bound, by, byts, ops = vio_observations_bound_ms(snap, oa, after)
    del after, m1, m2
    res["vio_observations"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                               "bound_by": by, "bytes": byts, "ops": ops,
                               "grid": vo.vio_observations.grid, "host_ms": host}
    for fn in counted_wrappers():
        fn.launches = counts[fn.__name__]
    smi = nvidia_smi_line()
    for name, r in res.items():
        print(f"{name} on {label}: kernel {r['ms']:.4f} ms ({r['grid']} blocks; host "
              f"{r['host_ms']:.4f} ms a call), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}: {r['bytes']} bytes, {r['ops']} f32 "
              f"operations), library none; {smi}")
    return res


KEY_ROW_OPS = 30  # a row: 3 finite tests, 3 divisions (products), floors, casts, 3 offsets,
# masks and shifts, 2 ors, the valid select
SORT_PASS_OPS = 20  # a row and pass: its rank (fields, 2 products, adds), digit, offsets,
# position, the next digit and its count
DEDUP_ROW_OPS = 40  # a row: 3 divisions, floors, casts, the hash (3 products, 2 xors, mask);
# 4 rounds of slot, atomic and winner compare; the keep test and its scan
PUSH_ENTRY_OPS = 6  # a ring entry: clamp (2), the fid test, its slot's id compared, the count
PUSH_PAIR_OPS = 4  # a pair of pool slots: two compares, an and, an or (the age rank)


def camera_stage_phase(lio_keys, rec, label="the LIVO path's last camera frame"):
    """voxel_sort, voxel_keys, vio_dedup and vio_push timed at the main
    path's shapes on the paths' recorded calls (lio_keys: the LIO path's
    last sort; rec: livo_path_phase's last sort, dedup and push), each
    against its plain version and its bound: the kernels by time_ms
    (median of 30 queued calls between CUDA events), the plain versions
    by event_ms (the dedup's and the push's plain versions read the
    host), each wrapper's host wall a call; the sort also against the
    route it replaced (the voxel_keys launch and torch.sort(stable=True),
    by time_ms and host wall) and torch.sort alone on its keys, with its
    compact rank's bits and pass count; for the push the library call
    torch.bincount(minlength=R + 1) on the refcount's targets. Also held
    bit for bit: the sort and the key pass with NaN, inf, -0.0 and
    wrapping rows on the card against their plain versions on the card and
    the CPU, the dedup on the camera cloud tiled three times (24576 rows:
    its arrays in the stream's scratch), the push in both its forms (one
    grid barrier, the launcher's choice at the shipped pool, and two) on
    the path's pool type and the other; the two-barrier form timed too. These
    launches are not the paths' (the counts are restored). Returns
    {"voxel_sort": {...}, "voxel_keys": {...}, "vio_dedup": {...},
    "vio_push": {...}}."""
    from fastlivo_tpu_torch import vio
    from fastlivo_tpu_torch import visual_map as vmap_mod
    from fastlivo_tpu_torch.ops import vio_dedup, vio_push
    from fastlivo_tpu_torch.ops import voxel_filter as vf

    counts = read_counts()
    smi = nvidia_smi_line()
    res = {}
    for src, (a, kw, _) in (("lio scan", lio_keys), ("camera cloud", rec["keys"])):
        pts, valid = a[0], a[1]
        N = pts.shape[0]
        bad, bvalid = pts.clone(), valid.clone()
        bad[:8] = float("nan")
        bad[8:16, 1] = float("inf")
        bad[16:64] = -0.0
        bad[64:72, 0] = 3e12
        bvalid[:72] = True
        for p, v in ((pts, valid), (bad, bvalid)):
            cpu_args = (p.cpu(), v.cpu(), *[None if t is None else t.cpu() for t in a[2:]])
            cpu_kw = {k: None if t is None else t.cpu() for k, t in kw.items()}
            got = vf.voxel_keys(p, v, *a[2:], **kw)
            want = vf.voxel_keys_plain(p, v, *a[2:], **kw)
            cpu = vf.voxel_keys_plain(*cpu_args, **cpu_kw)
            if not (torch.equal(got, want) and torch.equal(got.cpu(), cpu)):
                raise AssertionError(f"voxel_keys on the {src}: not bit-equal to its plain "
                                     f"version")
            got = vf.voxel_sort(p, v, *a[2:], **kw)
            want = vf._sorted_keys_plain(p, v, *a[2:], **kw)
            cpu = vf._sorted_keys_plain(*cpu_args, **cpu_kw)
            if not all(torch.equal(x, y) and torch.equal(x.cpu(), z)
                       for x, y, z in zip(got, want, cpu)):
                raise AssertionError(f"voxel_sort on the {src}: not bit-equal to its plain "
                                     f"version")
        keys = vf.voxel_keys(*a, **kw)
        bits, passes = vf.sort_span_plain(keys)
        ms = time_ms(lambda: vf.voxel_sort(*a, **kw))
        host = host_ms(lambda: vf.voxel_sort(*a, **kw), reps=30)
        lib_ms = time_ms(lambda: torch.sort(vf.voxel_keys(*a, **kw), stable=True))
        lib_host = host_ms(lambda: torch.sort(vf.voxel_keys(*a, **kw), stable=True), reps=30)
        sort_ms = time_ms(lambda: torch.sort(keys, stable=True))
        plain_ms = event_ms(lambda: vf._sorted_keys_plain(*a, **kw), reps=30)
        byts, ops = N * (12 + 1 + 16) + 4, N * (KEY_ROW_OPS + SORT_PASS_OPS * passes)
        b, by = bound(byts, ops)
        res.setdefault("voxel_sort", {})[src] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library": "the voxel_keys launch and torch.sort(stable=True)",
            "torch_sort_ms": sort_ms, "library_host_ms": lib_host, "bound_ms": b,
            "bound_by": by, "bytes": byts, "ops": ops, "host_ms": host, "rows": N,
            "rank_bits": bits, "passes": passes, "grid": vf.voxel_sort.grid,
            "tiles_a_block": vf.voxel_sort.tiles}
        ms = time_ms(lambda: vf.voxel_keys(*a, **kw))
        host = host_ms(lambda: vf.voxel_keys(*a, **kw), reps=30)
        plain_ms = event_ms(lambda: vf.voxel_keys_plain(*a, **kw), reps=30)
        byts, ops = N * (12 + 1 + 8) + 4, N * KEY_ROW_OPS
        b, by = bound(byts, ops)
        res.setdefault("voxel_keys", {})[src] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "bytes": byts,
            "ops": ops, "host_ms": host, "rows": N, "grid": vf.voxel_keys.grid}
    (pg, mask, max_vox), _, out = rec["dedup"]
    M = pg.shape[0]
    pg3 = torch.cat([pg, pg + 100.0, pg + 200.0])
    mask3 = torch.cat([mask, mask, mask])
    for p, mk, label_d in ((pg, mask, "as run"), (pg3, mask3, "tiled 3x")):
        got = vio_dedup.vio_dedup(p, mk, max_vox)
        want = vio._dedup_voxels_plain(p, mk, max_vox)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"vio_dedup, {label_d}: not bit-equal to its plain version")
    scratch_route = vio_dedup._library()[1](3 * M) > 0
    ms = time_ms(lambda: vio_dedup.vio_dedup(pg, mask, max_vox))
    host = host_ms(lambda: vio_dedup.vio_dedup(pg, mask, max_vox), reps=30)
    ms3 = time_ms(lambda: vio_dedup.vio_dedup(pg3, mask3, max_vox))
    plain_ms = event_ms(lambda: vio._dedup_voxels_plain(pg, mask, max_vox), reps=30)
    byts, ops = 13 * M + 13 * max_vox, DEDUP_ROW_OPS * M
    b, by = bound(byts, ops)
    res["vio_dedup"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                        "bytes": byts, "ops": ops, "host_ms": host, "rows": M,
                        "max_vox": max_vox, "rows_in": int(mask.sum()),
                        "kept": int(out[1].sum()), "grid": vio_dedup.vio_dedup.grid,
                        "rows_24576_ms": ms3, "rows_24576_scratch_route": scratch_route}
    p = rec["push"]
    R, (H, W) = p["after"].shape[0], p["img"].shape
    pool = torch.zeros((R, H, W), dtype=p["dtype"], device=p["img"].device)
    m = push_map(p, pool)
    NP, KO = m.obs_fid.shape
    n_live = min(max(int(m.n_pts), 0), NP)
    alive = (torch.arange(NP, device=pool.device) < m.n_pts)[:, None]
    slot = torch.clamp(m.obs_slot, 0, R - 1)
    ok = alive & (m.obs_fid >= 0) & (m.img_fid[slot.long()] == m.obs_fid)
    tgt = torch.where(ok, slot, R).reshape(-1).long()
    if not torch.equal(torch.bincount(tgt, minlength=R + 1)[:R].int(),
                       vmap_mod._live_slot_refs(m)):
        raise AssertionError("vio_push: torch.bincount is not the refcount")
    for dt in (p["dtype"], torch.float32 if p["dtype"] == torch.uint8 else torch.uint8):
        q = {**p, "dtype": dt}
        pl = torch.zeros((R, H, W), dtype=dt, device=pool.device)
        for form in (1, 2):  # both forms, forced
            m1, m2 = push_map(q, pl), push_map(q, pl)
            vio_push.vio_push(m1, p["img"], p["fid"], form=form)
            vmap_mod.push_image_plain(m2, p["img"], p["fid"])
            if not (torch.equal(m1.img_fid, m2.img_fid) and torch.equal(m1.imgs, m2.imgs)):
                raise AssertionError(f"vio_push ({vio_push.FORMS[form]}) on a {dt} pool: not "
                                     f"bit-equal to its plain version")
            del m1, m2
        del pl
    m1, m2 = push_map(p, pool), push_map(p, pool)
    ms = time_ms(lambda: vio_push.vio_push(m1, p["img"], p["fid"]))
    form, grid = vio_push.vio_push.form, vio_push.vio_push.grid
    host = host_ms(lambda: vio_push.vio_push(m1, p["img"], p["fid"]), reps=30)
    ms_two = time_ms(lambda: vio_push.vio_push(m1, p["img"], p["fid"], form=2))
    host_two = host_ms(lambda: vio_push.vio_push(m1, p["img"], p["fid"], form=2), reps=30)
    plain_ms = event_ms(lambda: vmap_mod.push_image_plain(m2, p["img"], p["fid"]), reps=30)
    lib_ms = event_ms(lambda: torch.bincount(tgt, minlength=R + 1), reps=30)
    es = pool.element_size()
    byts = 8 * n_live * KO + 8 * R + 4 + (4 + es) * H * W
    ops = PUSH_ENTRY_OPS * n_live * KO + PUSH_PAIR_OPS * R * R + (4 if es == 1 else 0) * H * W
    b, by = bound(byts, ops)
    res["vio_push"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b,
                       "bound_by": by, "bytes": byts, "ops": ops, "host_ms": host,
                       "live_rows": n_live, "ring": KO, "pool": R, "image": [H, W],
                       "dtype": str(p["dtype"]), "grid": grid, "form": vio_push.FORMS[form],
                       "two_barrier_ms": ms_two, "two_barrier_host_ms": host_two}
    del m, m1, m2, pool
    for fn in counted_wrappers():
        fn.launches = counts[fn.__name__]
    for src, r in res["voxel_sort"].items():
        print(f"voxel_sort on the {src} ({r['rows']} rows, rank bits {r['rank_bits']}, "
              f"{r['passes']} passes): kernel {r['ms']:.4f} ms ({r['grid']} blocks of "
              f"{r['tiles_a_block']} tile(s) of 1024 rows; host {r['host_ms']:.4f} ms a call), "
              f"library route (voxel_keys + torch.sort) {r['library_ms']:.4f} ms (host "
              f"{r['library_host_ms']:.4f} ms a call; torch.sort alone {r['torch_sort_ms']:.4f} "
              f"ms), plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}: {r['bytes']} bytes, {r['ops']} operations); {smi}")
    for src, r in res["voxel_keys"].items():
        print(f"voxel_keys on the {src} ({r['rows']} rows): kernel {r['ms']:.4f} ms "
              f"({r['grid']} blocks; host {r['host_ms']:.4f} ms a call), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}: "
              f"{r['bytes']} bytes, {r['ops']} operations), library none; {smi}")
    r = res["vio_dedup"]
    print(f"vio_dedup on {label} ({r['rows']} rows, {r['rows_in']} in, {r['kept']} kept of "
          f"{r['max_vox']}): kernel {r['ms']:.4f} ms (host {r['host_ms']:.4f} ms a call; "
          f"24576 rows {r['rows_24576_ms']:.4f} ms, scratch route {scratch_route}), plain "
          f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}: "
          f"{r['bytes']} bytes, {r['ops']} operations), library none; {smi}")
    r = res["vio_push"]
    print(f"vio_push on {label} ({r['live_rows']} live rows x {KO}, a {p['dtype']} pool of "
          f"{R} x {H}x{W}): kernel {r['ms']:.4f} ms ({r['form']}, {r['grid']} blocks; host "
          f"{r['host_ms']:.4f} ms a call; two grid barriers {r['two_barrier_ms']:.4f} ms, "
          f"host {r['two_barrier_host_ms']:.4f}), plain {r['plain_ms']:.4f} ms, library "
          f"torch.bincount {r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
          f"({r['bound_by']}: {r['bytes']} bytes, {r['ops']} operations); both forms on both "
          f"pool types bit-equal; {smi}")
    return res


DELETE_OPS_PER_CENTRE = 3  # the voxel's float, + 0.5, x voxel_size
DELETE_OPS_PER_TEST = 2  # lo <= c, c <= hi


def delete_bound_ms(m, n_boxes: int, killed: int):
    """(bound ms, "bytes" | "operations", bytes, ops) of one box delete: it
    reads slot_key (12 B a slot), the voxel size and the boxes and writes
    4 B per cleared cell. A cell lies in a box iff each of its three
    in-tile offsets does on its axis, so the work a slot needs is its 24
    axis centres (8 offsets x 3 axes) and two compares of each against
    each box: (3 + 2 B) x 24 operations a slot, not a decision per cell."""
    T = m.slot_key.shape[0]
    byts = 12 * T + 4 + 24 * n_boxes + 4 * killed
    ops = (DELETE_OPS_PER_CENTRE + DELETE_OPS_PER_TEST * n_boxes) * 24 * T
    t_b, t_o = byts / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations", byts, ops


def centroid_bound_ms(keys, pts, max_out: int):
    """(bound ms, "bytes" | "operations", bytes, ops) of one centroid pass:
    it reads each row's order entry and sorted key (16 B) and each valid
    row's C floats, and writes max_out rows of C floats and a mask byte;
    ~8 operations a row (head test, count, the division's share) and C
    adds a valid row."""
    from fastlivo_tpu_torch.ops import voxel_filter as vf

    N, C = pts.shape
    nvalid = int((keys != vf.INVALID).sum())
    byts = 16 * N + 4 * C * nvalid + (4 * C + 1) * max_out
    ops = 8 * N + C * nvalid + C * max_out
    t_b, t_o = byts / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations", byts, ops


INSERT_KEY_OPS = 70  # a row: 3 divisions, floors, casts; tile, cell, directory bits; the
# hash (3 multiplies, 3 finalizers of 7); the centre and distance; the key
INSERT_ROW_OPS = 6  # a sorted row's head test and its share of the scan
INSERT_HEAD_OPS = 20  # a tile winner: flag, rank, overflow test, its point's tile key
INSERT_WALK_OPS = 2  # a row of a directory group's first cell run: key test, distance test
CELL_ROW_OPS = 8  # a sorted row: head test, ok test, distance test, dropped count
CELL_WINNER_OPS = 30  # a run's winner: its slot, cell, centre and the stored distance


def insert_work(m, pts, valid):
    """The counts one insert of pts into m needs, from the plain passes on
    a copy: {"rows", "heads" (directory groups: tile winners), "walked"
    (rows of the groups' first cell runs, which the marking walks),
    "written" (winners that do not overflow the pool), "runs" ((dir_idx,
    cell) runs), "winners" (runs with an ok row), "cells" (cells whose
    check or point changed)}."""
    from fastlivo_tpu_torch.ops import tiled_map as tm

    mp = clone_map(m)
    T = m.slot_key.shape[0]
    gkey, rows = tm.insert_keys_plain(mp, pts, valid)
    sg, order = torch.sort(gkey, stable=True)
    sval = sg < 0
    sdir = (sg.to(torch.int64) + tm.KEY_BIAS) >> 9
    heads = tm._head(sdir) & sval
    run, start = tm._runs(sg)
    fresh = int((mp.dir_check[sdir[heads]] == tm.EMPTY_CHECK).sum())
    overflow = max(0, int(mp.n_alloc) + fresh - T)
    _, n_dropped = tm.insert_tiles_plain(mp, pts, rows, sg, order)
    ok = valid & (mp.dir_check[rows[0]] == rows[1])
    cc, cp = mp.cell_check.clone(), mp.pts.clone()
    tm.insert_cells_plain(mp, pts, valid, rows, sg, order, n_dropped)
    changed = (mp.cell_check != cc) | (mp.pts != cp).any(dim=1)
    return {"rows": int(pts.shape[0]), "heads": int(heads.sum()),
            "walked": int((heads[start] & sval).sum()),
            "written": int(heads.sum()) - overflow, "runs": int((tm._head(sg) & sval).sum()),
            "winners": int(torch.unique(run[ok[order]]).numel()),
            "cells": int(changed.sum())}


def insert_bounds(work):
    """{kernel: (bound ms, "bytes" | "operations", bytes, ops)} of the
    insert's two launches for `insert_work`'s counts, and of the cells
    pass inside the second. tiled_insert_keys: each row's point and mask
    read (13 B), its 32-bit key and five row values written (24 B).
    tiled_insert_tiles, both passes: a sorted position's key and order
    (12 B) and its row's directory index, check, distance bits and point
    (24 B) read once; a directory group's entry and slot read (8 B) and
    its winner's flag written (4 B); a written winner's entry and slot key
    written (20 B); a run winner's stored cell and check read (16 B); a
    written cell's check and point (16 B). tiled_insert_cells alone: a
    sorted position's key, order, check, distance bits and point (32 B),
    a run's directory entry (8 B), its winner's stored cell (16 B), a
    written cell (16 B). Operations: ~70 a row for the keys; a head test
    and scan share a row, 2 a walked row and 20 a winner for the tiles
    pass; 8 a row and 30 a run winner for the cells pass."""
    B, W, Wk, Wd, R, H, Wc = (work[k] for k in (
        "rows", "heads", "walked", "written", "runs", "winners", "cells"))
    tiles_ops = INSERT_ROW_OPS * B + INSERT_WALK_OPS * Wk + INSERT_HEAD_OPS * W
    cells_ops = CELL_ROW_OPS * B + CELL_WINNER_OPS * H
    out = {}
    for name, byts, ops in (
            ("tiled_insert_keys", 37 * B + 16, INSERT_KEY_OPS * B),
            ("tiled_insert_tiles", 36 * B + 12 * W + 20 * Wd + 16 * H + 16 * Wc + 16,
             tiles_ops + cells_ops),
            ("tiled_insert_cells", 32 * B + 8 * R + 16 * H + 16 * Wc + 4, cells_ops)):
        t_b, t_o = byts / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        out[name] = (max(t_b, t_o), "bytes" if t_b >= t_o else "operations", byts, ops)
    return out


UNDISTORT_POINT_OPS = 219  # a masked point past the search: Exp (t^2, root, sin, cos,
# a, b, K K, I + a K + b K K), R_k Exp, T, the three mat-vecs
UNDISTORT_FRAME_OPS = 60  # R_li^T R_e^T and R_li^T t_li, once


def undistort_bound_ms(args):
    """(bound ms, "bytes" | "operations", bytes, ops) of one undistortion:
    each point, its time and mask read and its result written (29 B), the
    pose table and the state and calibration once; 219 operations a
    masked point and 3 a step of its binary search over the M offsets."""
    st, pose, pts, t_rel, pmask, calib = args
    N, M = pts.shape[0], pose.offs.shape[0]
    elt = pose.offs.element_size()
    byts = 29 * N + 22 * M * elt + 12 * 8 + 12 * 4
    nm = int(pmask.sum())
    ops = nm * (UNDISTORT_POINT_OPS + 3 * int(np.ceil(np.log2(M + 1)))) + UNDISTORT_FRAME_OPS
    t_b, t_o = byts / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations", byts, ops


def to_cpu(x):
    """A tensor, or a NamedTuple of tensors, on the CPU."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    return type(x)(*(to_cpu(v) for v in x))


def frame_kernels_phase(lio_map, maps, rec, smi):
    """The LIO frame's insert and undistortion kernels against their plain
    versions (these launches are not the paths'; map_stages_phase restores
    the counts). The insert: the LIO path's last insert batch into a copy
    of its final map, into the compacted map (stale slots), into an empty
    map of the shipped capacity (every tile fresh) and into one of half as
    many slots as the batch has tiles (the pool overflows): every TiledMap
    field equal to insert_plain's on the card and on the CPU; on the path
    map tiled_insert_keys' int32 keys and rows equal to the plain pass's,
    and the second launch (tiled_insert_tiles, whose blocks also run the
    cells pass, tiled_insert_cells) the plain tiles and cells passes'
    directory, slot keys, cells and counts. Timed on the path map, the
    batch inserted again at every call (its tiles live, few cells
    nearer), beside the plain passes (the cells pass's row: the same
    launch, beside insert_cells_plain), the keys and their sort
    (tiled_insert_sort, bit-equal to insert_sort_plain on the batch)
    beside the route it replaced (the tiled_insert_keys launch and
    torch.sort(stable=True), by time_ms and host wall), torch.sort alone,
    the plain version and its bound, with the rank's bits and passes,
    the second launch also on the
    bootstrap batch into empty maps (every winner fresh), the whole insert
    beside insert_plain, and the stable sort of the batch's keys at 64
    bits (the JAX package's dir_idx << 40 | cell << 31 | distance bits)
    and at 32, in turns. undistort: the path's last frame step's scan and
    pose table (f32) and that table in f64: bit-equal to undistort_plain on
    the card, within 1e-5 m of it on the CPU. Timed beside the plain
    version. No library call computes either. Returns {kernel: numbers}."""
    from fastlivo_tpu_torch import imu as imu_mod
    from fastlivo_tpu_torch.ops import tiled_map as tm

    (_, pts, valid, *_), _ = rec["insert"]
    dev = pts.device
    dims = [1 << int(x) for x in lio_map.log2_dims.cpu()]
    T = lio_map.slot_key.shape[0]
    vs = float(lio_map.voxel_size)
    sg = torch.sort(tm.insert_keys_plain(lio_map, pts, valid)[0])[0]
    sdir = (sg[sg < 0].to(torch.int64) + tm.KEY_BIAS) >> 9
    tiles = int(torch.unique_consecutive(sdir).numel())  # the batch's tiles
    small = f"{max(tiles // 2, 1)} slots"
    cases = {"path map": lio_map, "compacted": maps["compacted"],
             "empty": tm.empty_tiled_map(dims, T, vs, device=dev),
             small: tm.empty_tiled_map(dims, max(tiles // 2, 1), vs, device=dev)}
    checked = {}
    for label, m in cases.items():
        want = tm.insert_plain(clone_map(m), pts, valid)
        cpu = tm.insert_plain(to_cpu(clone_map(m)), pts.cpu(), valid.cpu())
        got = tm.insert(clone_map(m), pts, valid)
        torch.cuda.synchronize()
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        same_cpu = all(torch.equal(g.cpu(), w) for g, w in zip(got, cpu))
        checked[label] = {"n_alloc": int(got.n_alloc), "n_dropped": int(got.n_dropped)}
        if not (same and same_cpu):
            raise AssertionError(f"tiled_insert on the {label} map: equal to insert_plain on "
                                 f"the card {same}, on the CPU {same_cpu}")
        del want, cpu, got
    if not checked[small]["n_dropped"] > 0:
        raise AssertionError(f"tiled_insert: no row dropped in {small} {checked}")
    # each launch against its plain passes, on the path map
    mp, mk = clone_map(lio_map), clone_map(lio_map)
    gkey, rows = tm.insert_keys_plain(mp, pts, valid)
    g2, r2 = tm.insert_keys(mk, pts, valid)
    sg, order = torch.sort(gkey, stable=True)
    pc = tm.insert_sorted_plain(mp, pts, valid, rows, sg, order)
    kc = tm.insert_tiles(mk, pts, valid, r2, sg, order)
    torch.cuda.synchronize()
    passes = (g2.dtype == torch.int32 and torch.equal(g2, gkey)
              and torch.equal(r2[:4], rows[:4])
              and all(torch.equal(a, b) for a, b in zip(kc, pc))
              and all(torch.equal(a, b) for a, b in zip(mk, mp)))
    if not passes:
        raise AssertionError("tiled_insert: a launch differs from its plain passes on the "
                             "path map")
    print(f"tiled_insert (the keys and their sort in one launch; tiles and cells in one "
          f"launch) on the LIO path's last batch ({pts.shape[0]} rows, {int(valid.sum())} "
          f"valid): every field equal to insert_plain on the card and on the CPU, into "
          f"{checked}; each launch equal to its plain passes")

    # the keys and their sort in one launch, beside the route it replaced
    got_s = tm.insert_sort(lio_map, pts, valid)
    want_s = tm.insert_sort_plain(lio_map, pts, valid)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got_s, want_s)):
        raise AssertionError("tiled_insert_sort on the LIO path's last batch: not bit-equal "
                             "to insert_sort_plain")
    bits, passes = tm.insert_span_plain(lio_map, want_s[0])
    B = pts.shape[0]
    s_ms = time_ms(lambda: tm.insert_sort(lio_map, pts, valid))
    s_grid, s_tiles = tm.insert_sort.grid, tm.insert_sort.tiles
    s_host = host_ms(lambda: tm.insert_sort(lio_map, pts, valid), reps=30)
    route = lambda: torch.sort(tm.insert_keys(lio_map, pts, valid)[0], stable=True)  # noqa
    route_ms = time_ms(route)
    route_host = host_ms(route, reps=30)
    alone_ms = time_ms(lambda: torch.sort(gkey, stable=True))
    s_plain_ms = event_ms(lambda: tm.insert_sort_plain(lio_map, pts, valid), reps=30)
    byts, ops = 45 * B + 16, B * (INSERT_KEY_OPS + SORT_PASS_OPS * passes)
    b, by = bound(byts, ops)
    sort_res = {"ms": s_ms, "plain_ms": s_plain_ms, "library_ms": route_ms,
                "library": "the tiled_insert_keys launch and torch.sort(stable=True)",
                "torch_sort_ms": alone_ms, "library_host_ms": route_host, "host_ms": s_host,
                "bound_ms": b, "bound_by": by, "bytes": byts, "ops": ops, "rows": B,
                "rank_bits": bits, "passes": passes, "grid": s_grid, "tiles_a_block": s_tiles,
                "max_abs_err": 0.0}
    print(f"tiled_insert_sort on the LIO path's last batch ({B} rows, rank bits {bits}, "
          f"{passes} passes): kernel {s_ms:.4f} ms ({s_grid} blocks of {s_tiles} tile(s) of "
          f"512 rows; host {s_host:.4f} ms a call), library route (tiled_insert_keys + "
          f"torch.sort) {route_ms:.4f} ms (host {route_host:.4f} ms a call; torch.sort alone "
          f"{alone_ms:.4f} ms), plain {s_plain_ms:.4f} ms, bound {b:.5f} ms ({by}: {byts} "
          f"bytes, {ops} operations); {smi}")

    work = insert_work(lio_map, pts, valid)
    bounds = insert_bounds(work)
    mt, mq = clone_map(lio_map), clone_map(lio_map)
    rows_k = tm.insert_keys(mt, pts, valid)[1]
    n_d = torch.zeros((), dtype=torch.int32, device=dev)
    second = time_ms(lambda: tm.insert_tiles(mt, pts, valid, rows_k, sg, order))
    timed = {
        "tiled_insert_keys": (lambda: tm.insert_keys(mt, pts, valid),
                              lambda: tm.insert_keys_plain(mq, pts, valid)),
        "tiled_insert_tiles": (
            None, lambda: tm.insert_sorted_plain(mq, pts, valid, rows, sg, order)),
        "tiled_insert_cells": (
            None, lambda: tm.insert_cells_plain(mq, pts, valid, rows, sg, order, n_d)),
    }
    res = {}
    for name, (kern, plain) in timed.items():
        ms = time_ms(kern) if kern is not None else second
        plain_ms = event_ms(plain, reps=30)
        b, by, byts, ops = bounds[name]
        res[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                     "bytes": byts, "ops": ops, "library_ms": None, "max_abs_err": 0.0,
                     **work}
        what = ("the cells pass inside tiled_insert_tiles' launch (the launch's time)"
                if name == "tiled_insert_cells" else name)
        print(f"{what} on the LIO path's last batch, re-inserted into its map ({work}): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.5f} ms ({by}: {byts} "
              f"bytes, {ops} operations), library none; {smi}")
    res["tiled_insert_cells"]["in_launch"] = "tiled_insert_tiles"
    res["tiled_insert_sort"] = sort_res
    res["tiled_insert_keys"]["path"] = ("none since tiled_insert_sort, whose launch computes "
                                        "the keys with the same device function")
    # the second launch where every winner is fresh: the bootstrap batch
    # into an empty map, each timed call into a map of its own (a
    # directory written by one call has the batch's tiles live for the
    # next); the timed maps share one pool, so after the first call the
    # cells the calls find are live and equal to theirs (the bound counts
    # the first call's cell writes)
    (_, bpts, bvalid, *_), _ = rec["first"]
    empty = tm.empty_tiled_map(dims, T, vs, device=dev)
    bwork = insert_work(empty, bpts, bvalid)
    bkey, brows = tm.insert_keys_plain(empty, bpts, bvalid)
    bsg, border = torch.sort(bkey, stable=True)
    fresh_maps = [empty._replace(dir_check=empty.dir_check.clone(),
                                 dir_slot=empty.dir_slot.clone(),
                                 slot_key=empty.slot_key.clone()) for _ in range(80)]
    compared = [clone_map(fresh_maps[k]) for k in (0, 1)]
    want_b = tm.insert_sorted_plain(compared[0], bpts, bvalid, brows, bsg, border)
    got_b = tm.insert_tiles(compared[1], bpts, bvalid, brows.clone(), bsg, border)
    torch.cuda.synchronize()
    if not (all(torch.equal(g, w) for g, w in zip(compared[1], compared[0]))
            and [int(x) for x in got_b] == [int(x) for x in want_b]):
        raise AssertionError("tiled_insert_tiles: the bootstrap batch into an empty map "
                             "differs from the plain tiles and cells passes")
    # 33 calls when the first batch queues ahead of the device; past 66 the
    # maps come round again, their winners then aliased
    calls, plain_calls = itertools.cycle(fresh_maps[2:68]), iter(fresh_maps[68:])
    fresh_ms = time_ms(lambda: tm.insert_tiles(next(calls), bpts, bvalid, brows, bsg, border))
    fresh_plain_ms = event_ms(lambda: tm.insert_sorted_plain(
        next(plain_calls), bpts, bvalid, brows, bsg, border), reps=10)
    b, by, byts, ops = insert_bounds(bwork)["tiled_insert_tiles"]
    res["tiled_insert_tiles"]["fresh_heads"] = {
        "ms": fresh_ms, "plain_ms": fresh_plain_ms, "bound_ms": b, "bound_by": by,
        "bytes": byts, "ops": ops, "grid": tm.insert_tiles.grid, **bwork}
    print(f"tiled_insert_tiles on the LIO path's bootstrap batch into an empty map ({bwork}, "
          f"every winner fresh; {tm.insert_tiles.grid} blocks): kernel {fresh_ms:.4f} ms, "
          f"plain {fresh_plain_ms:.4f} ms (a fresh map each call), bound {b:.5f} ms "
          f"({by}: {byts} bytes, {ops} operations); {smi}")
    del fresh_maps, compared, empty, calls, plain_calls

    whole = time_ms(lambda: tm.insert(mt, pts, valid))
    whole_plain = event_ms(lambda: tm.insert_plain(mq, pts, valid), reps=30)
    # the sort at both widths, in turns
    cell = (rows[0].to(torch.int64) << 9) | rows[2]
    D = lio_map.dir_check.shape[0]
    keys = {64: torch.where(valid, (cell << 31) | rows[3].to(torch.int64), D << 40), 32: gkey}
    sorts = {64: [], 32: []}
    for width in (64, 32, 32, 64):
        sorts[width].append(time_ms(lambda: torch.sort(keys[width], stable=True)))
    sort_ms = {w: sum(v) / len(v) for w, v in sorts.items()}
    t0 = time.perf_counter()
    for _ in range(20):
        tm.insert(mt, pts, valid)
    insert_host = 1e3 * (time.perf_counter() - t0) / 20
    torch.cuda.synchronize()
    res["tiled_insert_keys"].update(insert_ms=whole, insert_plain_ms=whole_plain,
                                    sort_ms=sort_ms[32], sort_64_ms=sort_ms[64],
                                    insert_host_ms=insert_host, cases=checked)
    print(f"the whole insert (its two launches, the keys and sort, then the tiles and "
          f"cells): {whole:.4f} ms on the card, torch.sort alone of the 32-bit keys "
          f"{sort_ms[32]:.4f} ms (of the 64-bit key {sort_ms[64]:.4f} ms), insert_plain "
          f"{whole_plain:.4f} ms; host {insert_host:.4f} ms a call; {smi}")
    del mt, mq, mp, mk

    # the undistortion on the path's last frame step
    (st, _m, pose, calib, pts_raw, t_rel, rmask, *_), _ = rec["frame"]
    args = (st, pose, pts_raw, t_rel, rmask, calib)
    pose64 = type(pose)(*(f.double() for f in pose))
    err, share = 0.0, {}
    for label, a in (("f32 pose", args), ("f64 pose", (st, pose64) + args[2:])):
        want = imu_mod.undistort_plain(*a)
        got = imu_mod.undistort(*a)
        cpu = imu_mod.undistort_plain(*(to_cpu(x) for x in a))
        torch.cuda.synchronize()
        d = bits_diff(got, want)
        e = float((got.cpu() - cpu).abs().max())
        share[label] = float((got.cpu().view(torch.int32) == cpu.view(torch.int32)).float().mean())
        err = max(err, e)
        if d != 0.0 or not e < 1e-5:
            raise AssertionError(f"undistort, {label}: {d} from the plain version on the card, "
                                 f"{e} m from the CPU's")
    ms = time_ms(lambda: imu_mod.undistort(*args))
    plain_ms = event_ms(lambda: imu_mod.undistort_plain(*args), reps=30)
    b, by, byts, ops = undistort_bound_ms(args)
    res["undistort"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                        "bytes": byts, "ops": ops, "library_ms": None, "max_abs_err": 0.0,
                        "max_abs_diff_to_cpu": err, "cpu_bit_equal_share": share,
                        "points": int(pts_raw.shape[0]), "masked": int(rmask.sum()),
                        "pose_rows": int(pose.offs.shape[0])}
    print(f"undistort on the LIO path's last scan ({pts_raw.shape[0]} rows, {int(rmask.sum())} "
          f"points, {pose.offs.shape[0]} pose rows): bit-equal to undistort_plain on the card "
          f"(f32 and f64 pose tables), {err:.3g} m from the CPU's (bit-equal share {share}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.5f} ms ({by}: {byts} bytes, "
          f"{ops} operations), library none; {smi}")
    return res


def face_boxes(m, rng, n_boxes: int):
    """n_boxes boxes around live cells of the map whose faces lie on cell
    centres (inclusive on both sides: the test's edge), 1 to 40 voxels
    from the cell on each side."""
    from fastlivo_tpu_torch.ops import voxel_map as vmap

    T = m.slot_key.shape[0]
    chk = vmap._check31(m.slot_key)
    live = (m.cell_check.view(T, 512) == chk[:, None]) & (
        torch.arange(T, device=chk.device) < m.n_alloc)[:, None]
    cells = torch.nonzero(live.view(-1)).view(-1).cpu().numpy()
    pick = cells[rng.integers(0, len(cells), n_boxes)]
    sk = m.slot_key.cpu().numpy()[pick // 512].astype(np.int64)
    c = pick % 512
    v = sk * 8 + np.stack([c >> 6, (c >> 3) & 7, c & 7], -1)
    vs = np.float32(m.voxel_size.item())
    ctr = lambda k: (k.astype(np.float32) + np.float32(0.5)) * vs  # noqa: E731
    lo = ctr(v - rng.integers(1, 41, v.shape))
    hi = ctr(v + rng.integers(1, 41, v.shape))
    dev = m.slot_key.device
    return (torch.from_numpy(lo.astype(np.float32)).to(dev),
            torch.from_numpy(hi.astype(np.float32)).to(dev))


def map_stages_phase(lio_map, box_sets, lio_rec, cam_filter):
    """The LIO frame's map-stage kernels against their plain versions on
    the card, then timed (these launches are not the paths'; the counts
    are restored). tiled_delete_boxes: on the LIO per-frame path's final
    map (Config()'s 16384 slots x 512 cells) and on that map compacted,
    with the tracker's last three box sets of
    the path and with 1, 3 and 6 boxes around live cells whose faces lie
    on cell centres: every field equal to delete_boxes_plain's (the
    compacted map is compacted after 6 other face boxes cleared whole
    tiles, so that slots past n_alloc keep stale keys). Timed on
    the tracker's last boxes (the path's input) and on the 6 face boxes,
    beside the plain version; no library call computes it.
    voxel_centroids: on the LIO path's last scan and the LIVO path's last
    camera cloud, as run, with max_out at half the voxels (overflow), and
    with NaN, inf and -0.0 rows: bit-equal to voxel_centroids_plain run
    on the CPU on the same sorted keys, the whole filter
    (voxel_downsample_device on the card) bit-equal to
    voxel_downsample_device on the CPU, and whether the card's own
    plain version (torch.segment_reduce on the card) gives the same bits.
    Timed as run beside the plain version and the library call
    torch.segment_reduce on the same rows and lengths. Then the insert
    and the undistortion (frame_kernels_phase, on the LIO path's last
    insert and frame step: `lio_rec`, with its last voxel filter's
    arguments). Returns {"tiled_delete_boxes": {...}, "voxel_centroids":
    {...}, "tiled_insert_keys": ..., "undistort": {...}}."""
    from fastlivo_tpu_torch.ops import tiled_map as tm
    from fastlivo_tpu_torch.ops import voxel_filter as vf

    counts = read_counts()
    smi = nvidia_smi_line()
    dev = lio_map.slot_key.device
    rng = np.random.default_rng(16)
    tracker = {f"tracker {k}": (torch.from_numpy(b[:, 0].copy()).to(dev),
                                torch.from_numpy(b[:, 1].copy()).to(dev))
               for k, b in enumerate(box_sets[-3:])}
    # compacted after clearing whole tiles: stale slots past n_alloc
    maps = {"path map": lio_map, "compacted": tm.compact(
        tm.delete_boxes_plain(clone_map(lio_map), *face_boxes(lio_map, rng, 6)))}
    n_alloc = int(maps["compacted"].n_alloc)
    stale = int((maps["compacted"].slot_key[n_alloc:] != 0).any(dim=1).sum())
    killed = {}
    for label, m in maps.items():
        faces = {f"faces {B}": face_boxes(m, rng, B) for B in (1, 3, 6)}
        if label == "path map":
            flo, fhi = faces["faces 6"]
        for name, (lo, hi) in {**tracker, **faces}.items():
            want = tm.delete_boxes_plain(clone_map(m), lo, hi)
            got = tm.delete_boxes(clone_map(m), lo, hi)
            torch.cuda.synchronize()
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            k = int((want.cell_check == tm.EMPTY_CHECK).sum()
                    - (m.cell_check == tm.EMPTY_CHECK).sum())
            killed[f"{label}, {name}"] = k
            if not same or (name.startswith("faces") and k == 0):
                raise AssertionError(f"tiled_delete_boxes on the {label}, {name} boxes: "
                                     f"equal {same}, {k} cells cleared")
            del want, got
    print(f"tiled_delete_boxes on the LIO path's map ({lio_map.slot_key.shape[0]} slots, "
          f"{int(lio_map.n_alloc)} allocated) and compacted ({n_alloc} allocated, {stale} "
          f"stale slots past them): every field equal to the plain version for the "
          f"tracker's and the face boxes; cells cleared {killed}")
    lo, hi = tracker[f"tracker {len(tracker) - 1}"]
    mt = clone_map(lio_map)
    ms = time_ms(lambda: tm.delete_boxes(mt, lo, hi))
    grid = tm.delete_boxes.grid
    ms6 = time_ms(lambda: tm.delete_boxes(mt, flo, fhi))
    mp = clone_map(lio_map)
    plain_ms = time_ms(lambda: tm.delete_boxes_plain(mp, lo, hi))
    plain6 = time_ms(lambda: tm.delete_boxes_plain(mp, flo, fhi))
    del mt, mp
    k_path = killed[f"path map, tracker {len(tracker) - 1}"]
    bound, by, byts, ops = delete_bound_ms(lio_map, lo.shape[0], k_path)
    bound6, by6, _, _ = delete_bound_ms(lio_map, 6, killed["path map, faces 6"])
    res = {"tiled_delete_boxes": {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "bytes": byts,
        "ops": ops, "grid": grid, "boxes": int(lo.shape[0]), "cells_cleared": k_path,
        "faces_6": {"ms": ms6, "plain_ms": plain6, "bound_ms": bound6, "bound_by": by6,
                    "cells_cleared": killed["path map, faces 6"]},
        "max_abs_err": 0.0, "cases": len(killed)}}
    print(f"tiled_delete_boxes, the tracker's {lo.shape[0]} boxes ({k_path} cells cleared): "
          f"kernel {ms:.4f} ms ({grid} blocks), plain {plain_ms:.4f} ms, bound {bound:.5f} ms ({by}: "
          f"{byts} bytes, {ops} operations), library none; 6 face boxes "
          f"({killed['path map, faces 6']} cells): kernel {ms6:.4f} ms, plain {plain6:.4f} "
          f"ms, bound {bound6:.5f} ms ({by6}); {smi}")

    cases, card_plain_same, card_plain_err = {}, True, 0.0
    timed = {}
    for src, (a, kw) in (("lio scan", lio_rec["filter"]), ("camera cloud", cam_filter)):
        pts, valid, leaf, max_out = a[0], a[1], a[2], a[3]
        inv = kw.get("inv_leaf")
        keys, order = vf._sorted_keys(pts, valid, leaf, inv)
        nseg = int(vf.voxel_centroids_plain(keys, order, pts, max_out)[1].sum())
        runs = torch.unique_consecutive(keys[keys != vf.INVALID], return_counts=True)[1]
        longest = int(runs.max()) if runs.numel() else 0
        bad = pts.clone()
        bad[:8] = float("nan")
        bad[8:16, 1] = float("inf")
        bad[16:64] = -0.0
        bvalid = valid.clone()
        bvalid[:64] = True
        for case, (p, v, mo) in {"as run": (pts, valid, max_out),
                                 "overflow": (pts, valid, max(nseg // 2, 1)),
                                 "nan, inf, -0.0 rows": (bad, bvalid, max_out)}.items():
            pk, od = vf._sorted_keys(p, v, leaf, inv)
            got = vf.voxel_centroids(pk, od, p, mo)
            cpu = vf.voxel_centroids_plain(pk.cpu(), od.cpu(), p.cpu(), mo)
            card = vf.voxel_centroids_plain(pk, od, p, mo)
            full = vf.voxel_downsample_device(p, v, leaf, mo, **kw)
            full_cpu = vf.voxel_downsample_device(
                p.cpu(), v.cpu(), None if leaf is None else leaf.cpu(), mo,
                **{k: t.cpu() for k, t in kw.items()})
            torch.cuda.synchronize()
            same = all(bits_diff(x.cpu(), y) == 0.0 for x, y in zip(got + full, cpu + full_cpu))
            csame = all(bits_diff(x.cpu(), y) == 0.0 for x, y in zip(card, cpu))
            cerr = float((card[0].cpu() - cpu[0]).abs().max())
            card_plain_same &= csame
            card_plain_err = max(card_plain_err, cerr)
            cases[f"{src}, {case}"] = {"rows": int(p.shape[0]), "max_out": mo,
                                       "voxels": int(cpu[1].sum()),
                                       "card_plain_bit_equal": csame}
            if not same or int(cpu[1].sum()) == 0:
                raise AssertionError(f"voxel_centroids on the {src}, {case}: bit-equal to the "
                                     f"CPU {same}, {int(cpu[1].sum())} voxels")
        # timed as run
        # the library call's inputs, as voxel_centroids_plain forms them
        vs = keys != vf.INVALID
        data = torch.where(vs[:, None], pts[order], torch.zeros_like(pts))
        lengths = torch.zeros(max_out + 1, dtype=torch.int64, device=dev)
        head = torch.ones_like(keys, dtype=torch.bool)
        head[1:] = keys[1:] != keys[:-1]
        sg = torch.clamp(torch.where(vs, torch.cumsum((head & vs).long(), 0) - 1,
                                     torch.full_like(keys, max_out)), max=max_out)
        lengths.index_add_(0, sg, torch.ones_like(sg))
        k_ms = time_ms(lambda: vf.voxel_centroids(keys, order, pts, max_out))
        p_ms = event_ms(lambda: vf.voxel_centroids_plain(keys, order, pts, max_out), reps=30)
        lib_ms = event_ms(lambda: torch.segment_reduce(data, "sum", lengths=lengths, axis=0,
                                                       unsafe=True, initial=0.0), reps=30)
        f_ms = time_ms(lambda: vf.voxel_downsample_device(pts, valid, leaf, max_out, **kw))
        with swapped(vf, "voxel_centroids", vf.voxel_centroids_plain):
            fp_ms = event_ms(lambda: vf.voxel_downsample_device(pts, valid, leaf, max_out, **kw),
                             reps=30)
        bound, by, byts, ops = centroid_bound_ms(keys, pts, max_out)
        timed[src] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": bound,
                      "bound_by": by, "bytes": byts, "ops": ops, "grid": vf.voxel_centroids.grid,
                      "rows": int(pts.shape[0]), "max_out": max_out, "voxels": nseg,
                      "longest_run": longest, "filter_ms": f_ms, "filter_plain_ms": fp_ms}
        print(f"voxel_centroids on the {src} ({pts.shape[0]} rows, {nseg} voxels into "
              f"{max_out}, the longest {longest} rows): kernel {k_ms:.4f} ms "
              f"({vf.voxel_centroids.grid} blocks), plain "
              f"{p_ms:.4f} ms, library torch.segment_reduce {lib_ms:.4f} ms, bound "
              f"{bound:.5f} ms ({by}: {byts} bytes, {ops} operations); the whole filter "
              f"(sort + kernel) {f_ms:.4f} ms, plain {fp_ms:.4f} ms; {smi}")
    print(f"voxel_centroids bit-equal to the plain version on the CPU in every case "
          f"{list(cases)}; the card's plain version bit-equal too: {card_plain_same} "
          f"(max abs difference {card_plain_err:.3g})")
    res["voxel_centroids"] = {**timed["lio scan"], "camera": timed["camera cloud"],
                              "max_abs_err": 0.0, "cases": cases,
                              "card_plain_bit_equal": card_plain_same,
                              "card_plain_max_abs_diff": card_plain_err}
    res.update(frame_kernels_phase(lio_map, maps, lio_rec, smi))
    for fn in counted_wrappers():
        fn.launches = counts[fn.__name__]
    return res


def lio_cascade_phase(a, label="the path map"):
    """lio_cascade on a path's last call `a` (its arguments, the map's
    search arrays as they were; the tiled, hash or dense map): held
    against the host loop lio.lio_loop (bit-equal with the step kernel,
    its search the map's kernel and that kernel's plain version, under
    cache_knn on the block knn_candidates gathers in torch ops; all plain
    the same iterations and the pose within 1e-9), then timed beside it. Times: the cascade (queued CUDA events), a call's host wall, and
    the host loop with the kernels (knn5_plane_tiled or knn5_plane_hashed
    and the step kernel), with the plain step, and all plain (the plain
    search), each one call alone between two events (the loop reads a
    flag an iteration), with its host wall. The bound from the inputs of
    every search iteration (lio_cascade_bound_ms). These launches are not
    the path's. Returns numbers."""
    from fastlivo_tpu_torch import lio
    from fastlivo_tpu_torch.ops import lio_cascade as lc
    from fastlivo_tpu_torch.ops import photometric as ph

    m, radius, o = a[0], a[10], cascade_options(a)
    block = None
    if o["cache_knn"]:  # the block the launch writes, held against knn_candidates'
        cand, found = gathered_block(a)
        block = (torch.full_like(cand, float("nan")), torch.ones_like(found))
    got = lc.lio_cascade(*a, block=block)
    its = int(got[6])
    want, want_ps = lio_loop_on(a), lio_loop_on(a, plain_search=True)
    err = max(max_abs_diff(got[:6], want[:6]), max_abs_diff(got[:6], want_ps[:6]))
    if not (lio_same(got, want) and lio_same(got, want_ps)):
        raise AssertionError(f"lio_cascade differs from the host loop on {label}'s last "
                             f"call by {err:.3g}")
    if block is not None and not (torch.equal(block[1], found)
                                  and torch.equal(block[0][found], cand[found])):
        raise AssertionError(f"lio_cascade's block on {label}'s last call differs from "
                             f"knn_candidates'")
    ms = time_ms(lambda: lc.lio_cascade(*a))
    host = host_ms(lambda: lc.lio_cascade(*a))
    loop_ms, loop_host = event_ms(lambda: lio_loop_on(a), reps=5), host_ms(lambda: lio_loop_on(a))
    with swapped(lio, "photometric_step", ph.photometric_step_plain):
        loop_plain_step_ms = event_ms(lambda: lio_loop_on(a), reps=5)
        all_plain = lio_loop_on(a, plain_search=True)
        pose_d = max(float((got[0] - all_plain[0]).abs().max()),
                     float((got[1] - all_plain[1]).abs().max()))
        if not (all_plain[6] == its and pose_d <= 1e-9):
            raise AssertionError(f"lio_cascade: {its} iterations, all plain {all_plain[6]}, "
                                 f"pose {pose_d:.3g}")
        plain_ms = event_ms(lambda: lio_loop_on(a, plain_search=True), reps=5)
        plain_host = host_ms(lambda: lio_loop_on(a, plain_search=True))
    pws = []
    knn = map_search(a)
    lio.lio_loop(lambda pw: (pws.append(pw), knn(pw))[1], *a[1:10])
    n = a[1].shape[0]
    bound, by, uniq = lio_cascade_bound_ms(m, torch.cat(pws), n, its, radius, **o)
    what = ("distinct directory entries, pool cells, live points, neighbourhood tiles"
            if lc.map_kind(m) == "tiled" else "distinct probed words, found points, probes "
            "taken, found rows")
    if o["cache_knn"]:
        what = f"the first search's {what}, then the block's candidates, found rows"
    route = (f"{lc.map_kind(m)} map, {'gather' if o['cache_knn'] else 'walk'} search, "
             f"{o['plane_fit']} fit")
    print(f"lio_cascade N={n} M={(2 * radius + 1) ** 3} on {label} ({route}): {its} iterations "
          f"({len(pws)} searching) in {ms:.4f} ms ({ms / its:.4f} ms an iteration; host "
          f"{host:.3f} ms a call), grid {lc.lio_cascade.grid} blocks; the host loop "
          f"{loop_ms:.4f} ms with the kernels (host {loop_host:.3f} ms), {loop_plain_step_ms:.4f} "
          f"with the plain step, {plain_ms:.4f} all plain (host {plain_host:.3f} ms; pose "
          f"within {pose_d:.3g}); bit-equal with the kernel and the plain search; bound "
          f"{bound:.6f} ms ({by}; {what} over the searches {uniq}), library none; "
          f"{nvidia_smi_line()}")
    if block is not None:
        print(f"lio_cascade on {label}: the block it wrote ({tuple(found.shape)}, "
              f"{int(found.sum())} found) equals knn_candidates' at the start pose")
    return {"max_abs_err": err, "iterations": its, "searches": len(pws), "ms": ms,
            "ms_per_iteration": ms / its, "host_ms": host, "grid": lc.lio_cascade.grid,
            "loop_ms": loop_ms, "loop_host_ms": loop_host,
            "loop_plain_step_ms": loop_plain_step_ms, "plain_ms": plain_ms,
            "plain_host_ms": plain_host, "all_plain_pose_max_diff": pose_d,
            "bound_ms": bound, "bound_by": by}


def with_radius(a, radius: int):
    """A lio_cascade call's arguments `a` at another search radius."""
    return (*a[:10], radius, *a[11:])


def radius_phase(calls: dict) -> dict:
    """lio_cascade at the radii past the templated walk's 27 candidates on
    paths' last calls (`calls`: {label: arguments}, the radius set in
    each): held against the host loop bit for bit, iterations included,
    its search the host-loop kernels (knn5_plane_tiled, knn5_plane_hashed,
    knn5_plane on the block, each at the same M) and the plain search;
    then timed (queued CUDA events) beside its bound
    (lio_cascade_bound_ms). These launches are not the paths'. Returns
    {label: numbers}."""
    from fastlivo_tpu_torch import lio
    from fastlivo_tpu_torch.ops import lio_cascade as lc

    smi = nvidia_smi_line()
    out = {}
    for label, a in calls.items():
        m, n, radius, o = a[0], a[1].shape[0], a[10], cascade_options(a)
        got = lc.lio_cascade(*a)
        its = int(got[6])
        pws = []
        knn = map_search(a)
        loop = lio.lio_loop(lambda pw: (pws.append(pw), knn(pw))[1], *a[1:10])
        plain = lio_loop_on(a, plain_search=True)
        err = max(max_abs_diff(got[:6], loop[:6]), max_abs_diff(got[:6], plain[:6]))
        if not (lio_same(got, loop) and lio_same(got, plain)):
            raise AssertionError(f"lio_cascade at radius {radius} ({label}) differs from the "
                                 f"host loop by {err:.3g}, iterations {its} / {loop[6]} / "
                                 f"{plain[6]}")
        ms = time_ms(lambda: lc.lio_cascade(*a))
        bound, by, _ = lio_cascade_bound_ms(m, torch.cat(pws), n, its, radius, **o)
        M = (2 * radius + 1) ** 3
        print(f"lio_cascade at radius {radius} (M={M}) on {label}: {its} iterations "
              f"({len(pws)} searching), {int(got[3].sum())} rows selected, {ms:.4f} ms, grid "
              f"{lc.lio_cascade.grid} blocks, bound {bound:.6f} ms ({by}); bit-equal to the "
              f"host loop with the kernels and with the plain search; {smi}")
        out[label] = {"radius": radius, "M": M, "ms": ms, "bound_ms": bound, "bound_by": by,
                      "iterations": its, "searches": len(pws), "selected": int(got[3].sum()),
                      "max_abs_err": err, "grid": lc.lio_cascade.grid}
        del got, loop, plain, pws
        torch.cuda.empty_cache()
    return out


def radius_run(dev, radius=3, duration=3.0):
    """(n) a small LIO run at `knn_voxel_radius` `radius` on the card and
    on the CPU (its plain versions), the same input: every frame within 1
    mm; on the card every EKF one lio_cascade launch and no host-loop
    search kernel. Returns numbers."""
    from fastlivo_tpu_torch.config import CapacityConfig, Config
    from fastlivo_tpu_torch.io.synthetic import SyntheticDataset
    from fastlivo_tpu_torch.pipeline import Pipeline

    res = []
    for d in (dev, "cpu"):
        cfg = Config()
        cfg.img_enable = False
        cfg.capacity = CapacityConfig(max_points=4096, max_raw_points=8192,
                                      tiled_dir_dims=(32, 32, 16), tiled_pool=1024,
                                      knn_voxel_radius=radius)
        ds = SyntheticDataset(duration=duration, points_per_scan=4096, lidar_noise=0.004,
                              seed=3)
        pipe = Pipeline(cfg, device=d)
        for beg, pts, t_rel in ds.lidar_scans_fast():
            pipe.push_lidar(beg, pts, t_rel)
        for t, acc, gyr in ds.imu_stream():
            pipe.push_imu(t, acc, gyr)
        if d is dev:
            outs, launches, wall = counted_run(pipe.spin)
        else:
            outs = pipe.spin()
        res.append(outs)
    a, b = res
    steady = sum(o.iters > 0 for o in a)
    if len(a) != len(b) or len(a) < 15:
        raise AssertionError(f"radius {radius}: frames {len(a)} on {dev} vs {len(b)} on cpu")
    dmax = max(np.linalg.norm(x.pos - y.pos) for x, y in zip(a, b))
    searches = {k: launches[k] for k in ("knn5_plane_tiled", "knn5_plane_hashed", "knn5_plane")}
    print(f"(n) radius {radius} (M={(2 * radius + 1) ** 3}), {dev} vs cpu: {len(a)} frames "
          f"({steady} steady), max position difference {dmax * 1e3:.4f} mm; lio_cascade "
          f"{launches['lio_cascade']} launches, host-loop searches {searches}; "
          f"{wall / len(a):.2f} ms a frame on the card")
    if not (dmax < 1e-3 and launches["lio_cascade"] >= steady > 0
            and not any(searches.values())):
        raise AssertionError(f"radius {radius}: {dmax:.2e} m, launches {launches}")
    return {"radius": radius, "frames": len(a), "max_diff_to_cpu_mm": dmax * 1e3,
            "ms_per_frame": wall / len(a), "launches": launches}


def photometric_compare(a, label="") -> float:
    """photometric_err_H against its plain version on one call's arguments
    `a`: every output bit-equal (the plain version writes the kernel's
    sums' orders out); the relative differences are printed beside it.
    Returns the max abs error over all outputs. This launch is not the
    path's."""
    from fastlivo_tpu_torch.ops import photometric as ph

    G, P, level, robust = a[1].shape[0], a[13], a[12], a[14]
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
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    print(f"photometric_err_H{label} G={G} P={P} level {level} robust {robust}: "
          f"{', '.join(rel)}; max_abs_err={e:.3g} (|HT| up to "
          f"{float(want[1].abs().max()):.3g}), bit-equal {same}")
    if not same:
        raise AssertionError(f"photometric_err_H {robust} not bit-equal to its plain version")
    return e


def measurement_args(a, level=None) -> list:
    """photometric_err_H's arguments for the first iteration of a cascade
    call whose arguments are `a` (photometric_cascade's, vio.photometric_
    loop's): its start pose, at `level` (default its first level)."""
    (img, tr_pos, tr_patch, tr_slevel, tr_valid, rot, x, _prot, _px, _P, Rci, Pci, Jdphi_dR,
     Jdp_dR, cam, levels, P, _max_iter, robust, robust_scale) = a
    lv = levels[0] if level is None else level
    return [img, tr_pos, tr_patch[:, lv], tr_slevel, tr_valid, rot, x[0:3], Rci, Pci,
            Jdphi_dR, Jdp_dR, cam, lv, P, robust, robust_scale]


def photometric_phase(dev, args):
    """photometric_err_H against its plain version on the inputs of the
    LIVO path's last measurement (G = 192 cells of a 640x512 image,
    P = 8), at every robust mode: bit-equal (photometric_compare); with
    every point invalid, err and HT exactly 0. Times the kernel, the unfused pair it
    replaced (the plain body sampling through the standalone
    patches_and_grads kernel) and the plain version. These launches are
    not the path's. Returns the max abs error over all outputs and the
    times."""
    from fastlivo_tpu_torch.ops import photometric as ph

    args = list(args)
    G, P = args[1].shape[0], args[13]
    err = 0.0
    for robust in ("none", "huber", "tukey"):
        err = max(err, photometric_compare(args[:14] + [robust, args[15]]))
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


class Recorded:
    """A SyntheticDataset's streams, drawn once (scans, IMU, images: the
    order in which the paths push them), so that every phase replays the
    same data: the dataset draws new noise on each call. Point times and
    IMU samples are rounded to float32, as the server's wire format
    carries them."""

    def __init__(self, ds):
        self.traj = ds.traj
        self.room = ds.room
        self._scans = [(b, p, r.astype(np.float32).astype(np.float64))
                       for b, p, r in ds.lidar_scans_fast()]
        f32 = lambda v: np.asarray(v, np.float32).astype(np.float64)  # noqa: E731
        self._imu = [(t, f32(a), f32(g)) for t, a, g in ds.imu_stream()]
        self._images = ds.images()

    def lidar_scans_fast(self):
        return self._scans

    def imu_stream(self):
        return self._imu

    def images(self):
        return self._images


def path_phase(dev, duration=6.0, points_per_scan=24000):
    """Pipeline(Config()) at its shipped capacities on `dev`; the kernels'
    launch counts are read around this run only. The LIO cascade must
    launch once per steady frame (each recorded: lio_cascade's inputs and
    outputs, no host read; the copies' memory reserved before the run), the searches and the step kernel never (the
    cascade searches inside), imu_propagate once per propagated group.
    After the run every cascade is held against the host loop on its
    inputs (check_lio_cascades). Returns (the pipeline, the launches, the
    outputs, the dataset, wall ms per frame, the last cascade call's
    arguments, the cascades' numbers, the boxes deleted, {"filter": the
    last voxel filter call's arguments, "insert": the last map insert's,
    "frame": the last lidar_frame_step's}). tiled_delete_boxes must
    launch once per tracker update with boxes, voxel_centroids once per
    steady frame, the insert's two launches (insert_sort, insert_tiles)
    once per insert and its key pass alone never, undistort once per frame
    step and bootstrap scan, voxel_sort once per filtered scan and
    voxel_keys never (each voxel sort and insert sort recorded and
    replayed after the run: check_stage_calls)."""
    from fastlivo_tpu_torch import imu as imu_mod
    from fastlivo_tpu_torch import lio
    from fastlivo_tpu_torch import pipeline as pipeline_mod
    from fastlivo_tpu_torch.config import Config
    from fastlivo_tpu_torch.ops import tiled_map as tm
    from fastlivo_tpu_torch.ops import voxel_filter as vf
    from fastlivo_tpu_torch.io.synthetic import SyntheticDataset
    from fastlivo_tpu_torch.pipeline import Pipeline

    cfg = Config()
    cfg.img_enable = False
    cap = cfg.capacity
    print(f"config: tiled map {cap.tiled_dir_dims} x {cap.tiled_pool} tiles, "
          f"max_points {cap.max_points}, max_raw_points {cap.max_raw_points}, "
          f"max_iteration {cfg.max_iteration}, knn_voxel_radius {cap.knn_voxel_radius}")
    ds = Recorded(SyntheticDataset(duration=duration, points_per_scan=points_per_scan,
                                   lidar_noise=0.004, seed=0))
    scans = ds.lidar_scans_fast()
    imu = ds.imu_stream()
    pipe = Pipeline(cfg, device=dev)
    for beg, pts, t_rel in scans:
        pipe.push_lidar(beg, pts, t_rel)
    for t, acc, gyr in imu:
        pipe.push_imu(t, acc, gyr)
    searches, groups, cascades, boxes, filt, ins, step = [], [], [], [], {}, {}, {}
    keys, isorts = [], []
    reserve_snapshots(pipe.map, len(scans))
    torch.cuda.synchronize()
    reset_counts()
    with spy(lio, "knn5_plane_search", searches), spy(imu_mod, "propagate_wire", groups), \
            recorded_lio(cascades), recorded_boxes(pipe, boxes), recorded_calls(vf, filt), \
            recorded_calls(tm, ins, "insert", first=True), \
            recorded_calls(pipeline_mod, step, "lidar_frame_step"), \
            recorded_all(vf, "_sorted_keys", keys), recorded_insert_sorts(isorts):
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
          f"{len(cascades)} LIO cascades, {len(searches)} searches outside them, "
          f"{len(groups)} propagated groups, launches {launches}, "
          f"ATE {ate * 1e3:.3f} mm, "
          f"median steady frame {np.median(frame_ms):.2f} ms "
          f"(p90 {np.percentile(frame_ms, 90):.2f} ms), "
          f"n_active median {int(np.median([o.n_active for o in steady]))}; "
          f"{nvidia_smi_line()}")
    if len(outs) < 40 or len(steady) < 30:
        raise AssertionError(f"too few frames: {len(outs)} ({len(steady)} steady)")
    need_cascade("lio per-frame", launches, len(steady))
    if (len(cascades) != len(steady) or searches or launches["knn5_plane"]
            or launches["knn5_plane_hashed"] or launches["photometric_step"]
            or launches["patches_and_grads"] or launches["imu_propagate"] != len(groups)
            or launches["delete_boxes"] != len(boxes) or not boxes
            or not launches["voxel_centroids"] == launches["voxel_sort"] == filt["n"]
            == len(keys) == len(steady) or launches["voxel_keys"] or launches["vio_dedup"]
            or launches["vio_push"]
            or not (launches["insert_sort"] == launches["insert_tiles"] == ins["n"]
                    == len(isorts) > len(steady) - 1) or launches["insert_keys"]
            or not launches["undistort"] >= step["n"] == len(steady)):
        raise AssertionError(f"launches {launches} for {len(cascades)} cascades, "
                             f"{len(searches)} searches, {len(groups)} groups, "
                             f"{len(steady)} steady frames, {len(boxes)} box deletes, "
                             f"{filt['n']} voxel filters, {ins['n']} inserts, "
                             f"{step['n']} frame steps")
    if not (np.isfinite(pos).all() and torch.isfinite(pipe.state.cov).all()):
        raise AssertionError("non-finite state")
    if not ate < 0.02:
        raise AssertionError(f"ATE {ate:.4f} m >= 2 cm")
    nums = check_lio_cascades(cascades, "lio per-frame")
    nums["stages"] = check_stage_calls(keys, [], [], isorts, "lio per-frame")
    return (pipe, launches, outs, ds, 1e3 * wall / len(outs), cascades[-1][0], nums, boxes,
            {"filter": filt["last"], "insert": ins["last"], "first": ins["first"],
             "frame": step["last"], "keys": keys[-1]})


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
    pool of 256 images of 640x512). The kernels' launch counts are read
    around this run only: the fused search once per search, the
    photometric cascade once per camera frame step, the standalone kernels,
    photometric_err_H and photometric_step never. Camera-frame time: host
    wall of Vio.update, its stats read included. After the run every
    cascade is held against the host loop on its inputs (check_cascades).
    Every camera frame's vio_select and vio_observations calls are
    recorded with a copy of the visual map and held after the run against
    their plain versions (check_vio_calls). Returns (launches, the
    recorded cascade calls, camera and lidar frame medians in ms, the
    outputs, the dataset, wall ms per lidar frame, the cascades', the LIO
    cascades' and the camera frames' numbers, the last recorded camera
    frame, the last camera voxel filter call's arguments, the last
    recorded key pass (the camera cloud's), dedup and push). Every key
    pass, dedup and image-pool push is recorded and replayed after the
    run by its kernel and its plain version (check_stage_calls):
    voxel_sort once per filtered scan and camera cloud (voxel_keys never), vio_dedup once
    per camera frame step, vio_push once per camera frame.
    tiled_delete_boxes must launch once per tracker update with boxes,
    voxel_centroids once per steady lidar frame and once per camera frame
    step, the insert's three passes once per insert, undistort once per
    lidar frame step and bootstrap scan."""
    from fastlivo_tpu_torch import imu as imu_mod
    from fastlivo_tpu_torch import lio
    from fastlivo_tpu_torch import pipeline as pipeline_mod
    from fastlivo_tpu_torch import vio as vio_mod
    from fastlivo_tpu_torch.ops import tiled_map as tm
    from fastlivo_tpu_torch.ops import voxel_filter as vf
    from fastlivo_tpu_torch.pipeline import Pipeline

    cfg = livo_config()
    cap = cfg.capacity
    print(f"livo config: camera {cfg.camera.width}x{cfg.camera.height} f={cfg.camera.fx}, "
          f"grid {cfg.grid_size}, patch {cfg.patch_size}, max_iteration "
          f"{cfg.max_iteration}, visual map {cap.vmap_points} pts x {cap.vmap_obs} obs, "
          f"{cap.vmap_table_size} slots x {cap.vmap_voxel_cap}, pool "
          f"{cap.frame_ring} x u8={cap.frame_ring_u8}")
    ds = Recorded(livo_dataset(cfg, duration=duration, points_per_scan=points_per_scan,
                               lidar_noise=0.004, seed=0))
    pipe = Pipeline(cfg, device=dev)
    push_all(pipe, ds)
    vio = pipe.vio
    cam_ms, searches, cascades, groups, lio_calls, vio_calls = [], [], [], [], [], []
    boxes, lid_filt, cam_filt, ins, step = [], {}, {}, {}, {}
    keys, dedups, pushes, isorts = [], [], [], []
    torch.cuda.synchronize()
    reset_counts()
    with spy(lio, "knn5_plane_search", searches), recorded_cascades(cascades), \
            spy(imu_mod, "propagate_wire", groups), timed_camera_frames(vio, cam_ms), \
            recorded_lio(lio_calls), recorded_vio(vio_calls), recorded_boxes(pipe, boxes), \
            recorded_calls(vf, lid_filt), recorded_calls(vio_mod, cam_filt), \
            recorded_calls(tm, ins, "insert"), \
            recorded_calls(pipeline_mod, step, "lidar_frame_step"), \
            recorded_all(vf, "_sorted_keys", keys), recorded_all(vio_mod, "_dedup_voxels", dedups), \
            recorded_pushes(pushes), recorded_insert_sorts(isorts):
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
    lid_ms = [1e3 * o.timing["total"] for o in steady]
    n_pts = int(vio.vmap.n_pts)
    print(f"livo path: {len(outs)} lidar frames ({len(steady)} steady), {vio.fid} camera "
          f"frames ({vio.steps} ran the frame step) in {wall:.2f} s; {len(lio_calls)} LIO "
          f"cascades, {len(searches)} searches outside them, {len(cascades)} photometric "
          f"cascades, {len(groups)} propagated "
          f"groups; launches {launches}; "
          f"ATE {ate * 1e3:.3f} mm; visual map {n_pts} points, last {vio.last_stats}")
    print(f"livo path: camera frame median {np.median(cam_ms):.2f} ms (p90 "
          f"{np.percentile(cam_ms, 90):.2f} ms) over {len(cam_ms)}; lidar frame median "
          f"{np.median(lid_ms):.2f} ms (p90 {np.percentile(lid_ms, 90):.2f} ms) over "
          f"{len(lid_ms)}; {nvidia_smi_line()}")
    if len(steady) < 30 or vio.steps < 30:
        raise AssertionError(f"too few frames: {len(steady)} steady, {vio.steps} camera")
    if n_pts <= 50 or vio.last_stats.get("tracked", 0) <= 5:
        raise AssertionError(f"visual map {n_pts} points, last {vio.last_stats}")
    if (len(cascades) != vio.steps or searches or len(lio_calls) != len(steady)
            or len(vio_calls) != vio.steps):
        raise AssertionError(f"{len(cascades)} cascades, {len(lio_calls)} LIO cascades, "
                             f"{len(searches)} searches, {len(vio_calls)} camera frames "
                             f"recorded")
    want = {"knn5_plane_tiled": 0, "knn5_plane_hashed": 0, "knn5_plane": 0,
            "photometric_err_H": 0, "photometric_cascade": vio.steps, "photometric_step": 0,
            "patches_and_grads": 0, "imu_propagate": len(groups),
            "lio_cascade": len(steady), "vio_select": vio.steps,
            "vio_observations": vio.steps, "delete_boxes": len(boxes),
            "voxel_centroids": lid_filt["n"] + cam_filt["n"], "insert_keys": 0,
            "insert_tiles": ins["n"], "insert_sort": ins["n"],
            "undistort": max(launches["undistort"], step["n"]), **dict.fromkeys(FLAT_KERNELS, 0),
            "voxel_sort": lid_filt["n"] + cam_filt["n"], "voxel_keys": 0,
            "vio_dedup": vio.steps, "vio_push": vio.fid}
    if (launches != want or lid_filt["n"] != len(steady) or cam_filt["n"] != vio.steps
            or len(keys) != want["voxel_sort"] or len(dedups) != vio.steps
            or len(isorts) != ins["n"]
            or len(pushes) != vio.fid
            or not ins["n"] >= step["n"] == len(steady)):
        raise AssertionError(f"launches {launches}, want {want}, {lid_filt['n']} lidar and "
                             f"{cam_filt['n']} camera voxel filters")
    if not (np.isfinite(pos).all() and torch.isfinite(pipe.state.cov).all()):
        raise AssertionError("non-finite state")
    if not ate < 0.06:
        raise AssertionError(f"LIVO ATE {ate:.4f} m >= 6 cm")
    nums = check_cascades(cascades, "livo per-frame")
    lio_nums = check_lio_cascades(lio_calls, "livo per-frame")
    del lio_calls
    vio_nums = check_vio_calls(vio_calls, "livo per-frame")
    vio_nums["stages"] = check_stage_calls(keys, dedups, pushes, isorts, "livo per-frame")
    return (launches, cascades, float(np.median(cam_ms)), float(np.median(lid_ms)),
            outs, ds, 1e3 * wall / len(outs), nums, lio_nums, vio_nums, vio_calls[-1],
            cam_filt["last"], {"keys": keys[-1], "dedup": dedups[-1], "push": pushes[-1]})


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


def wide_config(W=640, H=512, F=400.0, grid=10):
    """livo_config at patch_size 24, grid_size 10 (64 x 51 = 3264 cells on
    the 640x512 camera) and max_imu_per_group 1024 (a scan pose table of
    8200 rows): each kernel past its shared-memory stage or its old cap
    (vio_select's wide patch trees of 1024 values, the photometric
    kernels' loop over a block's pixels, vio_observations' insert arrays
    past 2048 rows, undistort's offsets past 4104 rows), at capacities
    that the CPU runs too: 4096-point scans, a 32 x 32 x 16 tiled
    directory of 1024 tiles, the shipped visual map (65536 points x 20
    observations, 2^18 slots), a pool of 16 u8 images."""
    from fastlivo_tpu_torch.config import CapacityConfig, Config

    cfg = Config()
    cfg.patch_size = 24
    cfg.grid_size = grid
    cfg.capacity = CapacityConfig(max_points=4096, max_raw_points=8192,
                                  tiled_dir_dims=(32, 32, 16), tiled_pool=1024,
                                  frame_ring=16, max_imu_per_group=1024)
    return livo_config(cfg, W=W, H=H, F=F)


def wide_phase(dev, duration=3.0, cfg=None, imu_hz=2000.0, cpu_frames=10):
    """LIVO at wide_config() (a 2 kHz IMU; the scan pose table has 8200
    rows whatever the rate) on the card
    and on the CPU, the same recorded data. The card run's kernels
    counted around it: vio_select, vio_observations and
    photometric_cascade once per camera frame step, undistort once per
    lidar frame step and bootstrap scan (every table of 8200 rows). After
    it every camera frame's vio_select and vio_observations are held
    against their plain versions (check_vio_calls) and every cascade
    against its host loop (check_cascades); the card's positions within
    2 mm of the CPU's over the first `cpu_frames` lidar frames (the CPU
    run on the pushes before the next frame's scan: at P = 24 its plain
    measurement costs most of the phase). Then the changed kernels are timed at these sizes
    (vio_select on the last camera frame at patch sizes 16, 24, 32 and 48,
    bit-equal to its plain version at each; vio_observations on it; the
    last photometric cascade at the path's patch size beside its host
    loop, and photometric_err_H on its first iteration, bit-equal to its
    plain version; undistort on the last frame step) beside their plain
    versions and bounds. Returns (ms per lidar frame, launches,
    numbers)."""
    from fastlivo_tpu_torch import imu as imu_mod
    from fastlivo_tpu_torch import pipeline as pipeline_mod
    from fastlivo_tpu_torch import vio
    from fastlivo_tpu_torch.ops import photometric as ph
    from fastlivo_tpu_torch.ops import vio_observations as vo
    from fastlivo_tpu_torch.ops import vio_select as vs
    from fastlivo_tpu_torch.pipeline import Pipeline

    cfg = cfg or wide_config()
    G = (cfg.camera.width // cfg.grid_size) * (cfg.camera.height // cfg.grid_size)
    ds = Recorded(livo_dataset(cfg, duration=duration, points_per_scan=4096,
                               lidar_noise=0.004, seed=7, imu_hz=imu_hz))
    pipe = Pipeline(cfg, device=dev)
    push_all(pipe, ds)
    vio_calls, cascades, step = [], [], {}
    with recorded_vio(vio_calls), recorded_cascades(cascades), \
            recorded_calls(pipeline_mod, step, "lidar_frame_step"):
        outs, launches, wall = counted_run(pipe.spin)
    steps = pipe.vio.steps
    M = pipe.max_scan_poses
    print(f"wide livo (patch {cfg.patch_size}, grid {cfg.grid_size}: {G} cells, "
          f"max_imu_per_group {cfg.capacity.max_imu_per_group}: {M} pose rows, IMU bucket "
          f"{pipe._imu_bucket}): {len(outs)} lidar frames, {steps} camera steps in "
          f"{wall / 1e3:.2f} s, launches {launches}, visual map {int(pipe.vio.vmap.n_pts)} "
          f"points, last {pipe.vio.last_stats}")
    if len(outs) < 20 or steps < 10 or step["n"] < 10:
        raise AssertionError(f"wide livo: {len(outs)} frames, {steps} camera steps")
    need_vio("wide livo", launches, steps)
    if (launches["photometric_cascade"] != steps or launches["undistort"] < step["n"]
            or len(cascades) != steps or len(vio_calls) != steps):
        raise AssertionError(f"wide livo: launches {launches}, {steps} camera steps, "
                             f"{step['n']} frame steps")
    nums = {"cells": G, "patch_size": cfg.patch_size, "pose_rows": M,
            "imu_bucket": pipe._imu_bucket, "camera_steps": steps,
            "tracked_last": pipe.vio.last_stats.get("tracked", 0)}
    nums["camera_frames"] = check_vio_calls(vio_calls, "wide livo")
    nums["cascades"] = check_cascades(cascades, "wide livo")
    last_cascade = list(cascades[-1][0])
    del cascades
    cpu = Pipeline(cfg, device="cpu")
    push_all(cpu, ds, t_max=outs[cpu_frames].t)
    t0 = time.perf_counter()
    ref = cpu.spin()
    cpu_s = time.perf_counter() - t0
    d = max_diff(outs[:len(ref)], ref)
    nums.update(cpu_seconds=cpu_s, max_diff_to_cpu_mm=d * 1e3, cpu_frames=len(ref),
                cpu_camera_steps=cpu.vio.steps, tracked=nums["camera_frames"]["tracked"])
    print(f"wide livo: card against CPU over the first {len(ref)} lidar frames "
          f"({cpu.vio.steps} camera steps): max position difference {d * 1e3:.4f} mm (CPU "
          f"run {cpu_s:.1f} s)")
    if not (d < 2e-3 and len(ref) >= cpu_frames and cpu.vio.steps >= cpu_frames // 2):
        raise AssertionError(f"wide livo: card and CPU differ by {d:.3g} m over {len(ref)} "
                             f"frames, {cpu.vio.steps} camera steps")
    del cpu, ref

    # the changed kernels at these sizes (these launches are not the path's)
    counts = read_counts()
    rec = vio_calls[-1]
    del vio_calls
    snap, a, kw, out = rec["select"]
    oa, _ = rec["obs"]
    sel = {}
    for P in (16, 24, 32, 48):
        kp = dict(kw, patch_size=P)
        o = vs.vio_select(snap, *a, **kp)
        want = vs.vio_select_plain(snap, *a, **kp)
        d = max(bits_diff(x, y) for x, y in zip([*o[0], *o[1], *o[2]],
                                                [*want[0], *want[1], *want[2]]))
        if d != 0.0:
            raise AssertionError(f"wide livo: vio_select at patch size {P}: {d} from the plain "
                                 "version")
        b, by, byts, ops = vio_select_bound_ms(snap, a, kp, o)
        sel[P] = {"ms": time_ms(lambda: vs.vio_select(snap, *a, **kp)),
                  "plain_ms": event_ms(lambda: vs.vio_select_plain(snap, *a, **kp), reps=5),
                  "bound_ms": b, "bound_by": by, "bytes": byts, "ops": ops,
                  "grid": vs.vio_select.grid, "tracked": int(o[0].valid.sum())}
    after = vo.vio_observations_plain(clone_map(snap), *oa)
    m1, m2 = clone_map(snap), clone_map(snap)
    b, by, byts, ops = vio_observations_bound_ms(snap, oa, after)
    obs = {"ms": time_ms(lambda: vo.vio_observations(m1, *oa)),
           "plain_ms": event_ms(lambda: vo.vio_observations_plain(m2, *oa), reps=5),
           "bound_ms": b, "bound_by": by, "bytes": byts, "ops": ops,
           "grid": vo.vio_observations.grid, "rows": G}
    del after, m1, m2, snap, rec
    (st, _m, pose, calib, pts_raw, t_rel, rmask, *_), _ = step["last"]
    ua = (st, pose, pts_raw, t_rel, rmask, calib)
    if bits_diff(imu_mod.undistort(*ua), imu_mod.undistort_plain(*ua)) != 0.0:
        raise AssertionError("wide livo: undistort not bit-equal to undistort_plain")
    b, by, byts, ops = undistort_bound_ms(ua)
    und = {"ms": time_ms(lambda: imu_mod.undistort(*ua)),
           "plain_ms": event_ms(lambda: imu_mod.undistort_plain(*ua), reps=30),
           "bound_ms": b, "bound_by": by, "bytes": byts, "ops": ops,
           "pose_rows": int(pose.offs.shape[0]), "points": int(pts_raw.shape[0])}
    # the photometric kernels at the path's patch size: the last cascade
    # (bit-equal to its host loop in check_cascades) and the measurement
    # of its first iteration
    a = last_cascade
    its = int(ph.photometric_cascade(*a)[5])
    meas = []
    with spy(vio, "photometric_err_H", meas):
        vio.photometric_loop(*a)
    b, by, _ = cascade_bound_ms([list(m) for m in meas], len(set(a[15])))
    casc = {"ms": time_ms(lambda: ph.photometric_cascade(*a)), "iterations": its,
            "loop_ms": event_ms(lambda: vio.photometric_loop(*a), reps=5), "bound_ms": b,
            "bound_by": by, "grid": ph.photometric_cascade.grid, "patch_size": a[16]}
    with swapped(vio, "photometric_step", ph.photometric_step_plain), \
            swapped(vio, "photometric_err_H", ph.photometric_err_H_plain):
        casc["plain_ms"] = event_ms(lambda: vio.photometric_loop(*a), reps=3)
    m0 = measurement_args(a)
    got, want = ph.photometric_err_H(*m0), ph.photometric_err_H_plain(*m0)
    if bits_diff(torch.cat([t.reshape(-1) for t in got]),
                 torch.cat([t.reshape(-1) for t in want])) != 0.0:
        raise AssertionError("wide livo: photometric_err_H not bit-equal to its plain version")
    b, by, _ = photometric_bound_ms(m0)
    meas_nums = {"ms": time_ms(lambda: ph.photometric_err_H(*m0)),
                 "plain_ms": event_ms(lambda: ph.photometric_err_H_plain(*m0), reps=5),
                 "bound_ms": b, "bound_by": by, "patch_size": m0[13],
                 "points": int(m0[1].shape[0])}
    del meas, last_cascade, a, m0
    for fn in counted_wrappers():
        fn.launches = counts[fn.__name__]
    smi = nvidia_smi_line()
    for P, r in sel.items():
        print(f"wide livo: vio_select at G={G}, P={P} on the last camera frame: kernel "
              f"{r['ms']:.4f} ms ({r['grid']} blocks, {r['tracked']} tracked), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}); {smi}")
    print(f"wide livo: vio_observations at G={G}: kernel {obs['ms']:.4f} ms ({obs['grid']} "
          f"blocks), plain {obs['plain_ms']:.4f} ms, bound {obs['bound_ms']:.5f} ms "
          f"({obs['bound_by']}); undistort at M={und['pose_rows']} ({und['points']} rows): "
          f"kernel {und['ms']:.4f} ms, plain {und['plain_ms']:.4f} ms, bound "
          f"{und['bound_ms']:.5f} ms ({und['bound_by']}); {smi}")
    print(f"wide livo: photometric_cascade at G={G}, P={casc['patch_size']} on the last "
          f"camera frame: {casc['iterations']} iterations in {casc['ms']:.4f} ms "
          f"({casc['grid']} blocks), the host loop {casc['loop_ms']:.4f} ms, all plain "
          f"{casc['plain_ms']:.4f} ms, bound {casc['bound_ms']:.5f} ms ({casc['bound_by']}); "
          f"photometric_err_H on its first iteration: kernel {meas_nums['ms']:.4f} ms, "
          f"bit-equal to its plain version ({meas_nums['plain_ms']:.4f} ms), bound "
          f"{meas_nums['bound_ms']:.5f} ms ({meas_nums['bound_by']}); {smi}")
    nums.update(vio_select=sel, vio_observations=obs, undistort=und,
                photometric_cascade=casc, photometric_err_H=meas_nums)
    return wall / len(outs), launches, nums


def plain_propagation_phase(dev, lio_ds, lio_ref, livo_ds, livo_ref):
    """The LIO and LIVO per-frame paths of path_phase and livo_path_phase
    on the same data, with the plain IMU loop swapped in for the kernel
    (plain_propagation): no imu_propagate launch, and the kernel's paths
    within 1 mm (LIO) and 2 mm (LIVO) of these in every frame. Prints the
    median steady lidar frame of both. Returns ({path: (ms per lidar
    frame, launches)}, {path: its other numbers})."""
    from fastlivo_tpu_torch.pipeline import Pipeline

    paths, extra = {}, {}
    for name, cfg, ds, ref, tol in (
            ("lio per-frame, plain IMU loop", lio_config(), lio_ds, lio_ref, 1e-3),
            ("livo per-frame, plain IMU loop", livo_config(), livo_ds, livo_ref, 2e-3)):
        pipe = Pipeline(cfg, device=dev)
        push_all(pipe, ds)
        with plain_propagation():
            outs, launches, wall = counted_run(pipe.spin)
        d = max_diff(outs, ref)
        med, med_ref = (float(np.median([1e3 * o.timing["total"] for o in r if o.iters > 0]))
                        for r in (outs, ref))
        print(f"{name}: {len(outs)} lidar frames, {wall / len(outs):.2f} ms/lidar frame, "
              f"median steady lidar frame {med:.2f} ms (with imu_propagate {med_ref:.2f} ms), "
              f"max position difference to the kernel's path {d * 1e3:.4f} mm, launches "
              f"{launches}; {nvidia_smi_line()}")
        if launches["imu_propagate"] or not d < tol:
            raise AssertionError(f"{name}: {d:.3g} m from the kernel's path, launches "
                                 f"{launches}")
        paths[name] = (wall / len(outs), launches)
        extra[name] = {"median_steady_ms": med, "median_steady_ms_with_kernel": med_ref,
                       "max_diff_to_kernel_path_mm": d * 1e3}
        del pipe
        torch.cuda.empty_cache()
    return paths, extra


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
    linked = sum(any(f"{s}_kernel" in name for s in KERNEL_STEMS) for name in names)
    return len(names) + max(launched - linked, 0), linked


def sort_kernels_in(prof, stages) -> int:
    """Device kernels of a library radix sort (CUB's onesweep, its
    histogram and scans) under the ranges whose names start with
    `stages`."""
    return sum("onesweep" in name.lower() or "radixsort" in name.lower()
               for e in prof.events()
               if e.name.startswith(stages) and str(e.device_type).endswith("CPU")
               for name in kernel_names(e))


def cpu_op_names(e) -> list:
    """The names of the host ops under a profiler event, at every depth."""
    return [n for c in e.cpu_children for n in [c.name] + cpu_op_names(c)]


def stage_ms(evs, name, n):
    """(host, device) ms per frame under the profiler range `name`."""
    e = [e for e in evs if e.key == name and str(e.device_type).endswith("CPU")]
    return ((e[0].cpu_time_total / 1e3 / n, e[0].device_time_total / 1e3 / n) if e
            else (0.0, 0.0))


def device_kernels(evs, ranges):
    """The profiler's device kernels (not the device-side spans of the
    named `ranges`)."""
    return [e for e in evs if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0 and not e.key.startswith(ranges)]


MAP_STAGE_KERNELS = ("voxel_centroids", "tiled_delete_boxes", "tiled_insert_keys",
                     "tiled_insert_tiles", "undistort", "voxel_sort", "tiled_insert_sort")


def profile_phase(dev, n_warm=30, duration=4.5, points_per_scan=24000, fused=True):
    """Where a steady frame's time goes: torch.profiler over the frames
    after the first `n_warm` scans of a second shipped-capacity run
    (without `fused`, of the unfused composition, the plain IMU loop
    included). Prints the device busy share of the window, device kernels
    per frame, `frame.propagate`'s host and device ms and device kernels
    per frame, the kernels under `lio.search` per frame, and the device
    kernels and host and device ms under `frame.lio_update` per frame;
    with `fused` also the largest kernel names and every stage. Returns
    {"search_kernels", "propagate_kernels", "kernels", "propagate_host_ms",
    "propagate_device_ms", "lio_update_kernels", "lio_update_host_ms",
    "lio_update_device_ms"} per frame."""
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
    check_composition(counts, fused, [("lio_cascade", "knn5_plane")], "lio profile")
    if (counts["imu_propagate"] > 0) != fused or counts["knn5_plane_tiled"]:
        raise AssertionError(f"lio profile ({'fused' if fused else 'unfused'}): {counts}")
    launched = counts["knn5_plane"]
    n_k, linked = kernels_in(prof, "lio.search", launched)
    n_p, _ = kernels_in(prof, "frame.propagate", counts["imu_propagate"])
    n_l, _ = kernels_in(prof, "frame.lio_update", counts["lio_cascade"] + counts["knn5_plane"]
                        + counts["photometric_step"])
    evs = prof.key_averages()
    stage = ("frame.", "lio.")  # the named ranges of frame_step/lio/pipeline
    kernels = device_kernels(evs, stage)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    prop_host, prop_dev = stage_ms(evs, "frame.propagate", n)
    lio_host, lio_dev = stage_ms(evs, "frame.lio_update", n)
    label = "fused" if fused else "unfused, plain IMU loop, LIO host loop"
    print(f"profile ({label}): {n} steady frames, {1e3 * wall / n:.2f} ms/frame wall "
          f"(profiler on), device busy {busy_ms / n:.3f} ms/frame = "
          f"{100 * busy_ms / (1e3 * wall):.1f}% of wall, {launches / n:.0f} device "
          f"kernels/frame, frame.propagate host {prop_host:.3f} ms/frame (device "
          f"{prop_dev:.3f}, {n_p / n:.1f} device kernels), {n_k / n:.1f} device kernels "
          f"under lio.search per frame (the "
          f"profiler linked {linked} of its {launched} hand-written launches to the range), "
          f"frame.lio_update host {lio_host:.3f} ms/frame (device {lio_dev:.3f}, "
          f"{n_l / n:.1f} device kernels)")
    res = {"search_kernels": n_k / n, "propagate_kernels": n_p / n, "kernels": launches / n,
           "propagate_host_ms": prop_host, "propagate_device_ms": prop_dev,
           "lio_update_kernels": n_l / n, "lio_update_host_ms": lio_host,
           "lio_update_device_ms": lio_dev, "device_busy_share": busy_ms / (1e3 * wall),
           "stages": {e.key: {"host_ms": e.cpu_time_total / 1e3 / n,
                              "device_ms": e.device_time_total / 1e3 / n}
                      for e in evs if e.key.startswith(stage)
                      and str(e.device_type).endswith("CPU")}}
    # the voxel filter: its kernels and any library radix sort under it
    vf_host, vf_dev = stage_ms(evs, "frame.voxel_filter", n)
    n_vf, _ = kernels_in(prof, "frame.voxel_filter",
                         counts["voxel_sort"] + counts["voxel_centroids"])
    n_sort = sort_kernels_in(prof, "frame.voxel_filter")
    res.update(voxel_filter_kernels=n_vf / n, voxel_filter_sort_kernels=n_sort / n)
    print(f"profile ({label}): frame.voxel_filter host {vf_host:.3f} ms/frame, device "
          f"{vf_dev:.3f} ms/frame, {n_vf / n:.1f} device kernels/frame, of them "
          f"{n_sort / n:.1f} of a library radix sort (onesweep)")
    if fused and n_sort:
        raise AssertionError(f"lio profile: {n_sort} library sort kernels under "
                             f"frame.voxel_filter")
    # the tiled insert: its keys and sort one hand-written launch, no library sort
    mi_host, mi_dev = stage_ms(evs, "frame.map_insert", n)
    n_isort = sort_kernels_in(prof, "frame.map_insert")
    res.update(map_insert_sort_kernels=n_isort / n)
    print(f"profile ({label}): frame.map_insert host {mi_host:.3f} ms/frame, device "
          f"{mi_dev:.3f} ms/frame, {n_isort / n:.1f} library radix sort kernels/frame")
    if fused and n_isort:
        raise AssertionError(f"lio profile: {n_isort} library sort kernels under "
                             f"frame.map_insert")
    if not fused:
        return res
    if not kernels:
        print("profile: the profiler saw no device time")
    # the map stages' hand-written kernels: launches a frame, device us a launch
    res["map_stage_kernels"] = {
        name: {"per_frame": e.count / n, "device_us": e.self_device_time_total / e.count}
        for e in kernels for name in MAP_STAGE_KERNELS if name + "_kernel" in e.key}
    print("profile: map-stage kernels " + ", ".join(
        f"{k} {v['per_frame']:.2f} a frame, {v['device_us']:.2f} us a launch"
        for k, v in res["map_stage_kernels"].items()) + f"; {nvidia_smi_line()}")
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
    return res


def livo_profile_phase(dev, t_warm=3.0, duration=4.5, points_per_scan=24000, fused=True):
    """Where a camera frame's time goes: torch.profiler over the LIVO
    frames after `t_warm` s of a second shipped-capacity LIVO run
    (without `fused`, of the unfused composition). Prints each `vio.*`
    stage's host and device ms per camera frame, the device kernels
    launched per camera frame under `vio.*` and under `vio.photometric`,
    and per lidar + camera pair all device kernels of the window and
    `frame.propagate`'s host ms and device kernels (a lidar and an image
    group). Returns {"photometric_kernels", "photometric_host_ms",
    "photometric_device_ms", "kernels_per_pair", "propagate_kernels_per_pair",
    "propagate_host_ms"}."""
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
    check_composition(counts, fused, [("lio_cascade", "knn5_plane"),
                                      ("photometric_cascade", "patches_and_grads")],
                      "livo profile")
    if counts["photometric_err_H"] or counts["photometric_step"]:
        raise AssertionError(f"livo profile: the host loop's kernels launched, {counts}")
    if (counts["imu_propagate"] > 0) != fused or not (
            counts["vio_select"] == counts["vio_observations"] == (n_cam if fused else 0)):
        raise AssertionError(f"livo profile ({'fused' if fused else 'unfused'}): {counts}")
    evs = prof.key_averages()
    # what runs under vio.observations: no host read on the kernels' route
    under = [n for e in prof.events() if e.name == "vio.observations"
             and str(e.device_type).endswith("CPU") for n in cpu_op_names(e)]
    reads = sum(n in ("aten::nonzero", "aten::item", "aten::_local_scalar_dense")
                for n in under)
    if fused and reads:
        raise AssertionError(f"livo profile: {reads} host reads under vio.observations")
    stages = sorted((e for e in evs if e.key.startswith("vio.")
                     and str(e.device_type).endswith("CPU")),
                    key=lambda e: -e.cpu_time_total)
    launched = counts["photometric_cascade"] + counts["patches_and_grads"]
    n_k, _ = kernels_in(prof, "vio.", launched + counts["vio_select"]
                        + counts["vio_observations"])
    n_sel, _ = kernels_in(prof, "vio.select", counts["vio_select"])
    n_obs, _ = kernels_in(prof, "vio.observations", counts["vio_observations"])
    # under vio.push its one launch; under vio.voxel_filter the cloud's key
    # pass and centroid and the dedup, one launch each a camera frame
    n_push, _ = kernels_in(prof, "vio.push", counts["vio_push"])
    n_vf, _ = kernels_in(prof, "vio.voxel_filter", 3 * counts["vio_dedup"])
    n_vsort = sort_kernels_in(prof, "vio.voxel_filter")
    if fused and n_vsort:
        raise AssertionError(f"livo profile: {n_vsort} library sort kernels under "
                             f"vio.voxel_filter")
    n_isort = sort_kernels_in(prof, "frame.map_insert") + sort_kernels_in(prof,
                                                                          "frame.voxel_filter")
    if fused and n_isort:
        raise AssertionError(f"livo profile: {n_isort} library sort kernels under "
                             f"frame.map_insert and frame.voxel_filter")
    if fused and (n_sel > n_cam or n_obs > 2 * n_cam):
        raise AssertionError(f"livo profile: {n_sel} kernels under vio.select_*, {n_obs} under "
                             f"vio.observations for {n_cam} camera frames (at most 1 and 2 "
                             "a frame: the poses are computed in the kernels)")
    sel_host = sum(stage_ms(evs, r, n_cam)[0] for r in ("vio.select_tracked", "vio.select_new"))
    obs_host = stage_ms(evs, "vio.observations", n_cam)[0]
    n_photo, linked = kernels_in(prof, "vio.photometric", launched)
    n_p, _ = kernels_in(prof, "frame.propagate", counts["imu_propagate"])
    kernels = device_kernels(evs, ("frame.", "lio.", "vio."))
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    per_pair = sum(e.count for e in kernels) / n_cam
    prop_host, _ = stage_ms(evs, "frame.propagate", n_cam)
    photo_host, photo_dev = stage_ms(evs, "vio.photometric", n_cam)
    photo = n_photo / n_cam
    print(f"livo profile ({'fused' if fused else 'unfused, plain IMU loop'}): {n_cam} camera "
          f"frames, {len(outs)} lidar frames, "
          f"{1e3 * wall:.1f} ms wall (profiler on), device busy {busy:.2f} ms = "
          f"{100 * busy / (1e3 * wall):.1f}% of wall; device kernels per camera "
          f"frame under vio.* {n_k / n_cam:.0f}, under vio.photometric {photo:.1f} (the "
          f"profiler linked {linked} of its {launched} hand-written launches to the range); "
          f"per lidar + camera pair {per_pair:.0f} device kernels, frame.propagate host "
          f"{prop_host:.3f} ms and {n_p / n_cam:.1f} device kernels; under vio.select_* "
          f"{n_sel / n_cam:.1f} device kernels and {sel_host:.3f} ms host per camera frame, "
          f"under vio.observations {n_obs / n_cam:.1f} and {obs_host:.3f} ms, host reads "
          f"there {reads}; under vio.push {n_push / n_cam:.1f} and under vio.voxel_filter "
          f"{n_vf / n_cam:.1f} device kernels per camera frame (of them "
          f"{n_vsort / n_cam:.1f} of a library radix sort, onesweep)")
    for e in stages:
        print(f"  stage {e.key:20s} host {e.cpu_time_total / 1e3 / n_cam:8.3f} ms/camera frame, "
              f"device {e.device_time_total / 1e3 / n_cam:8.3f} ms/camera frame, "
              f"{e.count / n_cam:.1f} calls/camera frame")
    return {"photometric_kernels": photo, "photometric_host_ms": photo_host,
            "photometric_device_ms": photo_dev, "kernels_per_pair": per_pair,
            "propagate_kernels_per_pair": n_p / n_cam, "propagate_host_ms": prop_host,
            "select_kernels": n_sel / n_cam, "select_host_ms": sel_host,
            "observations_kernels": n_obs / n_cam, "observations_host_ms": obs_host,
            "push_kernels": n_push / n_cam, "voxel_filter_kernels": n_vf / n_cam,
            "voxel_filter_sort_kernels": n_vsort / n_cam,
            "lidar_stage_sort_kernels": n_isort / n_cam,
            "observations_host_reads": reads, "camera_frames": n_cam,
            "device_busy_share": busy / (1e3 * wall),
            "stages": {e.key: {"host_ms": e.cpu_time_total / 1e3 / n_cam,
                               "device_ms": e.device_time_total / 1e3 / n_cam}
                       for e in stages}}


def fingerprint(m) -> int:
    """An order-sensitive sum of every map array's bits, on its device: two
    maps with equal fingerprints are, but for a collision, equal."""
    total = 0
    for t in m:
        b = t.reshape(-1)
        b = (b.view(torch.int32) if b.element_size() == 4 else b.view(torch.int64)
             if b.element_size() == 8 else b.to(torch.int32)).long()
        w = torch.arange(b.numel(), device=b.device) % 1000003 + 1
        total = (total * 1000033 + int((b * w).sum())) % (1 << 61)
    return total


@contextlib.contextmanager
def traced_steps(trace: dict):
    """Record, on the CPU, the bootstrap insert's batch (trace["boot"])
    and at each lidar_frame_step (trace["steps"]): the map's fingerprint
    before it, the propagated state and pose table, the undistortion's
    arguments (kept on their device), the downsampled points and mask,
    the EKF iterations and the posterior state. Not for a timed run: every
    step reads the device."""
    from fastlivo_tpu_torch import pipeline as pipeline_mod
    from fastlivo_tpu_torch.ops import tiled_map as tm

    real_step, real_insert = pipeline_mod.lidar_frame_step, tm.insert
    trace["steps"] = []

    def insert(m, pts, valid, *a):
        if "boot" not in trace:
            trace["boot"] = (pts.cpu(), valid.cpu())
        return real_insert(m, pts, valid, *a)

    def step(*args, **kw):
        st, m, pose = args[0], args[1], args[2]
        rec = {"map": fingerprint(m), "state": (st.rot.cpu(), st.pos.cpu()),
               "pose": to_cpu(pose),
               "und_args": (st, pose, args[4], args[5], args[6], args[3])}
        out = real_step(*args, **kw)
        rec.update(down=out[2].cpu(), dmask=out[3].cpu(), iters=int(out[5]),
                   post=(out[0].rot.cpu(), out[0].pos.cpu()))
        trace["steps"].append(rec)
        return out

    with swapped(pipeline_mod, "lidar_frame_step", step), swapped(tm, "insert", insert):
        yield


def undistort_on_own_inputs(und_args) -> tuple:
    """The undistortion on each card step's own inputs, the kernel against
    the plain version on the CPU: (steps bit-equal, the first step that
    differs or None, the largest difference in m)."""
    from fastlivo_tpu_torch import imu as imu_mod

    same, first, err = 0, None, 0.0
    for k, args in enumerate(und_args):
        got = imu_mod.undistort(*args).cpu()
        want = imu_mod.undistort_plain(*(to_cpu(x) for x in args))
        if bits_diff(got, want) == 0.0:
            same += 1
        elif first is None:
            first = k
        err = max(err, float((got - want).abs().max()))
    return same, first, err


STAGES = ("map", "propagation", "undistortion", "downsampled points", "voxel set",
          "EKF iterations", "posterior")


def first_difference(card: dict, cpu: dict) -> dict:
    """The first step and stage (STAGES, in the frame's order) at which the
    card's trace and the CPU's differ, and the bootstrap batch's
    difference: the map before the step (fingerprint), the propagated
    state and pose table (bits), the undistorted scan (each device's own
    kernel or plain version on its own inputs), the downsampled points
    (bits), their voxel set (mask), the EKF iterations and the posterior
    state (bits); and the first step at which each stage differs."""
    from fastlivo_tpu_torch import imu as imu_mod

    boot = max(bits_diff(a, b) for a, b in zip(card["boot"], cpu["boot"]))
    first = None
    by_stage = dict.fromkeys(STAGES)  # the first step at which each stage differs
    for k, (a, b) in enumerate(zip(card["steps"], cpu["steps"])):
        und_a = imu_mod.undistort(*a["und_args"]).cpu()
        und_b = imu_mod.undistort_plain(*b["und_args"])
        diffs = {
            "map": 0.0 if a["map"] == b["map"] else float("inf"),
            "propagation": max([bits_diff(x, y) for x, y in zip(a["state"], b["state"])]
                               + [bits_diff(x, y) for x, y in zip(a["pose"], b["pose"])]),
            "undistortion": bits_diff(und_a, und_b),
            "downsampled points": bits_diff(a["down"], b["down"]),
            "voxel set": 0.0 if torch.equal(a["dmask"], b["dmask"]) else float("inf"),
            "EKF iterations": float(abs(a["iters"] - b["iters"])),
            "posterior": max(bits_diff(x, y) for x, y in zip(a["post"], b["post"]))}
        for stage in STAGES:
            if diffs[stage] != 0.0 and by_stage[stage] is None:
                by_stage[stage] = k
            if diffs[stage] != 0.0 and first is None:
                first = {"step": k, "stage": stage, "difference": diffs[stage]}
    return {**(first or {"step": None, "stage": None, "difference": 0.0}),
            "first_step_by_stage": by_stage, "bootstrap_batch_difference": boot}


def cpu_agreement(dev):
    """A small input through the port on the card and on the CPU (its
    plain versions): every frame within 1 mm. Prints, on a line of its
    own, the first step and stage at which the two differ
    (first_difference) and the undistortion on each card step's own
    inputs against the CPU's plain version. Returns those numbers."""
    from fastlivo_tpu_torch.config import CapacityConfig, Config
    from fastlivo_tpu_torch.io.synthetic import SyntheticDataset
    from fastlivo_tpu_torch.pipeline import Pipeline

    res, traces = [], []
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
        trace = {}
        with traced_steps(trace):
            res.append(pipe.spin())
        traces.append(trace)
    a, b = res
    if len(a) != len(b) or len(a) < 25:
        raise AssertionError(f"frames {len(a)} on {dev} vs {len(b)} on cpu")
    dmax = max(np.linalg.norm(x.pos - y.pos) for x, y in zip(a, b))
    first = first_difference(*traces)
    same, und_first, und_err = undistort_on_own_inputs(
        [r["und_args"] for r in traces[0]["steps"]])
    pos_d = [float(np.linalg.norm(x.pos - y.pos)) for x, y in zip(a, b)]
    first_pos = next((k for k, e in enumerate(pos_d) if e > 0.0), None)
    print(f"small input, {dev} vs cpu, first difference over {len(traces[0]['steps'])} frame "
          f"steps: step {first['step']}, stage {first['stage']} ({first['difference']:.3g}; "
          f"stages in order {', '.join(STAGES)}; each stage's first differing step "
          f"{first['first_step_by_stage']}), the bootstrap batch "
          f"{first['bootstrap_batch_difference']:.3g} apart; the undistortion on each card "
          f"step's inputs, kernel against the CPU's plain version: bit-equal at {same} of "
          f"{len(traces[0]['steps'])} steps (the first differing {und_first}), max difference "
          f"{und_err:.3g} m; the first frame whose position differs {first_pos}")
    print(f"small input, {dev} vs cpu: {len(a)} frames, max position "
          f"difference {dmax * 1e3:.4f} mm")
    if not dmax < 1e-3:
        raise AssertionError(f"{dev} and cpu differ by {dmax:.2e} m")
    return {"max_diff_to_cpu_mm": dmax * 1e3, "first_difference": first,
            "undistort_bit_equal_steps": same, "undistort_first_differing_step": und_first,
            "undistort_max_abs_diff_m": und_err, "first_frame_position_differs": first_pos}


def imu_4khz_phase(dev, duration=3.0):
    """A short LIO run with a 4 kHz IMU and capacity.max_imu_per_group 512
    (~400 pairs a 10 Hz group, the 512 bucket) on the card and on the
    CPU, 4096-point scans: one imu_propagate launch per propagated
    group, the 512 bucket reached, every frame within 1 mm of the CPU's.
    Each steady frame's downsampled scan and EKF iterations are recorded on
    both devices, and the first frame where the card's and the CPU's
    downsampled points differ in a bit, in their voxel set, or in their
    iterations is printed. Returns (ms per lidar frame, launches,
    numbers)."""
    from fastlivo_tpu_torch import imu as imu_mod
    from fastlivo_tpu_torch import pipeline as pipeline_mod
    from fastlivo_tpu_torch.config import CapacityConfig, Config
    from fastlivo_tpu_torch.io.synthetic import SyntheticDataset
    from fastlivo_tpu_torch.pipeline import Pipeline

    res = []
    for d in (dev, "cpu"):
        cfg = Config()
        cfg.img_enable = False
        cfg.capacity = CapacityConfig(max_points=4096, max_raw_points=8192,
                                      tiled_dir_dims=(32, 32, 16), tiled_pool=1024,
                                      max_imu_per_group=512)
        ds = SyntheticDataset(duration=duration, points_per_scan=4096, lidar_noise=0.004,
                              seed=3, imu_hz=4000.0)
        pipe = Pipeline(cfg, device=d)
        for beg, pts, t_rel in ds.lidar_scans_fast():
            pipe.push_lidar(beg, pts, t_rel)
        for t, acc, gyr in ds.imu_stream():
            pipe.push_imu(t, acc, gyr)
        groups, steps, und_args = [], [], []
        real = pipeline_mod.lidar_frame_step

        def recorded(*args, **kw):
            out = real(*args, **kw)
            steps.append((out[2], out[3], out[5]))  # down, dmask, iters (fresh tensors)
            # undistort's arguments: the state, pose table and scan are fresh each step
            und_args.append((args[0], args[2], args[4], args[5], args[6], args[3]))
            return out

        with spy(imu_mod, "propagate_wire", groups), \
                swapped(pipeline_mod, "lidar_frame_step", recorded):
            outs, launches, wall = counted_run(lambda: pipe.spin() + pipe.finish())
        res.append((outs, launches, wall, groups, pipe._imu_bucket, steps))
        if d == dev:
            card_und = und_args
    (a, la, wa, ga, ba, sa), (b, _, _, _, bb, sb) = res
    # the undistortion alone, on each card step's own inputs: the kernel
    # against the plain version on the CPU (sinf / cosf their only
    # difference since the plain version's sums are the kernel's)
    und_same, und_first, und_err = undistort_on_own_inputs(card_und)
    d = max_diff(a, b)
    first = {"bits": None, "voxel_set": None, "iters": None}
    for k, ((da, ma, ia), (db, mb, ib)) in enumerate(zip(sa, sb)):
        da, ma = da.cpu(), ma.cpu()
        if first["bits"] is None and bits_diff(da, db) != 0.0:
            first["bits"] = k
        if first["voxel_set"] is None and not torch.equal(ma, mb):
            first["voxel_set"] = k
        if first["iters"] is None and int(ia) != int(ib):
            first["iters"] = k
    pos_d = [float(np.linalg.norm(x.pos - y.pos)) for x, y in zip(a, b)]
    first_pos = next((k for k, e in enumerate(pos_d) if e > 0.0), None)
    print(f"4 kHz IMU, card vs cpu, over {len(sa)} frame steps ({len(sb)} on the CPU): the "
          f"first step whose downsampled points differ in a bit {first['bits']}, in their "
          f"voxel set {first['voxel_set']}, in EKF iterations {first['iters']}; the first "
          f"frame whose position differs {first_pos} of {len(a)} "
          f"({pos_d[first_pos] * 1e3 if first_pos is not None else 0.0:.3g} mm there); the "
          f"undistortion on each card step's inputs, kernel against the CPU's plain version: "
          f"bit-equal at {und_same} of {len(card_und)} steps (the first differing "
          f"{und_first}), max difference {und_err:.3g} m")
    pairs = max(int(g[1].shape[0]) - 1 for g in ga)
    print(f"4 kHz IMU, max_imu_per_group 512, {dev} vs cpu: {len(a)} frames, "
          f"{len(ga)} propagated groups of up to {pairs} pairs (bucket {ba}), "
          f"{la['imu_propagate']} imu_propagate launches, {wa / len(a):.2f} ms per lidar frame "
          f"on the card, max position difference {d * 1e3:.4f} mm; {nvidia_smi_line()}")
    if not (len(a) >= 20 and la["imu_propagate"] == len(ga) >= len(a) and ba == bb == 512
            and pairs == 512 and d < 1e-3):
        raise AssertionError(f"4 kHz IMU: {len(a)} frames, launches {la}, groups {len(ga)}, "
                             f"buckets {ba} / {bb}, {d} m")
    return wa / len(a), la, {"max_diff_to_cpu_mm": d * 1e3, "groups": len(ga),
                             "bucket": ba, "first_step_differing": first,
                             "first_frame_position_differs": first_pos,
                             "undistort_bit_equal_steps": und_same,
                             "undistort_first_differing_step": und_first,
                             "undistort_max_abs_diff_m": und_err}


def ate_of(outs, ds, t_offset=0.0):
    """RMS position error against the synthetic ground truth after the
    static start."""
    base = ds.traj.base_pos
    errs = [np.linalg.norm(o.pos - (ds.traj.pose(o.t - t_offset)[1] - base))
            for o in outs if o.t - t_offset >= ds.traj.t_static + 0.5]
    return float(np.sqrt(np.mean(np.square(errs))))


def max_diff(outs, ref):
    """Frames equal in number and stamps; returns the largest position
    difference."""
    if len(outs) != len(ref) or any(a.t != b.t for a, b in zip(outs, ref)):
        raise AssertionError(f"{len(outs)} frames against {len(ref)}")
    return max(float(np.linalg.norm(a.pos - b.pos)) for a, b in zip(outs, ref))


def counted_run(fn):
    """fn() with the kernels' counts set to 0 just before and read just
    after; returns (result, launches, wall ms)."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    return res, read_counts(), wall


def need_launches(label, launches, names):
    if not all(launches[n] > 0 for n in names):
        raise AssertionError(f"{label}: launches {launches}, need {names} > 0")


def lio_block_phase(dev, ds, ref, ref_ms):
    """The LIO dataset of path_phase through BlockReplayer(8) and
    LivoBlockReplayer(8) at shipped capacities: the per-frame path's
    frames, each within 5 mm of it, ATE < 2 cm, each EKF one LIO cascade
    launch. Returns {path: (ms per lidar frame, launches)}."""
    from fastlivo_tpu_torch.config import Config
    from fastlivo_tpu_torch.pipeline import Pipeline
    from fastlivo_tpu_torch.replay import BlockReplayer, LivoBlockReplayer

    res = {}
    for name, rep in (("lio BlockReplayer(8)", BlockReplayer),
                      ("lio LivoBlockReplayer(8)", LivoBlockReplayer)):
        cfg = Config()
        cfg.img_enable = False
        pipe = Pipeline(cfg, device=dev)
        push_all(pipe, ds)
        outs, launches, wall = counted_run(lambda: rep(pipe, 8).run())
        d, ate = max_diff(outs, ref), ate_of(outs, ds)
        ms = wall / len(outs)
        print(f"{name}: {len(outs)} frames, {ms:.2f} ms/lidar frame (per-frame path "
              f"{ref_ms:.2f}), max position difference to per-frame {d * 1e3:.4f} mm, "
              f"ATE {ate * 1e3:.3f} mm, launches {launches}; {nvidia_smi_line()}")
        need_launches(name, launches, ["imu_propagate"])
        need_cascade(name, launches, sum(o.iters > 0 for o in outs))
        if not (d < 5e-3 and ate < 0.02):
            raise AssertionError(f"{name}: {d:.4f} m from per-frame, ATE {ate:.4f} m")
        res[name] = (ms, launches)
        del pipe
    return res


def checkpoint_roundtrip(pipe, dev, label):
    """io/checkpoint of `pipe` at its capacities: the host copy and the
    compressed write timed apart, the file's size, and a load back onto
    the card that returns every array unchanged. Returns (copy ms, write
    ms, MB on disk, MB of arrays)."""
    import os
    import tempfile

    from fastlivo_tpu_torch.io import checkpoint as ckpt

    vmap = pipe.vio.vmap if pipe.vio is not None else None
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ck.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arrays = ckpt.to_host(pipe.state, pipe.checkpointable_map(), vmap, pipe.calib)
        t1 = time.perf_counter()
        ckpt.write(path, arrays)
        t2 = time.perf_counter()
        size = os.path.getsize(path) / 1e6
        raw = sum(a.nbytes for a in arrays.values()) / 1e6
        state, m, vm, calib = ckpt.load(path, device=dev)
        for got, want in ((state, pipe.state), (m, pipe.map), (vm, vmap), (calib, pipe.calib)):
            if want is not None and not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{label} checkpoint does not round-trip")
    print(f"{label} checkpoint: {raw:.1f} MB of arrays, host copy {1e3 * (t1 - t0):.1f} ms, "
          f"compressed write {1e3 * (t2 - t1):.1f} ms, {size:.2f} MB on disk, loads back "
          f"equal; {nvidia_smi_line()}")
    return 1e3 * (t1 - t0), 1e3 * (t2 - t1), size, raw


def livo_block_phase(dev, ds, ref, ref_ms):
    """The LIVO dataset of livo_path_phase through LivoBlockReplayer(8):
    the per-frame path's frames within 1 cm, ATE < 6 cm, the fused search
    and the IMU kernel launched, the photometric cascade once per camera
    frame step and each cascade held against the host loop, each EKF one
    LIO cascade launch; then a
    checkpoint of the LIVO estimator (geometric and visual maps at shipped
    capacities). Returns ({path: (ms, launches)}, the checkpoint's
    numbers, the cascades' numbers)."""
    from fastlivo_tpu_torch.pipeline import Pipeline
    from fastlivo_tpu_torch.replay import LivoBlockReplayer

    pipe = Pipeline(livo_config(), device=dev)
    push_all(pipe, ds)
    cascades = []
    with recorded_cascades(cascades):
        outs, launches, wall = counted_run(lambda: LivoBlockReplayer(pipe, 8).run())
    need_vio("livo block", launches, pipe.vio.steps)
    d, ate = max_diff(outs, ref), ate_of(outs, ds)
    ms = wall / len(outs)
    print(f"livo LivoBlockReplayer(8): {len(outs)} lidar frames, {pipe.vio.steps} camera "
          f"steps, {ms:.2f} ms per lidar+camera pair (per-frame path {ref_ms:.2f}), max "
          f"position difference to per-frame {d * 1e3:.4f} mm, ATE {ate * 1e3:.3f} mm, "
          f"launches {launches}; {nvidia_smi_line()}")
    need_launches("livo block", launches, ["photometric_cascade", "imu_propagate"])
    need_cascade("livo block", launches, sum(o.iters > 0 for o in outs))
    if not (d < 1e-2 and ate < 0.06):
        raise AssertionError(f"livo block: {d:.4f} m from per-frame, ATE {ate:.4f} m")
    if not launches["photometric_cascade"] == pipe.vio.steps == len(cascades) or \
            launches["photometric_err_H"] or launches["photometric_step"]:
        raise AssertionError(f"livo block: launches {launches} for {pipe.vio.steps} steps")
    nums = check_cascades(cascades, "livo LivoBlockReplayer(8)")
    ck = checkpoint_roundtrip(pipe, dev, "livo")
    return {"livo LivoBlockReplayer(8)": (ms, launches)}, ck, nums


def lio_messages(ds, t_min=None, t_max=None):
    """The LIO dataset as the server's wire messages, in time order."""
    from fastlivo_tpu_torch import serve

    inside = lambda t: (t_min is None or t >= t_min) and (t_max is None or t < t_max)  # noqa: E731
    ev = [(t, serve.encode_imu(t, a, g)) for t, a, g in ds.imu_stream()
          if inside(t) or (t_max is not None and t_max <= t < t_max + 0.05)]
    ev += [(b, serve.encode_lidar(b, p[:, :3], r.astype(np.float32)))
           for b, p, r in ds.lidar_scans_fast() if inside(b)]
    ev.sort(key=lambda e: e[0])
    return [m for _, m in ev]


def serve_session(srv, msgs):
    """Stream `msgs` and a flush to `srv` over one Unix-socket connection
    while a reader thread takes the odometry lines; returns (lines, the
    gaps between lines in ms)."""
    import socket
    import threading

    from fastlivo_tpu_torch import serve

    srv.start_background()
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.connect(srv.address)
    c.settimeout(600)
    lines, stamps = [], []

    def read():
        buf = b""
        while True:
            chunk = c.recv(1 << 16)
            if not chunk:
                return
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                d = json.loads(line)
                if d.get("flushed"):
                    return
                lines.append(d)
                stamps.append(time.perf_counter())

    reader = threading.Thread(target=read)
    reader.start()
    for m in msgs:
        c.sendall(m)
    c.sendall(serve.encode_flush())
    reader.join(600)
    c.close()
    if not srv.wait(600) or reader.is_alive():
        raise AssertionError("the server did not finish")
    return lines, 1e3 * np.diff(stamps)


def serve_phase(dev, ds, ref, split=4.0):
    """serve.Server on a Unix socket in a temporary directory, with
    --autosave: it streams the LIO dataset up to `split`; its odometry
    lines are the per-frame path's frames at the same positions. A second
    Server warm-starts from the autosave and streams the rest: its first
    5 frames within 5 cm of the ground truth, RMS within 3 cm (the bounds
    of tests/test_checkpoint.py). Prints the gaps between odometry lines
    (median, p90) and the autosave's size."""
    import os
    import tempfile

    from fastlivo_tpu_torch import serve
    from fastlivo_tpu_torch.config import Config
    from fastlivo_tpu_torch.io import checkpoint as ckpt

    cfg = Config()
    cfg.img_enable = False
    res = {}
    with tempfile.TemporaryDirectory() as d:
        save = os.path.join(d, "auto.npz")
        srv = serve.Server(cfg, os.path.join(d, "a.sock"), autosave=save,
                           autosave_every=20, device=dev)
        (lines, gaps), launches, wall = counted_run(
            lambda: serve_session(srv, lio_messages(ds, t_max=split)))
        n = len(lines)
        dmax = max(float(np.linalg.norm(np.subtract(ln["pos"], o.pos)))
                   for ln, o in zip(lines, ref))
        same_t = all(ln["t"] == o.t for ln, o in zip(lines, ref))
        mb = os.path.getsize(save) / 1e6
        print(f"serve: {n} odometry lines in {wall / 1e3:.2f} s, gap between lines median "
              f"{np.median(gaps):.2f} ms p90 {np.percentile(gaps, 90):.2f} ms, max position "
              f"difference to per-frame {dmax:.3g} m, launches {launches}, autosave "
              f"{mb:.2f} MB; {nvidia_smi_line()}")
        need_launches("serve", launches, ["imu_propagate"])
        need_cascade("serve", launches)
        if n < 15 or not same_t or not dmax < 1e-6:
            raise AssertionError(f"serve: {n} lines, stamps equal {same_t}, {dmax:.3g} m")
        res["serve"] = (float(np.median(gaps)), float(np.percentile(gaps, 90)), launches)

        srv2 = serve.Server(cfg, os.path.join(d, "b.sock"), device=dev)
        srv2.pipe.warm_start(*ckpt.load(save, device=dev))
        (lines2, gaps2), launches2, _ = counted_run(
            lambda: serve_session(srv2, lio_messages(ds, t_min=split)))
    base = ds.traj.base_pos
    errs = [np.linalg.norm(np.subtract(ln["pos"], ds.traj.pose(ln["t"])[1] - base))
            for ln in lines2]
    rms = float(np.sqrt(np.mean(np.square(errs))))
    print(f"serve warm restart: {len(lines2)} lines, first 5 errors "
          f"{[round(float(e) * 1e3, 3) for e in errs[:5]]} mm, RMS {rms * 1e3:.3f} mm, gap median "
          f"{np.median(gaps2):.2f} ms, launches {launches2}; {nvidia_smi_line()}")
    need_launches("serve warm restart", launches2, ["imu_propagate"])
    need_cascade("serve warm restart", launches2)
    if len(lines2) < 10 or not (max(errs[:5]) < 0.05 and rms < 0.03):
        raise AssertionError(f"warm restart: {len(lines2)} lines, errors {errs[:5]}, RMS {rms}")
    res["serve warm restart"] = (float(np.median(gaps2)), float(np.percentile(gaps2, 90)),
                                 launches2)
    return res


def write_avia_bag(path, ds, t0=100.0):
    """A rosbag v2.0 of the dataset: sensor_msgs/Imu on /livox/imu and
    livox_ros_driver/CustomMsg scans on /livox/lidar (the layout of
    tests/test_rosbag_preprocess.py's fixture writer), stamps from t0."""
    import struct

    def field(k, v):
        return struct.pack("<I", len(k) + 1 + len(v)) + k + b"=" + v

    def record(fields, data):
        hdr = b"".join(field(k, v) for k, v in fields.items())
        return struct.pack("<I", len(hdr)) + hdr + struct.pack("<I", len(data)) + data

    def header(stamp):
        s = int(stamp)
        return struct.pack("<IIII", 0, s, int((stamp - s) * 1e9), 5) + b"frame"

    livox = np.dtype([("offset_time", "<u4"), ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                      ("reflectivity", "u1"), ("tag", "u1"), ("line", "u1")])
    msgs = []
    for t, acc, gyr in ds.imu_stream():
        raw = (header(t0 + t) + np.zeros(13).tobytes() + np.asarray(gyr, np.float64).tobytes()
               + np.zeros(9).tobytes() + np.asarray(acc, np.float64).tobytes()
               + np.zeros(9).tobytes())
        msgs.append((t0 + t, 0, raw))
    for beg, pts, t_rel in ds.lidar_scans_fast():
        arr = np.zeros(len(pts), livox)
        arr["x"], arr["y"], arr["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
        arr["offset_time"] = (t_rel * 1e9).astype(np.uint32)
        arr["tag"] = 0x10
        arr["line"] = np.arange(len(pts)) % 6
        raw = (header(t0 + beg) + struct.pack("<QIB3BI", int((t0 + beg) * 1e9), len(pts),
                                                  0, 0, 0, 0, len(pts)) + arr.tobytes())
        msgs.append((t0 + beg, 1, raw))
    msgs.sort(key=lambda m: m[0])
    conns = {0: (b"/livox/imu", b"sensor_msgs/Imu"),
             1: (b"/livox/lidar", b"livox_ros_driver/CustomMsg")}
    inner = b"".join(record({b"op": b"\x07", b"conn": struct.pack("<I", c), b"topic": tp},
                            field(b"type", ty) + field(b"md5sum", b"x")
                            + field(b"message_definition", b""))
                     for c, (tp, ty) in conns.items())
    for stamp, c, raw in msgs:
        s = int(stamp)
        inner += record({b"op": b"\x02", b"conn": struct.pack("<I", c),
                         b"time": struct.pack("<II", s, int((stamp - s) * 1e9))}, raw)
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        f.write(record({b"op": b"\x03", b"index_pos": struct.pack("<Q", 0),
                        b"conn_count": struct.pack("<I", 2),
                        b"chunk_count": struct.pack("<I", 1)}, b""))
        f.write(record({b"op": b"\x05", b"compression": b"none",
                        b"size": struct.pack("<I", len(inner))}, inner))
    return len(msgs)


def bag_phase(dev, ds, t0=100.0):
    """The LIO dataset as a bag of Avia scans, replayed through
    `run.main(["--bag", ..., "--block", "8"])` with `Config()`'s shipped
    capacities and preprocessing (every second point kept): the
    trajectory tracks the ground truth (ATE < 2 cm) through the fused
    search."""
    import os
    import tempfile

    from fastlivo_tpu_torch import run

    with tempfile.TemporaryDirectory() as d:
        bag, out = os.path.join(d, "avia.bag"), os.path.join(d, "traj.txt")
        n_msgs = write_avia_bag(bag, ds, t0)
        mb = os.path.getsize(bag) / 1e6
        rc, launches, wall = counted_run(lambda: run.main(
            ["--bag", bag, "--block", "8", "--out", out, "--device", str(dev)]))
        traj = np.loadtxt(out, ndmin=2)
    if rc != 0:
        raise AssertionError(f"run.main returned {rc}")

    class _Out:
        def __init__(self, r):
            self.t, self.pos = r[0], r[1:4]

    ate = ate_of([_Out(r) for r in traj], ds, t_offset=t0)
    ms = wall / len(traj)
    print(f"bag: {n_msgs} messages, {mb:.1f} MB, through run.main --bag --block 8: "
          f"{len(traj)} frames, {ms:.2f} ms/lidar frame (reading and decoding included), "
          f"ATE {ate * 1e3:.3f} mm, launches {launches}; {nvidia_smi_line()}")
    need_launches("bag", launches, ["imu_propagate"])
    need_cascade("bag", launches)
    if len(traj) < 30 or not np.isfinite(traj).all() or not ate < 0.02:
        raise AssertionError(f"bag: {len(traj)} frames, ATE {ate:.4f} m")
    return {"bag --block 8": (ms, launches)}


def same_outputs(outs, ref) -> bool:
    """Every frame of `outs` equal to `ref`'s, bit for bit (timing aside)."""
    return len(outs) == len(ref) and all(
        a.t == b.t and a.iters == b.iters and a.n_active == b.n_active
        and a.n_points == b.n_points and a.res_rms == b.res_rms
        and all(np.array_equal(getattr(a, f), getattr(b, f)) for f in ("pos", "quat", "vel"))
        for a, b in zip(outs, ref))


def lio_config(**capacity):
    """`Config()` without the camera, at its shipped capacities but for
    the given capacity fields."""
    from fastlivo_tpu_torch.config import Config

    cfg = Config()
    cfg.img_enable = False
    for k, v in capacity.items():
        setattr(cfg.capacity, k, v)
    return cfg


def backend_paths_phase(dev, ds, ref, ref_ms, frames=24):
    """The first `frames` frames of the LIO dataset of path_phase (the
    data up to the end of the next scan) through the other map backends
    and LIO options at shipped capacities: (a) the hash map (2^20 slots,
    probe 12), (b) the dense grid (256 x 256 x 64), (c) tiled with
    `cache_knn`, (d) tiled with `plane_fit: ref`, (e) tiled with
    `profile_every` 8, (f) BlockReplayer(8) on the hash map. The hash,
    dense, cache_knn, ref and hash-block paths must run every EKF as one
    lio_cascade launch (counted under its map, search and fit: the hash
    and dense walks of knn5_hashed_walk.cuh, under cache_knn the walk's
    gather form at the first search and knn5_cached_walk.cuh's re-rank of
    the block at the later ones, the reference's fit of plane_fit.cuh)
    and launch no search kernel (no knn5_plane_hashed, knn5_plane or tiled
    kernel) and make no knn_candidates call (cache_knn's block is written
    by the launch); each of their cascades is recorded
    (the copies' memory reserved before the run) and held against the host
    loop with the step kernel
    (check_lio_cascades: bit-equal, iterations equal); profile_every must
    leave the per-frame outputs unchanged in every bit; every ATE < 2 cm.
    The hash, dense and hash-block paths write their maps through the flat
    maps' kernels only: one hash_insert_keys and one hash_insert_probe
    launch per hash insert, one dense_insert per dense insert, one
    flat_delete_boxes per box set (the calls of the map module's `insert`
    and `delete_boxes` counted), and no call of a plain version; the
    tiled paths launch none of them.
    Checkpoints the hash and dense estimators. Returns ({path: (ms per
    frame, launches)}, {path: its other numbers}, {"hash": the hash path's
    pipeline, "dense": the dense path's}, {map: checkpoint numbers},
    {"hash", "dense", "cache_knn", "ref": that path's last lio_cascade
    call's arguments}, {"hash", "dense": {"map": a copy of the path's final
    map, "insert": its last insert's (pts, valid[, max_probe]), "boxes":
    its last box set (lo, hi), "inserts", "box_sets": their counts}})."""
    from fastlivo_tpu_torch.ops import dense_map as dm
    from fastlivo_tpu_torch.ops import lio_cascade as lc
    from fastlivo_tpu_torch.ops import tiled_map as tm
    from fastlivo_tpu_torch.ops import voxel_map as vm
    from fastlivo_tpu_torch.pipeline import Pipeline
    from fastlivo_tpu_torch.replay import BlockReplayer

    runs = [("hash", lio_config(map_backend="hash"), None, 0),
            ("dense", lio_config(map_backend="dense"), None, 0),
            ("tiled cache_knn", lio_config(cache_knn=True), None, 0),
            ("tiled plane_fit ref", lio_config(plane_fit="ref"), None, 0),
            ("tiled profile_every 8", lio_config(), None, 8),
            ("hash BlockReplayer(8)", lio_config(map_backend="hash"), BlockReplayer, 0)]
    paths, extra, ckpts, pipes, last, flat_in = {}, {}, {}, {}, {}, {}
    t_max = ref[frames].t
    # tiled per-frame's steady frames over the same span, beside each path's
    ref_steady = float(np.median([1e3 * o.timing["total"] for o in ref[:frames + 1]
                                  if o.iters > 0]))
    for name, cfg, rep, every in runs:
        cap = cfg.capacity
        pipe = Pipeline(cfg, device=dev)
        pipe.profile_every = every
        push_all(pipe, ds, t_max=t_max)
        gathers, calls = [], []
        mod = {"tiled": tm, "dense": dm, "hash": vm}[cap.map_backend]
        hashed = cap.map_backend != "tiled"
        option = "cache_knn" if cap.cache_knn else "ref" if cap.plane_fit == "ref" else None
        record = hashed or option is not None
        if record:
            reserve_snapshots(pipe.map, frames + 1)
        writes, plain_calls = {"insert": {}, "delete_boxes": {}}, []
        with contextlib.ExitStack() as stack:
            stack.enter_context(spy(mod, "knn_candidates", gathers))
            if record:
                stack.enter_context(recorded_lio(calls))
            for w, rec in writes.items():  # the map's writes: counted, the last recorded
                stack.enter_context(recorded_calls(mod, rec, name=w))
            for pm, pname in flat_plain():  # never reached on the card
                stack.enter_context(spy(pm, pname, plain_calls))
            outs, launches, wall = counted_run(
                (lambda: rep(pipe, 8).run()) if rep else pipe.spin)
        n_ins, n_del = writes["insert"].get("n", 0), writes["delete_boxes"].get("n", 0)
        flat = {k: launches[k] for k in FLAT_KERNELS}
        want_flat = {k: 0 for k in FLAT_KERNELS}
        if hashed:
            want_flat["flat_delete_boxes"] = n_del
            for k in (("hash_insert_keys", "hash_insert_probe") if cap.map_backend == "hash"
                      else ("dense_insert",)):
                want_flat[k] = n_ins
        print(f"{name}: map writes {n_ins} inserts, {n_del} box sets; launches {flat} "
              f"(want {want_flat}); plain versions called {len(plain_calls)} times")
        if flat != want_flat or plain_calls or (hashed and not (n_ins and n_del)):
            raise AssertionError(f"{name}: map write launches {flat}, want {want_flat} for "
                                 f"{n_ins} inserts and {n_del} box sets; {len(plain_calls)} "
                                 f"plain calls")
        by_map = dict(lc.lio_cascade.by_map)
        by_route = {"map": by_map, "search": dict(lc.lio_cascade.by_search),
                    "fit": dict(lc.lio_cascade.by_fit)}
        if len(outs) < frames:
            raise AssertionError(f"{name}: {len(outs)} frames of {frames}")
        pref = ref[:len(outs)]
        steady = [1e3 * o.timing["total"] for o in outs if o.iters > 0]
        d, ate = max_diff(outs, pref), ate_of(outs, ds)
        ms = wall / len(outs)
        k, kt = launches["knn5_plane"], launches["knn5_plane_tiled"]
        kh, ng, kc = launches["knn5_plane_hashed"], len(gathers), launches["lio_cascade"]
        print(f"{name}: {len(outs)} frames ({len(steady)} steady), {ms:.2f} ms/lidar frame "
              f"(tiled per-frame {ref_ms:.2f}), median steady frame {np.median(steady):.2f} ms "
              f"(tiled per-frame's {ref_steady:.2f} ms), "
              f"ATE {ate * 1e3:.3f} mm, max position difference to tiled per-frame "
              f"{d * 1e3:.4f} mm, knn5_plane_hashed {kh}, knn5_plane {k}, knn5_plane_tiled "
              f"{kt}, lio_cascade {kc} (by {by_route}), {ng} candidate gathers "
              f"({cap.map_backend} map, cache_knn {cap.cache_knn}, plane_fit "
              f"{cap.plane_fit}); {nvidia_smi_line()}")
        if option is not None:  # one cascade an EKF, its search and fit counted
            search = "gather" if cap.cache_knn else "walk"
            ok = (kc == len(steady) == len(calls) == by_route["search"][search]
                  == by_route["fit"][cap.plane_fit] and k == kt == kh == 0 and ng == 0)
        elif every:  # one cascade per EKF, the profiled ones included
            ok = kc >= len(steady) and kt == 0 and k == 0 and kh == 0 and same_outputs(
                outs, pref)
            print(f"{name}: last_stage_profile {pipe.last_stage_profile} ms, outputs "
                  f"bit-identical to per-frame: {same_outputs(outs, pref)}")
            ok = ok and set(pipe.last_stage_profile or ()) == {
                "undistort", "downsample", "ekf", "map"}
        else:  # hash, dense, hash BlockReplayer(8): one cascade an EKF, on its map
            ok = (kc >= len(steady) and by_map[cap.map_backend] == kc == len(calls)
                  and kh == 0 and k == 0 and kt == 0 and ng == 0 and d < 5e-8)
        if not ok or not launches["imu_propagate"] or not ate < 0.02:
            raise AssertionError(f"{name}: launches {launches} (lio_cascade by {by_route}), "
                                 f"{ng} candidate gathers, {len(calls)} recorded cascades, "
                                 f"{d * 1e3:.4f} mm from tiled per-frame, ATE {ate:.4f} m")
        paths[name] = (ms, launches)
        extra[name] = {"median_steady_ms": float(np.median(steady)),
                       "tiled_median_steady_ms": ref_steady, "ate_mm": ate * 1e3,
                       "max_diff_to_tiled_mm": d * 1e3, "candidate_gathers": len(gathers)}
        if record:
            extra[name]["lio_cascades"] = check_lio_cascades(calls, name)
            extra[name]["lio_cascade_by_route"] = by_route
            if name in ("hash", "dense") or option:
                last[option or name] = calls[-1][0]
            del calls
        if every:
            extra[name]["last_stage_profile_ms"] = pipe.last_stage_profile
        if name in ("hash", "dense"):
            (_, ipts, ivalid, *probe), _ = writes["insert"]["last"]
            (_, lo, hi), _ = writes["delete_boxes"]["last"]
            flat_in[name] = {"map": clone_map(pipe.map), "insert": (ipts, ivalid, *probe),
                             "boxes": (lo, hi), "inserts": n_ins, "box_sets": n_del}
            ckpts[name] = checkpoint_roundtrip(pipe, dev, f"lio {name}")
            pipes[name] = pipe
        del pipe
    return paths, extra, pipes, ckpts, last, flat_in


def colliding_voxels(T: int):
    """Two voxel coordinates whose first probe slot in a table of T slots
    is the same."""
    from fastlivo_tpu_torch.ops import voxel_map as vm

    k = np.stack(np.meshgrid(*[np.arange(-6, 6)] * 3, indexing="ij"), -1).reshape(-1, 3)
    slot = vm._slot_check(torch.from_numpy(k.astype(np.int32)), T - 1)[0].numpy()
    order = np.argsort(slot, kind="stable")
    i = np.nonzero(slot[order][1:] == slot[order][:-1])[0][0]
    return k[order[[i, i + 1]]]


def map_ops_phase(dev, flat_in, T=1 << 16, dims=(64, 64, 16), n=40000, T_full=1 << 20):
    """The hash map (T slots) and the dense grid (`dims`, aliasing: it
    spans 32 x 32 x 8 m, the points 40 m) built from seeded random points
    on the card and on the CPU: three inserts (the first with two voxels
    that claim one slot in the same round), knn_candidates at radius 1
    and 2, delete_boxes and the hash map's rebuild; every array on the
    card must equal the CPU's, each write through its kernels (launches
    counted). Then flat_map_kernels on the hash and dense paths' own maps
    and last batches (`flat_in`, from backend_paths_phase), and rebuild at
    a T_full table 75% full, beside rebuild_plain on the card. These
    launches are not the paths'. Returns ({kernel: numbers}, rebuild
    numbers)."""
    from fastlivo_tpu_torch.ops import dense_map as dm
    from fastlivo_tpu_torch.ops import voxel_map as vm

    rng = np.random.default_rng(0)
    pts = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    pts[:2] = (colliding_voxels(T) + 0.5) * 0.5
    pts[2:n // 10] = pts[n // 10: 2 * (n // 10) - 2] + 0.05
    valid = rng.random(n) > 0.05
    valid[:2] = True
    q = rng.uniform(-22, 22, (16384, 3)).astype(np.float32)
    q[:2] = pts[:2]
    lo, hi = np.float32([[-20, 0, -20]]), np.float32([[20, 20, 20]])
    res = {}
    counts = read_counts()
    reset_counts()
    for d in (dev, "cpu"):
        t = lambda a: torch.from_numpy(a).to(d)  # noqa: E731
        # host copies: the maps are updated in place, and .cpu() of a CPU
        # tensor is the tensor itself
        snap = lambda ts: [x.to("cpu", copy=True) for x in ts]  # noqa: E731
        got = []
        for mod, m in ((vm, vm.empty_map(T, 0.5, device=d)),
                       (dm, dm.empty_dense_map(dims, 0.5, device=d))):
            for sl in (slice(0, n // 3), slice(n // 3, 2 * n // 3), slice(2 * n // 3, n)):
                m = mod.insert(m, t(pts[sl]), t(valid[sl]))
                got.append(snap(m))
            for radius in (1, 2):
                got.append(snap(mod.knn_candidates(m, t(q), radius, 12)))
            if mod is vm and not bool(got[-1][1][:2, 0].all()):
                raise AssertionError("a voxel of the duplicate claim was not stored")
            m = mod.delete_boxes(m, t(lo), t(hi))
            got.append(snap(m))
            if mod is vm:
                got.append(snap(vm.rebuild(m)))
        res[str(d)] = got
        if d is dev:  # the card's launches
            launched = {k: v for k, v in read_counts().items() if k in FLAT_KERNELS}
    card, cpu = res[str(dev)], res["cpu"]
    differ = [i for i, (x, y) in enumerate(zip(card, cpu))
              if not all(torch.equal(a, b) for a, b in zip(x, y))]
    same = not differ
    print(f"map ops, hash 2^{T.bit_length() - 1} slots ({int(cpu[2][2])} occupied) and dense "
          f"{dims} ({int(cpu[9][2])} occupied) from {n} seeded points: insert x3 (with a "
          f"duplicate claim), knn_candidates r=1,2, delete_boxes, rebuild: card equals CPU "
          f"in every array: {same}; launches {launched}")
    want = {"hash_insert_keys": 4, "hash_insert_probe": 4, "dense_insert": 3,
            "flat_delete_boxes": 2}
    if not same or launched != want:
        raise AssertionError(f"map ops on the card differ from the CPU at steps {differ}, "
                             f"launches {launched} (want {want})")
    kernels = flat_map_kernels(flat_in)

    # rebuild at the shipped table, 75% full of distinct voxels (a block
    # of 128 x 128 x k voxels)
    n_full = 3 * T_full // 4
    g = np.stack(np.unravel_index(np.arange(n_full), (128, 128, -(-n_full // 16384))), -1)
    full = torch.from_numpy(((g - 64 + 0.5) * 0.5).astype(np.float32)).to(dev)
    m = vm.insert(vm.empty_map(T_full, 0.5, device=dev), full,
                  torch.ones(n_full, dtype=torch.bool, device=dev), 32)
    occ = int(m.count) / T_full
    rb_ms = event_ms(lambda: vm.rebuild(m))
    rb_plain_ms = event_ms(lambda: vm.rebuild_plain(m), reps=3)
    kept, kept_plain = vm.rebuild(m), vm.rebuild_plain(m)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(kept, kept_plain)):
        raise AssertionError("rebuild on the card differs from rebuild_plain")
    print(f"rebuild: 2^{T_full.bit_length() - 1} slots at {100 * occ:.2f}% occupancy "
          f"({n_full} voxels inserted at probe depth 32, {int(kept.count)} kept by the "
          f"rebuild, every array equal to rebuild_plain's), {rb_ms:.3f} ms per call alone "
          f"(CUDA events; rebuild_plain {rb_plain_ms:.3f} ms, {vm.hash_insert_probe.grid} "
          f"blocks); {nvidia_smi_line()}")
    for fn in counted_wrappers():
        fn.launches = counts[fn.__name__]
    return kernels, {"ms": rb_ms, "plain_ms": rb_plain_ms, "occupancy": occ}


PROBE_ROW_OPS = 10  # a head: its words, the round state
PROBE_OPS = 20  # a probe: the slot, the check compare, the ticket; a mine's distance
FLAT_KEY_OPS = 60  # a row: 3 divisions, floors, casts, the centre and distance, the mix
FLAT_CENTRE_OPS = 15  # an occupied slot: 3 divisions, floors, casts, adds, multiplies
FLAT_TEST_OPS = 6  # an occupied slot against a box: two compares an axis


def bound(byts, ops):
    """(least ms, "bytes" | "operations") for the bytes over HBM bandwidth
    and the operations over the f32 rate (integer operations run no
    faster)."""
    t_b, t_o = byts / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def hash_probe_work(m, pts, valid, rows, order, max_probe):
    """What one probe launch on these inputs needs, from insert_probe_plain's
    rounds replayed on a copy of the checks: {"rows", "heads", "rounds"
    (rounds with a live head), "probes" (slot reads), "mine" (stored points
    read), "claims" (slots claimed), "written" (slots whose point
    changed)}."""
    from fastlivo_tpu_torch.ops import voxel_map as vm

    T = m.check.shape[0]
    done = ~vm._sorted_heads(rows, order, valid)[1]
    heads = int((~done).sum())
    slot = rows[3][order].to(torch.int64)
    chk = rows[4][order]
    tc = torch.cat([m.check, m.check.new_full((1,), vm.EMPTY_CHECK)])
    probes = mine = rounds = 0
    for _ in range(max_probe):
        live = ~done
        n_live = int(live.sum())
        if not n_live:
            break
        rounds += 1
        probes += n_live
        cur = tc[slot]
        is_mine = (cur == chk) & live
        claim = (cur == vm.EMPTY_CHECK) & live
        mine += int(is_mine.sum())
        tc[torch.where(vm._last_wins(slot, claim, T), slot, T)] = chk
        done = done | is_mine | (claim & (tc[slot] == chk))
        slot = (slot + 1) & (T - 1)
    after = clone_map(m)
    vm.insert_probe_plain(after, pts, valid, rows, order, max_probe)
    claims = int(((m.check == vm.EMPTY_CHECK) & (after.check != vm.EMPTY_CHECK)).sum())
    written = int((after.pts != m.pts).any(dim=1).sum())
    return {"rows": int(order.shape[0]), "heads": heads, "rounds": rounds, "probes": probes,
            "mine": mine, "claims": claims, "written": written}


def flat_bounds(m, pts, valid, boxes=None, work=None):
    """{kernel: (bound ms, "bytes" | "operations", bytes, ops)}.
    hash_insert_keys: each row's point and mask read (13 B), each head's
    seven words written (28 B) and the count; ~60 operations a row.
    hash_insert_probe (`work` from hash_probe_work): a head's seven words
    and its point (40 B); a probe's check (4 B), a stored point read (12
    B), a claimed check (4 B) and a written point (12 B); ~10 operations a
    head and 20 a probe. dense_insert (`work`: {"rows", "winners", "written"}): each
    row's point and mask (13 B), a winner's cell check and point (16 B), a
    written cell (16 B); ~60 operations a valid row. flat_delete_boxes
    (`boxes` (lo, hi), `work`: {"occupied", "killed"}): every slot's check
    (4 B), an occupied slot's point (12 B), a killed check (4 B), the
    boxes; 15 operations an occupied slot and 6 a box."""
    B = pts.shape[0]
    out = {}
    if boxes is not None:
        nb = boxes[0].shape[0]
        T = m.check.shape[0]
        byts = 4 * T + 12 * work["occupied"] + 4 * work["killed"] + 24 * nb + 12
        ops = (FLAT_CENTRE_OPS + FLAT_TEST_OPS * nb) * work["occupied"]
        return {"flat_delete_boxes": (*bound(byts, ops), byts, ops)}
    if "probes" in work:
        kb = 13 * B + 28 * work["heads"] + 4
        out["hash_insert_keys"] = (*bound(kb, FLAT_KEY_OPS * B), kb, FLAT_KEY_OPS * B)
        byts = (40 * work["heads"] + 4 * work["probes"] + 12 * work["mine"]
                + 4 * work["claims"] + 12 * work["written"] + 12)
        ops = PROBE_ROW_OPS * work["heads"] + PROBE_OPS * work["probes"]
        out["hash_insert_probe"] = (*bound(byts, ops), byts, ops)
    else:
        nv = int(valid.sum())
        byts = 13 * B + 16 * work["winners"] + 16 * work["written"] + 8
        out["dense_insert"] = (*bound(byts, FLAT_KEY_OPS * nv), byts, FLAT_KEY_OPS * nv)
    return out


def flat_map_kernels(flat_in):
    """The flat maps' write kernels on the hash and dense paths' own maps
    and last batches and box sets: each launch bit-equal to its plain
    version on the card and on the CPU (the whole insert and the box
    delete compared on copies of the map, every array), then timed (CUDA
    events, the calls queued ahead of the device: time_ms) beside its plain
    version on the card (event_ms) and its bound, the batch re-inserted
    into its map at every call (its voxels stored, few rows nearer) and
    the box set deleted again (the first call's slots killed, the rest
    read). No library call computes them. Returns {kernel: numbers}."""
    from fastlivo_tpu_torch.ops import dense_map as dm
    from fastlivo_tpu_torch.ops import voxel_map as vm

    smi = nvidia_smi_line()
    res = {}
    for name, mod in (("hash", vm), ("dense", dm)):
        m = flat_in[name]["map"]
        pts, valid, *probe = flat_in[name]["insert"]
        probe = probe[0] if probe else 12
        lo, hi = flat_in[name]["boxes"]
        # the whole insert and the box delete: kernel, plain on the card, CPU
        plain_ins = vm.insert_plain if mod is vm else dm.insert_plain
        for what, kern, plain in (
                ("insert", lambda x: mod.insert(x, pts, valid, probe),
                 lambda x: plain_ins(x, *(to_cpu(t) if x.check.device.type == "cpu" else t
                                          for t in (pts, valid)), probe)),
                ("delete_boxes", lambda x: mod.delete_boxes(x, lo, hi),
                 lambda x: vm.delete_boxes_plain(x, *(to_cpu(t) if x.check.device.type == "cpu"
                                                      else t for t in (lo, hi))))):
            got, want, cpu = kern(clone_map(m)), plain(clone_map(m)), plain(to_cpu(m))
            torch.cuda.synchronize()
            if not (all(bits_diff(a, b) == 0.0 for a, b in zip(got, want))
                    and all(bits_diff(a.cpu(), b) == 0.0 for a, b in zip(got, cpu))):
                raise AssertionError(f"the {name} map's {what} on the card differs from its "
                                     f"plain version on the card or on the CPU")
        occupied = int((m.check != vm.EMPTY_CHECK).sum())
        killed = occupied - int((vm.delete_boxes_plain(clone_map(m), lo, hi).check
                                 != vm.EMPTY_CHECK).sum())
        mt, mq = clone_map(m), clone_map(m)
        d_ms = time_ms(lambda: vm.flat_delete_boxes(mt, lo, hi))
        d_plain = event_ms(lambda: vm.delete_boxes_plain(mq, lo, hi), reps=30)
        b, by, byts, ops = flat_bounds(m, pts, valid, (lo, hi),
                                       {"occupied": occupied, "killed": killed})[
            "flat_delete_boxes"]
        res[f"flat_delete_boxes {name}"] = {
            "ms": d_ms, "plain_ms": d_plain, "bound_ms": b, "bound_by": by, "bytes": byts,
            "ops": ops, "grid": vm.flat_delete_boxes.grid, "slots": int(m.check.shape[0]),
            "occupied": occupied, "boxes": int(lo.shape[0]), "killed": killed,
            "box_sets_on_path": flat_in[name]["box_sets"]}
        print(f"flat_delete_boxes on the {name} path's map ({m.check.shape[0]} slots, "
              f"{occupied} occupied) with its last {lo.shape[0]} boxes ({killed} killed by "
              f"the first call): kernel {d_ms:.4f} ms ({vm.flat_delete_boxes.grid} blocks), "
              f"plain {d_plain:.4f} ms, bound {b:.5f} ms ({by}: {byts} bytes, {ops} "
              f"operations), library none; {smi}")
        mt, mq = clone_map(m), clone_map(m)
        if mod is vm:
            heads_w, nh_w = vm.insert_heads_plain(m, pts, valid)
            heads, nh = vm.hash_insert_keys(m, pts, valid)
            k = int(nh_w)
            mk, mp = clone_map(m), clone_map(m)
            ck = vm.hash_insert_probe(mk, pts, heads_w, nh_w, probe)
            cp = vm.insert_plain(mp, pts, valid, probe).count
            torch.cuda.synchronize()
            if not (int(nh) == k and torch.equal(heads[:, :k], heads_w[:, :k])
                    and torch.equal(ck, cp) and all(torch.equal(a, b) for a, b in zip(mk, mp))):
                raise AssertionError("a hash insert launch differs from its plain pass")
            rows, skeys = vm.insert_keys_plain(m, pts, valid)
            work = hash_probe_work(m, pts, valid, rows, vm.sort_order(skeys), probe)
            bounds = flat_bounds(m, pts, valid, work=work)
            timed = {"hash_insert_keys": (lambda: vm.hash_insert_keys(mt, pts, valid),
                                          lambda: vm.insert_heads_plain(mq, pts, valid)),
                     "hash_insert_probe": (
                         lambda: vm.hash_insert_probe(mt, pts, heads, nh, probe),
                         lambda: vm.insert_heads_probe_plain(mq, pts, heads, nh, probe))}
        else:
            before = clone_map(m)
            after = dm.insert_plain(clone_map(m), pts, valid)
            cells = (after.check != before.check) | (after.pts != before.pts).any(dim=1)
            keys = vm.voxel_of(pts, m.voxel_size)
            cell = dm._cell_check(m, keys)[0]
            winners = int(torch.unique(cell[valid]).numel())
            work = {"rows": int(pts.shape[0]), "winners": winners,
                    "written": int(cells.sum())}
            bounds = flat_bounds(m, pts, valid, work=work)
            timed = {"dense_insert": (lambda: dm.dense_insert(mt, pts, valid),
                                      lambda: dm.insert_plain(mq, pts, valid))}
        for kname, (kern, plain) in timed.items():
            ms = time_ms(kern)
            grid = getattr(getattr(vm if kname.startswith("hash") else dm, kname), "grid", None)
            plain_ms = event_ms(plain, reps=30)
            b, by, byts, ops = bounds[kname]
            res[kname] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                          "bytes": byts, "ops": ops, "grid": grid,
                          "inserts_on_path": flat_in[name]["inserts"], **work,
                          **({"max_probe": probe} if mod is vm else {})}
            blocks = f" ({grid} blocks)" if grid else ""
            print(f"{kname} on the {name} path's last batch, re-inserted into its map "
                  f"({work}): kernel {ms:.4f} ms{blocks}, plain {plain_ms:.4f} ms, "
                  f"bound {b:.5f} ms ({by}: {byts} bytes, {ops} operations), library none; "
                  f"{smi}")
        whole = time_ms(lambda: mod.insert(mt, pts, valid, probe))
        whole_plain = event_ms(lambda: plain_ins(mq, pts, valid, probe), reps=30)
        t0 = time.perf_counter()
        for _ in range(20):
            mod.insert(mt, pts, valid, probe)
        host_ms = 1e3 * (time.perf_counter() - t0) / 20
        torch.cuda.synchronize()
        first = "hash_insert_keys" if mod is vm else "dense_insert"
        res[first].update(insert_ms=whole, insert_plain_ms=whole_plain, insert_host_ms=host_ms)
        print(f"the whole {name} insert: {whole:.4f} ms on the card, {mod.__name__}."
              f"insert_plain {whole_plain:.4f} ms; host {host_ms:.4f} ms a call; {smi}")
        del mt, mq
    return res


MIX_OPS = 29  # hash_mix.cuh's mix3: three murmur finalizers (8 each) and the chain (5)


def hashed_bound_ms(m, q, radius: int = 1, max_probe: int = 12):
    """Least time for knn5_plane_hashed on these inputs: the queries (12 B)
    and the map entries of hashed_work read once, 21 B written per query,
    over HBM bandwidth; against hashed_work's operations over the float32
    rate (integer operations run no faster). Returns (ms, "bytes" |
    "operations", (distinct probed words, distinct found points, probes
    taken, found rows))."""
    map_bytes, ops, uniq = hashed_work(m, q, radius, max_probe)
    nbytes = q.shape[0] * (12 + 21) + map_bytes
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), uniq


def hashed_work(m, q, radius: int = 1, max_probe: int = 12):
    """The hash or dense walk's work (knn5_hashed_walk.cuh) for the queries
    q: the bytes of each distinct check word the rows probe (4 B), each
    distinct found point (12 B) and the offsets; the operations these
    inputs need, counted from the walk's source: per query its voxel (6)
    and the fit and gate of plane_fit.cuh (260); per candidate row the
    murmur mix of its voxel (MIX_OPS; the key varies per row), its offset
    sums and slot or cell index (hash 6, dense 12) and one compare in each
    of the 5 selection rounds; per probe actually taken its compare and
    advance (3; a hash row stops at its first match, a missing voxel takes
    all `max_probe`; a dense row takes one); per found row its squared
    distance (8). Returns (bytes, operations, (distinct probed words,
    distinct found points, probes taken, found rows))."""
    from fastlivo_tpu_torch.ops import dense_map as dm
    from fastlivo_tpu_torch.ops import voxel_map as vm

    cand = vm.voxel_of(q, m.voxel_size)[:, None, :] + vm.neighbor_offsets(radius, q.device)
    n, M = cand.shape[:2]
    if isinstance(m, dm.DenseMap):
        cell, chk = dm._cell_check(m, cand)
        cell = cell.long()
        found = m.check[cell] == chk
        words, res, probes, index_ops = torch.unique(cell).numel(), cell, n * M, 12
    else:
        mask = m.check.shape[0] - 1
        slot, chk = vm._slot_check(cand, mask)
        slot = slot.long()
        found = torch.zeros_like(slot, dtype=torch.bool)
        res = torch.zeros_like(slot)
        probed, probes = [], 0
        for _ in range(max_probe):
            active = ~found
            probed.append(slot[active])
            probes += int(active.sum())
            hit = (m.check[slot] == chk) & active
            res = torch.where(hit, slot, res)
            found |= hit
            slot = (slot + 1) & mask
        words, index_ops = torch.unique(torch.cat(probed)).numel(), 6
    n_found = int(found.sum())
    uniq = (words, torch.unique(res[found]).numel(), probes, n_found)
    nbytes = uniq[0] * 4 + uniq[1] * 12 + M * 12
    ops = (n * (6 + 260) + n * M * (MIX_OPS + index_ops + 5) + 3 * probes
           + 8 * n_found)
    return nbytes, ops, uniq


def search_kernels(pipe, fused: bool, calls: int = 3) -> float:
    """Device kernels under `lio.search` in one lidar frame's EKF run as
    the host loop (the cascade's oracle; on the card the EKF is one
    lio_cascade launch): the mean over `calls` lio_update calls on the
    pipeline's map, state and last scan (without `fused`, through the
    unfused composition), under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from fastlivo_tpu_torch import lio

    cap, cfg = pipe.cfg.capacity, pipe.cfg
    down, _active = pipe.last_effect
    pmask = torch.ones(down.shape[0], dtype=torch.bool, device=down.device)
    torch.cuda.synchronize()
    reset_counts()
    with contextlib.ExitStack() as stack:
        stack.enter_context(swapped(lio, "cascade_applies", lambda *a, **kw: False))
        if not fused:
            stack.enter_context(unfused())
        prof = stack.enter_context(
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        for _ in range(calls):
            lio.lio_update(pipe.state, pipe.map, down, pmask, pipe.calib.lid_rot,
                           pipe.calib.lid_off, laser_point_cov=float(cfg.laser_point_cov),
                           max_iter=cfg.max_iteration, knn_radius=cap.knn_voxel_radius,
                           plane_fit=cap.plane_fit, cache_knn=cap.cache_knn,
                           max_probe=cap.max_probe)
        torch.cuda.synchronize()
    counts = read_counts()
    check_composition(counts, fused, [("knn5_plane_hashed", "knn5_plane")],
                      f"{cap.map_backend} search profile")
    launched = counts["knn5_plane_hashed"] + counts["knn5_plane"]
    n_k, _linked = kernels_in(prof, "lio.search", launched)
    return n_k / calls


def hashed_phase(pipes, n=16384, m=27) -> dict:
    """The fused search on the hash and dense paths' own maps and last
    scans (the EKF batch, N = 16384, at the posterior): bit-exact against
    its plain composition at M = 27 and 125, timed at M = 27 beside its
    bound, its plain version and the unfused pair it replaced (the
    backend's knn_candidates + the knn5_plane kernel). Then the
    slab-staged knn5_plane on the hash path's candidate block (M = 27):
    bit-exact against its plain version, timed beside its bound, its plain
    version and the block's knn_candidates. Then the device kernels under
    `lio.search` in one lidar frame's EKF on the hash map, fused and
    unfused. These launches are not the paths'. Returns {"hash": ...,
    "dense": ..., "knn5_plane": ..., "search_kernels_per_frame": ...}."""
    from fastlivo_tpu_torch import lio
    from fastlivo_tpu_torch.ops import knn_plane

    smi, out = nvidia_smi_line(), {}
    for name in ("hash", "dense"):
        pipe = pipes[name]
        mp, probe = pipe.map, pipe.cfg.capacity.max_probe
        mod = lio.map_module(mp)
        q = real_queries(pipe, n)
        err = 0.0
        for radius in (1, 2):
            got = knn_plane.knn5_plane_hashed(mp, q, radius, 0.1, probe)
            torch.cuda.synchronize()
            want = knn_plane.knn5_plane_hashed_plain(mp, q, radius, 0.1, probe)
            e = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            print(f"knn5_plane_hashed {name} path map N={n} M={(2 * radius + 1) ** 3}: "
                  f"max_abs_err={e:.3g}, bit-exact {same}, {int(want[1].sum())} planes")
            if not same:
                raise AssertionError(f"knn5_plane_hashed {name} radius {radius} differs by {e}")
            err = max(err, e)
        ms = time_ms(lambda: knn_plane.knn5_plane_hashed(mp, q, 1, 0.1, probe))
        pair_ms = time_ms(lambda: knn_plane.knn5_plane(
            *mod.knn_candidates(mp, q, 1, probe), q, 0.1))
        plain_ms = time_ms(lambda: knn_plane.knn5_plane_hashed_plain(mp, q, 1, 0.1, probe))
        bound_ms, bound_by, uniq = hashed_bound_ms(mp, q, 1, probe)
        print(f"knn5_plane_hashed N={n} M={m} on the {name} path map: kernel {ms:.4f} ms, "
              f"unfused pair (knn_candidates + knn5_plane kernel) {pair_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}; distinct probed "
              f"words, found points, probes taken, found rows {uniq}), library none; {smi}")
        out[name] = {"ms": ms, "pair_ms": pair_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "max_abs_err": err, "probed_words": uniq[0],
                     "found_points": uniq[1], "probes": uniq[2], "found_rows": uniq[3]}

    pipe = pipes["hash"]
    mp, probe = pipe.map, pipe.cfg.capacity.max_probe
    q = real_queries(pipe, n)
    mod = lio.map_module(mp)
    cand, found = mod.knn_candidates(mp, q, 1, probe)
    got = knn_plane.knn5_plane(cand, found, q)
    torch.cuda.synchronize()
    want = knn_plane.knn5_plane_plain(cand, found, q)
    err = knn5_contract(got, want, min_both=1000)
    exact = all(torch.equal(g, w) for g, w in zip(got, want))
    if not exact:
        raise AssertionError("knn5_plane on the hash path's block is not bit-exact")
    ms = time_ms(lambda: knn_plane.knn5_plane(cand, found, q))
    plain_ms = time_ms(lambda: knn_plane.knn5_plane_plain(cand, found, q))
    cand_ms = time_ms(lambda: mod.knn_candidates(mp, q, 1, probe))
    bound_ms, bound_by = knn5_bound_ms(n, m)
    print(f"knn5_plane N={n} M={m} on the hash path's block ({int(found.sum())} found "
          f"candidates, {int(want[1].sum())} planes): bit-exact {exact}, "
          f"max_abs_err={err:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}), the block's knn_candidates {cand_ms:.4f} ms, "
          f"library none; {smi}")
    out["knn5_plane"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "max_abs_err": err,
                         "knn_candidates_ms": cand_ms}
    del cand, found, got, want
    k = {"unfused": search_kernels(pipe, False), "fused": search_kernels(pipe, True)}
    print(f"device kernels under lio.search per lidar frame's EKF on the hash map: unfused "
          f"{k['unfused']:.1f}, fused {k['fused']:.1f}")
    if not k["fused"] < k["unfused"]:
        raise AssertionError(f"the fused search did not cut the kernel count: {k}")
    out["search_kernels_per_frame"] = k
    return out


def warmup_phase(dev, duration=2.0, points_per_scan=24000):
    """A few frames of a discarded LIO pipeline at shipped capacities (a
    dataset of its own seed), so that the first timed path is not the
    process's first pipeline: its first launches, allocations and library
    loads fall here. Returns the frames run."""
    from fastlivo_tpu_torch.io.synthetic import SyntheticDataset
    from fastlivo_tpu_torch.pipeline import Pipeline

    pipe = Pipeline(lio_config(), device=dev)
    push_all(pipe, SyntheticDataset(duration=duration, points_per_scan=points_per_scan,
                                    lidar_noise=0.004, seed=7))
    outs = pipe.spin()
    torch.cuda.synchronize()
    if not any(o.iters > 0 for o in outs):
        raise AssertionError(f"warm-up: {len(outs)} frames, none steady")
    print(f"warm-up: {len(outs)} lidar frames of a discarded pipeline "
          f"({sum(o.iters > 0 for o in outs)} steady)")
    return len(outs)


def livo_debug_phase(dev, ds, ref, ref_ms, ref_launches):
    """(g) The LIVO dataset of livo_path_phase through the per-frame path
    with `debug` and `pcd_save_en`, at the same capacities. Neither option
    changes what is computed: positions equal to the LIVO per-frame
    path's, the same launches of both kernels. Checks one overlay byte for
    byte against render_overlay of the same host arrays, Vio.colorize on
    the card against the same call on a CPU Vio with the same image and
    pose (masks may differ in at most 0.1% of the points, colours within
    0.05 of 255 where both paint), and the RGB cloud written by
    run.save_pcd and read back by viz._load_pcd (positions within 6e-5 m,
    the ASCII writer's %.4f; packed colours equal). Returns (ms per lidar
    frame, launches, numbers)."""
    import io
    import os
    import tempfile

    from fastlivo_tpu_torch import run, viz
    from fastlivo_tpu_torch import vio as vio_mod
    from fastlivo_tpu_torch.pipeline import Pipeline

    cfg = livo_config()
    cfg.debug = cfg.pcd_save_en = True
    pipe = Pipeline(cfg, device=dev)
    push_all(pipe, ds)
    drawn, tracked, dump = [], [], io.StringIO()
    real = vio_mod.render_overlay
    vio = pipe.vio
    apply = vio._apply_stats

    def record(*a):
        drawn.append(a)
        return real(*a)

    def applied(stats):
        tracked.append(int(stats[0]))
        apply(stats)

    vio._apply_stats = applied
    cascades = []
    with swapped(vio_mod, "render_overlay", record), contextlib.redirect_stdout(dump), \
            recorded_cascades(cascades):
        outs, launches, wall = counted_run(pipe.spin)
    vio._apply_stats = apply
    c_nums = check_cascades(cascades, "(g)")
    n_tracking = sum(t > 0 for t in tracked)
    d = max_diff(outs, ref)
    ms = wall / len(outs)
    gray, px, perr, valid = drawn[-1]
    same_overlay = np.array_equal(vio.last_overlay, real(gray, px, perr, valid))
    # colorize: the same image, pose and points on a CPU Vio
    pts = outs[-1].pts_world
    m_c, rgb_c = vio.colorize(pts)
    hv = vio_mod.Vio(cfg, device="cpu")
    hv.last_bgr, hv.last_rcw, hv.last_pcw = vio.last_bgr, vio.last_rcw, vio.last_pcw
    m_h, rgb_h = hv.colorize(pts)
    del hv
    mask_diff = int((m_c != m_h).sum())
    both = m_c & m_h
    rgb_err = float(np.abs(rgb_c[both] - rgb_h[both]).max())
    acc = np.concatenate(pipe.rgb_cloud)
    n_world = sum(len(o.pts_world) for o in outs if o.pts_world is not None)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rgb.pcd")
        t0 = time.perf_counter()
        run.save_pcd(path, acc[:, :3], acc[:, 3:6])
        t1 = time.perf_counter()
        p2, r2 = viz._load_pcd(path)
        mb = os.path.getsize(path) / 1e6
    pcd_pos_err = float(np.abs(p2 - acc[:, :3]).max())
    pcd_same_rgb = np.array_equal(r2, np.asarray(acc[:, 3:6], np.uint32).astype(np.float32))
    nums = {"max_diff_to_per_frame_mm": d * 1e3, "overlays": len(drawn),
            "camera_steps_tracking": n_tracking,
            "overlay_byte_equal": same_overlay, "colorize_points": len(pts),
            "colorize_mask_diff": mask_diff, "colorize_max_rgb_diff": rgb_err,
            "rgb_points": len(acc), "painted_share": len(acc) / n_world,
            "pcd_mb": mb, "pcd_write_s": t1 - t0, "pcd_max_pos_err": pcd_pos_err,
            "debug_show_lines": dump.getvalue().count("\n"), "cascades": c_nums}
    print(f"(g) livo debug + pcd_save_en per-frame: {len(outs)} lidar frames, {vio.steps} "
          f"camera steps, {ms:.2f} ms per lidar+camera pair (per-frame path {ref_ms:.2f}), max "
          f"position difference to per-frame {d * 1e3:.4f} mm, launches {launches} (per-frame "
          f"{ref_launches}); {len(drawn)} overlays for the {n_tracking} camera steps that "
          f"tracked points (of {len(tracked)} read), the last byte-equal to render_overlay of "
          f"its host arrays: {same_overlay}; colorize of {len(pts)} points, card vs CPU: "
          f"{mask_diff} masks differ, max rgb difference {rgb_err:.3g}; RGB cloud "
          f"{len(acc)} points, {100 * len(acc) / n_world:.1f}% of the {n_world} world points "
          f"painted; PCD {mb:.1f} MB written in {t1 - t0:.2f} s, read back: max position "
          f"error {pcd_pos_err:.3g} m, colours equal {pcd_same_rgb}; {nvidia_smi_line()}")
    need_launches("(g)", launches, ["lio_cascade", "photometric_cascade", "imu_propagate"])
    need_vio("(g)", launches, vio.steps)
    if not (d < 1e-9 and launches == ref_launches
            and launches["photometric_cascade"] == vio.steps == len(cascades)):
        raise AssertionError(f"(g): {d:.3g} m from per-frame, launches {launches}")
    if not (same_overlay and len(drawn) == n_tracking > len(tracked) // 2
            and len(tracked) == vio.steps
            and vio.last_overlay.shape == (cfg.camera.height, cfg.camera.width, 3)):
        raise AssertionError(f"(g): {len(drawn)} overlays for {n_tracking} tracking steps, "
                             f"{len(tracked)} reads for {vio.steps} steps")
    if not (mask_diff <= 1e-3 * len(pts) and both.sum() > 100 and rgb_err <= 0.05):
        raise AssertionError(f"(g) colorize: {mask_diff} masks differ, rgb {rgb_err}")
    if not (len(acc) > 1000 and pcd_pos_err <= 6e-5 and pcd_same_rgb):
        raise AssertionError(f"(g) RGB cloud: {len(acc)} points, PCD error {pcd_pos_err}")
    return ms, launches, nums


def fork_vio(v):
    """A second Vio on the same state: the visual map, the image pool
    included, is written in place, so it is cloned."""
    import copy

    f = copy.copy(v)
    f.vmap = type(v.vmap)(*(t.clone() for t in v.vmap))
    f._pending = []
    return f


def staged_phase(dev, ds, frames=10, t0=2.0, points=24000):
    """(h) Vio.update_staged against Vio.update at the LIVO path's full
    width (640x512, the shipped visual map), on `frames` camera frames of
    the LIVO dataset from t0: its images, its ground-truth poses with a
    (1, -0.8, 0.6) cm prior offset, `points`-point clouds of its room.
    Each frame runs both on forked states and goes on from the fused one;
    the JAX package's bounds (tests/test_vio.py): position and rotation
    within 5e-4, covariance within 1e-4, tracked within 2, map size within
    5%. The staged path's launches are counted around each staged call
    (three photometric_cascade launches a frame, one per level), its
    cascades are held against the host loop, and the measurement of its
    last cascade's first iteration against its plain version. Returns
    (staged ms per camera frame, launches, numbers)."""
    from fastlivo_tpu_torch import vio as vio_mod
    from fastlivo_tpu_torch.state import identity_state

    f64 = dict(dtype=torch.float64, device=dev)

    def state(t, dpos=(0.0, 0.0, 0.0)):
        rot, pos = ds.traj.pose(t)
        return identity_state(dev)._replace(rot=torch.as_tensor(rot, **f64),
                                            pos=torch.as_tensor(np.asarray(pos) + dpos, **f64))

    def room_cloud(k):
        return ds.room.sample_surface(points, np.random.default_rng(k)).astype(np.float32)

    cams = [(t, img) for t, img in ds.images() if t >= t0][:frames + 1]
    v = vio_mod.Vio(livo_config(), device=dev)
    s0 = state(cams[0][0])
    v.set_last_cloud(room_cloud(0))
    v.update(s0, s0, cams[0][1])  # bootstrap: the first points
    fused_ms, staged_ms, worst, calls = [], [], dict(pos=0.0, rot=0.0, cov=0.0, tracked=0,
                                                     map=0.0), []
    launches = {}
    for k, (t, img) in enumerate(cams[1:], 1):
        sp = state(t, (0.01, -0.008, 0.006))
        v.set_last_cloud(room_cloud(k))
        ref = fork_vio(v)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out_f = v.update(sp, sp, img)
        torch.cuda.synchronize()
        fused_ms.append(1e3 * (time.perf_counter() - t1))
        with recorded_cascades(calls):
            out_s, lk, ms = counted_run(lambda: ref.update_staged(sp, sp, img))
        staged_ms.append(ms)
        launches = {n: launches.get(n, 0) + c for n, c in lk.items()}
        nf, ns = int(v.vmap.n_pts), int(ref.vmap.n_pts)
        dk = dict(pos=float((out_f.pos - out_s.pos).abs().max()),
                  rot=float((out_f.rot - out_s.rot).abs().max()),
                  cov=float((out_f.cov - out_s.cov).abs().max()),
                  tracked=abs(v.last_stats["tracked"] - ref.last_stats["tracked"]),
                  map=abs(nf - ns) / max(ns, 1))
        worst = {n: max(worst[n], dk[n]) for n in worst}
        if not (dk["pos"] <= 5e-4 and dk["rot"] <= 5e-4 and dk["cov"] <= 1e-4
                and dk["tracked"] <= 2 and abs(nf - ns) <= max(3, 0.05 * ns)
                and v.last_stats["tracked"] > 10):
            raise AssertionError(f"(h) frame {k}: {dk}, tracked {v.last_stats} vs "
                                 f"{ref.last_stats}, map {nf} vs {ns}")
        del ref
    c_nums = check_cascades(calls, "(h) staged")
    ph_err = photometric_compare(measurement_args(calls[-1][0]), " (staged path's last call)")
    nums = {"camera_frames": frames, "fused_ms_median": float(np.median(fused_ms)),
            "staged_ms_median": float(np.median(staged_ms)), "worst": worst,
            "photometric_max_abs_err": ph_err, "map_points": int(v.vmap.n_pts),
            "cascades": c_nums}
    cam = v.cfg.camera
    print(f"(h) update_staged vs update, {frames} camera frames at {cam.width}x{cam.height}: "
          f"worst position "
          f"{worst['pos']:.3g}, rotation {worst['rot']:.3g}, covariance {worst['cov']:.3g}, "
          f"tracked {worst['tracked']}, map size {100 * worst['map']:.2f}%; staged launches "
          f"{launches}; ms per camera frame: staged median {np.median(staged_ms):.2f}, fused "
          f"median {np.median(fused_ms):.2f}; {nvidia_smi_line()}")
    need_launches("(h)", launches, ["photometric_cascade"])
    need_vio("(h) staged", launches, frames)
    if (launches["photometric_cascade"] != 3 * frames or launches["photometric_err_H"]
            or launches["photometric_step"] or launches["patches_and_grads"]):
        raise AssertionError(f"(h) staged launches {launches}")
    return float(np.median(staged_ms)), launches, nums


def host_ms(fn, reps=5) -> float:
    """Median host wall of fn() over `reps` calls, in ms."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def feature_ring(n=4000, seed=11):
    """One Avia ring of n points: a wavy wall with depth jumps and blind
    dropouts (tests/test_features.py's native case, longer)."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(-0.6, 0.6, n)
    r = 6.0 + 2.0 * np.sin(3 * ang) + rng.normal(0, 0.01, n)
    r = np.where(rng.random(n) < 0.03, r * rng.uniform(1.5, 3.0, n), r)
    r[rng.random(n) < 0.02] = 0.1
    pl = np.stack([r * np.cos(ang), r * np.sin(ang), 0.1 * np.sin(7 * ang)], 1)
    d = np.diff(pl, axis=0)
    return (pl, np.linspace(0, 100, n), pl[:, 0] ** 2 + pl[:, 1] ** 2,
            np.concatenate([np.sum(d * d, axis=1), [0.0]]))


def native_phase(dev, ds, lio_outs):
    """(i) The native host library (native/ingest.cpp, built by native.py
    with g++ on this machine) must load. Each entry point against its
    numpy or Python twin: the voxel filter on a scan of the LIO dataset
    (rtol 1e-5 / atol 1e-4, tests/test_native.py's bounds), the Avia
    decoder on its scans as Livox CustomPoints (rtol 1e-6), one ring of
    ~4000 points through give_feature (exact), and an lz4 block and
    xxh32 over 512 KiB of those CustomPoints, a bag chunk's payload
    (exact); host times of each. A pipeline's bootstrap frame must filter
    through it. Returns numbers."""
    from fastlivo_tpu_torch import features, native
    from fastlivo_tpu_torch import preprocess as pp
    from fastlivo_tpu_torch.config import AVIA, PreprocessConfig
    from fastlivo_tpu_torch.io import lz4
    from fastlivo_tpu_torch.ops.voxel_filter import voxel_downsample
    from fastlivo_tpu_torch.pipeline import Pipeline

    lib = native.load()
    if lib is None:
        raise AssertionError("(i) the native library did not build or load")
    livox = np.dtype([("offset_time", "<u4"), ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                      ("reflectivity", "u1"), ("tag", "u1"), ("line", "u1")])
    raw = []
    for _, pts, t_rel in ds.lidar_scans_fast()[20:22]:
        arr = np.zeros(len(pts), livox)
        arr["x"], arr["y"], arr["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
        arr["offset_time"] = (t_rel * 1e9).astype(np.uint32)
        arr["tag"] = 0x10
        arr["line"] = np.arange(len(pts)) % 6
        raw.append(arr)
    raw = np.concatenate(raw)
    pcfg = PreprocessConfig(lidar_type=AVIA, n_scans=6, blind=0.5, point_filter_num=2)
    dec = native.decode_avia_native(raw, pcfg.n_scans, pcfg.blind, pcfg.point_filter_num)
    xyz = np.stack([raw["x"], raw["y"], raw["z"]], 1).astype(np.float64)
    ref_pts, ref_t = pp.decode_avia(xyz, raw["reflectivity"].astype(np.float32), raw["tag"],
                                    raw["line"], raw["offset_time"].astype(np.float64), pcfg)
    np.testing.assert_allclose(dec[0], ref_pts, rtol=1e-6)
    np.testing.assert_allclose(dec[1], ref_t, atol=1e-12)
    scan = ds.lidar_scans_fast()[20][1][:, :3].astype(np.float32)
    got = native.voxel_downsample_native(scan, 0.5, max_out=16384)
    want = voxel_downsample(scan, 0.5, max_out=16384)
    if not np.array_equal(got[1], want[1]):
        raise AssertionError("(i) voxel filter: the masks differ")
    vox_err = float(np.abs(got[0] - want[0]).max())
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-4)
    vox_ms = (host_ms(lambda: native.voxel_downsample_native(scan, 0.5, max_out=16384)),
              host_ms(lambda: voxel_downsample(scan, 0.5, max_out=16384)))
    ring = feature_ring()
    sn, cn = native.give_feature_ring_native(*ring, 1.0, 3, True)
    sp, cp = features.give_feature(*ring, 1.0, 3, True)
    if not (np.array_equal(sn, sp) and np.array_equal(cn, cp)):
        raise AssertionError("(i) give_feature: native and Python differ")
    ring_ms = (host_ms(lambda: native.give_feature_ring_native(*ring, 1.0, 3, True), 20),
               host_ms(lambda: features.give_feature(*ring, 1.0, 3, True), 3))
    data = raw.tobytes()[:512 << 10]
    comp = lz4.compress_block(data)
    out_n, out_p = bytearray(), bytearray()
    lz4._decompress_block_native(lib, comp, out_n)
    lz4._decompress_block_py(comp, out_p)
    same_xxh = lz4.xxh32(data) == lz4._xxh32_py(data)
    if not (bytes(out_n) == bytes(out_p) == data and same_xxh):
        raise AssertionError("(i) lz4: native and Python differ")
    lz4_ms = (host_ms(lambda: lz4._decompress_block_native(lib, comp, bytearray())),
              host_ms(lambda: lz4._decompress_block_py(comp, bytearray()), 3))
    xxh_ms = (host_ms(lambda: lz4.xxh32(data)), host_ms(lambda: lz4._xxh32_py(data), 3))
    # a pipeline's bootstrap frame filters through the library
    boot = []
    real = native.voxel_downsample_native

    def record(*a, **kw):
        boot.append(real(*a, **kw))
        return boot[-1]

    pipe = Pipeline(lio_config(), device=dev)
    push_all(pipe, ds, t_max=lio_outs[0].t + 0.05)
    with swapped(native, "voxel_downsample_native", record):
        pipe.spin()
    if not (pipe.map_built and boot and all(b is not None for b in boot)):
        raise AssertionError(f"(i) bootstrap: map built {pipe.map_built}, {len(boot)} calls")
    nums = {"decoded_points": len(dec[0]), "voxel_filter_max_abs_err": vox_err,
            "voxel_filter_ms": vox_ms, "ring_points": len(ring[0]),
            "give_feature_ms": ring_ms, "lz4_bytes": len(data), "lz4_compressed": len(comp),
            "lz4_decode_ms": lz4_ms, "xxh32_ms": xxh_ms, "bootstrap_calls": len(boot)}
    print(f"(i) native library loaded; Avia decoder on {len(raw)} CustomPoints: "
          f"{len(dec[0])} kept, within rtol 1e-6 of numpy; voxel filter "
          f"on a {len(scan)}-point scan: max abs difference to numpy {vox_err:.3g}, native "
          f"{vox_ms[0]:.2f} ms vs numpy {vox_ms[1]:.2f} ms; give_feature on a ring of "
          f"{len(ring[0])} points: exact, native {ring_ms[0]:.3f} ms vs Python "
          f"{ring_ms[1]:.1f} ms; lz4 block of {len(data)} bytes ({len(comp)} compressed): "
          f"exact, native {lz4_ms[0]:.3f} ms vs Python {lz4_ms[1]:.1f} ms; xxh32 exact, "
          f"native {xxh_ms[0]:.3f} ms vs Python {xxh_ms[1]:.1f} ms; the bootstrap frame "
          f"filtered through it ({len(boot)} calls); host times; {nvidia_smi_line()}")
    return nums


@contextlib.contextmanager
def world_of_one(dev):
    """A process group of one on NCCL in this process, and its mesh; the
    communicator set up (at its first collective) before it is used."""
    import datetime

    import torch.distributed as dist

    from fastlivo_tpu_torch.parallel.launch import free_port
    from fastlivo_tpu_torch.parallel.sharded import make_mesh

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh(1, device=dev)
        mesh.all_reduce(mesh.all_gather(torch.zeros(1, device=mesh.device)))
        yield mesh
    finally:
        dist.destroy_process_group()


def counted_rank(rank, n, fn, *args):
    """A rank program that runs `fn(rank, n, *args)` with the kernels'
    counts set to 0 just before; returns (its result, the rank's
    launches), so a spawned run's launches reach the parent."""
    reset_counts()
    return fn(rank, n, *args), read_counts()


def mesh_rank(rank, n, cfg, scans, imu, device, warm=8):
    """(j)'s rank program (parallel.launch.launch): `warm` frames of a
    discarded pipeline (the rank's first launches and connections), then
    the replicated map and the sharded one, on `device`."""
    from fastlivo_tpu_torch.parallel.launch import replay_rank

    replay_rank(rank, n, cfg, scans[:warm], [s for s in imu if s[0] < scans[warm][0]],
                device, False)
    return [replay_rank(rank, n, cfg, scans, imu, device, sharded) for sharded in (False, True)]


def map_bytes(m) -> int:
    return sum(t.numel() * t.element_size() for t in m)


def halo_check(pipe, mesh):
    """knn5_plane_tiled on the input the sharded mesh path gives it: this
    rank's rows of the last scan's queries against a halo snapshot of
    the rank's shard over the scan's box, padded as
    MeshRunner.lidar_frame_step pads it at radius 1; bit-exact against
    its plain version (tiled_check)."""
    from fastlivo_tpu_torch.parallel import sharded_map as sm

    q = real_queries(pipe, pipe.last_effect[0].shape[0])
    lo, hi = sm.scan_box(q, torch.ones(q.shape[0], dtype=torch.bool, device=q.device))
    pad = 2 * pipe.map.voxel_size + 0.5
    runner = pipe.mesh_runner
    snap, dropped = sm.exchange_snapshot(pipe.map, lo - pad, hi + pad, runner.halo_tiles,
                                         mesh, dir_dims=runner.snap_dims)
    if int(dropped):
        raise AssertionError(f"halo snapshot dropped {int(dropped)} tiles")
    return tiled_check(snap, q[mesh.rows(q.shape[0])],
                       f"halo snapshot (mesh {mesh.size}, {int(snap.n_alloc)} tiles)")


def flat_mesh_run(name, dev, mesh, ds, t_max, frames, backend, cache_knn):
    """The replicated world of one on the hash map or the dense grid (with
    `cache_knn` or not) against the single-device path of the same config
    on the same frames: positions equal (0 mm) and the final maps equal
    in every bit; the flat maps' write kernels launched on the rank as on
    one card (one hash_insert_keys and hash_insert_probe, or one
    dense_insert, per insert; one flat_delete_boxes per box set; the
    same counts), the host loop's search kernel on the rank and the
    cascade on the single card. Returns ((ms per frame, launches), its
    other numbers)."""
    from fastlivo_tpu_torch.pipeline import Pipeline

    cfg = lambda: lio_config(map_backend=backend, cache_knn=cache_knn)  # noqa: E731
    single = Pipeline(cfg(), device=dev)
    push_all(single, ds, t_max=t_max)
    s_outs, s_launches, _ = counted_run(single.spin)
    pipe = Pipeline(cfg(), device=mesh.device, mesh=mesh)
    push_all(pipe, ds, t_max=t_max)
    outs, launches, wall = counted_run(pipe.spin)
    d = max_diff(outs, s_outs)
    same_map = all(bits_diff(a, b) == 0.0 for a, b in zip(pipe.map, single.map))
    writes = ("hash_insert_keys", "hash_insert_probe") if backend == "hash" else (
        "dense_insert",)
    flat = {k: launches[k] for k in FLAT_KERNELS}
    want = {k: s_launches[k] for k in FLAT_KERNELS}
    search = "knn5_plane" if cache_knn else "knn5_plane_hashed"
    print(f"{name}: {len(outs)} frames, {wall / len(outs):.2f} ms/frame, max position "
          f"difference to the single-device path {d * 1e3:.4f} mm, final map bit-equal "
          f"{same_map}; the rank's map writes {flat} (one card's {want}), {search} "
          f"{launches[search]}, lio_cascade {launches['lio_cascade']} (one card's "
          f"{s_launches['lio_cascade']}); {nvidia_smi_line()}")
    if (len(outs) < frames or d != 0.0 or not same_map or flat != want
            or not all(flat[k] for k in writes + ("flat_delete_boxes",))
            or not launches[search] or launches["lio_cascade"] or not s_launches["lio_cascade"]):
        raise AssertionError(f"{name}: difference {d} m, map equal {same_map}, launches "
                             f"{launches}, one card's {s_launches}")
    del pipe, single
    torch.cuda.empty_cache()
    return (wall / len(outs), launches), {"max_diff_to_single_device_mm": d * 1e3,
                                          "final_map_bit_equal": same_map}


def mesh_phase(dev, ds, ref, frames=16):
    """(j) LIO over a device mesh, on the first `frames` frames of the LIO
    dataset of path_phase at shipped capacities:
      - a world of one on NCCL in this process, with the map replicated
        and sharded: positions against the per-frame prefix (0 for the
        replicated map, <= 1 mm sharded), ms per frame, knn5_plane_tiled
        launches, collectives per frame and map bytes per rank; then
        replicated on the hash map (with `cache_knn` off and on) and on
        the dense grid, each against its single-device path at 0 mm with
        the flat maps' write kernels counted on the rank
        (flat_mesh_run);
      - a world of two sharing the card under gloo (NCCL refuses two ranks
        on one card), spawned by parallel.launch: rank 0 within 1 mm of
        the prefix, every rank launching the fused search, the sharded
        run's per-rank pool half the replicated one's.
    After the sharded world of one, knn5_plane_tiled is held against its
    plain version on that run's halo snapshot (halo_check).
    Returns ({path: (ms per frame, launches)}, {path: its other numbers},
    the knn5_plane_tiled launches of all of them, the halo check's
    max_abs_err)."""
    from fastlivo_tpu_torch.parallel.launch import launch
    from fastlivo_tpu_torch.pipeline import Pipeline

    smi = nvidia_smi_line()
    t_max = ref[frames].t
    paths, extra, mesh_launches = {}, {}, 0
    with world_of_one(dev) as mesh:
        for sharded in (False, True):
            name = f"mesh 1 nccl {'sharded' if sharded else 'replicated'}"
            pipe = Pipeline(lio_config(), device=mesh.device, mesh=mesh, sharded_map=sharded)
            push_all(pipe, ds, t_max=t_max)
            c0 = mesh.collectives
            outs, launches, wall = counted_run(pipe.spin)
            n_coll = mesh.collectives - c0
            if len(outs) < frames:
                raise AssertionError(f"{name}: {len(outs)} frames of {frames}")
            d = max_diff(outs, ref[:len(outs)])
            steady = sum(o.iters > 0 for o in outs)
            nb = map_bytes(pipe.map)
            print(f"{name}: {len(outs)} frames ({steady} steady), {wall / len(outs):.2f} ms/"
                  f"frame, max position difference to per-frame {d * 1e3:.4f} mm, "
                  f"knn5_plane_tiled {launches['knn5_plane_tiled']}, {n_coll / len(outs):.1f} "
                  f"collectives/frame, map {nb / 1e6:.1f} MB per rank "
                  f"({pipe.map.slot_key.shape[0]} tiles); {smi}")
            if ((d != 0.0 if not sharded else d > 1e-3) or launches["knn5_plane_tiled"] < steady
                    or not launches["imu_propagate"]):
                raise AssertionError(f"{name}: difference {d} m, launches {launches}")
            paths[name] = (wall / len(outs), launches)
            extra[name] = {"max_diff_to_per_frame_mm": d * 1e3, "map_mb_per_rank": nb / 1e6,
                           "collectives_per_frame": n_coll / len(outs)}
            mesh_launches += launches["knn5_plane_tiled"]
            if sharded:
                halo_err = halo_check(pipe, mesh)
            del pipe
            torch.cuda.empty_cache()
        for backend, cache_knn in (("hash", False), ("hash", True), ("dense", False)):
            name = f"mesh 1 nccl replicated {backend}{' cache_knn' if cache_knn else ''}"
            paths[name], extra[name] = flat_mesh_run(name, dev, mesh, ds, t_max, frames,
                                                     backend, cache_knn)

    scans = [s for s in ds.lidar_scans_fast() if s[0] < t_max]
    imu = [s for s in ds.imu_stream() if s[0] < t_max]
    t0 = time.perf_counter()
    res = launch(mesh_rank, 2, (lio_config(), scans, imu, "cuda:0"), backend="gloo",
                 timeout=300, deadline=600)
    print(f"mesh 2 gloo: two ranks on cuda:0 spawned and run in {time.perf_counter() - t0:.1f} s")
    pools = []
    for mode, sharded in enumerate((False, True)):
        name = f"mesh 2 gloo {'sharded' if sharded else 'replicated'}"
        r0 = res[0][mode]
        k = [r[mode]["knn5_plane_tiled"] for r in res]
        ki = [r[mode]["imu_propagate"] for r in res]
        d = float(np.abs(r0["pos"] - np.array([o.pos for o in ref[:len(r0["pos"])]])).max())
        ms = 1e3 * r0["wall_s"] / len(r0["t"])
        print(f"{name}: {len(r0['t'])} frames, {ms:.2f} ms/frame, max position difference "
              f"to per-frame {d * 1e3:.4f} mm, knn5_plane_tiled per rank {k}, imu_propagate "
              f"per rank {ki}, {r0['collectives'] / len(r0['t']):.1f} collectives/frame, map "
              f"{r0['map_bytes'] / 1e6:.1f} MB per rank ({r0['pool_tiles']} tiles); {smi}")
        if len(r0["t"]) < frames or d > 1e-3 or min(k) == 0 or min(ki) == 0:
            raise AssertionError(f"{name}: {len(r0['t'])} frames, difference {d} m, "
                                 f"launches {k}, {ki}")
        pools.append(r0["pool_tiles"])
        paths[name] = (ms, {"knn5_plane_tiled": sum(k), "imu_propagate": sum(ki)})
        extra[name] = {"max_diff_to_per_frame_mm": d * 1e3,
                       "map_mb_per_rank": r0["map_bytes"] / 1e6,
                       "collectives_per_frame": r0["collectives"] / len(r0["t"]),
                       "knn5_plane_tiled_per_rank": k}
        mesh_launches += sum(k)
    if pools[1] * 2 != pools[0]:
        raise AssertionError(f"per-shard pool {pools[1]} is not half of {pools[0]}")

    return paths, extra, mesh_launches, halo_err


def livo_mesh_rank(rank, n, cfg, scans, imu, images, device, warm=8):
    """(k)'s rank program: `warm` frames of a discarded LIVO pipeline,
    then the map replicated and sharded (the visual map in slabs)."""
    from fastlivo_tpu_torch.parallel.launch import replay_rank

    t_w = scans[warm][0]
    replay_rank(rank, n, cfg, scans[:warm], [s for s in imu if s[0] < t_w], device, False,
                [s for s in images if s[0] < t_w])
    return [replay_rank(rank, n, cfg, scans, imu, device, sharded, images)
            for sharded in (False, True)]


def vmap_mb(v) -> float:
    return sum(t.numel() * t.element_size() for t in v.vmap) / 1e6


def partials_compare(a, rows, label) -> float:
    """photometric_err_H's partials (what a mesh sums) against its plain
    version on the rows `rows` of one call's arguments `a`: HᵀH | Hᵀz
    within 1e-4 of its largest entry, Σperr within rtol 1e-5, n_meas
    equal; with no valid row, n_meas 1 and everything else 0. Returns
    the max abs error. These launches are not the path's."""
    from fastlivo_tpu_torch.ops import photometric as ph

    a = [x[rows].contiguous() if i in (1, 2, 3, 4) else x for i, x in enumerate(a)]
    got = ph.photometric_err_H(*a, partials=True)
    torch.cuda.synchronize()
    want = ph.photometric_err_H_plain(*a, partials=True)
    g, w = got[0].cpu().numpy(), want[0].cpu().numpy()
    scale = float(np.abs(w[:42]).max())
    d_ht = float(np.abs(g[:42] - w[:42]).max()) / max(scale, 1e-30)
    d_num = abs(float(g[42]) - float(w[42])) / max(abs(float(w[42])), 1e-30)
    if not (d_ht <= 1e-4 and d_num <= 1e-5 and g[43] == w[43]):
        raise AssertionError(f"photometric_err_H partials {label}: HT {d_ht:.3g} of max, "
                             f"Σperr rel {d_num:.3g}, n_meas {g[43]} vs {w[43]}")
    e = max(float(np.abs(g - w).max()), float((got[1] - want[1]).abs().max()))
    print(f"photometric_err_H partials on {label} ({a[1].shape[0]} cells): HT {d_ht:.3g} of "
          f"max, Σperr rel {d_num:.3g}, n_meas {g[43]:.0f} equal; max_abs_err={e:.3g}")
    none = list(a)
    none[4] = torch.zeros_like(a[4])
    got = ph.photometric_err_H(*none, partials=True)[0].cpu().numpy()
    if got[43] != 1.0 or got[:43].any():
        raise AssertionError(f"photometric_err_H partials with no valid cell: {got[40:]}")
    return e


def livo_mesh_phase(dev, ds, ref, frames=10, duration=3.0):
    """(k) LIVO over a device mesh, on the first `frames` lidar frames of
    the LIVO dataset of livo_path_phase at shipped capacities (640x512,
    grid 40: G = 192 cells; a u8 pool of 256 images and 65536 x 20
    observation rings):
      - the single-device prefix on the same pushes (equal to the per-frame
        path's first frames): one photometric_cascade launch per camera
        frame, their iterations summed;
      - a world of one on NCCL in this process, with the map replicated
        and with the map sharded and the visual map in slabs: 0.0000 mm
        from the prefix, the host loop's photometric_err_H launched once
        per iteration of the prefix's cascades, photometric_step once per
        iteration of those and of the LIO host loops, no cascade, the
        visual map's MB on the rank and
        collectives per camera frame;
      - two ranks sharing the card under gloo: rank 0 within 2 mm of the
        prefix, photometric_err_H and photometric_step launched in every
        rank and no cascade, equal visual-map points replicated and
        sharded, each rank's visual-map MB;
      - photometric_err_H's partials against their plain version on the
        arguments of the sharded world of one's last measurement: all G
        cells and rank 0's slab of a world of two (G/2), and no valid cell;
      - `run.main --synthetic --mesh 1 --sharded-map --map-pcd --save-ckpt`
        with the camera (one spawned NCCL rank, its launches counted in
        the rank): LIVO ATE < 6 cm, every kernel of the path launched, and its
        checkpoint loads into a single-device Pipeline with the whole pool
        and exactly the PCD's map points (the sharded map's gather).
    Returns ({path: (ms per lidar frame, launches)}, {path: its other
    numbers}, photometric_err_H's and photometric_step's launches over the
    mesh runs, the partials' max_abs_err)."""
    import os
    import tempfile

    from fastlivo_tpu_torch import run
    from fastlivo_tpu_torch import vio as vio_mod
    from fastlivo_tpu_torch.config import Config
    from fastlivo_tpu_torch.io import checkpoint as ckpt
    from fastlivo_tpu_torch.ops import tiled_map as tm
    from fastlivo_tpu_torch.parallel import launch as plaunch
    from fastlivo_tpu_torch.parallel.launch import launch
    from fastlivo_tpu_torch.pipeline import Pipeline

    smi = nvidia_smi_line()
    t_max = ref[frames].t
    paths, extra, mesh_launches, step_launches = {}, {}, 0, 0
    pipe = Pipeline(livo_config(), device=dev)
    push_all(pipe, ds, t_max=t_max)
    cascades = []
    with recorded_cascades(cascades):
        prefix, want, wall = counted_run(pipe.spin)
    d = max_diff(prefix, ref[:len(prefix)])
    n_cam, n_pts = pipe.vio.steps, int(pipe.vio.vmap.n_pts)
    iters = sum(int(out[5]) for _, out in cascades)
    print(f"livo prefix: {len(prefix)} lidar frames, {n_cam} camera steps, "
          f"{wall / len(prefix):.2f} ms/frame, {d * 1e3:.4f} mm from the per-frame path, "
          f"launches {want}, {iters} photometric iterations, visual map {n_pts} points, "
          f"{vmap_mb(pipe.vio):.1f} MB")
    if (len(prefix) < frames or d != 0.0 or n_cam < 10
            or not want["photometric_cascade"] == n_cam == len(cascades)
            or not want["vio_select"] == want["vio_observations"] == n_cam
            or want["imu_propagate"] == 0 or iters < 3 * n_cam):
        raise AssertionError(f"livo prefix: {len(prefix)} frames, {d} m, {n_cam} camera "
                             f"steps, launches {want}, {iters} iterations")
    del cascades
    del pipe
    with world_of_one(dev) as mesh:
        for sharded in (False, True):
            name = f"livo mesh 1 nccl {'sharded' if sharded else 'replicated'}"
            pipe = Pipeline(livo_config(), device=mesh.device, mesh=mesh, sharded_map=sharded)
            push_all(pipe, ds, t_max=t_max)
            calls, cam_coll = [], []
            v = pipe.vio
            update = v.update

            def counted_update(*a):  # the collectives of the camera frames
                c0 = mesh.collectives
                out = update(*a)
                cam_coll.append(mesh.collectives - c0)
                return out

            v.update = counted_update
            c0 = mesh.collectives
            with spy(vio_mod, "photometric_err_H", calls):
                outs, launches, wall = counted_run(pipe.spin)
            v.update = update
            d = max_diff(outs, prefix)
            coll = (mesh.collectives - c0 - sum(cam_coll)) / len(outs)
            cam = sum(cam_coll) / max(v.steps, 1)
            print(f"{name}: {len(outs)} frames, {v.steps} camera steps, "
                  f"{wall / len(outs):.2f} ms/frame, {d * 1e3:.4f} mm from the prefix, "
                  f"launches {launches}, visual map {int(v.vmap.n_pts)} points, "
                  f"{vmap_mb(v):.1f} MB on the rank, {cam:.2f} collectives per camera "
                  f"frame ({launches['photometric_err_H'] / max(v.steps, 1):.2f} photometric "
                  f"iterations), {coll:.2f} per lidar frame; {smi}")
            # the step kernel: once per photometric iteration and once per
            # iteration of each lidar frame's LIO host loop
            lio_its = sum(o.iters for o in outs)
            if (d != 0.0 or launches["photometric_err_H"] != iters
                    or launches["photometric_step"] != iters + lio_its
                    or launches["photometric_cascade"] or launches["vio_select"]
                    or launches["vio_observations"]
                    or launches["imu_propagate"] != want["imu_propagate"]
                    or int(v.vmap.n_pts) != n_pts):
                raise AssertionError(f"{name}: {d} m, launches {launches} vs {want}, "
                                     f"{iters} iterations in the prefix")
            paths[name] = (wall / len(outs), launches)
            extra[name] = {"max_diff_to_prefix_mm": d * 1e3, "vmap_mb_per_rank": vmap_mb(v),
                           "collectives_per_camera_frame": cam,
                           "collectives_per_lidar_frame": coll, "vmap_points": n_pts}
            mesh_launches += launches["photometric_err_H"]
            step_launches += launches["photometric_step"]
            last = calls[-1]
            del pipe, v, update
            torch.cuda.empty_cache()
    G = last[1].shape[0]
    err = max(partials_compare(last, slice(0, G), "a world of one's cells"),
              partials_compare(last, slice(0, G // 2), "rank 0's slab of a world of two"))

    scans = [s for s in ds.lidar_scans_fast() if s[0] < t_max]
    imu = [s for s in ds.imu_stream() if s[0] < t_max]
    images = [s for s in ds.images() if s[0] < t_max]
    t0 = time.perf_counter()
    res = launch(livo_mesh_rank, 2, (livo_config(), scans, imu, images, "cuda:0"),
                 backend="gloo", timeout=300, deadline=900)
    print(f"livo mesh 2 gloo: two ranks on cuda:0 spawned and run in "
          f"{time.perf_counter() - t0:.1f} s")
    pts = []
    for mode, sharded in enumerate((False, True)):
        name = f"livo mesh 2 gloo {'sharded' if sharded else 'replicated'}"
        r0 = res[0][mode]
        k = [r[mode]["photometric_err_H"] for r in res]
        ks = [r[mode]["photometric_step"] for r in res]
        kc = [r[mode]["photometric_cascade"] for r in res]
        ki = [r[mode]["imu_propagate"] for r in res]
        mb = [r[mode]["vmap_bytes"] / 1e6 for r in res]
        d = float(np.abs(r0["pos"] - np.array([o.pos for o in prefix[:len(r0["pos"])]])).max())
        ms = 1e3 * r0["wall_s"] / len(r0["t"])
        print(f"{name}: {len(r0['t'])} frames, {r0['vio_steps']} camera steps, {ms:.2f} ms/"
              f"frame, max position difference to the prefix {d * 1e3:.4f} mm, "
              f"photometric_err_H per rank {k}, photometric_step {ks}, photometric_cascade "
              f"{kc}, imu_propagate per rank {ki}, visual map "
              f"{r0['vmap_points']} points, "
              f"{mb} MB per rank, {r0['collectives'] / len(r0['t']):.1f} collectives per "
              f"lidar frame (the camera's included); {smi}")
        lio_its = [int(np.sum(r[mode]["iters"])) for r in res]
        if (len(r0["t"]) < frames or d > 2e-3 or min(k) == 0 or any(kc) or min(ki) == 0
                or ks != [a + b for a, b in zip(k, lio_its)]):
            raise AssertionError(f"{name}: {len(r0['t'])} frames, {d} m, launches {k}, "
                                 f"{ks}, {kc}, {ki}")
        pts.append([r[mode]["vmap_points"] for r in res])
        paths[name] = (ms, {"photometric_err_H": sum(k), "photometric_step": sum(ks),
                            "photometric_cascade": sum(kc), "imu_propagate": sum(ki)})
        extra[name] = {"max_diff_to_prefix_mm": d * 1e3, "vmap_mb_per_rank": mb,
                       "photometric_err_H_per_rank": k, "vmap_points": r0["vmap_points"],
                       "collectives_per_lidar_frame": r0["collectives"] / len(r0["t"])}
        mesh_launches += sum(k)
        step_launches += sum(ks)
    if pts[0] != pts[1] or len(set(pts[0])) != 1:
        raise AssertionError(f"visual-map points replicated {pts[0]} vs sharded {pts[1]}")

    with tempfile.TemporaryDirectory() as tmp:
        cfg_yaml, cam_yaml, out, pcd, ck = (os.path.join(tmp, f) for f in (
            "livo.yaml", "cam.yaml", "traj.txt", "map.pcd", "ck.npz"))
        cfg = livo_config()
        cam = cfg.camera
        with open(cfg_yaml, "w") as f:
            f.write(f"img_enable: 1\noutlier_threshold: {cfg.outlier_threshold}\n"
                    f"img_point_cov: {cfg.img_point_cov}\n"
                    f"camera: {{Rcl: {list(cfg.Rcl)}, Pcl: {list(cfg.Pcl)}}}\n")
        with open(cam_yaml, "w") as f:
            f.write(f"cam_width: {cam.width}\ncam_height: {cam.height}\ncam_fx: {cam.fx}\n"
                    f"cam_fy: {cam.fy}\ncam_cx: {cam.cx}\ncam_cy: {cam.cy}\n")
        # run.main spawns its ranks through parallel.launch.launch; each
        # rank runs under counted_rank, which hands back its launches
        rank_launches = []

        def counting_launch(fn, n, args=(), **kw):
            res = launch(counted_rank, n, (fn, *args), **kw)
            rank_launches.extend(c for _, c in res)
            return [r for r, _ in res]

        t0 = time.perf_counter()
        plaunch.launch = counting_launch
        try:
            rc = run.main(["--config", cfg_yaml, "--camera", cam_yaml, "--synthetic",
                           "--duration", str(duration), "--mesh", "1", "--sharded-map",
                           "--out", out, "--map-pcd", pcd, "--save-ckpt", ck])
        finally:
            plaunch.launch = launch
        wall = time.perf_counter() - t0
        launches = {k: sum(c[k] for c in rank_launches) for k in rank_launches[0]}
        traj = np.loadtxt(out)
        truth = livo_dataset(cfg, duration=duration).traj
        errs = [np.linalg.norm(row[1:4] - (truth.pose(row[0])[1] - truth.base_pos))
                for row in traj if row[0] >= truth.t_static + 0.5]
        ate = float(np.sqrt(np.mean(np.square(errs))))
        with open(pcd) as f:
            n_pcd = int(next(line for line in f if line.startswith("POINTS")).split()[1])
        pipe = Pipeline(livo_config(), device=dev)
        pipe.warm_start(*ckpt.load(ck, device=dev))
        n_map = tm.extract_points(pipe.map)[1]
        v = pipe.vio.vmap
        n_vis, slots = int(v.n_pts), int((v.img_fid >= 0).sum())
    print(f"run --mesh 1 --sharded-map (LIVO): rc {rc}, {len(traj)} poses in {wall:.1f} s "
          f"(spawn included), ATE {ate * 1e3:.3f} mm, map PCD {n_pcd} points, checkpoint "
          f"loaded into a single-device Pipeline: map {n_map} points, visual map {n_vis} "
          f"points, pool {v.imgs.shape[0]} slots ({slots} filled), launches in the rank "
          f"{launches}; {smi}")
    need_launches("run --mesh 1 LIVO", launches,
                  ["knn5_plane_tiled", "photometric_err_H", "photometric_step", "imu_propagate"])
    if (rc != 0 or not ate < 0.06 or launches["photometric_cascade"] or launches["vio_select"]
            or launches["vio_observations"] or n_map != n_pcd or n_pcd == 0
            or v.imgs.shape[0] != Config().capacity.frame_ring or n_vis == 0 or slots == 0):
        raise AssertionError(f"run --mesh 1 LIVO: rc {rc}, ATE {ate}, map points "
                             f"{n_map} / {n_pcd}, {n_vis} visual-map points")
    name = "run --mesh 1 --sharded-map livo (spawn included; launches in the rank)"
    paths[name] = (1e3 * wall / len(traj), launches)
    extra[name] = {"ate_mm": ate * 1e3, "poses": len(traj), "map_points": n_pcd,
                   "vmap_points": n_vis}
    return paths, extra, (mesh_launches, step_launches), err


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
    seconds = {}

    @contextlib.contextmanager
    def phase(label):
        t0 = time.perf_counter()
        yield
        seconds[label] = time.perf_counter() - t0
        print(f"phase {label}: {seconds[label]:.1f} s")

    with phase("build"):
        print(f"build: {build_all():.2f} s")
    # what time_ms reads for a kernel that does nothing: the floor under
    # every kernel time below
    print(f"launch floor: an empty kernel {time_ms(lambda: torch.cuda._sleep(0)):.4f} ms")

    n, m = 16384, 27  # the main path's EKF batch at max_points, radius 1
    with phase("kernels"):
        err_random = kernel_phase(dev, n, m)
        pg_err, pg_ms, pg_plain_ms, pg_bound_ms, pg_bound_by = patches_phase(dev)
        tiled_err = tiled_check(*random_map(dev, n), "random-block map")
        imu_res = imu_phase(dev)
    with phase("warm-up"):
        warmup_phase(dev)
    with phase("lio per-frame"):
        (pipe, lio_launches, lio_outs, lio_ds, lio_ms, lio_call, lio_nums, lio_boxes,
         lio_rec) = path_phase(dev)
        lio_map = pipe.map  # for the map-stage kernels, after the LIVO path
        lio_casc = lio_cascade_phase(lio_call)
        del lio_call

        # the search on the path's own map and queries: compare, then time
        q = real_queries(pipe, n)
        tiled_err = max(tiled_err, tiled_check(pipe.map, q, "path map"))
        cand, found = tm.knn_candidates(pipe.map, q, 1)
        got = knn_plane.knn5_plane(cand, found, q)
        torch.cuda.synchronize()
        want = knn_plane.knn5_plane_plain(cand, found, q)
        err = max(err_random, knn5_contract(got, want, min_both=1000))
        print(f"knn5_plane N={n} M={m} on the tiled path's block: contract ok")
        t_ms = time_ms(lambda: knn_plane.knn5_plane_tiled(pipe.map, q, 1, 0.1))
        pair_ms = time_ms(lambda: knn_plane.knn5_plane(*tm.knn_candidates(pipe.map, q, 1),
                                                       q, 0.1))
        t_plain_ms = time_ms(lambda: knn_plane.knn5_plane_tiled_plain(pipe.map, q, 1, 0.1))
        t_bound_ms, t_bound_by, uniq = tiled_bound_ms(pipe.map, q, 1)
        print(f"knn5_plane_tiled N={n} M={m} on the path map: kernel {t_ms:.4f} ms, unfused "
              f"pair (knn_candidates + knn5_plane kernel) {pair_ms:.4f} ms, plain "
              f"{t_plain_ms:.4f} ms, bound {t_bound_ms:.5f} ms ({t_bound_by}; distinct "
              f"directory entries, pool cells, live points, neighbourhood tiles {uniq}), "
              f"library none; {smi}")
        del pipe, cand, found, got, want
        torch.cuda.empty_cache()
    # the other map backends and LIO options on the same LIO dataset; the
    # fused hash and dense searches and the standalone knn5_plane on their
    # paths' maps; the maps' operations
    paths = {"lio per-frame": (lio_ms, lio_launches)}
    lio_extra = {"lio per-frame": {"lio_cascades": lio_nums}}
    with phase("backends (a)-(f)"):
        backend_paths, path_extra, backend_pipes, backend_ckpts, backend_last, flat_in = \
            backend_paths_phase(dev, lio_ds, lio_outs, lio_ms)
        paths.update(backend_paths)
        path_extra.update(lio_extra)
        # the cascade on the last call of the hash, dense, cache_knn and ref
        # paths, beside its bound and the host loop; the hash and dense
        # paths' last calls again with cache_knn (its gather instances on
        # those maps)
        for k in ("hash", "dense"):
            backend_last[f"{k} cache_knn"] = with_options(backend_last[k], cache_knn=True)
        path_casc = {k: lio_cascade_phase(a, f"the {k} path's last call")
                     for k, a in backend_last.items()}
    with phase("radius 0 and 3 cascades"):
        # the cascade at radius 0 and 3 on each map, walking and under
        # cache_knn, and with the reference's fit at radius 3
        tiled_last = with_options(backend_last["cache_knn"], cache_knn=False)
        radius_calls = {}
        for r in (0, 3):
            for kind, a in (("tiled", tiled_last), ("hash", backend_last["hash"]),
                            ("dense", backend_last["dense"])):
                for search in ("walk", "gather"):
                    radius_calls[f"{kind} {search} r{r}"] = with_radius(
                        with_options(a, cache_knn=search == "gather"), r)
        radius_calls["tiled walk ref r3"] = with_radius(backend_last["ref"], 3)
        radius_casc = radius_phase(radius_calls)
        del backend_last, radius_calls, tiled_last
        torch.cuda.empty_cache()
    with phase("hash and dense search kernels"):
        hashed = hashed_phase(backend_pipes, n, m)
        err = max(err, hashed["knn5_plane"]["max_abs_err"])
        del backend_pipes
        torch.cuda.empty_cache()
    with phase("map ops"):
        flat_res, rebuild = map_ops_phase(dev, flat_in)
        del flat_in
        torch.cuda.empty_cache()
    # the slice's other paths on the same LIO dataset: block replay,
    # serving with autosave and warm restart, bag replay
    with phase("lio block replay"):
        paths.update(lio_block_phase(dev, lio_ds, lio_outs, lio_ms))
    with phase("serve"):
        paths.update(serve_phase(dev, lio_ds, lio_outs))
    with phase("bag"):
        paths.update(bag_phase(dev, lio_ds))
        torch.cuda.empty_cache()
    with phase("livo per-frame"):
        (livo_launches, cascades, cam_fused, lid_fused, livo_outs, livo_ds,
         livo_ms, casc_nums, livo_lio_nums, vio_nums, vio_rec, cam_filter,
         stage_rec) = livo_path_phase(dev)
        last_call = cascades[-1][0]
        del cascades
        vio_res = vio_kernels_phase(vio_rec)
        stage_res = camera_stage_phase(lio_rec["keys"], stage_rec)
        del vio_rec, stage_rec
        torch.cuda.empty_cache()
    with phase("map stage kernels"):
        stages = map_stages_phase(lio_map, lio_boxes, lio_rec, cam_filter)
        del lio_map, lio_rec, cam_filter
        torch.cuda.empty_cache()
    with phase("livo block replay"):
        livo_paths, livo_ckpt, block_casc = livo_block_phase(dev, livo_ds, livo_outs, livo_ms)
    paths["livo per-frame"] = (livo_ms, livo_launches)
    path_extra["livo per-frame"] = {"cascades": casc_nums, "lio_cascades": livo_lio_nums,
                                    "camera_frames": vio_nums}
    paths.update(livo_paths)
    path_extra["livo LivoBlockReplayer(8)"] = {"cascades": block_casc}
    with phase("plain IMU loop paths"):
        pp_paths, pp_extra = plain_propagation_phase(dev, lio_ds, lio_outs, livo_ds, livo_outs)
        paths.update(pp_paths)
        path_extra.update(pp_extra)
    with phase("(g) livo debug + pcd_save_en"):
        g_ms, g_launches, g_nums = livo_debug_phase(dev, livo_ds, livo_outs, livo_ms,
                                                    livo_launches)
        paths["livo debug + pcd_save_en per-frame"] = (g_ms, g_launches)
        path_extra["livo debug + pcd_save_en per-frame"] = g_nums
    torch.cuda.empty_cache()
    with phase("(h) update_staged"):
        h_ms, h_launches, h_nums = staged_phase(dev, livo_ds)
        paths["vio update_staged"] = (h_ms, h_launches)
        path_extra["vio update_staged"] = h_nums
        torch.cuda.empty_cache()
    with phase("(i) native"):
        native_nums = native_phase(dev, lio_ds, lio_outs)
    with phase("(j) mesh"):
        mesh_paths, mesh_extra, mesh_launches, halo_err = mesh_phase(dev, lio_ds, lio_outs)
        tiled_err = max(tiled_err, halo_err)
        paths.update(mesh_paths)
        path_extra.update(mesh_extra)
        torch.cuda.empty_cache()
    with phase("(k) livo mesh"):
        k_paths, k_extra, ph_mesh_launches, partials_err = livo_mesh_phase(
            dev, livo_ds, livo_outs)
        paths.update(k_paths)
        path_extra.update(k_extra)
        del livo_outs
        torch.cuda.empty_cache()
    with phase("photometric kernels"):
        ph_err, ph_ms, ph_pair_ms, ph_plain_ms, ph_bound_ms, ph_bound_by = \
            photometric_phase(dev, measurement_args(last_call, level=0))
        casc = cascade_phase(dev, last_call)
        del last_call
    print(f"camera frame median {cam_fused:.2f} ms, lidar frame median {lid_fused:.2f} ms; "
          f"{smi}")

    with phase("card vs cpu"):
        agreement = cpu_agreement(dev)
        livo_cpu_agreement(dev)
    with phase("(n) radius 3"):
        radius_lio = radius_run(dev)
    with phase("(l) 4 kHz IMU"):
        l_ms, l_launches, l_nums = imu_4khz_phase(dev)
        paths["lio 4 kHz IMU, 512-pair groups"] = (l_ms, l_launches)
        path_extra["lio 4 kHz IMU, 512-pair groups"] = l_nums
    with phase("(m) wide livo"):
        wide_name = "livo patch 24, grid 10 (3264 cells), max_imu_per_group 1024"
        m_ms, m_launches, wide = wide_phase(dev)
        paths[wide_name] = (m_ms, m_launches)
        path_extra[wide_name] = {k: wide[k] for k in (
            "cells", "patch_size", "pose_rows", "imu_bucket", "camera_steps", "tracked",
            "max_diff_to_cpu_mm", "cpu_seconds", "cpu_frames", "cpu_camera_steps")}
        torch.cuda.empty_cache()
    old = {"undistort": stages["undistort"], **vio_res}
    print("changed kernels, shipped size -> wide size (ms, kernel / bound): undistort "
          f"M={old['undistort']['pose_rows']} {old['undistort']['ms']:.4f} / "
          f"{old['undistort']['bound_ms']:.5f} -> M={wide['undistort']['pose_rows']} "
          f"{wide['undistort']['ms']:.4f} / {wide['undistort']['bound_ms']:.5f}; vio_select "
          f"G=192 P=8 {old['vio_select']['ms']:.4f} / {old['vio_select']['bound_ms']:.5f} -> "
          + ", ".join(f"G={wide['cells']} P={P} {r['ms']:.4f} / {r['bound_ms']:.5f}"
                      for P, r in wide["vio_select"].items())
          + f"; vio_observations G=192 {old['vio_observations']['ms']:.4f} / "
          f"{old['vio_observations']['bound_ms']:.5f} -> G={wide['cells']} "
          f"{wide['vio_observations']['ms']:.4f} / {wide['vio_observations']['bound_ms']:.5f}"
          f"; {smi}")
    with phase("profiles"):
        # 9-10 profiled LIO frames fused, 1-2 unfused (whose ~5000 kernels a
        # frame make the profiler's processing the costliest part of the
        # run); 6-7 LIVO pairs fused, 2-3 unfused
        lio_prof = [profile_phase(dev, fused=f, duration=4.0 if f else 3.2)
                    for f in (False, True)]
        livo_prof = [livo_profile_phase(dev, fused=f, duration=3.7 if f else 3.3)
                     for f in (False, True)]
    (lu, lf), (vu, vf) = lio_prof, livo_prof
    print(f"per steady lidar frame, unfused (plain IMU loop) -> fused: device kernels "
          f"{lu['kernels']:.0f} -> {lf['kernels']:.0f}, under lio.search "
          f"{lu['search_kernels']:.1f} -> {lf['search_kernels']:.1f}, under frame.lio_update "
          f"{lu['lio_update_kernels']:.1f} -> {lf['lio_update_kernels']:.1f} (host "
          f"{lu['lio_update_host_ms']:.3f} -> {lf['lio_update_host_ms']:.3f} ms, device "
          f"{lu['lio_update_device_ms']:.3f} -> {lf['lio_update_device_ms']:.3f} ms), "
          f"under frame.propagate "
          f"{lu['propagate_kernels']:.1f} -> {lf['propagate_kernels']:.1f}, frame.propagate "
          f"host {lu['propagate_host_ms']:.3f} -> {lf['propagate_host_ms']:.3f} ms; per LIVO "
          f"lidar + camera pair: device kernels {vu['kernels_per_pair']:.0f} -> "
          f"{vf['kernels_per_pair']:.0f}, under frame.propagate "
          f"{vu['propagate_kernels_per_pair']:.1f} -> {vf['propagate_kernels_per_pair']:.1f}, "
          f"frame.propagate host {vu['propagate_host_ms']:.3f} "
          f"-> {vf['propagate_host_ms']:.3f} ms; under vio.photometric per camera frame "
          f"{vu['photometric_kernels']:.1f} -> {vf['photometric_kernels']:.1f} kernels, host "
          f"{vu['photometric_host_ms']:.3f} -> {vf['photometric_host_ms']:.3f} ms, device "
          f"{vu['photometric_device_ms']:.3f} -> {vf['photometric_device_ms']:.3f} ms; {smi}")
    sl, sv = lf["stages"], vf["stages"]
    ms2 = lambda d, k: (f"{d.get(k, {}).get('host_ms', 0.0):.3f} host / "  # noqa: E731
                        f"{d.get(k, {}).get('device_ms', 0.0):.3f} device")
    print(f"map stages per steady LIO frame, ms: frame.map_insert {ms2(sl, 'frame.map_insert')}"
          f", frame.undistort {ms2(sl, 'frame.undistort')}"
          f", frame.delete_boxes {ms2(sl, 'frame.delete_boxes')}, frame.voxel_filter "
          f"{ms2(sl, 'frame.voxel_filter')}; per camera frame vio.voxel_filter "
          f"{ms2(sv, 'vio.voxel_filter')} ({vu['voxel_filter_kernels']:.1f} -> "
          f"{vf['voxel_filter_kernels']:.1f} kernels), vio.push {ms2(sv, 'vio.push')} "
          f"({vu['push_kernels']:.1f} -> {vf['push_kernels']:.1f} kernels); device kernels "
          f"per LIO frame {lu['kernels']:.0f} "
          f"-> {lf['kernels']:.0f} (device busy {100 * lu['device_busy_share']:.1f}% -> "
          f"{100 * lf['device_busy_share']:.1f}% of wall), per LIVO pair "
          f"{vu['kernels_per_pair']:.0f} -> {vf['kernels_per_pair']:.0f} (unfused -> fused, "
          f"the unfused with the plain box delete, key pass, centroid, insert, "
          f"undistortion, dedup and push); {smi}")
    if not (lf["search_kernels"] < lu["search_kernels"] and lf["kernels"] < lu["kernels"]
            and lf["lio_update_kernels"] < lu["lio_update_kernels"]
            and vf["photometric_kernels"] < vu["photometric_kernels"]
            and vf["kernels_per_pair"] < vu["kernels_per_pair"]
            and lf["propagate_kernels"] < lu["propagate_kernels"]
            and vf["propagate_kernels_per_pair"] < vu["propagate_kernels_per_pair"]
            and vf["select_kernels"] < vu["select_kernels"]
            and vf["observations_kernels"] < vu["observations_kernels"]
            and vf["push_kernels"] < vu["push_kernels"]
            and vf["voxel_filter_kernels"] < vu["voxel_filter_kernels"]):
        raise AssertionError("the fused kernels did not cut the kernel counts")
    ck_keys = ("copy_ms", "write_ms", "disk_mb", "array_mb")
    print(json.dumps({"paths": {
        k: {"ms_per_frame_or_gap_median": v[0],
            "gap_p90": v[1] if k.startswith("serve") else None,
            "launches": v[-1], **path_extra.get(k, {})} for k, v in paths.items()},
        "livo_checkpoint": dict(zip(ck_keys, livo_ckpt)),
        **{f"lio_{k}_checkpoint": dict(zip(ck_keys, v)) for k, v in backend_ckpts.items()},
        "hash_rebuild": rebuild,
        "card_vs_cpu_small_lio": agreement,
        "card_vs_cpu_radius_3_lio": radius_lio,
        "profile": {"lio": dict(zip(("unfused", "fused"), lio_prof)),
                    "livo": dict(zip(("unfused", "fused"), livo_prof))},
        "hashed_search": hashed,
        "native": native_nums,
        "phase_seconds": seconds,
        "nvidia_smi": smi}))

    for k, v in lf.get("map_stage_kernels", {}).items():  # the profiler's time a launch
        if k in stages:
            stages[k]["profiler_us_a_launch"] = v["device_us"]
    print(json.dumps({"kernels": [{
        "name": "knn5_plane_tiled", "route": "cuda",
        "source": "fastlivo_tpu_torch/csrc/knn5_plane_tiled.cu",
        "replaces": "fastlivo_tpu/ops/pallas_lio.py:219",
        "launches": mesh_launches, "path": "(j) lio mesh (the host loop)",
        "max_abs_err": tiled_err,
        "ms": t_ms, "plain_ms": t_plain_ms, "bound_ms": t_bound_ms,
        "bound_by": t_bound_by, "library_ms": None,
        "launches_per_path": {k: v[-1]["knn5_plane_tiled"] for k, v in paths.items()
                              if v[-1].get("knn5_plane_tiled")},
    }, {
        "name": "lio_cascade", "route": "cuda",
        "source": "fastlivo_tpu_torch/csrc/lio_cascade.cu",
        "replaces": "fastlivo_tpu/lio.py:256 (the while_loop around "
                    "fastlivo_tpu/ops/pallas_lio.py:219)",
        "launches": lio_launches["lio_cascade"],
        "max_abs_err": max(lio_casc["max_abs_err"], lio_nums["max_abs_err"],
                           livo_lio_nums["max_abs_err"],
                           *(v["max_abs_err"] for v in path_casc.values()),
                           *(path_extra[k]["lio_cascades"]["max_abs_err"] for k in (
                               "hash", "dense", "tiled cache_knn", "tiled plane_fit ref",
                               "hash BlockReplayer(8)"))),
        **{k: lio_casc[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        **{k: lio_casc[k] for k in (
            "iterations", "searches", "ms_per_iteration", "host_ms", "grid", "loop_ms",
            "loop_host_ms", "loop_plain_step_ms", "plain_host_ms")},
        **{f"{k.replace(' ', '_')}_{'map' if k in ('hash', 'dense') else 'route'}": {
            n: v[n] for n in ("ms", "plain_ms", "bound_ms", "bound_by", "iterations",
                              "searches", "grid", "loop_ms", "loop_host_ms", "host_ms")}
           for k, v in path_casc.items()},
        "libraries": {"lio_cascade": "M = 27", "lio_cascade_125": "M = 125",
                      "lio_cascade_any": "any other M, the walks' generic form"},
        "instances": [f"lio_cascade_kernel<{w}, {g}, {mm}, {f}>" for w in (
            "TILED", "HASH", "DENSE") for g in ("walk", "gather") for mm in (27, 125)
            for f in ("tls", "ref")] + [
            f"lio_cascade_kernel<{w}, walk or gather at run time, ANY_M, {f}>" for w in (
                "TILED", "HASH", "DENSE") for f in ("tls", "ref")],
        "by_radius": radius_casc,
        "launches_by_route": {k: path_extra[k]["lio_cascade_by_route"] for k in (
            "hash", "dense", "tiled cache_knn", "tiled plane_fit ref",
            "hash BlockReplayer(8)")},
        "launches_per_path": {k: v[-1]["lio_cascade"] for k, v in paths.items()
                              if v[-1].get("lio_cascade")},
    }, {
        "name": "photometric_err_H", "route": "cuda",
        "source": "fastlivo_tpu_torch/csrc/photometric_err_H.cu",
        "replaces": "fastlivo_tpu/ops/pallas_image.py:180",
        "launches": ph_mesh_launches[0], "path": "(k) livo mesh (the host loop)",
        "max_abs_err": max(ph_err, partials_err),
        "ms": ph_ms, "plain_ms": ph_plain_ms, "bound_ms": ph_bound_ms,
        "bound_by": ph_bound_by, "library_ms": None, "wide": wide["photometric_err_H"],
        "launches_per_path": {k: v[-1]["photometric_err_H"] for k, v in paths.items()
                              if v[-1].get("photometric_err_H")},
    }, {
        "name": "photometric_cascade", "route": "cuda",
        "source": "fastlivo_tpu_torch/csrc/photometric_cascade.cu",
        "replaces": "fastlivo_tpu/vio.py:723 (the while_loop around "
                    "fastlivo_tpu/ops/pallas_image.py:180)",
        "launches": livo_launches["photometric_cascade"],
        "max_abs_err": casc["cascade"]["max_abs_err"],
        **{k: casc["cascade"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        **{k: casc["cascade"][k] for k in (
            "iterations", "ms_per_iteration", "host_ms", "loop_ms", "loop_ms_per_iteration",
            "loop_plain_step_ms", "plain_host_ms")},
        "wide": wide["photometric_cascade"],
        "launches_per_path": {k: v[-1]["photometric_cascade"] for k, v in paths.items()
                              if v[-1].get("photometric_cascade")},
    }, {
        "name": "photometric_step", "route": "cuda",
        "source": "fastlivo_tpu_torch/csrc/photometric_cascade.cu",
        "replaces": "fastlivo_tpu/vio.py:669-691 (the while_loop body's step, over a mesh)",
        "launches": ph_mesh_launches[1], "path": "(k) livo mesh (the host loop)",
        "max_abs_err": casc["step"]["max_abs_err"],
        **{k: casc["step"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "launches_per_path": {k: v[-1]["photometric_step"] for k, v in paths.items()
                              if v[-1].get("photometric_step")},
    }, *[{
        "name": name, "route": "cuda",
        "source": f"fastlivo_tpu_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": livo_launches[name], "path": "livo per-frame",
        "max_abs_err": vio_nums["max_abs_err"],
        **{k: vio_res[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        **{k: v for k, v in vio_res[name].items() if k in ("bytes", "ops", "grid", "host_ms")},
        "wide": wide[name],
        "launches_per_path": {k: v[-1][name] for k, v in paths.items() if v[-1].get(name)},
    } for name, replaces in (
        ("vio_select", "fastlivo_tpu/vio.py:130-484 (select_tracked and select_new_points, "
                       "jitted XLA; no Pallas kernel)"),
        ("vio_observations", "fastlivo_tpu/vio.py:972 and fastlivo_tpu/visual_map.py:243, "
                             ":494 (prep_observations, add_points, add_observations, jitted "
                             "XLA; no Pallas kernel)"))], {
        "name": "knn5_plane_hashed", "route": "cuda",
        "source": "fastlivo_tpu_torch/csrc/knn5_plane_hashed.cu",
        "replaces": "fastlivo_tpu/ops/pallas_lio.py:219",
        "launches": backend_paths["hash"][1]["knn5_plane_hashed"],
        "path": "none since the hash and dense EKF runs in lio_cascade (its walk "
                "knn5_hashed_walk.cuh); the cascade's oracle",
        "max_abs_err": max(hashed["hash"]["max_abs_err"], hashed["dense"]["max_abs_err"]),
        "ms": hashed["hash"]["ms"], "plain_ms": hashed["hash"]["plain_ms"],
        "bound_ms": hashed["hash"]["bound_ms"], "bound_by": hashed["hash"]["bound_by"],
        "library_ms": None, "unfused_pair_ms": hashed["hash"]["pair_ms"],
        "dense": {k: hashed["dense"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "pair_ms")},
        "launches_per_path": {k: backend_paths[k][1]["knn5_plane_hashed"] for k in (
            "hash", "dense", "hash BlockReplayer(8)")},
    }, {
        "name": "knn5_plane", "route": "cuda",
        "source": "fastlivo_tpu_torch/csrc/knn5_plane.cu",
        "replaces": "fastlivo_tpu/ops/pallas_lio.py:219",
        "launches": backend_paths["tiled cache_knn"][1]["knn5_plane"], "max_abs_err": err,
        "path": "none on one card since cache_knn's EKF runs in lio_cascade (the block "
                "written by its first search, re-ranked by knn5_cached_walk.cuh); the "
                "cascade's oracle under cache_knn, and the search of the host loop (a mesh "
                "under cache_knn)",
        **{k: hashed["knn5_plane"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "launches_per_path": {k: v[-1]["knn5_plane"] for k, v in paths.items()
                              if "cache_knn" in k},
    }, {
        "name": "patches_and_grads", "route": "cuda",
        "source": "fastlivo_tpu_torch/csrc/patches_and_grads.cu",
        "replaces": "fastlivo_tpu/ops/pallas_image.py:180",
        "launches": livo_launches["patches_and_grads"], "max_abs_err": pg_err,
        "ms": pg_ms, "plain_ms": pg_plain_ms, "bound_ms": pg_bound_ms,
        "bound_by": pg_bound_by, "library_ms": None,
    }, {
        "name": "imu_propagate", "route": "cuda",
        "source": "fastlivo_tpu_torch/csrc/imu_propagate.cu",
        "replaces": "fastlivo_tpu/imu.py:314 (lax.scan, no Pallas kernel)",
        "launches": lio_launches["imu_propagate"],
        "max_abs_err": max(v["max_abs_err"] for v in imu_res.values()),
        **{k: imu_res[32][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None, "pairs": 32, "chain_steps": 32, "by_pairs": imu_res,
        "launches_per_path": {k: v[-1]["imu_propagate"] for k, v in paths.items()},
        "mesh_launches": sum(v[-1]["imu_propagate"] for k, v in paths.items() if "mesh" in k),
    }, *[{
        "name": name, "route": "cuda",
        "source": f"fastlivo_tpu_torch/csrc/{source}.cu",
        "replaces": replaces,
        "launches": lio_launches[counter], "path": "lio per-frame",
        **{k: stages[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by")},
        "library_ms": stages[name].get("library_ms"),
        **{k: v for k, v in stages[name].items() if k not in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        **({"wide": wide["undistort"]} if name == "undistort" else {}),
        "launches_per_path": {k: v[-1][counter] for k, v in paths.items()
                              if v[-1].get(counter)},
    } for name, counter, source, replaces in (
        ("tiled_delete_boxes", "delete_boxes", "tiled_delete_boxes",
         "fastlivo_tpu/ops/tiled_map.py:246-260 (delete_boxes, jitted XLA; no Pallas kernel)"),
        ("voxel_centroids", "voxel_centroids", "voxel_centroids",
         "fastlivo_tpu/ops/voxel_filter.py:54-71 (voxel_downsample_device after its argsort, "
         "jitted XLA; no Pallas kernel)"),
        ("tiled_insert_sort", "insert_sort", "tiled_insert",
         "fastlivo_tpu/ops/tiled_map.py:121-138 (insert up to and with its argsort: keys, "
         "tiles, hash, distance, packed key, jnp.argsort; jitted XLA; no Pallas kernel)"),
        ("tiled_insert_keys", "insert_keys", "tiled_insert",
         "fastlivo_tpu/ops/tiled_map.py:121-137 (insert before its argsort: keys, tiles, "
         "hash, distance, packed key; jitted XLA; no Pallas kernel)"),
        ("tiled_insert_tiles", "insert_tiles", "tiled_insert",
         "fastlivo_tpu/ops/tiled_map.py:139-200 (insert after its argsort: tile winners, "
         "allocation cumsum, directory writes, then its cells; jitted XLA; no Pallas "
         "kernel)"),
        ("tiled_insert_cells", "insert_tiles", "tiled_insert",
         "fastlivo_tpu/ops/tiled_map.py:170-200 (insert: first-ok cell winners by cumsum and "
         "cummax, cell writes; jitted XLA; no Pallas kernel; here the cells pass inside "
         "tiled_insert_tiles' launch)"),
        ("undistort", "undistort", "undistort",
         "fastlivo_tpu/imu.py:354-398 (undistort, jitted XLA; no Pallas kernel)"))], *[{
        "name": name, "route": "cuda",
        "source": f"fastlivo_tpu_torch/csrc/{source}.cu",
        "replaces": replaces,
        "launches": backend_paths[path][1][name], "path": path, "max_abs_err": 0.0,
        **{k: flat_res[key][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        **{k: v for k, v in flat_res[key].items() if k not in (
            "ms", "plain_ms", "bound_ms", "bound_by")},
        **({"dense": flat_res["flat_delete_boxes dense"]} if name == "flat_delete_boxes"
           else {}),
        "launches_per_path": {k: v[-1][name] for k, v in paths.items() if v[-1].get(name)},
    } for name, key, path, source, replaces in (
        ("hash_insert_keys", "hash_insert_keys", "hash", "hash_insert",
         "fastlivo_tpu/ops/voxel_map.py:146-164 (insert up to the run heads: voxel, slot, "
         "check, distance, jnp.lexsort's heads without a sort; jitted XLA; no Pallas "
         "kernel)"),
        ("hash_insert_probe", "hash_insert_probe", "hash", "hash_insert",
         "fastlivo_tpu/ops/voxel_map.py:165-189 (insert's probe rounds over the heads; "
         "jitted XLA; no Pallas kernel)"),
        ("dense_insert", "dense_insert", "dense", "dense_insert",
         "fastlivo_tpu/ops/dense_map.py:70-114 (insert, jitted XLA; no Pallas kernel)"),
        ("flat_delete_boxes", "flat_delete_boxes hash", "hash", "flat_delete_boxes",
         "fastlivo_tpu/ops/voxel_map.py:268-286 and fastlivo_tpu/ops/dense_map.py:141-157 "
         "(delete_boxes, jitted XLA; no Pallas kernel)"))], *[{
        "name": name, "route": "cuda",
        "source": f"fastlivo_tpu_torch/csrc/{source}.cu",
        "replaces": replaces,
        "launches": livo_launches[name], "path": "livo per-frame",
        "max_abs_err": 0.0,
        **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": r.get("library_ms"),
        **{k: v for k, v in r.items() if k not in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        **extra,
        "launches_per_path": {k: v[-1][name] for k, v in paths.items() if v[-1].get(name)},
    } for name, source, r, extra, replaces in (
        ("voxel_sort", "voxel_keys", stage_res["voxel_sort"]["camera cloud"],
         {"lio_scan": stage_res["voxel_sort"]["lio scan"],
          "lio_launches": lio_launches["voxel_sort"]},
         "fastlivo_tpu/ops/voxel_filter.py:41-53 (voxel_downsample_device up to and with its "
         "argsort: the packed keys and their stable sort; jitted XLA; no Pallas kernel)"),
        ("voxel_keys", "voxel_keys", stage_res["voxel_keys"]["camera cloud"],
         {"lio_scan": stage_res["voxel_keys"]["lio scan"],
          "path": "none since voxel_sort, whose launch computes the keys with the same "
                  "device function"},
         "fastlivo_tpu/ops/voxel_filter.py:41-52 (voxel_downsample_device before its argsort: "
         "the finite test, floor, cast, 3 x 20-bit packing, invalid marker; jitted XLA; no "
         "Pallas kernel)"),
        ("vio_dedup", "vio_dedup", stage_res["vio_dedup"], {},
         "fastlivo_tpu/vio.py:735-780 (_dedup_voxels, jitted XLA; no Pallas kernel)"),
        ("vio_push", "vio_push", stage_res["vio_push"], {},
         "fastlivo_tpu/visual_map.py:126-156, :191-213, :216-240 (_live_slot_refs, "
         "push_slot, push_image; jitted XLA; no Pallas kernel)"))]]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
