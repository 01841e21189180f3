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
device mesh on the first 24 LIO frames: a world of one on NCCL in this
process and a world of two sharing the card under gloo (spawned by
`parallel.launch`), each with the map replicated and block-sharded,
against the per-frame path, and (k) LIVO over a device mesh on the
first 24 lidar frames of the LIVO dataset, the same two worlds with the
map replicated and with the map sharded and the camera's image pool and
observation rings in per-rank slabs, against the single-device prefix,
`photometric_err_H`'s partials (what a mesh sums) held against their
plain version on one rank's slab, then `run.main --mesh 1 --sharded-map`
with the camera and its checkpoint. The tiled-map paths
run the fused kernels: the LIO search in one launch (`knn5_plane_tiled`)
and each photometric iteration's measurement in one launch
(`photometric_err_H`, also on the staged path and in every rank of the
mesh runs); the hash, dense and
`cache_knn` paths search through the standalone `knn5_plane`; each
path's launches are counted around it. The standalone
`patches_and_grads` is held against its plain version but is not on the
paths. The hash and dense maps' operations run on the card and on the
CPU on the same seeded points and must agree in every array; `rebuild`
is timed at the shipped table. Each path's trajectory is checked against
the per-frame path and the synthetic ground truth, and the port on the
card against the port on the CPU on a small input. Both per-frame paths
are profiled, and so is the unfused composition they replaced, for the
kernel counts under `lio.search` and `vio.photometric` before and after.

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

    def wrapped(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

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


def photometric_compare(a, label="") -> float:
    """photometric_err_H against its plain version on one call's arguments
    `a`: HᵀH and Hᵀz each within 1e-4 of its largest entry, err and perr
    within rtol 1e-5. Returns the max abs error over all outputs. This
    launch is not the path's."""
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
    print(f"photometric_err_H{label} G={G} P={P} level {level} robust {robust}: "
          f"{', '.join(rel)}; max_abs_err={e:.3g} (|HT| up to "
          f"{float(want[1].abs().max()):.3g})")
    return e


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
    ds = Recorded(SyntheticDataset(duration=duration, points_per_scan=points_per_scan,
                                   lidar_noise=0.004, seed=0))
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
    return pipe, launches, outs, ds, 1e3 * wall / len(outs)


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
    around this run only: the fused kernels launch once per search and
    once per photometric iteration and the standalone ones never.
    Camera-frame time: host wall of Vio.update, its stats read included.
    Returns (launches, the last photometric call's arguments, camera and
    lidar frame medians in ms, the outputs, the dataset, wall ms per
    lidar frame)."""
    from fastlivo_tpu_torch import lio, vio as vio_mod
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
    with spy(lio, "knn5_plane_tiled", searches), \
            spy(vio_mod, "photometric_err_H", measurements):
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
    print(f"livo path: {len(outs)} lidar frames ({len(steady)} steady), {vio.fid} camera "
          f"frames ({vio.steps} ran the frame step) in {wall:.2f} s; {len(searches)} "
          f"searches, {len(measurements)} photometric iterations; launches {launches}; "
          f"ATE {ate * 1e3:.3f} mm; visual map {n_pts} points, last {vio.last_stats}")
    print(f"livo path: camera frame median {np.median(cam_ms):.2f} ms (p90 "
          f"{np.percentile(cam_ms, 90):.2f} ms) over {len(cam_ms)}; lidar frame median "
          f"{np.median(lid_ms):.2f} ms (p90 {np.percentile(lid_ms, 90):.2f} ms) over "
          f"{len(lid_ms)}; {nvidia_smi_line()}")
    if len(steady) < 30 or vio.steps < 30:
        raise AssertionError(f"too few frames: {len(steady)} steady, {vio.steps} camera")
    if n_pts <= 50 or vio.last_stats.get("tracked", 0) <= 5:
        raise AssertionError(f"visual map {n_pts} points, last {vio.last_stats}")
    if len(measurements) < 3 * vio.steps or len(searches) < len(steady):
        raise AssertionError(f"{len(measurements)} measurements, {len(searches)} searches")
    want = {"knn5_plane_tiled": len(searches), "knn5_plane": 0,
            "photometric_err_H": len(measurements), "patches_and_grads": 0}
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want}")
    if not (np.isfinite(pos).all() and torch.isfinite(pipe.state.cov).all()):
        raise AssertionError("non-finite state")
    if not ate < 0.06:
        raise AssertionError(f"LIVO ATE {ate:.4f} m >= 6 cm")
    return (launches, measurements[-1], float(np.median(cam_ms)), float(np.median(lid_ms)),
            outs, ds, 1e3 * wall / len(outs))


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
    check_composition(counts, fused, [("knn5_plane_tiled", "knn5_plane")], "lio profile")
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
    check_composition(counts, fused, [("knn5_plane_tiled", "knn5_plane"),
                                      ("photometric_err_H", "patches_and_grads")],
                      "livo profile")
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
    frames, each within 5 mm of it, ATE < 2 cm, through the fused
    search. Returns {path: (ms per lidar frame, launches)}."""
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
        need_launches(name, launches, ["knn5_plane_tiled"])
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
    the per-frame path's frames within 1 cm, ATE < 6 cm, both fused
    kernels launched; then a checkpoint of the LIVO estimator (geometric
    and visual maps at shipped capacities)."""
    from fastlivo_tpu_torch.pipeline import Pipeline
    from fastlivo_tpu_torch.replay import LivoBlockReplayer

    pipe = Pipeline(livo_config(), device=dev)
    push_all(pipe, ds)
    outs, launches, wall = counted_run(lambda: LivoBlockReplayer(pipe, 8).run())
    d, ate = max_diff(outs, ref), ate_of(outs, ds)
    ms = wall / len(outs)
    print(f"livo LivoBlockReplayer(8): {len(outs)} lidar frames, {pipe.vio.steps} camera "
          f"steps, {ms:.2f} ms per lidar+camera pair (per-frame path {ref_ms:.2f}), max "
          f"position difference to per-frame {d * 1e3:.4f} mm, ATE {ate * 1e3:.3f} mm, "
          f"launches {launches}; {nvidia_smi_line()}")
    need_launches("livo block", launches, ["knn5_plane_tiled", "photometric_err_H"])
    if not (d < 1e-2 and ate < 0.06):
        raise AssertionError(f"livo block: {d:.4f} m from per-frame, ATE {ate:.4f} m")
    ck = checkpoint_roundtrip(pipe, dev, "livo")
    return {"livo LivoBlockReplayer(8)": (ms, launches)}, ck


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
        need_launches("serve", launches, ["knn5_plane_tiled"])
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
    need_launches("serve warm restart", launches2, ["knn5_plane_tiled"])
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
    need_launches("bag", launches, ["knn5_plane_tiled"])
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
    dense, cache_knn and hash-block paths must search through the
    standalone knn5_plane kernel and never the tiled one; plane_fit ref
    through neither; profile_every must leave the per-frame outputs
    unchanged in every bit; every ATE < 2 cm. Checkpoints the hash and
    dense estimators. Returns ({path: (ms per frame, launches)}, {path:
    its other numbers}, the hash path's pipeline, {map: checkpoint
    numbers})."""
    from fastlivo_tpu_torch.ops import dense_map as dm
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
    paths, extra, ckpts, hash_pipe = {}, {}, {}, None
    t_max = ref[frames].t
    for name, cfg, rep, every in runs:
        cap = cfg.capacity
        pipe = Pipeline(cfg, device=dev)
        pipe.profile_every = every
        push_all(pipe, ds, t_max=t_max)
        gathers = []
        mod = {"tiled": tm, "dense": dm, "hash": vm}[cap.map_backend]
        with spy(mod, "knn_candidates", gathers):
            outs, launches, wall = counted_run(
                (lambda: rep(pipe, 8).run()) if rep else pipe.spin)
        if len(outs) < frames:
            raise AssertionError(f"{name}: {len(outs)} frames of {frames}")
        pref = ref[:len(outs)]
        steady = [1e3 * o.timing["total"] for o in outs if o.iters > 0]
        d, ate = max_diff(outs, pref), ate_of(outs, ds)
        ms = wall / len(outs)
        k, kt = launches["knn5_plane"], launches["knn5_plane_tiled"]
        print(f"{name}: {len(outs)} frames ({len(steady)} steady), {ms:.2f} ms/lidar frame "
              f"(tiled per-frame {ref_ms:.2f}), median steady frame {np.median(steady):.2f} ms, "
              f"ATE {ate * 1e3:.3f} mm, max position difference to tiled per-frame "
              f"{d * 1e3:.4f} mm, knn5_plane {k}, knn5_plane_tiled {kt}, {len(gathers)} "
              f"candidate gathers ({cap.map_backend} map, cache_knn {cap.cache_knn}, "
              f"plane_fit {cap.plane_fit}); {nvidia_smi_line()}")
        if cap.plane_fit == "ref":
            ok = k == 0 and kt == 0
        elif every:
            ok = kt > 0 and k == 0 and same_outputs(outs, pref)
            print(f"{name}: last_stage_profile {pipe.last_stage_profile} ms, outputs "
                  f"bit-identical to per-frame: {same_outputs(outs, pref)}")
            ok = ok and set(pipe.last_stage_profile or ()) == {
                "undistort", "downsample", "ekf", "map"}
        else:
            ok = k > 0 and kt == 0
        if not ok or not ate < 0.02:
            raise AssertionError(f"{name}: launches {launches}, ATE {ate:.4f} m")
        paths[name] = (ms, launches)
        extra[name] = {"median_steady_ms": float(np.median(steady)), "ate_mm": ate * 1e3,
                       "max_diff_to_tiled_mm": d * 1e3, "candidate_gathers": len(gathers)}
        if every:
            extra[name]["last_stage_profile_ms"] = pipe.last_stage_profile
        if name in ("hash", "dense"):
            ckpts[name] = checkpoint_roundtrip(pipe, dev, f"lio {name}")
        if name == "hash":
            hash_pipe = pipe
        del pipe
    return paths, extra, hash_pipe, ckpts


def colliding_voxels(T: int):
    """Two voxel coordinates whose first probe slot in a table of T slots
    is the same."""
    from fastlivo_tpu_torch.ops import voxel_map as vm

    k = np.stack(np.meshgrid(*[np.arange(-6, 6)] * 3, indexing="ij"), -1).reshape(-1, 3)
    slot = vm._slot_check(torch.from_numpy(k.astype(np.int32)), T - 1)[0].numpy()
    order = np.argsort(slot, kind="stable")
    i = np.nonzero(slot[order][1:] == slot[order][:-1])[0][0]
    return k[order[[i, i + 1]]]


def map_ops_phase(dev, T=1 << 16, dims=(64, 64, 16), n=40000, T_full=1 << 20):
    """The hash map (T slots) and the dense grid (`dims`, aliasing: it
    spans 32 x 32 x 8 m, the points 40 m) built from seeded random points
    on the card and on the CPU: three inserts (the first with two voxels
    that claim one slot in the same round), knn_candidates at radius 1
    and 2, delete_boxes and the hash map's rebuild; every array on the
    card must equal the CPU's. Then times rebuild at a T_full table 75%
    full. Returns (rebuild ms, its occupancy)."""
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
    card, cpu = res[str(dev)], res["cpu"]
    differ = [i for i, (x, y) in enumerate(zip(card, cpu))
              if not all(torch.equal(a, b) for a, b in zip(x, y))]
    same = not differ
    print(f"map ops, hash 2^{T.bit_length() - 1} slots ({int(cpu[2][2])} occupied) and dense "
          f"{dims} ({int(cpu[9][2])} occupied) from {n} seeded points: insert x3 (with a "
          f"duplicate claim), knn_candidates r=1,2, delete_boxes, rebuild: card equals CPU "
          f"in every array: {same}")
    if not same:
        raise AssertionError(f"map ops on the card differ from the CPU at steps {differ}")

    # rebuild at the shipped table, 75% full of distinct voxels (a block
    # of 128 x 128 x k voxels)
    n_full = 3 * T_full // 4
    g = np.stack(np.unravel_index(np.arange(n_full), (128, 128, -(-n_full // 16384))), -1)
    full = torch.from_numpy(((g - 64 + 0.5) * 0.5).astype(np.float32)).to(dev)
    m = vm.insert(vm.empty_map(T_full, 0.5, device=dev), full,
                  torch.ones(n_full, dtype=torch.bool, device=dev), 32)
    occ = int(m.count) / T_full
    rb_ms = event_ms(lambda: vm.rebuild(m))
    kept = int(vm.rebuild(m).count)
    print(f"rebuild: 2^{T_full.bit_length() - 1} slots at {100 * occ:.2f}% occupancy "
          f"({n_full} voxels inserted at probe depth 32, {kept} kept by the rebuild), "
          f"{rb_ms:.3f} ms per call alone (CUDA events); {nvidia_smi_line()}")
    return rb_ms, occ


def hash_block_phase(pipe, n=16384, m=27):
    """The standalone knn5_plane on the hash path's own candidate block:
    the last scan's EKF batch (N = 16384) at the posterior, M = 27
    neighbourhood voxels from voxel_map.knn_candidates. Against its plain
    version (the contract, and whether bit-exact), timed beside its
    bound, its plain version and the block's knn_candidates. These
    launches are not the path's. Returns (max_abs_err, ms, plain ms,
    bound ms, bound by, knn_candidates ms)."""
    from fastlivo_tpu_torch.ops import knn_plane
    from fastlivo_tpu_torch.ops import voxel_map as vm

    q = real_queries(pipe, n)
    probe = pipe.cfg.capacity.max_probe
    cand, found = vm.knn_candidates(pipe.map, q, 1, probe)
    got = knn_plane.knn5_plane(cand, found, q)
    torch.cuda.synchronize()
    want = knn_plane.knn5_plane_plain(cand, found, q)
    err = knn5_contract(got, want, min_both=1000)
    exact = all(torch.equal(g, w) for g, w in zip(got, want))
    ms = time_ms(lambda: knn_plane.knn5_plane(cand, found, q))
    plain_ms = time_ms(lambda: knn_plane.knn5_plane_plain(cand, found, q))
    cand_ms = time_ms(lambda: vm.knn_candidates(pipe.map, q, 1, probe))
    bound_ms, bound_by = knn5_bound_ms(n, m)
    print(f"knn5_plane N={n} M={m} on the hash path's block ({int(found.sum())} found "
          f"candidates, {int(want[1].sum())} planes): contract ok, bit-exact {exact}, "
          f"max_abs_err={err:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), the block's knn_candidates {cand_ms:.4f} ms, "
          f"library none; {nvidia_smi_line()}")
    return err, ms, plain_ms, bound_ms, bound_by, cand_ms


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
    with swapped(vio_mod, "render_overlay", record), contextlib.redirect_stdout(dump):
        outs, launches, wall = counted_run(pipe.spin)
    vio._apply_stats = apply
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
            "debug_show_lines": dump.getvalue().count("\n")}
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
    need_launches("(g)", launches, ["knn5_plane_tiled", "photometric_err_H"])
    if not (d < 1e-9 and launches == ref_launches):
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
    5%. The staged path's launches are counted around each staged call,
    and its last photometric measurement is held against its plain
    version. Returns (staged ms per camera frame, launches, numbers)."""
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
        calls.clear()
        with spy(vio_mod, "photometric_err_H", calls):
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
    ph_err = photometric_compare(list(calls[-1]), " (staged path's last call)")
    nums = {"camera_frames": frames, "fused_ms_median": float(np.median(fused_ms)),
            "staged_ms_median": float(np.median(staged_ms)), "worst": worst,
            "photometric_max_abs_err": ph_err, "map_points": int(v.vmap.n_pts)}
    cam = v.cfg.camera
    print(f"(h) update_staged vs update, {frames} camera frames at {cam.width}x{cam.height}: "
          f"worst position "
          f"{worst['pos']:.3g}, rotation {worst['rot']:.3g}, covariance {worst['cov']:.3g}, "
          f"tracked {worst['tracked']}, map size {100 * worst['map']:.2f}%; staged launches "
          f"{launches}; ms per camera frame: staged median {np.median(staged_ms):.2f}, fused "
          f"median {np.median(fused_ms):.2f}; {nvidia_smi_line()}")
    need_launches("(h)", launches, ["photometric_err_H"])
    if launches["photometric_err_H"] < 3 * frames or launches["patches_and_grads"]:
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


def mesh_phase(dev, ds, ref, frames=24):
    """(j) LIO over a device mesh, on the first `frames` frames of the LIO
    dataset of path_phase at shipped capacities:
      - a world of one on NCCL in this process, with the map replicated
        and sharded: positions against the per-frame prefix (0 for the
        replicated map, <= 1 mm sharded), ms per frame, knn5_plane_tiled
        launches, collectives per frame and map bytes per rank;
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
            if (d != 0.0 if not sharded else d > 1e-3) or launches["knn5_plane_tiled"] < steady:
                raise AssertionError(f"{name}: difference {d} m, launches {launches}")
            paths[name] = (wall / len(outs), launches)
            extra[name] = {"max_diff_to_per_frame_mm": d * 1e3, "map_mb_per_rank": nb / 1e6,
                           "collectives_per_frame": n_coll / len(outs)}
            mesh_launches += launches["knn5_plane_tiled"]
            if sharded:
                halo_err = halo_check(pipe, mesh)
            del pipe
            torch.cuda.empty_cache()

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
        d = float(np.abs(r0["pos"] - np.array([o.pos for o in ref[:len(r0["pos"])]])).max())
        ms = 1e3 * r0["wall_s"] / len(r0["t"])
        print(f"{name}: {len(r0['t'])} frames, {ms:.2f} ms/frame, max position difference "
              f"to per-frame {d * 1e3:.4f} mm, knn5_plane_tiled per rank {k}, "
              f"{r0['collectives'] / len(r0['t']):.1f} collectives/frame, map "
              f"{r0['map_bytes'] / 1e6:.1f} MB per rank ({r0['pool_tiles']} tiles); {smi}")
        if len(r0["t"]) < frames or d > 1e-3 or min(k) == 0:
            raise AssertionError(f"{name}: {len(r0['t'])} frames, difference {d} m, "
                                 f"launches {k}")
        pools.append(r0["pool_tiles"])
        paths[name] = (ms, {"knn5_plane_tiled": sum(k)})
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


def livo_mesh_phase(dev, ds, ref, frames=24, duration=4.0):
    """(k) LIVO over a device mesh, on the first `frames` lidar frames of
    the LIVO dataset of livo_path_phase at shipped capacities (640x512,
    grid 40: G = 192 cells; a u8 pool of 256 images and 65536 x 20
    observation rings):
      - the single-device prefix on the same pushes (equal to the per-frame
        path's first frames), its photometric_err_H launches counted;
      - a world of one on NCCL in this process, with the map replicated
        and with the map sharded and the visual map in slabs: 0.0000 mm
        from the prefix, the same photometric_err_H launches, the visual
        map's MB on the rank and collectives per camera frame;
      - two ranks sharing the card under gloo: rank 0 within 2 mm of the
        prefix, photometric_err_H launched in every rank, equal visual-map
        points replicated and sharded, each rank's visual-map MB;
      - photometric_err_H's partials against their plain version on the
        arguments of the sharded world of one's last measurement: all G
        cells and rank 0's slab of a world of two (G/2), and no valid cell;
      - `run.main --synthetic --mesh 1 --sharded-map --map-pcd --save-ckpt`
        with the camera (one spawned NCCL rank): LIVO ATE < 6 cm, and its
        checkpoint loads into a single-device Pipeline with the whole pool
        and exactly the PCD's map points (the sharded map's gather).
    Returns ({path: (ms per lidar frame, launches)}, {path: its other
    numbers}, photometric_err_H's launches over the mesh runs, the
    partials' max_abs_err)."""
    import os
    import tempfile

    from fastlivo_tpu_torch import run
    from fastlivo_tpu_torch import vio as vio_mod
    from fastlivo_tpu_torch.config import Config
    from fastlivo_tpu_torch.io import checkpoint as ckpt
    from fastlivo_tpu_torch.ops import tiled_map as tm
    from fastlivo_tpu_torch.parallel.launch import launch
    from fastlivo_tpu_torch.pipeline import Pipeline

    smi = nvidia_smi_line()
    t_max = ref[frames].t
    paths, extra, mesh_launches = {}, {}, 0
    pipe = Pipeline(livo_config(), device=dev)
    push_all(pipe, ds, t_max=t_max)
    prefix, want, wall = counted_run(pipe.spin)
    d = max_diff(prefix, ref[:len(prefix)])
    n_cam, n_pts = pipe.vio.steps, int(pipe.vio.vmap.n_pts)
    print(f"livo prefix: {len(prefix)} lidar frames, {n_cam} camera steps, "
          f"{wall / len(prefix):.2f} ms/frame, {d * 1e3:.4f} mm from the per-frame path, "
          f"launches {want}, visual map {n_pts} points, {vmap_mb(pipe.vio):.1f} MB")
    if len(prefix) < frames or d != 0.0 or n_cam < 10 or want["photometric_err_H"] == 0:
        raise AssertionError(f"livo prefix: {len(prefix)} frames, {d} m, {n_cam} camera "
                             f"steps, launches {want}")
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
            if (d != 0.0 or launches["photometric_err_H"] != want["photometric_err_H"]
                    or int(v.vmap.n_pts) != n_pts):
                raise AssertionError(f"{name}: {d} m, launches {launches} vs {want}")
            paths[name] = (wall / len(outs), launches)
            extra[name] = {"max_diff_to_prefix_mm": d * 1e3, "vmap_mb_per_rank": vmap_mb(v),
                           "collectives_per_camera_frame": cam,
                           "collectives_per_lidar_frame": coll, "vmap_points": n_pts}
            mesh_launches += launches["photometric_err_H"]
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
        mb = [r[mode]["vmap_bytes"] / 1e6 for r in res]
        d = float(np.abs(r0["pos"] - np.array([o.pos for o in prefix[:len(r0["pos"])]])).max())
        ms = 1e3 * r0["wall_s"] / len(r0["t"])
        print(f"{name}: {len(r0['t'])} frames, {r0['vio_steps']} camera steps, {ms:.2f} ms/"
              f"frame, max position difference to the prefix {d * 1e3:.4f} mm, "
              f"photometric_err_H per rank {k}, visual map {r0['vmap_points']} points, "
              f"{mb} MB per rank, {r0['collectives'] / len(r0['t']):.1f} collectives per "
              f"lidar frame (the camera's included); {smi}")
        if len(r0["t"]) < frames or d > 2e-3 or min(k) == 0:
            raise AssertionError(f"{name}: {len(r0['t'])} frames, {d} m, launches {k}")
        pts.append([r[mode]["vmap_points"] for r in res])
        paths[name] = (ms, {"photometric_err_H": sum(k)})
        extra[name] = {"max_diff_to_prefix_mm": d * 1e3, "vmap_mb_per_rank": mb,
                       "photometric_err_H_per_rank": k, "vmap_points": r0["vmap_points"],
                       "collectives_per_lidar_frame": r0["collectives"] / len(r0["t"])}
        mesh_launches += sum(k)
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
        t0 = time.perf_counter()
        rc = run.main(["--config", cfg_yaml, "--camera", cam_yaml, "--synthetic",
                       "--duration", str(duration), "--mesh", "1", "--sharded-map",
                       "--out", out, "--map-pcd", pcd, "--save-ckpt", ck])
        wall = time.perf_counter() - t0
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
          f"points, pool {v.imgs.shape[0]} slots ({slots} filled); {smi}")
    if (rc != 0 or not ate < 0.06 or n_map != n_pcd or n_pcd == 0
            or v.imgs.shape[0] != Config().capacity.frame_ring or n_vis == 0 or slots == 0):
        raise AssertionError(f"run --mesh 1 LIVO: rc {rc}, ATE {ate}, map points "
                             f"{n_map} / {n_pcd}, {n_vis} visual-map points")
    name = "run --mesh 1 --sharded-map livo (spawn included; launches in the rank)"
    paths[name] = (1e3 * wall / len(traj), {})
    extra[name] = {"ate_mm": ate * 1e3, "poses": len(traj), "map_points": n_pcd,
                   "vmap_points": n_vis}
    return paths, extra, mesh_launches, err


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
    with phase("warm-up"):
        warmup_phase(dev)
    with phase("lio per-frame"):
        pipe, lio_launches, lio_outs, lio_ds, lio_ms = path_phase(dev)

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
    # standalone knn5_plane on the hash path's block; the maps' operations
    paths = {"lio per-frame": (lio_ms, lio_launches)}
    with phase("backends (a)-(f)"):
        backend_paths, path_extra, hash_pipe, backend_ckpts = backend_paths_phase(
            dev, lio_ds, lio_outs, lio_ms)
        paths.update(backend_paths)
        err_hash, ms, plain_ms, bound_ms, bound_by, cand_ms = hash_block_phase(hash_pipe, n, m)
        err = max(err, err_hash)
        del hash_pipe
        torch.cuda.empty_cache()
    with phase("map ops"):
        rebuild_ms, rebuild_occ = map_ops_phase(dev)
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
        (livo_launches, last_call, cam_fused, lid_fused, livo_outs, livo_ds,
         livo_ms) = livo_path_phase(dev)
    with phase("livo block replay"):
        livo_paths, livo_ckpt = livo_block_phase(dev, livo_ds, livo_outs, livo_ms)
    paths["livo per-frame"] = (livo_ms, livo_launches)
    paths.update(livo_paths)
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
    with phase("photometric kernel"):
        ph_err, ph_ms, ph_pair_ms, ph_plain_ms, ph_bound_ms, ph_bound_by = \
            photometric_phase(dev, last_call)
        del last_call
    print(f"camera frame median {cam_fused:.2f} ms, lidar frame median {lid_fused:.2f} ms; "
          f"{smi}")

    with phase("card vs cpu"):
        cpu_agreement(dev)
        livo_cpu_agreement(dev)
    with phase("profiles"):
        # the unfused runs only count kernels: 5 profiled frames each
        search_k = [profile_phase(dev, fused=False, duration=3.5),
                    profile_phase(dev, fused=True)]
        photo_k = [livo_profile_phase(dev, fused=False, duration=3.5),
                   livo_profile_phase(dev, fused=True)]
    print(f"device kernels under lio.search per steady lidar frame: unfused {search_k[0]:.1f}, "
          f"fused {search_k[1]:.1f}; under vio.photometric per camera frame: unfused "
          f"{photo_k[0]:.1f}, fused {photo_k[1]:.1f}")
    if not (search_k[1] < search_k[0] and photo_k[1] < photo_k[0]):
        raise AssertionError("the fused kernels did not cut the kernel counts")
    ck_keys = ("copy_ms", "write_ms", "disk_mb", "array_mb")
    print(json.dumps({"paths": {
        k: {"ms_per_frame_or_gap_median": v[0],
            "gap_p90": v[1] if k.startswith("serve") else None,
            "launches": v[-1], **path_extra.get(k, {})} for k, v in paths.items()},
        "livo_checkpoint": dict(zip(ck_keys, livo_ckpt)),
        **{f"lio_{k}_checkpoint": dict(zip(ck_keys, v)) for k, v in backend_ckpts.items()},
        "hash_rebuild": {"ms": rebuild_ms, "occupancy": rebuild_occ},
        "hash_block_knn_candidates_ms": cand_ms,
        "native": native_nums,
        "phase_seconds": seconds,
        "nvidia_smi": smi}))

    print(json.dumps({"kernels": [{
        "name": "knn5_plane_tiled", "route": "cuda",
        "source": "fastlivo_tpu_torch/csrc/knn5_plane_tiled.cu",
        "replaces": "fastlivo_tpu/ops/pallas_lio.py:219",
        "launches": lio_launches["knn5_plane_tiled"], "max_abs_err": tiled_err,
        "ms": t_ms, "plain_ms": t_plain_ms, "bound_ms": t_bound_ms,
        "bound_by": t_bound_by, "library_ms": None, "mesh_launches": mesh_launches,
    }, {
        "name": "photometric_err_H", "route": "cuda",
        "source": "fastlivo_tpu_torch/csrc/photometric_err_H.cu",
        "replaces": "fastlivo_tpu/ops/pallas_image.py:180",
        "launches": livo_launches["photometric_err_H"],
        "max_abs_err": max(ph_err, partials_err),
        "ms": ph_ms, "plain_ms": ph_plain_ms, "bound_ms": ph_bound_ms,
        "bound_by": ph_bound_by, "library_ms": None, "mesh_launches": ph_mesh_launches,
    }, {
        "name": "knn5_plane", "route": "cuda",
        "source": "fastlivo_tpu_torch/csrc/knn5_plane.cu",
        "replaces": "fastlivo_tpu/ops/pallas_lio.py:219",
        "launches": backend_paths["hash"][1]["knn5_plane"], "max_abs_err": err, "ms": ms,
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
