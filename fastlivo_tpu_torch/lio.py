"""LIO iterated error-state Kalman update — the LiDAR half of the product.

Port of the JAX package's lio.py (the reference's iterated-EKF loop,
src/laserMapping.cpp:1506-1732). The per-point loop (kNN search -> plane
fit -> gating -> H row) is batched masked tensor math over a padded
point set; the iteration protocol is the reference's
`nearest_search_en` / `rematch_num` / `EKF_stop_flg` state machine:

  - iterations run for iterCount = -1 .. max_iter-1 (:1506);
  - the map search runs on the first iteration and on up to two
    "rematch" iterations triggered by convergence or the antepenultimate
    iteration (:1700-1705);
  - selection shrinks monotonically between searches (:1569-1585);
  - the Kalman step is prior-anchored:
    solution = K_1[:, :6] Hᵀz + vec - G vec[:6] (:1663-1683);
  - on stop, P <- (I - G) P (:1712).

The JAX package runs the loop as a `lax.while_loop`. On one CUDA device,
on any map (tiled, hash or dense) with the TLS fit and no `cache_knn`
(`Config()`'s default), so does the port: one cooperative launch of
ops/lio_cascade.lio_cascade runs every iteration's search, gates, rows
and step on the card and reads nothing back. Everywhere else (the CPU, a
mesh, `cache_knn`, `plane_fit: ref`) the loop is the host loop
`lio_loop`, which reads the convergence flag once per iteration (at most
max_iter + 1 reads), so `iters` is the JAX package's exactly; it is also
the plain version the cascade is bit-equal to when it runs the step
kernel. The loop's search computes the JAX package's
`pallas_knn=True` branch (the map's knn_candidates, then the Pallas
knn5_plane), by map backend and option:
  - no cache, any backend: one kernel (ops/knn_plane.knn5_plane_search:
    knn5_plane_tiled on the tiled map, knn5_plane_hashed on the hash or
    dense map), the map's neighbourhood gather (the tiles, the hash
    probes or the dense grid's computed cells) fused into the 5-NN
    selection and fit;
  - `cache_knn`, any backend: the candidate block gathered once at the
    prior pose (the backend's knn_candidates), then the knn5_plane kernel
    on that block against the moved queries at every search;
  - `plane_fit: ref`: the backend's knn (or the re-rank of the cached
    block), then plane.fit_plane_ref, in torch ops (no kernel fits the
    reference's plane; the JAX package runs no Pallas kernel there).
Both routes take the world points, the plane distances and the H rows as
explicit 3-term sums and [HᵀH₆ | Hᵀz] in one fixed order
(ops/lio_cascade.fixed_order_sum), so that the cascade and the loop round
alike.

Numerics: the residual batch is float32; the 18-dim gain and state
update are float64, with the exact f64 gain (the step of
ops/photometric.photometric_step, fed -Hᵀz).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from .ops import dense_map as dm
from .ops import plane as plane_ops
from .ops import tiled_map as tm
from .ops import voxel_map as vm
from .ops.knn_plane import knn5_plane, knn5_plane_search
from .ops.lio_cascade import fixed_order_sum, lio_cascade
from .ops.photometric import _rows_times, photometric_step
from .state import NavState

BACKENDS = {"tiled": tm, "dense": dm, "hash": vm}  # capacity.map_backend

SQ_DIST_GATE = 5.0  # 5th-NN squared-distance gate (laserMapping.cpp:1549)
RES_GATE = 2.0  # |residual| gate at compaction (:1600)
S_GATE = 0.9  # plane-quality score gate (:1576-1578)
PLANE_THRESH = 0.1  # esti_plane threshold (:1571)
CONV_ROT_DEG = 0.01  # convergence: |dR|*57.3 < 0.01 deg (:1688)
CONV_POS_CM = 0.015  # convergence: |dt|*100 < 0.015 cm (:1688)
GATES = (SQ_DIST_GATE, S_GATE, RES_GATE)  # as ops/lio_cascade.lio_cascade takes them
CONV = (CONV_ROT_DEG, CONV_POS_CM)


class LioResult(NamedTuple):
    state: NavState  # posterior state (cov updated)
    pts_world: torch.Tensor  # (N, 3) scan in world frame at the posterior
    active: torch.Tensor  # (N,) bool: points that fed the final update
    res: torch.Tensor  # (N,) |point-to-plane| residual at the posterior
    n_active: torch.Tensor  # () int32
    iters: int | torch.Tensor  # iterations executed (a device int32 from the cascade)


def map_module(m):
    """The backend module of a map value."""
    for mod, cls in ((tm, tm.TiledMap), (dm, dm.DenseMap), (vm, vm.VoxelMap)):
        if isinstance(m, cls):
            return mod
    raise TypeError(f"not a map: {type(m).__name__}")


def check_supported(map_backend: str = "tiled", plane_fit: str = "tls"):
    """Raise ValueError for a map backend or plane fit that does not exist
    (the JAX package refuses both names at config load)."""
    if map_backend not in BACKENDS:
        raise ValueError(f"map_backend={map_backend!r}: must be one of "
                         f"{tuple(BACKENDS)}")
    if plane_fit not in ("tls", "ref"):
        raise ValueError(f"plane_fit={plane_fit!r}: must be 'tls' or 'ref'")


def cascade_applies(m, device, plane_fit: str = "tls", cache_knn: bool = False,
                    mesh=None) -> bool:
    """Whether lio_update runs its iterations as one lio_cascade launch:
    on one CUDA device (no mesh), on the tiled, hash or dense map, with the
    TLS fit and without `cache_knn`. Everywhere else it runs `lio_loop`."""
    return (mesh is None and torch.device(device).type == "cuda"
            and isinstance(m, (tm.TiledMap, vm.VoxelMap, dm.DenseMap))
            and plane_fit == "tls" and not cache_knn)


def world_points(p_imu: torch.Tensor, rot: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The scan (N, 3) in the world frame at the pose (rot (3, 3), pos (3,),
    f64, cast down to the batch's f32): p rot32ᵀ + pos32 as three products
    summed left to right per row, the cascade kernel's order (a matmul's is
    the BLAS's own)."""
    dtype = p_imu.dtype
    return _rows_times(p_imu, rot.to(dtype)) + pos.to(dtype)


def plane_distance(pabcd: torch.Tensor, pw: torch.Tensor) -> torch.Tensor:
    """plane.point_to_plane with its sum written out: ((a x + b y) + c z) + d."""
    return ((pabcd[:, 0] * pw[:, 0] + pabcd[:, 1] * pw[:, 1])
            + pabcd[:, 2] * pw[:, 2]) + pabcd[:, 3]


def gate_rows(p_imu, bns, pw, rot, pabcd, plane_ok, sel):
    """One iteration's gates and measurement (laserMapping.cpp:1549-1629):
    sel narrowed by plane_ok and the s score, the active rows, and
    [HᵀH₆ | Hᵀz] (6, 7) f32 from the H rows [p_imu × Rᵀn, n], z = -pd2, as
    the per-row products summed by `fixed_order_sum` (the cascade kernel's
    order; each product and sum one torch op, so nothing is contracted).
    Returns (sel, HT)."""
    dtype = pw.dtype
    pd2 = plane_distance(pabcd, pw)
    s = 1.0 - 0.9 * torch.abs(pd2) / bns
    sel = sel & plane_ok & (s > S_GATE)
    active = sel & (torch.abs(pd2) <= RES_GATE)
    n_vec = pabcd[:, :3]
    v = _rows_times(n_vec, rot.to(dtype).T)  # (Rᵀ n)ᵀ rows
    h = torch.stack([  # skew(p)·v = p × v
        p_imu[:, 1] * v[:, 2] - p_imu[:, 2] * v[:, 1],
        p_imu[:, 2] * v[:, 0] - p_imu[:, 0] * v[:, 2],
        p_imu[:, 0] * v[:, 1] - p_imu[:, 1] * v[:, 0],
        n_vec[:, 0], n_vec[:, 1], n_vec[:, 2]], dim=-1)
    hw = h * active.to(dtype)[:, None]
    rhs = torch.cat([h, -pd2[:, None]], dim=-1)
    HT = fixed_order_sum((hw[:, :, None] * rhs[:, None, :]).reshape(-1, 42))
    return sel, HT.view(6, 7)


def lio_update(
    state: NavState,  # propagated prior (its cov is the prior covariance)
    m,  # tiled_map.TiledMap | dense_map.DenseMap | voxel_map.VoxelMap
    pts_body: torch.Tensor,  # (N, 3) downsampled, undistorted scan (lidar frame)
    pmask: torch.Tensor,  # (N,) bool validity
    lid_rot: torch.Tensor,  # (3, 3) lidar -> IMU rotation
    lid_off: torch.Tensor,  # (3,) lidar origin in IMU frame
    laser_point_cov: float,
    max_iter: int = 4,
    knn_radius: int = 1,
    plane_fit: str = "tls",
    cache_knn: bool = False,
    max_probe: int = 12,
    mesh=None,
) -> LioResult:
    """One scan's iterated point-to-plane EKF update
    (laserMapping.cpp:1506-1732). `max_probe`: the hash map's probe
    depth (the other maps ignore it). `mesh` (parallel.sharded.Mesh):
    the batch is this rank's rows; the [HᵀH | Hᵀz] partials and the
    active count are reduced over the mesh, so `state`, `n_active` and
    `iters` are the same on every rank (JAX's `axis_name`).

    On one CUDA device, on any map with the TLS fit and no `cache_knn`,
    the iterations are one launch of ops/lio_cascade.lio_cascade (the JAX
    package's while_loop: search, gates, rows and f64 step on the card,
    nothing read back) and `iters` is a device int32; otherwise (the CPU,
    a mesh, `cache_knn`, `plane_fit: ref`) they are the host loop
    `lio_loop` and `iters` a host int. The covariance, the posterior cloud and the final
    gate are the same torch ops after either."""
    check_supported(plane_fit=plane_fit)
    mod = map_module(m)
    f64 = torch.float64
    prior = state

    p_imu = pts_body @ lid_rot.T + lid_off  # (N, 3) in IMU frame
    # |p|^(1/2) for the s score (:1575)
    body_norm_sqrt = torch.sqrt(torch.sqrt(torch.sum(pts_body * pts_body, dim=-1)))
    # loop-invariant f64 prior terms
    P = prior.cov.to(f64) / laser_point_cov
    prior_x = torch.cat([prior.pos, prior.vel, prior.bg, prior.ba, prior.grav])
    prior_rot = prior.rot.contiguous()

    if cascade_applies(m, p_imu.device, plane_fit, cache_knn, mesh):
        rot, x, G, sel, pabcd, plane_ok, iters = lio_cascade(
            m, p_imu, body_norm_sqrt, pmask.contiguous(), prior_rot, prior_x, prior_rot,
            prior_x, P, max_iter, knn_radius, PLANE_THRESH, GATES, CONV, max_probe)
    else:
        if cache_knn:
            # the candidate block gathered ONCE, at the prior pose; every
            # search re-ranks it against the moved queries (a deviation from
            # the reference's full re-search, laserMapping.cpp:1543, that the
            # JAX package offers as an option)
            with record_function("lio.search"):
                cand0, found0 = mod.knn_candidates(
                    m, world_points(p_imu, prior.rot, prior.pos), knn_radius, max_probe)

        def search(pw):
            """(pabcd, plane_ok, nd2_5: the fifth-nearest squared distance)."""
            if plane_fit == "ref":
                if cache_knn:
                    neigh, nd2, _ = vm.topk_from_candidates(cand0, found0, pw, 5)
                else:
                    neigh, nd2, _ = mod.knn(m, pw, 5, knn_radius, max_probe)
                pabcd, ok = plane_ops.fit_plane_ref(neigh, threshold=PLANE_THRESH)
                return pabcd, ok, nd2[:, -1]
            if cache_knn:
                return knn5_plane(cand0, found0, pw, PLANE_THRESH)
            return knn5_plane_search(m, pw, knn_radius, PLANE_THRESH, max_probe)

        rot, x, G, sel, pabcd, plane_ok, iters = lio_loop(
            search, p_imu, body_norm_sqrt, pmask, prior_rot, prior_x, prior_rot, prior_x, P,
            max_iter, mesh)

    pos, vel, bg, ba, grav = x[0:3], x[3:6], x[6:9], x[9:12], x[12:15]
    # covariance update at stop: P <- (I - [G|0]) P (:1712), with
    # G = K·HᵀH of the final iteration
    cov = prior.cov - G @ prior.cov[0:6, :]
    post = NavState(rot, pos, vel, bg, ba, grav, cov)

    pw = world_points(p_imu, rot, pos)
    pd2 = plane_distance(pabcd, pw)
    s = 1.0 - 0.9 * torch.abs(pd2) / body_norm_sqrt
    active = sel & plane_ok & (s > S_GATE) & (torch.abs(pd2) <= RES_GATE)
    n_act = active.sum(dtype=torch.int32)
    if mesh is not None:
        n_act = mesh.all_reduce(n_act)
    return LioResult(
        state=post,
        pts_world=pw,
        active=active,
        res=torch.abs(pd2),
        n_active=n_act,
        iters=iters,
    )


def lio_loop(search, p_imu, bns, pmask, rot, x, prior_rot, prior_x, P_, max_iter: int,
             mesh=None):
    """The iterations as a host loop (ops/lio_cascade.lio_cascade's
    outputs, `iters` a host int): the CPU's path, the mesh's, the
    options' (`cache_knn`, `plane_fit: ref`), and the plain version the
    card's cascade is held
    against. `search(pw)` gives (pabcd, plane_ok, nd2_5) for the scan at
    the world points pw. Each iteration: the search when search_en (one
    kernel launch on the card), `gate_rows`, and the prior-anchored step
    `photometric_step` fed -Hᵀz with the LIO thresholds (the step kernel on
    the card, `photometric_step_plain` on the CPU), then one host read of
    the convergence flag (at most max_iter + 1 reads), so `iters` is the
    JAX package's exactly. Returns (rot, x, G = K·HᵀH₆ of the last
    iteration, sel, pabcd, plane_ok, iters)."""
    it = -1
    search_en = True
    rematch = 0
    stop = False
    sel = pabcd = plane_ok = G = None
    while not stop:
        pw = world_points(p_imu, rot, x[0:3])
        if search_en:
            with record_function("lio.search"):
                pabcd, plane_ok, nd2_5 = search(pw)
                sel = (nd2_5 <= SQ_DIST_GATE) & pmask
        sel, HT = gate_rows(p_imu, bns, pw, rot, pabcd, plane_ok, sel)
        if mesh is not None:
            HT = mesh.psum(HT)
        # sol = vec + K (Hᵀz - HᵀH₆ vec₆) is the photometric step's
        # vec - K (z + HᵀH₆ vec₆) at z = -Hᵀz, bit for bit
        HT = torch.cat([HT[:, 0:6], -HT[:, 6:7]], dim=1)
        rot, x, conv, G = photometric_step(rot, x, prior_rot, prior_x, P_, HT, CONV)
        conv = bool(conv)
        do_rematch = conv or (rematch == 0 and it == max_iter - 2)
        rematch += int(do_rematch)
        stop = rematch >= 2 or it == max_iter - 1
        search_en = do_rematch
        it += 1
    return rot, x, G, sel, pabcd, plane_ok, it + 1


class LocalMapTracker:
    """Host-side sliding local-map bookkeeping (lasermap_fov_segment,
    laserMapping.cpp:363-421). Tracks the axis-aligned local cube and
    emits world-frame delete boxes when the sensor nears an edge; the
    deletion itself is the map backend's device-side `delete_boxes`.

    Reproduced reference quirk: with cube_side_length far below
    2*MOV_THRESHOLD*DET_RANGE = 900 m, need_move fires every frame, the
    window slides mov_dist=150 m per frame in every near-edge axis and
    runs away from the trajectory within a few frames — after which the
    emitted boxes contain no points and the map never slides. Configs
    meant to bound the map need cube_side_length > 900 m (or
    `mode="clamped"`)."""

    DET_RANGE = 300.0  # laserMapping.cpp:83
    MOV_THRESHOLD = 1.5  # :90

    def __init__(self, cube_len: float, mode: str = "ref"):
        """`mode`: "ref" reproduces lasermap_fov_segment verbatim;
        "clamped" (`capacity.slider: clamped`) re-centres the window on
        the sensor whenever it nears an edge, emitting the vacated slabs
        as delete boxes, so the map stays bounded for any cube size."""
        self.cube_len = float(cube_len)
        self.mode = mode
        self.initialized = False
        self.vmin = [0.0, 0.0, 0.0]
        self.vmax = [0.0, 0.0, 0.0]

    def update(self, pos):
        """pos: length-3 sensor position. Returns list of (lo, hi) boxes
        to delete (possibly empty)."""
        pos = [float(p) for p in pos]
        if not self.initialized:
            half = self.cube_len / 2.0
            self.vmin = [p - half for p in pos]
            self.vmax = [p + half for p in pos]
            self.initialized = True
            return []
        if self.mode == "clamped":
            return self._update_clamped(pos)
        thr = self.MOV_THRESHOLD * self.DET_RANGE
        d_lo = [abs(pos[i] - self.vmin[i]) for i in range(3)]
        d_hi = [abs(pos[i] - self.vmax[i]) for i in range(3)]
        if not any(d_lo[i] <= thr or d_hi[i] <= thr for i in range(3)):
            return []
        mov = max((self.cube_len - 2.0 * thr) * 0.5 * 0.9,
                  self.DET_RANGE * (self.MOV_THRESHOLD - 1.0))
        boxes = []
        nmin, nmax = list(self.vmin), list(self.vmax)
        for i in range(3):
            if d_lo[i] <= thr:
                nmin[i] -= mov
                nmax[i] -= mov
                lo, hi = list(self.vmin), list(self.vmax)
                lo[i] = self.vmax[i] - mov
                boxes.append((lo, hi))
            elif d_hi[i] <= thr:
                nmin[i] += mov
                nmax[i] += mov
                lo, hi = list(self.vmin), list(self.vmax)
                hi[i] = self.vmin[i] + mov
                boxes.append((lo, hi))
        self.vmin, self.vmax = nmin, nmax
        return boxes

    def _update_clamped(self, pos):
        """Re-centring slider: when the sensor is within a quarter cube
        of an edge, shift the window so the sensor is centred again and
        emit the vacated slab per moved axis."""
        thr = 0.25 * self.cube_len
        boxes = []
        nmin, nmax = list(self.vmin), list(self.vmax)
        for i in range(3):
            center = 0.5 * (self.vmin[i] + self.vmax[i])
            shift = pos[i] - center
            near_edge = (pos[i] - self.vmin[i] <= thr
                         or self.vmax[i] - pos[i] <= thr)
            if not near_edge or shift == 0.0:
                continue
            nmin[i] += shift
            nmax[i] += shift
            lo, hi = list(self.vmin), list(self.vmax)
            if shift > 0:
                hi[i] = self.vmin[i] + shift  # vacated low slab
            else:
                lo[i] = self.vmax[i] + shift  # vacated high slab
            boxes.append((lo, hi))
        self.vmin, self.vmax = nmin, nmax
        return boxes
