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

The JAX package runs the loop as a `lax.while_loop`; here it is a host
loop that reads the convergence flag once per iteration (at most
max_iter + 1 reads), so `iters` is the JAX package's exactly. The search
follows the JAX package's `pallas_knn=True` branch (the map's
knn_candidates, then the Pallas knn5_plane), by map backend and option:
  - tiled map, no cache: one kernel (ops/knn_plane.knn5_plane_tiled),
    the neighbourhood gather fused into the 5-NN selection and fit;
  - hash or dense map, no cache: the backend's knn_candidates, then the
    knn5_plane kernel;
  - `cache_knn`, any backend: the candidate block gathered once at the
    prior pose, then the knn5_plane kernel on that block against the
    moved queries at every search;
  - `plane_fit: ref`: the backend's knn (or the re-rank of the cached
    block), then plane.fit_plane_ref, in torch ops (no kernel fits the
    reference's plane; the JAX package runs no Pallas kernel there).

Numerics: the residual batch is float32; the 18-dim gain and state
update are float64, with the exact f64 gain (ops/linalg.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from .ops import dense_map as dm
from .ops import linalg as linalg_ops
from .ops import plane as plane_ops
from .ops import so3
from .ops import tiled_map as tm
from .ops import voxel_map as vm
from .ops.knn_plane import knn5_plane, knn5_plane_tiled
from .state import NavState

BACKENDS = {"tiled": tm, "dense": dm, "hash": vm}  # capacity.map_backend

SQ_DIST_GATE = 5.0  # 5th-NN squared-distance gate (laserMapping.cpp:1549)
RES_GATE = 2.0  # |residual| gate at compaction (:1600)
S_GATE = 0.9  # plane-quality score gate (:1576-1578)
PLANE_THRESH = 0.1  # esti_plane threshold (:1571)
CONV_ROT_DEG = 0.01  # convergence: |dR|*57.3 < 0.01 deg (:1688)
CONV_POS_CM = 0.015  # convergence: |dt|*100 < 0.015 cm (:1688)


class LioResult(NamedTuple):
    state: NavState  # posterior state (cov updated)
    pts_world: torch.Tensor  # (N, 3) scan in world frame at the posterior
    active: torch.Tensor  # (N,) bool: points that fed the final update
    res: torch.Tensor  # (N,) |point-to-plane| residual at the posterior
    n_active: torch.Tensor  # () int32
    iters: int  # iterations executed


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
    `iters` are the same on every rank (JAX's `axis_name`)."""
    check_supported(plane_fit=plane_fit)
    mod = map_module(m)
    dtype = pts_body.dtype
    f64 = torch.float64
    prior = state

    p_imu = pts_body @ lid_rot.T + lid_off  # (N, 3) in IMU frame
    # |p|^(1/2) for the s score (:1575)
    body_norm_sqrt = torch.sqrt(torch.sqrt(torch.sum(pts_body * pts_body, dim=-1)))

    def world_pts(rot, pos):
        # point batch stays f32; the f64 pose casts down at the boundary
        return p_imu @ rot.to(dtype).T + pos.to(dtype)

    if cache_knn:
        # the candidate block gathered ONCE, at the prior pose; every
        # search re-ranks it against the moved queries (a deviation from
        # the reference's full re-search, laserMapping.cpp:1543, that the
        # JAX package offers as an option)
        with record_function("lio.search"):
            cand0, found0 = mod.knn_candidates(
                m, world_pts(prior.rot, prior.pos), knn_radius, max_probe)

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
        if mod is tm:
            return knn5_plane_tiled(m, pw, knn_radius, PLANE_THRESH)
        return knn5_plane(*mod.knn_candidates(m, pw, knn_radius, max_probe), pw,
                          PLANE_THRESH)

    # loop-invariant f64 prior terms
    P = prior.cov.to(f64) / laser_point_cov
    prior_x = torch.cat([prior.pos, prior.vel, prior.bg, prior.ba, prior.grav])

    rot = state.rot
    x = prior_x.clone()
    it = -1
    search_en = True
    rematch = 0
    stop = False
    sel = pabcd = plane_ok = HTH6 = None
    while not stop:
        pos = x[0:3]
        pw = world_pts(rot, pos)
        if search_en:
            with record_function("lio.search"):
                pabcd, plane_ok, nd2_5 = search(pw)
                sel = (nd2_5 <= SQ_DIST_GATE) & pmask

        pd2 = plane_ops.point_to_plane(pabcd, pw)  # (N,)
        s = 1.0 - 0.9 * torch.abs(pd2) / body_norm_sqrt
        sel = sel & plane_ok & (s > S_GATE)
        active = sel & (torch.abs(pd2) <= RES_GATE)

        # H rows: [(skew(p_imu) Rᵀ n), n], z = -pd2 (:1607-1629)
        n_vec = pabcd[:, :3]
        Rt_n = n_vec @ rot.to(dtype)  # (N, 3) = (Rᵀ n)ᵀ rows
        A = torch.linalg.cross(p_imu, Rt_n)  # skew(p)·v = p × v
        h = torch.cat([A, n_vec], dim=-1)  # (N, 6)
        hw = h * active.to(dtype)[:, None]
        # [HᵀH₆ | Hᵀz] in one (6, 7) product
        HT = hw.T @ torch.cat([h, -pd2[:, None]], dim=-1)
        if mesh is not None:
            HT = mesh.psum(HT)
        HTH6 = HT[:, 0:6].to(f64)
        HTz = HT[:, 6].to(f64)

        K16 = linalg_ops.kalman_gain6_f64(P, HTH6)  # (18, 6)
        vec = torch.cat([so3.log(rot.T @ prior.rot), prior_x - x])
        sol = vec + K16 @ (HTz - HTH6 @ vec[0:6])

        rot = rot @ so3.exp(sol[0:3])
        x = x + sol[3:18]

        conv = bool(
            (torch.linalg.norm(sol[0:3]) * 57.3 < CONV_ROT_DEG)
            & (torch.linalg.norm(sol[3:6]) * 100.0 < CONV_POS_CM))
        do_rematch = conv or (rematch == 0 and it == max_iter - 2)
        rematch += int(do_rematch)
        stop = rematch >= 2 or it == max_iter - 1
        search_en = do_rematch
        it += 1

    pos, vel, bg, ba, grav = x[0:3], x[3:6], x[6:9], x[9:12], x[12:15]
    # covariance update at stop: P <- (I - [G|0]) P (:1712), with
    # G = K·HᵀH of the final iteration
    G = linalg_ops.kalman_gain6_f64(P, HTH6) @ HTH6
    cov = prior.cov - G @ prior.cov[0:6, :]
    post = NavState(rot, pos, vel, bg, ba, grav, cov)

    pw = world_pts(rot, pos)
    pd2 = plane_ops.point_to_plane(pabcd, pw)
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
        iters=it + 1,
    )


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
