"""Residual rows over a device mesh: the mesh, its collectives, the
sharded LIO update and scan step, and the sharded photometric update.

Port of the JAX package's parallel/sharded.py. JAX's `shard_map` is one
process driving N devices; here the mesh is SPMD over processes, one rank
per device (`torch.distributed`, NCCL on cards, gloo on the CPU). Every
rank runs the replicated host logic on identical inputs; the point batch
is row-partitioned, rank r taking rows [r·N/n, (r+1)·N/n):

  - each rank searches the map, fits planes and builds its H rows;
  - the (6, 7) [HᵀH | Hᵀz] partials are all-gathered and summed in rank
    order on every rank (`Mesh.psum`), so every rank holds the same bits
    whatever the backend's all-reduce would do. The host-loop EKF
    (`lio.lio_update`) reads its convergence flag from that sum, so one
    ulp of difference could send one rank round the loop once more, into
    a collective the others never call;
  - every rank runs the identical 18x18 solve, so the ranks stay in
    lockstep without broadcasts;
  - the map stays replicated: the world points are all-gathered and each
    rank applies the identical insert. `sharded_map.py` block-partitions
    the tiled map instead.

The collectives of JAX's shard_map body map to `Mesh` methods:
psum of floats -> `psum` (all-gather + rank-order sum), psum / pmin /
pmax of ints or exact values -> `all_reduce`, tiled all_gather ->
`all_gather` (concatenated in rank order), axis_index -> `rank`. Under
gloo with CUDA tensors (two ranks sharing one card, which NCCL refuses)
the tensors go through the host.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .. import imu as imu_mod
from .. import lio as lio_mod
from .. import vio as vio_mod
from ..device import resolve_device
from ..state import NavState

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


class Mesh:
    """One rank's view of a 1-D device mesh over the default process
    group: its rank, size and device. `collectives` counts the collective
    calls this rank made."""

    def __init__(self, rank: int, size: int, device: torch.device):
        self.rank = rank
        self.size = size
        self.device = device
        backend = dist.get_backend()
        if backend == "nccl" and device.type != "cuda":
            raise ValueError(f"an NCCL mesh needs CUDA devices, not {device}")
        # gloo takes CPU tensors only: stage CUDA tensors through the host
        self.stage = backend == "gloo" and device.type == "cuda"
        self.collectives = 0

    def __repr__(self):
        return f"Mesh(rank={self.rank}, size={self.size}, device={self.device})"

    def rows(self, n: int) -> slice:
        """This rank's slice of an n-row batch (n divisible by the size)."""
        if n % self.size:
            raise ValueError(f"{n} rows are not divisible by the mesh size {self.size}")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def slab(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of `t` zero-padded to a multiple of the mesh
        size: rows [rank·L, (rank+1)·L), L = ceil(rows / size), as the JAX
        package pads a batch before its dynamic slice."""
        L = -(-t.shape[0] // self.size)
        pad = L * self.size - t.shape[0]
        if pad:
            t = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
        return t[self.rank * L:(self.rank + 1) * L]

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if t.dtype == torch.bool:
            t = t.to(torch.uint8)  # not every backend reduces or gathers bool
        return t.cpu() if self.stage else t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' tensors (equal shapes) concatenated along dim 0 in
        rank order (JAX's all_gather(tiled=True))."""
        return torch.cat(self._gather(t)).to(t.device, t.dtype)

    def _gather(self, t: torch.Tensor) -> list:
        w = self._wire(t)
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w)
        self.collectives += 1
        return parts

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Float partial sums reduced in rank order, the same bits on
        every rank."""
        parts = self._gather(t)
        acc = parts[0].clone()
        for p in parts[1:]:
            acc += p
        return acc.to(t.device)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Integer sums, or min / max (exact in any order); a new tensor."""
        w = self._wire(t).clone()
        dist.all_reduce(w, op=_OPS[op])
        self.collectives += 1
        return w.to(t.device, t.dtype)

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Tensors with a different number of rows on each rank,
        concatenated in rank order (padded to the longest for the
        gather)."""
        n = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
        counts = self.all_gather(n).tolist()
        if max(counts) == 0:
            return t
        pad = t.new_zeros((max(counts),) + tuple(t.shape[1:]))
        pad[:t.shape[0]] = t
        parts = self.all_gather(pad).split(max(counts))
        return torch.cat([p[:c] for p, c in zip(parts, counts)])


def make_mesh(n: int | None = None, device=None) -> Mesh:
    """This rank's mesh over an initialised process group (see
    parallel/launch.py). `n`, if given, must be the world size. `device`:
    where this rank's tensors live; by default `cuda:<rank>`, which must
    exist. NCCL needs one card per rank; two ranks may share a card under
    gloo (device "cuda:0")."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group (start the ranks with "
                           "parallel.launch.launch or init_process_group)")
    size = dist.get_world_size()
    rank = dist.get_rank()
    if n is not None and n != size:
        raise ValueError(f"a mesh of {n} in a world of {size} ranks")
    if device is None:
        if not torch.cuda.is_available() or rank >= torch.cuda.device_count():
            raise ValueError(f"rank {rank} has no card: "
                             f"{torch.cuda.device_count()} visible; pass device='cpu'")
        device = f"cuda:{rank}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    return Mesh(rank, size, dev)


def sharded_lio_update(
    mesh: Mesh,
    state: NavState,
    m,
    pts_body: torch.Tensor,  # (N, 3) replicated; N divisible by the mesh size
    pmask: torch.Tensor,
    lid_rot: torch.Tensor,
    lid_off: torch.Tensor,
    laser_point_cov: float,
    max_iter: int = 4,
    knn_radius: int = 2,
    max_probe: int = 12,
    plane_fit: str = "tls",
) -> lio_mod.LioResult:
    """`lio.lio_update` with this rank's rows of the point batch.

    Returns the same LioResult on every rank: state, n_active and iters
    are replicated; pts_world, active and res are all-gathered back to
    the full (N,) batch (JAX returns them row-sharded)."""
    rows = mesh.rows(pts_body.shape[0])
    res = lio_mod.lio_update(
        state, m, pts_body[rows], pmask[rows], lid_rot, lid_off,
        laser_point_cov=laser_point_cov, max_iter=max_iter,
        knn_radius=knn_radius, max_probe=max_probe, plane_fit=plane_fit,
        mesh=mesh,
    )
    return res._replace(pts_world=mesh.all_gather(res.pts_world),
                        active=mesh.all_gather(res.active),
                        res=mesh.all_gather(res.res))


def sharded_scan_step(
    mesh: Mesh,
    state: NavState,
    m,  # any map backend, replicated; updated IN PLACE by the insert
    # propagation inputs (replicated: the IMU recursion is sequential)
    acc_avg, gyr_avg, dt, offs, pair_valid, tail_dt, acc_s_last, angvel_last,
    calib: imu_mod.ImuCalib,
    # the scan (replicated; each rank takes its rows)
    pts_body, t_rel, pmask,
    laser_point_cov: float,
    max_iter: int = 4,
    knn_radius: int = 1,
    max_probe: int = 8,
    plane_fit: str = "tls",
):
    """The per-scan step over the mesh: IMU propagation (replicated) ->
    undistortion (this rank's rows) -> iterated EKF (rows, rank-order
    reductions) -> map insertion (all-gathered world points, the same
    insert on every rank; the hash map inserts at the search's probe
    depth). Returns (state', map', n_active, acc_s_last', angvel_last')."""
    st, pose, acc_l, ang_l = imu_mod.propagate(
        state, acc_avg, gyr_avg, dt, offs, pair_valid, tail_dt,
        acc_s_last, angvel_last, calib,
    )
    rows = mesh.rows(pts_body.shape[0])
    und = imu_mod.undistort(st, pose, pts_body[rows], t_rel[rows], pmask[rows], calib)
    res = lio_mod.lio_update(
        st, m, und, pmask[rows], calib.lid_rot, calib.lid_off,
        laser_point_cov=laser_point_cov, max_iter=max_iter,
        knn_radius=knn_radius, max_probe=max_probe, plane_fit=plane_fit,
        mesh=mesh,
    )
    world = mesh.all_gather(res.pts_world)
    wmask = mesh.all_gather(pmask[rows])
    m2 = lio_mod.map_module(m).insert(m, world, wmask, max_probe)
    return res.state, m2, res.n_active, acc_l, ang_l


def sharded_photometric_update(
    mesh: Mesh,
    state: NavState,
    prior: NavState,
    cam,
    img: torch.Tensor,
    tr_pos: torch.Tensor,  # (G, 3), replicated; each rank takes its cell slab
    tr_patch: torch.Tensor,  # (G, 3, P, P)
    tr_slevel: torch.Tensor,  # (G,)
    tr_valid: torch.Tensor,  # (G,)
    Rci, Pci, Jdphi_dR, Jdp_dR,
    img_point_cov: float,
    patch_size: int,
    level: int,
    max_iter: int,
    robust: str = "none",
):
    """`vio.photometric_update` with this rank's slab of the tracked set
    (zero-padded to a multiple of the mesh size), the image and the
    state replicated; the partials are summed in rank order each
    iteration, so the ranks iterate in lockstep. Returns the same tuple
    on every rank: (state, G (18, 6), per-point errors all-gathered to
    the whole (G,) set, mean error, iterations); JAX returns the errors
    row-sharded."""
    st, Gmat, perr, err, its = vio_mod.photometric_update(
        state, prior, cam, img, mesh.slab(tr_pos), mesh.slab(tr_patch),
        mesh.slab(tr_slevel), mesh.slab(tr_valid), Rci, Pci, Jdphi_dR, Jdp_dR,
        img_point_cov, patch_size, level=level, max_iter=max_iter, robust=robust,
        mesh=mesh)
    return st, Gmat, mesh.all_gather(perr)[:tr_pos.shape[0]], err, its
