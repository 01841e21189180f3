"""Visual sparse map: points, observation rings, voxel index, image pool.

Port of the JAX package's visual_map.py (the reference's `feat_map`
voxel hash of `VOXEL_POINTS*`, lidar_selection.h:118, and `Point` with
its `Feature` observations, point.h / feature.h), in fixed-capacity
arrays with int32 indices:

  - points: position, Shi-Tomasi value and a ring of up to KO
    observations (lidar_selection.cpp:944-951);
  - an observation keeps the pixel, the world->camera pose at capture,
    the pyramid level and an int32 slot into the reference-image pool;
  - the pool keeps an image alive while a live observation references it
    (the reference's shared_ptr on Feature::img); only when every slot
    is referenced does `push_image` evict the least-referenced image,
    oldest first (on one card one launch of ops/vio_push.vio_push, whose
    plain version is `push_image_plain`);
  - `feat_map` is an open-addressing voxel hash (0.5 m voxels) whose
    slots hold up to VC point indices.

The JAX package's functions are pure and its fused camera step donates
the map (vio.py:961-968); here the mutating functions (`push_image`,
`add_points`, `add_observations`) update the map's tensors IN PLACE and
return the map with its new `n_pts`. `compact` builds new tensors.

Scatters: where the JAX package scatters with `mode="drop"`, the port
writes the kept rows only (`_put`, one host read of the kept count) or
through a sentinel row. Where it scatters duplicate indices with `set`,
XLA on the CPU keeps the LAST update; the port picks that winner
explicitly (`_last_wins`), so both devices give the JAX package's result.

Slabs (`Pipeline(mesh=, sharded_map=True)` with the camera): each rank of
a parallel.sharded.Mesh holds a contiguous slab of the image pool
(`imgs`, R/n slots) and of the observation rings (`obs_*`, NP/n point
rows); every other field is replicated. The functions that read or write
those fields take the `mesh` (None: the whole map on this rank; the JAX
package's `obs_axis`): a rank reads the rows it owns, zeroes the rest
and the mesh sums them (exact: one owner per element), and writes land
on the owner only. `shard_slabs` / `gather_slabs` convert between the two
layouts.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .device import resolve_device
from .ops.linalg import norm3
from .ops.vio_push import vio_push
from .ops.voxel_map import _last_wins, _slot_check

VOXEL_SIZE = 0.5  # lidar_selection.cpp:210
EMPTY = -2147483648  # free voxel-hash slot (int32 min)
I32, I64 = torch.int32, torch.int64
# the fields held in slabs under a sharded pool (rows split over the mesh)
SLAB_FIELDS = ("imgs", "obs_px", "obs_rcw", "obs_pcw", "obs_slot", "obs_fid",
               "obs_level")


class VisualMap(NamedTuple):
    # points
    pos: torch.Tensor  # (NP, 3) f32 world position
    value: torch.Tensor  # (NP,) f32 Shi-Tomasi score
    n_obs: torch.Tensor  # (NP,) i32
    n_pts: torch.Tensor  # () i32 allocation cursor
    # observation rings (the bearing and camera centre are derived from
    # the stored pixel and pose, as in the JAX package)
    obs_px: torch.Tensor  # (NP, KO, 2) f32
    obs_rcw: torch.Tensor  # (NP, KO, 3, 3) f32 world->cam rotation
    obs_pcw: torch.Tensor  # (NP, KO, 3) f32 world->cam translation
    obs_slot: torch.Tensor  # (NP, KO) i32 image pool slot
    obs_fid: torch.Tensor  # (NP, KO) i32 frame id (-1 empty)
    obs_level: torch.Tensor  # (NP, KO) i32 feature level
    # voxel hash (slot/check scheme of ops/voxel_map.py)
    vox_keys: torch.Tensor  # (T,) i32 31-bit check; EMPTY = free
    vox_count: torch.Tensor  # (T,) i32
    vox_idx: torch.Tensor  # (T, VC) i32 point indices
    # reference image pool
    imgs: torch.Tensor  # (R, H, W) f32 or u8
    img_fid: torch.Tensor  # (R,) i32 frame id in the slot (-1 empty)


def empty_visual_map(n_points: int = 1 << 16, n_obs: int = 20,
                     table_size: int = 1 << 18, voxel_cap: int = 16,
                     ring: int = 64, height: int = 512, width: int = 640,
                     dtype=torch.float32, img_dtype=None,
                     device=None, slabs: int = 1) -> VisualMap:
    """An empty map on `device` (CUDA unless given, see device.py).
    `img_dtype=torch.uint8` (the shipped `capacity.frame_ring_u8`) keeps
    the pool quantized to u8, as the reference keeps its frames.
    `slabs` = n > 1: one rank's slabs of it on a mesh of n (SLAB_FIELDS
    with `n_points` / n and `ring` / n rows; the slabs of an empty map
    are all alike), never the whole pool and rings."""
    if table_size & (table_size - 1):
        raise ValueError(f"table_size must be a power of two, got {table_size}")
    if n_points % slabs or ring % slabs:
        raise ValueError(f"{slabs} slabs do not divide {n_points} points and {ring} images")
    dev = resolve_device(device)
    NP, KO, T, VC, R = n_points, n_obs, table_size, voxel_cap, ring
    NPs, Rs = NP // slabs, R // slabs
    img_dtype = dtype if img_dtype is None else img_dtype
    f = dict(dtype=dtype, device=dev)
    i = dict(dtype=I32, device=dev)
    return VisualMap(
        pos=torch.zeros((NP, 3), **f),
        value=torch.zeros(NP, **f),
        n_obs=torch.zeros(NP, **i),
        n_pts=torch.zeros((), **i),
        obs_px=torch.zeros((NPs, KO, 2), **f),
        obs_rcw=torch.zeros((NPs, KO, 3, 3), **f),
        obs_pcw=torch.zeros((NPs, KO, 3), **f),
        obs_slot=torch.zeros((NPs, KO), **i),
        obs_fid=torch.full((NPs, KO), -1, **i),
        obs_level=torch.zeros((NPs, KO), **i),
        vox_keys=torch.full((T,), EMPTY, **i),
        vox_count=torch.zeros(T, **i),
        vox_idx=torch.zeros((T, VC), **i),
        imgs=torch.zeros((Rs, height, width), dtype=img_dtype, device=dev),
        img_fid=torch.full((R,), -1, **i),
    )


def voxel_of(p: torch.Tensor) -> torch.Tensor:
    # division by 0.5 is exact in either form (no reciprocal rounding)
    return torch.floor(p / VOXEL_SIZE).to(I32)


def _kept(keep: torch.Tensor) -> torch.Tensor:
    """Row numbers of the kept rows (one host read: their count)."""
    return torch.nonzero(keep).squeeze(1)


def _put(dst: torch.Tensor, index: tuple, values: torch.Tensor,
         rows: torch.Tensor):
    """dst[index[rows]] = values[rows] in place: the JAX package's
    `.at[index].set(values, mode="drop")` with the kept rows named by
    `rows` (from `_kept`) instead of dropping an out-of-range index. The
    kept indices must be unique."""
    dst[tuple(ix[rows] for ix in index)] = values[rows]


def shard_slabs(m: VisualMap, rank: int, n: int) -> VisualMap:
    """Rank `rank`'s slab layout of a whole map: rows [rank·k, (rank+1)·k)
    of each SLAB_FIELDS array (k = rows / n; MeshRunner.check_capacity
    refuses sizes that n does not divide), copied."""
    def cut(a):
        k = a.shape[0] // n
        return a[rank * k:(rank + 1) * k].clone()

    return m._replace(**{f: cut(getattr(m, f)) for f in SLAB_FIELDS})


def gather_slabs(m: VisualMap, mesh) -> VisualMap:
    """The whole map from every rank's slabs (a collective: every rank
    calls it at the same point)."""
    return m._replace(**{f: mesh.all_gather(getattr(m, f)) for f in SLAB_FIELDS})


def _owned(m: VisualMap, rows: torch.Tensor, mesh):
    """Global point rows -> (local ring row, owned by this rank) under
    the slab layout."""
    NPl = m.obs_fid.shape[0]
    loc = rows - mesh.rank * NPl
    return loc, (loc >= 0) & (loc < NPl)


def _live_slot_refs(m: VisualMap, mesh=None) -> torch.Tensor:
    """(R,) i32 count of live observations referencing each pool slot: the
    point is allocated, the observation exists (fid >= 0) and the slot
    still stores that fid (the reference's shared_ptr refcount on
    Feature::img). Under the slab layout each rank counts its ring rows
    (alive by their global row) and the mesh sums the counts. R comes
    from `img_fid`, which is never in slabs."""
    NPl, KO = m.obs_fid.shape
    R = m.img_fid.shape[0]
    row0 = 0 if mesh is None else mesh.rank * NPl
    alive = (row0 + torch.arange(NPl, dtype=I32, device=m.pos.device) < m.n_pts)[:, None]
    slot = torch.clamp(m.obs_slot, 0, R - 1)
    ok = alive & (m.obs_fid >= 0) & (m.img_fid[slot.long()] == m.obs_fid)
    tgt = torch.where(ok, slot, R).reshape(-1).long()
    # an integer index_add (order-free): bincount reads its maximum back
    # to the host
    refs = torch.zeros(R + 1, dtype=I32, device=tgt.device).index_add_(
        0, tgt, torch.ones_like(tgt, dtype=I32))[:R]
    return refs if mesh is None else mesh.all_reduce(refs)


def _gather_obs(m: VisualMap, safe: torch.Tensor, mesh=None):
    """(K, KO, ...) obs fields of point rows `safe`: (px, rcw, pcw, slot,
    fid, level). Under the slab layout each rank gathers the rows it owns
    from its slab, zeroes the others, and the mesh sums them: two
    collectives, one for the float fields and one for the integer ones."""
    s = safe.long()
    if mesh is None:
        return (m.obs_px[s], m.obs_rcw[s], m.obs_pcw[s], m.obs_slot[s],
                m.obs_fid[s], m.obs_level[s])
    K, KO = s.shape[0], m.obs_fid.shape[1]
    loc, mine = _owned(m, s, mesh)
    ls = torch.clamp(loc, 0, m.obs_fid.shape[0] - 1)
    keep = mine[:, None, None]
    f = torch.cat([m.obs_px[ls], m.obs_rcw[ls].reshape(K, KO, 9), m.obs_pcw[ls]], -1)
    i = torch.stack([m.obs_slot[ls], m.obs_fid[ls], m.obs_level[ls]], -1)
    f = mesh.all_reduce(torch.where(keep, f, torch.zeros_like(f)))
    i = mesh.all_reduce(torch.where(keep, i, torch.zeros_like(i)))
    return (f[..., 0:2], f[..., 2:11].reshape(K, KO, 3, 3), f[..., 11:14],
            i[..., 0], i[..., 1], i[..., 2])


def _slot_of_fid(m: VisualMap, fid: torch.Tensor) -> torch.Tensor:
    """Pool slot holding frame `fid` (0 if absent: the stored observation
    then fails close_view_obs's img_fid check)."""
    return torch.argmax((m.img_fid == fid).to(I32)).to(I32)


def push_slot(m: VisualMap, fid: torch.Tensor, mesh=None) -> torch.Tensor:
    """The pool slot `push_image` writes `fid` into: argmin of the key
    re-push (-2) < empty/dead (age rank) < live ((1+min(refs,200))*R +
    rank: fewest references, then oldest). Ranks are computed within the
    pool, ties (the -1 empties) broken by slot index. The same on every
    rank under the slab layout (`mesh`: see the module doc)."""
    refs = _live_slot_refs(m, mesh)
    R = m.img_fid.shape[0]
    sl = torch.arange(R, dtype=I32, device=m.img_fid.device)
    f = m.img_fid
    older = (f[None, :] < f[:, None]) | ((f[None, :] == f[:, None])
                                         & (sl[None, :] < sl[:, None]))
    rank = older.sum(dim=1, dtype=I32)  # unique 0..R-1
    live_key = (torch.clamp(refs, max=200) + 1) * R + rank
    key = torch.where(refs > 0, live_key, rank)
    key = torch.where(f == fid, torch.full_like(key, -2), key)
    return torch.argmin(key).to(I32)


def push_image(m: VisualMap, img: torch.Tensor, fid, mesh=None) -> VisualMap:
    """Store the frame's grayscale image in the pool, in place
    (`push_image_plain`). A map on the card without the slab layout
    (`mesh` None) takes one launch of ops/vio_push.vio_push, with no host
    read; the CPU and the slab layout run the plain version."""
    if mesh is None:
        return vio_push(m, img, fid)
    return push_image_plain(m, img, fid, mesh)


def push_image_plain(m: VisualMap, img: torch.Tensor, fid, mesh=None) -> VisualMap:
    """Store the frame's grayscale image in the pool, in place (slot
    policy in `push_slot`). A u8 pool stores round(clip(img, 0, 255)),
    rounding half to even as the JAX package does. Under the slab layout
    (`mesh`) every rank picks the slot from the replicated `img_fid` and
    only the slot's owner writes the image. The torch code the CPU runs
    and the oracle of ops/vio_push.vio_push."""
    fid = torch.as_tensor(fid, dtype=I32, device=m.img_fid.device)
    slot = push_slot(m, fid, mesh).long().reshape(1)
    if not m.imgs.dtype.is_floating_point:
        img = torch.round(torch.clamp(img, 0.0, 255.0))
    img = img.to(m.imgs.dtype)[None]
    if mesh is None:
        m.imgs.index_copy_(0, slot, img)
    else:
        # the owner's row takes the image, another rank rewrites a row
        # of its slab with itself (no host read of the slot)
        Rl = m.imgs.shape[0]
        loc = slot - mesh.rank * Rl
        mine = (loc >= 0) & (loc < Rl)
        loc = torch.clamp(loc, 0, Rl - 1)
        m.imgs.index_copy_(0, loc, torch.where(mine[:, None, None], img, m.imgs[loc]))
    m.img_fid.index_copy_(0, slot, fid.reshape(1))
    return m


def add_points(m: VisualMap, pts: torch.Tensor, px: torch.Tensor,
               rcw: torch.Tensor, pcw: torch.Tensor, value: torch.Tensor,
               fid, mask: torch.Tensor, max_probe: int = 12, mesh=None) -> VisualMap:
    """Batched AddPoint (lidar_selection.cpp:204-230) with the creation
    observation (addSparseMap :178-190, level 0), in place. Rows past the
    point capacity are dropped. Under the slab layout (`mesh`) the point
    fields and the voxel index update on every rank alike and each
    creation observation lands on its row's owner only."""
    dt = m.pos.dtype
    pts, px, value = (x.to(dt) for x in (pts, px, value))
    rcw, pcw = rcw.to(dt), pcw.to(dt)
    NP = m.pos.shape[0]
    dev = m.pos.device
    fid = torch.as_tensor(fid, dtype=I32, device=dev)

    mask = mask & (m.n_pts + torch.cumsum(mask.to(I32), 0) <= NP)
    order_idx = torch.cumsum(mask.to(I32), 0) - 1
    idx = torch.where(mask, m.n_pts + order_idx, NP).to(I32)
    n_new = mask.sum(dtype=I32)

    ix = (idx.long(),)
    oidx, omask = idx.long(), mask
    if mesh is not None:
        oidx, mine = _owned(m, oidx, mesh)
        omask = mask & mine
    ix0 = (oidx, torch.zeros_like(oidx))
    slot = _slot_of_fid(m, fid)
    B = idx.shape[0]
    rows = _kept(mask)
    _put(m.pos, ix, pts, rows)
    _put(m.value, ix, value, rows)
    _put(m.n_obs, ix, torch.ones(B, dtype=I32, device=dev), rows)
    orows = rows if mesh is None else _kept(omask)
    _put(m.obs_px, ix0, px, orows)
    _put(m.obs_rcw, ix0, rcw.expand(B, 3, 3), orows)
    _put(m.obs_pcw, ix0, pcw.expand(B, 3), orows)
    _put(m.obs_slot, ix0, slot.expand(B), orows)
    _put(m.obs_fid, ix0, fid.expand(B), orows)
    _put(m.obs_level, ix0, torch.zeros(B, dtype=I32, device=dev), orows)
    m = m._replace(n_pts=m.n_pts + n_new)
    _voxel_index_insert(m.vox_keys, m.vox_count, m.vox_idx, pts, idx, mask,
                        max_probe)
    return m


def _lexsort3(keys: torch.Tensor) -> torch.Tensor:
    """jnp.lexsort((arange(B), k0, k1, k2)): k2 primary, then k1, k0,
    then the row. Stable argsorts from the least significant key."""
    order = torch.arange(keys.shape[0], device=keys.device)
    for j in (0, 1, 2):
        order = order[torch.argsort(keys[order, j], stable=True)]
    return order


def _voxel_index_insert(vk, vc, vi, pts, idx, mask, max_probe):
    """Insert point indices into the voxel hash, in place (AddPoint
    :204-230 batched): group the batch by voxel, claim or find the
    voxel's slot, append up to the per-voxel capacity. Shared by
    add_points and compact."""
    B = pts.shape[0]
    T = vk.shape[0]
    VC = vi.shape[1]
    tmask = T - 1
    dev = pts.device
    keys = voxel_of(pts)
    # invalid rows share one sentinel key so they cannot split a voxel's
    # sorted group
    keys = torch.where(mask[:, None], keys, torch.full_like(keys, EMPTY + 1))
    slot0, checks = _slot_check(keys, tmask)
    ord_ = _lexsort3(keys)
    ks = keys[ord_]
    checks_s = checks[ord_]
    same = torch.all(ks == torch.roll(ks, 1, dims=0), dim=-1)
    same[0] = False
    seg_start = ~same
    grp = torch.cumsum(seg_start.to(I64), 0) - 1
    pos_in_batch = torch.arange(B, dtype=I64, device=dev)
    first_of_grp = torch.full((B,), B, dtype=I64, device=dev).scatter_reduce_(
        0, grp, pos_in_batch, "amin")
    rank = (pos_in_batch - first_of_grp[grp]).to(I32)
    mask_s = mask[ord_]
    is_leader = seg_start & mask_s

    # a local copy of the keys with one sentinel slot for dropped claims
    vk_ext = torch.cat([vk, vk.new_full((1,), EMPTY)])
    slot = slot0[ord_].long()
    done = ~mask_s
    resolved = torch.full((B,), T, dtype=I64, device=dev)
    for _ in range(max_probe):
        cur = vk_ext[slot]
        is_empty = cur == EMPTY
        is_mine = (cur == checks_s) & ~done
        claim = is_empty & is_leader & ~done
        # two voxels' leaders claiming one free slot: the later row wins
        win = _last_wins(slot, claim, T)
        vk_ext[torch.where(win, slot, T)] = checks_s
        won = claim & (vk_ext[slot] == checks_s)
        hit = is_mine | won
        resolved = torch.where(hit & (resolved == T), slot, resolved)
        done = done | hit
        slot = (slot + 1) & tmask
    vk.copy_(vk_ext[:T])

    # followers share the leader's resolved slot
    lead_res = torch.full((B,), T, dtype=I64, device=dev).scatter_reduce_(
        0, grp, resolved, "amin")
    res_all = lead_res[grp]
    write_pos = vc[torch.clamp(res_all, max=T - 1)] + rank
    ok = (res_all < T) & mask_s & (write_pos < VC)
    wp = torch.clamp(write_pos, max=VC - 1).long()
    win = _last_wins(res_all * VC + wp, ok, T * VC)
    _put(vi, (res_all, wp), idx[ord_].to(I32), _kept(win))
    # per-voxel count increment, applied once at each group's leader
    inc = torch.zeros(B, dtype=I32, device=dev).index_add_(0, grp, ok.to(I32))
    rows = _kept(is_leader & (res_all < T))
    vc.index_add_(0, res_all[rows], inc[grp][rows])


def compact(m: VisualMap, center: torch.Tensor, radius, mesh=None) -> VisualMap:
    """Keep only points within `radius` (inf-norm) of `center`, compacted
    to the front in their order; blank the dropped rows' observations and
    rebuild the voxel index. New tensors (the visual analogue of the
    sliding local map, triggered on a load factor). Under the slab layout
    (`mesh`) every rank gathers the slabs, compacts the whole map and
    keeps its slabs of the result (a collective)."""
    if mesh is not None:
        whole = compact(gather_slabs(m, mesh), center, radius)
        return shard_slabs(whole, mesh.rank, mesh.size)
    NP = m.pos.shape[0]
    dev = m.pos.device
    alive = torch.arange(NP, dtype=I32, device=dev) < m.n_pts
    keep = alive & (torch.amax(torch.abs(m.pos - center[None, :]), dim=-1) <= radius)
    perm = torch.argsort((~keep).to(I32), stable=True)
    n2 = keep.sum(dtype=I32)
    g = lambda a: a[perm]  # noqa: E731
    new_alive = torch.arange(NP, dtype=I32, device=dev) < n2
    m2 = m._replace(
        pos=g(m.pos), value=g(m.value), n_obs=g(m.n_obs), n_pts=n2,
        obs_px=g(m.obs_px), obs_rcw=g(m.obs_rcw), obs_pcw=g(m.obs_pcw),
        obs_slot=g(m.obs_slot),
        obs_fid=torch.where(new_alive[:, None], g(m.obs_fid),
                            torch.full_like(m.obs_fid, -1)),
        obs_level=g(m.obs_level),
        vox_keys=torch.full_like(m.vox_keys, EMPTY),
        vox_count=torch.zeros_like(m.vox_count),
        vox_idx=torch.zeros_like(m.vox_idx),
    )
    _voxel_index_insert(m2.vox_keys, m2.vox_count, m2.vox_idx, m2.pos,
                        torch.arange(NP, dtype=I32, device=dev), new_alive, 12)
    return m2


def gather_voxel_points(m: VisualMap, vox: torch.Tensor, vmask: torch.Tensor,
                        max_probe: int = 12):
    """feat_map lookup (addFromSparseMap :423-447): (Nv, 3) int voxel
    coords -> (Nv, VC) point indices + validity. The probe chain is
    `max_probe` consecutive slots; the first key hit resolves."""
    T = m.vox_keys.shape[0]
    VC = m.vox_idx.shape[1]
    tmask = T - 1
    slot, qcheck = _slot_check(vox, tmask)
    qcheck = torch.where(vmask, qcheck, torch.full_like(qcheck, EMPTY + 1))
    probes = (slot[:, None] + torch.arange(max_probe, dtype=I32,
                                           device=vox.device)[None, :]) & tmask
    hit = m.vox_keys[probes.long()] == qcheck[:, None]  # (Nv, P)
    found = hit.any(dim=1)
    first = torch.argmax(hit.to(I32), dim=1)  # first hit
    resolved = torch.gather(probes, 1, first[:, None])[:, 0]
    safe = torch.where(found, resolved, 0).long()
    idx = m.vox_idx[safe]
    cnt = torch.where(found, m.vox_count[safe], 0)
    valid = torch.arange(VC, device=vox.device)[None, :] < cnt[:, None]
    return idx, valid


def _camposes(o_pcw: torch.Tensor, o_rcw: torch.Tensor) -> torch.Tensor:
    """Camera centres -pcw @ rcw of (K, KO) stored poses -> (K, KO, 3),
    each sum left to right (the camera-frame kernels' order)."""
    p = o_pcw[..., None]
    return -((p[..., 0, :] * o_rcw[..., 0, :] + p[..., 1, :] * o_rcw[..., 1, :])
             + p[..., 2, :] * o_rcw[..., 2, :])


def close_view_obs(m: VisualMap, idx: torch.Tensor, campos: torch.Tensor,
                   mesh=None):
    """Point::getCloseViewObs (point.cpp:141-178) batched over point
    indices (K,): the observation whose viewing ray has the largest
    cosine to the current one; rejected below cos 60 deg or when its
    image slot was recycled. Returns a dict of the chosen observation's
    fields + ok (K,). Under the slab layout (`mesh`) the fields are
    gathered from their owners and the choice runs on every rank alike."""
    K = idx.shape[0]
    R = m.img_fid.shape[0]
    safe = torch.clamp(idx, 0, m.pos.shape[0] - 1)
    o_px, o_rcw, o_pcw, o_slot, o_fid, o_level = _gather_obs(m, safe, mesh)
    pos = m.pos[safe.long()]  # (K, 3)
    obs_dir = campos[None, :] - pos
    obs_dir = obs_dir / (norm3(obs_dir)[..., None] + 1e-12)
    camposes = _camposes(o_pcw, o_rcw)
    dirs = camposes - pos[:, None, :]
    dirs = dirs / (norm3(dirs)[..., None] + 1e-12)
    od = obs_dir[:, None, :]
    cos = (od[..., 0] * dirs[..., 0] + od[..., 1] * dirs[..., 1]) + od[..., 2] * dirs[..., 2]
    usable = (o_fid >= 0) & (m.img_fid[torch.clamp(o_slot, 0, R - 1).long()] == o_fid)
    cos = torch.where(usable, cos, torch.full_like(cos, -2.0))
    best = torch.argmax(cos, dim=-1)  # (K,), first maximum
    best_cos = torch.gather(cos, 1, best[:, None])[:, 0]

    def take(a):
        b = best.reshape(K, *([1] * (a.ndim - 1))).expand(K, 1, *a.shape[2:])
        return torch.gather(a, 1, b)[:, 0]

    return {
        "px": take(o_px), "rcw": take(o_rcw), "pcw": take(o_pcw),
        "campos": take(camposes), "slot": take(o_slot), "fid": take(o_fid),
        "level": take(o_level), "cos": best_cos, "ok": best_cos > 0.5,
    }


def add_observations(m: VisualMap, idx: torch.Tensor, px: torch.Tensor,
                     rcw: torch.Tensor, pcw: torch.Tensor,
                     value: torch.Tensor, fid, level: torch.Tensor,
                     mask: torch.Tensor, mesh=None) -> VisualMap:
    """Batched addObservation append (lidar_selection.cpp:913-965), in
    place: a full ring overwrites its furthest-view observation
    (getFurthestViewObs, point.cpp:219-247). `idx` (K,) unique. Under the
    slab layout (`mesh`) every rank computes the write plan from the
    owner-gathered rings and each observation lands on its row's owner."""
    dt = m.pos.dtype
    px, value = px.to(dt), value.to(dt)
    rcw, pcw = rcw.to(dt), pcw.to(dt)
    KO = m.obs_px.shape[1]
    NP = m.pos.shape[0]
    dev = m.pos.device
    fid = torch.as_tensor(fid, dtype=I32, device=dev)
    safe = torch.clamp(idx, 0, NP - 1).long()
    campos = _camposes(pcw, rcw)
    n = m.n_obs[safe]
    full = n >= KO
    _, o_rcw, o_pcw, _, o_fid, _ = _gather_obs(m, safe, mesh)
    dist = norm3(_camposes(o_pcw, o_rcw) - campos[None, None, :])
    dist = torch.where(o_fid >= 0, dist, torch.full_like(dist, -1.0))
    evict = torch.argmax(dist, dim=-1)
    w = torch.where(full, evict, torch.clamp(n, max=KO - 1).long())
    K = safe.shape[0]
    slot = _slot_of_fid(m, fid)
    ix = (safe,)
    rows = _kept(mask)
    _put(m.value, ix, value, rows)
    _put(m.n_obs, ix, torch.clamp(n + 1, max=KO), rows)
    if mesh is None:
        ixw, orows = (safe, w), rows
    else:
        loc, mine = _owned(m, safe, mesh)
        ixw, orows = (loc, w), _kept(mask & mine)
    _put(m.obs_px, ixw, px, orows)
    _put(m.obs_rcw, ixw, rcw.expand(K, 3, 3), orows)
    _put(m.obs_pcw, ixw, pcw.expand(K, 3), orows)
    _put(m.obs_slot, ixw, slot.expand(K), orows)
    _put(m.obs_fid, ixw, fid.expand(K), orows)
    _put(m.obs_level, ixw, level.to(I32), orows)
    return m
