"""Scan voxel-grid downsampling: each occupied voxel becomes the centroid
of its points (the reference's `pcl::VoxelGrid` scan filter,
laserMapping.cpp:172-173 with leaf `filter_size_surf`).

Port of the JAX package's ops/voxel_filter.py: the device filter of the
fused frame step and the host (numpy) filter of the bootstrap frames.
"""
from __future__ import annotations

import numpy as np
import torch


def voxel_downsample_device(pts: torch.Tensor, valid: torch.Tensor,
                            leaf: torch.Tensor | None, max_out: int,
                            inv_leaf: torch.Tensor | None = None):
    """Centroid voxel filter with a fixed output capacity, on pts' device.

    Packed-key stable sort, then a segmented sum into `max_out` rows;
    rows past the capacity and invalid rows go to one extra sentinel row
    that is cut off. Output order is sorted-voxel-key order. Non-finite
    points are dropped (pcl::VoxelGrid's is-finite skip).

    Each segment is summed in row order (`segment_reduce` over the sorted
    rows), on CUDA as on the CPU: the result does not change from run to
    run, as an atomic `index_add_` would.

    Args:   pts (N, C>=3) f32; valid (N,) bool; leaf: 0-d f32 tensor on
            pts' device (see voxel_map.voxel_of for why not a float);
            or, instead of `leaf`, `inv_leaf`: the keys are then
            floor(pts * inv_leaf). The JAX package's fused camera step
            passes its 0.2 m leaf as a constant, which XLA turns into a
            multiply by the f32 reciprocal; `inv_leaf` computes that form.
    Returns (out (max_out, C), mask (max_out,)).
    """
    N, C = pts.shape
    valid = valid & torch.all(torch.isfinite(pts[:, :3]), dim=-1)
    keys = torch.floor(pts[:, :3] / leaf if inv_leaf is None
                       else pts[:, :3] * inv_leaf)
    # zero the dropped rows before the cast: a NaN has no integer value
    keys = torch.where(valid[:, None], keys, torch.zeros_like(keys)).to(torch.int64)
    # 3 x 20-bit offset coordinates in one key; the invalid marker 2^62
    # sorts last
    packed = (
        ((keys[:, 0] + (1 << 19)) & 0xFFFFF) << 40
        | ((keys[:, 1] + (1 << 19)) & 0xFFFFF) << 20
        | ((keys[:, 2] + (1 << 19)) & 0xFFFFF)
    )
    packed = torch.where(valid, packed, torch.full_like(packed, 1 << 62))
    order = torch.argsort(packed, stable=True)
    sp = packed[order]
    ps = pts[order]
    vs = valid[order]
    start = torch.ones_like(vs)
    start[1:] = sp[1:] != sp[:-1]
    start &= vs
    seg = torch.cumsum(start.to(torch.int64), 0) - 1
    seg = torch.where(vs, seg, torch.full_like(seg, max_out))
    seg = torch.clamp(seg, max=max_out)  # overflow -> sentinel row
    # seg never decreases along the sorted rows, so the segments are the
    # row runs of these lengths (integer counts: exact in any order)
    lengths = torch.zeros(max_out + 1, dtype=torch.int64, device=pts.device)
    lengths.index_add_(0, seg, torch.ones_like(seg))
    sums = torch.segment_reduce(
        torch.where(vs[:, None], ps, torch.zeros_like(ps)), "sum",
        lengths=lengths, axis=0, unsafe=True, initial=0.0)
    sums, cnt = sums[:max_out], lengths[:max_out].to(pts.dtype)
    mask = cnt > 0
    out = sums / torch.clamp(cnt, min=1.0)[:, None]
    return torch.where(mask[:, None], out, torch.zeros_like(out)), mask


def voxel_downsample(pts: np.ndarray, leaf: float,
                     max_out: int | None = None):
    """Host centroid-per-voxel downsample, in scan order.

    Args:
      pts: (N, 3+C) float array; extra columns are averaged alongside xyz.
      leaf: voxel edge length.
      max_out: if given, output is padded/truncated to this many rows and
        a validity mask is returned (truncation keeps the first voxels
        in scan order).

    Returns:
      (out, mask): out (M, 3+C) f32, mask (M,) bool. Without max_out,
      M is the number of occupied voxels and mask is all-true.
    """
    pts = np.asarray(pts, dtype=np.float64)
    if pts.ndim == 2 and len(pts):
        pts = pts[np.all(np.isfinite(pts[:, :3]), axis=1)]
    if pts.size == 0:
        M = max_out or 0
        return (np.zeros((M, pts.shape[1] if pts.ndim == 2 else 3), np.float32),
                np.zeros(M, bool))
    keys = np.floor(pts[:, :3] / leaf).astype(np.int64)
    # pack 3 x 21-bit signed coords into one int64 key
    packed = (
        ((keys[:, 0] + (1 << 20)) & 0x1FFFFF)
        | (((keys[:, 1] + (1 << 20)) & 0x1FFFFF) << 21)
        | (((keys[:, 2] + (1 << 20)) & 0x1FFFFF) << 42)
    )
    order = np.argsort(packed, kind="stable")
    sp = packed[order]
    first = np.ones(len(sp), bool)
    first[1:] = sp[1:] != sp[:-1]
    group = np.cumsum(first) - 1
    nv = group[-1] + 1
    sums = np.zeros((nv, pts.shape[1]), np.float64)
    np.add.at(sums, group, pts[order])
    counts = np.bincount(group, minlength=nv).astype(np.float64)
    cent = sums / counts[:, None]
    # restore scan order: voxel labeled by first occurrence
    first_idx = np.full(nv, len(pts), np.int64)
    np.minimum.at(first_idx, group, order)
    out = cent[np.argsort(first_idx, kind="stable")].astype(np.float32)
    if max_out is None:
        return out, np.ones(len(out), bool)
    mask = np.zeros(max_out, bool)
    n = min(len(out), max_out)
    buf = np.zeros((max_out, pts.shape[1]), np.float32)
    buf[:n] = out[:n]
    mask[:n] = True
    return buf, mask
