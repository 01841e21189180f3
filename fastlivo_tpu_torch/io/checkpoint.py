"""Map/state checkpointing: save and restore the whole estimator.

Port of the JAX package's io/checkpoint.py, with its `.npz` layout key
for key, so a snapshot written by either package loads into the other:

    map_type        "tiled", "dense" or "voxel" (the hash map)
    state/<field>   NavState (f64)
    map/<field>     TiledMap, DenseMap or VoxelMap
    vmap/<field>    VisualMap (LIVO only)
    calib/<field>   ImuCalib (lets a restored process skip IMU init)

The port updates its maps in place, on the card and on the CPU alike, so
`to_host` copies every array (a CPU tensor too) before it returns: the
caller may run the next frame right after it.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .. import convert
from ..ops.dense_map import DenseMap
from ..ops.tiled_map import TiledMap
from ..ops.voxel_map import VoxelMap
from ..visual_map import VisualMap

# map_type -> the map's class, as the JAX package names them
MAP_TYPES = {"voxel": VoxelMap, "dense": DenseMap, "tiled": TiledMap}


def to_host(state, m, visual=None, calib=None) -> dict:
    """The snapshot as a dict of host numpy arrays in the `.npz` layout
    (a synchronous copy of every array, sharing no memory with the
    tensors)."""
    out = {"map_type": np.array(
        next(k for k, cls in MAP_TYPES.items() if isinstance(m, cls)))}
    for prefix, nt in (("state", state), ("map", m), ("vmap", visual),
                       ("calib", calib)):
        if nt is not None:
            for name, val in convert._to_arrays(nt).items():
                out[f"{prefix}/{name}"] = val
    return out


def write(path, arrays: dict) -> None:
    """np.savez_compressed of a `to_host` dict (appends `.npz` to a path
    without it, as numpy does)."""
    np.savez_compressed(path, **arrays)


def save(path: str | Path, state, m, visual=None, calib=None) -> None:
    """`calib`: optional imu.ImuCalib; with it, a restored process resumes
    without the 200-sample static IMU re-initialization."""
    write(path, to_host(state, m, visual, calib))


def load(path: str | Path, device=None):
    """Returns (NavState, map of the snapshot's backend, VisualMap | None,
    ImuCalib | None) on `device` (CUDA unless given). A snapshot without
    `map_type` holds a hash map, as in the JAX package; snapshots without
    a calib load with calib None; `vmap/` fields the VisualMap no longer
    has are ignored."""
    from ..device import resolve_device

    dev = resolve_device(device)
    path = Path(path)
    if not path.exists() and path.suffix != ".npz":
        # np.savez appends .npz when missing: accept the path save() got
        path = path.with_suffix(path.suffix + ".npz")
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    map_type = str(arrays.get("map_type", "voxel"))
    if map_type not in MAP_TYPES:
        raise ValueError(f"checkpoint map_type {map_type!r}: not one of "
                         f"{tuple(MAP_TYPES)}")

    def part(prefix, keep=None):
        d = {k.split("/", 1)[1]: v for k, v in arrays.items()
             if k.startswith(prefix + "/")}
        if keep is not None:
            d = {k: v for k, v in d.items() if k in keep}
        return d

    state = convert.state_from_arrays(part("state"), dev)
    m = convert._from_arrays(MAP_TYPES[map_type], part("map"), dev)
    vd = part("vmap", set(VisualMap._fields))
    visual = convert.visual_map_from_arrays(vd, dev) if vd else None
    cd = part("calib")
    calib = convert.calib_from_arrays(cd, dev) if cd else None
    return state, m, visual, calib
