"""State and maps carried across as dicts of numpy arrays.

Each `*_from_arrays` takes a dict keyed by the NamedTuple's field names
(the JAX package's field names, so `{f: np.asarray(v) for f, v in
jax_state._asdict().items()}` converts its values) and a device; each
`*_to_arrays` is the inverse, and returns arrays of its own: the maps
are updated in place, so an array that shared a CPU tensor's memory would
change with the next frame. Dtypes are kept as given.
"""
from __future__ import annotations

import numpy as np
import torch

from .imu import ImuCalib, PoseTable
from .ops.dense_map import DenseMap
from .ops.tiled_map import TiledMap
from .ops.voxel_map import VoxelMap
from .state import NavState
from .visual_map import VisualMap


def _from_arrays(cls, d: dict, device):
    return cls(**{f: torch.as_tensor(np.array(d[f]), device=device)
                  for f in cls._fields})


def _own(t: torch.Tensor) -> np.ndarray:
    # .cpu() copies a device tensor but returns a CPU tensor itself
    t = t.detach()
    return (t.clone() if t.device.type == "cpu" else t.cpu()).numpy()


def _to_arrays(nt) -> dict:
    return {f: _own(getattr(nt, f)) for f in nt._fields}


def state_from_arrays(d: dict, device) -> NavState:
    return _from_arrays(NavState, d, device)


def calib_from_arrays(d: dict, device) -> ImuCalib:
    return _from_arrays(ImuCalib, d, device)


def pose_table_from_arrays(d: dict, device) -> PoseTable:
    return _from_arrays(PoseTable, d, device)


def tiled_map_from_arrays(d: dict, device) -> TiledMap:
    return _from_arrays(TiledMap, d, device)


def voxel_map_from_arrays(d: dict, device) -> VoxelMap:
    return _from_arrays(VoxelMap, d, device)


def dense_map_from_arrays(d: dict, device) -> DenseMap:
    return _from_arrays(DenseMap, d, device)


def visual_map_from_arrays(d: dict, device) -> VisualMap:
    return _from_arrays(VisualMap, d, device)


state_to_arrays = calib_to_arrays = pose_table_to_arrays = _to_arrays
tiled_map_to_arrays = voxel_map_to_arrays = dense_map_to_arrays = _to_arrays
visual_map_to_arrays = _to_arrays
