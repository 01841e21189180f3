"""State and maps carried across as dicts of numpy arrays.

Each `*_from_arrays` takes a dict keyed by the NamedTuple's field names
(the JAX package's field names, so `{f: np.asarray(v) for f, v in
jax_state._asdict().items()}` converts its values) and a device; each
`*_to_arrays` is the inverse. Dtypes are kept as given.
"""
from __future__ import annotations

import numpy as np
import torch

from .imu import ImuCalib, PoseTable
from .ops.tiled_map import TiledMap
from .state import NavState


def _from_arrays(cls, d: dict, device):
    return cls(**{f: torch.as_tensor(np.array(d[f]), device=device)
                  for f in cls._fields})


def _to_arrays(nt) -> dict:
    return {f: getattr(nt, f).detach().cpu().numpy() for f in nt._fields}


def state_from_arrays(d: dict, device) -> NavState:
    return _from_arrays(NavState, d, device)


def calib_from_arrays(d: dict, device) -> ImuCalib:
    return _from_arrays(ImuCalib, d, device)


def pose_table_from_arrays(d: dict, device) -> PoseTable:
    return _from_arrays(PoseTable, d, device)


def tiled_map_from_arrays(d: dict, device) -> TiledMap:
    return _from_arrays(TiledMap, d, device)


state_to_arrays = calib_to_arrays = pose_table_to_arrays = tiled_map_to_arrays = _to_arrays
