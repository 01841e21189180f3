"""The block-sharded tiled map behind the pipeline's map-backend surface
(`Pipeline(mesh=..., sharded_map=True)`, `--sharded-map`).

Port of the JAX package's parallel/sharded_backend.py: the same
duck-typed operations as a single-device map module (`insert`,
`delete_boxes`, `compact`, `extract_points`), so the pipeline swaps the
backend without touching its frame logic. Each rank holds its own shard
(a `tiled_map.TiledMap` of the tiles it owns, sharded_map.owner_of), so
per-rank map memory is ~1/N of the replicated map's.

  insert         ownership-masked insert of the whole world batch, in
                 place (each owner sees exactly the inserts the
                 replicated map would apply to its tiles)
  delete_boxes   on every shard, in place (deletion is cell-local)
  compact        per-shard pool compaction
  max_occupancy  the fullest shard's allocation (a collective)
  extract_points every shard's live points, gathered to EVERY rank (a
                 collective)

The collectives run at the same point on every rank: the pipeline calls
them from its replicated host logic.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import tiled_map as tm
from . import sharded_map as sm
from .sharded import Mesh


class ShardedTiledBackend:
    """`Pipeline._map_mod` for a block-sharded tiled map."""

    is_sharded = True

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n = mesh.size

    def empty(self, dims, pool_tiles_total: int, voxel_size: float) -> tm.TiledMap:
        """This rank's empty shard: a pool of max(total // n, 256) tiles,
        so the total capacity matches the single-device `tiled_pool`."""
        return sm.make_shards(self.mesh, dims, max(pool_tiles_total // self.n, 256),
                              voxel_size)

    def insert(self, shard: tm.TiledMap, world: torch.Tensor, mask: torch.Tensor,
               max_probe: int = 0) -> tm.TiledMap:
        return sm.shard_insert(shard, world, mask, self.mesh.rank, self.n)

    def delete_boxes(self, shard: tm.TiledMap, boxes_lo: torch.Tensor,
                     boxes_hi: torch.Tensor) -> tm.TiledMap:
        return tm.delete_boxes(shard, boxes_lo, boxes_hi)

    def compact(self, shard: tm.TiledMap) -> tm.TiledMap:
        return tm.compact(shard)

    def pool_per_shard(self, shard: tm.TiledMap) -> int:
        return shard.slot_key.shape[0]

    def max_occupancy(self, shard: tm.TiledMap) -> float:
        """The largest allocation over the shards: the fullest shard is the
        binding pool constraint."""
        return float(self.mesh.all_reduce(shard.n_alloc, "max"))

    def extract_points(self, shard: tm.TiledMap):
        """(pts (L, 3), L): the live points of every shard in rank order,
        on every rank (host numpy). Owned tiles are disjoint, so the
        concatenation is the map's content."""
        pts, _ = tm.extract_points(shard)
        allp = self.mesh.all_gather_rows(torch.as_tensor(pts, device=self.mesh.device))
        allp = allp.cpu().numpy().astype(np.float32, copy=False)
        return allp, len(allp)
