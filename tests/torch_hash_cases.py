"""Seeded batches for the hash map's insert that stress the two places
where the JAX package's sorted order (jnp.lexsort((d2c, k0, k1, k2)))
decides the table: each voxel's head (its row with the least distance to
the voxel centre, the lower row on a tie, invalid rows never heading a
voxel) and a slot contested in one round (the head last in (k2, k1, k0)
order keeps it). numpy only (no JAX): the card's tests import it too.
"""
import numpy as np

from fastlivo_tpu_torch.ops import voxel_map as vm

VOX = 0.5


def first_slots(keys, T: int) -> np.ndarray:
    """voxel_map._slot_check's first probe slot of int voxels (n, 3)."""
    z = vm._mix64_np(np.asarray(keys, np.int64).astype(np.int32)).astype(np.int64)
    return (z >> 13) & (T - 1)


def contested(axis: int, T: int = 64, n: int = 9, seed: int = 0):
    """(pts (m, 3) f32, valid (m,) bool): n voxels that differ only in
    coordinate `axis` (0: k0, 1: k1, 2: k2), some of them negative, whose
    first probe slot in a table of T slots is one, so that all n claim it
    in the first round and the losers go on to contend for the next slots;
    each voxel holds one to three rows (one of them invalid at times), in
    a seeded order."""
    rng = np.random.default_rng(seed + 10 * axis)
    cand = np.tile(np.array([3, -5, 2], np.int64), (4000, 1))
    cand[:, axis] = np.arange(-2000, 2000)
    s = first_slots(cand, T)
    vals, counts = np.unique(s, return_counts=True)
    keys = cand[s == vals[np.argmax(counts)]]
    keys = keys[rng.choice(len(keys), n, replace=False)]
    reps = rng.integers(1, 4, n)
    k = np.repeat(keys, reps, axis=0)
    pts = ((k + rng.uniform(0.05, 0.95, k.shape)) * VOX).astype(np.float32)
    valid = rng.random(len(k)) > 0.2
    valid[np.cumsum(reps) - 1] = True  # every voxel keeps a valid row
    o = rng.permutation(len(k))
    return pts[o], valid[o]


def ties_and_invalid(seed: int = 0, n: int = 600):
    """(pts, valid): voxels whose rows lie at one distance from the centre
    (exact duplicates, and points mirrored about the centre: the head is
    the lowest such row), voxels whose every row is invalid (no head), and
    voxels whose nearest row is invalid (the nearest valid row heads
    them), on negative and positive coordinates."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-6, 6, (n // 6, 3))
    keys = np.unique(keys, axis=0)
    rows, valid = [], []
    for i, k in enumerate(keys):
        c = (k + 0.5) * VOX
        off = rng.uniform(-0.2, 0.2, 3).astype(np.float32)
        kind = i % 4
        if kind == 0:  # exact duplicates
            rows += [c + off] * 3
            valid += [True] * 3
        elif kind == 1:  # mirrored: one distance, three points
            rows += [c + off, c - off, c + off * np.float32([1, -1, 1])]
            valid += [True] * 3
        elif kind == 2:  # every row invalid
            rows += [c + off, c - 0.5 * off]
            valid += [False, False]
        else:  # the nearest row invalid
            rows += [c + 0.1 * off, c + off, c - off]
            valid += [False, True, True]
    pts = np.asarray(rows, np.float32)
    valid = np.asarray(valid)
    o = rng.permutation(len(pts))
    return pts[o], valid[o]
