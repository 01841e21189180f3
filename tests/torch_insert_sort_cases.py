"""The tiled insert's sort cases, shared by tests/test_torch_insert_sort.py
(the CPU, against the JAX package) and tests/test_torch_cuda.py (the card):
numpy only.

A case is (dims, pool, batches), each batch (pts (B, 3) f32, valid (B,)
bool) inserted in order at 0.5 m voxels. "lio" is the shape of the LIO
path's insert: 16384 rows of which the first 12000 are valid (the
filtered scan, the rest padding), on the synthetic box room about the
world origin, where the map starts: its tiles straddle the directory's
wrap in every axis (tile -1 is field value dim - 1). "far" is the room
moved away from the origin (no wrap); "wrap_x", "wrap_y", "wrap_z" straddle
the wrap in one axis; then no valid row, one row, no rows, a directory of
2^22 entries (256, 256, 64) with rows in its last entry's last cell, a
directory of 2^22 entries whose x field has 16384 values (ranked by its
range, not its occupancy), and 20000 rows in 40 voxels (runs of equal
keys, exact duplicates among them); and every row valid over 8 x 4 x 4
or 32 x 32 x 32 tiles, every tile value of each field occupied: ranks of
exactly 16 and 24 bits.
"""
import numpy as np

VOX = 0.5
CASES = ["lio", "far", "wrap_x", "wrap_y", "wrap_z", "all_invalid", "n1", "n0", "dir_2_22",
         "wide_field", "equal_runs", "bits16", "bits24"]
# the occupied tile values (x, y, z) of the cases whose every row is valid
# and whose sort rank reaches exactly 2^bits - 1 (R_x R_y R_z 512 = 2^bits):
# a digit boundary
BITS_TILES = {"bits16": (8, 4, 4), "bits24": (32, 32, 32)}
ROOM_LO = np.array([-6.0, -5.0, -1.2])  # the synthetic room in the world frame
ROOM_HI = np.array([6.0, 5.0, 2.0])


def room_points(rng, n, lo=ROOM_LO, hi=ROOM_HI, noise=0.004):
    """n points on the faces of the box [lo, hi], with noise."""
    ext = hi - lo
    face = rng.integers(0, 6, n)
    p = lo + rng.uniform(0, 1, (n, 3)) * ext
    axis, side = face // 2, face % 2
    p[np.arange(n), axis] = np.where(side == 1, hi[axis], lo[axis])
    return (p + rng.normal(0, noise, (n, 3))).astype(np.float32)


def lio_batch(rng, n=16384, n_valid=12000, offset=(0.0, 0.0, 0.0)):
    p = room_points(rng, n) + np.asarray(offset, np.float32)
    return p, np.arange(n) < n_valid


def slab_batch(rng, n, lo, hi):
    """n points uniform in the box [lo, hi], 5% invalid."""
    p = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    return p, rng.random(n) > 0.05


def sort_case(case, seed=0):
    """(dims, pool, batches) of a case."""
    rng = np.random.default_rng([seed, len(case)])
    dims, pool = (128, 128, 64), 4096
    if case == "lio":
        return dims, pool, [lio_batch(rng) for _ in range(3)]
    if case == "far":
        return dims, pool, [lio_batch(rng, offset=(150.0, 70.0, 15.0)) for _ in range(2)]
    if case.startswith("wrap_"):
        lo, hi = np.array([60.0, 60.0, 20.0]), np.array([80.0, 80.0, 30.0])
        q = "xyz".index(case[-1])
        lo[q], hi[q] = -12.0, 12.0
        return dims, pool, [slab_batch(rng, 6000, lo, hi) for _ in range(2)]
    if case == "all_invalid":
        p, v = lio_batch(rng)
        return dims, pool, [(p, np.zeros_like(v)), lio_batch(rng), (p, np.zeros_like(v))]
    if case == "n1":
        p, _ = lio_batch(rng)
        return dims, pool, [(p[:1], np.ones(1, bool)), (p[1:2], np.ones(1, bool))]
    if case == "n0":
        p, v = lio_batch(rng)
        return dims, pool, [(p[:0], v[:0]), (p[:300], v[:300]), (p[:0], v[:0])]
    if case == "dir_2_22":
        last = np.array([[-0.2, -0.3, -0.1], [-0.24, -0.26, -0.25]], np.float32)
        p, v = slab_batch(rng, 3000, [-3.0, -3.0, -3.0], [3.0, 3.0, 3.0])
        return (256, 256, 64), 64, [(np.concatenate([last, p]),
                                     np.concatenate([np.ones(2, bool), v]))] * 2
    if case == "wide_field":
        return (16384, 16, 16), 256, [slab_batch(rng, 5000, [-30.0, -3.0, -3.0],
                                                 [30.0, 3.0, 3.0]) for _ in range(2)]
    if case == "equal_runs":
        vox = rng.integers(-20, 20, (40, 3))
        pick = rng.integers(0, 40, 20000)
        p = ((vox[pick] + rng.uniform(0.05, 0.95, (20000, 3))) * VOX).astype(np.float32)
        p[5000:9000] = p[4000]  # exact duplicates: equal keys and distances
        return (32, 32, 16), 1024, [(p, rng.random(20000) > 0.05)]
    if case in BITS_TILES:  # tiles of 8 voxels: 4 m a side, the box from the origin
        ext = np.array(BITS_TILES[case], np.float64) * 8 * VOX
        n = 6000 if case == "bits16" else 40000
        p = rng.uniform(0.0, 1.0, (n, 3)) * ext
        p[:len(ext)] = ext - 0.1  # the far corner tiles, whatever the draw
        return (128, 128, 64), 4096, [(p.astype(np.float32), np.ones(n, bool))]
    raise ValueError(case)


def resized(p, v, n):
    """The batch's first n rows, or the batch repeated with its copies 37 m
    apart in x until it has n."""
    if n <= len(p):
        return p[:n], v[:n]
    reps = -(-n // len(p))
    p2 = np.concatenate([p + np.float32(37.0 * k) * np.array([1, 0, 0], np.float32)
                         for k in range(reps)])
    return p2[:n], np.tile(v, reps)[:n]
