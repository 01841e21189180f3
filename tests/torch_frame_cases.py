"""Seeded inputs of the LIO frame's map insert and scan undistortion, in
numpy only: the CPU tests (tests/test_torch_frame_kernels.py) and the
card tests (tests/test_torch_cuda.py, which imports no JAX) share them.

insert_case(case) -> (dims, pool, steps): each step is ("insert", pts
(B, 3) f32, valid (B,) bool) or ("compact", lo (3,), hi (3,)) (clear a
box, then compact: the slots past n_alloc keep stale keys and cells).
undistort_case(case) -> dict of the undistortion's inputs.
"""
import numpy as np

VOX = 0.5
BIG_T = 1e30
INSERT_CASES = ["stream", "aliasing", "overflow", "head_not_ok", "compacted", "empty",
                "one_row", "all_invalid", "straddle", "overflow_mid_tile"]
UNDISTORT_CASES = ["scan", "small_angle", "offset_hits", "masked", "table_512", "table_2",
                   "table_max"]
UNDISTORT_MAX_M = 4104  # imu.UNDISTORT_MAX_M: 8 (512 + 1) rows


def stream(seed, n_batches=4, n=1500, span=30.0):
    """Surface-like batches around the origin (negative voxel and tile
    coordinates), with invalid rows and near-duplicates."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        p = np.stack([rng.uniform(-span, span, n), rng.uniform(-span, span, n),
                      np.abs(np.sin(0.2 * rng.uniform(-span, span, n))) * 2 - 1], 1)
        p[: n // 10] = p[n // 10: n // 5] + rng.normal(0, 0.05, (n // 10, 3))
        out.append((p.astype(np.float32), rng.random(n) > 0.05))
    return out


def head_not_ok_batch(rng, first_loser: bool):
    """Two tiles on one directory entry of a (2, 2, 2) directory: the
    losing tile's point lies nearest its voxel centre, so it heads the
    (entry, cell) run, and the run's winner is the next row (the winning
    tile's point in the same in-tile cell). The winning tile heads the
    entry through a point in a lower cell. Plus an exact duplicate (a tie
    that the stable sort breaks by row) and surface rows."""
    loser = [0.76, 0.75, 0.75]   # tile (0, 0, 0), voxel (1, 1, 1), 1e-4 from its centre
    winner = [8.9, 0.75, 0.75]   # tile (2, 0, 0), voxel (17, 1, 1), 0.15 from its centre
    head = [8.1, 0.1, 0.1]       # tile (2, 0, 0), voxel (16, 0, 0): cell 0 heads the entry
    special = np.array([loser, winner, head, winner], np.float32)
    if not first_loser:
        special = special[::-1].copy()
    p, v = stream(int(rng.integers(1 << 30)), n_batches=1, n=400)[0]
    return np.concatenate([special, p]), np.concatenate([np.ones(4, bool), v])


def tile_grid_batch(rng, tiles, n):
    """n rows in the given tiles ((k, 3) int tile coordinates of 4 m cubes
    at VOX = 0.5), row i in tiles[i % k], inside the tile by 0.1 m."""
    t = np.asarray(tiles, np.float64)[np.arange(n) % len(tiles)]
    return (t * 8 * VOX + rng.uniform(0.1, 8 * VOX - 0.1, (n, 3))).astype(np.float32)


def straddle_batches(rng):
    """Fresh tile heads on both sides of the 1024-row tile ends: a batch
    that fills 5 tiles, then 3000 rows in those 5 (aliased heads) with
    single rows of new tiles at rows 1020-1027 and 2044-2051."""
    old = [(i, 1, 1) for i in range(5)]
    first = tile_grid_batch(rng, old, 600)
    p = tile_grid_batch(rng, old, 3000)
    fresh = list(range(1020, 1028)) + list(range(2044, 2052))
    p[fresh] = tile_grid_batch(rng, [(i % 8, 3 + i // 8, 2) for i in range(len(fresh))],
                               len(fresh))
    return [("insert", first, np.ones(600, bool)), ("insert", p, np.ones(3000, bool))]


def overflow_mid_tile_batch(rng):
    """3000 rows over 100 new tiles of a 10 x 10 grid, 30 consecutive rows
    a tile: the fresh heads come every ~30 rows, so a 40-slot pool
    overflows at the 41st, in the middle of the second 1024-row tile."""
    tiles = [(i % 10, i // 10, 0) for i in range(100)]
    n = 3000
    t = np.asarray(tiles, np.float64)[np.arange(n) // 30]
    p = (t * 8 * VOX + rng.uniform(0.1, 8 * VOX - 0.1, (n, 3))).astype(np.float32)
    return [("insert", p, rng.random(n) > 0.02)]


def insert_case(case):
    rng = np.random.default_rng(len(case))
    dims, pool = (32, 32, 16), 1024
    ins = lambda b: [("insert", p, v) for p, v in b]  # noqa: E731
    if case == "stream":
        return dims, pool, ins(stream(11))
    if case == "aliasing":  # a (2, 2, 2) directory over a +-30 m scene
        return (2, 2, 2), pool, ins(stream(2))
    if case == "overflow":  # 24 pool slots: fresh tiles past them drop their rows
        return dims, 24, ins(stream(1))
    if case == "head_not_ok":
        steps = [("insert",) + head_not_ok_batch(rng, f) for f in (True, False)]
        return (2, 2, 2), 64, steps + steps[:1]
    if case == "compacted":
        b = stream(5, n_batches=3)
        return dims, pool, ins(b[:2]) + [
            ("compact", np.array([-40.0, -40.0, -5.0], np.float32),
             np.array([0.0, 40.0, 5.0], np.float32))] + ins(b[2:] + b[:1])
    if case == "empty":
        b = stream(6, n_batches=2)
        return dims, pool, ins([b[0], (b[1][0][:0], b[1][1][:0]), b[1]])
    if case == "one_row":
        b = stream(7, n_batches=2)
        return dims, pool, ins([(b[0][0][:1], np.ones(1, bool)), b[1],
                                (b[0][0][1:2], np.ones(1, bool))])
    if case == "straddle":
        return dims, pool, straddle_batches(rng)
    if case == "overflow_mid_tile":
        return dims, 40, overflow_mid_tile_batch(rng)
    if case == "all_invalid":
        b = stream(8, n_batches=2)
        return dims, pool, ins([(b[0][0], np.zeros(len(b[0][1]), bool)), b[1],
                                (b[0][0], np.zeros(len(b[0][1]), bool))])
    raise ValueError(case)


def _rot(w):
    """Rodrigues in f64 for (..., 3) rotation vectors."""
    t = np.linalg.norm(w, axis=-1, keepdims=True)[..., None]
    k = np.zeros(w.shape[:-1] + (3, 3))
    k[..., 0, 1], k[..., 0, 2], k[..., 1, 2] = -w[..., 2], w[..., 1], -w[..., 0]
    k = k - np.swapaxes(k, -1, -2)
    ts = np.where(t > 0, t, 1.0)
    return np.eye(3) + np.sin(ts) / ts * k + (1 - np.cos(ts)) / ts ** 2 * (k @ k)


def undistort_case(case, seed=0):
    """The undistortion's inputs: state rot (3, 3) and pos (3,) f64; the
    pose table offs, rot, pos, vel, acc, gyr f32 (M rows: row 0 at row0,
    leading rows repeating it, the pairs, BIG_T padding); pts (N, 3),
    t_rel (N,) f32, pmask (N,) bool; lid_rot (3, 3), lid_off (3,) f32."""
    rng = np.random.default_rng(seed + len(case))
    M, n_pairs, N, gyr_scale = 64, 40, 4000, 0.4
    if case == "table_512":  # a 4 kHz IMU: 512 pairs a scan
        M, n_pairs, N = 512, 400, 8000
    if case == "table_2":  # the smallest table with a search: row 0 twice
        M, n_pairs = 2, 2
    if case == "table_max":  # the largest table the kernel stages
        M, n_pairs, N = UNDISTORT_MAX_M, 4000, 8000
    if case == "small_angle":  # every row in the Taylor branch (t^2 < 1e-12)
        gyr_scale = 1e-7
    row0 = np.float32(-0.004)
    offs = np.full(M, BIG_T, np.float32)
    lead = min(3, n_pairs - 1)  # leading skipped pairs alias row 0's offset
    offs[:lead + 1] = row0
    offs[lead + 1:n_pairs] = np.sort(rng.uniform(0.0, 0.1, n_pairs - lead - 1)).astype(np.float32)
    gyr = rng.normal(0, gyr_scale, (M, 3))
    if case == "small_angle":
        gyr[::5] = 0.0
    d = dict(
        state_rot=_rot(rng.normal(0, 0.5, 3)), state_pos=rng.normal(0, 3, 3),
        offs=offs, rot=_rot(rng.normal(0, 0.5, (M, 3))).astype(np.float32),
        pos=rng.normal(0, 3, (M, 3)).astype(np.float32),
        vel=rng.normal(0, 1, (M, 3)).astype(np.float32),
        acc=rng.normal(0, 2, (M, 3)).astype(np.float32), gyr=gyr.astype(np.float32),
        pts=rng.uniform(-20, 20, (N, 3)).astype(np.float32),
        t_rel=rng.uniform(-0.01, 0.12, N).astype(np.float32),
        pmask=rng.random(N) > 0.05,
        lid_rot=_rot(np.array([0.01, -0.02, 0.03])).astype(np.float32),
        lid_off=np.array([0.05, -0.02, 0.1], np.float32))
    if case == "offset_hits":  # times on the offsets, row 0's included
        d["t_rel"][: 2 * n_pairs] = np.concatenate([offs[:n_pairs]] * 2)
    if case == "masked":
        d["pmask"][::2] = False
        d["pts"][:40:2] = np.nan
    return d
