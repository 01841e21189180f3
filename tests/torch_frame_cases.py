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
                "one_row", "all_invalid", "straddle", "overflow_mid_tile", "nearest_later",
                "equal_bits", "long_run", "dir_2_22"]
UNDISTORT_CASES = ["scan", "small_angle", "offset_hits", "masked", "table_512", "table_2",
                   "table_max", "table_513", "table_1024"]
UNDISTORT_STAGE_M = 4104  # imu.UNDISTORT_STAGE_M: 8 (512 + 1) rows
# the pipeline's pose table (8 (max_imu_per_group + 1) rows) past the stage
UNDISTORT_GLOBAL_M = {"table_4105": 4105, "table_513": 4112, "table_1024": 8200}


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


def nearest_later_batch(rng, a_wins: bool):
    """Tiles A (0, 0, 0) and B (2, 0, 0) share the entry 0 of a (2, 2, 2)
    directory, and their cell 0 (voxels (0, 0, 0) and (16, 0, 0)) heads
    it: the run's nearest row comes after two farther ones, one of each
    tile, so its tile wins (A where a_wins). Tile C (1, 0, 0) alone on its
    entry: the nearest row of its first cell run after a farther one, and
    a nearer row in a later cell. Plus surface rows."""
    c = np.array([[0.25, 0.25, 0.25], [8.25, 0.25, 0.25]], np.float32)  # A's, B's cell 0
    win, lose = (c[0], c[1]) if a_wins else (c[1], c[0])
    special = np.array([
        win + [0.2, 0.2, 0.2],      # the winning tile, far (0.12 m^2)
        lose + [0.1, 0.0, 0.0],     # the losing tile, nearer (0.01)
        win + [0.01, 0.0, 0.0],     # the winning tile, nearest (1e-4)
        lose + [0.2, 0.0, 0.0],     # the losing tile again
        [4.45, 0.45, 0.45],         # C's cell 0 (voxel (8, 0, 0)), far
        [4.26, 0.25, 0.25],         # C's cell 0, nearest
        [4.75, 0.75, 0.751],        # C's cell 73 (voxel (9, 1, 1)), nearer than both
    ], np.float32)
    p, v = stream(int(rng.integers(1 << 30)), n_batches=1, n=300)[0]
    return np.concatenate([special, p]), np.concatenate([np.ones(len(special), bool), v])


def equal_bits_batches():
    """Rows at equal distances from their voxel centre, so equal distance
    bits: the cell 0 of tiles A (0, 0, 0) and B (2, 0, 0), which share
    the entry 0 of a (2, 2, 2) directory, at 0.125 m either side of their
    centres (exact in f32). First B's row, then A's two: B wins the entry
    and its row the cell; then A's row at -0.125, B's, A's at +0.125: A
    wins with its earlier row; then A's +0.125 row alone, no nearer than
    the stored one, which stays. An exact duplicate row in the first two
    batches."""
    a0, a1 = [0.125, 0.25, 0.25], [0.375, 0.25, 0.25]
    b = [8.125, 0.25, 0.25]
    batches = [[b, a1, a0, b], [a0, b, a1, a0], [a1]]
    return [("insert", np.array(x, np.float32), np.ones(len(x), bool)) for x in batches]


def long_run_batches(rng):
    """Runs longer than a 1024-row tile, in a (2, 2, 2) directory: first
    1000 rows of tile A (0, 0, 0) in its cell 0, then 3000 rows in its
    cell 1 with every third row of tile B (2, 0, 0), which aliases A, in
    the same cell (B's rows are dropped): the cell 1 run spans sorted
    positions 1000-3999, across three tile ends, with its nearest ok row
    at 3899 and a nearer dropped row at 3900, and 20 invalid rows after
    them. Then B takes the entry: 1500 rows in its cell 0, the nearest
    last."""
    vs = 0.5

    def voxel_rows(vox, n):
        return ((np.asarray(vox, np.float64) + rng.uniform(0.05, 0.95, (n, 3))) * vs)

    x = voxel_rows([0, 0, 0], 1000)
    y = voxel_rows([0, 0, 1], 3000)
    y[::3] = voxel_rows([16, 0, 1], 1000)
    y[2900] = [8.25, 0.25, 0.75]  # B's row at its voxel centre: the nearest, not ok
    y[2899] = [0.2501, 0.25, 0.75]  # A's nearest, at sorted position 3899
    first = np.concatenate([x, y, voxel_rows([3, 3, 3], 20)]).astype(np.float32)
    valid = np.ones(len(first), bool)
    valid[-20:] = False
    second = voxel_rows([16, 0, 0], 1500)
    second[-1] = [8.2501, 0.25, 0.25]
    return [("insert", first, valid),
            ("insert", second.astype(np.float32), np.ones(1500, bool))]


def dir_2_22_batch(rng):
    """A directory of 2^22 entries, (256, 256, 64) tiles, the JAX
    package's largest: a row in its last entry's last cell (tile (-1, -1,
    -1), voxel (-1, -1, -1), key 2^31 - 1 - 2^31 = -1) and a nearer one
    after it, surface rows around the origin (many in the last entries),
    and invalid rows (key 0) after them in the sort."""
    p, v = stream(int(rng.integers(1 << 30)), n_batches=1, n=600, span=3.0)[0]
    last = np.array([[-0.2, -0.3, -0.1], [-0.24, -0.26, -0.25]], np.float32)
    return np.concatenate([last, p]), np.concatenate([np.ones(2, bool), v])


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
    if case == "nearest_later":
        return (2, 2, 2), 64, [("insert",) + nearest_later_batch(rng, f)
                               for f in (True, False, True)]
    if case == "equal_bits":
        return (2, 2, 2), 64, equal_bits_batches()
    if case == "long_run":
        return (2, 2, 2), 64, long_run_batches(rng)
    if case == "dir_2_22":
        return (256, 256, 64), 64, [("insert",) + dir_2_22_batch(rng) for _ in range(2)]
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
        M, n_pairs, N = UNDISTORT_STAGE_M, 4000, 8000
    if case in UNDISTORT_GLOBAL_M:  # searched in global memory
        M = UNDISTORT_GLOBAL_M[case]
        n_pairs, N = M - 100, 8000
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


UNDISTORT_KINDS = ["padded", "unsorted", "duplicates", "nan_times"]


def undistort_kind_case(M, kind, seed=0):
    """undistort_case("scan")'s inputs on a table of M rows whose offsets
    are of one kind: "padded" (sorted, the last quarter BIG_T),
    "unsorted" (those permuted), "duplicates" (every live offset three
    times) or "nan_times" (padded, every 7th point time NaN); the point
    times also hit offsets, BIG_T and the infinities."""
    rng = np.random.default_rng(seed + M + len(kind))
    d = undistort_case("scan", seed)
    N = len(d["pts"])
    n_live = max(1, (3 * M) // 4)
    offs = np.full(M, np.float32(BIG_T), np.float32)
    offs[:n_live] = np.sort(rng.uniform(-0.004, 0.1, n_live)).astype(np.float32)
    if kind == "unsorted":
        offs = rng.permutation(offs)
    if kind == "duplicates":
        offs[:n_live] = np.repeat(offs[:n_live:3], 3)[:n_live]
    t = rng.uniform(-0.01, 0.12, N).astype(np.float32)
    t[:50] = offs[:50]
    t[50:53] = [np.float32(BIG_T), np.inf, -np.inf]
    if kind == "nan_times":
        t[::7] = np.nan
    d["offs"], d["t_rel"] = offs, t
    for f, scale in (("pos", 3), ("vel", 1), ("acc", 2), ("gyr", 0.4)):
        d[f] = rng.normal(0, scale, (M, 3)).astype(np.float32)
    d["rot"] = _rot(rng.normal(0, 0.5, (M, 3))).astype(np.float32)
    return d

