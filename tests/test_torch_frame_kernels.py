"""Port parity: the plain versions of the LIO frame's insert and
undistortion kernels, on the CPU.

`tiled_map.insert` on a CUDA map runs two kernels around one stable sort
of 32-bit keys (csrc/tiled_insert.cu), `imu.undistort` on CUDA points
one (csrc/undistort.cu); on the CPU their plain versions `insert_plain`
and `undistort_plain` run, and the card tests hold the kernels to them
bit for bit (tests/test_torch_cuda.py). Here:

  - the kernels' passes written out in numpy as the kernels run them
    (keys a row at a time; tile winners, each the nearest row of its
    directory group's first cell run, flagged from the directory as it
    was by blocks of sorted positions, then ranked by blocks of rows in
    their original order, each prefix found by look-back over the
    blocks' status words; each cell run's nearest ok row found by the
    block of sorted positions that holds the run's first row, reading on
    past its end) give insert_plain's map bit for bit, batch by batch, at
    blocks of 1, 7, 32 and 1024 rows, on streams with directory aliasing,
    pool overflow (also in the middle of a tile), fresh winners on both
    sides of a tile end, runs whose first row is not ok, a compacted map
    with stale slots, B = 0 and 1, no valid row, nearest rows after
    farther ones, equal distances, runs longer than a tile and across
    tile ends, and a directory of 2^22 entries with a row in its last
    cell; and each plain pass's outputs equal the model's;
  - the undistortion's search in shared memory, with torch's probes,
    finds torch.searchsorted's rows on sorted, padded, unsorted and
    duplicate offsets and NaN times, at M = 1, 2, 520 and the largest
    table the kernel stages, which is the pipeline's at 512 IMU pairs a
    group;
  - insert_plain equals the JAX package's insert, field by field;
  - undistort_plain is within 1e-5 m of the JAX package's undistort
    (its sums run in another order: f32 roundings of points within 20 m
    of the sensor, as tests/test_torch_imu.py) on
    small-angle rows (so3.exp's Taylor branch), times on the offsets,
    offsets with duplicates and BIG_T rows, masked rows (copied bit for
    bit, NaN included) and a 512-row pose table; an f64 pose table (the
    views of a pose pack) gives the f32 table's bits;
  - the wrappers refuse a device that is neither the CPU nor CUDA.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fastlivo_tpu import imu as jimu
from fastlivo_tpu import state as jstate
from fastlivo_tpu.ops import tiled_map as jtm

from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch import imu as timu
from fastlivo_tpu_torch.ops import tiled_map as ttm
from fastlivo_tpu_torch.ops.voxel_map import _mix64_np

from torch_frame_cases import (INSERT_CASES, UNDISTORT_CASES, UNDISTORT_GLOBAL_M,
                               UNDISTORT_STAGE_M, VOX, insert_case, undistort_case)

torch.set_num_threads(1)
F32, EMPTY = np.float32, ttm.EMPTY_CHECK


# --- the insert's passes in numpy -------------------------------------------

def keys_model(m, p, valid):
    """tiled_insert_keys, a row at a time: (gkey (B,) int32, rows (5, B))."""
    vs = F32(m["voxel_size"])
    l0, l1, l2 = (int(x) for x in m["log2_dims"])
    B = len(p)
    gkey = np.zeros(B, np.int32)
    rows = np.zeros((5, B), np.int32)
    for i in range(B):
        k = np.floor(p[i] / vs).astype(np.int32)
        t = k >> 3
        cofs = ((k[0] & 7) << 6) | ((k[1] & 7) << 3) | (k[2] & 7)
        d = (((t[0] & ((1 << l0) - 1)) << (l1 + l2)) | ((t[1] & ((1 << l1) - 1)) << l2)
             | (t[2] & ((1 << l2) - 1)))
        chk = np.int32(_mix64_np(t[None])[0] & np.uint32(0x7FFFFFFF))
        e = p[i] - (k.astype(F32) + F32(0.5)) * vs
        d2c = (e[0] * e[0] + e[1] * e[1]) + e[2] * e[2]
        bits = np.array(d2c, F32).view(np.int32)
        gkey[i] = ((int(d) << 9) | int(cofs)) - (1 << 31) if valid[i] else 0
        rows[:4, i] = d, chk, cofs, bits
    return gkey, rows


def key_cell(key):
    """A valid row's sort key -> its dir_idx << 9 | cell."""
    return int(key) + (1 << 31)


FLAG_A, FLAG_P = 1 << 30, 2 << 30  # csrc/lookback.cuh's status words


def count_before(status, t):
    """lookback.cuh's count_before: the warp reads 32 status words a step
    (lane l the word of tile base - l, tile -1 an inclusive 0) and adds
    the values down to the nearest inclusive prefix."""
    total = 0
    for base in range(t - 1, -1, -32):
        words = [status[base - l] if base - l >= 0 else FLAG_P for l in range(32)]
        assert all(w != 0 for w in words)  # every earlier tile has published
        stop = next((l for l, w in enumerate(words) if w & FLAG_P), None)
        total += sum(w & (FLAG_A - 1) for w in words[:32 if stop is None else stop + 1])
        if stop is not None:
            break
    return total


def tiles_model(m, p, rows, sg, order, tile=1024, seed=0):
    """The tiles pass of tiled_insert_tiles as its blocks run: the marking
    blocks, one a tile of `tile` sorted positions (here in a shuffled
    order), stage their positions' keys, rows and distance bits; a thread
    at a directory group's first position walks the group's first cell
    run (on past the block's end, from the sorted arrays, where the run
    goes on) for its least (distance bits, position) and flags that row
    (1 aliased, 2 fresh) from the directory before any write; then the
    ranking blocks, one a tile of `tile` rows in their original order:
    each counts its fresh winners and publishes the count (an aggregate;
    tile 0 an inclusive prefix), and then, in a shuffled order, finds its
    exclusive prefix by look-back over the status words, publishes its
    inclusive prefix, and each of its winners that does not overflow the
    pool writes its entry and its slot's key (a fresh winner's rank:
    n_alloc + prefix + its in-tile inclusive count - 1). Writes m in
    place; returns (n_alloc, n_dropped)."""
    T = len(m["slot_key"])
    vs = F32(m["voxel_size"])
    B = len(p)
    nt = max(1, -(-B // tile))
    rng = np.random.default_rng(seed)
    flag = rows[4]
    for t in rng.permutation(nt):  # the marking blocks, in any order
        r0 = t * tile
        sk = sg[r0:r0 + tile]
        srow = order[r0:r0 + tile]
        sbits = rows[3, srow]
        n = len(sk)
        for x in range(n):
            k = sk[x]
            prev = sk[x - 1] if x else (sg[r0 - 1] if r0 else 0)
            if k >= 0 or (prev < 0 and key_cell(prev) >> 9 == key_cell(k) >> 9):
                continue  # invalid, or not its directory group's first position
            best, row = sbits[x], srow[x]
            y = x + 1
            while y < n and sk[y] == k:
                if sbits[y] < best:
                    best, row = sbits[y], srow[y]
                y += 1
            if y == n:  # past the block's end
                for r in range(r0 + n, B):
                    if sg[r] != k:
                        break
                    if rows[3, order[r]] < best:
                        best, row = rows[3, order[r]], order[r]
            flag[row] = 1 if m["dir_check"][key_cell(k) >> 9] != EMPTY else 2
    slot0 = m["dir_slot"].copy()  # what an aliased winner reads (only it writes its entry)
    counts = [int(np.sum(flag[j * tile:(j + 1) * tile] == 2)) for j in range(nt)]
    status = [FLAG_P | counts[0]] + [FLAG_A | c for c in counts[1:]]
    base, total = int(m["n_alloc"]), None
    for j in [0, *(1 + rng.permutation(nt - 1))]:  # the look-backs, in any order
        excl = count_before(status, j) if j else 0
        status[j] = FLAG_P | (excl + counts[j])
        if j == nt - 1:
            total = excl + counts[j]
        rank = excl
        for i in range(j * tile, min(B, (j + 1) * tile)):
            f, d = flag[i], rows[0, i]
            if not f:
                continue
            rank += f == 2
            new_slot = base + rank - 1
            if f == 2 and new_slot >= T:
                continue
            slot_w = slot0[d] if f == 1 else new_slot
            m["dir_check"][d] = rows[1, i]
            m["dir_slot"][d] = slot_w
            if 0 <= slot_w < T:
                m["slot_key"][slot_w] = np.floor(p[i] / vs).astype(np.int32) >> 3
    return np.int32(min(base + total, T)), np.int32(m["n_dropped"])


def cells_model(m, p, rows, sg, order, n_dropped, tile=1024, seed=0):
    """The cells pass of tiled_insert_tiles as its blocks run, one a tile
    of `tile` sorted positions (here in a shuffled order), after every
    directory write: a block stages its positions' keys, checks, distance
    bits and points; a thread at a (dir_idx, cell) run's first position
    reads the run's directory entry and walks the run (on past the block's
    end, from the sorted arrays, where it goes on): the rows whose check
    is the entry's are ok, the others dropped, and the least (distance
    bits, position) ok row replaces a dead or farther stored cell. Each
    block adds its dropped rows to n_dropped."""
    T = len(m["slot_key"])
    vs = F32(m["voxel_size"])
    B = len(p)
    nt = max(1, -(-B // tile))
    for c in np.random.default_rng(seed).permutation(nt):
        r0 = c * tile
        sk = sg[r0:r0 + tile]
        srow = order[r0:r0 + tile]
        schk, sbits, sp = rows[1, srow], rows[3, srow], p[srow]
        n, dropped = len(sk), 0
        for x in range(n):
            k = sk[x]
            prev = sk[x - 1] if x else (sg[r0 - 1] if r0 else 0)
            if k >= 0 or (r0 + x > 0 and prev == k):
                continue  # invalid, or not its run's first position
            d = key_cell(k) >> 9
            cur, slot = m["dir_check"][d], m["dir_slot"][d]
            best = None  # (distance bits, point)
            y = x
            while y < n and sk[y] == k:
                if schk[y] != cur:
                    dropped += 1
                elif best is None or sbits[y] < best[0]:
                    best = sbits[y], sp[y]
                y += 1
            if y == n:  # past the block's end
                for r in range(r0 + n, B):
                    if sg[r] != k:
                        break
                    w = order[r]
                    if rows[1, w] != cur:
                        dropped += 1
                    elif best is None or rows[3, w] < best[0]:
                        best = rows[3, w], p[w]
            if best is None:
                continue
            cell = int(np.clip(slot, 0, T - 1)) * 512 + (key_cell(k) & 511)
            bits, pw = best
            es = m["pts"][cell] - (np.floor(pw / vs).astype(np.int32).astype(F32)
                                   + F32(0.5)) * vs
            stored = (es[0] * es[0] + es[1] * es[1]) + es[2] * es[2]
            if m["cell_check"][cell] != cur or np.array(bits, np.int32).view(F32) < stored:
                m["cell_check"][cell] = cur
                m["pts"][cell] = pw
        n_dropped = np.int32(n_dropped + dropped)
    return n_dropped


def insert_model(m, p, valid, tile=1024):
    """The keys pass, the stable sort and the second launch's tiles and
    cells passes, on numpy copies of m."""
    m = {k: v.copy() for k, v in m.items()}
    gkey, rows = keys_model(m, p, valid)
    order = np.argsort(gkey, kind="stable")
    sg = gkey[order]
    m["n_alloc"], n_dropped = tiles_model(m, p, rows, sg, order, tile)
    m["n_dropped"] = cells_model(m, p, rows, sg, order, n_dropped, tile)
    return m


def replay(case, step_fn):
    """Runs insert_case(case) on a CPU map, calling step_fn(map before,
    pts, valid, map after) at each insert."""
    dims, pool, steps = insert_case(case)
    m = ttm.empty_tiled_map(dims, pool, VOX, device="cpu")
    for step in steps:
        if step[0] == "compact":
            lo, hi = (torch.from_numpy(b[None]) for b in step[1:])
            m = ttm.compact(ttm.delete_boxes_plain(m, lo, hi))
            n = int(m.n_alloc)
            assert n < pool and bool((m.slot_key[n:] != 0).any())  # stale slots
            continue
        _, p, v = step
        before = convert.tiled_map_to_arrays(m)
        m = ttm.insert(m, torch.from_numpy(p), torch.from_numpy(v))
        step_fn(before, p, v, m)
    return m


@pytest.mark.parametrize("tile", [1024, 7, 1, 32])
@pytest.mark.parametrize("case", INSERT_CASES)
def test_insert_passes_in_numpy_are_insert_plain(case, tile):
    """The kernels' passes, written out in numpy (the second launch with
    its blocks of 1024 rows, and of 1, 7 and 32 so that small batches
    carry ranks across tiles, through the look-back, and runs across
    blocks), give insert_plain's map bit for bit after every batch."""
    def check(before, p, v, m):
        want = insert_model(before, p, v, tile)
        got = convert.tiled_map_to_arrays(m)
        for f in want:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)

    m = replay(case, check)
    if case in ("overflow", "aliasing", "overflow_mid_tile"):
        assert int(m.n_dropped) > 0
    if case in ("overflow", "overflow_mid_tile"):
        assert int(m.n_alloc) == m.slot_key.shape[0]


@pytest.mark.parametrize("case", INSERT_CASES)
def test_insert_plain_passes_match_the_model(case):
    """Each plain pass's outputs (keys and rows; the directory, slot keys
    and counts; the cells) equal the numpy model's; where a run's first
    row is not ok, another row of the run wins its cell."""
    def check(before, p, v, m):
        mt = convert.tiled_map_from_arrays(before, "cpu")
        pt, vt = torch.from_numpy(p), torch.from_numpy(v)
        gkey, rows = ttm.insert_keys_plain(mt, pt, vt)
        mk = {k: x.copy() for k, x in before.items()}
        gk, rk = keys_model(mk, p, v)
        np.testing.assert_array_equal(gkey.numpy(), gk)
        np.testing.assert_array_equal(rows.numpy(), rk)
        sg, order = torch.sort(gkey, stable=True)
        n_alloc, n_dropped = ttm.insert_tiles_plain(mt, pt, rows, sg, order)
        order_np = order.numpy()
        want = tiles_model(mk, p, rk, sg.numpy(), order_np)
        assert (int(n_alloc), int(n_dropped)) == tuple(int(x) for x in want)
        for f in ("dir_check", "dir_slot", "slot_key"):
            np.testing.assert_array_equal(getattr(mt, f).numpy(), mk[f], err_msg=f)
        ttm.insert_cells_plain(mt, pt, vt, rows, sg, order, n_dropped)
        wd = cells_model(mk, p, rk, sg.numpy(), order_np, want[1])
        assert int(n_dropped) == int(wd)
        for f in ("cell_check", "pts"):
            np.testing.assert_array_equal(getattr(mt, f).numpy(), mk[f], err_msg=f)

    m = replay(case, check)
    if case == "head_not_ok":
        # the winning tile's point, second in its run, holds the cell
        p = np.array([[8.9, 0.75, 0.75]], np.float32)
        cpts, found = ttm.knn_candidates(m, torch.from_numpy(p), radius=0)
        assert bool(found[0, 0]) and np.array_equal(cpts[0, 0].numpy(), p[0])


@pytest.mark.parametrize("case", INSERT_CASES)
def test_insert_plain_matches_jax(case):
    dims, pool, steps = insert_case(case)
    mj = jtm.empty_tiled_map(dims, pool, VOX)
    mt = ttm.empty_tiled_map(dims, pool, VOX, device="cpu")
    for step in steps:
        if step[0] == "compact":
            lo, hi = step[1][None], step[2][None]
            mj = jtm.compact(jtm.delete_boxes(mj, jnp.asarray(lo), jnp.asarray(hi)))
            mt = ttm.compact(ttm.delete_boxes_plain(mt, torch.from_numpy(lo),
                                                    torch.from_numpy(hi)))
            continue
        _, p, v = step
        mj = jtm.insert(mj, jnp.asarray(p), jnp.asarray(v))
        mt = ttm.insert_plain(mt, torch.from_numpy(p), torch.from_numpy(v))
        got = convert.tiled_map_to_arrays(mt)
        for f, w in mj._asdict().items():
            np.testing.assert_array_equal(got[f], np.array(w), err_msg=f)


def test_new_insert_cases_cover_tile_ends():
    """The straddle case's second batch has fresh heads on both sides of
    the 1024-row tile ends and aliased heads in the same tiles; the
    overflow_mid_tile case's pool overflows at a fresh head in the middle
    of its second tile."""
    for case in ("straddle", "overflow_mid_tile"):
        heads = []

        def check(before, p, v, m):
            mk = {k: x.copy() for k, x in before.items()}
            gk, rk = keys_model(mk, p, v)
            order = np.argsort(gk, kind="stable")
            tiles_model(mk, p, rk, gk[order], order)
            heads.append((rk[4].copy(), int(before["n_alloc"]), len(before["slot_key"])))

        replay(case, check)
        flag, n_alloc, T = heads[-1]
        fresh = np.nonzero(flag == 2)[0]
        if case == "straddle":
            assert {1020, 1027, 2044, 2051} <= set(fresh.tolist())
            assert (flag[:1024] == 1).any() and (flag[1024:2048] == 1).any()
        else:
            first_over = fresh[T - n_alloc]  # the first fresh head past the pool
            assert 1024 < first_over < 2048 and first_over % 1024 > 32


def test_narrow_key_cases_cover_their_edges():
    """The narrow key's cases hold what they are for: in nearest_later a
    tile winner that is not its run's first row (in both aliasing tiles'
    turns); in equal_bits a first cell run of equal distances; in
    long_run a run of more than 1024 sorted positions across tile ends
    whose nearest row is not ok and lies past the run's first block; in
    dir_2_22 the largest key, -1, of a row in the directory's last cell,
    with invalid rows (key 0) after it."""
    seen = {}

    def flags_of(case):
        out = []

        def check(before, p, v, m):
            mk = {k: x.copy() for k, x in before.items()}
            gk, rk = keys_model(mk, p, v)
            order = np.argsort(gk, kind="stable")
            tiles_model(mk, p, rk, gk[order], order)
            out.append((gk, rk, order))

        replay(case, check)
        return out

    for case in ("nearest_later", "equal_bits", "long_run", "dir_2_22"):
        seen[case] = flags_of(case)
    # nearest_later: the winning tile's nearest row 2 wins the entry over
    # rows 0 and 1, and C's nearest row 5 over row 4
    for gk, rk, order in seen["nearest_later"]:
        assert rk[4, 2] and not rk[4, 0] and not rk[4, 1] and rk[4, 5] and not rk[4, 4]
    assert len({int(rk[1, 2]) for _, rk, _ in seen["nearest_later"]}) == 2
    # equal_bits: equal distance bits in the first batch's run; its first
    # row (B's) wins, then A's first row
    (gk, rk, _), (gk2, rk2, _), _ = seen["equal_bits"]
    assert len(set(gk.tolist())) == 1 and len(set(rk[3].tolist())) == 1
    assert rk[4, 0] > 0 and not rk[4, 1:].any() and rk2[4, 0] > 0 and not rk2[4, 1:].any()
    # long_run: the cell 1 run covers sorted positions 1000-3999
    gk, rk, order = seen["long_run"][0]
    sg = gk[order]
    assert (sg[1000:4000] == sg[1000]).all() and sg[999] != sg[1000] and sg[4000] == 0
    assert order[3899] == 3899 and order[3900] == 3900 and rk[3, 3900] < rk[3, 3899]
    assert rk[1, 3900] != rk[1, 3899]  # the nearer row is B's, not ok once A holds the entry
    # dir_2_22: a row keyed -1 (dir_idx 2^22 - 1, cell 511), invalid rows after it
    for gk, rk, order in seen["dir_2_22"]:
        sg = gk[order]
        assert gk[0] == -1 and rk[0, 0] == (1 << 22) - 1 and rk[2, 0] == 511
        last_valid = int(np.nonzero(sg < 0)[0][-1])
        assert sg[last_valid] == -1 and (sg[last_valid + 1:] == 0).all()
        assert last_valid + 1 < len(sg)


# --- the undistortion -------------------------------------------------------

def search_model(offs, t):
    """csrc/undistort.cu's search over the offsets, staged in shared
    memory (M <= STAGE_M) or in place in global memory (larger M), the
    same probes in both, a point at a time: torch's lower bound (mid = lo
    + ((hi - lo) >> 1), go right while !(offs[mid] >= t))."""
    out = np.empty(len(t), np.int64)
    for i, ti in enumerate(t):
        lo, hi = 0, len(offs)
        while lo < hi:
            mid = lo + ((hi - lo) >> 1)
            if not (offs[mid] >= ti):
                lo = mid + 1
            else:
                hi = mid
        out[i] = lo
    return out


@pytest.mark.parametrize("kind", ["padded", "unsorted", "duplicates", "nan_times"])
@pytest.mark.parametrize("M", [1, 2, 520, UNDISTORT_STAGE_M, 4105, 8200])
def test_shared_memory_search_takes_torchs_probes(M, kind):
    """The kernel's search finds torch.searchsorted's (left) row on any
    table: the plain version's oracle, whatever the offsets' order; in
    shared memory up to UNDISTORT_STAGE_M rows, and the same search in
    global memory past it (4105, 8200: max_imu_per_group 1024)."""
    rng = np.random.default_rng(M + len(kind))
    n_live = max(1, (3 * M) // 4)
    offs = np.full(M, np.float32(1e30), np.float32)  # BIG_T padding
    offs[:n_live] = np.sort(rng.uniform(-0.004, 0.1, n_live)).astype(np.float32)
    if kind == "unsorted":
        offs = rng.permutation(offs)
    if kind == "duplicates":
        offs[:n_live] = np.repeat(offs[:n_live:3], 3)[:n_live]
    t = np.concatenate([rng.uniform(-0.01, 0.12, 600), offs[:50],
                        [np.float32(1e30), np.inf, -np.inf]]).astype(np.float32)
    if kind == "nan_times":
        t[::7] = np.nan
    want = torch.searchsorted(torch.from_numpy(offs), torch.from_numpy(t), right=False)
    np.testing.assert_array_equal(search_model(offs, t), want.numpy())


def test_undistort_table_limit_is_the_pipelines():
    """The kernel's shared-memory stage (csrc/undistort.cu's STAGE_M) is
    imu.UNDISTORT_STAGE_M, a size and no longer a limit: the shipped
    configuration's table fits the stage, 512 is the largest group size
    whose table still fits it, and the tables past it (513, 1024) are
    the global layout's test cases; the wrapper refuses no table the
    kernel's int rows hold."""
    from fastlivo_tpu_torch.config import CapacityConfig, Config
    from fastlivo_tpu_torch.ops import _build
    from fastlivo_tpu_torch.pipeline import Pipeline

    src = (_build.CSRC / "undistort.cu").read_text()
    assert f"constexpr int STAGE_M = {timu.UNDISTORT_STAGE_M};" in src
    assert "MAX_M" not in src and "M <= STAGE_M" in src
    assert timu.UNDISTORT_STAGE_M == UNDISTORT_STAGE_M
    assert not hasattr(timu, "UNDISTORT_MAX_M")
    sizes = {}
    for per_group in (Config().capacity.max_imu_per_group, 512, 513, 1024):
        cfg = Config()
        cfg.img_enable = False
        cfg.capacity = CapacityConfig(max_points=256, max_raw_points=512,
                                      tiled_dir_dims=(4, 4, 4), tiled_pool=8,
                                      max_imu_per_group=per_group)
        sizes[per_group] = Pipeline(cfg, device="cpu").max_scan_poses
    assert sizes[64] == 520 <= timu.UNDISTORT_STAGE_M
    assert sizes[512] == timu.UNDISTORT_STAGE_M < sizes[513]
    assert sizes[513] == UNDISTORT_GLOBAL_M["table_513"]
    assert sizes[1024] == UNDISTORT_GLOBAL_M["table_1024"]


def test_lookback_header_serves_both_kernels(tmp_path, monkeypatch):
    """csrc/lookback.cuh is included by voxel_centroids.cu,
    tiled_insert.cu and (since the hash insert's heads are written by
    look-back) hash_insert.cu, and an edit of it changes those libraries'
    tags (so they rebuild), not the others'."""
    import shutil

    from fastlivo_tpu_torch.ops import _build

    users = sorted(n for n in _build.SOURCES
                   if '#include "lookback.cuh"' in (_build.CSRC / f"{n}.cu").read_text())
    assert users == ["hash_insert", "tiled_insert", "voxel_centroids"]
    before = {n: _build.library_path(n).name for n in _build.SOURCES}
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    (csrc / "lookback.cuh").write_text((csrc / "lookback.cuh").read_text() + "\n// edit\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    after = {n: _build.library_path(n).name for n in _build.SOURCES}
    assert sorted(n for n in before if before[n] != after[n]) == users


def undistort_inputs(d, pose_dtype=np.float32):
    """(JAX args, port args on the CPU) of undistort_case's dict."""
    zeros = np.zeros(3)
    sj = jstate.identity_state()._replace(rot=jnp.asarray(d["state_rot"]),
                                          pos=jnp.asarray(d["state_pos"]))
    st = convert.state_from_arrays({k: np.array(v) for k, v in sj._asdict().items()}, "cpu")
    fields = ("offs", "rot", "pos", "vel", "acc", "gyr")
    pj = jimu.PoseTable(*(jnp.asarray(d[f]) for f in fields))
    pt = timu.PoseTable(*(torch.from_numpy(d[f].astype(pose_dtype)) for f in fields))
    cal = dict(acc_scale=np.float32(1.0), cov_acc=zeros, cov_gyr=zeros, cov_bias_acc=zeros,
               cov_bias_gyr=zeros, lid_rot=d["lid_rot"], lid_off=d["lid_off"])
    cj = jimu.ImuCalib(**{k: jnp.asarray(np.asarray(v, np.float32)) for k, v in cal.items()})
    ct = timu.ImuCalib(**{k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in cal.items()})
    rest = [d["pts"], d["t_rel"], d["pmask"]]
    return ((sj, pj, *map(jnp.asarray, rest), cj),
            (st, pt, *map(torch.from_numpy, rest), ct))


@pytest.mark.parametrize("case", UNDISTORT_CASES)
def test_undistort_plain_matches_jax(case):
    d = undistort_case(case)
    ja, ta = undistort_inputs(d)
    want = np.asarray(jimu.undistort(*ja))
    got = timu.undistort_plain(*ta)
    bits = lambda x: x.view(torch.int32)  # noqa: E731  (NaN rows compare equal)
    assert torch.equal(bits(timu.undistort(*ta)), bits(got))  # the CPU: the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    pm = d["pmask"]
    assert np.array_equal(got.numpy()[~pm].view(np.int32), d["pts"][~pm].view(np.int32))
    assert np.isfinite(got.numpy()[pm]).all()
    # an f64 pose table (the views of a pose pack) is cast where it is read
    _, t64 = undistort_inputs(d, np.float64)
    assert torch.equal(bits(timu.undistort_plain(*t64)), bits(got))
    if case == "small_angle":
        phi = d["gyr"].astype(np.float64) * 0.12
        assert (np.sum(phi * phi, axis=1) < 1e-12).all()


def test_frame_kernel_wrappers_refuse_other_devices():
    m = ttm.empty_tiled_map((2, 2, 2), 4, VOX, device="cpu")
    m = type(m)(*(t.to("meta") for t in m))
    p = torch.zeros((8, 3), device="meta")
    v = torch.ones(8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        ttm.insert(m, p, v)
    with pytest.raises(ValueError):
        ttm.insert_keys(m, p, v)
    d = undistort_case("scan")
    _, ta = undistort_inputs(d)
    meta = [type(x)(*(t.to("meta") for t in x)) if isinstance(x, tuple) else x.to("meta")
            for x in ta]
    with pytest.raises(ValueError):
        timu.undistort(*meta)
