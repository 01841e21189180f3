"""Port parity: the voxel filter's sort and the camera cloud's dedup, as the
card's kernels decompose them, on the CPU.

The voxel filter's keys and their stable sort run on the card as one
cooperative launch of csrc/voxel_keys.cu (`ops/voxel_filter.voxel_sort`):
the packed keys, each field's extremes over the valid rows (atomic maxima
of f + 1 and 2^20 - f a tile), a compact rank r = ((fx - min_x) R_y + (fy -
min_y)) R_z + (fz - min_z) (R_x R_y R_z for an invalid row), and stable
8-bit LSD radix passes over it, as many as r's bit length needs, each
block ranking its consecutive tiles' rows in order, each digit based at
the counts of every block's earlier digits and of the earlier blocks' same
digit. Each pass's counts are published by their blocks as count + 1 in
the pass's histogram row (two buffers, pass p's the (p % 2)-th) and read
by the others, who wait while a word is 0; a block zeroes its row of the
buffer read one pass back, the last block the last pass's buffer. Its
plain version `_sorted_keys_plain` (voxel_keys_plain and torch's stable
sort) is what the CPU runs. Here, in numpy: the rank orders and ties the
rows as the packed key does (tests/torch_camera_stage_cases.py's key
cases: the LIO scan, the camera cloud, NaN and inf rows, wrapping
coordinates, no valid row, one row, a spread past 2^32, ranks of exactly
8, 16 and 24 bits); the passes give torch.sort(stable=True)'s permutation
bit for bit with one and four 1024-row tiles a block and N from 0 to
98304 (1025: one past a tile), every published row seen by its readers,
the histogram buffers back at 0; the filter on the modelled sort equals
the JAX package's voxel_downsample_device.

The camera cloud's dedup (csrc/vio_dedup.cu, `ops/vio_dedup.vio_dedup`)
sets its table once: round p's contenders take the maximum of ((p + 1) <<
29) | (2^29 - 1 - row), so each contender reads its own round's lowest row
at its slot; the rounds stop when no row contends; the kept rows (winners
and leftovers) are compacted by one scan over (tile of 1024 rows, warp)
counts and each row's rank in its warp's ballot. The model of those rules
gives `_dedup_voxels_plain`'s vox and vmask and the JAX package's
_dedup_voxels bit for bit on the dedup cases.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastlivo_tpu import vio as jvio
from fastlivo_tpu.ops import voxel_filter as jvf

from fastlivo_tpu_torch import vio as tvio
from fastlivo_tpu_torch.ops import vio_dedup
from fastlivo_tpu_torch.ops import voxel_filter as tvf

import torch_camera_stage_cases as cases

torch.set_num_threads(1)

INVALID = 1 << 62
M20 = 0xFFFFF
TILE = 1024  # the sort's tile: 256 threads, 4 rows each
DIGITS = 256


def keys_of(case, n=None):
    """The packed keys (numpy int64) of a key case (its first n rows, or
    the LIO scan tiled with offsets to n rows), and its arguments."""
    p, valid, leaf, inv = cases.keys_case(case)
    if n is not None and n > len(p):
        reps = -(-n // len(p))
        p = np.concatenate([p + np.float32(100.0 * k) for k in range(reps)])[:n]
        valid = np.tile(valid, reps)[:n]
    elif n is not None:
        p, valid = p[:n], valid[:n]
    lf = None if leaf is None else torch.tensor(leaf, dtype=torch.float32)
    iv = None if inv is None else torch.tensor(inv, dtype=torch.float32)
    args = (torch.from_numpy(np.ascontiguousarray(p)), torch.from_numpy(valid), lf, iv)
    return tvf.voxel_keys_plain(*args).numpy(), args


def span_by_tiles(keys, tile):
    """The kernel's header after its first barrier: per block (`tile`
    rows) the maxima of
    f + 1 and 2^20 - f of each field over its valid rows and its invalid
    flag (0 where it has none), combined by maxima in any order. Returns
    (lo (3,), R (3,), has_invalid, passes, bits) or None without a valid
    row (then 0 passes)."""
    hi, low, inv = np.zeros(3, np.int64), np.zeros(3, np.int64), 0
    for t0 in np.random.default_rng(tile).permutation(max(1, -(-len(keys) // tile))):
        k = keys[t0 * tile:(t0 + 1) * tile]
        vs = k != INVALID
        inv = max(inv, int((~vs).any()))
        if vs.any():
            f = np.stack([(k[vs] >> 40) & M20, (k[vs] >> 20) & M20, k[vs] & M20])
            hi = np.maximum(hi, f.max(1) + 1)
            low = np.maximum(low, (1 << 20) - f.min(1))
    if hi[0] == 0:
        return None
    lo = (1 << 20) - low
    R = hi - lo
    rmax = int(R[0]) * int(R[1]) * int(R[2]) - (0 if inv else 1)
    bits = rmax.bit_length()
    return lo, R, inv, -(-bits // 8), bits


def rank_of(keys, span):
    """The compact rank (uint64) of the packed keys."""
    lo, R = span[0], span[1]
    vs = keys != INVALID
    f = [((keys >> s) & M20) - lo[q] for q, s in enumerate((40, 20, 0))]
    f = [np.where(vs, x, 0).astype(np.uint64) for x in f]
    r = (f[0] * np.uint64(R[1]) + f[1]) * np.uint64(R[2]) + f[2]
    return np.where(vs, r, np.uint64(int(R[0]) * int(R[1]) * int(R[2])))


@pytest.mark.parametrize("case", cases.KEYS_CASES)
def test_compact_rank_orders_and_ties_as_the_key(case):
    """Sorted by the packed key, the rank never decreases and two
    neighbours' ranks are equal exactly where their keys are: the rank
    orders and ties the rows as the key does, on every key case (wrapped
    fields, NaN, inf and invalid rows at the marker, no valid row, one
    row, a spread past 2^32); the header's maxima give the extremes of
    the valid fields; sort_span_plain (the smoke run's report) agrees."""
    keys, _ = keys_of(case)
    span = span_by_tiles(keys, 1024)
    assert tvf.sort_span_plain(torch.from_numpy(keys)) == (
        (0, 0) if span is None else (span[4], span[3]))
    if span is None:  # no valid row: every rank equal, the identity
        assert case == "all_invalid" and (keys == INVALID).all()
        return
    vs = keys != INVALID
    f = np.stack([(keys[vs] >> 40) & M20, (keys[vs] >> 20) & M20, keys[vs] & M20])
    np.testing.assert_array_equal(span[0], f.min(1))
    np.testing.assert_array_equal(span[1], f.max(1) - f.min(1) + 1)
    r = rank_of(keys, span)
    o = np.argsort(keys, kind="stable")
    rk, kk = r[o], keys[o]
    assert (rk[1:] >= rk[:-1]).all()
    np.testing.assert_array_equal(rk[1:] == rk[:-1], kk[1:] == kk[:-1])
    np.testing.assert_array_equal(np.argsort(r, kind="stable"), o)
    assert int(r.max()).bit_length() == span[4]
    if case == "spread":
        assert span[4] > 32 and span[3] == 5
    if case == "wrap":  # a field over its whole 20 bits
        assert int(span[1].max()) == 1 << 20 and span[3] >= 7
    if case == "n1":
        assert span[3] == 0
    if case in ("lio", "camera"):  # 160 and 400 voxels a side
        assert span[4] in (22, 26) and span[3] == (3 if case == "lio" else 4)
    if case in cases.BITS_RANGES:  # exactly a digit boundary
        np.testing.assert_array_equal(span[1], cases.BITS_RANGES[case])
        assert span[4] == int(case[4:]) and span[3] == span[4] // 8


def sort_by_passes(keys, tile):
    """The kernel's sort in numpy, a block `tile` consecutive positions
    (its tiles of 1024 ranked in order, one running base a digit): (sorted
    keys, order, the histogram buffers after the launch). In pass p every
    block ranks its rows and publishes each digit's count + 1 in its row of
    buffer p % 2, which must be 0 until then, and zeroes its row of the
    buffer read one pass back; the readers take the row less 1 (the true
    counts); the last block zeroes the last pass's buffer."""
    n = len(keys)
    G = max(1, -(-n // tile))
    span = span_by_tiles(keys, tile)
    rows = np.arange(n)
    bufs = np.zeros((2, G, DIGITS), np.int64)
    if span is None or span[3] == 0:
        return keys.copy(), rows, bufs
    passes = span[3]
    cur_k, cur_r = keys.copy(), rows.copy()

    def digits(k, p):
        return ((rank_of(k, span) >> np.uint64(8 * p)) & np.uint64(DIGITS - 1)).astype(np.int64)

    pos = np.arange(n)
    b = pos // tile
    for p in range(passes):
        d = digits(cur_k, p)
        true = np.zeros((G, DIGITS), np.int64)
        np.add.at(true, (b, d), 1)
        assert not bufs[p % 2].any()  # zeroed a pass before (or never written)
        bufs[p % 2] = true + 1  # each block's row published
        if p > 0:
            bufs[(p + 1) % 2] = 0  # each block's row read one pass back
        H = bufs[p % 2] - 1  # what the readers take
        before = np.cumsum(H, 0) - H  # the same digit in earlier tiles
        total = H.sum(0)
        base = np.cumsum(total) - total  # earlier digits in every tile
        grp = b * DIGITS + d
        o = np.argsort(grp, kind="stable")  # in-tile order within each (tile, digit)
        start = np.r_[0, np.flatnonzero(grp[o][1:] != grp[o][:-1]) + 1]
        within = np.empty(n, np.int64)
        within[o] = np.arange(n) - np.repeat(start, np.diff(np.r_[start, n]))
        dst = base[d] + before[b, d] + within
        assert np.array_equal(np.sort(dst), pos)
        nk, nr = np.empty_like(cur_k), np.empty_like(cur_r)
        nk[dst], nr[dst] = cur_k, cur_r
        cur_k, cur_r = nk, nr
    bufs[(passes - 1) % 2] = 0  # the last block
    return cur_k, cur_r, bufs


SORT_SIZES = [(c, None) for c in cases.KEYS_CASES] + [
    ("lio", n) for n in (0, 1, 33, 1025, 4096, 98304)]


@pytest.mark.parametrize("tiles", [1, 4])
@pytest.mark.parametrize("case,n", SORT_SIZES,
                         ids=[c if n is None else f"{c}_{n}" for c, n in SORT_SIZES])
def test_radix_passes_give_the_stable_sort(case, n, tiles):
    """The passes with the pass count the device chooses, with one tile of
    1024 rows a block (the main path's) or four (past what the card holds
    at once), give torch.sort(stable=True)'s keys and permutation bit for
    bit, the histograms read by each pass are the blocks' counts, and the
    scratch's buffers are back at 0."""
    keys, _ = keys_of(case, n)
    got_k, got_o, bufs = sort_by_passes(keys, TILE * tiles)
    want = torch.sort(torch.from_numpy(keys), stable=True)
    np.testing.assert_array_equal(got_k, want[0].numpy())
    np.testing.assert_array_equal(got_o, want[1].numpy())
    assert not bufs.any()


@pytest.mark.parametrize("case", cases.KEYS_CASES)
def test_filter_on_the_modelled_sort_matches_jax(case):
    """The device filter with the modelled sort's keys and order (what the
    launch hands voxel_centroids) against the JAX package's
    voxel_downsample_device: masks equal, centroids within the 1e-6 of
    test_voxel_filter_key_pass_matches_jax; the CPU's voxel_sort and
    _sorted_keys are the plain version and count no launch."""
    keys, (pts, valid, lf, iv) = keys_of(case)
    n0 = tvf.voxel_sort.launches
    k_cpu, o_cpu = tvf.voxel_sort(pts, valid, lf, iv)
    k2, o2 = tvf._sorted_keys(pts, valid, lf, iv)
    assert tvf.voxel_sort.launches == n0
    plain = tvf._sorted_keys_plain(pts, valid, lf, iv)
    for a, b in ((k_cpu, plain[0]), (o_cpu, plain[1]), (k2, plain[0]), (o2, plain[1])):
        assert torch.equal(a, b)
    sk, so, _ = sort_by_passes(keys, 1024)
    p3 = pts[:, :3].contiguous()
    max_out = 16384
    ot, mt = tvf.voxel_centroids_plain(torch.from_numpy(sk), torch.from_numpy(so), p3, max_out)
    if iv is None:
        oj, mj = jvf.voxel_downsample_device(jnp.asarray(p3.numpy()), jnp.asarray(valid.numpy()),
                                             jnp.float32(float(lf)), max_out)
    else:
        import jax

        oj, mj = jax.jit(lambda a, v: jvf.voxel_downsample_device(a, v, 0.2, max_out))(
            jnp.asarray(p3.numpy()), jnp.asarray(valid.numpy()))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    fin = np.isfinite(ot.numpy()).all(axis=1) & mt.numpy()
    np.testing.assert_allclose(ot.numpy()[fin], np.asarray(oj)[fin], rtol=1e-6, atol=1e-6)
    if case == "bits8":  # every voxel of the 4 x 8 x 8 range holds rows
        assert int(mt.sum()) == 256
    elif case not in ("all_invalid", "n1"):
        assert int(mt.sum()) > 1000


def test_voxel_sort_refuses_other_devices():
    """voxel_sort takes the CPU (its plain version) or CUDA (its kernel),
    nothing else: a meta tensor raises before any launch."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tvf.voxel_sort(torch.zeros((4, 3), device=meta),
                       torch.ones(4, dtype=torch.bool, device=meta),
                       torch.tensor(0.5, device=meta), None)


# --- the camera cloud's voxel dedup ----------------------------------------

ROW_MASK = (1 << 29) - 1


def dedup_tagged(p, mask, max_vox, threads=1024, seed=0):
    """The kernel's rules in numpy: the table set once to 0; in round p
    each contender takes the maximum of ((p + 1) << 29) | (ROW_MASK -
    row) at (h + p) & (TB - 1), the atomics in a random order; each
    contender then reads its slot (always its own round's entry) and is a
    winner (its own row), resolved (another row of its key) or contends
    again; the rounds stop when no row contends. The kept rows (winners
    and leftovers), row r = k * threads + t in tile k, warp t // 32, lane
    t % 32, are ranked by the exclusive scan of the (tile, warp) counts in
    tile-major order plus the row's rank among its warp's kept lanes.
    Returns (vox, vmask, rounds run, leftover rows)."""
    rng = np.random.default_rng(seed)
    M = len(p)
    assert M < 1 << 28  # the wrapper's limit: row ids below the round tag
    keys = np.floor(p / np.float32(0.5)).astype(np.int32)
    TB = 1 << M.bit_length()
    h = cases.voxel_hash(keys, TB)
    contend, winner = mask.copy(), np.zeros(M, bool)
    table = np.zeros(TB, np.int64)
    rounds = 0
    for rnd in range(4):
        c = np.flatnonzero(contend)
        slots = (h[c] + rnd) & (TB - 1)
        perm = rng.permutation(len(c))
        np.maximum.at(table, slots[perm], (((rnd + 1) << 29) | (ROW_MASK - c))[perm])
        v = table[slots]
        assert ((v >> 29) == rnd + 1).all()  # a current-round entry, never a stale one
        w = ROW_MASK - (v & ROW_MASK)
        win = w == c
        same = ~win & (keys[w] == keys[c]).all(axis=1)
        winner[c[win]] = True
        contend[c[win | same]] = False
        rounds += 1
        if not contend.any():
            break
    keep = contend | winner
    per = -(-M // threads)
    kp = np.zeros(per * threads, bool)
    kp[:M] = keep
    tiles = kp.reshape(per, threads // 32, 32)  # [tile, warp, lane]: row order
    cnt = tiles.sum(2)
    off = (np.cumsum(cnt.ravel()) - cnt.ravel()).reshape(cnt.shape)
    in_warp = np.cumsum(tiles, 2) - tiles
    rank = (off[:, :, None] + in_warp).ravel()[:M]
    vox = np.zeros((max_vox, 3), np.int32)
    vmask = np.zeros(max_vox, bool)
    ok = keep & (rank < max_vox)
    vox[rank[ok]] = keys[ok]
    vmask[rank[ok]] = True
    return vox, vmask, rounds, int(contend.sum())


@pytest.mark.parametrize("case", cases.DEDUP_CASES)
def test_dedup_round_tagged_table_and_one_scan(case):
    """The round-tagged table (set once) and the one-scan compaction give
    _dedup_voxels_plain's vox and vmask and the JAX package's
    _dedup_voxels bit for bit: the camera cloud (8192 rows into 4096), the
    small run's, slot chains longer than four probes (leftovers kept),
    duplicates, overflow, nothing masked in, 5000 rows (not a multiple of
    1024), 20000, 24576 and 40000 rows; the CPU's vio_dedup is the plain
    version and counts no launch."""
    p, mask, max_vox = cases.dedup_case(case)
    pt, mk = torch.from_numpy(p), torch.from_numpy(mask)
    n0 = vio_dedup.vio_dedup.launches
    vt, kt = tvio._dedup_voxels_plain(pt, mk, max_vox)
    v2, k2 = vio_dedup.vio_dedup(pt, mk, max_vox)
    assert vio_dedup.vio_dedup.launches == n0
    assert torch.equal(v2, vt) and torch.equal(k2, kt)
    vox, vmask, rounds, left = dedup_tagged(p, mask, max_vox, seed=len(case))
    np.testing.assert_array_equal(vox, vt.numpy())
    np.testing.assert_array_equal(vmask, kt.numpy())
    vj, kj = jvio._dedup_voxels(jnp.asarray(p), jnp.asarray(mask), max_vox)
    np.testing.assert_array_equal(vox, np.asarray(vj))
    np.testing.assert_array_equal(vmask, np.asarray(kj))
    if case == "chain":
        assert left > 0 and rounds == 4
    if case == "all_masked":
        assert rounds == 1 and not vmask.any()
