"""Port parity: the tiled insert's keys and stable sort as the card's
kernel decomposes them, on the CPU.

On a CUDA map `ops/tiled_map.insert` is two launches of
csrc/tiled_insert.cu: `insert_sort` (tiled_insert_sort: the keys and the
rows' values, then a stable sort of the keys) and `insert_tiles` (the
tiles and cells passes). The sort's launch reduces, over the valid rows,
each wrapped directory field's min and max and (for a field of at most
8192 values) its occupancy bitmap, by integer atomics a block; after a
grid barrier it ranks a valid key ((g_x R_y + g_y) R_z + g_z) 512 + cell,
g_q the count of occupied values of field q below the key's (f - min for
a wider field), R_q their count, and an invalid key R_x R_y R_z 512; then
stable 8-bit LSD radix passes over that rank (csrc/radix_passes.cuh, the
voxel filter's), as many as its bit length needs. The rank's low byte is
the key's cell byte (0 for an invalid key), so pass 0's counts are
published before the first barrier; every pass's counts go into the
pass's histogram row of each block as count + 1 (two buffers), read by
the others, who wait while a word is 0. Its plain version
`insert_sort_plain` (insert_keys_plain and torch's stable sort) is what the
CPU runs. Here, in numpy, on tests/torch_insert_sort_cases.py's batches
(the LIO path's shape about the world origin, where every axis straddles
the directory's wrap; the room away from it; a wrap in one axis; no valid
row; one row; no rows; a directory of 2^22 entries; a field of 16384
values; runs of equal keys):

  - the rank, from the blocks' extremes and bitmaps combined in any
    order, orders and ties the rows exactly as the 32-bit key does, and
    insert_span_plain (the smoke run's report) gives its bits and passes;
  - the passes, a block one or four 512-row tiles, give
    torch.sort(stable=True)'s keys and permutation bit for bit, B from 0
    to 65536 (513: one past a tile), pass 0's digit computed from the key
    alone is the rank's, every published row is seen by its readers, and
    the two histogram buffers end at 0; ranks of exactly 16 and 24 bits;
  - the tiles and cells passes on the modelled sort (insert_sorted_plain)
    leave the map equal to the JAX package's insert, field by field,
    batch after batch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastlivo_tpu.ops import tiled_map as jtm

from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch.ops import tiled_map as ttm

import torch_insert_sort_cases as cases

torch.set_num_threads(1)

KEY_BIAS = 1 << 31
TILE = 512  # the sort's tile: 256 threads, 2 rows each
DIGITS = 256
DENSE_BITS = 8192
DENSE_WORDS = DENSE_BITS // 32
FIELD_OFF = 1 << 22


def keys_of(dims, p, v):
    """The plain key pass's keys (numpy int32) and rows on an empty map of
    `dims`."""
    m = ttm.empty_tiled_map(dims, 4, cases.VOX, device="cpu")
    gkey, rows = ttm.insert_keys_plain(m, torch.from_numpy(p), torch.from_numpy(v))
    return gkey.numpy(), rows.numpy()


def fields_of(keys, dims):
    """The three wrapped tile fields of each key's directory index (valid
    keys only)."""
    l0, l1, l2 = (int(np.log2(d)) for d in dims)
    d = (keys.astype(np.int64) + KEY_BIAS) >> 9
    return [d >> (l1 + l2), (d >> l2) & ((1 << l1) - 1), d & ((1 << l2) - 1)]


def span_by_blocks(keys, dims, block, seed=0):
    """The kernel's header after its first barrier: per block (`block`
    consecutive rows) the maxima of f + 1 and of 2^22 - f of each field
    over its valid rows, its invalid flag and each dense field's bitmap
    (DENSE_WORDS uint32 words), combined by maxima and ORs in a random
    order; then each dense field's prefix popcounts. Returns None without
    a valid row (0 passes), else a dict of the rank's parameters, its bits
    and passes."""
    dense = [d <= DENSE_BITS for d in dims]
    hi, low, inv = np.zeros(3, np.int64), np.zeros(3, np.int64), 0
    bm = np.zeros((3, DENSE_WORDS), np.uint32)
    nblocks = max(1, -(-len(keys) // block))
    for b in np.random.default_rng(seed).permutation(nblocks):
        k = keys[b * block:(b + 1) * block]
        vs = k < 0
        inv = max(inv, int((~vs).any()))
        if not vs.any():
            continue
        f = fields_of(k[vs], dims)
        for q in range(3):
            hi[q] = max(hi[q], int(f[q].max()) + 1)
            low[q] = max(low[q], FIELD_OFF - int(f[q].min()))
            if dense[q]:
                np.bitwise_or.at(bm[q], f[q] >> 5, (np.uint32(1) << (f[q] & 31).astype(
                    np.uint32)))
    if hi[0] == 0:
        return None
    lo = FIELD_OFF - low
    pop = np.array([[bin(int(w)).count("1") for w in row] for row in bm], np.int64)
    pre = np.cumsum(pop, 1) - pop
    R = [int(pop[q].sum()) if dense[q] else int(hi[q] - lo[q]) for q in range(3)]
    rinv = R[0] * R[1] * R[2] * 512
    bits = (rinv if inv else rinv - 1).bit_length()
    return dict(lo=lo, bm=bm, pre=pre, dense=dense, R=R, rinv=rinv, bits=bits,
                passes=-(-bits // 8), dims=dims)


def rank_of(keys, span):
    """The compact rank (uint64) of the keys, from the header as the
    kernel reads it: a dense field by its bitmap's prefix popcount below
    the value, a wide one by its offset from the least."""
    vs = keys < 0
    f = fields_of(np.where(vs, keys, -1), span["dims"])
    g = []
    for q in range(3):
        if span["dense"][q]:
            w = f[q] >> 5
            below = span["bm"][q][w] & ((np.uint32(1) << (f[q] & 31).astype(np.uint32))
                                        - np.uint32(1))
            pc = np.array([bin(int(x)).count("1") for x in below], np.int64)
            g.append(span["pre"][q][w] + pc)
        else:
            g.append(f[q] - span["lo"][q])
    cell = (keys.astype(np.int64) + KEY_BIAS) & 511
    r = ((g[0] * span["R"][1] + g[1]) * span["R"][2] + g[2]) * 512 + cell
    return np.where(vs, r, span["rinv"]).astype(np.uint64)


def sort_by_passes(keys, block, span):
    """The kernel's sort in numpy, a block `block` consecutive positions
    (its tiles of 512 ranked in order, one running base a digit): (sorted
    keys, order, the histogram buffers after the launch). Pass 0's digit,
    the key's cell byte (0 for an invalid key), must be the rank's low
    byte: each block publishes its count of it (+ 1) in its row of buffer 0
    before the first barrier, also where no pass follows (no valid row: the
    block then zeroes its row). In pass p > 0 every block publishes its
    count + 1 in its row of buffer p % 2, which must be 0 until then, and
    zeroes its row of the buffer read one pass back; the readers take the
    row less 1 (the true counts); the last block zeroes the last pass's
    buffer."""
    n = len(keys)
    G = max(1, -(-n // block))
    rows = np.arange(n)
    bufs = np.zeros((2, G, DIGITS), np.int64)
    pos = np.arange(n)
    b = pos // block
    digit0 = np.where(keys < 0, (keys.astype(np.int64) + KEY_BIAS) & 255, 0)
    np.add.at(bufs[0], (b, digit0), 1)
    bufs[0] += 1  # published in the keys phase
    if span is None or span["passes"] == 0:
        bufs[0] = 0  # each block's own row, in the identity's branch
        return keys.copy(), rows, bufs
    passes = span["passes"]
    cur_k, cur_r = keys.copy(), rows.copy()

    def digits(k, p):
        return ((rank_of(k, span) >> np.uint64(8 * p)) & np.uint64(DIGITS - 1)).astype(np.int64)

    np.testing.assert_array_equal(digit0, digits(cur_k, 0))
    for p in range(passes):
        d = digits(cur_k, p)
        true = np.zeros((G, DIGITS), np.int64)
        np.add.at(true, (b, d), 1)
        if p > 0:
            assert not bufs[p % 2].any()  # zeroed a pass before (or never written)
            bufs[p % 2] = true + 1  # each block's row published
            bufs[(p + 1) % 2] = 0  # each block's row read one pass back
        H = bufs[p % 2] - 1  # what the readers take
        np.testing.assert_array_equal(H, true)
        before = np.cumsum(H, 0) - H  # the same digit in earlier blocks
        total = H.sum(0)
        base = np.cumsum(total) - total  # earlier digits in every block
        grp = b * DIGITS + d
        o = np.argsort(grp, kind="stable")  # in-block order within each (block, digit)
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


def case_keys(case):
    dims, _, batches = cases.sort_case(case)
    return dims, [keys_of(dims, p, v)[0] for p, v in batches]


@pytest.mark.parametrize("case", cases.CASES)
def test_compact_rank_orders_and_ties_as_the_key(case):
    """Sorted by the key, the rank never decreases and two neighbours'
    ranks are equal exactly where their keys are, on every batch of every
    case (wrapped fields, invalid rows at the top, no valid row, one row,
    no rows, a 2^22-entry directory, a field ranked by its range, equal
    keys); its stable argsort is the key's; the largest rank the launch
    counts its passes for (R_x R_y R_z 512, less one without an invalid
    row) bounds it; insert_span_plain gives those bits and passes. About the world origin (the LIO path's batches) the
    occupancy rank takes 2 passes where the fields' ranges would take 4;
    a field ranked by its range across the wrap spans it whole."""
    dims, keys = case_keys(case)
    for k in keys:
        span = span_by_blocks(k, dims, TILE)
        m = ttm.empty_tiled_map(dims, 4, cases.VOX, device="cpu")
        assert ttm.insert_span_plain(m, torch.from_numpy(k)) == (
            (0, 0) if span is None else (span["bits"], span["passes"]))
        if span is None:  # no valid row: every rank equal, the identity
            assert not (k < 0).any()
            continue
        r = rank_of(k, span)
        o = np.argsort(k, kind="stable")
        rk, kk = r[o], k[o]
        assert (rk[1:] >= rk[:-1]).all()
        np.testing.assert_array_equal(rk[1:] == rk[:-1], kk[1:] == kk[:-1])
        np.testing.assert_array_equal(np.argsort(r, kind="stable"), o)
        inv = bool((k >= 0).any())
        assert int(r.max()) <= span["rinv"] - (0 if inv else 1)
        assert span["bits"] == (span["rinv"] - (0 if inv else 1)).bit_length()
        if case == "lio":
            f = fields_of(k[k < 0], dims)
            assert all(int(x.max() - x.min()) + 1 == d for x, d in zip(f, dims))  # wraps
            assert span["R"] == [4, 4, 2] and span["passes"] == 2
        if case == "wide_field":
            assert not span["dense"][0] and span["R"][0] == 16384 and span["passes"] == 4
        if case == "n1":
            assert span["bits"] == 9 and span["passes"] == 2
        if case in cases.BITS_TILES:  # exactly a digit boundary
            assert span["R"] == list(cases.BITS_TILES[case])
            assert span["bits"] == int(case[4:]) and span["passes"] == span["bits"] // 8


SORT_SIZES = [(c, None) for c in cases.CASES] + [("lio", n) for n in (1, 33, 513, 1025,
                                                                      65536)]


@pytest.mark.parametrize("tiles", [1, 4])
@pytest.mark.parametrize("case,n", SORT_SIZES,
                         ids=[c if n is None else f"{c}_{n}" for c, n in SORT_SIZES])
def test_passes_give_torch_stable_sort(case, n, tiles):
    """The modelled passes, a block `tiles` consecutive 512-row tiles,
    give torch.sort(stable=True)'s sorted keys and permutation bit for
    bit, and the histogram buffers end back at 0."""
    dims, _, batches = cases.sort_case(case)
    if n is not None:
        batches = [cases.resized(*batches[0], n)]
    for p, v in batches:
        k = keys_of(dims, p, v)[0]
        span = span_by_blocks(k, dims, tiles * TILE, seed=tiles)
        sk, order, bufs = sort_by_passes(k, tiles * TILE, span)
        want_k, want_o = torch.sort(torch.from_numpy(k), stable=True)
        np.testing.assert_array_equal(sk, want_k.numpy())
        np.testing.assert_array_equal(order, want_o.numpy())
        assert not bufs.any()
        assert ttm.insert_sort_plain(
            ttm.empty_tiled_map(dims, 4, cases.VOX, device="cpu"), torch.from_numpy(p),
            torch.from_numpy(v))[0].dtype == torch.int32


@pytest.mark.parametrize("case", ["lio", "far", "wrap_z", "all_invalid", "n1", "n0",
                                  "dir_2_22", "wide_field", "equal_runs"])
def test_insert_on_the_modelled_sort_matches_jax(case):
    """The port's tiles and cells passes on the modelled sort's keys and
    permutation (the card's second launch's plain version) leave every
    TiledMap field equal to the JAX package's insert after every batch;
    insert_sort on the CPU is insert_sort_plain and counts no launch."""
    dims, pool, batches = cases.sort_case(case)
    mj = jtm.empty_tiled_map(dims, pool, cases.VOX)
    mt = ttm.empty_tiled_map(dims, pool, cases.VOX, device="cpu")
    n0 = ttm.insert_sort.launches
    for p, v in batches:
        pt, vt = torch.from_numpy(p), torch.from_numpy(v)
        sg, order, rows = ttm.insert_sort(mt, pt, vt)
        k = sg.numpy()[np.argsort(order.numpy())]  # the keys in row order
        sk, so, _ = sort_by_passes(k, TILE, span_by_blocks(k, dims, TILE))
        np.testing.assert_array_equal(sk, sg.numpy())
        np.testing.assert_array_equal(so, order.numpy())
        n_alloc, n_dropped = ttm.insert_sorted_plain(mt, pt, vt, rows, torch.from_numpy(sk),
                                                     torch.from_numpy(so))
        mt = mt._replace(n_alloc=n_alloc, n_dropped=n_dropped)
        if len(p):
            mj = jtm.insert(mj, jnp.asarray(p), jnp.asarray(v))
        got = convert.tiled_map_to_arrays(mt)
        for f, w in mj._asdict().items():
            np.testing.assert_array_equal(got[f], np.array(w), err_msg=f)
    assert ttm.insert_sort.launches == n0
