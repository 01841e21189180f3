"""Port parity: the LIO frame's map stages around the EKF, on the CPU.

The tiled map's `delete_boxes` (whose CUDA route is the kernel
csrc/tiled_delete_boxes.cu, its plain version `delete_boxes_plain` the
CPU's), `insert` (whose masked writes carry fixed shapes) and the voxel
filter `voxel_downsample_device` (whose CUDA route after the sort is the
kernel csrc/voxel_centroids.cu, its plain version `voxel_centroids_plain`
the CPU's). The same seeded numpy inputs go through the JAX package and
the port on the CPU. Tolerances: the maps array-identical, field by
field; the filter's masks equal and its centroids within rtol and atol
1e-6 (the bound of tests/test_torch_tiled_map.py: the JAX package's
scatter-add against a segment sum). The kernels' orders are also written
out in numpy here and held bit for bit against the plain versions: the
centroid as a row-order sum from +0.0 and an IEEE division, and as the
kernel decomposes it (tiles, heads counted per tile, segment numbers by
look-back, runs continued past tile ends with one accumulator); the box
delete as per-axis masks of each tile's eight offsets, tested a slot a
lane and written for the hit slots only. On the CPU no
stage of the steady frame around the EKF reads the device (no item,
nonzero, boolean-mask index or tensor built from host data).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from torch.utils._python_dispatch import TorchDispatchMode

from fastlivo_tpu.ops import tiled_map as jtm
from fastlivo_tpu.ops import voxel_filter as jvf

from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch.ops import tiled_map as ttm
from fastlivo_tpu_torch.ops import voxel_filter as tvf

torch.set_num_threads(1)

DIMS, POOL, VOX = (32, 32, 16), 1024, 0.5


def assert_maps_equal(mt, mj):
    got = convert.tiled_map_to_arrays(mt)
    want = {k: np.array(v) for k, v in mj._asdict().items()}
    for f in want:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


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


def both_maps(seed, pool=POOL, dims=DIMS, batches=None):
    mj = jtm.empty_tiled_map(dims, pool, VOX)
    mt = ttm.empty_tiled_map(dims, pool, VOX, device="cpu")
    for p, v in batches if batches is not None else stream(seed):
        mj = jtm.insert(mj, jnp.asarray(p), jnp.asarray(v))
        mt = ttm.insert(mt, torch.from_numpy(p), torch.from_numpy(v))
    return mt, mj


# --- delete_boxes -----------------------------------------------------------

def centre(v):
    """The f32 centre of voxel v at VOX, as both packages round it."""
    return (np.float32(v) + np.float32(0.5)) * np.float32(VOX)


# (lo, hi) rows; a face on a cell centre is inclusive on both sides
BOX_CASES = {
    "one": [((-30, -30, -5), (-5, 30, 5))],
    "faces_on_centres": [((centre(-20), centre(-7), centre(-2)),
                          (centre(3), centre(9), centre(1)))],
    "inert": [((1, 1, 1), (0, 0, 0)), ((5, -2, -5), (30, 2, 5))],
    "four": [((-30, -30, -5), (-22, 30, 5)), ((22, -30, -5), (30, 30, 5)),
             ((-30, -30, -5), (30, -22, 5)), ((-30, 22, -5), (30, 30, 5))],
    "six_sides": [((-30, -30, -5), (-25, 30, 5)), ((25, -30, -5), (30, 30, 5)),
                  ((-30, -30, -5), (30, -25, 5)), ((-30, 25, -5), (30, 30, 5)),
                  ((-30, -30, -5), (30, 30, centre(-1))),
                  ((centre(-3), centre(-4), centre(1)), (centre(2), centre(5), 5))],
    "nan_bound": [((np.nan, -30, -5), (30, 30, 5)), ((-2, -2, -5), (2, 2, 5))],
}


def many_boxes(n=40, seed=4):
    """n small boxes with faces on cell centres, every fifth with a NaN
    bound on one axis."""
    rng = np.random.default_rng(seed)
    v = np.sort(rng.integers(-60, 60, (n, 3, 2)), axis=-1)
    v[:, 2] = np.sort(rng.integers(-4, 4, (n, 2)), axis=-1)
    lo, hi = centre(v[..., 0]), centre(v[..., 1])
    lo[::5, 1] = np.nan
    hi[2::5, 0] = np.nan
    return [(tuple(a), tuple(b)) for a, b in zip(lo, hi)]


BOX_CASES["many"] = many_boxes()


def boxes(case):
    b = np.asarray(BOX_CASES[case], np.float32)
    return b[:, 0].copy(), b[:, 1].copy()


@pytest.mark.parametrize("case", list(BOX_CASES))
def test_delete_boxes_plain_matches_jax(case):
    mt, mj = both_maps(6)
    lo, hi = boxes(case)
    n0 = ttm.delete_boxes.launches
    mt = ttm.delete_boxes(mt, torch.from_numpy(lo), torch.from_numpy(hi))
    mj = jtm.delete_boxes(mj, jnp.asarray(lo), jnp.asarray(hi))
    assert ttm.delete_boxes.launches == n0  # the CPU runs the plain version
    assert_maps_equal(mt, mj)


@pytest.mark.parametrize("case", ["one", "faces_on_centres", "six_sides"])
def test_delete_boxes_after_compact_clears_stale_slots(case):
    """After `compact` the slots past n_alloc keep stale keys and cells;
    both packages test every slot."""
    mt, mj = both_maps(7)
    lo, hi = boxes("one")
    mt = ttm.compact(ttm.delete_boxes(mt, torch.from_numpy(lo), torch.from_numpy(hi)))
    mj = jtm.compact(jtm.delete_boxes(mj, jnp.asarray(lo), jnp.asarray(hi)))
    assert_maps_equal(mt, mj)
    n_alloc = int(mt.n_alloc)
    stale = mt.slot_key[n_alloc:]
    assert n_alloc < POOL and bool((stale != 0).any())  # stale keys past n_alloc
    lo, hi = boxes(case)
    mt = ttm.delete_boxes(mt, torch.from_numpy(lo), torch.from_numpy(hi))
    mj = jtm.delete_boxes(mj, jnp.asarray(lo), jnp.asarray(hi))
    assert_maps_equal(mt, mj)


def delete_lane_per_slot(slot_key, voxel_size, lo, hi, cell_check, empty):
    """csrc/tiled_delete_boxes.cu's order in numpy. The test, a slot a
    lane: the slot's 24 per-axis centres (int32 wrap of slot_key * 8 +
    offset) and, per box, the 8-bit masks of the offsets whose centre lies
    in the box on x, y and z; the slot is hit when some box's three masks
    are all non-zero. The write pass, for the hit slots only: cell (i, j,
    k) is cleared when, for some box, bit i of x, j of y and k of z are
    set. Returns (cell_check after, hit (T,))."""
    T = slot_key.shape[0]
    v = (slot_key.astype(np.uint32)[:, :, None] * np.uint32(8)
         + np.arange(8, dtype=np.uint32)).astype(np.int32)  # (T, 3, 8), int32 wrap
    c = (v.astype(np.float32) + np.float32(0.5)) * np.float32(voxel_size)
    inside = [(c >= lo[b][None, :, None]) & (c <= hi[b][None, :, None])  # (T, 3, 8)
              for b in range(lo.shape[0])]
    hit = np.zeros(T, bool)
    for m in inside:
        hit |= m.any(axis=2).all(axis=1)
    out = cell_check.copy()
    for s in np.flatnonzero(hit):
        kill = np.zeros((8, 8, 8), bool)
        for m in inside:
            kill |= m[s, 0][:, None, None] & m[s, 1][None, :, None] & m[s, 2][None, None, :]
        out[s * 512:(s + 1) * 512][kill.reshape(-1)] = empty
    return out, hit


@pytest.mark.parametrize("case", list(BOX_CASES))
def test_delete_boxes_axis_masks_equal_the_plain_version(case):
    """The kernel's decomposition of the box test into per-axis offset
    masks, a slot a lane, with writes for the hit slots only, clears
    exactly the plain version's cells: stale slots past n_alloc after
    `compact` and the int32 wrap of their voxel coordinate included; a
    slot that is not hit keeps every cell."""
    mt, _ = both_maps(8, batches=stream(8, n_batches=2))
    slab = torch.tensor([[-30.0, -30.0, -5.0]]), torch.tensor([[-16.0, 30.0, 5.0]])
    mt = ttm.compact(ttm.delete_boxes_plain(mt, *slab))
    n_alloc = int(mt.n_alloc)
    assert bool((mt.slot_key[n_alloc:] != 0).any())  # stale keys past n_alloc
    sk = mt.slot_key.clone()
    sk[-3] = torch.tensor([2 ** 28 - 1, -(2 ** 28), 3], dtype=torch.int32)  # wraps
    sk[n_alloc - 1] = torch.tensor([-(2 ** 28) + 1, 2 ** 28 - 2, -1], dtype=torch.int32)
    mt = mt._replace(slot_key=sk)
    lo, hi = boxes(case)
    want = ttm.delete_boxes_plain(mt._replace(cell_check=mt.cell_check.clone()),
                                  torch.from_numpy(lo), torch.from_numpy(hi)).cell_check
    got, hit = delete_lane_per_slot(sk.numpy(), float(mt.voxel_size), lo, hi,
                                    mt.cell_check.numpy(), ttm.EMPTY_CHECK)
    np.testing.assert_array_equal(got, want.numpy())
    changed = (got != mt.cell_check.numpy()).reshape(-1, 512).any(axis=1)
    assert not (changed & ~hit).any()
    assert int((want == ttm.EMPTY_CHECK).sum()) > int((mt.cell_check == ttm.EMPTY_CHECK).sum()) \
        or case == "inert"


# --- insert -----------------------------------------------------------------

def insert_case(case):
    """(pool, dims, batches) of an insert stream."""
    b = stream(11, n_batches=3)
    if case == "all_invalid":
        p, v = b[1]
        return POOL, DIMS, [b[0], (p, np.zeros_like(v)), b[2]]
    if case == "writes_no_cell":  # the same batch again: no point is nearer
        return POOL, DIMS, [b[0], b[0]]
    if case == "one_row":
        return POOL, DIMS, [b[0], (b[1][0][:1], np.ones(1, bool))]
    if case == "empty_batch":
        return POOL, DIMS, [b[0], (b[1][0][:0], np.ones(0, bool)), b[1]]
    if case == "exhaustion":
        return 24, DIMS, stream(1)
    if case == "aliasing":
        return POOL, (2, 2, 2), stream(2)
    if case == "exhaustion_then_invalid":
        s = stream(3)
        return 16, DIMS, s + [(s[0][0], np.zeros_like(s[0][1]))]
    raise ValueError(case)


@pytest.mark.parametrize("case", ["all_invalid", "writes_no_cell", "one_row", "empty_batch",
                                  "exhaustion", "aliasing", "exhaustion_then_invalid"])
def test_insert_fixed_shape_writes_match_jax(case):
    pool, dims, batches = insert_case(case)
    mj = jtm.empty_tiled_map(dims, pool, VOX)
    mt = ttm.empty_tiled_map(dims, pool, VOX, device="cpu")
    for p, v in batches:
        before = convert.tiled_map_to_arrays(mt)
        mj = jtm.insert(mj, jnp.asarray(p), jnp.asarray(v))
        mt = ttm.insert(mt, torch.from_numpy(p), torch.from_numpy(v))
        assert_maps_equal(mt, mj)
        if not v.any():  # nothing valid: no field changes
            after = convert.tiled_map_to_arrays(mt)
            for f in ("dir_check", "dir_slot", "cell_check", "pts", "slot_key", "n_alloc"):
                np.testing.assert_array_equal(after[f], before[f], err_msg=f)
    if case.startswith("exhaustion"):
        assert int(mt.n_dropped) > 0 and int(mt.n_alloc) == pool


@pytest.mark.parametrize("shape", ["vector", "rows"])
@pytest.mark.parametrize("written", ["none", "first", "middle", "all"])
def test_scatter_writes_only_the_masked_rows(shape, written):
    """_scatter_ equals dst[idx[mask]] = val[mask], also where no row or
    every row is written."""
    rng = np.random.default_rng(5)
    B, n = 9, 20
    idx = torch.from_numpy(rng.permutation(n)[:B].astype(np.int32))
    mask = torch.tensor({"none": [0] * B, "first": [1] + [0] * (B - 1),
                         "middle": [0, 0, 0, 1, 0, 1, 0, 0, 0], "all": [1] * B}[written],
                        dtype=torch.bool)
    tail = (3,) if shape == "rows" else ()
    dst = torch.from_numpy(rng.normal(size=(n,) + tail).astype(np.float32))
    val = torch.from_numpy(rng.normal(size=(B,) + tail).astype(np.float32))
    want = dst.clone()
    want[idx[mask].long()] = val[mask]
    src, some, (at,) = ttm._drop_rows(mask, idx)
    ttm._scatter_(dst, src, some, at, val)
    assert torch.equal(dst, want)


# --- the voxel filter -------------------------------------------------------

def scan(case, n=3000, seed=8):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    p[: n // 3] = p[n // 3: 2 * (n // 3)] + rng.normal(0, 0.05, (n // 3, 3))
    valid = rng.random(n) > 0.05
    if case == "neg_zero":
        p[:40] = np.float32(-0.0)  # one voxel of -0.0 rows
        p[40:80, 1] = np.float32(-0.0)
    elif case == "nan_inf":
        p[5, 0] = np.nan
        p[6, 1] = np.inf
        p[7, 2] = -np.inf
        p[8] = np.nan
    elif case == "all_invalid":
        valid[:] = False
    elif case == "dense":  # few voxels, long runs
        p = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    return p, valid


FILTER_CASES = [("neg_zero", 4096), ("nan_inf", 4096), ("all_invalid", 4096),
                ("overflow", 700), ("dense", 4096), ("dense", 3)]


@pytest.mark.parametrize("case,max_out", FILTER_CASES)
def test_voxel_downsample_device_matches_jax(case, max_out):
    p, valid = scan(case)
    n0 = tvf.voxel_centroids.launches
    ot, mt = tvf.voxel_downsample_device(torch.from_numpy(p), torch.from_numpy(valid),
                                         torch.tensor(0.5, dtype=torch.float32), max_out)
    oj, mj = jvf.voxel_downsample_device(jnp.asarray(p), jnp.asarray(valid),
                                         jnp.float32(0.5), max_out)
    assert tvf.voxel_centroids.launches == n0  # the CPU runs the plain version
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-6, atol=1e-6)
    assert np.isfinite(ot.numpy()).all()
    if case == "all_invalid":
        assert not mt.any() and not ot.any()
    if case == "neg_zero":  # -0.0 sums to +0.0 from the +0.0 start
        rows = ot.numpy()[mt.numpy()]
        assert not np.signbit(rows[rows == 0]).any()


def centroids_in_row_order(keys, order, pts, max_out):
    """The kernel's sums in numpy: heads of the sorted valid keys, each run
    summed row by row in f32 from +0.0, divided by its length in f32."""
    nvalid = int(np.sum(keys != tvf.INVALID))
    out = np.zeros((max_out, pts.shape[1]), np.float32)
    mask = np.zeros(max_out, bool)
    heads = [r for r in range(nvalid) if r == 0 or keys[r] != keys[r - 1]]
    for g, s0 in enumerate(heads[:max_out]):
        s1 = heads[g + 1] if g + 1 < len(heads) else nvalid
        acc = np.zeros(pts.shape[1], np.float32)
        for r in range(s0, s1):
            acc = (acc + pts[order[r]]).astype(np.float32)
        out[g] = acc / np.float32(s1 - s0)
        mask[g] = True
    return out, mask


@pytest.mark.parametrize("case,max_out", FILTER_CASES + [("inv_leaf", 2048)])
def test_voxel_centroids_plain_is_the_kernels_row_order(case, max_out):
    """The plain version run on the CPU (the kernel's oracle) sums each run
    in row order from +0.0: bit for bit the kernel's order. The keys come
    sorted, with `order` the stable sort's permutation of them."""
    p, valid = scan("dense" if case == "inv_leaf" else case)
    pt = torch.from_numpy(p)
    leaf = torch.tensor(0.2 if case == "inv_leaf" else 0.5, dtype=torch.float32)
    kw = dict(inv_leaf=1.0 / leaf) if case == "inv_leaf" else {}
    keys, order = tvf._sorted_keys(pt, torch.from_numpy(valid),
                                   None if kw else leaf, kw.get("inv_leaf"))
    assert bool((keys[1:] >= keys[:-1]).all())
    got = tvf.voxel_centroids_plain(keys, order, pt, max_out)
    want = centroids_in_row_order(keys.numpy(), order.numpy(), p, max_out)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[0].numpy().view(np.int32), want[0].view(np.int32))
    full = tvf.voxel_downsample_device(pt, torch.from_numpy(valid), None if kw else leaf,
                                       max_out, **kw)
    assert all(torch.equal(a, b) for a, b in zip(full, got))


def segments_before(agg, incl, inclusive, t, width=32):
    """The kernel's decoupled look-back for tile t: windows of `width`
    earlier tiles, nearest first, each adding a tile's own count (its
    aggregate) until it meets one that holds its inclusive prefix."""
    total = 0
    for base in range(t - 1, -1, -width):
        for i in range(base, base - width, -1):
            if i < 0 or inclusive[i]:
                total += incl[i] if i >= 0 else 0
                return total
            total += agg[i]
    return total


def centroids_by_tiles(keys, order, pts, max_out, tile, ext=32, seed=0):
    """csrc/voxel_centroids.cu's decomposition in numpy. Tiles of `tile`
    sorted rows; each tile's heads (valid, key unlike the row before) and
    their count; the tile's first segment number by look-back over the
    earlier tiles, each holding its aggregate or, at random, its inclusive
    prefix; each head's run summed in row order from +0.0 by the head's
    tile: to the next head in the tile, else on past the tile's end, the
    `ext` rows staged after it and then spans of tile + ext rows, while
    the key holds, one accumulator carried through the chunks; rows nseg
    .. max_out - 1 zero. Returns (out, mask, {sorted head row: segment})."""
    rng = np.random.default_rng(seed)
    N, C = pts.shape
    ntiles = -(-N // tile)
    heads = [[r for r in range(t * tile, min(N, (t + 1) * tile))
              if keys[r] != tvf.INVALID and (r == 0 or keys[r] != keys[r - 1])]
             for t in range(ntiles)]
    agg = np.array([len(h) for h in heads], np.int64)
    incl = np.cumsum(agg)
    inclusive = rng.random(ntiles) < 0.5
    inclusive[:1] = True  # tile 0 publishes its inclusive prefix at once
    out = np.zeros((max_out, C), np.float32)
    mask = np.zeros(max_out, bool)
    seg = {}
    for t in range(ntiles):
        excl = segments_before(agg, incl, inclusive, t)
        assert excl == (incl[t - 1] if t else 0)
        end = min(N, (t + 1) * tile)
        seg.update({s0: excl + h for h, s0 in enumerate(heads[t])})
        for h, s0 in enumerate(heads[t]):
            g = excl + h
            if g >= max_out:
                break
            if h + 1 < len(heads[t]):
                chunks = [(s0, heads[t][h + 1])]
            else:  # the tile's valid rows, then on past its end while the key holds
                r = s0
                while r < end and keys[r] == keys[s0]:
                    r += 1
                chunks, lim = [(s0, r)], ext
                while r == end and r < N:
                    e = r
                    while e < min(N, r + lim) and keys[e] == keys[s0]:
                        e += 1
                    chunks.append((r, e))
                    end, r, lim = r + lim, e, tile + ext
            acc = np.zeros(C, np.float32)
            for a, b in chunks:  # each chunk continues the accumulator
                for r in range(a, b):
                    acc = (acc + pts[order[r]]).astype(np.float32)
            out[g] = acc / np.float32(chunks[-1][1] - s0)
            mask[g] = True
    nseg = segments_before(agg, incl, inclusive, ntiles)
    assert nseg == (incl[-1] if ntiles else 0)
    out[nseg:] = 0.0
    mask[nseg:] = False
    return out, mask, seg


def run_case(case, n=4000, seed=9):
    """(keys sorted, order, pts, max_out): runs of chosen lengths in
    sorted key order, then invalid rows; pts in a random row order."""
    rng = np.random.default_rng(seed)
    C = 5 if case == "five_columns" else 3
    if case == "long_runs":  # longer than a tile and its staged rows: spans
        lengths = [1, 2500, 3, 1100, 40, 33, 32, 31]
    elif case == "all_invalid":
        lengths = []
    else:  # short and mid runs crossing tile ends of 1, 7, 32 and 1024 rows
        lengths = list(rng.integers(1, 80, 200))
    lengths = [x for x in np.cumsum(lengths) if x <= n]
    keys = np.full(n, tvf.INVALID, np.int64)
    prev = 0
    for v, stop in enumerate(lengths):
        keys[prev:stop] = 1000 + 7 * v
        prev = stop
    order = rng.permutation(n).astype(np.int64)
    pts = np.zeros((n, C), np.float32)
    pts[order] = rng.normal(0, 20, (n, C)).astype(np.float32)
    pts[order[:60]] = np.float32(-0.0)  # a run of -0.0 rows sums to +0.0
    pts[order[70], 1] = np.nan  # propagates through its run
    pts[order[75], 2] = np.inf
    max_out = {"overflow": 50, "max_out_1": 1}.get(case, 4096)
    return keys, order, pts, max_out


@pytest.mark.parametrize("tile", [1, 7, 32, 1024])
@pytest.mark.parametrize("case", ["crossing", "long_runs", "overflow", "max_out_1",
                                  "all_invalid", "five_columns"])
def test_voxel_centroids_tile_decomposition_is_the_plain_version(case, tile):
    """The kernel's decomposition (tiles, look-back, runs continued past
    tile ends in chunks with one accumulator, the fill past the segments)
    gives voxel_centroids_plain's segment numbers and bits."""
    keys, order, pts, max_out = run_case(case)
    out, mask, seg = centroids_by_tiles(keys, order, pts, max_out, tile)
    got = tvf.voxel_centroids_plain(torch.from_numpy(keys), torch.from_numpy(order),
                                    torch.from_numpy(pts), max_out)
    np.testing.assert_array_equal(got[1].numpy(), mask)
    np.testing.assert_array_equal(got[0].numpy().view(np.int32), out.view(np.int32))
    valid = keys != tvf.INVALID
    head = valid & np.r_[True, keys[1:] != keys[:-1]]
    assert sorted(seg) == list(np.flatnonzero(head))
    assert [seg[r] for r in sorted(seg)] == list(range(len(seg)))
    if case != "all_invalid":  # a -0.0 run first; a NaN further on where kept
        assert mask.any() and not np.signbit(out[0]).any()
        assert np.isnan(out).any() == (max_out > 1)


def test_kernel_wrappers_refuse_other_devices():
    m = ttm.empty_tiled_map((2, 2, 2), 4, VOX, device="cpu")
    m = type(m)(*(t.to("meta") for t in m))
    lo = torch.zeros((1, 3), device="meta")
    with pytest.raises(ValueError):
        ttm.delete_boxes(m, lo, lo)
    k = torch.zeros(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        tvf.voxel_centroids(k, k, torch.zeros((8, 3), device="meta"), 4)


# --- no host read around the EKF --------------------------------------------

# ops that read the device on CUDA: a scalar read, a count that sizes a
# result, a tensor built from host data
READS = ("aten._local_scalar_dense", "aten.item", "aten.nonzero", "aten.masked_select",
         "aten.lift_fresh", "aten.unique", "aten._unique", "aten.repeat_interleave")


class HostReads(TorchDispatchMode):
    """Records each op that would read the device to the host on CUDA,
    and each index or index_put with a boolean index (sized on the host)."""

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name.startswith(READS):
            self.reads.append(name)
        elif name in ("aten.index", "aten.index_put", "aten.index_put_"):
            if any(t is not None and t.dtype == torch.bool for t in args[1]):
                self.reads.append(name + " (boolean index)")
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def frame_args():
    """The arguments of a steady lidar_frame_step of a small LIO run on
    the CPU."""
    from fastlivo_tpu_torch import pipeline
    from fastlivo_tpu_torch.config import CapacityConfig, Config
    from fastlivo_tpu_torch.io.synthetic import SyntheticDataset

    cfg = Config()
    cfg.img_enable = False
    cfg.capacity = CapacityConfig(max_points=2048, max_raw_points=4096,
                                  tiled_dir_dims=(32, 32, 16), tiled_pool=1024)
    ds = SyntheticDataset(duration=2.6, points_per_scan=2048, lidar_noise=0.004, seed=3)
    pipe = pipeline.Pipeline(cfg, device="cpu")
    for beg, pts, t_rel in ds.lidar_scans_fast():
        pipe.push_lidar(beg, pts, t_rel)
    for t, acc, gyr in ds.imu_stream():
        pipe.push_imu(t, acc, gyr)
    calls = []
    real = pipeline.lidar_frame_step

    def spy(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    pipeline.lidar_frame_step = spy
    try:
        pipe.spin()
    finally:
        pipeline.lidar_frame_step = real
    assert calls
    return calls[-1]


@pytest.mark.parametrize("stage", ["undistort", "sort_keys", "insert", "frame_outputs"])
def test_frame_stages_read_nothing_to_the_host(frame_args, stage):
    from fastlivo_tpu_torch import frame_step
    from fastlivo_tpu_torch import imu as imu_mod

    (state, m, pose, calib, pts, trel, rmask, fss), kw = frame_args
    und = imu_mod.undistort(state, pose, pts, trel, rmask, calib)
    down, dmask = tvf.voxel_downsample_device(und, rmask, fss, kw["max_points"])
    m = type(m)(*(t.clone() for t in m))
    iters = torch.tensor(3)
    calls = {
        "undistort": lambda: imu_mod.undistort(state, pose, pts, trel, rmask, calib),
        "sort_keys": lambda: tvf._sorted_keys(und, rmask, fss, None),
        "insert": lambda: ttm.insert(m, down, dmask),
        "frame_outputs": lambda: frame_step.frame_outputs(
            state, dmask.sum(), iters, dmask, torch.zeros(down.shape[0]), dmask, und, rmask,
            calib, m.n_alloc, True),
    }
    with HostReads() as mode:
        calls[stage]()
    assert mode.reads == []


def test_host_read_detector_sees_a_boolean_index():
    x, mask = torch.arange(5.0), torch.tensor([True, False, True, False, True])
    with HostReads() as mode:
        x[mask] = 0.0
        _ = int(x.sum())
    assert {"aten.index_put_ (boolean index)", "aten._local_scalar_dense"} <= set(mode.reads)
