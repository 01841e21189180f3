"""Port parity: the plain versions of the flat maps' write kernels.

The hash map's insert is a keys pass (`insert_keys_plain`, the kernel
hash_insert_keys' oracle), a sort of two int64 keys in turn
(`sort_order`) and the probe rounds (`insert_probe_plain`, the kernel
hash_insert_probe's oracle); the dense grid's insert is `insert_plain`
(the kernel dense_insert's oracle) and the box delete of both maps
`delete_boxes_plain` (flat_delete_boxes'). The same seeded numpy inputs go
through the JAX package's ops/voxel_map.py and ops/dense_map.py and
through these on the CPU, on tables of at most 2^16 slots and grids of at
most (64, 64, 16) cells; every array is bit-equal. The cases: the sort
against jnp.lexsort at voxel coordinates near +-2^31, negative ones and
equal distances; inserts with a duplicate claim, with a 31-bit check
collision, with a probe run that overflows a full table, with no row and
with every row invalid; rebuild; the dense grid's aliased eviction; the
box delete with an inert box and with more boxes than one block of the
kernel stages. On the CPU the wrappers route to the plain versions and
launch nothing; another device is refused.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fastlivo_tpu.ops import dense_map as jdm
from fastlivo_tpu.ops import voxel_map as jvm

from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch.ops import dense_map as tdm
from fastlivo_tpu_torch.ops import voxel_map as tvm

VOX = 0.5
BOX_CAP = 256  # boxes flat_delete_boxes.cu stages in shared memory at once


def bits_equal(got: dict, mj):
    """Every field of the port's map (as arrays) equal in every bit to the
    JAX package's."""
    for f, v in mj._asdict().items():
        want = np.atleast_1d(np.array(v))
        g = np.atleast_1d(got[f])
        assert g.dtype == want.dtype, f
        assert np.array_equal(g.view(np.uint8), want.view(np.uint8)), f


def hash_equal(mt, mj):
    bits_equal(convert.voxel_map_to_arrays(mt), mj)


def dense_equal(mt, mj):
    bits_equal(convert.dense_map_to_arrays(mt), mj)


def surface(rng, n, span=12.0):
    """Points on a bumpy surface (negative voxel coordinates included), a
    tenth of them near-duplicates of others, some rows invalid."""
    p = np.stack([rng.uniform(-span, span, n), rng.uniform(-span, span, n),
                  np.abs(np.sin(0.2 * rng.uniform(-span, span, n))) * 2 - 1], 1)
    p[: n // 10] = p[n // 10: n // 5] + rng.normal(0, 0.05, (n // 10, 3))
    return p.astype(np.float32), rng.random(n) > 0.05


def extreme_points(rng):
    """Rows whose voxels lie near +-2^31 (multiples of 256 voxels, exact in
    f32, so many share a distance of 0), negative and small coordinates,
    and repeated points (equal distances in one voxel)."""
    big = np.array([-2 ** 31, -2 ** 31 + 256, -2 ** 30, 2 ** 30, 2 ** 31 - 512, 2 ** 31 - 256],
                   np.int64)
    k = rng.choice(big, (120, 3))
    k[:40, 0] = rng.integers(-3, 3, 40)
    k[40:80, 1] = rng.integers(-3, 3, 40)
    p = (k.astype(np.float64) * VOX).astype(np.float32)
    small = rng.uniform(-3, 3, (200, 3)).astype(np.float32)
    small[100:150] = small[50:100]  # equal distances, equal voxels
    small[150:160] = -small[140:150]  # mirrored offsets about the origin
    p = np.concatenate([p, small, p[:30]])
    return p, rng.random(len(p)) > 0.1


@pytest.mark.parametrize("seed", [0, 1])
def test_keys_and_two_pass_sort_equal_lexsort(seed):
    """insert_keys_plain's voxels, probe slots, checks and distance bits
    are the JAX package's, and the two stable sorts of its int64 keys give
    jnp.lexsort((d2c, k0, k1, k2)) exactly, near +-2^31, below 0 and at
    equal distances."""
    rng = np.random.default_rng(seed)
    p, v = extreme_points(rng)
    T = 1 << 16
    mt = tvm.empty_map(T, VOX, device="cpu")
    rows, skeys = tvm.insert_keys_plain(mt, torch.from_numpy(p), torch.from_numpy(v))
    vs = jnp.float32(VOX)
    keys = jvm.voxel_of(jnp.asarray(p), vs)
    slot, chk = jvm._slot_check(keys, T - 1)
    centre = (keys.astype(jnp.float32) + 0.5) * vs
    d2c = jnp.where(jnp.asarray(v), jnp.sum((jnp.asarray(p) - centre) ** 2, axis=-1), jvm.BIG)
    want = np.stack([np.array(keys[:, 0]), np.array(keys[:, 1]), np.array(keys[:, 2]),
                     np.array(slot), np.array(chk),
                     np.array(d2c.astype(jnp.float32)).view(np.int32)])
    assert rows.dtype == torch.int32 and skeys.dtype == torch.int64
    np.testing.assert_array_equal(rows.numpy(), want)
    order = jnp.lexsort((d2c, keys[:, 0], keys[:, 1], keys[:, 2]))
    np.testing.assert_array_equal(tvm.sort_order(skeys).numpy(), np.array(order))
    assert np.abs(want[:3]).max() >= 2 ** 31 - 256  # the extremes were reached
    assert len(np.unique(want[5])) < len(p) // 2  # and distances tie


def colliding_checks(n_pairs=2):
    """Pairs of voxels of a seeded grid with one 31-bit check (and so one
    probe slot in any table of up to 2^18 slots)."""
    g = np.stack(np.meshgrid(*[np.arange(-40, 40)] * 3, indexing="ij"), -1).reshape(-1, 3)
    g = np.random.default_rng(3).permutation(g)
    chk = (tvm._mix64_np(g.astype(np.int32)) & np.uint32(0x7FFFFFFF)).astype(np.int64)
    order = np.argsort(chk, kind="stable")
    dup = np.nonzero(chk[order][1:] == chk[order][:-1])[0]
    assert len(dup) >= n_pairs
    return [g[order[[i, i + 1]]] for i in dup[:n_pairs]]


def insert_both(mt, mj, p, v, max_probe=12):
    mt = tvm.insert(mt, torch.from_numpy(p), torch.from_numpy(v), max_probe)
    mj = jvm.insert(mj, jnp.asarray(p), jnp.asarray(v), max_probe=max_probe)
    hash_equal(mt, mj)
    return mt, mj


@pytest.mark.parametrize("T", [16, 64])
def test_check_collision_both_claims_win(T):
    """Two voxels with one 31-bit check claim one slot in the same round:
    both read their check back and count as won, the later sorted row's
    point stands; a later batch of the first voxel finds the slot as its
    own. Bit-equal to the JAX package."""
    rng = np.random.default_rng(T)
    for a, b in colliding_checks():
        mt, mj = tvm.empty_map(T, VOX, device="cpu"), jvm.empty_map(T, VOX)
        filler, fv = surface(rng, 6, 2.0)
        p = np.concatenate([(np.stack([a, b]).astype(np.float32) + 0.3) * VOX, filler])
        v = np.concatenate([np.ones(2, bool), fv])
        mt, mj = insert_both(mt, mj, p, v)
        # both won one slot: the count runs one ahead of the occupied slots
        assert int(mt.count) == int((mt.check != tvm.EMPTY_CHECK).sum()) + 1
        again = ((np.stack([a, b]).astype(np.float32) + 0.5) * VOX)  # nearer the centres
        mt, mj = insert_both(mt, mj, again, np.ones(2, bool))
        mt, mj = insert_both(mt, mj, p[::-1].copy(), v[::-1].copy())


def test_duplicate_claim_and_probe_overflow():
    """Voxels that claim one free slot in the same round (the later in
    (z, y, x) order keeps it, the other probes on), then more voxels than
    a 16-slot table holds at probe depths 12 and 3 (the last rows run out
    of probes and are dropped). Bit-equal to the JAX package."""
    T = 16
    k = np.stack(np.meshgrid(*[np.arange(-4, 4)] * 3, indexing="ij"), -1).reshape(-1, 3)
    slot = tvm._slot_check(torch.from_numpy(k.astype(np.int32)), T - 1)[0].numpy()
    order = np.argsort(slot, kind="stable")
    same = np.nonzero(slot[order][1:] == slot[order][:-1])[0][0]
    pair = k[order[[same, same + 1]]]
    mt, mj = tvm.empty_map(T, VOX, device="cpu"), jvm.empty_map(T, VOX)
    mt, mj = insert_both(mt, mj, (pair.astype(np.float32) + 0.5) * VOX, np.ones(2, bool))
    assert int(mt.count) == 2
    rng = np.random.default_rng(5)
    for probe in (12, 3):
        p = ((rng.permutation(k)[:40].astype(np.float32) + rng.uniform(0.1, 0.9, (40, 3)))
             * VOX).astype(np.float32)
        mt, mj = insert_both(mt, mj, p, np.ones(40, bool), probe)
    assert int(mt.count) == T  # full: the rest were dropped


@pytest.mark.parametrize("case", ["empty batch", "all invalid"])
def test_insert_of_nothing(case):
    """A batch of invalid rows leaves the table as the JAX package's (and as
    it was), and so does a batch of no row, which the JAX package's insert
    refuses (its `.at[0]` on an empty axis): there the JAX map is the
    table before the call."""
    rng = np.random.default_rng(7)
    mt, mj = insert_both(tvm.empty_map(1 << 10, VOX, device="cpu"), jvm.empty_map(1 << 10, VOX),
                         *surface(rng, 500))
    n = 0 if case == "empty batch" else 300
    p = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    before = [t.clone() for t in mt]
    if n:
        mt, mj = insert_both(mt, mj, p, np.zeros(n, bool))
    else:
        mt = tvm.insert(mt, torch.from_numpy(p), torch.zeros(0, dtype=torch.bool))
        hash_equal(mt, mj)
    assert all(torch.equal(a, b) for a, b in zip(mt, before))


@pytest.mark.parametrize("T,probe", [(1 << 10, 12), (1 << 12, 6), (1 << 16, 12)])
def test_insert_stream_delete_and_rebuild(T, probe):
    """Batches into T slots (the smaller tables nearly full), a box delete
    with an inert box, more batches into the holes at a shallow probe,
    rebuild (through insert at probe 32) and rebuild_plain: every array
    bit-equal to the JAX package's."""
    rng = np.random.default_rng(T)
    mt, mj = tvm.empty_map(T, VOX, device="cpu"), jvm.empty_map(T, VOX)
    n = min(T, 3000)
    batches = [surface(rng, n) for _ in range(3)]
    for p, v in batches:
        mt, mj = insert_both(mt, mj, p, v)
    lo = np.float32([[-12, -12, -5], [2, -3, -5], [1, 1, 1]])
    hi = np.float32([[-2, 12, 5], [12, 3, 5], [0, 0, 0]])  # the last inert
    mt = tvm.delete_boxes(mt, torch.from_numpy(lo), torch.from_numpy(hi))
    mj = jvm.delete_boxes(mj, jnp.asarray(lo), jnp.asarray(hi))
    hash_equal(mt, mj)
    for p, v in batches[:2]:
        mt, mj = insert_both(mt, mj, p, v, probe)
    rj = jvm.rebuild(mj)
    hash_equal(tvm.rebuild(mt), rj)
    hash_equal(tvm.rebuild_plain(mt), rj)


def test_dense_insert_with_aliased_eviction():
    """The dense grid's insert (64 x 64 x 16 cells spanning 32 x 32 x 8 m,
    points over 48 m, so that cells alias and evict), with equal
    distances, no row and every row invalid: bit-equal to the JAX
    package."""
    rng = np.random.default_rng(11)
    dims = (64, 64, 16)
    mt, mj = tdm.empty_dense_map(dims, VOX, device="cpu"), jdm.empty_dense_map(dims, VOX)
    for n, span in ((4000, 24.0), (4000, 24.0), (0, 1.0), (500, 24.0)):
        p, v = surface(rng, n, span)
        p[: n // 20] = p[n // 20: n // 10]  # repeats: equal distances, ties to the lower row
        if n == 500:
            v[:] = False
        mt = tdm.insert(mt, torch.from_numpy(p), torch.from_numpy(v))
        mj = jdm.insert(mj, jnp.asarray(p), jnp.asarray(v))
        dense_equal(mt, mj)
    # one grid period away in x: the same cells, other voxels
    pts, _ = tdm.extract_points(mt)
    moved = pts[:300] + np.float32([dims[0] * VOX, 0, 0])
    before = int(mt.count)
    mt = tdm.insert(mt, torch.from_numpy(moved), torch.ones(300, dtype=torch.bool))
    mj = jdm.insert(mj, jnp.asarray(moved), jnp.ones(300, bool))
    dense_equal(mt, mj)
    assert int(mt.count) == before  # evictions, not new cells


def random_boxes(rng, pts, n, inert=True):
    """n boxes around stored points, 0.2 to 3 m from each on every axis;
    with `inert` the last has lo > hi (holds nothing)."""
    c = pts[rng.integers(0, len(pts), n)].astype(np.float64)
    lo = (c - rng.uniform(0.2, 3.0, (n, 3))).astype(np.float32)
    hi = (c + rng.uniform(0.2, 3.0, (n, 3))).astype(np.float32)
    if inert:
        lo[-1], hi[-1] = hi[-1], lo[-1]
    return lo, hi


@pytest.mark.parametrize("backend", ["hash", "dense"])
@pytest.mark.parametrize("n_boxes", [1, 3, BOX_CAP + 45])
def test_delete_boxes(backend, n_boxes):
    """The box delete of both maps, with an inert box (lo > hi) and with
    more boxes than one block of the kernel stages at once: bit-equal to
    the JAX package, the count included."""
    rng = np.random.default_rng(n_boxes)
    if backend == "hash":
        mt, mj = tvm.empty_map(1 << 14, VOX, device="cpu"), jvm.empty_map(1 << 14, VOX)
        ins_t, ins_j, equal, mod, jmod = tvm.insert, jvm.insert, hash_equal, tvm, jvm
    else:
        mt, mj = tdm.empty_dense_map((32, 32, 16), VOX, device="cpu"), jdm.empty_dense_map(
            (32, 32, 16), VOX)
        ins_t, ins_j, equal, mod, jmod = tdm.insert, jdm.insert, dense_equal, tdm, jdm
    for _ in range(2):
        p, v = surface(rng, 4000)
        mt = ins_t(mt, torch.from_numpy(p), torch.from_numpy(v))
        mj = ins_j(mj, jnp.asarray(p), jnp.asarray(v))
    lo, hi = random_boxes(rng, mod.extract_points(mt)[0], n_boxes, inert=n_boxes > 1)
    before = int(mt.count)
    mt = mod.delete_boxes(mt, torch.from_numpy(lo), torch.from_numpy(hi))
    mj = jmod.delete_boxes(mj, jnp.asarray(lo), jnp.asarray(hi))
    equal(mt, mj)
    assert int(mt.count) < before
    if n_boxes > 1:  # the inert box alone clears nothing
        mt2 = mod.delete_boxes(mt, torch.from_numpy(lo[-1:]), torch.from_numpy(hi[-1:]))
        assert int(mt2.count) == int(mt.count)


def nan_inverted_boxes(rng, pts, n):
    """n boxes around stored points, a tenth inverted on one axis, a tenth
    with a NaN bound, one on a voxel edge (a centre exactly on lo and on
    hi: held) and one a float past it (not held)."""
    lo, hi = random_boxes(rng, pts, n, inert=False)
    k = rng.permutation(n)
    for b in k[: n // 10]:
        a = rng.integers(0, 3)
        lo[b, a], hi[b, a] = hi[b, a], lo[b, a]
    for b in k[n // 10: n // 5]:
        (lo if rng.random() < 0.5 else hi)[b, rng.integers(0, 3)] = np.nan
    c = ((np.floor(pts[0] / np.float32(VOX)).astype(np.float32) + np.float32(0.5))
         * np.float32(VOX)).astype(np.float32)
    edge = np.stack([c, np.nextafter(c, np.float32(np.inf))])
    return np.concatenate([lo, edge]), np.concatenate([hi, np.stack([c, c])])


@pytest.mark.parametrize("backend,size", [("hash", 4), ("hash", 8), ("hash", 1 << 12),
                                          ("dense", (2, 2, 1)), ("dense", (2, 2, 2)),
                                          ("dense", (32, 32, 16))])
def test_delete_boxes_nan_inverted_and_every_slot(backend, size):
    """The box delete on tables of 4, 8 and 4096 slots (the card's scan: a
    lane's 16 slots, fewer, many warps) and on dense grids of 4, 8 and
    16384 cells: 40 boxes with NaN and inverted bounds, boxes whose
    centre lies on lo and hi (held) or one float below lo (not held), then a box
    set that frees every occupied slot; bit-equal to the JAX package, the
    count included."""
    rng = np.random.default_rng(len(str(size)))
    if backend == "hash":
        mt, mj = tvm.empty_map(size, VOX, device="cpu"), jvm.empty_map(size, VOX)
        ins_t, ins_j, equal, mod, jmod = tvm.insert, jvm.insert, hash_equal, tvm, jvm
    else:
        mt, mj = tdm.empty_dense_map(size, VOX, device="cpu"), jdm.empty_dense_map(size, VOX)
        ins_t, ins_j, equal, mod, jmod = tdm.insert, jdm.insert, dense_equal, tdm, jdm
    p, v = surface(rng, 3000, 6.0)
    mt = ins_t(mt, torch.from_numpy(p), torch.from_numpy(v))
    mj = ins_j(mj, jnp.asarray(p), jnp.asarray(v))
    stored = mod.extract_points(mt)[0]
    before = int(mt.count)
    lo, hi = nan_inverted_boxes(rng, stored, 40)
    mt = mod.delete_boxes(mt, torch.from_numpy(lo), torch.from_numpy(hi))
    mj = jmod.delete_boxes(mj, jnp.asarray(lo), jnp.asarray(hi))
    equal(mt, mj)
    assert int(mt.count) < before  # the edge box held its centre
    lo = np.float32([[-1e30, -1e30, -1e30], [1, 1, 1]])
    hi = np.float32([[1e30, 1e30, 1e30], [-1, -1, -1]])
    mt = mod.delete_boxes(mt, torch.from_numpy(lo), torch.from_numpy(hi))
    mj = jmod.delete_boxes(mj, jnp.asarray(lo), jnp.asarray(hi))
    equal(mt, mj)
    assert not (mt.check != tvm.EMPTY_CHECK).any()


def scan_partition(T: int, check_off: int):
    """A numpy model of csrc/flat_delete_boxes.cu's launch: the slots each
    thread scans for a table of T slots whose check starts `check_off`
    bytes past 16-byte alignment. The head (slots before the first
    16-byte-aligned check) and the tail (past the last whole 4-slot group)
    take a thread a slot after the body's threads; in the body warp w's
    lane l loads groups w * 128 + l + 32 j, j < 4, as 16-byte words.
    Returns (body slots (groups, 4), their 16-byte load index per (thread,
    j) with -1 for none, the scalar slots, the blocks)."""
    head = min(T, ((16 - check_off % 16) % 16) // 4)
    groups, tail = (T - head) >> 2, (T - head) & 3
    body_threads = -(-groups // 128) * 32
    gid = np.arange(body_threads)
    g = ((gid >> 5) * 128 + (gid & 31))[:, None] + 32 * np.arange(4)[None]
    g = np.where(g < groups, g, -1)
    live = g[g >= 0]
    body = (head + 4 * live)[:, None] + np.arange(4)[None]
    s = np.arange(head + tail)
    scalar = np.where(s < head, s, head + 4 * groups + (s - head))
    blocks = -(-(body_threads + head + tail) // 256)
    return body, g, scalar, blocks


@pytest.mark.parametrize("check_off", [0, 4, 8, 12])
def test_box_delete_scan_covers_every_slot_once(check_off):
    """The card's box delete scan (numpy model, scan_partition): for every
    power-of-two table from 1 to 2^22 slots and every 4-byte base offset
    of the check, each slot is scanned exactly once; a body group's check
    is one aligned 16-byte word; each of a warp's four loads is one
    contiguous 512-byte row; 2^20 slots take 256 blocks of 256 threads and
    2^22 take 1024 (the whole table in flight)."""
    for e in range(23):
        T = 1 << e
        body, g, scalar, blocks = scan_partition(T, check_off)
        seen = np.bincount(np.concatenate([body.ravel(), scalar]), minlength=T)
        assert seen.shape == (T,) and (seen == 1).all(), (T, check_off)
        assert ((check_off + 4 * body[:, 0]) % 16 == 0).all()
        assert len(scalar) <= 6
        full = g[: (len(g) // 32) * 32].reshape(-1, 32, 4)
        rows = full[(full >= 0).all(axis=(1, 2))]
        assert (np.diff(rows, axis=1) == 1).all()
        if check_off == 0 and e in (20, 22):
            assert blocks == (256 if e == 20 else 1024) and len(scalar) == 0


def test_cpu_maps_take_the_plain_versions_and_other_devices_are_refused():
    """On the CPU every write wrapper is its plain version and counts no
    launch; a map on another device (meta) is refused, never run in
    torch ops."""
    rng = np.random.default_rng(2)
    p, v = (torch.from_numpy(a) for a in surface(rng, 800))
    counters = (tvm.hash_insert_keys, tvm.hash_insert_probe, tdm.dense_insert,
                tvm.flat_delete_boxes)
    n0 = [f.launches for f in counters]
    h = tvm.insert(tvm.empty_map(1 << 10, VOX, device="cpu"), p, v)
    hp = tvm.insert_plain(tvm.empty_map(1 << 10, VOX, device="cpu"), p, v)
    d = tdm.insert(tdm.empty_dense_map((16, 16, 8), VOX, device="cpu"), p, v)
    dp = tdm.insert_plain(tdm.empty_dense_map((16, 16, 8), VOX, device="cpu"), p, v)
    lo, hi = torch.tensor([[-3.0, -3, -3]]), torch.tensor([[3.0, 3, 3]])
    for a, b in ((h, hp), (d, dp), (tvm.delete_boxes(h, lo, hi), tvm.delete_boxes_plain(hp, lo, hi)),
                 (tdm.delete_boxes(d, lo, hi), tvm.delete_boxes_plain(dp, lo, hi))):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert [f.launches for f in counters] == n0
    assert len({f.__name__ for f in counters}) == len(counters)
    meta = tvm.empty_map(1 << 10, VOX, device="cpu")
    meta = meta._replace(**{f: getattr(meta, f).to("meta") for f in meta._fields})
    dmeta = tdm.empty_dense_map((16, 16, 8), VOX, device="cpu")
    dmeta = dmeta._replace(**{f: getattr(dmeta, f).to("meta") for f in dmeta._fields})
    pm, vm_ = p.to("meta"), v.to("meta")
    for call in (lambda: tvm.insert(meta, pm, vm_), lambda: tdm.insert(dmeta, pm, vm_),
                 lambda: tvm.delete_boxes(meta, lo.to("meta"), hi.to("meta")),
                 lambda: tdm.delete_boxes(dmeta, lo.to("meta"), hi.to("meta")),
                 lambda: tvm.hash_insert_keys(meta, pm, vm_),
                 lambda: tdm.dense_insert(dmeta, pm, vm_)):
        with pytest.raises(ValueError):
            call()
    with pytest.raises(ValueError):
        tdm.insert(tdm.empty_dense_map((16, 16, 8), VOX, device="cpu"),
                   torch.zeros((1 << 24, 3)).expand(1 << 24, 3), torch.zeros(1 << 24, dtype=bool))
