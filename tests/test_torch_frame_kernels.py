"""Port parity: the plain versions of the LIO frame's insert and
undistortion kernels, on the CPU.

`tiled_map.insert` on a CUDA map runs three kernels around one stable
sort (csrc/tiled_insert.cu), `imu.undistort` on CUDA points one
(csrc/undistort.cu); on the CPU their plain versions `insert_plain` and
`undistort_plain` run, and the card tests hold the kernels to them bit
for bit (tests/test_torch_cuda.py). Here:

  - the kernels' passes written out in numpy as the kernels run them
    (keys a row at a time; tile heads flagged from the directory as it
    was, then ranked by a block scan over the rows in chunks of the
    block's threads; each cell run walked from its head to its first ok
    row) give insert_plain's map bit for bit, batch by batch, on streams
    with directory aliasing, pool overflow, runs whose sorted head is
    not ok, a compacted map with stale slots, B = 0 and 1 and no valid
    row; and each plain pass's outputs equal the model's;
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

from torch_frame_cases import INSERT_CASES, UNDISTORT_CASES, VOX, insert_case, undistort_case

torch.set_num_threads(1)
F32, EMPTY = np.float32, ttm.EMPTY_CHECK


# --- the insert's passes in numpy -------------------------------------------

def keys_model(m, p, valid):
    """tiled_insert_keys, a row at a time: (gkey, rows (5, B))."""
    vs = F32(m["voxel_size"])
    l0, l1, l2 = (int(x) for x in m["log2_dims"])
    D = len(m["dir_check"])
    B = len(p)
    gkey = np.zeros(B, np.int64)
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
        key = (np.int64(d) << 40) | (np.int64(cofs) << 31) | np.int64(bits)
        gkey[i] = key if valid[i] else np.int64(D) << 40
        rows[:4, i] = d, chk, cofs, bits
    return gkey, rows


def tiles_model(m, p, rows, sg, order, threads=1024):
    """tiled_insert_tiles: the tile heads flag their rows (1 aliased, 2
    fresh) from the directory before any write; then chunks of `threads`
    rows in row order, a block scan ranking the fresh heads, each head
    that does not overflow writing its entry and its slot's key. Writes
    m in place; returns (n_alloc, n_dropped)."""
    D, T = len(m["dir_check"]), len(m["slot_key"])
    vs = F32(m["voxel_size"])
    B = len(p)
    flag = rows[4]
    for r in range(B):
        sdir = sg[r] >> 40
        if sdir < D and (r == 0 or (sg[r - 1] >> 40) != sdir):
            row = order[r]
            flag[row] = 1 if m["dir_check"][rows[0, row]] != EMPTY else 2
    base, carry = int(m["n_alloc"]), 0
    for c0 in range(0, B, threads):
        f = flag[c0:c0 + threads]
        incl = np.cumsum(f == 2)
        for j in np.nonzero(f)[0]:
            i, d = c0 + j, rows[0, c0 + j]
            new_slot = base + carry + int(incl[j]) - 1
            if f[j] == 2 and new_slot >= T:
                continue
            slot_w = m["dir_slot"][d] if f[j] == 1 else new_slot
            m["dir_check"][d] = rows[1, i]
            m["dir_slot"][d] = slot_w
            m["slot_key"][slot_w] = np.floor(p[i] / vs).astype(np.int32) >> 3
        carry += int(incl[-1]) if len(incl) else 0
    return np.int32(min(base + carry, T)), np.int32(m["n_dropped"])


def cells_model(m, p, valid, rows, sg, order, n_dropped):
    """tiled_insert_cells: each (dir_idx, cell) run's head walks to the
    run's first ok row, which replaces a dead or farther stored cell;
    the valid rows that are not ok add to n_dropped."""
    D, T = len(m["dir_check"]), len(m["slot_key"])
    vs = F32(m["voxel_size"])
    B = len(p)
    ok = valid & (m["dir_check"][rows[0]] == rows[1])
    for r in range(B):
        scell = sg[r] >> 31
        if (sg[r] >> 40) >= D or (r > 0 and (sg[r - 1] >> 31) == scell):
            continue
        q = r
        while q < B and (sg[q] >> 31) == scell and not ok[order[q]]:
            q += 1
        if q == B or (sg[q] >> 31) != scell:
            continue
        w = order[q]
        cell = int(np.clip(m["dir_slot"][rows[0, w]], 0, T - 1)) * 512 + rows[2, w]
        es = m["pts"][cell] - (np.floor(p[w] / vs).astype(np.int32).astype(F32) + F32(0.5)) * vs
        stored = (es[0] * es[0] + es[1] * es[1]) + es[2] * es[2]
        if m["cell_check"][cell] != rows[1, w] or rows[3, w:w + 1].view(F32)[0] < stored:
            m["cell_check"][cell] = rows[1, w]
            m["pts"][cell] = p[w]
    return np.int32(n_dropped + np.sum(valid & ~ok))


def insert_model(m, p, valid, threads=1024):
    """The three passes around the stable sort, on numpy copies of m."""
    m = {k: v.copy() for k, v in m.items()}
    gkey, rows = keys_model(m, p, valid)
    order = np.argsort(gkey, kind="stable")
    sg = gkey[order]
    m["n_alloc"], n_dropped = tiles_model(m, p, rows, sg, order, threads)
    m["n_dropped"] = cells_model(m, p, valid, rows, sg, order, n_dropped)
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


@pytest.mark.parametrize("threads", [1024, 7])
@pytest.mark.parametrize("case", INSERT_CASES)
def test_insert_passes_in_numpy_are_insert_plain(case, threads):
    """The kernels' passes, written out in numpy (with the scan's chunk of
    1024 rows, and of 7 so that small batches carry ranks across
    chunks), give insert_plain's map bit for bit after every batch."""
    def check(before, p, v, m):
        want = insert_model(before, p, v, threads)
        got = convert.tiled_map_to_arrays(m)
        for f in want:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)

    m = replay(case, check)
    if case in ("overflow", "aliasing"):
        assert int(m.n_dropped) > 0
    if case == "overflow":
        assert int(m.n_alloc) == m.slot_key.shape[0]


@pytest.mark.parametrize("case", INSERT_CASES)
def test_insert_plain_passes_match_the_model(case):
    """Each plain pass's outputs (keys and rows; the directory, slot keys
    and counts; the cells) equal the numpy model's; where a run's sorted
    head is not ok, the second row of the run wins its cell."""
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
        wd = cells_model(mk, p, v, rk, sg.numpy(), order_np, want[1])
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


# --- the undistortion -------------------------------------------------------

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
