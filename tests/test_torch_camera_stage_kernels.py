"""Port parity: the camera frame's stage kernels' plain versions on the CPU.

Three stages that the port runs as hand-written kernels on the card: the
voxel filter's key pass (csrc/voxel_keys.cu, plain version
`ops/voxel_filter.voxel_keys_plain`; on every LIO scan and camera cloud),
the camera cloud's voxel dedup (csrc/vio_dedup.cu, plain version
`vio._dedup_voxels_plain`) and the image-pool push (csrc/vio_push.cu,
plain version `visual_map.push_image_plain`). On the CPU each wrapper runs
its plain version, which is held here against the JAX package on seeded
inputs (tests/torch_camera_stage_cases.py): the dedup's keys and mask and
the push's pool and frame ids bit-equal after every push; the key pass
through the whole device filter (masks equal, centroids within the
rtol and atol 1e-6 of tests/test_torch_map_stages.py). Each kernel's
decomposition is also written out in numpy and held bit for bit against
its plain version: the keys a thread a row in f32; the dedup's rounds in
one block, rows strided over its threads, the table set again each
round, the survivors compacted a tile of 1024 rows at a time (the dedup
kernel's first design; the redesigned kernel's round-tagged table and
one-scan compaction, and the voxel filter's sort, are modelled in
tests/test_torch_voxel_sort.py); the push's per-block histograms summed
in any order and its argmin as the least packed (key order bits, slot),
in its two forms: up to ONE_BARRIER_MAX_R pool slots one grid barrier
(the ranks a warp a slot over the grid before it, stored beside the
counts; each block's own argmin of all the keys after it, the pairs
zeroed by the last block's ticket), past it two (the
keys a warp a slot, one 64-bit word for the slot); the modelled pool
equal to push_image_plain's and the JAX package's push_image's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastlivo_tpu import vio as jvio
from fastlivo_tpu import visual_map as jvm
from fastlivo_tpu.ops import voxel_filter as jvf

from fastlivo_tpu_torch import vio as tvio
from fastlivo_tpu_torch import visual_map as tvm
from fastlivo_tpu_torch.ops import vio_dedup, vio_push
from fastlivo_tpu_torch.ops import voxel_filter as tvf

import torch_camera_stage_cases as cases

torch.set_num_threads(1)


# --- the voxel filter's key pass -----------------------------------------

def scale_of(leaf, inv):
    return (torch.tensor(leaf, dtype=torch.float32) if inv is None else None,
            None if inv is None else torch.tensor(inv, dtype=torch.float32))


def keys_by_thread(p, valid, leaf, inv):
    """The kernel's rule, a row at a time in f32: floorf of p / leaf (or p
    * inv), the cast to int64, the 20-bit fields packed in int64, 2^62
    for a row that is invalid or not finite."""
    out = np.empty(len(p), np.int64)
    s = np.float32(leaf if inv is None else inv)
    for i in range(len(p)):
        x = p[i, :3]
        if not (valid[i] and np.isfinite(x).all()):
            out[i] = 1 << 62
            continue
        k = [int(np.floor(np.float32(v / s) if inv is None else np.float32(v * s)))
             for v in x]
        f = [((v + (1 << 19)) & 0xFFFFF) for v in k]
        out[i] = f[0] << 40 | f[1] << 20 | f[2]
    return out


@pytest.mark.parametrize("case", cases.KEYS_CASES)
def test_voxel_keys_plain_is_the_kernels_rule(case):
    """voxel_keys_plain (the CPU's, the kernel's oracle) equals the kernel's
    thread-a-row rule bit for bit: NaN and inf rows and invalid rows at
    2^62, -0.0 at voxel 0, negative and wrapped coordinates; the CPU's
    wrapper runs the plain version and counts no launch."""
    p, valid, leaf, inv = cases.keys_case(case)
    lf, iv = scale_of(leaf, inv)
    n0 = tvf.voxel_keys.launches
    got = tvf.voxel_keys(torch.from_numpy(p), torch.from_numpy(valid), lf, iv).numpy()
    assert tvf.voxel_keys.launches == n0
    rows = np.arange(len(p)) if len(p) < 4096 else np.r_[0:600, len(p) - 400:len(p)]
    want = keys_by_thread(p[rows], valid[rows], leaf, inv)
    np.testing.assert_array_equal(got[rows], want)
    if case == "wrap":  # voxel 2^19 - 1 fills its 20-bit field, 2^19 wraps to 0
        assert [int(got[r]) >> 40 for r in (200, 201, 202, 203)] == [0xFFFFF, 0, 1, 0]
    if case in ("edges", "wrap"):
        assert (got[100:104] == 1 << 62).all() and (got[:64] == (1 << 19) * (
            (1 << 40) + (1 << 20) + 1)).all()


@pytest.mark.parametrize("case", cases.KEYS_CASES)
def test_voxel_filter_key_pass_matches_jax(case):
    """The whole device filter on the CPU (the key pass, torch's stable
    sort, the centroid) against the JAX package's voxel_downsample_device
    on the same rows: the voxels found and their order equal (the masks),
    the centroids within 1e-6. The camera cloud's reciprocal leaf against
    the JAX package's filter jitted with its 0.2 m leaf a constant, which
    XLA multiplies by the f32 reciprocal."""
    p, valid, leaf, inv = cases.keys_case(case)
    p3 = np.ascontiguousarray(p[:, :3])
    max_out = 16384
    lf, iv = scale_of(leaf, inv)
    ot, mt = tvf.voxel_downsample_device(torch.from_numpy(p3), torch.from_numpy(valid), lf,
                                         max_out, inv_leaf=iv)
    if inv is None:
        oj, mj = jvf.voxel_downsample_device(jnp.asarray(p3), jnp.asarray(valid),
                                             jnp.float32(leaf), max_out)
    else:
        oj, mj = jax.jit(lambda a, v: jvf.voxel_downsample_device(a, v, 0.2, max_out))(
            jnp.asarray(p3), jnp.asarray(valid))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    fin = np.isfinite(ot.numpy()).all(axis=1) & mt.numpy()
    np.testing.assert_allclose(ot.numpy()[fin], np.asarray(oj)[fin], rtol=1e-6, atol=1e-6)
    if case == "bits8":  # every voxel of the 4 x 8 x 8 range holds rows
        assert int(mt.sum()) == 256
    elif case not in ("all_invalid", "n1"):
        assert int(mt.sum()) > 1000


# --- the camera cloud's voxel dedup --------------------------------------

@pytest.mark.parametrize("case", cases.DEDUP_CASES)
def test_dedup_voxels_plain_matches_jax(case):
    """vio._dedup_voxels_plain (the CPU's, the kernel's oracle) against the
    JAX package's _dedup_voxels, keys and mask bit-equal: slot chains
    longer than four probes (leftovers kept), exact duplicates, more
    survivors than max_vox, nothing masked in, M not a power of two, M
    past the kernel's shared memory; vio._dedup_voxels and the wrapper
    on the CPU are the plain version and count no launch."""
    p, mask, max_vox = cases.dedup_case(case)
    pt, mk = torch.from_numpy(p), torch.from_numpy(mask)
    n0 = vio_dedup.vio_dedup.launches
    vt, kt = tvio._dedup_voxels_plain(pt, mk, max_vox)
    for fn in (tvio._dedup_voxels, vio_dedup.vio_dedup):
        v2, k2 = fn(pt, mk, max_vox)
        assert torch.equal(v2, vt) and torch.equal(k2, kt)
    assert vio_dedup.vio_dedup.launches == n0
    vj, kj = jvio._dedup_voxels(jnp.asarray(p), jnp.asarray(mask), max_vox)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    n = int(kt.sum())
    if case == "all_masked":
        assert n == 0 and not vt.any()
    elif case == "overflow":
        assert n == max_vox
    else:
        assert 0 < n < max_vox
        assert not vt[n:].any()


def dedup_one_block(p, mask, max_vox, threads=1024):
    """The kernel in numpy: rows strided over `threads`; a round sets the
    table to M, takes the minimum row id of each contender at (h + p) &
    (TB - 1), then each contender reads its slot's winner (itself: a
    winner; another row of its key: resolved; else it contends again);
    the survivors (winners and leftovers) compacted a tile of `threads`
    rows at a time by a scan of the tile's keep flags. Returns (vox,
    vmask, the leftover rows)."""
    M = len(p)
    keys = np.floor(p / np.float32(0.5)).astype(np.int32)
    TB = 1 << M.bit_length()
    h = cases.voxel_hash(keys, TB)
    state = np.where(mask, 0, 1)  # 0 contending, 1 resolved or masked out, 2 winner
    for rnd in range(4):
        table = np.full(TB, M, np.int64)
        slots = (h + rnd) & (TB - 1)
        for t in range(threads):  # the atomics in any order
            rows = np.arange(t, M, threads)
            c = rows[state[rows] == 0]
            np.minimum.at(table, slots[c], c)
        w = table[slots]
        c = state == 0
        win = c & (w == np.arange(M))
        same = c & ~win & (keys[np.minimum(w, M - 1)] == keys).all(axis=1)
        state[win], state[same] = 2, 1
    vox = np.zeros((max_vox, 3), np.int32)
    vmask = np.zeros(max_vox, bool)
    base = 0
    for r0 in range(0, M, threads):
        keep = state[r0:r0 + threads] != 1
        rank = base + np.cumsum(keep) - keep
        rows = np.arange(r0, min(r0 + threads, M))
        ok = keep & (rank < max_vox)
        vox[rank[ok]] = keys[rows[ok]]
        vmask[rank[ok]] = True
        base += int(keep.sum())
    return vox, vmask, int((state == 0).sum())


@pytest.mark.parametrize("case", cases.DEDUP_CASES)
def test_dedup_kernel_rounds_in_one_block(case):
    """The first design's one-block rounds (the table set again each
    round, the atomics' order free) and its tiled compaction give the
    plain version's keys and mask bit for bit; the chain case leaves rows
    unresolved after four rounds, which both keep."""
    p, mask, max_vox = cases.dedup_case(case)
    vt, kt = tvio._dedup_voxels_plain(torch.from_numpy(p), torch.from_numpy(mask), max_vox)
    vox, vmask, left = dedup_one_block(p, mask, max_vox)
    np.testing.assert_array_equal(vox, vt.numpy())
    np.testing.assert_array_equal(vmask, kt.numpy())
    if case == "chain":
        assert left > 0


# --- the image-pool push --------------------------------------------------

def torch_pool(sizes):
    """An empty torch pool of the case's sizes (its frame ids
    sizes["img_fid0"] where the case gives them)."""
    m = tvm.empty_visual_map(n_points=sizes["NP"], n_obs=sizes["KO"], table_size=1 << 10,
                             voxel_cap=4, ring=sizes["R"], height=sizes["H"],
                             width=sizes["W"], img_dtype=torch.uint8 if sizes["u8"] else None,
                             device="cpu")
    if "img_fid0" in sizes:
        m.img_fid.copy_(torch.from_numpy(sizes["img_fid0"]))
    return m


def jax_pool(sizes):
    m = jvm.empty_visual_map(n_points=sizes["NP"], n_obs=sizes["KO"], table_size=1 << 10,
                             voxel_cap=4, ring=sizes["R"], height=sizes["H"],
                             width=sizes["W"], img_dtype=jnp.uint8 if sizes["u8"] else None)
    return m._replace(img_fid=jnp.asarray(sizes["img_fid0"])) if "img_fid0" in sizes else m


@pytest.mark.parametrize("case", cases.PUSH_CASES)
def test_push_image_plain_matches_jax(case):
    """push_image_plain (the CPU's, the kernel's oracle) against the JAX
    package's push_image through a pool that fills and evicts (the least
    referenced, oldest first), re-pushes of a live fid, dead entries
    (stale fids, empties, slots out of range, rows past n_pts), on u8
    and f32 pools with pixels at .5 and outside [0, 255]: imgs and
    img_fid bit-equal after every push; push_image and the wrapper on
    the CPU are the plain version and count no launch."""
    sizes, steps = cases.push_steps(case)
    mt, mj = torch_pool(sizes), jax_pool(sizes)
    n0 = vio_push.vio_push.launches
    evicted = 0
    for k, (seed, fid, upd) in enumerate(steps):
        img = cases.push_image_of(sizes["H"], sizes["W"], seed)
        before = mt.img_fid.clone()
        push = (tvm.push_image, vio_push.vio_push, tvm.push_image_plain)[k % 3]
        mt = push(mt, torch.from_numpy(img), int(fid))
        mj = jvm.push_image(mj, jnp.asarray(img), jnp.int32(fid))
        np.testing.assert_array_equal(mt.img_fid.numpy(), np.asarray(mj.img_fid))
        np.testing.assert_array_equal(mt.imgs.numpy(), np.asarray(mj.imgs))
        evicted += int(((before >= 0) & (before != mt.img_fid)).sum())
        mt = cases.apply_ring_update(mt, fid, upd)
        mj = mj._replace(obs_slot=jnp.asarray(mt.obs_slot.numpy()),
                         obs_fid=jnp.asarray(mt.obs_fid.numpy()),
                         n_pts=jnp.int32(int(mt.n_pts)))
    assert vio_push.vio_push.launches == n0
    assert evicted > 0


def push_by_blocks(m, fid, G, rng):
    """The kernel's slot in numpy: G blocks each counting the live entries
    of its share n b / G .. n (b + 1) / G of the rows below n_pts into its
    own histogram, the histograms summed in a random order; then each
    slot's age rank and key, the least packed (key with its sign bit
    flipped) << 32 | slot. Returns (refs, slot)."""
    slot_a, fid_a = m.obs_slot.numpy(), m.obs_fid.numpy()
    img_fid = m.img_fid.numpy().astype(np.int64)
    R = len(img_fid)
    NP = slot_a.shape[0]
    n = min(max(int(m.n_pts), 0), NP)
    hists = []
    for b in range(G):
        s = np.clip(slot_a[n * b // G:n * (b + 1) // G], 0, R - 1).ravel()
        f = fid_a[n * b // G:n * (b + 1) // G].ravel()
        live = (f >= 0) & (img_fid[s] == f)
        hists.append(np.bincount(s[live], minlength=R))
    refs = np.zeros(R, np.int64)
    for b in rng.permutation(G):
        refs += hists[b]
    sl = np.arange(R)
    older = ((img_fid[None, :] < img_fid[:, None])
             | ((img_fid[None, :] == img_fid[:, None]) & (sl[None, :] < sl[:, None])))
    rank = older.sum(1)
    key = np.where(refs > 0, (np.minimum(refs, 200) + 1) * R + rank, rank)
    key = np.where(img_fid == fid, -2, key).astype(np.int32)
    packed = ((key.view(np.uint32) ^ np.uint32(0x80000000)).astype(np.uint64) << np.uint64(32)
              | sl.astype(np.uint64))
    return refs, int(packed.min() & np.uint64(0xFFFFFFFF))


@pytest.mark.parametrize("G", [1, 7, 264])
@pytest.mark.parametrize("case", ["evict", "repush", "dead"])
def test_push_slot_by_block_histograms(case, G):
    """The push kernel's decomposition: per-block histograms of the live
    entries, summed in any order, equal _live_slot_refs; the least
    packed key is push_slot's argmin (the lowest slot of the least key),
    before every push of a sequence."""
    rng = np.random.default_rng(G)
    sizes, steps = cases.push_steps(case)
    mt = torch_pool(sizes)
    for seed, fid, upd in steps:
        refs, slot = push_by_blocks(mt, fid, G, rng)
        np.testing.assert_array_equal(refs, tvm._live_slot_refs(mt).numpy())
        assert slot == int(tvm.push_slot(mt, torch.tensor(fid, dtype=torch.int32)))
        img = cases.push_image_of(sizes["H"], sizes["W"], seed)
        mt = tvm.push_image_plain(mt, torch.from_numpy(img), int(fid))
        mt = cases.apply_ring_update(mt, fid, upd)


PUSH_WARPS = 16  # the push kernel's warps a block


def push_one_barrier(m, fid, G, rng):
    """The one-barrier form's slot in numpy: the scratch's (count, rank)
    pairs start at 0; each of G blocks adds its share's histogram into the
    counts (the blocks in a random order) and stores the age ranks of its
    share of the slots (a warp a slot, grid-stride: slot s by block (s //
    16) % G) beside them; after the barrier each block reads all R pairs,
    forms every key and takes its own least packed (key with its sign bit
    flipped) << 32 | slot; the blocks take tickets in a random order and
    the last one zeroes the pairs and the ticket. Returns (refs, every
    block's slot, the scratch's pairs and ticket after the launch)."""
    slot_a, fid_a = m.obs_slot.numpy(), m.obs_fid.numpy()
    img_fid = m.img_fid.numpy().astype(np.int64)
    R = len(img_fid)
    NP = slot_a.shape[0]
    n = min(max(int(m.n_pts), 0), NP)
    pairs = np.zeros((R, 2), np.int64)
    sl = np.arange(R)
    for b in rng.permutation(G):
        s = np.clip(slot_a[n * b // G:n * (b + 1) // G], 0, R - 1).ravel()
        f = fid_a[n * b // G:n * (b + 1) // G].ravel()
        live = (f >= 0) & (img_fid[s] == f)
        pairs[:, 0] += np.bincount(s[live], minlength=R)
        mine = sl[(sl // PUSH_WARPS) % G == b]  # the slots of this block's warps
        older = ((img_fid[None, :] < img_fid[mine][:, None])
                 | ((img_fid[None, :] == img_fid[mine][:, None])
                    & (sl[None, :] < mine[:, None])))
        pairs[mine, 1] = older.sum(1)
    refs, rank = pairs[:, 0].copy(), pairs[:, 1].copy()  # what every block reads
    slots = []
    for b in range(G):
        key = np.where(refs > 0, (np.minimum(refs, 200) + 1) * R + rank, rank)
        key = np.where(img_fid == fid, -2, key).astype(np.int32)
        packed = ((key.view(np.uint32) ^ np.uint32(0x80000000)).astype(np.uint64)
                  << np.uint64(32) | sl.astype(np.uint64))
        slots.append(int(packed.min() & np.uint64(0xFFFFFFFF)))
    ticket = 0
    for b in rng.permutation(G):
        ticket += 1
        if ticket == G:  # the last block to read the pairs
            pairs[:] = 0
            ticket = 0
    return refs, slots, pairs, ticket


def pool_after(m, slot, img, fid):
    """The pool after the copy into `slot`: a u8 pool round(clamp(img, 0,
    255)) (rint: half to even), an f32 pool the image; img_fid[slot] the
    fid."""
    imgs, ids = m.imgs.numpy().copy(), m.img_fid.numpy().copy()
    imgs[slot] = (np.rint(np.clip(img, 0, 255)).astype(np.uint8) if imgs.dtype == np.uint8
                  else img)
    ids[slot] = fid
    return imgs, ids


PUSH_FORM_CASES = [(c, G) for c in cases.PUSH_CASES if c != "big" for G in (1, 7, 264)] + [
    ("big", 264)]


@pytest.mark.parametrize("case,G", PUSH_FORM_CASES,
                         ids=[f"{c}-{G}" for c, G in PUSH_FORM_CASES])
def test_push_forms_by_blocks(case, G):
    """The push as its launcher routes it, in numpy: up to
    ONE_BARRIER_MAX_R slots the one-barrier form (every block's own
    argmin over the (count, rank) pairs it reads after the barrier, the
    ranks a warp a slot over the grid, the last block's ticketed reset),
    past it (the
    "big" pool) the two-barrier form (push_by_blocks): every block's slot
    is push_slot's, the scratch ends back at 0, and the pool after the
    modelled copy equals push_image_plain's and the JAX package's
    push_image's, bit for bit, before and after every push of a
    sequence that fills and evicts."""
    rng = np.random.default_rng(G)
    sizes, steps = cases.push_steps(case)
    one = sizes["R"] <= vio_push.ONE_BARRIER_MAX_R
    assert one == (case != "big")
    mt, mj = torch_pool(sizes), jax_pool(sizes)
    for seed, fid, upd in steps:
        img = cases.push_image_of(sizes["H"], sizes["W"], seed)
        if one:
            refs, slots, scratch, ticket = push_one_barrier(mt, fid, G, rng)
            assert not scratch.any() and ticket == 0
        else:
            refs, slot = push_by_blocks(mt, fid, G, rng)
            slots = [slot]
        np.testing.assert_array_equal(refs, tvm._live_slot_refs(mt).numpy())
        want = int(tvm.push_slot(mt, torch.tensor(fid, dtype=torch.int32)))
        assert slots == [want] * len(slots)
        imgs, ids = pool_after(mt, want, img, fid)
        mt = tvm.push_image_plain(mt, torch.from_numpy(img), int(fid))
        mj = jvm.push_image(mj, jnp.asarray(img), jnp.int32(fid))
        for got in (mt.imgs.numpy(), np.asarray(mj.imgs)):
            np.testing.assert_array_equal(got, imgs)
        for got in (mt.img_fid.numpy(), np.asarray(mj.img_fid)):
            np.testing.assert_array_equal(got, ids)
        mt = cases.apply_ring_update(mt, fid, upd)
        mj = mj._replace(obs_slot=jnp.asarray(mt.obs_slot.numpy()),
                         obs_fid=jnp.asarray(mt.obs_fid.numpy()),
                         n_pts=jnp.int32(int(mt.n_pts)))


@pytest.mark.parametrize("stage", ["voxel_keys", "vio_dedup", "vio_push"])
def test_stage_wrappers_refuse_other_devices(stage):
    """A wrapper takes the CPU (its plain version) or CUDA (its kernel),
    nothing else: a meta tensor raises before any launch."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if stage == "voxel_keys":
            tvf.voxel_keys(torch.zeros((4, 3), device=meta),
                           torch.ones(4, dtype=torch.bool, device=meta),
                           torch.tensor(0.5, device=meta), None)
        elif stage == "vio_dedup":
            vio_dedup.vio_dedup(torch.zeros((4, 3), device=meta),
                                torch.ones(4, dtype=torch.bool, device=meta), 2)
        else:
            m = torch_pool(dict(NP=8, KO=2, R=2, H=4, W=4, u8=True))
            m = m._replace(**{f: getattr(m, f).to(meta) for f in m._fields})
            vio_push.vio_push(m, torch.zeros((4, 4), device=meta), 0)
