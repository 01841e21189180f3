"""Port parity: the camera frame's selection and visual-map upkeep, the
plain versions of the vio_select and vio_observations kernels, against
the JAX package.

On the CPU `ops/vio_select.vio_select` runs select_tracked +
select_new_points and `ops/vio_observations.vio_observations` runs
prep_observations + add_observations + add_points (their plain versions,
in the kernels' order of operations); the kernels themselves run only on
the card (tests/test_torch_cuda.py). The inputs are test_torch_vio.py's
scene: a visual map grown by the JAX package's Vio over three rendered
frames, and a next frame at a perturbed prior. Tolerances:
  - vio_select against JAX's select_tracked + select_new_points, with the
    u8 and the f32 pool, ncc_en on and off: idx, valid, search_level,
    cell_value and the add mask equal; patches atol 1e-3 and positions
    rtol 1e-6 where valid; errors rtol 1e-4 where valid; the new points'
    positions equal and scores rtol 1e-4 where added (the Shi-Tomasi box
    sums and the products run in another order than XLA's: a few ulp);
  - vio_observations against JAX's prep_observations + add_observations
    + add_points: every integer field of the map equal; the float fields
    equal where copied from inputs (positions, poses), within atol 1e-3
    (pixels) and rtol 1e-4 (scores) where computed; on the scene's frame,
    on the same map with every ring full (evictions), with the point pool
    full but for three rows (the new points past it dropped), and with
    two new voxels whose probe chains start at the same free slot;
  - an empty frame (no scan row, no voxel): nothing tracked or added,
    the map unchanged, as in JAX;
  - vio.frame_kernels_apply: True on a CUDA device without a mesh, False
    on the CPU, over a mesh and with the pool in slabs;
  - wider patches (P 10 and 16, the kernel's 128- and 256-wide trees):
    vio_select against JAX at the tolerances above, on the same map; the
    kernel's lane trees (vio_common.cuh's warp_tree, numpy model) give
    image.halving_sum's bits at vio._patch_sum's width for every P from
    2 to 16, random and adversarial values;
  - vio_observations over 3264 rows (a 640x512 camera at grid 10: past
    the kernel's 2048 rows in shared memory) against JAX at the
    tolerances above: the frame's rows, then invalid tracked rows and new
    points near the frame's;
  - the camera poses: both wrappers take a state's rot and pos (f64) with
    the extrinsics and return the pose they used, equal to vio._cam_pose
    and within 1e-6 of the JAX package's `Rci @ rot32.T`, `-rcw @ pos32 +
    Pci` (a matmul's order: a few ulp); vio_select on the scene's prior,
    vio_observations on the posterior with every ring full and with the
    point pool full. The JAX side is fed the port's poses, so that both
    select and update the same frame.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastlivo_tpu import vio as jvio
from fastlivo_tpu import visual_map as jvm
from fastlivo_tpu.ops.voxel_map import _slot_check as jslot

from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch import vio as tvio
from fastlivo_tpu_torch import visual_map as tvm
from fastlivo_tpu_torch.ops import vio_observations as vo
from fastlivo_tpu_torch.ops import vio_select as vs
from test_torch_vio import scene, stage_inputs  # noqa: F401  (fixture)

INT_FIELDS = ("n_obs", "n_pts", "obs_slot", "obs_fid", "obs_level", "vox_keys", "vox_count",
              "vox_idx", "img_fid", "imgs")


def arrays(m):
    return {f: np.array(v) for f, v in m._asdict().items()}


def both_maps(d):
    """The JAX and the port's map from one set of numpy arrays."""
    return (jvm.VisualMap(**{f: jnp.asarray(v) for f, v in d.items()}),
            convert.visual_map_from_arrays(d, "cpu"))


def statics(jv, P=None):
    return dict(grid_size=jv.grid_size, patch_size=P or jv.patch_size, gw=jv.gw, gh=jv.gh)


def state_pose(sc, dpos=(0.0, 0.0, 0.0)):
    """The scene's prior state moved by `dpos` (world, m): its rot and pos
    (f64 tensors), the extrinsics, and the port's camera pose of it
    (vio._cam_pose) as f32 numpy, which the JAX side is fed."""
    tv = sc["tv"]
    rot = torch.from_numpy(np.array(sc["prior"].rot, np.float64))
    pos = torch.from_numpy(np.asarray(sc["prior"].pos, np.float64) + np.asarray(dpos))
    rcw, pcw = tvio._cam_pose(tv.Rci, tv.Pci, rot, pos)
    return (rot, pos, tv.Rci, tv.Pci), rcw.numpy(), pcw.numpy()


def select_both(sc, d, pg, pm, vox, vm, ncc=False, P=None):
    jv, tv = sc["jv"], sc["tv"]
    jmap, tmap = both_maps(d)
    kw = statics(jv, P)
    thr = np.float32(0.5 if ncc else 100.0)
    state, rcw, pcw = state_pose(sc)
    tj = jvio.select_tracked(jmap, jv.cam, jnp.asarray(rcw), jnp.asarray(pcw),
                             jnp.asarray(sc["gray"]), jnp.asarray(pg), jnp.asarray(pm),
                             jnp.asarray(vox), jnp.asarray(vm), jv._out_thre_dev,
                             jnp.float32(thr), ncc_en=ncc, **kw)
    nj = jvio.select_new_points(jv.cam, jnp.asarray(rcw), jnp.asarray(pcw),
                                jnp.asarray(sc["gray"]), jnp.asarray(pg), jnp.asarray(pm),
                                tj.cell_value, **kw)
    t = torch.from_numpy
    got = vs.vio_select(tmap, tv.cam, *state, t(sc["gray"]), t(pg), t(pm), t(vox), t(vm),
                        tv._out_thre_dev, torch.tensor(thr), ncc_en=ncc, **kw)
    return (tj, nj), got


def assert_select_close(want, got):
    (tj, nj), (tt, nt, _) = want, got
    valid = np.asarray(tj.valid)
    for f in ("valid", "idx", "search_level", "cell_value"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(tj, f)),
                                      err_msg=f)
    np.testing.assert_allclose(tt.patch.numpy()[valid], np.asarray(tj.patch)[valid], atol=1e-3)
    np.testing.assert_allclose(tt.pos.numpy()[valid], np.asarray(tj.pos)[valid], rtol=1e-6)
    np.testing.assert_allclose(tt.errors.numpy()[valid], np.asarray(tj.errors)[valid],
                               rtol=1e-4)
    add = np.asarray(nj[3])
    np.testing.assert_array_equal(nt[3].numpy(), add)
    np.testing.assert_array_equal(nt[0].numpy()[add], np.asarray(nj[0])[add])
    np.testing.assert_allclose(nt[1].numpy()[add], np.asarray(nj[1])[add], atol=1e-3)
    np.testing.assert_allclose(nt[2].numpy()[add], np.asarray(nj[2])[add], rtol=1e-4)
    return valid, add


@pytest.mark.parametrize("pool", ["u8", "f32"])
@pytest.mark.parametrize("ncc", [False, True], ids=["ncc_off", "ncc_on"])
def test_vio_select_matches_jax(scene, pool, ncc):  # noqa: F811
    (pg, pm, vox, vm), _ = stage_inputs(scene)
    d = arrays(scene["jv"].vmap)
    assert d["imgs"].dtype == np.uint8
    if pool == "f32":
        d["imgs"] = d["imgs"].astype(np.float32)
    want, got = select_both(scene, d, pg, pm, vox, vm, ncc)
    valid, add = assert_select_close(want, got)
    assert valid.sum() > 10 and add.sum() > 5


@pytest.mark.parametrize("P", [10, 16])
@pytest.mark.parametrize("ncc", [False, True], ids=["ncc_off", "ncc_on"])
def test_vio_select_matches_jax_at_wide_patches(scene, P, ncc):  # noqa: F811
    """Patch sizes 10 and 16 on the scene's map (grown at 8: the map keeps
    observations and images, not patches), u8 pool."""
    (pg, pm, vox, vm), _ = stage_inputs(scene)
    d = arrays(scene["jv"].vmap)
    want, got = select_both(scene, d, pg, pm, vox, vm, ncc, P=P)
    assert got[0].patch.shape[1:] == (3, P, P)
    valid, add = assert_select_close(want, got)
    assert valid.sum() > 0 and add.sum() > 0


def lane_tree(x, width):
    """csrc/vio_common.cuh's warp_tree<width> in numpy f32: the values
    padded with zeros to `width`, lane l holding x[l + 32 h]; the levels
    above 32 in the lane (h + n / 2 onto h while n > 1), then the shuffle
    tree (lane l adds lane l + off, off 16 .. 1; a lane past 31 reads
    its own value); lane 0's sum."""
    x = np.concatenate([x, np.zeros(width - len(x), np.float32)]).astype(np.float32)
    y = x.reshape(width // 32, 32).copy()  # y[h, l] = x[l + 32 h]
    n = width // 32
    while n > 1:
        y[:n // 2] = y[:n // 2] + y[n // 2:n]
        n //= 2
    s = y[0].copy()
    off = 16
    while off:
        down = s.copy()
        down[:32 - off] = s[off:]
        s = s + down
        off //= 2
    return s[0]


def kernel_width(P):
    """The tree width csrc/vio_select.cu's launch picks from P."""
    return 64 if P * P <= 64 else (128 if P * P <= 128 else 256)


@pytest.mark.parametrize("values", ["random", "adversarial"])
@pytest.mark.parametrize("P", range(2, 17))
def test_lane_trees_keep_halving_sums_order(P, values):
    """The kernel's lane tree at its launch's width gives the bits of
    image.halving_sum at vio._patch_sum's width (64 for P <= 8, 128 for
    9-11, 256 for 12-16), on random values and on values whose sum
    depends on the order (magnitudes from 1e-30 to 1e30 mixed, with
    cancellation), zeros padding the patch to the width."""
    from fastlivo_tpu_torch.ops import image

    PP = P * P
    width = max(64, 1 << (PP - 1).bit_length())
    assert kernel_width(P) == width
    rng = np.random.default_rng(P + 100 * len(values))
    for _ in range(20):
        if values == "random":
            x = rng.normal(0, 1, PP) * 10.0 ** rng.integers(-3, 4, PP)
        else:
            x = rng.choice([1e30, -1e30, 1e-30, 1.0, -1.0, 3.0e7, 0.1, 2.0 ** -24, 0.0], PP)
            x = x * rng.uniform(0.5, 2.0, PP)
        x = x.astype(np.float32)
        want = image.halving_sum(torch.from_numpy(x)[None], width)[0]
        assert tvio._patch_sum(torch.from_numpy(x)[None])[0].view(torch.int32) == \
            want.view(torch.int32)
        got = np.float32(lane_tree(x, width))
        assert got.view(np.int32) == want.numpy().view(np.int32), (P, x)


def rows_inputs(inp, B, rng):
    """The frame's observation inputs over B rows (cells): its rows, then
    B - G rows whose tracked part is invalid (an index anywhere in the
    pool) and whose new points are the frame's moved by up to 5 cm (some
    in the same voxels), with its pixels, scores and add mask."""
    G = len(inp["idx"])
    k = rng.integers(0, G, B - G)
    out = dict(inp)
    out["idx"] = np.concatenate([inp["idx"], rng.integers(0, 4096, B - G).astype(np.int32)])
    out["valid"] = np.concatenate([inp["valid"], np.zeros(B - G, bool)])
    out["slevel"] = np.concatenate([inp["slevel"], inp["slevel"][k]])
    move = rng.uniform(-0.05, 0.05, (B - G, 3)).astype(np.float32)
    out["npos"] = np.concatenate([inp["npos"], inp["npos"][k] + move])
    for f in ("npx", "nscore", "nadd"):
        out[f] = np.concatenate([inp[f], inp[f][k]])
    return out


def test_vio_observations_matches_jax_at_3264_rows(scene):  # noqa: F811
    d, inp = frame_inputs(scene, arrays(scene["jv"].vmap))
    inp = rows_inputs(inp, 3264, np.random.default_rng(5))
    n0, NP = int(d["n_pts"]), d["pos"].shape[0]
    after, oadd, _ = observations_both(scene, d, inp)
    kept = min(int(inp["nadd"].sum()), NP - n0)
    assert kept > 300 and int(after["n_pts"]) == n0 + kept
    assert oadd.sum() == inp["valid"].sum() > 10


def frame_inputs(sc, d):
    """The scene's next frame selected by the JAX package on the map `d`,
    its image pushed first; the posterior pose 0.6 m from the prior (every
    tracked row passes the Δp gate). Returns (the map arrays after the
    push, the observation inputs as numpy: the posterior state rot2, pos2,
    the poses rcw2, pcw2 and rcw, pcw of the posterior and the prior)."""
    jv = sc["jv"]
    (pg, pm, vox, vm), _ = stage_inputs(sc)
    fid = np.int32(jv.fid)
    jmap = jvm.push_image(both_maps(d)[0], jnp.asarray(sc["gray"]), jnp.int32(fid))
    d = arrays(jmap)
    kw = statics(jv)
    _, rcw, pcw = state_pose(sc)
    tj = jvio.select_tracked(jmap, jv.cam, jnp.asarray(rcw), jnp.asarray(pcw),
                             jnp.asarray(sc["gray"]), jnp.asarray(pg), jnp.asarray(pm),
                             jnp.asarray(vox), jnp.asarray(vm), jv._out_thre_dev,
                             jv._ncc_thre_dev, **kw)
    nj = jvio.select_new_points(jv.cam, jnp.asarray(rcw), jnp.asarray(pcw),
                                jnp.asarray(sc["gray"]), jnp.asarray(pg), jnp.asarray(pm),
                                tj.cell_value, **kw)
    (rot2, pos2, _, _), rcw2, pcw2 = state_pose(sc, (0.6, 0.0, 0.0))
    inp = dict(rot2=rot2.numpy(), pos2=pos2.numpy(), rcw2=rcw2, pcw2=pcw2, rcw=rcw, pcw=pcw,
               idx=np.array(tj.idx), valid=np.array(tj.valid),
               slevel=np.array(tj.search_level), npos=np.array(nj[0]), npx=np.array(nj[1]),
               nscore=np.array(nj[2]), nadd=np.array(nj[3]), fid=fid)
    return d, inp


def observations_both(sc, d, inp):
    jv, tv = sc["jv"], sc["tv"]
    jmap, tmap = both_maps(d)
    j = {k: jnp.asarray(v) for k, v in inp.items() if k not in ("rot2", "pos2")}
    gray = jnp.asarray(sc["gray"])
    opc, osc, oadd = jvio.prep_observations(jmap, jv.cam, j["rcw2"], j["pcw2"], gray, j["idx"],
                                            j["valid"])
    jmap = jvm.add_observations(jmap, j["idx"], opc, j["rcw2"], j["pcw2"], osc, j["fid"],
                                j["slevel"], oadd)
    jmap = jvm.add_points(jmap, j["npos"], j["npx"], j["rcw"], j["pcw"], j["nscore"],
                          j["fid"], j["nadd"])
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in inp.items()}
    tmap, topc, tosc, pose2 = vo.vio_observations(
        tmap, tv.cam, torch.from_numpy(sc["gray"]), t["rot2"], t["pos2"], tv.Rci, tv.Pci,
        t["idx"], t["valid"], t["slevel"], t["rcw"], t["pcw"], t["npos"], t["npx"],
        t["nscore"], t["nadd"], t["fid"])
    np.testing.assert_array_equal(pose2[0].numpy(), inp["rcw2"])
    np.testing.assert_array_equal(pose2[1].numpy(), inp["pcw2"])
    a, b = arrays(jmap), convert.visual_map_to_arrays(tmap)
    for f in tvm.VisualMap._fields:
        assert a[f].dtype == b[f].dtype and a[f].shape == b[f].shape, f
        if f in INT_FIELDS + ("pos", "obs_rcw", "obs_pcw"):
            np.testing.assert_array_equal(b[f], a[f], err_msg=f)
        elif f == "value":
            np.testing.assert_allclose(b[f], a[f], rtol=1e-4, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_allclose(b[f], a[f], atol=1e-3, err_msg=f)
    valid = inp["valid"]
    np.testing.assert_allclose(topc.numpy()[valid], np.asarray(opc)[valid], atol=1e-3)
    np.testing.assert_allclose(tosc.numpy()[valid], np.asarray(osc)[valid], rtol=1e-4)
    return arrays(jmap), np.asarray(oadd), pose2


def fill_rings(d, rng):
    """Every live point's ring full: each empty entry a copy of entry 0
    at a pose moved by up to 0.3 m, so that the furthest view differs."""
    n = int(d["n_pts"])
    KO = d["obs_fid"].shape[1]
    for f in ("obs_px", "obs_rcw", "obs_pcw", "obs_slot", "obs_fid", "obs_level"):
        d[f] = d[f].copy()
    for p in range(n):
        for o in range(int(d["n_obs"][p]), KO):
            for f in ("obs_px", "obs_rcw", "obs_slot", "obs_fid", "obs_level"):
                d[f][p, o] = d[f][p, 0]
            d["obs_pcw"][p, o] = d["obs_pcw"][p, 0] + rng.uniform(-0.3, 0.3, 3)
    d["n_obs"] = np.where(np.arange(len(d["n_obs"])) < n, KO, d["n_obs"]).astype(np.int32)
    return d


@pytest.mark.parametrize("case", ["frame", "full_rings", "pool_full", "shared_slot"])
def test_vio_observations_matches_jax(scene, case):  # noqa: F811
    d, inp = frame_inputs(scene, arrays(scene["jv"].vmap))
    n0, NP = int(d["n_pts"]), d["pos"].shape[0]
    assert inp["valid"].sum() > 10 and inp["nadd"].sum() > 5
    if case == "full_rings":
        d = fill_rings(d, np.random.default_rng(4))
    if case == "pool_full":
        d["n_pts"] = np.asarray(NP - 3, np.int32)
    if case == "shared_slot":
        # two voxels whose probe chains start at one free slot, both added
        T = d["vox_keys"].shape[0]
        grid = np.stack(np.meshgrid(*[np.arange(-8, 8)] * 3, indexing="ij"), -1).reshape(-1, 3)
        slot, check = (np.asarray(a) for a in jslot(jnp.asarray(grid, jnp.int32), T - 1))
        free = (d["vox_keys"] == tvm.EMPTY) & (np.roll(d["vox_keys"], -1) == tvm.EMPTY)
        first = {}
        for i in range(len(grid)):
            j = first.setdefault(slot[i], i)
            if j != i and check[i] != check[j] and free[slot[i]]:
                a, b = j, i
                break
        rows = np.flatnonzero(inp["nadd"])[:2]
        inp["npos"] = inp["npos"].copy()
        inp["npos"][rows] = (grid[[a, b]] + 0.5) * 0.5
    after, oadd, _ = observations_both(scene, d, inp)
    kept = int(inp["nadd"].sum())
    if case == "pool_full":
        assert int(after["n_pts"]) == NP and kept > 3
    else:
        assert int(after["n_pts"]) == n0 + kept
    assert oadd.sum() == inp["valid"].sum()  # the 0.6 m step adds every tracked row
    if case == "full_rings":
        idx = inp["idx"][inp["valid"]]
        assert (after["n_obs"][idx] == d["obs_fid"].shape[1]).all()
    if case == "shared_slot":
        s0 = slot[a]
        keys = after["vox_keys"]
        T = len(keys)
        assert {keys[s0], keys[(s0 + 1) % T]} == {check[a], check[b]}


def test_empty_frame_matches_jax(scene):  # noqa: F811
    (pg, pm, vox, vm), _ = stage_inputs(scene)
    d = arrays(scene["jv"].vmap)
    want, got = select_both(scene, d, pg, np.zeros_like(pm), vox, np.zeros_like(vm))
    valid, add = assert_select_close(want, got)
    assert not valid.any() and not add.any() and not got[0].cell_value.any()
    d2, inp = frame_inputs(scene, d)
    inp.update(valid=np.zeros_like(inp["valid"]), nadd=np.zeros_like(inp["nadd"]))
    after, _, _ = observations_both(scene, d2, inp)
    for f, v in d2.items():
        np.testing.assert_array_equal(after[f], v, err_msg=f)


@pytest.mark.parametrize("case", ["cuda", "cpu", "mesh", "pool_sharded"])
def test_frame_kernels_apply(case):
    """The routing rule of vio_frame_step and Vio.update_staged: the
    kernels on one CUDA device with no mesh, the torch code elsewhere (the
    pool in slabs, `pool_sharded`, needs a mesh: vio_frame_step refuses
    it without one)."""
    dev = "cpu" if case == "cpu" else torch.device("cuda")
    mesh = object() if case in ("mesh", "pool_sharded") else None
    assert tvio.frame_kernels_apply(dev, mesh) == (case == "cuda")
    if case == "pool_sharded":
        with pytest.raises(ValueError, match="requires a mesh"):
            tvio.vio_frame_step(*[None] * 14, grid_size=40, patch_size=8, gw=16, gh=12,
                                ncc_en=False, max_iter=1, max_pg=8, pool_sharded=True)


def test_cpu_frame_takes_the_plain_versions(scene, monkeypatch):  # noqa: F811
    """On the CPU the wrappers run their plain versions and launch
    nothing; vio_frame_step calls the torch code itself."""
    calls = []
    monkeypatch.setattr(vs, "_launcher", lambda: calls.append("select"))
    monkeypatch.setattr(vo, "_launcher", lambda: calls.append("observations"))
    (pg, pm, vox, vm), _ = stage_inputs(scene)
    n = (vs.vio_select.launches, vo.vio_observations.launches)
    _, got = select_both(scene, arrays(scene["jv"].vmap), pg, pm, vox, vm)
    d, inp = frame_inputs(scene, arrays(scene["jv"].vmap))
    observations_both(scene, d, inp)
    assert not calls and (vs.vio_select.launches, vo.vio_observations.launches) == n
    assert int(got[0].valid.sum()) > 10


def jax_pose(Rci, Pci, rot, pos):
    """The JAX package's camera pose of a state (fastlivo_tpu/vio.py's
    `Rci @ rot32.T`, `-rcw @ pos32 + Pci`), as numpy."""
    rcw = jnp.asarray(Rci.numpy()) @ jnp.asarray(rot.numpy(), jnp.float32).T
    pcw = -rcw @ jnp.asarray(pos.numpy(), jnp.float32) + jnp.asarray(Pci.numpy())
    return np.asarray(rcw), np.asarray(pcw)


@pytest.mark.parametrize("case", ["select", "full_rings", "pool_full"])
def test_poses_from_the_state(scene, case):  # noqa: F811
    """Each wrapper's pose is the state's (vio._cam_pose, bit for bit) and
    the JAX package's within 1e-6: vio_select's of the prior state, and
    vio_observations' of the posterior one, also with every ring full
    and with the point pool full (where the kept observations evict and
    the new points are dropped)."""
    if case == "select":
        (pg, pm, vox, vm), _ = stage_inputs(scene)
        _, got = select_both(scene, arrays(scene["jv"].vmap), pg, pm, vox, vm)
        (rot, pos, Rci, Pci), _, _ = state_pose(scene)
        rcw, pcw = got[2]
    else:
        d, inp = frame_inputs(scene, arrays(scene["jv"].vmap))
        if case == "full_rings":
            d = fill_rings(d, np.random.default_rng(5))
        else:
            d["n_pts"] = np.asarray(d["pos"].shape[0] - 2, np.int32)
        after, oadd, (rcw, pcw) = observations_both(scene, d, inp)
        assert oadd.sum() > 10
        if case == "pool_full":
            assert int(after["n_pts"]) == d["pos"].shape[0]
        rot, pos = torch.from_numpy(inp["rot2"]), torch.from_numpy(inp["pos2"])
        Rci, Pci = scene["tv"].Rci, scene["tv"].Pci
    want = tvio._cam_pose(Rci, Pci, rot, pos)
    assert rcw.dtype == pcw.dtype == torch.float32
    assert torch.equal(rcw, want[0]) and torch.equal(pcw, want[1])
    jr, jp = jax_pose(Rci, Pci, rot, pos)
    np.testing.assert_allclose(rcw.numpy(), jr, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pcw.numpy(), jp, rtol=0, atol=1e-6)
