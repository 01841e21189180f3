"""Port parity: the block-sharded tiled map (parallel/sharded_map.py,
parallel/sharded_backend.py) on gloo ranks against the JAX package on
the conftest's virtual CPU devices, at meshes of 2 and 4.

Exact, array for array: the ownership partition (owner_of, disjoint and
complete), shard_insert, extract_blocks (with and without a truncating
budget), build_snapshot (the halo exchange's gathered snapshot and its
overflow count), the snapshot's kNN (also against the full map),
sharded_compact, every ShardedTiledBackend operation, and the halo
overflow count of a starved MeshRunner step (halo_tiles=4). The EKF
state of that step agrees with JAX at pos 1e-5 / rot 1e-6. The
snapshot's kNN equals the port's full-map kNN exactly and JAX's with
the distances within 1 ulp (XLA contracts their multiply-adds).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from fastlivo_tpu import imu as jimu
from fastlivo_tpu.ops import tiled_map as jtm
from fastlivo_tpu.parallel import sharded as jsh
from fastlivo_tpu.parallel import sharded_map as jsm
from fastlivo_tpu.parallel.product import MeshRunner as JRunner
from fastlivo_tpu.parallel.sharded_backend import ShardedTiledBackend as JBackend
from fastlivo_tpu.state import identity_state

from fastlivo_tpu_torch.ops import tiled_map as tm
from fastlivo_tpu_torch.parallel import sharded_map as sm
from fastlivo_tpu_torch.parallel.launch import launch

import torch_mesh_ranks as ranks
from test_lio import make_room_points

DIMS, POOL, VS = (64, 64, 32), 512, 0.3
K_EXCH, K_SMALL = 512, 16
MESHES = [2, 4]


def run(fn, n, *args):
    return launch(fn, n, args, timeout=120, deadline=300)


def local(shards, d):
    return jax.tree.map(lambda x: x[d], shards)


def assert_same(port: dict, jx, label=""):
    """Every field of a port NamedTuple's arrays equal to the JAX value's."""
    for f, v in port.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jx, f)), err_msg=f"{label}.{f}")


def padded_room():
    world = make_room_points(step=0.15)
    pad = np.zeros((((len(world) + 255) // 256) * 256, 3), np.float32)
    pad[:len(world)] = world
    mask = np.arange(len(pad)) < len(world)
    return world, pad, mask


@pytest.fixture(scope="module", params=MESHES)
def lib(request):
    """The library on both sides: shards, blocks, the snapshot and its
    kNN, the compacted shards."""
    n = request.param
    world, pad, mask = padded_room()
    lo = (world.min(0) - 0.5).astype(np.float32)
    hi = (world.max(0) + 0.5).astype(np.float32)
    q = (world[::7][:512] + 0.02).astype(np.float32)
    del_lo = np.array([[-6.0, -6.0, -1.0]], np.float32)
    del_hi = np.array([[0.0, 6.0, 4.0]], np.float32)

    mesh = jsh.make_mesh(n)

    def ins(shard, w, wm):
        loc = jax.tree.map(lambda x: x[0], shard)
        l2 = jsm.shard_insert(loc, w, wm, jax.lax.axis_index("dp"), n)
        return jax.tree.map(lambda x: x[None], l2)

    shards = jsm.make_shards(n, DIMS, POOL, VS)
    spec = jax.tree.map(lambda _: P("dp"), shards)
    shards = shard_map(ins, mesh=mesh, in_specs=(spec, P(), P()), out_specs=spec,
                       check_vma=False)(shards, jnp.asarray(pad), jnp.asarray(mask))
    jl, jh = jnp.asarray(lo), jnp.asarray(hi)
    blocks = [jsm.extract_blocks(local(shards, d), jl, jh, K_EXCH) for d in range(n)]
    small = [jsm.extract_blocks(local(shards, d), jl, jh, K_SMALL) for d in range(n)]
    cat = [jnp.concatenate([b[i] for b in blocks]) for i in range(4)]
    snap = jsm.build_snapshot(*cat, local(shards, 0).voxel_size, dir_dims=DIMS)
    dropped = sum(int(b[4]) for b in blocks)
    deleted = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jtm.delete_boxes(local(shards, d), jnp.asarray(del_lo), jnp.asarray(del_hi))
        for d in range(n)])
    compacted = jsm.sharded_compact(mesh, deleted)
    full = jtm.insert(jtm.empty_tiled_map(DIMS, 2048, VS), jnp.asarray(pad), jnp.asarray(mask))
    jax_side = dict(shards=shards, blocks=blocks, small=small, snap=snap, dropped=dropped,
                    knn=jtm.knn(snap, jnp.asarray(q), 5, 1),
                    full_knn=jtm.knn(full, jnp.asarray(q), 5, 1), compacted=compacted)

    port = run(ranks.sharded_map_rank, n, pad, mask, DIMS, POOL, VS, lo, hi, K_EXCH, K_SMALL,
               q, del_lo, del_hi)
    port_small = [r["small"] for r in port]
    full_t = tm.insert(tm.empty_tiled_map(DIMS, 2048, VS, device="cpu"),
                       torch.as_tensor(pad), torch.as_tensor(mask))
    full_knn = tm.knn(full_t, torch.as_tensor(q), 5, 1)
    return n, jax_side, port, port_small, full_knn


@pytest.mark.parametrize("slab", [4, 3])
def test_owner_of_matches_jax(slab):
    rng = np.random.default_rng(0)
    tkey = rng.integers(-300, 300, (4096, 3)).astype(np.int32)
    for n in (1, 2, 3, 4, 8):
        got = sm.owner_of(torch.as_tensor(tkey), n, slab).numpy()
        want = np.asarray(jsm.owner_of(jnp.asarray(tkey), n, slab))
        np.testing.assert_array_equal(got, want)
        assert got.min() >= 0 and got.max() < n


def test_ownership_partition_is_disjoint_and_complete(lib):
    """Each shard holds only tiles it owns, and the shards' live cells are
    the full map's."""
    n, _, port, _, _ = lib
    total = 0
    for r, res in enumerate(port):
        sh = res["shard"]
        k = int(sh["n_alloc"])  # 0 where the room lies in no slab of rank r
        owners = sm.owner_of(torch.as_tensor(sh["slot_key"][:k]), n).numpy()
        assert (owners == r).all()
        live = tm.extract_points(tm.TiledMap(**{f: torch.as_tensor(v)
                                                for f, v in sh.items()}))[1]
        total += live
    world, pad, mask = padded_room()
    full = tm.insert(tm.empty_tiled_map(DIMS, 2048, VS, device="cpu"),
                     torch.as_tensor(pad), torch.as_tensor(mask))
    assert total == tm.extract_points(full)[1] > 1000


def test_shard_insert_matches_jax(lib):
    n, jx, port, _, _ = lib
    for r in range(n):
        assert_same(port[r]["shard"], local(jx["shards"], r), f"rank {r}")


@pytest.mark.parametrize("budget", ["ample", "truncating"])
def test_extract_blocks_matches_jax(lib, budget):
    n, jx, port, port_small, _ = lib
    mine = [r["blocks"] for r in port] if budget == "ample" else port_small
    theirs = jx["blocks"] if budget == "ample" else jx["small"]
    for r in range(n):
        for i, name in enumerate(("keys", "cell_check", "pts", "valid", "dropped")):
            np.testing.assert_array_equal(mine[r][i], np.asarray(theirs[r][i]),
                                          err_msg=f"rank {r} {name}")
    if budget == "truncating":
        assert sum(int(b[4]) for b in mine) > 0  # the budget cut tiles


def test_snapshot_matches_jax(lib):
    """The gathered snapshot (build_snapshot of the all-gathered blocks) is
    JAX's on every rank, and no tile overflowed the budget."""
    n, jx, port, _, _ = lib
    for r in range(n):
        assert_same(port[r]["snap"], jx["snap"], f"rank {r}")
        assert port[r]["dropped"] == jx["dropped"] == 0


def test_snapshot_knn_matches_full_map(lib):
    n, jx, port, _, full_knn = lib
    neigh_f, d2_f, v_f = (x.numpy() for x in full_knn)
    assert v_f.sum() > 1000
    for r in range(n):
        neigh, d2, valid = port[r]["knn"]
        np.testing.assert_array_equal(valid, v_f)
        np.testing.assert_array_equal(d2, d2_f)
        # a neighbour slot that found nothing holds whatever its pool cell does
        np.testing.assert_array_equal(neigh[valid], neigh_f[v_f])
        _, j_d2, j_valid = (np.asarray(x) for x in jx["knn"])
        np.testing.assert_array_equal(valid, j_valid)
        # XLA contracts the distance's multiply-adds: 1 ulp apart, which
        # may pick another of two grid points tied for the fifth place
        np.testing.assert_allclose(d2, j_d2, rtol=2e-7, atol=0)
    np.testing.assert_array_equal(v_f, np.asarray(jx["full_knn"][2]))


def test_sharded_compact_matches_jax(lib):
    n, jx, port, _, _ = lib
    for r in range(n):
        assert_same(port[r]["compact"], local(jx["compacted"], r), f"rank {r}")
    assert sum(int(p["compact"]["n_alloc"]) for p in port) < sum(
        int(p["shard"]["n_alloc"]) for p in port)


@pytest.fixture(scope="module", params=MESHES)
def backend(request):
    """Every ShardedTiledBackend operation on both sides (the scene of the
    JAX package's test_sharded_backend_ops_match_single_device)."""
    n = request.param
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(3):
        pts = np.stack([rng.uniform(-30, 30, 512), rng.uniform(-30, 30, 512),
                        rng.uniform(0.0, 2.0, 512)], axis=1).astype(np.float32)
        batches.append((pts, rng.random(512) < 0.9))
    lo = np.array([[-30.0, -30.0, -30.0]], np.float32)
    hi = np.array([[0.0, 30.0, 30.0]], np.float32)
    be = JBackend(jsh.make_mesh(n))
    sh = be.empty((16, 16, 8), 2048, 0.5)
    for pts, mask in batches:
        sh = be.insert(sh, jnp.asarray(pts), jnp.asarray(mask))
    jx = dict(inserted=sh, points=be.extract_points(sh)[0], pool=be.pool_per_shard(sh),
              occupancy=be.max_occupancy(sh))
    sh = be.delete_boxes(sh, jnp.asarray(lo), jnp.asarray(hi))
    jx["deleted"] = sh
    sh = be.compact(sh)
    jx["compacted"], jx["points_after"] = sh, be.extract_points(sh)[0]
    port = run(ranks.backend_rank, n, (16, 16, 8), 2048, 0.5, batches, lo, hi)
    return n, jx, port


@pytest.mark.parametrize("op", ["inserted", "deleted", "compacted"])
def test_backend_ops_match_jax(backend, op):
    n, jx, port = backend
    for r in range(n):
        assert_same(port[r][op], local(jx[op], r), f"{op} rank {r}")


def test_backend_gathers_match_jax(backend):
    """extract_points on every rank equals JAX's (the shards in rank
    order), pool_per_shard is tiled_pool / n, max_occupancy the fullest
    shard's."""
    n, jx, port = backend
    for r in range(n):
        for key in ("points", "points_after"):
            np.testing.assert_array_equal(port[r][key], jx[key])
        assert port[r]["pool"] == jx["pool"] == 2048 // n
        assert port[r]["occupancy"] == jx["occupancy"] > 0
    assert len(port[0]["points"]) > 100 and 0 < len(port[0]["points_after"])


def _calib_jax():
    return jimu.ImuCalib(
        acc_scale=jnp.float32(1.0), cov_acc=jnp.full(3, 0.01, jnp.float32),
        cov_gyr=jnp.full(3, 0.001, jnp.float32),
        cov_bias_acc=jnp.full(3, 1e-5, jnp.float32),
        cov_bias_gyr=jnp.full(3, 1e-5, jnp.float32),
        lid_rot=jnp.eye(3, dtype=jnp.float32), lid_off=jnp.zeros(3, jnp.float32))


def _pose_jax(k=8):
    return jimu.PoseTable(
        offs=jnp.asarray(np.linspace(0, 0.1, k, dtype=np.float32)),
        rot=jnp.tile(jnp.eye(3, dtype=jnp.float32)[None], (k, 1, 1)),
        pos=jnp.zeros((k, 3), jnp.float32), vel=jnp.zeros((k, 3), jnp.float32),
        acc=jnp.zeros((k, 3), jnp.float32), gyr=jnp.zeros((k, 3), jnp.float32))


def arrays(nt):
    return {f: np.asarray(v) for f, v in nt._asdict().items()}


@pytest.mark.parametrize("n", MESHES)
def test_halo_overflow_is_counted(n):
    """A starved halo budget (halo_tiles=4) lands in the shards' n_dropped,
    as JAX's test_halo_overflow_is_counted; the counts and the step's
    state equal JAX's."""
    rng = np.random.default_rng(0)
    world = np.stack([rng.uniform(-30, 30, 8000), rng.uniform(-30, 30, 8000),
                      rng.uniform(0, 2, 8000)], 1).astype(np.float32)
    scan = (world[rng.choice(8000, 2048, replace=False)]
            - np.array([0.0, 0.0, 1.0])).astype(np.float32)
    state = identity_state()._replace(pos=jnp.asarray([0.0, 0.0, 1.0]))
    calib, pose = _calib_jax(), _pose_jax()
    kw = dict(laser_point_cov=0.001, max_points=2048, max_iter=2, knn_radius=1,
              max_probe=8, dense_out=False)
    mesh = jsh.make_mesh(n)
    be = JBackend(mesh)
    shards = be.insert(be.empty((32, 32, 8), 2048, 0.5), jnp.asarray(world),
                       jnp.ones(8000, bool))
    runner = JRunner(mesh, sharded_map=True, halo_tiles=4, snap_dims=(32, 32, 8))
    jout = runner.lidar_frame_step(
        state, shards, pose, calib, jnp.asarray(scan), jnp.zeros(2048, jnp.float32),
        jnp.ones(2048, bool), jnp.float32(0.5), **kw)
    port = run(ranks.frame_step_rank, n, True, world, (32, 32, 8), 2048, 0.5,
               arrays(state), arrays(pose), arrays(calib), scan,
               np.zeros(2048, np.float32), np.ones(2048, bool), 0.5, kw, 4)
    want = np.asarray(jout[1].n_dropped)
    assert want.sum() > 0
    for r in range(n):
        assert int(port[r]["map"]["n_dropped"]) == want[r]
        np.testing.assert_allclose(port[r]["state"]["pos"], np.asarray(jout[0].pos),
                                   atol=1e-5)
        np.testing.assert_allclose(port[r]["state"]["rot"], np.asarray(jout[0].rot),
                                   atol=1e-6)


def test_blockmap_scan_step_matches_jax(lib):
    """sharded_blockmap_scan_step (propagation, undistortion, the halo
    exchange, the EKF against the snapshot, the ownership-masked insert)
    on the scene of the JAX package's
    test_blockmap_scan_step_matches_single_device: the snapshot's tiles
    and every shard's tiles equal JAX's, the state within pos 1e-5 / rot
    1e-6, n_active within 2."""
    n, jx, _, _, _ = lib
    world, pad, mask = padded_room()
    rng = np.random.default_rng(0)
    P, N = 16, 2048
    prop = dict(acc=np.tile(np.array([0.0, 0.0, 9.81], np.float32), (P, 1)),
                gyr=np.zeros((P, 3), np.float32), dt=np.full(P, 0.005, np.float32),
                offs=np.cumsum(np.full(P, 0.005, np.float32)).astype(np.float32),
                valid=np.ones(P, bool), tail=np.float32(0.0),
                acc_s_last=np.zeros(3, np.float32), angvel_last=np.zeros(3, np.float32))
    state = identity_state()._replace(pos=jnp.asarray([0.05, -0.04, 0.03]),
                                      grav=jnp.asarray([0.0, 0.0, -9.81]))
    scan = (world[rng.choice(len(world), N, replace=False)]
            + rng.normal(0, 0.003, (N, 3))).astype(np.float32)
    t_rel = np.linspace(0, 0.08, N).astype(np.float32)
    calib = _calib_jax()
    kw = dict(laser_point_cov=0.001, max_iter=4, knn_radius=1, k_exch=512)
    jst, jshards, jn, jtiles = jsm.sharded_blockmap_scan_step(
        jsh.make_mesh(n), state, jx["shards"], *[jnp.asarray(prop[k]) for k in (
            "acc", "gyr", "dt", "offs", "valid", "tail", "acc_s_last", "angvel_last")],
        calib, jnp.asarray(scan), jnp.asarray(t_rel), jnp.ones(N, bool), **kw)
    port = run(ranks.blockmap_step_rank, n, pad, mask, DIMS, POOL, VS, arrays(state), prop,
               arrays(calib), scan, t_rel, kw)
    for r in range(n):
        got = port[r]
        np.testing.assert_allclose(got["state"]["pos"], np.asarray(jst.pos), atol=1e-5)
        np.testing.assert_allclose(got["state"]["rot"], np.asarray(jst.rot), atol=1e-6)
        assert abs(got["n_active"] - int(jn)) <= 2 and got["n_active"] > N // 2
        assert got["snap_tiles"] == int(jtiles) > 10
        mine, theirs = got["shard"], local(jshards, r)
        assert int(mine["n_alloc"]) == int(theirs.n_alloc)
        np.testing.assert_array_equal(mine["slot_key"], np.asarray(theirs.slot_key))
        np.testing.assert_array_equal(got["state"]["pos"], port[0]["state"]["pos"])
