"""CLI runner: replay a rosbag, or a synthetic dataset, through the pipeline.

    python -m fastlivo_tpu_torch.run --config avia.yaml \\
        [--camera camera_pinhole.yaml] --bag run.bag --out traj.txt

    python -m fastlivo_tpu_torch.run --synthetic \\
        [--config avia.yaml] [--camera camera_pinhole.yaml] [--no-img] \\
        [--duration 8] [--out traj.txt] [--eval] [--device cpu]

Runs LIVO (LiDAR + IMU + camera) when the config enables the camera and
LIO with `--no-img` (a bag without `--camera` runs LIO). Runs on CUDA
unless `--device cpu` is given. Offline replay defers each frame's
readback by one frame (`--sync-read` turns that off; outputs are the
same); `--block N` replays in blocks of N events with one read per block.
Writes a TUM trajectory (t x y z qx qy qz qw, laserMapping.cpp:
1738-1748), optionally the Log/ traces (`--log-dir`), the accumulated
world cloud (`--pcd-out`: RGB-painted in LIVO mode, intensity in LIO
mode), the map's points (`--map-pcd`), a checkpoint (`--save-ckpt`) and
PNG frames of the cloud and path (`--viz-dir`, every `--viz-every`
frames; needs matplotlib), and prints per-stage timing (with
`--profile-every N`, also each LIO stage's time on its own). With
`debug` in the config, reads stay synchronous. Without `--config` (or
`--launch`) the built-in `Config()` defaults are used.

`--mesh N` runs LIO or LIVO over N ranks, one spawned process each
(parallel/launch.py): NCCL with one card per rank, or gloo with
`--device cpu`. Every rank replays the same stream; the scan's rows and
the camera frame's candidate, cell and photometric rows are split over
the ranks and the EKFs' reductions cross the mesh (parallel/product.py).
`--sharded-map` also block-shards the map and holds the camera's image
pool and observation rings in per-rank slabs. Rank 0 writes every output
file and prints the summary.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from . import preprocess as pp
from .camera import load_camera_yaml
from .config import OUST64, VELO16, XT32, Config, load_config
from .logging_util import write_tum
from .pipeline import Pipeline


def _lidar_fields(msg_type: str, msg: dict, lidar_type: int) -> dict:
    """A decoded lidar message as preprocess.decode's field dict."""
    p = msg["points"]
    if msg_type == "livox_ros_driver/CustomMsg":
        return {
            "xyz": np.stack([p["x"], p["y"], p["z"]], 1),
            "reflectivity": p["reflectivity"].astype(np.float32),
            "tag": p["tag"],
            "line": p["line"],
            "offset_time_ns": p["offset_time"].astype(np.float64),
        }
    names = p.dtype.names
    xyz = np.stack([p["x"], p["y"], p["z"]], 1)

    def field(name, default):
        return p[name] if name in names else default

    zeros = np.zeros(len(p))
    if lidar_type == VELO16:
        return {"xyz": xyz, "intensity": field("intensity", zeros),
                "time_s": field("time", zeros),
                "ring": field("ring", np.zeros(len(p), np.int32))}
    if lidar_type == OUST64:
        return {"xyz": xyz, "intensity": field("intensity", zeros),
                "t_ns": field("t", zeros),
                "ring": field("ring", np.zeros(len(p), np.int32))}
    if lidar_type == XT32:
        return {"xyz": xyz, "intensity": field("intensity", zeros),
                "timestamp_s": field("timestamp", zeros)}
    raise ValueError(f"unsupported lidar_type {lidar_type} for {msg_type}")


def _make_replayer(pipe: Pipeline, block: int, block_scan: bool = False):
    """Block replay: by default the per-frame path with block-packed
    readback (LivoBlockReplayer, LIO or LIVO); `block_scan` (LIO only)
    runs the block's frames in replay.lidar_block_step instead. The two
    give the same positions; the choice is kept for parity with the JAX
    package's command line, which compiles the block into one scan."""
    from .replay import BlockReplayer, LivoBlockReplayer

    if block_scan and not pipe.cfg.img_enable:
        return BlockReplayer(pipe, block)
    return LivoBlockReplayer(pipe, block)


def run_bag(pipe: Pipeline, bag_path: str, max_frames: int | None,
            block: int = 0, rate: float = 0.0, block_scan: bool = False):
    """Replay a bag; returns the number of frames. `rate` > 0 paces the
    messages at that multiple of wall-clock time by their stamps (the
    `rosbag play -r` role); 0 replays as fast as possible. With `block`
    the messages are all ingested first and replayed in blocks, and
    `max_frames` caps the ingested scans."""
    from .io.rosbag import bgr_normalize, read_bag

    cfg = pipe.cfg
    topics = {cfg.lid_topic, cfg.imu_topic}
    img_topics = ()
    img_topic_locked = None  # the first image stream seen wins
    if cfg.img_enable:
        # bags often store the compressed stream: accept both names, and
        # push each frame once when a bag carries both
        img_topics = (cfg.img_topic, cfg.img_topic + "/compressed")
        topics.update(img_topics)
    replayer = _make_replayer(pipe, block, block_scan) if block else None
    n_frames = 0
    n_scans = 0
    t_wall0 = time.perf_counter()
    t_bag0 = None
    for topic, mtype, stamp, msg in read_bag(bag_path, topics):
        if rate > 0:
            if t_bag0 is None:
                t_bag0 = stamp
            lag = (stamp - t_bag0) / rate - (time.perf_counter() - t_wall0)
            if lag > 0:
                time.sleep(lag)
        if topic == cfg.imu_topic:
            pipe.push_imu(msg["stamp"], msg["acc"], msg["gyr"])
        elif topic == cfg.lid_topic:
            fields = _lidar_fields(mtype, msg, cfg.preprocess.lidar_type)
            pts, t_rel = pp.decode(fields, cfg.preprocess)
            if len(pts) > 1:
                pipe.push_lidar(msg["stamp"], pts, t_rel)
                n_scans += 1
        elif topic in img_topics:
            if img_topic_locked is None:
                img_topic_locked = topic
            if topic == img_topic_locked:
                img = bgr_normalize(msg["image"], msg.get("encoding", "bgr8"))
                pipe.push_img(msg["stamp"] + cfg.delta_time, img)
        if replayer is None:
            n_frames += len(pipe.spin())
        if max_frames and (n_frames >= max_frames
                           or (replayer is not None and n_scans >= max_frames)):
            break
    if replayer is not None:
        before = len(pipe.outputs)
        replayer.run()
        n_frames += len(pipe.outputs) - before
    n_frames += len(pipe.finish())  # the deferred tail
    return n_frames


def run_synthetic(pipe: Pipeline, duration: float, points_per_scan: int = 8192,
                  block: int = 0, block_scan: bool = False):
    """Feed a SyntheticDataset (LiDAR + IMU, and 10 Hz images rendered
    through the config's camera when it is enabled) through `pipe`;
    returns (frames, dataset)."""
    from .io.synthetic import SyntheticDataset

    cfg = pipe.cfg
    cam = cfg.camera
    ds = SyntheticDataset(
        duration=duration,
        points_per_scan=points_per_scan,
        lidar_noise=0.004,
        cam_hz=10.0 if cfg.img_enable else 0.0,
        cam_size=(cam.width, cam.height),
        cam_f=cam.fx,
        cam_fy=cam.fy,
        cam_c=(cam.cx, cam.cy),
        cam_d=np.asarray(cam.d[:4]),
        Rcl=cfg.Rcl_mat,
        Pcl=cfg.Pcl_vec,
        lid_rot=cfg.extrinsic_R,
        lid_off=cfg.extrinsic_T,
    )
    for beg, pts, t_rel in ds.lidar_scans_fast():
        pipe.push_lidar(beg, pts, t_rel)
    for t, acc, gyr in ds.imu_stream():
        pipe.push_imu(t, acc, gyr)
    for t, img in ds.images():
        pipe.push_img(t, img)
    if block:
        n0 = len(pipe.outputs)
        outs = _make_replayer(pipe, block, block_scan).run()[n0:]
    else:
        outs = pipe.spin() + pipe.finish()
    return len(outs), ds


def save_pcd(path: str, pts: np.ndarray, rgb: np.ndarray | None = None,
             intensity: np.ndarray | None = None):
    """Minimal ASCII PCD writer (pcd_save_en path, laserMapping.cpp:
    1839-1855). With `rgb` (N, 3) in [0,255], writes the packed rgb
    field of pcl::PointXYZRGB (the reference's LIVO RGB map cloud);
    with `intensity` (N,), writes PointXYZI (the reference's LIO-mode
    intensity-colored cloud, README 4.1); else PointXYZ."""
    with open(path, "w") as f:
        if rgb is None and intensity is not None:
            f.write(
                "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
                "FIELDS x y z intensity\nSIZE 4 4 4 4\nTYPE F F F F\n"
                "COUNT 1 1 1 1\n"
                f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
                f"POINTS {len(pts)}\nDATA ascii\n")
            np.savetxt(f, np.concatenate(
                [pts[:, :3], np.asarray(intensity, np.float32)[:, None]], 1),
                fmt="%.4f")
            return
        if rgb is not None:
            packed = ((np.asarray(rgb[:, 0], np.uint32) << 16)
                      | (np.asarray(rgb[:, 1], np.uint32) << 8)
                      | np.asarray(rgb[:, 2], np.uint32)).view(np.int32)
            f.write(
                "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
                "FIELDS x y z rgb\nSIZE 4 4 4 4\nTYPE F F F U\nCOUNT 1 1 1 1\n"
                f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
                f"POINTS {len(pts)}\nDATA ascii\n")
            for p, c in zip(pts[:, :3], packed):
                f.write("%.4f %.4f %.4f %d\n" % (p[0], p[1], p[2], c))
            return
        f.write(
            "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
            "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
            f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
            f"POINTS {len(pts)}\nDATA ascii\n")
        np.savetxt(f, pts[:, :3], fmt="%.4f")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default=None, help="FAST-LIVO style YAML")
    ap.add_argument("--camera", default=None,
                    help="vikit-style camera YAML (camera_pinhole.yaml)")
    ap.add_argument("--launch", default=None,
                    help="reference launch file (launch/mapping_*.launch): "
                    "resolves --config/--camera from its <rosparam> entries")
    ap.add_argument("--bag", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--duration", type=float, default=8.0)
    ap.add_argument("--out", default="trajectory.txt")
    ap.add_argument("--no-img", action="store_true", help="force LIO-only")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on the CPU)")
    ap.add_argument("--log-dir", default=None, help="write the Log/ traces here")
    ap.add_argument("--pcd-out", default=None,
                    help="write the accumulated world cloud: RGB-painted in LIVO "
                    "mode, intensity-colored in LIO mode")
    ap.add_argument("--map-pcd", default=None,
                    help="export the map's live points to a PCD at exit")
    ap.add_argument("--save-ckpt", default=None,
                    help="write state + maps + IMU calib (.npz) at exit")
    ap.add_argument("--load-ckpt", default=None,
                    help="restore state + maps (+ IMU calib) before replay")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="with --bag: pace messages at this multiple of "
                    "wall-clock time (rosbag play -r; 0 = as fast as possible)")
    ap.add_argument("--block", type=int, default=0,
                    help="offline replay in N-event blocks, one packed "
                    "device read per block")
    ap.add_argument("--block-scan", action="store_true",
                    help="with --block in LIO mode: run each block's frames "
                    "in replay.lidar_block_step")
    ap.add_argument("--profile-every", type=int, default=0,
                    help="every N steady frames, also run the LIO stages one "
                    "by one and print their times (laserMapping.cpp:1805)")
    ap.add_argument("--viz-dir", default=None,
                    help="live visualization: render the world cloud and path to "
                    "PNG frames in this directory (latest.png tracks the newest; "
                    "the rviz surface, laserMapping.cpp:1377-1389); needs matplotlib")
    ap.add_argument("--viz-every", type=int, default=5,
                    help="render every N-th frame (with --viz-dir)")
    ap.add_argument("--sync-read", action="store_true",
                    help="read each frame's results before the next frame "
                    "(by default offline replay defers the read one frame; "
                    "the outputs are the same)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="run LIO or LIVO over N ranks, one process each (NCCL, "
                    "one card per rank; gloo with --device cpu; 0 = one device). "
                    "The scan's and the camera frame's rows are split over the "
                    "ranks; positions match one device to f32-reduction epsilon")
    ap.add_argument("--sharded-map", action="store_true",
                    help="with --mesh N: block-shard the map over the ranks "
                    "(ownership-striped tile slabs, per-rank pool tiled_pool/N); "
                    "the EKF searches a per-scan halo snapshot gathered from the "
                    "owners (parallel/sharded_map.py)")
    ap.add_argument(
        "--eval", action="store_true",
        help="with --synthetic: print ATE RMSE vs the known trajectory and "
        "position-NEES filter consistency (eval.py)",
    )
    args = ap.parse_args(argv)
    if args.launch:
        from .config import parse_launch

        cfg_yaml, cam_yaml = parse_launch(args.launch)
        args.config = args.config or str(cfg_yaml)
        if args.camera is None and cam_yaml is not None:
            args.camera = str(cam_yaml)
    if not (args.bag or args.synthetic):
        ap.error("need --bag or --synthetic")
    if args.eval and (args.block or not args.synthetic):
        # block replay keeps no per-frame covariance
        ap.error("--eval needs --synthetic without --block")
    cfg = load_config(args.config) if args.config else Config()
    if args.camera:
        cfg.camera = load_camera_yaml(args.camera)
    if args.no_img or (args.bag and args.camera is None):
        cfg.img_enable = False
    if args.pcd_out:
        cfg.pcd_save_en = True
    if args.mesh:
        if args.block:
            # block replay is per device; the mesh runs per frame
            ap.error("--mesh and --block are mutually exclusive")
    elif args.sharded_map:
        ap.error("--sharded-map requires --mesh N")
    if args.sharded_map and args.load_ckpt:
        ap.error("--sharded-map cannot restore a single-device map "
                 "checkpoint (re-run without --sharded-map, or rebuild "
                 "the map from the stream)")
    if args.mesh:
        from .parallel.launch import launch, mesh_backend

        return launch(_run_rank, args.mesh, (args, cfg),
                      backend=mesh_backend(args.device, args.mesh))[0]
    return _run(args, cfg)


def _run_rank(rank: int, n: int, args, cfg) -> int:
    """`run --mesh N`'s rank program (parallel.launch.launch)."""
    from .parallel.launch import rank_device
    from .parallel.sharded import make_mesh

    return _run(args, cfg, make_mesh(n, device=rank_device(args.device)))


def _run(args, cfg, mesh=None) -> int:
    """The run after argument parsing; under a mesh every rank runs it and
    rank 0 writes the outputs (the map's gathers are collectives, called
    on every rank)."""
    lead = mesh is None or mesh.rank == 0
    pipe = Pipeline(cfg, device=None if mesh else args.device, log_dir=args.log_dir,
                    mesh=mesh, sharded_map=args.sharded_map)
    pipe.profile_every = args.profile_every
    if not args.sync_read and not args.block and not cfg.debug:
        # offline default: frame N's read overlaps frame N+1's dispatch;
        # debug keeps sync reads for the overlay
        pipe.async_read = True
    if args.viz_dir and lead:
        from .viz import LiveViewer

        pipe.on_frame = LiveViewer(args.viz_dir, every=args.viz_every).update
    if args.load_ckpt:
        from .io import checkpoint as ckpt_mod

        # with a calib in the snapshot, IMU init is skipped and the EKF
        # engages on the first restored frame
        pipe.warm_start(*ckpt_mod.load(args.load_ckpt, device=pipe.device))
    pipe.collect_cov = args.eval  # per-frame covariance for NEES
    t0 = time.perf_counter()
    ds = None
    if args.bag:
        n = run_bag(pipe, args.bag, args.max_frames, args.block, rate=args.rate,
                    block_scan=args.block_scan)
    else:
        n, ds = run_synthetic(pipe, args.duration, block=args.block,
                              block_scan=args.block_scan)
    wall = time.perf_counter() - t0

    if args.map_pcd:
        pts_live, n_live = pipe._map_mod.extract_points(pipe.map)
    # a collective under a mesh: every rank joins, rank 0 gets the arrays
    ckpt_arrays = pipe.checkpoint_arrays() if args.save_ckpt else None
    if not lead:
        return 0
    traj = pipe.tum_trajectory()
    if len(traj):
        write_tum(args.out, traj)
    if args.pcd_out and pipe.outputs:
        if pipe.rgb_cloud:
            # the RGB world map (pcl_wait_save, laserMapping.cpp:778, 1841)
            acc = np.concatenate(pipe.rgb_cloud)
            save_pcd(args.pcd_out, acc[:, :3], acc[:, 3:6])
        else:
            keep = [o for o in pipe.outputs if o.pts_world is not None]
            if keep:
                pts = np.concatenate([o.pts_world for o in keep])
                inten = None
                if all(o.intensity is not None and len(o.intensity) == len(o.pts_world)
                       for o in keep):
                    inten = np.concatenate([o.intensity for o in keep])
                save_pcd(args.pcd_out, pts, intensity=inten)
    tm = {}
    if pipe.outputs:
        tm = {k: float(np.mean([o.timing[k] for o in pipe.outputs])) * 1e3
              for k in pipe.outputs[0].timing}
    where = f"mesh={mesh.size}{'+sharded-map' if args.sharded_map else ''} " if mesh else ""
    print(f"frames={n} wall={wall:.1f}s device={pipe.device} {where}"
          + " ".join(f"{k}={v:.1f}ms" for k, v in tm.items()))
    if pipe.vio is not None:
        print(f"vio: frames={pipe.vio.fid} map_points={int(pipe.vio.vmap.n_pts)} "
              f"last={pipe.vio.last_stats}")
    if pipe.auto_resets:
        print(f"divergence watchdog fired {pipe.auto_resets}x "
              "(mapping restarted; see capacity.auto_reset_rms)")
    print(f"trajectory: {args.out} ({len(traj)} poses)")
    if args.eval:
        from .eval import evaluate_synthetic

        m = evaluate_synthetic(pipe.outputs, pipe.covs, ds)
        print("eval: " + " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in m.items()))
    if args.map_pcd:
        save_pcd(args.map_pcd, pts_live)
        print(f"map pcd: {args.map_pcd} ({n_live} points)")
    if args.save_ckpt:
        from .io import checkpoint as ckpt_mod

        ckpt_mod.write(args.save_ckpt, ckpt_arrays)
        print(f"checkpoint: {args.save_ckpt}")
    if pipe.last_stage_profile:
        print("stage profile (ms): " + " ".join(
            f"{k}={v:.1f}" for k, v in pipe.last_stage_profile.items()))
    if pipe.logger is not None:
        pipe.logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
