"""Configuration dataclasses mirroring the reference parameter surface.

Every field name follows the rosparam name read by `readParameters`
(reference: src/laserMapping.cpp:1096-1137) or the camera YAML loaded by
vikit (config/camera_pinhole.yaml), so existing FAST-LIVO YAML configs
load unchanged via `load_config`.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional

import numpy as np
import yaml

# lidar_type enum (reference: include/preprocess.h:13)
AVIA = 1
VELO16 = 2
OUST64 = 3
XT32 = 4


@dataclasses.dataclass
class CameraConfig:
    """Pinhole camera intrinsics + radtan distortion (camera_*.yaml)."""

    width: int = 640
    height: int = 512
    fx: float = 400.0
    fy: float = 400.0
    cx: float = 300.0
    cy: float = 300.0
    # radial-tangential distortion [k1, k2, p1, p2]
    d: List[float] = dataclasses.field(default_factory=lambda: [0.0, 0.0, 0.0, 0.0])


@dataclasses.dataclass
class PreprocessConfig:
    lidar_type: int = AVIA
    n_scans: int = 6  # preprocess/scan_line
    blind: float = 0.01  # preprocess/blind
    point_filter_num: int = 2
    feature_extract_enable: bool = False


@dataclasses.dataclass
class MappingConfig:
    acc_cov_scale: float = 1.0
    gyr_cov_scale: float = 1.0
    # LiDAR -> IMU extrinsics (mapping/extrinsic_T, extrinsic_R)
    extrinsic_T: List[float] = dataclasses.field(default_factory=lambda: [0.0, 0.0, 0.0])
    extrinsic_R: List[float] = dataclasses.field(
        default_factory=lambda: [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0]
    )


@dataclasses.dataclass
class CapacityConfig:
    """Fixed capacities with no reference equivalent (the reference uses
    dynamic containers). Device batches are padded to these."""

    # "tiled" (default): two-level tile directory + pool — long-range AND
    # probe-free (ops/tiled_map.py). "dense": single rolling grid,
    # fastest for bounded extents. "hash": open-addressing table.
    map_backend: str = "tiled"
    dense_dims: tuple = (256, 256, 64)  # rolling-grid dims (powers of two)
    tiled_dir_dims: tuple = (128, 128, 64)  # tile-directory dims (tiles)
    tiled_pool: int = 16384  # pool capacity in tiles (512 cells each)
    # opt-in numerics/perf switches (see lio.lio_update docstrings)
    cache_knn: bool = False  # re-rank cached kNN candidates on rematches
    mixed_gain: bool = False  # f32 gain solve + one f64 refinement
    # IRLS robust weighting of VIO photometric rows: "none" (reference
    # behavior) | "huber" | "tukey" — completes the vk::robust_cost
    # scaffolding the reference leaves commented out
    # (lidar_selection.cpp:75-78, 839-842)
    vio_robust: str = "none"
    # LIO plane-fit backend: "tls" (centered orthogonal regression,
    # default — f32-stable far from the origin) | "ref" (the exact
    # esti_plane A·n=-1 parametrization, common_lib.h:449-493, solved in
    # f64). Measured end-to-end equivalent; see tests/test_reference_algebra.py
    plane_fit: str = "tls"
    # opt-in Pallas fused top-5 + TLS plane fit on the LIO search leg
    # (ops/pallas_lio.py; A/B'd in docs/PERF_ANALYSIS.md round 5)
    pallas_knn: bool = False
    # Update the map buffers in place instead of copying the whole map
    # each frame (~143 MB geometric at shipped capacities). The torch
    # port always updates in place; the field is kept so YAML configs
    # load unchanged.
    donate_maps: bool = True
    # divergence watchdog (beyond-reference, default OFF): when
    # res_rms stays above auto_reset_rms for auto_reset_frames
    # consecutive frames the pipeline RESTARTS MAPPING at the current
    # pose (fresh geometric+visual maps; state/trajectory kept) —
    # after losing track (e.g. a motion-phase IMU gap) there is no
    # relocalization (the reference has none either), so the map is
    # permanently poisoned and drift compounds; the restart freezes
    # the accumulated offset instead. 0.0 disables.
    auto_reset_rms: float = 0.0
    auto_reset_frames: int = 10
    # sliding-local-map mode: "ref" (default) reproduces the reference's
    # lasermap_fov_segment exactly — including its runaway-slide quirk
    # with shipped cube_side_length values (lio.LocalMapTracker
    # docstring), under which map boundedness rests on pool compaction;
    # "clamped" re-centers the window on the sensor instead, so the
    # emitted delete boxes actually bound the map for ANY cube size
    slider: str = "ref"
    map_table_size: int = 1 << 20  # voxel-hash slots (one map point per slot)
    max_probe: int = 12  # open-addressing probe depth (= insert's depth)
    knn_voxel_radius: int = 1  # 3x3x3 neighborhood for the 5-NN gather;
    # 2 widens to 5x5x5 for very sparse maps (voxel >> point spacing)
    max_points: int = 16384  # padded scan size fed to the LIO update
    max_raw_points: int = 32768  # padded raw scan size for undistortion
    max_imu_per_group: int = 64  # padded IMU samples per measurement group
    # VIO capacities
    vmap_points: int = 65536  # visual map point capacity
    vmap_obs: int = 20  # observations per point (lidar_selection.cpp:944)
    vmap_voxel_cap: int = 8  # visual points indexed per 0.5 m voxel
    vmap_table_size: int = 1 << 18  # visual voxel-hash slots
    # Reference-image pool depth. Images are retained with the
    # reference's shared_ptr semantics (feature.h:40): a slot is only
    # reused once no live observation references its image; at
    # saturation the least-referenced image is evicted
    # (visual_map.push_image). Quantified on the 25 s yaw-sweep revisit
    # scenario (scripts/quantify_ring_eviction.py).
    frame_ring: int = 256
    # store the pool quantized to u8 — the reference itself keeps
    # frames as u8 cv::Mats (feature.h:40), and u8 buys a 4x deeper
    # pool per byte of HBM (256 u8 slots = the old 64 f32 slots). An
    # f32 pool (frame_ring_u8: false) preserves the fractional
    # BGR->gray weights instead; the two trajectories differ only by
    # the <=0.5-level ref-image quantization (tests/test_vio.py).
    frame_ring_u8: bool = True
    max_tracked: int = 512  # padded sub_sparse_map size (grid cells)
    max_cands: int = 8192  # padded visual candidate gather size
    # --- block-sharded geometric map (--mesh N --sharded-map) ---------
    # Per-DEVICE contribution to the per-scan halo snapshot, in tiles;
    # the gathered snapshot holds halo_tiles * n_devices tiles and must
    # cover every tile intersecting the scan's padded AABB (parallel/
    # sharded_map.extract_blocks drops the excess, which would cost
    # kNN parity — size generously; 256 tiles = 1024 m^2 of surface
    # at the default 4 m tiles).
    halo_tiles: int = 256


@dataclasses.dataclass
class Config:
    # top-level params (laserMapping.cpp:1098-1136)
    dense_map_enable: bool = True
    img_enable: bool = True
    lidar_enable: bool = True
    debug: bool = False
    max_iteration: int = 4  # NUM_MAX_ITERATIONS
    ncc_en: bool = False
    ncc_thre: float = 100.0
    laser_point_cov: float = 0.001
    img_point_cov: float = 10.0
    filter_size_surf: float = 0.5
    filter_size_map: float = 0.5
    cube_side_length: float = 200.0
    grid_size: int = 40
    patch_size: int = 8
    outlier_threshold: float = 100.0
    pose_output_en: bool = False
    pcd_save_en: bool = False
    delta_time: float = 0.0
    # topics (common.lid_topic / common.imu_topic / camera.img_topic)
    lid_topic: str = "/livox/lidar"
    imu_topic: str = "/livox/imu"
    img_topic: str = "/left_camera/image"

    preprocess: PreprocessConfig = dataclasses.field(default_factory=PreprocessConfig)
    mapping: MappingConfig = dataclasses.field(default_factory=MappingConfig)
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    # camera-from-lidar extrinsics (camera/Rcl, camera/Pcl)
    Rcl: List[float] = dataclasses.field(
        default_factory=lambda: [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0]
    )
    Pcl: List[float] = dataclasses.field(default_factory=lambda: [0.0, 0.0, 0.0])

    capacity: CapacityConfig = dataclasses.field(default_factory=CapacityConfig)

    # --- convenience accessors -------------------------------------------
    @property
    def extrinsic_R(self) -> np.ndarray:
        return np.asarray(self.mapping.extrinsic_R, dtype=np.float64).reshape(3, 3)

    @property
    def extrinsic_T(self) -> np.ndarray:
        return np.asarray(self.mapping.extrinsic_T, dtype=np.float64)

    @property
    def Rcl_mat(self) -> np.ndarray:
        return np.asarray(self.Rcl, dtype=np.float64).reshape(3, 3)

    @property
    def Pcl_vec(self) -> np.ndarray:
        return np.asarray(self.Pcl, dtype=np.float64)


def _get(d: dict, key: str, default):
    return d.get(key, default)


def load_config(yaml_path: str | Path, camera_yaml: Optional[str | Path] = None) -> Config:
    """Load a FAST-LIVO style YAML (e.g. reference config/avia.yaml) plus
    an optional camera YAML (config/camera_pinhole.yaml)."""
    with open(yaml_path) as f:
        raw = yaml.safe_load(f)
    cfg = Config()
    cfg.dense_map_enable = bool(_get(raw, "dense_map_enable", 1))
    cfg.img_enable = bool(_get(raw, "img_enable", 1))
    cfg.lidar_enable = bool(_get(raw, "lidar_enable", 1))
    cfg.max_iteration = int(_get(raw, "max_iteration", 4))
    cfg.ncc_en = bool(_get(raw, "ncc_en", False))
    cfg.ncc_thre = float(_get(raw, "ncc_thre", 100.0))
    cfg.laser_point_cov = float(_get(raw, "laser_point_cov", 0.001))
    cfg.img_point_cov = float(_get(raw, "img_point_cov", 10.0))
    cfg.filter_size_surf = float(_get(raw, "filter_size_surf", 0.5))
    cfg.filter_size_map = float(_get(raw, "filter_size_map", 0.5))
    cfg.cube_side_length = float(_get(raw, "cube_side_length", 200.0))
    cfg.grid_size = int(_get(raw, "grid_size", 40))
    cfg.patch_size = int(_get(raw, "patch_size", 4))
    cfg.outlier_threshold = float(_get(raw, "outlier_threshold", 100.0))
    cfg.pose_output_en = bool(_get(raw, "pose_output_en", False))
    cfg.delta_time = float(_get(raw, "delta_time", 0.0))

    pre = raw.get("preprocess", {})
    cfg.preprocess = PreprocessConfig(
        lidar_type=int(_get(pre, "lidar_type", AVIA)),
        n_scans=int(_get(pre, "scan_line", 16)),
        blind=float(_get(pre, "blind", 0.01)),
        point_filter_num=int(_get(raw, "point_filter_num", 2)),
        feature_extract_enable=bool(_get(raw, "feature_extract_enable", 0)),
    )
    mp = raw.get("mapping", {})
    cfg.mapping = MappingConfig(
        acc_cov_scale=float(_get(mp, "acc_cov_scale", 1.0)),
        gyr_cov_scale=float(_get(mp, "gyr_cov_scale", 1.0)),
        extrinsic_T=list(_get(mp, "extrinsic_T", [0.0, 0.0, 0.0])),
        extrinsic_R=list(_get(mp, "extrinsic_R", [1, 0, 0, 0, 1, 0, 0, 0, 1])),
    )
    common = raw.get("common", {})
    cfg.lid_topic = str(_get(common, "lid_topic", cfg.lid_topic))
    cfg.imu_topic = str(_get(common, "imu_topic", cfg.imu_topic))
    cam_block = raw.get("camera", {})
    if "Rcl" in cam_block:
        cfg.Rcl = list(cam_block["Rcl"])
    if "Pcl" in cam_block:
        cfg.Pcl = list(cam_block["Pcl"])
    if "img_topic" in cam_block:
        cfg.img_topic = str(cam_block["img_topic"])
    pcd = raw.get("pcd_save", {})
    cfg.pcd_save_en = bool(_get(pcd, "pcd_save_en", False))
    cap = raw.get("capacity", {})  # fixed-capacity knobs (ours, optional)
    if cap:
        fields = {f.name for f in dataclasses.fields(CapacityConfig)}
        kw = {}
        for k, v in cap.items():
            if k not in fields:
                continue
            if k in ("map_backend", "vio_robust", "plane_fit", "slider"):
                kw[k] = str(v)
                allowed = {"map_backend": ("tiled", "dense", "hash"),
                           "vio_robust": ("none", "huber", "tukey"),
                           "plane_fit": ("tls", "ref"),
                           "slider": ("ref", "clamped")}[k]
                if kw[k] not in allowed:
                    # fail at LOAD time, not minutes later mid-jit-trace
                    raise ValueError(
                        f"capacity.{k}={kw[k]!r}: must be one of {allowed}")
            elif k in ("cache_knn", "mixed_gain", "frame_ring_u8",
                       "pallas_knn", "donate_maps"):
                kw[k] = bool(v)
            elif k == "auto_reset_rms":
                kw[k] = float(v)
            elif k in ("dense_dims", "tiled_dir_dims"):
                kw[k] = tuple(int(x) for x in v)
            else:
                kw[k] = int(v)
        cfg.capacity = CapacityConfig(**kw)
        if cfg.capacity.pallas_knn and cfg.capacity.plane_fit == "ref":
            # fail at LOAD time, not minutes later mid-jit-trace
            raise ValueError(
                "capacity.pallas_knn implements the tls plane fit only "
                "— unset it or use plane_fit: tls")

    if camera_yaml is not None:
        with open(camera_yaml) as f:
            cam = yaml.safe_load(f)
        cfg.camera = CameraConfig(
            width=int(cam["cam_width"]),
            height=int(cam["cam_height"]),
            fx=float(cam["cam_fx"]),
            fy=float(cam["cam_fy"]),
            cx=float(cam["cam_cx"]),
            cy=float(cam["cam_cy"]),
            d=[float(cam.get(f"cam_d{i}", 0.0)) for i in range(4)],
        )
    return cfg


def parse_launch(launch_path: str | Path) -> tuple:
    """Resolve a reference launch file (launch/mapping_*.launch) to its
    (config_yaml, camera_yaml) pair so a FAST-LIVO user can point the
    CLI at the exact launch file they already use (reference launch
    files only load the two YAMLs; rviz/republish nodes map to --viz
    and the bag reader's built-in CompressedImage decoding).

    `$(find <pkg>)` resolves to the launch file's package root (its
    parent directory's parent), matching catkin's source layout."""
    import re
    import xml.etree.ElementTree as ET

    launch_path = Path(launch_path)
    pkg_root = launch_path.resolve().parent.parent

    def resolve(p: str) -> Path:
        return Path(re.sub(r"\$\(find [^)]*\)", str(pkg_root), p))

    root = ET.parse(launch_path).getroot()
    # a <rosparam file=...> nested inside a <node> = camera intrinsics;
    # any other (top level or inside <group>/<include>) = the rig
    # config. Searched recursively so grouped launch files work too.
    node_rps = {
        id(rp)
        for node in root.iter("node")
        for rp in node.iter("rosparam")
    }
    cfg_yaml = None
    cam_yaml = None
    for rp in root.iter("rosparam"):
        f = rp.get("file")
        if not f:
            continue
        p = resolve(f)
        if not p.exists():
            raise FileNotFoundError(
                f"{launch_path}: <rosparam file={f!r}> resolves to "
                f"{p}, which does not exist ($(find <pkg>) is resolved "
                "to this launch file's package root)"
            )
        if id(rp) in node_rps:
            cam_yaml = p
        else:
            cfg_yaml = p
    if cfg_yaml is None:
        raise ValueError(f"no <rosparam file=...> found in {launch_path}")
    return cfg_yaml, cam_yaml
