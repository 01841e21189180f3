"""Live visualization — the reference's rviz surface without ROS.

The reference publishes three live topics for rviz (laserMapping.cpp):
  /cloud_registered   registered world-frame scan cloud, RGB-painted in
                      LIVO mode (publish_frame_world :780-807,
                      publish_frame_world_rgb :710-769)
  /aft_mapped_to_init odometry pose     (publish_odometry :915-940)
  /path               trajectory        (publish_path :951-957)

This stack has no ROS; the viewer renders the same three surfaces
directly: an accumulated world cloud, the current pose, and the path,
as top-down (X-Y) and side (X-Z) projections. Two modes:

  live     `LiveViewer` hooked into the pipeline loop (run.py --viz-dir)
           writes a PNG per rendered frame plus an atomically-replaced
           latest.png — point an image viewer / browser auto-refresh at
           it for a live display on headless boxes.
  offline  `python -m fastlivo_tpu_torch.viz <Log dir>` replays a recorded
           pos_log.txt (+ optional PCD world cloud) into the same frames
           — rviz-on-a-bag parity for finished runs.

Matplotlib Agg only (no display server needed), imported only when a
frame renders; the render cost is host-side and off the device hot path.

Port of the JAX package's viz.py (host numpy; nothing here runs on the
device).
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np

_PNG_MAGIC = b"\x89PNG"


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class LiveViewer:
    """Accumulates per-frame clouds + poses and renders every `every`-th
    frame. Bounded memory: the cloud reservoir is uniformly decimated
    back to `max_cloud/2` points whenever it exceeds `max_cloud` (the
    reference leaves bounding to rviz; a headless renderer must cap)."""

    def __init__(self, out_dir: str | Path, every: int = 5,
                 max_cloud: int = 200_000, per_frame: int = 4096,
                 dpi: int = 100):
        self.dir = Path(out_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.every = max(1, every)
        self.max_cloud = max_cloud
        self.per_frame = per_frame
        self.dpi = dpi
        self._cloud: list[np.ndarray] = []  # (N,7) x y z r g b has_rgb
        self._n_cloud = 0
        self._path: list[np.ndarray] = []  # (4,) t,x,y,z
        self._frame = 0
        self._rendered = 0

    # ---- accumulation ----------------------------------------------------

    def add_cloud(self, pts: np.ndarray, rgb: Optional[np.ndarray] = None):
        """World-frame points for this frame; `rgb` (N,3) in [0,255]
        mirrors the painted cloud of publish_frame_world_rgb."""
        if pts is None or len(pts) == 0:
            return
        pts = np.asarray(pts, np.float32)
        if len(pts) > self.per_frame:
            pts_idx = np.linspace(0, len(pts) - 1, self.per_frame).astype(int)
            pts = pts[pts_idx]
            rgb = rgb[pts_idx] if rgb is not None else None
        chunk = np.zeros((len(pts), 7), np.float32)
        chunk[:, :3] = pts[:, :3]
        if rgb is not None:
            # per-POINT color flag: colorless live chunks keep the height
            # colormap even after an rgb background was added
            chunk[:, 3:6] = np.asarray(rgb, np.float32)
            chunk[:, 6] = 1.0
        self._cloud.append(chunk)
        self._n_cloud += len(chunk)
        if self._n_cloud > self.max_cloud:
            allc = np.concatenate(self._cloud)
            keep = np.linspace(0, len(allc) - 1, self.max_cloud // 2).astype(int)
            self._cloud = [allc[keep]]
            self._n_cloud = len(keep)

    def update(self, out) -> Optional[Path]:
        """Per-frame hook (`out` is a pipeline FrameOutput). Returns the
        written PNG path when this frame rendered, else None."""
        rgb = None
        inten_attr = getattr(out, "intensity", None)  # duck-typed hooks
        if out.pts_world is not None and inten_attr is not None:
            # LIO mode: grayscale intensity cloud, matching the offline
            # PCD surface (the live view used to fall back to the
            # height colormap while playback showed intensity)
            inten = np.asarray(inten_attr, np.float64)
            n = min(len(inten), len(out.pts_world))
            g = np.clip(inten[:n], 0.0, 255.0)
            if g.size and g.max() <= 1.5:  # normalized intensities
                g = g * 255.0
            rgb = np.repeat(g[:, None], 3, axis=1)
            self.add_cloud(out.pts_world[:n], rgb=rgb)
            return self._step(out.t, np.asarray(out.pos)[:3],
                              stats=f"t={out.t:.2f}s  iters={out.iters}  "
                                    f"pts={out.n_points}")
        self.add_cloud(out.pts_world)
        return self._step(out.t, np.asarray(out.pos)[:3],
                          stats=f"t={out.t:.2f}s  iters={out.iters}  "
                                f"pts={out.n_points}")

    def _step(self, t: float, pos, stats: str = "") -> Optional[Path]:
        """Shared cadence: append a path row, advance the frame counter,
        render on every `every`-th frame (used by live update() and
        offline playback())."""
        self._path.append(np.array([t, *pos]))
        self._frame += 1
        if (self._frame - 1) % self.every == 0:
            return self.render(stats=stats)
        return None

    # ---- rendering -------------------------------------------------------

    def render(self, stats: str = "") -> Path:
        plt = _plt()
        cloud = (np.concatenate(self._cloud) if self._cloud
                 else np.zeros((0, 7), np.float32))
        path = np.asarray(self._path) if self._path else np.zeros((0, 4))

        fig, axes = plt.subplots(1, 2, figsize=(12, 6), dpi=self.dpi)
        colored = cloud[:, 6] > 0
        for ax, (a, b, la, lb) in zip(
            axes, [(0, 1, "x [m]", "y [m]"), (0, 2, "x [m]", "z [m]")]
        ):
            plain = cloud[~colored]
            if len(plain):
                ax.scatter(plain[:, a], plain[:, b], s=0.3, c=plain[:, 2],
                           cmap="viridis", linewidths=0, rasterized=True)
            rgbc = cloud[colored]
            if len(rgbc):
                ax.scatter(rgbc[:, a], rgbc[:, b], s=0.3,
                           c=np.clip(rgbc[:, 3:6] / 255.0, 0, 1),
                           linewidths=0, rasterized=True)
            if len(path):
                ax.plot(path[:, 1 + a], path[:, 1 + b], "r-", lw=1.2)
                ax.plot(path[-1, 1 + a], path[-1, 1 + b], "r^", ms=8)
            ax.set_xlabel(la)
            ax.set_ylabel(lb)
            ax.set_aspect("equal", adjustable="datalim")
            ax.grid(True, alpha=0.3)
        fig.suptitle(f"fastlivo_tpu_torch  frame {self._frame}  "
                     f"cloud {self._n_cloud} pts  {stats}")
        fig.tight_layout()
        # rasterize ONCE; frame_N.png and latest.png share the bytes
        # (latest via atomic replace so a polling viewer never sees a
        # torn file)
        import shutil

        out = self.dir / f"frame_{self._rendered:05d}.png"
        tmp = self.dir / ".latest.tmp"
        fig.savefig(tmp, format="png")
        plt.close(fig)
        shutil.copyfile(tmp, out)
        os.replace(tmp, self.dir / "latest.png")
        self._rendered += 1
        return out


# ---- offline playback of a recorded Log/ directory -----------------------


def _load_pcd(path: str | Path):
    """Minimal ASCII/binary PCD reader for run.save_pcd output: returns
    (pts (N,3), rgb (N,3) or None). The packed rgb field decodes by its
    declared TYPE: U (our ASCII writer) is the packed integer VALUE;
    F (pcl::PointXYZRGB binary convention) is the float whose BITS hold
    the packed value."""
    with open(path, "rb") as f:
        fields, types, n, fmt = [], [], 0, "ascii"
        while True:
            raw = f.readline()
            if not raw:
                raise ValueError(f"{path}: truncated PCD header (no DATA line)")
            line = raw.decode("ascii", "replace").strip()
            if line.startswith("FIELDS"):
                fields = line.split()[1:]
            elif line.startswith("TYPE"):
                types = line.split()[1:]
            elif line.startswith("POINTS"):
                n = int(line.split()[1])
            elif line.startswith("DATA"):
                fmt = line.split()[1]
                break
        if fmt == "ascii":
            # float64 parse keeps packed-uint32 rgb values exact (2^24 max)
            data = np.loadtxt(f, dtype=np.float64, max_rows=n, ndmin=2)
        else:
            data = np.frombuffer(
                f.read(4 * len(fields) * n), np.float32
            ).reshape(n, len(fields)).astype(np.float64)
    pts = data[:, :3].astype(np.float32)
    rgb = None
    if "rgb" in fields:
        i = fields.index("rgb")
        rgb_type = types[i] if i < len(types) else "F"
        if fmt == "ascii" and rgb_type in ("U", "I"):
            packed = data[:, i].astype(np.int64).astype(np.uint32)
        else:
            packed = data[:, i].astype(np.float32).view(np.uint32)
        rgb = np.stack([(packed >> 16) & 0xFF, (packed >> 8) & 0xFF,
                        packed & 0xFF], 1).astype(np.float32)
    elif "intensity" in fields:
        # LIO-mode PointXYZI → grayscale display
        i = np.clip(data[:, fields.index("intensity")], 0, 255)
        rgb = np.repeat(i[:, None], 3, axis=1).astype(np.float32)
    return pts, rgb


def playback(log_dir: str | Path, out_dir: str | Path, every: int = 10,
             pcd: str | Path | None = None) -> int:
    """Replay pos_log.txt (25-col rows, logging_util.log_pos — the
    dump_lio_state_to_log format, laserMapping.cpp:226-256) into viewer
    frames; optional PCD world cloud as the static background. Returns
    the number of frames rendered."""
    rows = np.loadtxt(Path(log_dir) / "pos_log.txt", ndmin=2)
    viewer = LiveViewer(out_dir, every=every)
    if pcd is not None:
        pts, rgb = _load_pcd(pcd)
        viewer.add_cloud(pts, rgb)
    for t, x, y, z in rows[:, [0, 4, 5, 6]]:
        viewer._step(t, (x, y, z), stats=f"t={t:.2f}s (playback)")
    return viewer._rendered


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("log_dir", help="Log/ directory holding pos_log.txt")
    ap.add_argument("--out", default="viz", help="output frame directory")
    ap.add_argument("--every", type=int, default=10)
    ap.add_argument("--pcd", default=None,
                    help="world-cloud PCD (run.py --pcd-out) as background")
    args = ap.parse_args(argv)
    n = playback(args.log_dir, args.out, args.every, args.pcd)
    print(f"rendered {n} frames -> {args.out}/ (latest.png tracks newest)")


if __name__ == "__main__":
    main()
