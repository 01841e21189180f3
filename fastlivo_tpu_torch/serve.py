"""Online serving: a socket transport feeding the pipeline live.

Port of the JAX package's serve.py with the same wire protocol, byte for
byte, so a client of either server works with the other. The reference
runs as a live ROS node (laserMapping.cpp:1139); here a length-prefixed
binary protocol over a Unix or TCP socket is decoded into the same
`Pipeline.push_*` calls, and odometry is streamed back per frame.

    python -m fastlivo_tpu_torch.serve --config avia.yaml --unix /tmp/livo.sock \\
        [--camera cam.yaml] [--async-read | --block-read E] [--log-dir Log] \\
        [--autosave ckpt.npz [--autosave-every N]] [--load-ckpt ckpt.npz] \\
        [--device cpu]

Wire format (little-endian), one message per frame:
    u32 total_len | u8 kind | payload
  kind 0 IMU:   f64 stamp | f32[3] acc | f32[3] gyr
  kind 1 LIDAR: f64 stamp | u32 n | f32[n,3] xyz | f32[n] t_rel
  kind 2 IMAGE: f64 stamp | u16 h | u16 w | u8 ch | u8[h,w,ch] (BGR/gray)
  kind 3 FLUSH: (empty) — process everything buffered, then ack

Responses (server -> every client), one JSON line per lidar frame:
    {"t": ..., "pos": [x,y,z], "quat": [w,x,y,z], "n_active": N,
     "res_rms": r, "auto_resets": k}
and {"flushed": true} to the client that sent a FLUSH.

Estimation runs on the per-connection reader threads, serialized by one
lock; the kernels launch on the calling thread's current CUDA stream.

`--mesh N` (LIO or LIVO) runs N ranks, one process each
(parallel/launch.py). Rank 0 owns the socket and the Server; before its
Pipeline takes a message (images included) it broadcasts the message to
the other ranks, whose Pipelines take the same sequence (`follow`).
Autosaves and the shutdown travel in the same stream, so the gathers of
a checkpoint (a sharded map's points, the visual map's slabs) run at the
same point on every rank. Only rank 0 answers clients.
"""
from __future__ import annotations

import datetime
import json
import os
import socket
import struct
import threading
import time
from collections import deque

import numpy as np
import torch.distributed as dist

from .config import Config
from .pipeline import Pipeline

IMU, LIDAR, IMAGE, FLUSH = 0, 1, 2, 3
MAX_MSG = 256 << 20  # reject absurd length prefixes (corrupt stream)
# kinds that only the mesh's rank stream carries, never the socket
NOOP, SNAPSHOT, SHUTDOWN = 16, 17, 18
HEARTBEAT_S = 20.0  # an idle leader's NOOP period (well inside the timeout)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def encode_imu(stamp: float, acc, gyr) -> bytes:
    payload = struct.pack("<Bd", IMU, stamp)
    payload += np.asarray(acc, np.float32).tobytes()
    payload += np.asarray(gyr, np.float32).tobytes()
    return struct.pack("<I", len(payload)) + payload


def encode_lidar(stamp: float, pts, t_rel) -> bytes:
    pts = np.ascontiguousarray(pts, np.float32)
    t_rel = np.ascontiguousarray(t_rel, np.float32)
    payload = struct.pack("<BdI", LIDAR, stamp, len(pts))
    payload += pts.tobytes() + t_rel.tobytes()
    return struct.pack("<I", len(payload)) + payload


def encode_image(stamp: float, img) -> bytes:
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    payload = struct.pack("<BdHHB", IMAGE, stamp, h, w, ch) + img.tobytes()
    return struct.pack("<I", len(payload)) + payload


def encode_flush() -> bytes:
    return struct.pack("<I", 1) + struct.pack("<B", FLUSH)


class _Sender:
    """Per-connection outbound queue and sender thread: a broadcast only
    appends, so a stalled consumer fills its own bounded queue and is
    dropped instead of blocking the others; all writes to one socket go
    through it, so lines never interleave."""

    MAX_QUEUE = 4096  # lines; ~0.5 MB of odometry backlog

    def __init__(self, conn):
        self.conn = conn
        self._q = deque()
        self._cv = threading.Condition()
        self.dead = False  # hard drop (stalled or broken consumer)
        self.closing = False  # graceful: drain queued lines, then stop
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def send(self, data: bytes) -> None:
        with self._cv:
            if self.dead:
                return
            if len(self._q) >= self.MAX_QUEUE:
                self.dead = True  # the consumer stopped reading
                self._q.clear()
            else:
                self._q.append(data)
            self._cv.notify()

    def close(self) -> None:
        """Graceful shutdown: queued replies drain before the socket
        closes."""
        with self._cv:
            self.closing = True
            self._cv.notify()
        self._thread.join(2.0)

    def _run(self):
        while True:
            with self._cv:
                while not self._q and not (self.dead or self.closing):
                    self._cv.wait()
                if not self._q or self.dead:
                    return
                data = self._q.popleft()
            try:
                self.conn.sendall(data)
            except OSError:
                with self._cv:
                    self.dead = True
                    self._q.clear()
                return


def apply_message(pipe: Pipeline, kind: int, payload: bytes) -> list:
    """Decode one wire message into `pipe` and spin it; returns the new
    outputs (a FLUSH also resolves the deferred frames)."""
    if kind == IMU:
        (stamp,) = struct.unpack_from("<d", payload, 1)
        acc = np.frombuffer(payload, np.float32, 3, 9)
        gyr = np.frombuffer(payload, np.float32, 3, 21)
        pipe.push_imu(stamp, acc, gyr)
    elif kind == LIDAR:
        stamp, cnt = struct.unpack_from("<dI", payload, 1)
        off = 1 + 8 + 4
        pts = np.frombuffer(payload, np.float32, cnt * 3, off).reshape(cnt, 3)
        t_rel = np.frombuffer(payload, np.float32, cnt, off + cnt * 12).astype(np.float64)
        pipe.push_lidar(stamp, pts, t_rel)
    elif kind == IMAGE:
        stamp, h, w, ch = struct.unpack_from("<dHHB", payload, 1)
        img = np.frombuffer(payload, np.uint8, h * w * ch, 14).reshape(h, w, ch)
        if ch == 1:
            img = img[..., 0]
        pipe.push_img(stamp, img)
    outs = pipe.spin()
    if kind == FLUSH:
        outs = outs + pipe.finish()  # a flush is a true barrier
    return outs


class RankStream:
    """Rank 0's message stream to the other ranks of the world, over a gloo
    group of its own (created on every rank, in the same order): the
    messages, then NOOP heartbeats while idle, SNAPSHOT before each
    checkpoint and SHUTDOWN at the end."""

    def __init__(self):
        self.group = dist.new_group(backend="gloo",
                                    timeout=datetime.timedelta(seconds=10 * HEARTBEAT_S))
        self.last = time.monotonic()

    def send(self, kind: int, payload: bytes = b"") -> None:
        dist.broadcast_object_list([(kind, payload)], src=0, group=self.group)
        self.last = time.monotonic()

    def recv(self):
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]


def follow(pipe: Pipeline, stream: RankStream) -> None:
    """A follower rank: feed `pipe` rank 0's messages until SHUTDOWN."""
    while True:
        kind, payload = stream.recv()
        if kind == SHUTDOWN:
            return
        if kind == SNAPSHOT:
            pipe.checkpoint_arrays()  # join the gathers of rank 0's checkpoint
        elif kind != NOOP:
            apply_message(pipe, kind, payload)


class Server:
    """Multi-connection server driving one Pipeline.

    Each connection gets a reader thread; any connection may publish
    sensor messages and every connection receives the odometry broadcast.
    Estimation is serialized by a lock, so the pipeline sees the
    reference's single-threaded spinOnce cadence (:1260-1267)."""

    def __init__(self, cfg: Config, address, log_dir=None, autosave=None,
                 autosave_every: int = 600, device=None, mesh=None,
                 sharded_map: bool = False):
        """`address`: a Unix socket path or a (host, port) tuple.
        `autosave`: optional .npz path; every `autosave_every` frames and
        at shutdown the estimator is snapshot there (io/checkpoint
        format; resume with `--load-ckpt` or Pipeline.warm_start). The
        arrays are copied to the host under the pipeline lock (the maps
        are updated in place); compression and the atomic file replace
        run on a worker thread. `device`: CUDA unless given. `mesh`: rank
        0's mesh (see the module doc; `sharded_map` as for Pipeline)."""
        self.pipe = Pipeline(cfg, device=device, log_dir=log_dir, mesh=mesh,
                             sharded_map=sharded_map)
        self.stream = RankStream() if mesh is not None else None
        self.autosave = autosave
        self.autosave_every = max(int(autosave_every), 1)
        self._frames_since_save = 0
        self._saver = None  # lazy single-worker executor
        if isinstance(address, tuple):
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        else:
            if os.path.exists(address):
                os.unlink(address)  # stale socket from a prior run
            self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.bind(address)
        self.sock.listen(8)
        self.address = self.sock.getsockname()
        self._thread = None
        self._done = threading.Event()
        self._conns: list = []
        self._senders: dict = {}  # conn -> _Sender (broadcast targets)
        self._conns_lock = threading.Lock()
        self._pipe_lock = threading.Lock()  # serializes estimation
        self._n_ever = 0

    def serve_forever(self):
        """Accept loop; returns (and sets `done`) once at least one
        connection existed and all have closed."""
        try:
            self.sock.settimeout(0.2)
            while True:
                try:
                    conn, _ = self.sock.accept()
                except socket.timeout:
                    with self._conns_lock:
                        if self._n_ever and not self._conns:
                            break
                    if (self.stream is not None
                            and time.monotonic() - self.stream.last > HEARTBEAT_S):
                        with self._pipe_lock:
                            self.stream.send(NOOP)
                    continue
                self._n_ever += 1
                with self._conns_lock:
                    self._conns.append(conn)
                    self._senders[conn] = _Sender(conn)
                threading.Thread(target=self._reader, args=(conn,),
                                 daemon=True).start()
        finally:
            self.sock.close()
            if self.autosave:
                # the shutdown snapshot also captures the final state
                with self._pipe_lock:
                    self._snapshot()
                if self._saver is not None:
                    self._saver.shutdown(wait=True)
            if self.stream is not None:
                with self._pipe_lock:
                    self.stream.send(SHUTDOWN)
            if self.pipe.logger is not None:
                self.pipe.logger.close()
            self._done.set()

    def _reader(self, conn):
        try:
            self._serve_conn(conn)
        finally:
            with self._conns_lock:
                if conn in self._conns:
                    self._conns.remove(conn)
                s = self._senders.pop(conn, None)
            if s is not None:
                s.close()
            try:
                conn.close()
            except OSError:
                pass

    def _broadcast(self, data: bytes):
        """Non-blocking: append to every connection's sender queue."""
        with self._conns_lock:
            senders = list(self._senders.values())
        for s in senders:
            s.send(data)

    def _send_to(self, conn, data: bytes):
        """A reply to one connection, through its sender queue."""
        with self._conns_lock:
            s = self._senders.get(conn)
        if s is not None:
            s.send(data)

    def start_background(self):
        self._thread = threading.Thread(target=self.serve_forever, daemon=True)
        self._thread.start()
        return self

    def wait(self, timeout=None):
        return self._done.wait(timeout)

    def _serve_conn(self, conn: socket.socket):
        pipe = self.pipe
        while True:
            hdr = _recv_exact(conn, 4)
            if hdr is None:
                break
            (n,) = struct.unpack("<I", hdr)
            if n == 0 or n > MAX_MSG:
                self._send_to(conn, b'{"error": "bad message length"}\n')
                break
            payload = _recv_exact(conn, n)
            if payload is None:
                break
            kind = payload[0]
            with self._pipe_lock:
                if self.stream is not None and kind in (IMU, LIDAR, IMAGE, FLUSH):
                    self.stream.send(kind, payload)  # before rank 0 takes it
                outs = apply_message(pipe, kind, payload)
                # broadcast inside the lock: queue appends do not block,
                # and the odometry lines stay in order across publishers
                for out in outs:
                    line = json.dumps({
                        "t": out.t,
                        "pos": [float(v) for v in out.pos],
                        "quat": [float(v) for v in out.quat],
                        "n_active": out.n_active,
                        "res_rms": round(out.res_rms, 6),
                        "auto_resets": pipe.auto_resets,
                    }) + "\n"
                    self._broadcast(line.encode())
                if self.autosave and outs:
                    self._frames_since_save += len(outs)
                    if self._frames_since_save >= self.autosave_every:
                        self._snapshot()
            if kind == FLUSH:
                self._send_to(conn, b'{"flushed": true}\n')

    def _snapshot(self):
        """Periodic or shutdown checkpoint (call under _pipe_lock): copy
        the estimator to host numpy now, then compress and atomically
        replace the file on the worker thread."""
        from .io import checkpoint as ckpt_mod

        pipe = self.pipe
        if not pipe.map_built:
            return  # nothing worth a snapshot yet
        if self.stream is not None:
            self.stream.send(SNAPSHOT)
        arrays = pipe.checkpoint_arrays()
        self._frames_since_save = 0
        if self._saver is None:
            from concurrent.futures import ThreadPoolExecutor

            self._saver = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="fastlivo-autosave")
        path = str(self.autosave)
        if not path.endswith(".npz"):
            path += ".npz"

        def _write():
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                ckpt_mod.write(f, arrays)
            os.replace(tmp, path)  # a crash never leaves a torn file

        self._saver.submit(_write)


def main(argv=None):
    import argparse

    from .config import load_config

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default=None)
    ap.add_argument("--camera", default=None)
    ap.add_argument("--launch", default=None,
                    help="reference launch file; resolves --config/--camera")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--unix", default=None, help="unix socket path")
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on the CPU)")
    ap.add_argument("--async-read", action="store_true",
                    help="deferred per-frame readback: odometry publishes "
                    "one frame late")
    ap.add_argument("--block-read", type=int, default=0, metavar="E",
                    help="block-packed readback: one device read per E "
                    "events; odometry publishes up to ~2E events late. "
                    "Incompatible with --log-dir.")
    ap.add_argument("--load-ckpt", default=None, metavar="PATH.npz",
                    help="warm-start from a checkpoint before serving; a "
                    "missing file starts cold (pair with --autosave PATH)")
    ap.add_argument("--autosave", default=None, metavar="PATH.npz",
                    help="periodic crash-recovery checkpoint, atomically "
                    "replaced, written every --autosave-every frames and at "
                    "shutdown")
    ap.add_argument("--autosave-every", type=int, default=600, metavar="N",
                    help="frames between autosaves (default 600 ~ 60 s at 10 Hz)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="LIO or LIVO over N ranks, one process each (NCCL, one "
                    "card per rank; gloo with --device cpu; 0 = one device); rank "
                    "0 owns the socket")
    ap.add_argument("--sharded-map", action="store_true",
                    help="with --mesh N: block-shard the map over the ranks "
                    "(per-rank pool tiled_pool/N; per-scan halo snapshot search)")
    args = ap.parse_args(argv)
    if args.launch:
        from .config import parse_launch

        cfg_yaml, cam_yaml = parse_launch(args.launch)
        args.config = args.config or str(cfg_yaml)
        if args.camera is None and cam_yaml is not None:
            args.camera = str(cam_yaml)
    if args.config is None:
        ap.error("--config (or --launch) is required")
    if args.block_read and args.log_dir:
        ap.error("--block-read is incompatible with --log-dir "
                 "(per-frame trace logging needs per-frame reads)")
    cfg = load_config(args.config, args.camera)
    if args.camera is None:
        cfg.img_enable = False
    if not args.mesh and args.sharded_map:
        ap.error("--sharded-map requires --mesh N")
    if args.sharded_map and args.load_ckpt:
        ap.error("--sharded-map cannot restore a single-device map "
                 "checkpoint (rebuild from the stream)")
    if args.mesh:
        from .parallel.launch import launch, mesh_backend

        return launch(_serve_rank, args.mesh, (args, cfg),
                      backend=mesh_backend(args.device, args.mesh))[0]
    return _serve(args, cfg)


def _setup(pipe: Pipeline, args) -> None:
    """Warm start and readback options, the same on every rank."""
    if args.load_ckpt:
        from .io import checkpoint as ckpt_mod

        if os.path.exists(args.load_ckpt) or os.path.exists(args.load_ckpt + ".npz"):
            pipe.warm_start(*ckpt_mod.load(args.load_ckpt, device=pipe.device))
            print("warm-started from checkpoint", flush=True)
        else:
            # the first boot of the crash-recovery pairing: no file yet
            print("checkpoint not found; starting cold", flush=True)
    if args.async_read:
        pipe.async_read = True
    if args.block_read:
        pipe.enable_block_read(args.block_read)


def _serve(args, cfg, mesh=None) -> int:
    addr = args.unix if args.unix else ("127.0.0.1", args.port)
    srv = Server(cfg, addr, log_dir=args.log_dir, autosave=args.autosave,
                 autosave_every=args.autosave_every,
                 device=None if mesh else args.device, mesh=mesh,
                 sharded_map=args.sharded_map)
    _setup(srv.pipe, args)
    print(f"listening on {srv.address}", flush=True)
    srv.serve_forever()
    return 0


def _serve_rank(rank: int, n: int, args, cfg) -> int:
    """`serve --mesh N`'s rank program (parallel.launch.launch): rank 0
    serves, the others follow its stream."""
    from .parallel.launch import rank_device
    from .parallel.sharded import make_mesh

    mesh = make_mesh(n, device=rank_device(args.device))
    if rank == 0:
        return _serve(args, cfg, mesh)
    pipe = Pipeline(cfg, mesh=mesh, sharded_map=args.sharded_map)
    stream = RankStream()  # after the Pipeline, as on rank 0
    _setup(pipe, args)
    follow(pipe, stream)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
