"""Minimal pure-Python rosbag v2.0 reader + message decoders.

The reference consumes its benchmark datasets exclusively as ROS1 bags
(README.md:118-138); this module replaces the rosbag/roscpp transport
stack for offline replay. Supports:

  - bag format v2.0: record framing, chunk records with `none`, `bz2`
    and `lz4` compression (the roslz4 frame format, decoded by the
    pure-Python `io.lz4` module), connection records, message records;
  - decoders for the message types the reference subscribes to
    (laserMapping.cpp:1146-1150): livox_ros_driver/CustomMsg,
    sensor_msgs/PointCloud2 (velodyne/ouster/xt32 layouts),
    sensor_msgs/Imu, sensor_msgs/Image, sensor_msgs/CompressedImage
    (via PIL).

Returned messages are plain dicts of numpy arrays/scalars, ready for
preprocess.decode / Pipeline.push_*.
"""
from __future__ import annotations

import bz2
import struct
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

from . import lz4

MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAGHDR = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNKINFO = 0x06
OP_CONN = 0x07


def _parse_header(buf: bytes) -> dict:
    out = {}
    i = 0
    while i < len(buf):
        (n,) = struct.unpack_from("<I", buf, i)
        i += 4
        field = buf[i : i + n]
        i += n
        k, _, v = field.partition(b"=")
        out[k.decode()] = v
    return out


def _records(buf, i: int = 0) -> Iterator[Tuple[dict, bytes]]:
    # A bag ending in a partially written final record (crashed
    # recording — normally salvageable with `rosbag reindex`) replays
    # its complete prefix with a RuntimeWarning instead of aborting the
    # run; any record that READ cleanly is yielded before the warning,
    # so mid-file corruption that produces a garbage length still
    # surfaces (as a warning + an abruptly short replay).
    import warnings

    L = len(buf)
    while i + 8 <= L:
        (hlen,) = struct.unpack_from("<I", buf, i)
        i += 4
        if i + hlen + 4 > L:
            warnings.warn(
                f"truncated bag: record header runs past EOF at byte {i}; "
                f"replaying the complete prefix only",
                RuntimeWarning, stacklevel=2)
            return
        hdr = _parse_header(buf[i : i + hlen])
        i += hlen
        (dlen,) = struct.unpack_from("<I", buf, i)
        i += 4
        if i + dlen > L:
            warnings.warn(
                f"truncated bag: record data runs past EOF at byte {i} "
                f"(need {dlen}, have {L - i}); replaying the complete "
                f"prefix only",
                RuntimeWarning, stacklevel=2)
            return
        data = buf[i : i + dlen]
        i += dlen
        yield hdr, data
    if i != L:
        # a partial length prefix (1-7 trailing bytes)
        warnings.warn(
            f"truncated bag: {L - i} trailing bytes at EOF",
            RuntimeWarning, stacklevel=2)


class _Reader:
    """Streaming deserializer for ROS1 message wire format."""

    def __init__(self, data: bytes):
        self.d = data
        self.i = 0

    def u8(self):
        v = self.d[self.i]
        self.i += 1
        return v

    def u32(self):
        (v,) = struct.unpack_from("<I", self.d, self.i)
        self.i += 4
        return v

    def u64(self):
        (v,) = struct.unpack_from("<Q", self.d, self.i)
        self.i += 8
        return v

    def f64(self, n=1):
        v = np.frombuffer(self.d, np.float64, n, self.i)
        self.i += 8 * n
        return v if n > 1 else float(v[0])

    def string(self):
        n = self.u32()
        s = self.d[self.i : self.i + n]
        self.i += n
        return s.decode(errors="replace")

    def time(self):
        return self.u32() + self.u32() * 1e-9

    def bytes_(self):
        n = self.u32()
        b = self.d[self.i : self.i + n]
        self.i += n
        return b

    def header(self):
        seq = self.u32()
        stamp = self.time()
        frame = self.string()
        return seq, stamp, frame


_PF_DTYPES = {
    1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
    5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64,
}


def decode_imu(data: bytes) -> dict:
    r = _Reader(data)
    _, stamp, _ = r.header()
    r.f64(4)  # orientation
    r.f64(9)
    gyr = np.array(r.f64(3))
    r.f64(9)
    acc = np.array(r.f64(3))
    return {"stamp": stamp, "acc": acc, "gyr": gyr}


def decode_pointcloud2(data: bytes) -> dict:
    r = _Reader(data)
    _, stamp, _ = r.header()
    height, width = r.u32(), r.u32()
    nf = r.u32()
    fields = []
    for _ in range(nf):
        name = r.string()
        off = r.u32()
        dt = r.u8()
        cnt = r.u32()
        fields.append((name, off, dt, cnt))
    r.u8()  # is_bigendian
    point_step = r.u32()
    r.u32()  # row_step
    raw = r.bytes_()
    n = len(raw) // point_step
    names, formats, offsets = [], [], []
    for name, off, dt, cnt in fields:
        names.append(name)
        base = _PF_DTYPES[dt]
        formats.append(base if cnt == 1 else (base, (cnt,)))
        offsets.append(off)
    dtype = np.dtype(
        {"names": names, "formats": formats, "offsets": offsets,
         "itemsize": point_step}
    )
    arr = np.frombuffer(raw, dtype=dtype, count=n)
    return {"stamp": stamp, "points": arr, "height": height, "width": width}


def decode_livox_custom(data: bytes) -> dict:
    r = _Reader(data)
    _, stamp, _ = r.header()
    timebase = r.u64()
    point_num = r.u32()
    r.u8()  # lidar_id
    r.u8(); r.u8(); r.u8()  # rsvd
    n = r.u32()  # points array length
    dtype = np.dtype(
        [("offset_time", "<u4"), ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
         ("reflectivity", "u1"), ("tag", "u1"), ("line", "u1")]
    )
    arr = np.frombuffer(r.d, dtype=dtype, count=n, offset=r.i)
    return {"stamp": stamp, "timebase": timebase, "point_num": point_num,
            "points": arr}


def decode_image(data: bytes) -> dict:
    r = _Reader(data)
    _, stamp, _ = r.header()
    h, w = r.u32(), r.u32()
    enc = r.string()
    be = r.u8()  # is_bigendian
    step = r.u32()
    raw = r.bytes_()
    el = enc.lower()
    if "16" in el and ("mono" in el or "16uc1" in el or el == "16sc1"):
        # 16-bit mono (mono16 / 16UC1): decode as u16 rows, scale to the
        # 8-bit range the pipeline's grayscale path expects (the
        # reference receives 8-bit BGR via cv_bridge; a 16-bit camera
        # stream would go through the same 8-bit conversion there)
        dt = np.dtype(">u2" if be else "<u2")
        img16 = np.frombuffer(raw, dt).reshape(h, step // 2)[:, :w]
        img = (img16 >> 8).astype(np.uint8)
        return {"stamp": stamp, "image": img, "encoding": enc}
    img = np.frombuffer(raw, np.uint8)
    ch = step // max(w, 1)
    img = img.reshape(h, step)[:, : w * ch]
    if ch > 1:
        img = img.reshape(h, w, ch)
    return {"stamp": stamp, "image": img, "encoding": enc}


def bgr_normalize(img: np.ndarray, encoding: str) -> np.ndarray:
    """Reorder a decoded image to the BGR channel order the pipeline
    assumes (the reference receives BGR via cv_bridge before
    cv::cvtColor(CV_BGR2GRAY), lidar_selection.cpp:1037). Honors the ROS
    'encoding' field: rgb8/rgba8 sources get their channels swapped,
    alpha is dropped, mono passes through."""
    enc = (encoding or "").lower()
    if img.ndim == 3 and img.shape[2] >= 3:
        if img.shape[2] == 4:
            img = img[..., :3]
        if enc.startswith("rgb"):
            img = img[..., ::-1]
    return img


def decode_compressed_image(data: bytes) -> dict:
    import io as _io

    from PIL import Image as PILImage

    r = _Reader(data)
    _, stamp, _ = r.header()
    fmt = r.string()
    raw = r.bytes_()
    img = np.asarray(PILImage.open(_io.BytesIO(raw)))
    if img.ndim == 3:
        if img.shape[2] == 4:
            img = img[..., :3]  # drop alpha BEFORE the channel flip
        img = img[..., ::-1]  # PIL gives RGB; reference expects BGR
    return {"stamp": stamp, "image": img, "format": fmt}


DECODERS = {
    "sensor_msgs/Imu": decode_imu,
    "sensor_msgs/PointCloud2": decode_pointcloud2,
    "livox_ros_driver/CustomMsg": decode_livox_custom,
    "sensor_msgs/Image": decode_image,
    "sensor_msgs/CompressedImage": decode_compressed_image,
}


def read_bag(
    path: str | Path,
    topics: Optional[set] = None,
) -> Iterator[Tuple[str, str, float, dict]]:
    """Yield (topic, msg_type, receive_stamp, decoded) in file order.

    Messages without a registered decoder are skipped. The file is
    memory-mapped, not loaded: multi-GB dataset bags stream without
    resident memory cost (decoders copy out only what they keep).
    """
    import mmap

    f = open(path, "rb")
    try:
        data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    except (ValueError, OSError):  # empty file or mmap-less fs
        data = f.read()
    if not data[: len(MAGIC)] == MAGIC:
        f.close()
        raise ValueError(f"{path}: not a rosbag v2.0 file")
    conns: dict[int, tuple[str, str]] = {}  # conn id -> (topic, type)

    def handle_record(hdr: dict, rec: bytes):
        op = hdr["op"][0]
        if op == OP_CONN:
            (cid,) = struct.unpack("<I", hdr["conn"])
            topic = hdr["topic"].decode()
            chdr = _parse_header(rec)
            conns[cid] = (topic, chdr.get("type", b"").decode())
        elif op == OP_MSG:
            (cid,) = struct.unpack("<I", hdr["conn"])
            secs, nsecs = struct.unpack("<II", hdr["time"])
            topic, mtype = conns.get(cid, ("?", "?"))
            if topics is not None and topic not in topics:
                return
            dec = DECODERS.get(mtype)
            if dec is not None:
                yield topic, mtype, secs + nsecs * 1e-9, dec(rec)

    try:
        for hdr, rec in _records(data, len(MAGIC)):
            op = hdr["op"][0]
            if op == OP_CHUNK:
                comp = hdr.get("compression", b"none").decode()
                if comp == "none":
                    block = rec
                else:
                    try:
                        if comp == "bz2":
                            block = bz2.decompress(rec)
                        elif comp == "lz4":
                            block = lz4.decompress_frame(rec)
                        else:
                            raise NotImplementedError(
                                f"chunk compression {comp!r}")
                    except NotImplementedError:
                        raise
                    except Exception as e:
                        # one corrupt chunk (bit rot, partial write)
                        # must not kill a multi-GB replay: skip it,
                        # keep every other chunk — mirrors the
                        # truncated-record degradation in _records
                        import warnings

                        warnings.warn(
                            f"corrupt {comp} chunk skipped "
                            f"({type(e).__name__}: {e})",
                            RuntimeWarning, stacklevel=2)
                        continue
                for h2, r2 in _records(block):
                    yield from handle_record(h2, r2)
            else:
                # unchunked bags store conn/message records at top level
                yield from handle_record(hdr, rec)
    finally:
        # release the mapping + fd even when the caller abandons the
        # generator early (--max-frames break; review r5)
        if isinstance(data, mmap.mmap):
            data.close()
        f.close()
