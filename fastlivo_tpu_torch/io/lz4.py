"""Pure-Python LZ4 (block + frame) for rosbag chunk decompression.

The reference toolchain reads `compression=lz4` bag chunks through
roslz4 (the rosbag storage format's second compression option next to
bz2). No lz4 binding is available in this image, so this module
implements the subset the bag reader needs, dependency-free:

  - LZ4 block format: full decoder, plus a greedy hash-table compressor
    (used by the bag writer/tests; emits real matches so round-trips
    exercise the decoder's match paths);
  - LZ4 frame format v1 (magic 0x184D2204): parser for all flag
    combinations (block checksums, content size/checksum, dict id,
    skippable frames), with xxHash32 verification of the header and
    content checksums — matching what roslz4 produces;
  - legacy frame format (magic 0x184C2102): 8 MiB fixed blocks.

Matches are resolved against the whole output produced so far, so both
block-linked and block-independent streams decode correctly (linked
blocks reference the previous 64 KiB window across block boundaries).

Throughput is host-ingestion-path only (a few MB per bag chunk); the
device pipeline never sees compressed bytes.

The port's copy of the JAX package's io/lz4.py, with the same C++ block
decoder and xxh32 (native/ingest.cpp through the port's native.py, ~100x
the pure-Python loops on MB-scale bag chunks); where the library cannot
be built, the Python implementations below, the readable spec, run.
"""
from __future__ import annotations

import ctypes
import struct

from .. import native

FRAME_MAGIC = 0x184D2204
LEGACY_MAGIC = 0x184C2102
SKIP_MAGIC_LO = 0x184D2A50
SKIP_MAGIC_HI = 0x184D2A5F
LEGACY_BLOCK = 8 << 20

_P1, _P2, _P3, _P4, _P5 = (
    2654435761, 2246822519, 3266489917, 668265263, 374761393
)
_M32 = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def xxh32(data: bytes, seed: int = 0) -> int:
    """xxHash32 (the checksum the LZ4 frame format uses)."""
    lib = native.load()
    if lib is not None:
        return int(lib.xxh32_native(bytes(data), len(data), seed))
    return _xxh32_py(data, seed)


def _xxh32_py(data: bytes, seed: int = 0) -> int:
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + _P1 + _P2) & _M32
        v2 = (seed + _P2) & _M32
        v3 = seed
        v4 = (seed - _P1) & _M32
        while i <= n - 16:
            a, b, c, d = struct.unpack_from("<4I", data, i)
            v1 = (_rotl((v1 + a * _P2) & _M32, 13) * _P1) & _M32
            v2 = (_rotl((v2 + b * _P2) & _M32, 13) * _P1) & _M32
            v3 = (_rotl((v3 + c * _P2) & _M32, 13) * _P1) & _M32
            v4 = (_rotl((v4 + d * _P2) & _M32, 13) * _P1) & _M32
            i += 16
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M32
    else:
        h = (seed + _P5) & _M32
    h = (h + n) & _M32
    while i <= n - 4:
        (k,) = struct.unpack_from("<I", data, i)
        h = (_rotl((h + k * _P3) & _M32, 17) * _P4) & _M32
        i += 4
    while i < n:
        h = (_rotl((h + data[i] * _P5) & _M32, 11) * _P1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * _P2) & _M32
    h ^= h >> 13
    h = (h * _P3) & _M32
    h ^= h >> 16
    return h


def decompress_block(src: bytes, out: bytearray) -> None:
    """Decode one LZ4 block, appending to `out`. Match offsets may
    reach into bytes already in `out` (the linked-block window)."""
    lib = native.load()
    if lib is not None:
        _decompress_block_native(lib, src, out)
        return
    _decompress_block_py(src, out)


def _decompress_block_native(lib, src: bytes, out: bytearray) -> None:
    pos = len(out)
    # capacity guess: rosbag frames cap decompressed blocks at 4 MiB
    # (legacy: 8 MiB), and a block never shrinks below ~its compressed
    # size; over-guessing costs a multi-MB zero-fill per call, so start
    # tight and grow 4x on the rare -2
    extra = max(4 << 20, 2 * len(src))
    while True:
        cap = pos + extra
        out.extend(b"\0" * (cap - len(out)))
        buf = (ctypes.c_char * cap).from_buffer(out)
        new_len = lib.lz4_decompress_block(bytes(src), len(src), buf,
                                           pos, cap)
        del buf  # release the exported buffer before resizing
        if new_len == -2:  # output capacity exceeded: grow and retry
            del out[pos:]
            extra *= 4
            continue
        if new_len < 0:
            del out[pos:]
            raise ValueError("lz4: malformed block (native decoder)")
        del out[new_len:]
        return


def _decompress_block_py(src: bytes, out: bytearray) -> None:
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if lit:
            if i + lit > n:
                raise ValueError("lz4: literal run past block end")
            out += src[i:i + lit]
            i += lit
        if i >= n:
            break  # last sequence: literals only
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0 or offset > len(out):
            raise ValueError("lz4: bad match offset")
        mlen = token & 15
        if mlen == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        mlen += 4
        start = len(out) - offset
        if offset >= mlen:
            out += out[start:start + mlen]
        else:  # overlapping match: repeat the trailing pattern
            pattern = bytes(out[start:])
            out += (pattern * (mlen // offset + 1))[:mlen]


def compress_block(src: bytes) -> bytes:
    """Greedy LZ4 block compressor (hash-table, last-occurrence).

    Honors the format's end-of-block rules: the final sequence is
    literals-only, matches never start within the last 12 bytes and
    never consume the last 5. Output decodes with any LZ4 decoder."""
    n = len(src)
    out = bytearray()
    table: dict = {}
    anchor = 0
    i = 0
    limit = n - 12  # no match may start past this point

    def emit(lit_start: int, lit_end: int, offset: int, mlen: int) -> None:
        lit = lit_end - lit_start
        ml = mlen - 4 if mlen else 0
        token = (min(lit, 15) << 4) | (min(ml, 15) if mlen else 0)
        out.append(token)
        if lit >= 15:
            rem = lit - 15
            while rem >= 255:
                out.append(255)
                rem -= 255
            out.append(rem)
        out.extend(src[lit_start:lit_end])
        if mlen:
            out.extend(struct.pack("<H", offset))
            if ml >= 15:
                rem = ml - 15
                while rem >= 255:
                    out.append(255)
                    rem -= 255
                out.append(rem)

    while i <= limit:
        key = src[i:i + 4]
        cand = table.get(key)
        table[key] = i
        if cand is not None and i - cand <= 0xFFFF:
            mlen = 4
            maxm = n - 5 - i  # matches must leave the last 5 bytes literal
            while mlen < maxm and src[cand + mlen] == src[i + mlen]:
                mlen += 1
            if mlen >= 4:
                emit(anchor, i, i - cand, mlen)
                i += mlen
                anchor = i
                continue
        i += 1
    emit(anchor, n, 0, 0)  # final literals-only sequence
    return bytes(out)


def compress_frame(data: bytes) -> bytes:
    """One block-independent LZ4 frame with a content checksum — the
    shape roslz4 writes (64 KiB max-block streams write many blocks;
    one block per <=4 MiB input is equally valid frame-format)."""
    flg = (1 << 6) | (1 << 5) | (1 << 2)  # v1, block-indep, content-checksum
    bd = 7 << 4  # 4 MiB max block size
    hdr = bytes([flg, bd])
    out = bytearray(struct.pack("<I", FRAME_MAGIC))
    out += hdr
    out.append((xxh32(hdr) >> 8) & 0xFF)
    pos = 0
    while True:
        chunk = data[pos:pos + (4 << 20)]
        pos += len(chunk)
        comp = compress_block(chunk)
        if len(comp) < len(chunk):
            out += struct.pack("<I", len(comp))
            out += comp
        else:  # incompressible: stored block (high bit set)
            out += struct.pack("<I", len(chunk) | 0x80000000)
            out += chunk
        if pos >= len(data):
            break
    out += struct.pack("<I", 0)  # end mark
    out += struct.pack("<I", xxh32(data))
    return bytes(out)


def decompress_frame(data: bytes) -> bytes:
    """Decode a concatenation of LZ4 frames (modern, legacy, skippable)."""
    i = 0
    n = len(data)
    out = bytearray()
    while i < n:
        if n - i < 4:
            raise ValueError("lz4: truncated frame magic")
        (magic,) = struct.unpack_from("<I", data, i)
        i += 4
        if magic == FRAME_MAGIC:
            flg, bd = data[i], data[i + 1]
            if flg >> 6 != 1:
                raise ValueError("lz4: unsupported frame version")
            b_checksum = (flg >> 4) & 1
            c_size = (flg >> 3) & 1
            c_checksum = (flg >> 2) & 1
            dict_id = flg & 1
            hdr_start = i
            i += 2
            if c_size:
                i += 8
            if dict_id:
                i += 4
            hc = data[i]
            i += 1
            if (xxh32(data[hdr_start:i - 1]) >> 8) & 0xFF != hc:
                raise ValueError("lz4: frame header checksum mismatch")
            frame_out_start = len(out)
            while True:
                (bsize,) = struct.unpack_from("<I", data, i)
                i += 4
                if bsize == 0:
                    break
                stored = bsize >> 31
                bsize &= 0x7FFFFFFF
                block = data[i:i + bsize]
                i += bsize
                if b_checksum:
                    (bc,) = struct.unpack_from("<I", data, i)
                    i += 4
                    if xxh32(block) != bc:
                        raise ValueError("lz4: block checksum mismatch")
                if stored:
                    out += block
                else:
                    decompress_block(block, out)
            if c_checksum:
                (cc,) = struct.unpack_from("<I", data, i)
                i += 4
                if xxh32(bytes(out[frame_out_start:])) != cc:
                    raise ValueError("lz4: content checksum mismatch")
        elif magic == LEGACY_MAGIC:
            while n - i >= 4:
                (bsize,) = struct.unpack_from("<I", data, i)
                if bsize == FRAME_MAGIC or bsize == LEGACY_MAGIC or (
                    SKIP_MAGIC_LO <= bsize <= SKIP_MAGIC_HI
                ):
                    break  # next frame begins
                i += 4
                decompress_block(data[i:i + bsize], out)
                i += bsize
        elif SKIP_MAGIC_LO <= magic <= SKIP_MAGIC_HI:
            (sz,) = struct.unpack_from("<I", data, i)
            i += 4 + sz
        else:
            raise ValueError(f"lz4: bad frame magic 0x{magic:08X}")
    return bytes(out)
