"""TCP RGB-D frame streaming: network sensor and server (port of
``voxelhashing_tpu.io.network``; the same wire format).

A length-prefixed binary protocol carrying zlib-compressed u16 depth, raw
RGB and an optional device pose per frame (little-endian):

    u32 magic 0x52474244 ('RGBD'); u32 width; u32 height; u32 flags
        (bit0: has color, bit1: has pose)
    f32 depth_shift
    u64 depth_bytes; u64 color_bytes
    f32[16] camera-to-world pose (row major; identity if absent)
    bytes: zlib(u16 depth * shift), raw u8 rgb
"""

from __future__ import annotations

import socket
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

MAGIC = 0x52474244
_HDR = struct.Struct("<IIIIfQQ")


def _pack_frame(depth: np.ndarray, color: Optional[np.ndarray],
                pose: Optional[np.ndarray], depth_shift: float) -> bytes:
    h, w = depth.shape
    du16 = np.where(np.isfinite(depth),
                    np.clip(depth * depth_shift, 0, 65535), 0
                    ).astype("<u2")
    dbuf = zlib.compress(du16.tobytes())
    cbuf = b""
    flags = 0
    if color is not None:
        flags |= 1
        cbuf = np.clip(color * 255.0, 0, 255).astype(np.uint8).tobytes()
    if pose is not None:
        flags |= 2
    p = np.asarray(pose if pose is not None else np.eye(4), "<f4")
    return (_HDR.pack(MAGIC, w, h, flags, depth_shift, len(dbuf), len(cbuf))
            + p.tobytes() + dbuf + cbuf)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _unpack_frame(sock: socket.socket):
    hdr = _recv_exact(sock, _HDR.size)
    magic, w, h, flags, shift, dlen, clen = _HDR.unpack(hdr)
    if magic != MAGIC:
        raise ValueError(f"bad frame magic {magic:#x}")
    pose = np.frombuffer(_recv_exact(sock, 64), "<f4").reshape(4, 4).copy()
    du16 = np.frombuffer(zlib.decompress(_recv_exact(sock, dlen)),
                         "<u2").reshape(h, w)
    depth = du16.astype(np.float32) / shift
    depth = np.where(du16 == 0, np.nan, depth)
    color = None
    if flags & 1:
        color = np.frombuffer(_recv_exact(sock, clen),
                              np.uint8).reshape(h, w, 3)
        color = color.astype(np.float32) / 255.0
    return depth, color, (pose if flags & 2 else None)


class RGBDStreamServer:
    """Sensor-side frame publisher (the NetworkServer role): accepts one
    client and pushes frames."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 depth_shift: float = 1000.0):
        self.depth_shift = depth_shift
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(1)
        self.port = self._lsock.getsockname()[1]
        self._conn: Optional[socket.socket] = None

    def accept(self, timeout: Optional[float] = None):
        self._lsock.settimeout(timeout)
        self._conn, _ = self._lsock.accept()

    def send_frame(self, depth, color=None, pose=None):
        if self._conn is None:
            raise RuntimeError("no client connected")
        self._conn.sendall(_pack_frame(np.asarray(depth), color, pose,
                                       self.depth_shift))

    def close(self):
        if self._conn is not None:
            self._conn.close()
        self._lsock.close()


class NetworkSensor:
    """Engine-side frame consumer (NetworkSensor.h role): connects to a
    stream server and yields frames; the optional device pose plays the
    part of the Tango fallback pose (DepthSensing.cpp:781-785)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)

    def read_frame(self) -> Tuple[np.ndarray, Optional[np.ndarray],
                                  Optional[np.ndarray]]:
        return _unpack_frame(self._sock)

    def frames(self):
        while True:
            try:
                yield self.read_frame()
            except (ConnectionError, OSError):
                return

    def close(self):
        self._sock.close()
