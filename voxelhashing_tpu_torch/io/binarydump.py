"""mLib ``.sensor`` binary dump, read and write (port of
``voxelhashing_tpu.io.binarydump``; numpy, the same bytes).

Layout (little-endian; strings and vectors are a u64 count and the
elements, mat4f is 16 row-major f32):

    u32   version (1 or 2)
    str   sensor name               (u64 len + bytes)
    u32   depth_num_frames
    u32   depth_width, depth_height
    u32   color_num_frames
    u32   color_width, color_height
    4x mat4f depth calibration      (intrinsic, intrinsic^-1,
                                     extrinsic, extrinsic^-1)
    4x mat4f color calibration
    depth frames: raw f32[h*w] each (metres; invalid = -inf/0)
    color frames: raw u8[h*w*4] RGBA each
    vec<u64> color timestamps       (u64 count + values)
    vec<u64> depth timestamps
    vec<mat4f> trajectory           (version 2 only; camera-to-world)
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..config import CameraConfig

_MINF = np.float32(-np.inf)


def _read_mat4(f) -> np.ndarray:
    return np.frombuffer(f.read(64), np.float32).reshape(4, 4).copy()


def _write_mat4(f, m) -> None:
    f.write(np.ascontiguousarray(m, np.float32).tobytes())


def _read_str(f) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("latin-1")


def _read_u64_vec(f) -> np.ndarray:
    (n,) = struct.unpack("<Q", f.read(8))
    return np.frombuffer(f.read(8 * n), np.uint64).copy()


class BinaryDumpReader:
    """Streaming ``.sensor`` reader with the SensReader interface."""

    def __init__(self, path: str):
        self.path = path
        self._f = f = open(path, "rb")
        (version,) = struct.unpack("<I", f.read(4))
        if version not in (1, 2):
            raise ValueError(f"unsupported .sensor version {version}")
        self.version = version
        self.sensor_name = _read_str(f)
        (self.num_frames, self.depth_width, self.depth_height,
         self.color_num_frames, self.color_width, self.color_height
         ) = struct.unpack("<6I", f.read(24))
        self.depth_intrinsic = _read_mat4(f)
        _ = _read_mat4(f)                       # intrinsic inverse (derived)
        self.depth_extrinsic = _read_mat4(f)
        _ = _read_mat4(f)
        self.color_intrinsic = _read_mat4(f)
        _ = _read_mat4(f)
        self.color_extrinsic = _read_mat4(f)
        _ = _read_mat4(f)
        self._depth_off = f.tell()
        dsz = 4 * self.depth_width * self.depth_height
        csz = 4 * self.color_width * self.color_height
        self._color_off = self._depth_off + self.num_frames * dsz
        f.seek(self._color_off + self.color_num_frames * csz)
        self.color_timestamps = _read_u64_vec(f)
        self.depth_timestamps = _read_u64_vec(f)
        self.trajectory: List[np.ndarray] = []
        if version == 2:
            (n,) = struct.unpack("<Q", f.read(8))
            self.trajectory = [_read_mat4(f) for _ in range(int(n))]

    @property
    def camera(self) -> CameraConfig:
        """Depth intrinsics as a CameraConfig (initializeDepthIntrinsics,
        BinaryDumpReader.cpp:50)."""
        k = self.depth_intrinsic
        return CameraConfig(width=self.depth_width,
                            height=self.depth_height,
                            fx=float(k[0, 0]), fy=float(k[1, 1]),
                            cx=float(k[0, 2]), cy=float(k[1, 2]))

    def __len__(self) -> int:
        return self.num_frames

    def read_frame(self, i: int) -> Tuple[np.ndarray, Optional[np.ndarray],
                                          Optional[np.ndarray]]:
        """(depth [h,w] f32 NaN-invalid, color [h,w,3] f32 [0,1] | None,
        camera-to-world pose [4,4] | None)."""
        f = self._f
        dw, dh = self.depth_width, self.depth_height
        f.seek(self._depth_off + i * 4 * dw * dh)
        d = np.frombuffer(f.read(4 * dw * dh), np.float32).reshape(dh, dw)
        d = d.copy()
        d[~np.isfinite(d) | (d <= 0.0)] = np.nan
        c = None
        if i < self.color_num_frames:
            cw, ch = self.color_width, self.color_height
            f.seek(self._color_off + i * 4 * cw * ch)
            rgba = np.frombuffer(f.read(4 * cw * ch),
                                 np.uint8).reshape(ch, cw, 4)
            c = rgba[..., :3].astype(np.float32) / 255.0
        pose = self.trajectory[i] if i < len(self.trajectory) else None
        return d, c, pose

    def frames(self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray],
                                       Optional[np.ndarray]]]:
        for i in range(self.num_frames):
            yield self.read_frame(i)

    def close(self) -> None:
        self._f.close()


def write_sensor(path: str, cam: CameraConfig, frames,
                 trajectory=None, sensor_name: str = "voxelhashing_tpu",
                 color_cam: Optional[CameraConfig] = None) -> int:
    """Write an mLib-wire-compatible ``.sensor`` dump (version 2).

    ``frames``: iterable of (depth [h,w] f32 metres NaN-invalid,
    color [h,w,3] f32 [0,1] | None). Returns the frame count.
    """
    frames = list(frames)
    n = len(frames)
    has_color = n > 0 and frames[0][1] is not None
    ccam = color_cam or cam

    def k_mat(c: CameraConfig) -> np.ndarray:
        k = np.eye(4, dtype=np.float32)
        k[0, 0], k[1, 1] = c.fx, c.fy
        k[0, 2], k[1, 2] = c.cx, c.cy
        return k

    with open(path, "wb") as f:
        f.write(struct.pack("<I", 2))
        name = sensor_name.encode("latin-1")
        f.write(struct.pack("<Q", len(name)) + name)
        f.write(struct.pack("<6I", n, cam.width, cam.height,
                            n if has_color else 0, ccam.width, ccam.height))
        for k in (k_mat(cam), ccam and k_mat(ccam)):
            _write_mat4(f, k)
            _write_mat4(f, np.linalg.inv(k))
            _write_mat4(f, np.eye(4, dtype=np.float32))   # extrinsic
            _write_mat4(f, np.eye(4, dtype=np.float32))
        for d, _ in frames:
            d = np.asarray(d, np.float32).copy()
            d[~np.isfinite(d)] = _MINF                    # MINF invalid
            f.write(d.tobytes())
        if has_color:
            for _, c in frames:
                rgba = np.empty((ccam.height, ccam.width, 4), np.uint8)
                rgba[..., :3] = np.clip(np.asarray(c) * 255.0, 0,
                                        255).astype(np.uint8)
                rgba[..., 3] = 255
                f.write(rgba.tobytes())
        ts = np.arange(n, dtype=np.uint64)
        f.write(struct.pack("<Q", n if has_color else 0))
        if has_color:
            f.write(ts.tobytes())
        f.write(struct.pack("<Q", n) + ts.tobytes())
        traj = trajectory if trajectory is not None else []
        f.write(struct.pack("<Q", len(traj)))
        for m in traj:
            _write_mat4(f, m)
    return n
