""".sens RGB-D sequence container, read and write (port of
``voxelhashing_tpu.io.sensfile``; numpy, the same bytes).

Version-4 layout (little-endian):

    u32   version (== 4)
    u64   sensor-name length; bytes  sensor name
    4x4f  color intrinsic; 4x4f color extrinsic   (row-major f32)
    4x4f  depth intrinsic; 4x4f depth extrinsic
    i32   color compression (0 raw, 1 png, 2 jpeg)
    i32   depth compression (0 raw ushort, 1 zlib ushort, 2 occi)
    u32   colorWidth, colorHeight, depthWidth, depthHeight
    f32   depthShift (depth[m] = stored / depthShift)
    u64   numFrames, then per frame:
        4x4f  camera-to-world;  u64 tsColor; u64 tsDepth
        u64 colorBytes; u64 depthBytes; bytes color; bytes depth
    u64   numIMUFrames, then per IMU frame 5*vec3d + u64 timestamp

Depth zlib compression is plain ``zlib`` over little-endian u16; PNG and
JPEG color decode through PIL, imported only when such a file is read.
The OCCI depth codec runs in the native host library
(``native.occi_decode``/``occi_encode``), which raises when it cannot be
built or loaded; the numpy codec here (``occi_decode_plain``,
``occi_encode_plain``, bit-identical and ~500x slower) runs only when the
caller passes ``native=False``. Nothing here touches the card:
``PrefetchReader``'s decode thread makes no CUDA call.
"""

from __future__ import annotations

import dataclasses
import io as _io
import queue
import struct
import threading
import zlib
from typing import Iterator, List, Optional, Tuple

import numpy as np

SENS_VERSION = 4
COLOR_RAW, COLOR_PNG, COLOR_JPEG = 0, 1, 2
DEPTH_RAW, DEPTH_ZLIB, DEPTH_OCCI = 0, 1, 2


# ---------------------------------------------------------------------------
# OCCI depth codec. Bitstream grammar, MSB first:
#
#   00                  next value == last value
#   11 / 10             next value == last value +1 / -1
#   010 bbbbb           next (N+5) values == last value   (N in 5 bits)
#   01101 / 01100       next value == last value +2 / -2
#   0111 bbbbbbbbbbb    next value == X                   (X in 11 bits)
#
# Values above 2047 cannot ride the 11-bit reset: write metric depth with a
# coarse shift (256 per metre) or use DEPTH_ZLIB (write_sens's default).
# ---------------------------------------------------------------------------


def occi_decode(buf: bytes, num_elements: int, native: bool = True
                ) -> np.ndarray:
    """Decode an OCCI bitstream to u16[num_elements]: the native decoder,
    or the numpy one with ``native=False``."""
    if native:
        from .. import native as native_lib
        return native_lib.occi_decode(buf, num_elements)
    return occi_decode_plain(buf, num_elements)


def occi_encode(values: np.ndarray, native: bool = True) -> bytes:
    """Encode u16 values (masked to 11 bits) as an OCCI bitstream: the
    native encoder, or the numpy one with ``native=False``."""
    if native:
        from .. import native as native_lib
        return native_lib.occi_encode(values)
    return occi_encode_plain(values)


def occi_decode_plain(buf: bytes, num_elements: int) -> np.ndarray:
    """The numpy OCCI decoder (the native decoder's plain version)."""
    bits = np.unpackbits(np.frombuffer(buf, np.uint8))
    out = np.zeros(num_elements, np.uint16)
    pos = 0
    n = 0
    last = 0
    nbits = len(bits)

    def take(k):
        nonlocal pos
        v = 0
        for _ in range(k):
            v = (v << 1) | int(bits[pos])
            pos += 1
        return v

    while n < num_elements and pos < nbits:
        if take(1) == 1:                  # 1x: +/-1
            last = (last + 1) & 0xFFFF if take(1) else (last - 1) & 0xFFFF
            out[n] = last
            n += 1
            continue
        if take(1) == 0:                  # 00: repeat one
            out[n] = last
            n += 1
            continue
        if take(1) == 0:                  # 010: run of repeats
            run = min(take(5) + 5, num_elements - n)
            out[n:n + run] = last
            n += run
            continue
        if take(1) == 0:                  # 0110x: +/-2
            last = (last + 2) & 0xFFFF if take(1) else (last - 2) & 0xFFFF
        else:                             # 0111: 11-bit reset
            last = take(11)
        out[n] = last
        n += 1
    return out


def occi_encode_plain(values: np.ndarray) -> bytes:
    """The numpy OCCI encoder (the native encoder's plain version)."""
    v = np.asarray(values, np.int64).reshape(-1)
    bits: list = []

    def put(val, k):
        for i in range(k - 1, -1, -1):
            bits.append((val >> i) & 1)

    last = 0
    zeros = 0

    def burn_zeros():
        nonlocal zeros
        while zeros > 0:
            if zeros <= 4:
                for _ in range(zeros):
                    put(0, 2)
                zeros = 0
            else:
                enc = min(zeros - 5, 31)
                put(0b010, 3)
                put(enc, 5)
                zeros -= enc + 5

    for cur in v:
        cur = int(cur)
        delta = cur - last
        if delta == 0:
            zeros += 1
        else:
            burn_zeros()
            if delta == 1:
                put(0b11, 2)
            elif delta == -1:
                put(0b10, 2)
            elif delta == 2:
                put(0b01101, 5)
            elif delta == -2:
                put(0b01100, 5)
            else:
                put(0b0111, 4)
                put(cur & 0x7FF, 11)
                cur = cur & 0x7FF
        last = cur
    burn_zeros()
    return np.packbits(np.asarray(bits, np.uint8)).tobytes()


@dataclasses.dataclass
class SensCalibration:
    intrinsic: np.ndarray   # [4,4] f32
    extrinsic: np.ndarray   # [4,4] f32


@dataclasses.dataclass
class SensHeader:
    sensor_name: str
    calibration_color: SensCalibration
    calibration_depth: SensCalibration
    color_compression: int
    depth_compression: int
    color_width: int
    color_height: int
    depth_width: int
    depth_height: int
    depth_shift: float
    num_frames: int


def _read_mat4(f) -> np.ndarray:
    return np.frombuffer(f.read(64), "<f4").reshape(4, 4).copy()


class SensReader:
    """Random-access .sens reader. ``native=False`` decodes OCCI depth with
    the numpy codec."""

    def __init__(self, path: str, native: bool = True):
        self.path = path
        self.native = native
        self._f = open(path, "rb")
        f = self._f
        (version,) = struct.unpack("<I", f.read(4))
        if version != SENS_VERSION:
            self._f.close()
            raise ValueError(f"unsupported .sens version {version}")
        (nlen,) = struct.unpack("<Q", f.read(8))
        name = f.read(nlen).decode("latin-1")
        cal_c = SensCalibration(_read_mat4(f), _read_mat4(f))
        cal_d = SensCalibration(_read_mat4(f), _read_mat4(f))
        cc, dc = struct.unpack("<ii", f.read(8))
        cw, ch, dw, dh = struct.unpack("<IIII", f.read(16))
        (shift,) = struct.unpack("<f", f.read(4))
        (nframes,) = struct.unpack("<Q", f.read(8))
        self.header = SensHeader(name, cal_c, cal_d, cc, dc,
                                 cw, ch, dw, dh, shift, int(nframes))
        self._frame_offsets: List[int] = []
        for _ in range(self.header.num_frames):
            self._frame_offsets.append(f.tell())
            f.seek(64 + 8 + 8, 1)                    # pose + 2 timestamps
            csz, dsz = struct.unpack("<QQ", f.read(16))
            f.seek(csz + dsz, 1)

    def __len__(self):
        return self.header.num_frames

    def read_frame(self, i: int) -> Tuple[np.ndarray, Optional[np.ndarray],
                                          np.ndarray]:
        """Returns (depth [h,w] f32 metres with NaN invalid,
        color [h,w,3] f32 in [0,1] or None, camera_to_world [4,4] f32)."""
        h = self.header
        f = self._f
        f.seek(self._frame_offsets[i])
        pose = _read_mat4(f)
        f.read(16)                                   # timestamps
        csz, dsz = struct.unpack("<QQ", f.read(16))
        cbuf = f.read(csz)
        dbuf = f.read(dsz)

        if h.depth_compression == DEPTH_ZLIB:
            depth_u16 = np.frombuffer(zlib.decompress(dbuf), "<u2")
        elif h.depth_compression == DEPTH_RAW:
            depth_u16 = np.frombuffer(dbuf, "<u2")
        elif h.depth_compression == DEPTH_OCCI:
            depth_u16 = occi_decode(dbuf, h.depth_width * h.depth_height,
                                    native=self.native)
        else:
            raise NotImplementedError(
                f"depth compression {h.depth_compression}")
        depth_u16 = depth_u16.reshape(h.depth_height, h.depth_width)
        depth = depth_u16.astype(np.float32) / h.depth_shift
        depth = np.where(depth_u16 == 0, np.nan, depth)

        color = None
        if csz > 0:
            if h.color_compression == COLOR_RAW:
                color = np.frombuffer(cbuf, np.uint8).reshape(
                    h.color_height, h.color_width, 3)
            else:                                    # PNG / JPEG
                from PIL import Image
                color = np.asarray(
                    Image.open(_io.BytesIO(cbuf)).convert("RGB"))
            color = color.astype(np.float32) / 255.0
        return depth, color, pose

    def frames(self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray],
                                       np.ndarray]]:
        for i in range(len(self)):
            yield self.read_frame(i)

    def ground_truth(self) -> List[np.ndarray]:
        """All camera-to-world poses."""
        poses = []
        f = self._f
        for off in self._frame_offsets:
            f.seek(off)
            poses.append(_read_mat4(f))
        return poses

    def close(self):
        self._f.close()


def write_sens(path: str, depths: np.ndarray, colors: Optional[np.ndarray],
               poses: List[np.ndarray], intrinsic: np.ndarray,
               depth_shift: float = 1000.0, sensor_name: str = "synthetic",
               compress_depth: bool = True,
               depth_codec: Optional[int] = None,
               native: bool = True) -> None:
    """Write a version-4 .sens file (host arrays).

    depths: [n,h,w] f32 metres (NaN invalid); colors: [n,h,w,3] f32 [0,1]
    or None; intrinsic: [4,4]. ``depth_codec``: DEPTH_RAW / DEPTH_ZLIB /
    DEPTH_OCCI (default: zlib when ``compress_depth``; OCCI needs
    depth*shift < 2048, i.e. a coarse shift like 256/m, and encodes
    natively unless ``native=False``).
    """
    if depth_codec is None:
        depth_codec = DEPTH_ZLIB if compress_depth else DEPTH_RAW
    n, h, w = depths.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<I", SENS_VERSION))
        name = sensor_name.encode()
        f.write(struct.pack("<Q", len(name)) + name)
        intr = np.asarray(intrinsic, "<f4").reshape(4, 4)
        eye = np.eye(4, dtype="<f4")
        for m in (intr, eye, intr, eye):             # color cal, depth cal
            f.write(m.tobytes())
        f.write(struct.pack("<ii", COLOR_RAW, depth_codec))
        f.write(struct.pack("<IIII", w, h, w, h))
        f.write(struct.pack("<f", depth_shift))
        f.write(struct.pack("<Q", n))
        for i in range(n):
            d = depths[i]
            cap = 2047 if depth_codec == DEPTH_OCCI else 65535
            du16 = np.where(np.isfinite(d), np.clip(
                np.round(d * depth_shift), 0, cap), 0).astype("<u2")
            if depth_codec == DEPTH_OCCI:
                dbuf = occi_encode(du16.reshape(-1), native=native)
            else:
                dbuf = du16.tobytes()
                if depth_codec == DEPTH_ZLIB:
                    dbuf = zlib.compress(dbuf)
            cbuf = b""
            if colors is not None:
                cbuf = np.clip(colors[i] * 255.0, 0,
                               255).astype(np.uint8).tobytes()
            f.write(np.asarray(poses[i], "<f4").reshape(4, 4).tobytes())
            f.write(struct.pack("<QQ", i * 33333, i * 33333))
            f.write(struct.pack("<QQ", len(cbuf), len(dbuf)))
            f.write(cbuf)
            f.write(dbuf)
        f.write(struct.pack("<Q", 0))                # no IMU frames


class SensChainReader:
    """Several .sens files replayed as one sequence; all must share the
    depth size (a mismatch raises)."""

    def __init__(self, paths: List[str], native: bool = True):
        if not paths:
            raise ValueError("no .sens files given")
        self.readers = []
        try:
            for p in paths:
                self.readers.append(SensReader(p, native=native))
            h0 = self.readers[0].header
            for r in self.readers[1:]:
                h = r.header
                if (h.depth_width, h.depth_height) != (h0.depth_width,
                                                       h0.depth_height):
                    raise ValueError(
                        f"{r.path}: depth size {h.depth_width}x"
                        f"{h.depth_height} != {h0.depth_width}x"
                        f"{h0.depth_height} of chain head")
        except BaseException:
            self.close()
            raise
        self.header = h0
        self._starts = []
        n = 0
        for r in self.readers:
            self._starts.append(n)
            n += len(r)
        self._total = n

    def __len__(self):
        return self._total

    def _locate(self, i: int):
        if not 0 <= i < self._total:
            raise IndexError(i)
        for ri in range(len(self.readers) - 1, -1, -1):
            if i >= self._starts[ri]:
                return self.readers[ri], i - self._starts[ri]
        raise IndexError(i)

    def read_frame(self, i: int):
        r, j = self._locate(i)
        return r.read_frame(j)

    def frames(self):
        for r in self.readers:
            yield from r.frames()

    def ground_truth(self) -> List[np.ndarray]:
        out: List[np.ndarray] = []
        for r in self.readers:
            out.extend(r.ground_truth())
        return out

    def close(self):
        for r in self.readers:
            r.close()


class PrefetchReader:
    """Read-ahead frame cache: a background thread decodes frames (numpy,
    no CUDA call) into a bounded queue, in order, so decompression overlaps
    the device step. Wraps any reader with ``read_frame``, ``__len__``,
    ``header`` and ``ground_truth``; the ground truth is read up front, as
    the worker owns the file afterwards. Consume with :meth:`frames`;
    :meth:`close` stops the worker, also after an early exit."""

    def __init__(self, reader, depth: int = 8):
        self.reader = reader
        self.header = reader.header
        self._gt = reader.ground_truth()
        self._n = len(reader)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        # a bounded put that gives up once close() is called, so that an
        # abandoned reader's worker never blocks on a full queue
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    def _work(self):
        try:
            for i in range(self._n):
                if self._stop.is_set() or not self._put(
                        self.reader.read_frame(i)):
                    break
        except Exception as e:          # handed to the consumer by frames()
            self._error = e
        finally:
            self._put(None)

    def __len__(self):
        return self._n

    def frames(self):
        while True:
            item = self._q.get()
            if item is None:
                if self._error is not None:
                    raise self._error
                return
            yield item

    def read_frame(self, i: int):
        raise TypeError("PrefetchReader is sequential; iterate frames()")

    def ground_truth(self) -> List[np.ndarray]:
        return self._gt

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)
        self.reader.close()


def tum_to_sens(tum_dir: str, out_path: str, max_frames: Optional[int] = None,
                compress_depth: bool = True) -> int:
    """Convert a TUM RGB-D directory to a .sens file. Returns the number of
    frames written."""
    from .tum import load_tum
    seq = load_tum(tum_dir, max_frames=max_frames)
    cam = seq.camera
    depths, colors, poses = [], [], []
    for i in range(len(seq)):
        d, c, p = seq.read_frame(i)
        depths.append(d)
        colors.append(c if c is not None
                      else np.zeros(d.shape + (3,), np.float32))
        poses.append(p if p is not None else np.eye(4, dtype=np.float32))
    intr = np.eye(4, dtype=np.float32)
    intr[0, 0], intr[1, 1] = cam.fx, cam.fy
    intr[0, 2], intr[1, 2] = cam.cx, cam.cy
    write_sens(out_path, np.stack(depths), np.stack(colors), poses, intr,
               sensor_name="tum", compress_depth=compress_depth)
    return len(depths)
