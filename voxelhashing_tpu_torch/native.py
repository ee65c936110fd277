"""ctypes binding of the host runtime ``native/voxelhash_host.cpp``: the
chunk store that holds streamed-out blocks in host memory, the
vertex-welding PLY writer, and the OCCI depth codec of ``.sens`` files.

The C++ source is shared with the JAX package and not changed; this module
builds its own copy with g++ at first use into
``build/voxelhashing_tpu_torch/`` at the repository root (named by a hash
of the source), and never falls back: a missing compiler or a failed build
raises. ``streaming.PyChunkStore`` and ``meshing.merge_vertices`` are the
plain versions, chosen explicitly by callers, as are
``io.sensfile.occi_decode_plain`` and ``occi_encode_plain``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .config import VOXELS_PER_BLOCK

_REPO = Path(__file__).resolve().parents[1]
SOURCE = _REPO / "native" / "voxelhash_host.cpp"
BUILD_DIR = _REPO / "build" / "voxelhashing_tpu_torch"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_P, _I32, _I64, _F = (ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                      ctypes.c_float)
_SIGNATURES = {
    "chunkstore_create": ([_I32, _I32], _P),
    "chunkstore_destroy": ([_P], None),
    "chunkstore_file_blocks": ([_P, _P, _P, _P, _P, _I32], None),
    "chunkstore_block_count": ([_P], _I64),
    "chunkstore_chunk_count": ([_P], _I32),
    "chunkstore_pop_in_sphere": ([_P, _F, _F, _F, _F, _F, _I32, _I32,
                                  _P, _P, _P, _P, _P, _P], _I32),
    "chunkstore_chunk_ids": ([_P, _I32, _P, _I32], _I32),
    "chunkstore_chunk_coords": ([_P, _P, _I32], _I32),
    "chunkstore_peek_count": ([_P, _P, _I32], _I64),
    "chunkstore_peek_chunks": ([_P, _P, _I32, _P, _P, _P, _P, _I32], _I32),
    "mesh_weld_save_ply": ([ctypes.c_char_p, _P, _P, _I64, _F], _I64),
    "occi_decode_u16": ([_P, _I64, _P, _I64], ctypes.c_int),
    "occi_encode_u16": ([_P, _I64, _P, _I64], _I64),
}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libvoxelhash_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host runtime cannot "
                           "be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded host runtime (built at first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _rows(n: int):
    return (np.zeros((n,), np.int32),
            np.zeros((n, VOXELS_PER_BLOCK), np.float32),
            np.zeros((n, VOXELS_PER_BLOCK), np.float32),
            np.zeros((n, VOXELS_PER_BLOCK), np.uint32))


class NativeChunkStore:
    """The C++ chunk store; the same interface as ``streaming.PyChunkStore``
    (keys int32, sdf and weight f32, color uint32, 512 voxels a row)."""

    def __init__(self, blocks_per_chunk: int, world_blocks: int):
        self._lib = library()
        self._h = self._lib.chunkstore_create(blocks_per_chunk, world_blocks)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.chunkstore_destroy(self._h)
            self._h = None

    def file_blocks(self, keys, sdf, weight, color):
        n = len(keys)
        if n == 0:
            return
        keys = np.ascontiguousarray(keys, np.int32)
        sdf = np.ascontiguousarray(sdf, np.float32)
        weight = np.ascontiguousarray(weight, np.float32)
        color = np.ascontiguousarray(color, np.uint32)
        shape = (n, VOXELS_PER_BLOCK)
        if sdf.shape != shape or weight.shape != shape \
                or color.shape != shape or keys.shape != (n,):
            raise ValueError(f"file_blocks: rows must be [{n}, 512]")
        self._lib.chunkstore_file_blocks(self._h, _ptr(keys), _ptr(sdf),
                                         _ptr(weight), _ptr(color), n)

    def block_count(self) -> int:
        return int(self._lib.chunkstore_block_count(self._h))

    def chunk_count(self) -> int:
        return int(self._lib.chunkstore_chunk_count(self._h))

    def pop_in_sphere(self, cam_pos, radius: float, chunk_size_world: float,
                      max_chunks: int, cap: int):
        k, s, w, c, _ = self.pop_in_sphere_tracked(
            cam_pos, radius, chunk_size_world, max_chunks, cap)
        return k, s, w, c

    def pop_in_sphere_tracked(self, cam_pos, radius: float,
                              chunk_size_world: float, max_chunks: int,
                              cap: int):
        """Pop up to ``max_chunks`` chunks wholly inside the sphere (at most
        ``cap`` blocks; a chunk that does not fit is split). Returns the
        rows and the coords [m,3] of the chunks removed entirely."""
        keys, sdf, weight, color = _rows(cap)
        cleared = np.zeros((max(max_chunks, 1) * 3,), np.int32)
        n_cleared = np.zeros((1,), np.int32)
        n = self._lib.chunkstore_pop_in_sphere(
            self._h, float(cam_pos[0]), float(cam_pos[1]),
            float(cam_pos[2]), float(radius), float(chunk_size_world),
            max_chunks, cap, _ptr(keys), _ptr(sdf), _ptr(weight),
            _ptr(color), _ptr(cleared), _ptr(n_cleared))
        m = int(n_cleared[0])
        return (keys[:n], sdf[:n], weight[:n], color[:n],
                cleared[:3 * m].reshape(m, 3))

    def chunk_ids(self, grid_dim: int, cap: int = 1 << 20) -> np.ndarray:
        out = np.zeros((cap,), np.int32)
        n = self._lib.chunkstore_chunk_ids(self._h, grid_dim, _ptr(out), cap)
        return out[:n]

    def chunk_coords(self, cap: int = 1 << 20) -> np.ndarray:
        out = np.zeros((cap * 3,), np.int32)
        n = self._lib.chunkstore_chunk_coords(self._h, _ptr(out), cap)
        return out[:3 * n].reshape(n, 3)

    def peek_count(self, coords) -> int:
        coords = np.ascontiguousarray(coords, np.int32).reshape(-1, 3)
        return int(self._lib.chunkstore_peek_count(self._h, _ptr(coords),
                                                   len(coords)))

    def peek_chunks(self, coords) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray, np.ndarray]:
        """Copies (the store keeps them) of every block of the chunks
        ``coords`` [m,3]."""
        coords = np.ascontiguousarray(coords, np.int32).reshape(-1, 3)
        m = len(coords)
        cap = int(self._lib.chunkstore_peek_count(self._h, _ptr(coords), m))
        keys, sdf, weight, color = _rows(cap)
        if cap:
            n = self._lib.chunkstore_peek_chunks(
                self._h, _ptr(coords), m, _ptr(keys), _ptr(sdf),
                _ptr(weight), _ptr(color), cap)
            if n != cap:
                raise RuntimeError(f"peek_chunks: {n} rows of {cap}")
        return keys, sdf, weight, color


def weld_save_ply(path: str, triangles: np.ndarray,
                  colors: Optional[np.ndarray], eps: float) -> int:
    """Weld vertices on their exact quantized position (``round(p/eps)``)
    and write a binary little-endian PLY; returns the face count."""
    tris = np.ascontiguousarray(triangles, np.float32).reshape(-1, 3, 3)
    cols = None if colors is None else np.ascontiguousarray(
        colors, np.float32).reshape(tris.shape)
    n = library().mesh_weld_save_ply(
        str(path).encode(), _ptr(tris), None if cols is None else _ptr(cols),
        len(tris), float(eps))
    if n < 0:
        raise IOError(f"mesh_weld_save_ply failed: {path}")
    return int(n)


def occi_decode(buf: bytes, num_elements: int) -> np.ndarray:
    """Decode an OCCI depth bitstream into uint16[num_elements]."""
    out = np.empty(num_elements, np.uint16)
    src = np.frombuffer(buf, np.uint8)
    rc = library().occi_decode_u16(_ptr(src), len(src), _ptr(out),
                                   int(num_elements))
    if rc != 0:
        raise ValueError("occi bitstream truncated")
    return out


def occi_encode(values: np.ndarray) -> bytes:
    """Encode uint16 values (masked to 11 bits) as an OCCI bitstream."""
    v = np.ascontiguousarray(values, np.uint16).reshape(-1)
    cap = 2 * v.size + 16
    out = np.zeros(cap, np.uint8)
    n = library().occi_encode_u16(_ptr(v), v.size, _ptr(out), cap)
    if n < 0:
        raise ValueError("occi encode overflow")
    return out[:n].tobytes()
