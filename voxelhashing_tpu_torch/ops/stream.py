"""Streaming's device half on the card (``csrc/stream.cu``): the sweep of
one pool part (``stream_sweep_kernel``), the copy of the rows it listed into
a ring slot (``stream_extract_kernel``) and a stream-in's bitmask sets and
clears (``stream_bits_kernel``); and page-locked host memory mapped into the
card's address space (:class:`HostBuffer`): the sweep reads the camera
there and writes the count and the keys there, the extract the rows.

No TPU kernel: the JAX package runs the sweep and the extract as XLA
(``voxelhashing_tpu/streaming.py:76`` ``select_stream_out``, :118
``extract_blocks``). Their plain versions, which the CPU path runs, are
``streaming.select_stream_out``, ``streaming.extract_blocks`` and
``streaming.bitmask_delta``; the sweep lists the same rows in the same
order, with the same keys, count and mask.

:func:`sweep`, :func:`extract` and :func:`bits` issue one launch each on
the current stream (a CUDA graph captures them) and count it in their
``launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from ..config import MapConfig, StreamingConfig, VOXELS_PER_BLOCK


class HostBuffer:
    """Page-locked host memory of ``shape`` and ``dtype`` that the card
    reads and writes in place (``array``: the host's numpy view;
    ``device_ptr``: the address a kernel uses). Freed by :meth:`free`."""

    def __init__(self, shape, dtype=np.float32):
        dtype = np.dtype(dtype)
        shape = tuple(np.atleast_1d(shape))
        nbytes = int(np.prod(shape)) * dtype.itemsize
        out = (ctypes.c_void_p * 2)()
        _build.check(_build.library("stream").vh_stream_host_alloc(
            nbytes, ctypes.addressof(out)), "stream")
        self.host_ptr, self.device_ptr = out[0], out[1]
        self.array = np.ctypeslib.as_array(
            (ctypes.c_uint8 * nbytes).from_address(self.host_ptr)
        ).view(dtype).reshape(shape)

    def free(self) -> None:
        if self.host_ptr is not None:
            self.array = None
            _build.check(_build.library("stream").vh_stream_host_free(
                ctypes.c_void_p(self.host_ptr)), "stream")
            self.host_ptr = self.device_ptr = None


def _check(t, dtype, shape, what):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.device.type != "cuda":
        raise ValueError(f"stream: {what} must be a contiguous {dtype} "
                         f"{tuple(shape)} CUDA tensor, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _check_host(buf: HostBuffer, dtype, shape, what):
    a = buf.array
    if a is None or a.dtype != np.dtype(dtype) or a.shape != tuple(shape):
        raise ValueError(f"stream: {what} must be host memory of "
                         f"{np.dtype(dtype).name} {tuple(shape)}")


def sweep(block_key, cam: HostBuffer, part, cfg: MapConfig,
          scfg: StreamingConfig, bpc: int, idx, keys: HostBuffer, mask,
          count, count_host: HostBuffer, bitmask) -> None:
    """List the rows of the part the counter ``part`` (int32 []) holds that
    are allocated and at least ``scfg.radius`` from the camera (the first
    three values of ``cam``), in row order, up to ``idx``'s length: into
    ``idx``, ``keys`` (host memory), ``mask``, ``count`` and
    ``count_host`` (as ``streaming.select_stream_out`` returns them),
    their chunks' bits set in ``bitmask``; the counter moves to the next
    part."""
    cap = idx.shape[0]
    _check(block_key, torch.int32, (cfg.num_blocks,), "block_key")
    _check(part, torch.int32, (), "part")
    _check(idx, torch.int32, (cap,), "idx")
    _check(mask, torch.bool, (cap,), "mask")
    _check(count, torch.int32, (), "count")
    _check(bitmask, torch.int32, (bitmask.shape[0],), "bitmask")
    _check_host(cam, np.float32, (4,), "cam")
    _check_host(keys, np.int32, (cap,), "keys")
    _check_host(count_host, np.int32, (1,), "count_host")
    p = _build.ptr
    h = ctypes.c_void_p
    _build.check(_build.library("stream").vh_stream_sweep(
        p(block_key), cfg.num_blocks, h(cam.device_ptr), p(part),
        scfg.out_parts, cfg.world_blocks, bpc, scfg.grid_dim,
        cfg.voxel_size, 0.5 * cfg.block_size_world, scfg.radius, cap,
        p(idx), h(keys.device_ptr), p(mask), p(count),
        h(count_host.device_ptr), p(bitmask), bitmask.shape[0],
        _build.stream_ptr(block_key.device)), "stream")
    sweep.launches += 1


sweep.launches = 0


def extract(count, idx, sdf, weight, color, out_sdf: HostBuffer,
            out_weight: HostBuffer, out_color: HostBuffer) -> None:
    """Copy the pool rows ``idx[:count]`` (sdf, weight, color, in the
    pool's dtypes) into the first ``count`` rows of the ``out_*`` host
    arrays (sdf and weight as the bfloat16 bits, uint16)."""
    cap = idx.shape[0]
    rows = (sdf.shape[0], VOXELS_PER_BLOCK)
    _check(sdf, torch.bfloat16, rows, "sdf")
    _check(weight, torch.bfloat16, rows, "weight")
    _check(color, torch.int32, rows, "color")
    _check(idx, torch.int32, (cap,), "idx")
    for buf, dt, what in ((out_sdf, np.uint16, "out_sdf"),
                          (out_weight, np.uint16, "out_weight"),
                          (out_color, np.int32, "out_color")):
        _check_host(buf, dt, (cap, VOXELS_PER_BLOCK), what)
    p = _build.ptr
    h = ctypes.c_void_p
    _build.check(_build.library("stream").vh_stream_extract(
        p(count), p(idx), cap, p(sdf), p(weight), p(color),
        h(out_sdf.device_ptr), h(out_weight.device_ptr),
        h(out_color.device_ptr), _build.stream_ptr(idx.device)), "stream")
    extract.launches += 1


extract.launches = 0


def bits(bitmask, ids, n_set: int) -> None:
    """Set the bits of ``ids[:n_set]`` and clear those of ``ids[n_set:]``
    (int32 grid indices on the card; the two lists disjoint)."""
    _check(ids, torch.int32, (ids.shape[0],), "ids")
    n_clear = ids.shape[0] - n_set
    if not 0 <= n_set <= ids.shape[0]:
        raise ValueError(f"stream: {n_set} ids to set of {ids.shape[0]}")
    _build.check(_build.library("stream").vh_stream_bits(
        _build.ptr(bitmask), _build.ptr(ids), n_set, n_clear,
        _build.stream_ptr(bitmask.device)), "stream")
    bits.launches += 1


bits.launches = 0
