"""Kernel A: the fused TSDF integrate (``csrc/fused_integrate.cu``).

Replaces the TPU Pallas kernel ``voxelhashing_tpu/ops/pallas_integrate.py``
(``pl.pallas_call`` at :321, reached through ``integrate_pallas`` and
``integrate_pallas_dense``). One kernel serves both: the dense-slice path
and its ``lax.cond`` were TPU workarounds.

:func:`fused_integrate` launches the CUDA kernel for CUDA tensors and runs
the plain PyTorch version, ``integrate.integrate`` over the first
``n_active`` rows, for CPU tensors; any other device raises. There is no
fallback from the kernel to the plain version.

On a CUDA tensor the wrapper inverts the pose (``geometry.invert_rigid``,
the same bits as the plain version) and checks what the kernel assumes
(:func:`prepare`); :func:`launch` then issues the kernel alone, which forms
each pixel's color word from the f32 RGB frame itself. With
``MapConfig.bilinear_color`` :func:`launch` issues two kernels on the
stream: ``vh_frame_color_words``, which writes the frame's color-word image
(``integrate.frame_color_word``; counted in
``fused_integrate.color_word_launches``), then the bilinear variant,
which reads its corners from that image
(``vh_fused_integrate_bilinear``, counted in
``fused_integrate.bilinear_launches``; the nearest-color kernel in
``fused_integrate.launches``). A depth-only frame skips the image. The
plain version counts its calls on CUDA tensors
(``integrate.integrate.cuda_calls``). Its least time on the card is the
larger of :func:`bytes_moved` over the memory rate and :func:`operations`
over the f32 rate; see the source for what its design does about the
bytes.
"""

from __future__ import annotations

import torch

from ..config import CameraConfig, MapConfig, VOXELS_PER_BLOCK
from .. import geometry as geom
from .. import integrate as integ
from ..blockmap import MapState, POOL_DTYPE
from . import _build

_POOL_ALIGN = 16      # bulk copies (TMA) need 16-byte aligned rows


def bytes_moved(n_rows: int, n_updated: int, max_rows: int,
                cam: CameraConfig, with_color: bool = True) -> int:
    """The least bytes kernel A must move, each input read once and each
    output written once: bf16 sdf and weight of every voxel of the
    ``n_rows`` active rows (4 B); for each of the ``n_updated`` voxels its
    color read and its sdf, weight and color written (12 B); the frame
    (f32 depth, and f32 RGB when given); per active row its ``active_idx``
    entry and block key read and its surface flag written; the stats of
    all ``max_rows`` rows written (8 B each); the view matrix and
    ``n_active`` read. The bilinear variant moves the same bytes: its
    color-word image (4 B a pixel, written and read back) is neither an
    input nor an output, and its corner reads read that image again."""
    pixels = cam.height * cam.width
    row_reads = 2 * 2 * VOXELS_PER_BLOCK * n_rows
    updated = (4 + 2 + 2 + 4) * n_updated
    frame = pixels * 4 * (4 if with_color else 1)
    per_row = (4 + 4 + 1) * n_rows
    return row_reads + updated + frame + per_row + 8 * max_rows + 64 + 4


# f32 operations per voxel, counted on the plain version (integrate.integrate)
# with adds, multiplies, divisions, min/max, floor, abs and compares one each:
# every voxel of an active row is placed (3) and moved into the camera (18),
# projected (12), tested against its depth sample (8) and enters the row's
# stats (5); an updated voxel also forms its color word (15) and its update
# (13: the clamp, the sample weight and the weighted mean)
_OPS_PER_VOXEL = 3 + 18 + 12 + 8 + 5
_OPS_PER_UPDATE = 15 + 13
# the bilinear variant's color sample in place of the one color word (15),
# counted the same way on integrate._bilinear_color: the rounded centre (4),
# the offsets, their directions and alpha, beta (6), the corners' pixels
# (2), per corner the screen test, clamps and index (10) and its three
# channels (3), the weights and normalisers (8), per channel two row sums,
# three divisions, the column sum and the clamp (14) and the three lower
# bounds of the divisors (3); and once per pixel the color word of the
# color-word image (15)
_OPS_BILINEAR_COLOR = 4 + 6 + 2 + 4 * (10 + 3) + 8 + 3 * 14 + 3
_OPS_COLOR_WORD = 15


def operations(n_rows: int, n_updated: int, bilinear: bool = False,
               n_pixels: int = 0) -> int:
    """The f32 operations kernel A (or with ``bilinear`` its bilinear
    variant and the color-word image of a frame of ``n_pixels``) must do
    for ``n_rows`` active rows of which ``n_updated`` voxels update (the
    counts above)."""
    per_update = _OPS_PER_UPDATE
    if bilinear:
        per_update += _OPS_BILINEAR_COLOR - _OPS_COLOR_WORD
    return (_OPS_PER_VOXEL * VOXELS_PER_BLOCK * n_rows
            + per_update * n_updated
            + (_OPS_COLOR_WORD * n_pixels if bilinear else 0))


def _check_inputs(state: MapState, depth, color, view, active_idx, n_active,
                  cam: CameraConfig):
    dev = depth.device
    n = state.block_key.shape[0]
    checks = [
        (state.sdf.dtype == POOL_DTYPE and state.weight.dtype == POOL_DTYPE,
         "pool sdf/weight must be bf16"),
        (state.color.dtype == torch.int32, "pool color must be int32"),
        (state.block_key.dtype == torch.int32, "block_key must be int32"),
        (state.surf.dtype == torch.bool, "surf must be bool"),
        (all(tuple(t.shape) == (n, VOXELS_PER_BLOCK)
             for t in (state.sdf, state.weight, state.color))
         and tuple(state.surf.shape) == (n,), "pool shapes must agree"),
        (active_idx.dtype == torch.int32 and active_idx.ndim == 1,
         "active_idx must be int32[M]"),
        (tuple(depth.shape) == (cam.height, cam.width)
         and depth.dtype == torch.float32, "depth must be f32[h,w]"),
        (color is None or (tuple(color.shape) == (cam.height, cam.width, 3)
                           and color.dtype == torch.float32),
         "color must be f32[h,w,3] or None"),
        (view.dtype == torch.float32 and tuple(view.shape) == (4, 4),
         "view must be f32[4,4]"),
        (n_active.numel() == 1 and n_active.dtype == torch.int32,
         "n_active must be an int32 scalar tensor"),
        (all(t.data_ptr() % _POOL_ALIGN == 0
             for t in (state.sdf, state.weight, state.color)),
         "pool sdf/weight/color must be 16-byte aligned"),
    ]
    tensors = [state.sdf, state.weight, state.color, state.block_key,
               state.surf, active_idx, n_active, depth, view]
    if color is not None:
        tensors.append(color)
    for t in tensors:
        checks.append((t.device == dev, "all tensors on one device"))
        checks.append((t.is_contiguous(), "tensors must be contiguous"))
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"fused_integrate: {msg}")


def prepare(state: MapState, depth, color, view, cam: CameraConfig,
            cfg: MapConfig, active_idx, n_active):
    """Check the inputs and allocate the stats; returns (launch arguments,
    stats f32[M,2]). Everything :func:`launch` needs is in the arguments
    (pointers, sizes, the camera and map constants, for a bilinear frame
    with color the frame and its color-word image int32[h*w], and the
    device whose current stream it launches on)."""
    _check_inputs(state, depth, color, view, active_idx, n_active, cam)
    m = active_idx.shape[0]
    dev = depth.device
    stats = torch.empty((m, 2), dtype=torch.float32, device=dev)
    p = _build.ptr
    frame, pre_pass = _build.ptr_or_null(color), None
    if cfg.bilinear_color and color is not None:
        words = torch.empty((cam.height * cam.width,), dtype=torch.int32,
                            device=dev)
        pre_pass = (color, words)
        frame = p(words)
    args = (p(view), p(depth), frame,
            p(state.block_key), p(active_idx), p(n_active), p(state.sdf),
            p(state.weight), p(state.color), p(state.surf), p(stats), m,
            cam.width, cam.height, cam.fx, cam.fy, cam.cx, cam.cy,
            cam.depth_min, cam.depth_max - cam.depth_min, cfg.voxel_size,
            cfg.truncation, cfg.truncation_scale,
            cfg.max_integration_distance, cfg.integration_weight_sample * 1.5,
            cfg.integration_weight_max, cfg.world_blocks,
            cfg.bilinear_color, pre_pass, dev)
    return args, stats


def launch_color_words(color, words) -> None:
    """Launch the kernel that writes the color word of each pixel of
    ``color`` (f32[h,w,3], contiguous, on the card) into ``words``
    (int32[h*w]), on the current stream (the only place that does; counts
    the launch)."""
    if not (color.dtype == torch.float32 and words.dtype == torch.int32
            and color.is_contiguous() and words.is_contiguous()
            and color.numel() == 3 * words.numel()
            and color.device == words.device):
        raise ValueError("fused_integrate: the color-word image needs a "
                         "contiguous f32 [h,w,3] frame and int32 [h*w] "
                         "words on one device")
    _build.check(_build.library("fused_integrate").vh_frame_color_words(
        _build.ptr(color), _build.ptr(words), words.numel(),
        _build.stream_ptr(words.device)), "fused_integrate")
    fused_integrate.color_word_launches += 1


def launch(args) -> None:
    """Launch the kernel (its bilinear variant, after the color-word image,
    when the prepared config asks for it) on prepared arguments, on the
    current stream (the only place that does; counts the launches)."""
    *kernel_args, bilinear, pre_pass, device = args
    if pre_pass is not None:
        launch_color_words(*pre_pass)
    lib = _build.library("fused_integrate")
    fn = lib.vh_fused_integrate_bilinear if bilinear else \
        lib.vh_fused_integrate
    _build.check(fn(*kernel_args, _build.stream_ptr(device)),
                 "fused_integrate")
    if bilinear:
        fused_integrate.bilinear_launches += 1
    else:
        fused_integrate.launches += 1


def fused_integrate(state: MapState, depth, color, pose, cam: CameraConfig,
                    cfg: MapConfig, active_idx, n_active):
    """Fuse one frame into the first ``n_active`` rows of ``active_idx``.

    Pool rows and ``surf`` are updated IN PLACE. Returns
    (state, (min_abs_sdf f32[M], max_weight f32[M])), the per-row GC stats
    over the stored values; rows past ``n_active`` get (inf, 0).
    """
    if depth.device.type == "cpu":
        mask = torch.arange(active_idx.shape[0]) < n_active
        return integ.integrate(state, depth, color, pose, cam, cfg,
                               active_idx=active_idx, active_mask=mask)
    if depth.device.type != "cuda":
        raise ValueError(f"fused_integrate: no kernel for {depth.device}")
    view = geom.invert_rigid(pose.to(torch.float32))
    args, stats = prepare(state, depth.contiguous(),
                          None if color is None else color.contiguous(),
                          view, cam, cfg, active_idx, n_active)
    launch(args)
    return state, (stats[:, 0], stats[:, 1])


fused_integrate.launches = 0
fused_integrate.bilinear_launches = 0
fused_integrate.color_word_launches = 0
