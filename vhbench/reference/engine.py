"""One frame of the reference: a frozen copy of the eager step of
``voxelhashing_tpu_torch.engine`` (preprocess -> compactify -> render ->
ICP track -> (lost? skip) -> DDA alloc -> fusion -> GC -> maintain) for
the single-device, online configurations the benchmark runs, on the plain
versions of every stage.

:func:`step` can follow a run of the program frame by frame: given the
program's pose (``pose=``), the frame fuses at that pose, so the map it
leaves is what the map stages alone make of that pose. ``rnd`` is applied
to the float32 values handed from one stage to the next and to the
fusion's own (``fuse_rnd``, where given, to the fusion's own instead); the
control passes a rounding to bfloat16 (:func:`to_bf16`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .config import EngineConfig
from . import blockmap, geometry as geom, integrate as integ, raycast, tracking
from . import streaming
from .blockmap import MapState
from .ops.image import FrameInputs, color_to_intensity, preprocess


def same(x):
    return x


def to_bf16(x):
    """The control's rounding: a float32 tensor rounded to bfloat16 and
    back (other dtypes unchanged)."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.to(torch.bfloat16).to(torch.float32)
    return x


class Frame(NamedTuple):
    """What the reference makes of one frame."""

    map: MapState
    pose: torch.Tensor          # f32[4,4] its own tracked pose
    valid: bool                 # its own tracker's verdict
    n_active: int               # rows the fusion updated


def create(cfg: EngineConfig, device) -> MapState:
    """A fresh empty map on ``device``."""
    return blockmap.create(cfg.map, device)


def _front(state: MapState, last_pose, frame: FrameInputs,
           cfg: EngineConfig, first: bool, rnd):
    """compactify -> render -> track from ``last_pose`` (frame 0 keeps
    it). Returns (pose, valid, (active_idx, n_active, overflow), model
    depth)."""
    cam = cfg.camera
    dev = last_pose.device
    view = geom.invert_rigid(last_pose)
    active_idx, n_active, overflow = blockmap.compactify(state, view, cam,
                                                         cfg.map)
    active_mask = torch.arange(active_idx.shape[0], device=dev) < n_active
    use_rgbd = cfg.tracker.use_rgbd
    model = raycast.render(state, last_pose, cam, cfg.map, cfg.raycast,
                           active_idx=active_idx, active_mask=active_mask,
                           with_color=use_rgbd)
    reuse = (active_idx, n_active, overflow)
    if first:
        return last_pose, True, reuse, model.depth
    rgbd = {}
    if use_rgbd and frame.intensity is not None:
        rgbd = dict(input_intensity=frame.intensity,
                    model_intensity=rnd(torch.where(
                        torch.isfinite(model.depth),
                        color_to_intensity(model.color), torch.nan)),
                    weight_depth=cfg.tracker.weight_depth,
                    weight_color=cfg.tracker.weight_color,
                    color_sigma=cfg.tracker.color_sigma)
    tr = tracking.track(frame.points, frame.normals, rnd(model.points),
                        rnd(model.normals), last_pose, cam, cfg.tracker,
                        **rgbd)
    return tr.pose, bool(tr.valid), reuse, model.depth


def _back(state: MapState, frame: FrameInputs, pose, cfg: EngineConfig,
          frame_idx: int, reuse, model_depth, rnd, fuse_rnd,
          stream_bitmask=None) -> tuple:
    """alloc (candidates in chunks marked in ``stream_bitmask`` dropped)
    -> the active list with this frame's new rows -> fusion -> GC
    (starving every ``gc_starve_interval`` frames) -> maintain."""
    cam, mp = cfg.camera, cfg.map
    dev = frame.depth.device
    keys = integ.alloc_candidates(
        frame.depth, pose, cam, mp, tile=mp.alloc_tile, phase=frame_idx,
        model_depth=model_depth if mp.alloc_novelty else None)
    if stream_bitmask is not None:
        keys = streaming.mask_keys(keys, stream_bitmask, mp, cfg.streaming)
    n_free_before = state.n_free
    state, _ = blockmap.allocate(state, keys, mp, rounds=1)
    active_idx, n_active, _ = reuse
    cap_a = active_idx.shape[0]
    n_new = n_free_before - state.n_free
    j = torch.arange(mp.alloc_insert_cap, dtype=torch.int32, device=dev)
    slots_new = state.free_stack[torch.clamp(
        state.n_free + j, 0, mp.num_blocks - 1).long()]
    pos = n_active + j
    put = (j < n_new) & (pos < cap_a)
    active_idx = blockmap.put(active_idx, pos, slots_new, put)
    n_active = torch.clamp(n_active + n_new, max=cap_a)
    active_mask = torch.arange(cap_a, device=dev) < n_active
    state, gc_stats = integ.integrate(state, frame.depth, frame.color, pose,
                                      cam, mp, active_idx=active_idx,
                                      active_mask=active_mask,
                                      rnd=fuse_rnd)
    if mp.gc_enabled:
        starve = frame_idx > 0 and frame_idx % mp.gc_starve_interval == 0
        if starve:
            state = integ.starve(state, active_idx, active_mask)
            state = integ.garbage_collect(state, active_idx, active_mask, mp)
        else:
            state = integ.garbage_collect(state, active_idx, active_mask, mp,
                                          cached_stats=gc_stats)
    if blockmap.need_maintain(blockmap.maintain_flags(state, mp), mp,
                              frame_idx):
        state = blockmap.compact_pool(state, mp)
    return state, int(n_active)


def step(state: MapState, last_pose, depth_raw, color_raw,
         cfg: EngineConfig, frame_idx: int, pose=None,
         integrate: Optional[bool] = None, rnd=same,
         fuse_rnd=None, stream_bitmask=None) -> Frame:
    """Frame ``frame_idx`` (the host frame counter) on ``state`` (updated
    in place) from the previous pose ``last_pose``. ``pose``: fuse at this
    pose (the program's), else at the reference's own; ``integrate``:
    whether the frame is fused (the program's verdict), else the
    reference's own tracker decides; ``stream_bitmask``: the streaming
    bitmask the allocation honours (``streaming.mask_keys``), or None."""
    if cfg.offline or cfg.use_trajectory or cfg.map.bilinear_color:
        raise NotImplementedError("the reference runs the online, tracked, "
                                  "nearest-color step only")
    frame = preprocess(depth_raw, color_raw, cfg.camera, cfg.filter)
    frame = FrameInputs(*(rnd(getattr(frame, k)) for k in FrameInputs.__slots__))
    first = frame_idx == 0
    own_pose, valid, reuse, model_depth = _front(state, last_pose, frame,
                                                 cfg, first, rnd)
    fuse = valid if integrate is None else integrate
    n_active = 0
    if fuse:
        state, n_active = _back(state, frame, own_pose if pose is None
                                else pose, cfg, frame_idx, reuse,
                                rnd(model_depth), rnd,
                                rnd if fuse_rnd is None else fuse_rnd,
                                stream_bitmask)
    return Frame(state, own_pose, valid, n_active)
