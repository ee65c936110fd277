"""Per-frame reconstruction over the dense voxel grid (PyTorch port of
``voxelhashing_tpu.denseengine``).

    preprocess -> dense render -> ICP track (depth only) -> (lost? skip)
    -> dense integrate

The loop the reference's DX11 app ran before the sparse hash, with the
same preprocessing and tracker as :mod:`engine`. Runs eagerly on the
device of the state. JAX's ``lax.cond`` on ``valid`` is a decision on the
host: frame 0 (nothing to render yet) and trajectory replay read nothing
from the device; a tracked frame reads ``valid`` once, as ``engine.step``
does. On frame 0 JAX renders the empty grid and tracks before it keeps the
pose; the port skips that work, so pose and ``valid`` agree with JAX on
every frame and the other tracking fields from frame 1 on.

``step(..., mark=f)`` calls ``f(stage)`` each time a stage's work has been
issued, in the order of :data:`STAGES`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from .config import EngineConfig, resolve_device
from . import densegrid, tracking
from .densegrid import DenseGrid, DenseGridConfig
from .ops.image import preprocess
from .tracking import TrackingResult

STAGES = ("preprocess", "render", "track", "integrate")


def _no_mark(stage: str) -> None:
    pass


class DenseEngineState(NamedTuple):
    """Fields of the JAX ``DenseEngineState``, plus ``frame_host``: the
    frame counter kept on the host beside the device one."""

    grid: DenseGrid
    pose: torch.Tensor           # f32[4,4] current camera-to-world
    frame: torch.Tensor          # int32[] frame counter
    tracking_lost: torch.Tensor  # bool[] last frame's tracking status
    frame_host: int = 0


def create(grid_cfg: DenseGridConfig, initial_pose=None, device="cuda"
           ) -> DenseEngineState:
    """Fresh dense engine state on ``device`` (the card unless the caller
    asks for the CPU)."""
    device = resolve_device(device)
    pose = torch.eye(4, dtype=torch.float32, device=device) \
        if initial_pose is None else torch.as_tensor(
            initial_pose, dtype=torch.float32, device=device)
    return DenseEngineState(
        grid=densegrid.create(grid_cfg, device),
        pose=pose,
        frame=torch.zeros((), dtype=torch.int32, device=device),
        tracking_lost=torch.zeros((), dtype=torch.bool, device=device),
        frame_host=0)


def step(state: DenseEngineState, depth_raw, color_raw, cfg: EngineConfig,
         grid_cfg: DenseGridConfig, pose_hint=None, mark=_no_mark,
         in_place: bool = False) -> Tuple[DenseEngineState, TrackingResult]:
    """One frame: preprocess -> dense render -> ICP -> dense integrate
    (tensors on the state's device). With ``cfg.use_trajectory`` the hint
    is the pose. ``in_place``: fuse into the state's grid tensors (see
    :func:`make_step`)."""
    cam = cfg.camera
    dev = state.pose.device
    frame = preprocess(depth_raw, color_raw, cam, cfg.filter)
    mark("preprocess")
    is_first = state.frame_host == 0
    replay = cfg.use_trajectory and pose_hint is not None

    if replay or is_first:
        # trajectory replay, or frame 0 (no model yet): keep the pose
        zstats, zcurve = tracking.empty_stats(cfg.tracker, dev)
        zero_f = torch.zeros((), dtype=torch.float32, device=dev)
        tr = TrackingResult(
            pose=(torch.as_tensor(pose_hint, dtype=torch.float32, device=dev)
                  if replay else state.pose),
            valid=torch.ones((), dtype=torch.bool, device=dev),
            residual=zero_f,
            corr_count=torch.zeros((), dtype=torch.int32, device=dev),
            condition=zero_f, level_stats=zstats, iter_residuals=zcurve,
            planarity=zero_f if replay else tracking.planarity_probe(
                frame.points, frame.normals, cfg.tracker))
        mark("render")
        integrate_now = True
    else:
        model = densegrid.render(state.grid, grid_cfg, state.pose, cam,
                                 num_samples=cfg.raycast.num_samples)
        mark("render")
        tr = tracking.track(frame.points, frame.normals, model.points,
                            model.normals, state.pose, cam, cfg.tracker)
        integrate_now = bool(tr.valid)
    mark("track")

    grid = state.grid
    if integrate_now:
        grid = densegrid.integrate(grid, grid_cfg, frame.depth, frame.color,
                                   tr.pose, cam, in_place=in_place)
    mark("integrate")
    return DenseEngineState(grid=grid, pose=tr.pose, frame=state.frame + 1,
                            tracking_lost=~tr.valid,
                            frame_host=state.frame_host + 1), tr


@functools.lru_cache(maxsize=4)
def make_step(cfg: EngineConfig, grid_cfg: DenseGridConfig,
              with_hint: bool = False, donate: bool = True):
    """The dense step with its configs bound: ``fn(state, depth, color[,
    hint], mark=...)``. ``donate=True`` fuses into the given state's grid
    tensors in place (that state must not be read again, as after JAX's
    donation); ``donate=False`` leaves every tensor of it unchanged."""
    if with_hint:
        def fn(state, depth, color, hint, mark=_no_mark):
            return step(state, depth, color, cfg, grid_cfg, pose_hint=hint,
                        mark=mark, in_place=donate)
    else:
        def fn(state, depth, color, mark=_no_mark):
            return step(state, depth, color, cfg, grid_cfg, mark=mark,
                        in_place=donate)
    return fn
