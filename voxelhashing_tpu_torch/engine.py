"""The per-frame reconstruction engine (PyTorch port of
``voxelhashing_tpu.engine``).

    preprocess -> compactify -> render (splat or march) -> ICP track
    (depth only, or RGB-D) -> (lost? skip) -> DDA alloc -> fused integrate
    -> garbage collect -> maintain

Runs eagerly on the device of the state. Branches that JAX takes with
``lax.cond`` on device values are decided here from the host frame counter
(first frame, starvation cadence, alloc tile phase) or run masked (the GC
free pass, the tracker's converged levels); only two read the device, one
scalar each: ``tracking.valid`` (integrate or skip) and
``blockmap.maybe_maintain``'s ``need``.

``step(..., mark=f)`` calls ``f(stage)`` each time a stage's work has been
issued, in the order of :data:`STAGES`; ``chip_smoke.py`` records a CUDA
event there to time the stages.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .config import EngineConfig, resolve_device
from . import blockmap, geometry as geom, integrate as integ, raycast, tracking
from . import streaming
from .blockmap import MapState
from .ops.fused_integrate import fused_integrate
from .ops.image import FrameInputs, color_to_intensity, preprocess
from .raycast import RaycastResult
from .tracking import TrackingResult

STAGES = ("preprocess", "compactify", "render", "track", "alloc",
          "integrate", "gc", "maintain")


def _no_mark(stage: str) -> None:
    pass


class EngineState(NamedTuple):
    """Fields of the JAX ``EngineState``, plus ``frame_host``: the frame
    counter kept on the host beside the device one, so per-frame decisions
    need no device read."""

    map: MapState
    pose: torch.Tensor           # f32[4,4] current camera-to-world
    frame: torch.Tensor          # int32[] frame counter
    tracking_lost: torch.Tensor  # bool[] last frame's tracking status
    n_integrated: torch.Tensor   # int32[] frames actually integrated
    frame_host: int = 0


class FrameDiagnostics(NamedTuple):
    """Per-frame numbers, kept on the device until the host asks."""

    n_allocated_blocks: torch.Tensor   # int32[]
    n_active_blocks: torch.Tensor      # int32[]
    active_overflow: torch.Tensor      # int32[]
    splat_overflow: torch.Tensor       # int32[]
    alloc_missed: torch.Tensor         # int32[]
    icp_residual: torch.Tensor         # f32[]
    icp_corr_count: torch.Tensor       # int32[]
    icp_condition: torch.Tensor        # f32[]
    icp_level_stats: torch.Tensor      # f32[levels,4]
    icp_iter_residuals: torch.Tensor   # f32[levels,max_iters]
    tracking_valid: torch.Tensor       # bool[]
    icp_planarity: torch.Tensor        # f32[]


def create(cfg: EngineConfig, initial_pose=None, device="cuda"
           ) -> EngineState:
    """Fresh engine state on ``device`` (the card unless the caller asks
    for the CPU; see ``config.resolve_device``)."""
    device = resolve_device(device)
    pose = torch.eye(4, dtype=torch.float32, device=device) \
        if initial_pose is None else torch.as_tensor(
            initial_pose, dtype=torch.float32, device=device)
    return EngineState(
        map=blockmap.create(cfg.map, device),
        pose=pose,
        frame=torch.zeros((), dtype=torch.int32, device=device),
        tracking_lost=torch.zeros((), dtype=torch.bool, device=device),
        n_integrated=torch.zeros((), dtype=torch.int32, device=device),
        frame_host=0,
    )


def _integrate_frame(state: MapState, frame: FrameInputs, pose,
                     cfg: EngineConfig, frame_idx: int, stream_bitmask=None,
                     reuse_active=None, model_depth=None, mark=_no_mark,
                     key_filter=None):
    """alloc -> compactify (or reuse) -> fused integrate -> gc -> maintain.

    ``key_filter``: a mask over the allocation candidates (the multi-device
    step keeps the keys its rank owns, ``parallel/sharded.py``; it passes
    its shard's capacity as ``cfg.map``).

    ``stream_bitmask``: the streaming eviction bitmask; candidates in
    evicted chunks are dropped (a gather and a mask, no host sync).

    ``reuse_active``: ``(active_idx, n_active, overflow)`` from the
    raycast-pose compactify (online); this frame's new pool slots (the free
    stack's popped window) are appended instead of a second compactify.
    Offline replay runs the alloc fixpoint rounds and the exact compactify
    at the new pose.
    """
    cam = cfg.camera
    mp = cfg.map
    dev = frame.depth.device
    keys = integ.alloc_candidates(
        frame.depth, pose, cam, mp,
        tile=1 if cfg.offline else mp.alloc_tile,
        phase=None if cfg.offline else frame_idx,
        model_depth=(model_depth
                     if (not cfg.offline and mp.alloc_novelty) else None))
    if key_filter is not None:
        keys = key_filter(keys)
    if stream_bitmask is not None:
        keys = streaming.mask_keys(keys, stream_bitmask, mp, cfg.streaming)
    rounds = mp.alloc_rounds_offline if cfg.offline else 1
    n_free_before = state.n_free
    state, _ = blockmap.allocate(state, keys, mp, rounds=rounds)
    if cfg.offline:
        _, found = blockmap.lookup(state, keys, mp)
        alloc_missed = blockmap._isum((keys != geom.INVALID_KEY) & ~found)
    else:
        alloc_missed = torch.zeros((), dtype=torch.int32, device=dev)
    if reuse_active is not None:
        active_idx, n_active, overflow = reuse_active
        cap_a = active_idx.shape[0]
        n_new = n_free_before - state.n_free
        j = torch.arange(rounds * mp.alloc_insert_cap, dtype=torch.int32,
                         device=dev)
        slots_new = state.free_stack[torch.clamp(
            state.n_free + j, 0, mp.num_blocks - 1).long()]
        pos = n_active + j
        put = (j < n_new) & (pos < cap_a)
        active_idx = blockmap.put(active_idx, pos, slots_new, put)
        overflow = overflow + torch.clamp(n_active + n_new - cap_a, min=0)
        n_active = torch.clamp(n_active + n_new, max=cap_a)
    else:
        view = geom.invert_rigid(pose)
        active_idx, n_active, overflow = blockmap.compactify(state, view,
                                                             cam, mp)
    active_mask = torch.arange(active_idx.shape[0], device=dev) < n_active
    mark("alloc")
    state, gc_stats = fused_integrate(state, frame.depth, frame.color, pose,
                                      cam, mp, active_idx, n_active)
    mark("integrate")
    if mp.gc_enabled:
        # starve every gc_starve_interval frames (then the rows changed and
        # GC re-reads them); otherwise GC uses the kernel's stats
        if frame_idx > 0 and frame_idx % mp.gc_starve_interval == 0:
            state = integ.starve(state, active_idx, active_mask)
            state = integ.garbage_collect(state, active_idx, active_mask, mp)
        else:
            state = integ.garbage_collect(state, active_idx, active_mask, mp,
                                          cached_stats=gc_stats)
    mark("gc")
    state = blockmap.maybe_maintain(state, mp, frame_idx)
    mark("maintain")
    return state, active_idx, active_mask, n_active, overflow, alloc_missed


def step(state: EngineState, depth_raw, color_raw, cfg: EngineConfig,
         pose_hint=None, mark=_no_mark, stream_bitmask=None
         ) -> Tuple[EngineState, FrameDiagnostics]:
    """Process one RGB-D frame (tensors on the state's device).

    ``pose_hint``: optional external pose. With ``cfg.use_trajectory`` the
    hint is the pose; with ``use_trajectory_only_init`` it seeds ICP and
    the model render. ``stream_bitmask``: the streaming manager's
    eviction bitmask (``streaming.StreamingManager.bitmask``), which keeps
    allocation out of evicted chunks. ``mark``: called with each stage's name when its
    work has been issued (see :data:`STAGES`).
    """
    cam = cfg.camera
    dev = state.pose.device
    frame = preprocess(depth_raw, color_raw, cam, cfg.filter)
    mark("preprocess")
    is_first = state.frame_host == 0
    hint = None if pose_hint is None else torch.as_tensor(
        pose_hint, dtype=torch.float32, device=dev)

    raycast_pose = state.pose
    if cfg.use_trajectory_only_init and hint is not None:
        raycast_pose = hint
    view = geom.invert_rigid(raycast_pose)
    active_idx, n_active, overflow0 = blockmap.compactify(state.map, view,
                                                          cam, cfg.map)
    active_mask = torch.arange(active_idx.shape[0], device=dev) < n_active
    mark("compactify")
    # RGB-D tracking reads the model's intensity: render with color
    use_rgbd = cfg.tracker.use_rgbd and not cfg.use_trajectory
    model = raycast.render(state.map, raycast_pose, cam, cfg.map,
                           cfg.raycast, active_idx=active_idx,
                           active_mask=active_mask, with_color=use_rgbd)
    mark("render")
    rgbd_now = use_rgbd and frame.intensity is not None

    zstats, zcurve = tracking.empty_stats(cfg.tracker, dev)
    zero_f = torch.zeros((), dtype=torch.float32, device=dev)
    if (cfg.use_trajectory and hint is not None) or is_first:
        # trajectory replay, or frame 0 (no model yet): keep the pose
        replay = cfg.use_trajectory and hint is not None
        tr = TrackingResult(pose=hint if replay else state.pose,
                            valid=torch.ones((), dtype=torch.bool,
                                             device=dev),
                            residual=zero_f,
                            corr_count=torch.zeros((), dtype=torch.int32,
                                                   device=dev),
                            condition=zero_f, level_stats=zstats,
                            iter_residuals=zcurve,
                            planarity=zero_f if replay or rgbd_now else
                            tracking.planarity_probe(frame.points,
                                                     frame.normals,
                                                     cfg.tracker))
    else:
        last_pose = state.pose
        if cfg.use_trajectory_only_init and hint is not None:
            last_pose = hint
        rgbd = {}
        if rgbd_now:
            rgbd = dict(input_intensity=frame.intensity,
                        model_intensity=torch.where(
                            torch.isfinite(model.depth),
                            color_to_intensity(model.color), torch.nan),
                        weight_depth=cfg.tracker.weight_depth,
                        weight_color=cfg.tracker.weight_color,
                        color_sigma=cfg.tracker.color_sigma)
        tr = tracking.track(frame.points, frame.normals, model.points,
                            model.normals, last_pose, cam, cfg.tracker,
                            **rgbd)

    reuse = None if cfg.offline else (active_idx, n_active, overflow0)
    integrate_now = is_first or bool(tr.valid)
    mark("track")
    if integrate_now:
        new_map, _, _, n_act, overflow, alloc_missed = _integrate_frame(
            state.map, frame, tr.pose, cfg, state.frame_host,
            stream_bitmask=stream_bitmask, reuse_active=reuse,
            model_depth=model.depth, mark=mark)
    else:
        new_map = state.map
        n_act = overflow = alloc_missed = torch.zeros(
            (), dtype=torch.int32, device=dev)

    diag = FrameDiagnostics(
        n_allocated_blocks=cfg.map.num_blocks - new_map.n_free,
        n_active_blocks=n_act,
        active_overflow=overflow,
        splat_overflow=model.splat_overflow,
        alloc_missed=alloc_missed,
        icp_residual=tr.residual,
        icp_corr_count=tr.corr_count,
        icp_condition=tr.condition,
        icp_level_stats=tr.level_stats,
        icp_iter_residuals=tr.iter_residuals,
        tracking_valid=tr.valid,
        icp_planarity=tr.planarity,
    )
    new_state = EngineState(
        map=new_map,
        pose=tr.pose,
        frame=state.frame + 1,
        tracking_lost=~tr.valid,
        n_integrated=state.n_integrated + tr.valid.to(torch.int32),
        frame_host=state.frame_host + 1,
    )
    return new_state, diag


def render_view(state: EngineState, cfg: EngineConfig, pose=None
                ) -> RaycastResult:
    """Standalone render (with color) of the current map from ``pose``
    (default: the current pose), in ``cfg.raycast.mode``."""
    pose = state.pose if pose is None else torch.as_tensor(
        pose, dtype=torch.float32, device=state.pose.device)
    view = geom.invert_rigid(pose)
    active_idx, n_active, _ = blockmap.compactify(state.map, view,
                                                  cfg.camera, cfg.map)
    active_mask = torch.arange(active_idx.shape[0],
                               device=active_idx.device) < n_active
    return raycast.render(state.map, pose, cfg.camera, cfg.map, cfg.raycast,
                          active_idx=active_idx, active_mask=active_mask)
