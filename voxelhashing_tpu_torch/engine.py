"""The per-frame reconstruction engine (PyTorch port of
``voxelhashing_tpu.engine``).

    preprocess -> compactify -> render (splat or march) -> ICP track
    (depth only, or RGB-D) -> (lost? skip) -> DDA alloc -> fused integrate
    -> garbage collect -> maintain

The frame is two segments: :func:`_front` (preprocess to track; reads
the map, writes nothing; its compactify and render, :func:`_view`, read
no input of the frame) and :func:`_back` (alloc to GC, and the maintain
flags; updates the map). Branches that JAX takes with ``lax.cond`` on
device values are decided from the host frame counter (first frame,
starvation cadence) or run masked (the GC free pass, the tracker's
converged levels); only two read the device, one each: ``tracking.valid``
(integrate or skip; not read under trajectory replay, where it is the
constant True) and the two maintain flags (``blockmap.need_maintain``).

:func:`step` runs the segments eagerly. :func:`make_step` is the
counterpart of JAX's jit-compiled, donating step: on a CUDA state each
frame after the first is a replay of CUDA graphs captured from the same
segment functions (the counterpart of "one device program per frame"),
with those two reads between them, the view half first so that the host
stages the frame's inputs while it runs; on a CPU state it runs the same
functions eagerly.

``step(..., mark=f)`` calls ``f(stage)`` each time a stage's work has been
issued, in the order of :data:`STAGES`; ``chip_smoke.py`` records a CUDA
event there to time the stages. ``step(..., tally=f)`` hands ``f(name,
value)`` the frame's counters (``diagnostics.TRACE_COUNTERS``) as device
scalars. :func:`make_step`'s step with a ``trace``
(``diagnostics.StepTracer``) takes both into traced variants of its graphs
and times its host work in spans.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config import EngineConfig, resolve_device
from . import blockmap, geometry as geom, integrate as integ, raycast, tracking
from . import streaming
from .blockmap import MapState
from .ops import _build, hash_table, raymarch
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




class Front(NamedTuple):
    """What the front segment hands to the back one."""

    frame: FrameInputs              # the preprocessed frame
    tr: TrackingResult
    model_depth: torch.Tensor       # f32[h,w] the model render's depth
    splat_overflow: torch.Tensor    # int32[]
    reuse: Optional[tuple]          # (active_idx, n_active, overflow)


class Back(NamedTuple):
    """What the back segment returns."""

    map: MapState
    n_active: torch.Tensor          # int32[]
    overflow: torch.Tensor          # int32[]
    alloc_missed: torch.Tensor      # int32[]
    flags: torch.Tensor             # bool[2] blockmap.maintain_flags


def _is_starve(mp, frame_idx: int) -> bool:
    """Whether GC starves the weights at host frame ``frame_idx``."""
    return (mp.gc_enabled and frame_idx > 0
            and frame_idx % mp.gc_starve_interval == 0)


class View(NamedTuple):
    """The front's view half (:func:`_view`): what the map shows from the
    raycast pose."""

    active_idx: torch.Tensor        # int32[cap] the active rows
    n_active: torch.Tensor          # int32[]
    overflow: torch.Tensor          # int32[] rows in view past the cap
    model: RaycastResult            # the model render


def _view(state: EngineState, cfg: EngineConfig, hint=None,
          mark=_no_mark) -> View:
    """compactify -> render at the raycast pose (the last pose, or the
    hint under ``use_trajectory_only_init``): reads the map and the pose,
    no input of the frame."""
    cam = cfg.camera
    dev = state.pose.device
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
    return View(active_idx, n_active, overflow0, model)


def _front(state: EngineState, depth_raw, color_raw, cfg: EngineConfig,
           hint=None, first: bool = False, mark=_no_mark,
           tally=None, view: Optional[View] = None) -> Front:
    """preprocess -> compactify -> render -> track, with no host read and
    no write to the map. ``hint``: the pose hint (a device tensor) or None;
    ``first``: frame 0 (no model yet: the pose is kept). ``tally``: given
    the ICP iterations whose residual the tracker kept, of those launched
    (one past its level's early-out, or skipped, leaves it NaN). ``view``:
    the view half when it already ran (:func:`_view`, which reads no
    input), else it runs after the preprocess."""
    cam = cfg.camera
    dev = state.pose.device
    frame = preprocess(depth_raw, color_raw, cam, cfg.filter)
    mark("preprocess")
    if view is None:
        view = _view(state, cfg, hint, mark)
    model = view.model
    use_rgbd = cfg.tracker.use_rgbd and not cfg.use_trajectory
    rgbd_now = use_rgbd and frame.intensity is not None

    replay = cfg.use_trajectory and hint is not None
    if replay or first:
        # trajectory replay, or frame 0 (no model yet): keep the pose
        zstats, zcurve = tracking.empty_stats(cfg.tracker, dev)
        zero_f = torch.zeros((), dtype=torch.float32, device=dev)
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
    if tally is not None:
        tally("icp_live_iters", torch.sum(~torch.isnan(tr.iter_residuals)))
    reuse = None if cfg.offline else (view.active_idx, view.n_active,
                                      view.overflow)
    return Front(frame=frame, tr=tr, model_depth=model.depth,
                 splat_overflow=model.splat_overflow, reuse=reuse)


def _back(state: MapState, frame: FrameInputs, pose, cfg: EngineConfig,
          phase, starve: bool, stream_bitmask=None, reuse_active=None,
          model_depth=None, mark=_no_mark, key_filter=None,
          tally=None) -> Back:
    """alloc -> compactify (or reuse) -> fused integrate -> gc, then the
    maintain flags; no host read (the pool rows are updated in place).

    ``phase``: the alloc tile phase, the frame counter (a host int, or a
    device int32 scalar). ``starve``: this frame starves the weights
    before GC (:func:`_is_starve`).

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

    ``tally``: given the blocks the alloc inserted and those GC freed.
    """
    cam = cfg.camera
    mp = cfg.map
    dev = frame.depth.device
    keys = integ.alloc_candidates(
        frame.depth, pose, cam, mp,
        tile=1 if cfg.offline else mp.alloc_tile,
        phase=None if cfg.offline else phase,
        model_depth=(model_depth
                     if (not cfg.offline and mp.alloc_novelty) else None))
    if key_filter is not None:
        keys = key_filter(keys)
    if stream_bitmask is not None:
        keys = streaming.mask_keys(keys, stream_bitmask, mp, cfg.streaming)
    rounds = mp.alloc_rounds_offline if cfg.offline else 1
    n_free_before = state.n_free
    state, _ = blockmap.allocate(state, keys, mp, rounds=rounds)
    if tally is not None:
        n_free_alloc = state.n_free
        tally("blocks_inserted", n_free_before - n_free_alloc)
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
        if starve:
            state = integ.starve(state, active_idx, active_mask)
            state = integ.garbage_collect(state, active_idx, active_mask, mp)
        else:
            state = integ.garbage_collect(state, active_idx, active_mask, mp,
                                          cached_stats=gc_stats)
    if tally is not None:
        tally("blocks_freed", state.n_free - n_free_alloc)
    mark("gc")
    return Back(map=state, n_active=n_active, overflow=overflow,
                alloc_missed=alloc_missed,
                flags=blockmap.maintain_flags(state, mp))


def _integrate_frame(state: MapState, frame: FrameInputs, pose,
                     cfg: EngineConfig, frame_idx: int, stream_bitmask=None,
                     reuse_active=None, model_depth=None, mark=_no_mark,
                     key_filter=None, tally=None):
    """:func:`_back` at host frame ``frame_idx``, then the maintain
    decision (one host read) and, when needed, ``compact_pool``. Returns
    (map, n_active, overflow, alloc_missed)."""
    back = _back(state, frame, pose, cfg, frame_idx,
                 _is_starve(cfg.map, frame_idx),
                 stream_bitmask=stream_bitmask, reuse_active=reuse_active,
                 model_depth=model_depth, mark=mark, key_filter=key_filter,
                 tally=tally)
    state = back.map
    if blockmap.need_maintain(back.flags, cfg.map, frame_idx):
        state = blockmap.compact_pool(state, cfg.map)
    mark("maintain")
    return state, back.n_active, back.overflow, back.alloc_missed


def _front_diagnostics(front: Front) -> dict:
    """The diagnostics' fields the front segment gives."""
    tr = front.tr
    return dict(splat_overflow=front.splat_overflow,
                icp_residual=tr.residual,
                icp_corr_count=tr.corr_count,
                icp_condition=tr.condition,
                icp_level_stats=tr.level_stats,
                icp_iter_residuals=tr.iter_residuals,
                tracking_valid=tr.valid,
                icp_planarity=tr.planarity)


def _back_diagnostics(cfg: EngineConfig, back: Optional[Back],
                      map_state: MapState) -> dict:
    """The diagnostics' fields of the back segment and the map;
    ``back`` None: the frame was not integrated."""
    if back is None:
        n_act = overflow = alloc_missed = torch.zeros(
            (), dtype=torch.int32, device=map_state.n_free.device)
    else:
        n_act, overflow, alloc_missed = (back.n_active, back.overflow,
                                         back.alloc_missed)
    return dict(n_allocated_blocks=cfg.map.num_blocks - map_state.n_free,
                n_active_blocks=n_act, active_overflow=overflow,
                alloc_missed=alloc_missed)


def _diagnostics(cfg: EngineConfig, front: Front, back: Optional[Back],
                 map_state: MapState) -> FrameDiagnostics:
    """The frame's diagnostics; ``back`` None: the frame was not
    integrated."""
    return FrameDiagnostics(**_front_diagnostics(front),
                            **_back_diagnostics(cfg, back, map_state))


def _copied(fields: dict) -> dict:
    """Copies of the tensors ``fields`` in one launch: their bytes
    concatenated (the widest elements first, so that each field's offset
    is a multiple of its element size), each viewed back as its field."""
    order = sorted(fields, key=lambda k: -fields[k].element_size())
    flat = [fields[k].reshape(-1).view(torch.uint8) for k in order]
    packed = torch.cat(flat)
    out, at = {}, 0
    for k, f in zip(order, flat):
        t = fields[k]
        out[k] = packed[at:at + f.numel()].view(t.dtype).reshape(t.shape)
        at += f.numel()
    return out


def step(state: EngineState, depth_raw, color_raw, cfg: EngineConfig,
         pose_hint=None, mark=_no_mark, stream_bitmask=None, tally=None
         ) -> Tuple[EngineState, FrameDiagnostics]:
    """Process one RGB-D frame (tensors on the state's device), eagerly.

    ``pose_hint``: optional external pose. With ``cfg.use_trajectory`` the
    hint is the pose; with ``use_trajectory_only_init`` it seeds ICP and
    the model render. ``stream_bitmask``: the streaming manager's
    eviction bitmask (``streaming.StreamingManager.bitmask``), which keeps
    allocation out of evicted chunks. ``mark``: called with each stage's name when its
    work has been issued (see :data:`STAGES`). ``tally``: called with each of
    the frame's counters (see the module docstring).
    """
    dev = state.pose.device
    is_first = state.frame_host == 0
    hint = None if pose_hint is None else torch.as_tensor(
        pose_hint, dtype=torch.float32, device=dev)
    front = _front(state, depth_raw, color_raw, cfg, hint, first=is_first,
                   mark=mark, tally=tally)
    tr = front.tr
    replay = cfg.use_trajectory and hint is not None
    integrate_now = is_first or replay or bool(tr.valid)
    mark("track")
    if integrate_now:
        new_map, n_act, overflow, alloc_missed = _integrate_frame(
            state.map, front.frame, tr.pose, cfg, state.frame_host,
            stream_bitmask=stream_bitmask, reuse_active=front.reuse,
            model_depth=front.model_depth, mark=mark, tally=tally)
        back = Back(map=new_map, n_active=n_act, overflow=overflow,
                    alloc_missed=alloc_missed, flags=None)
    else:
        new_map, back = state.map, None

    diag = _diagnostics(cfg, front, back, new_map)
    new_state = EngineState(
        map=new_map,
        pose=tr.pose,
        frame=state.frame + 1,
        tracking_lost=~tr.valid,
        n_integrated=state.n_integrated + tr.valid.to(torch.int32),
        frame_host=state.frame_host + 1,
    )
    return new_state, diag


# ---------------------------------------------------------------------------
# make_step: the step as replays of captured CUDA graphs
# ---------------------------------------------------------------------------

_POOL_FIELDS = ("sdf", "weight", "color")


def graph_keys(cfg: EngineConfig, frame_idx: int, replay: bool):
    """The segments :func:`make_step` runs at host frame ``frame_idx``, in
    order: ``("eager",)`` for frame 0 (the one frame with no model, and
    the back segment's warm-up); under trajectory replay (``valid`` is
    then the constant True) one graph, ``"fused"``; else ``"view"`` (the
    front's compactify and render, :func:`_view`), ``"front"`` (its
    preprocess and track) and, when the frame tracked, ``"back"``. A
    starve frame's back half is a graph of its own (``"_starve"``)."""
    if frame_idx == 0:
        return ("eager",)
    tail = "_starve" if _is_starve(cfg.map, frame_idx) else ""
    return ("fused" + tail,) if replay else ("view", "front", "back" + tail)


def _launch_counters():
    """(owner, attribute) of every kernel launch count."""
    from .ops import fused_integrate as fa, icp_update as iu, solve6 as s6
    from .ops import icp_linearize as il, splat_zbuf as sb
    from .ops import alloc_candidates as ac, preprocess as pp
    from .ops import hash_table as ht, raymarch as rm, stream as st
    return ((pp.preprocess_depth, "launches"),
            (ac.alloc_candidates, "launches"),
            (ht.allocate, "launches"),
            (ht.delete_blocks, "launches"),
            (ht.garbage_collect, "launches"),
            (fa.fused_integrate, "launches"),
            (fa.fused_integrate, "bilinear_launches"),
            (fa.fused_integrate, "color_word_launches"),
            (sb.splat_zbuf, "launches"),
            (sb.splat_zbuf_color, "launches"),
            (rm.ray_bounds, "launches"),
            (rm.march, "launches"),
            (iu.icp_update, "launches"),
            (il.associate, "launches"),
            (il.linearize, "launches"),
            (il.linearize, "color_launches"),
            (il.associate_linearize, "launches"),
            (il.associate_linearize, "color_launches"),
            (s6.solve6, "launches"),
            (st.sweep, "launches"),
            (st.extract, "launches"),
            (st.bits, "launches"))


class CountedGraph:
    """A captured graph, its outputs, and the kernel launches its capture
    counted (``counts``: {(owner, attribute): n}). A capture launches
    nothing, so :func:`capture` takes back the counts the wrappers added
    while capturing; every :meth:`replay` adds them."""

    def __init__(self, graph, counts, out):
        self.graph, self.counts, self.out = graph, counts, out
        self.nodes = None
        self.capture_ms = None

    def replay(self) -> None:
        self.graph.replay()
        for (owner, attr), n in self.counts.items():
            setattr(owner, attr, getattr(owner, attr) + n)


@contextlib.contextmanager
def _taken_back(counters, counts: dict):
    """Inside the block the wrappers' launch counts may rise; at its end
    they are set back, and what they rose by goes into ``counts``."""
    before = [getattr(owner, attr) for owner, attr in counters]
    try:
        yield
    finally:
        for (owner, attr), b in zip(counters, before):
            n = getattr(owner, attr) - b
            setattr(owner, attr, b)
            if n:
                counts[(owner, attr)] = n


def capture(fn, graph, context, counters=None) -> CountedGraph:
    """Run ``fn`` inside ``context`` (a capture of ``graph``) and return
    the :class:`CountedGraph` with its outputs and launch counts."""
    counts = {}
    with _taken_back(_launch_counters() if counters is None else counters,
                     counts), context:
        out = fn()
    return CountedGraph(graph, counts, out)


def _graph_nodes(graph) -> Optional[int]:
    """The nodes of a captured ``torch.cuda.CUDAGraph(keep_graph=True)``
    (``cuGraphGetNodes`` of ``libcuda``)."""
    lib = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    rc = lib.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                             ctypes.byref(n))
    return int(n.value) if rc == 0 else None


def _same(a, b) -> bool:
    return a is b or (a.data_ptr() == b.data_ptr() and a.dtype == b.dtype
                      and a.shape == b.shape and a.stride() == b.stride())


def _state_tensors(es: EngineState):
    """(name, tensor) of every tensor of an engine state."""
    return ([(f, getattr(es.map, f)) for f in MapState._fields]
            + [(f, getattr(es, f)) for f in ("pose", "frame",
                                             "tracking_lost",
                                             "n_integrated")])


def _clone_state(es: EngineState) -> EngineState:
    return es._replace(map=MapState(*(t.clone() for t in es.map)),
                       pose=es.pose.clone(), frame=es.frame.clone(),
                       tracking_lost=es.tracking_lost.clone(),
                       n_integrated=es.n_integrated.clone())


class _NoSpans:
    """The tracer's span calls on an untraced frame: nothing."""

    def open(self, name: str, key: Optional[str] = None) -> None:
        pass

    def close(self) -> None:
        pass

    def read_done(self, anchor: bool) -> None:
        pass


_NO_SPANS = _NoSpans()


class GraphStep:
    """The step of :func:`make_step`: ``step_fn(state, depth, color[,
    hint][, bitmask]) -> (state, diagnostics)``.

    Frame 0 is an eager :func:`step`. On a CUDA state every later frame is
    a replay of CUDA graphs captured from :func:`_view`, :func:`_front`
    and :func:`_back` (:func:`graph_keys`), each captured on the first
    frame that needs it, all in one memory pool. A tracked frame's host
    work is issued while a graph is queued on the device: the view graph
    (compactify and render, which read no input) is replayed, the frame's
    inputs are staged behind it (``inputs_behind`` counts those frames),
    the front graph (preprocess and track) is replayed, the copies of its
    diagnostics are issued, ``valid`` is read and, when the frame tracked,
    a back graph is replayed, the copies of its diagnostics are issued and
    the two maintain flags are read. A pose hint is staged before the view
    graph, which renders at it under ``use_trajectory_only_init``. A
    trajectory-replay frame stages its inputs, replays one graph, reads
    the flags and copies the diagnostics. When maintenance is due,
    ``compact_pool`` runs eagerly between frames, the step takes its
    result into its own buffers, and the map's diagnostics are copied
    after it. A capture that fails raises; no frame after frame 0 runs the
    eager step. On a CPU state the same functions run eagerly, in the same
    order.

    The step owns the state's tensors (the graphs read and write them at
    fixed addresses). A call adopts the given state: the state the step
    returned, handed back as it was (``donate``), is its own; otherwise
    each tensor that is not already the step's own is copied in (the first
    call after frame 0, and after anything that replaced a field:
    ``compact_pool``, a streaming manager's deletes and inserts).
    ``bytes_adopted`` and ``pool_bytes_adopted`` count those bytes (the
    pool rows ``sdf``, ``weight``, ``color`` apart). With ``donate=True``
    the returned state's tensors are the step's own and the given state is
    consumed (as under JAX donation: the pool is updated in place);
    ``donate=False`` leaves the given state unchanged and returns copies.
    Diagnostics are always copies.

    Inputs on the host (numpy arrays, CPU tensors) reach the card through
    two pinned staging sets used in turn, a set a frame; a set is reused
    only after the event recorded behind its copies has completed. Device
    inputs are copied into the step's input buffers, but for a bitmask
    that is a contiguous int32 tensor on the step's device: the graphs
    read it where it lies, so the same tensor given again (a streaming
    manager's, updated in place) costs no copy (``_bitmask_input``). A
    state that is the returned one's tensors rewrapped (a manager that
    wrote the map in place) is adopted with no copy. Given a
    ``streaming.AsyncStreamingManager``'s bitmask, a tracked frame runs
    the manager's queued host jobs whose device work has completed after
    its front graph (under trajectory replay, its one graph) is queued and
    before its first read, while the card is busy
    (``streaming.host_work``).

    ``trace``: None (off, as made), or a ``diagnostics.StepTracer`` that
    records the frames of each call while it is set (set and cleared
    between calls). A traced frame replays traced variants of the graphs, each
    captured on the first traced frame that needs it, in the same pool and
    kept in ``traced`` apart from ``graphs``: the untraced graphs with the
    tracer's stamps at their start, at each mark and at their end, and its
    counters. The traced graphs write to the tracer they were captured for:
    another tracer set on the step has them captured anew. The same frame
    makes the same two reads; the state and the diagnostics are those of
    an untraced frame.

    ``close()`` frees the graphs and buffers.
    """

    def __init__(self, cfg: EngineConfig, with_hint: bool = False,
                 donate: bool = True, with_stream_mask: bool = False):
        self.cfg = cfg
        self.with_hint = with_hint
        self.donate = donate
        self.with_stream_mask = with_stream_mask
        self.trace = None                # a diagnostics.StepTracer
        self.graphs = {}                 # key -> CountedGraph (CUDA)
        self.traced = {}                 # key -> traced CountedGraph
        self._traced_for = None          # the tracer they write to
        self.bytes_adopted = 0
        self.pool_bytes_adopted = 0
        self.inputs_behind = 0           # frames staged behind the view
        self._buf = None                 # the step's own EngineState
        self._returned = None            # the state the last call returned
        self._phase = None               # int32[] the frame's alloc phase
        self._inputs = None              # name -> static input tensor
        self._bitmask_shared = False     # the bitmask input is the caller's
        self._host_work = None           # its streaming manager's host jobs
        self._staging = [{}, {}]         # pinned host copies, two sets
        self._staged = [None, None]      # event behind each set's copies
        self._turn = 0
        self._filling = False            # the frame's pinned set is in use
        self._stream = None
        self._pool = None

    # -- buffers ---------------------------------------------------------

    def _adopt(self, state: EngineState) -> None:
        """Make the step's buffers hold ``state`` (see the class)."""
        if state is self._returned:
            return
        r = self._returned
        if r is not None and state.map is r.map and state.pose is r.pose \
                and state.frame is r.frame \
                and state.tracking_lost is r.tracking_lost \
                and state.n_integrated is r.n_integrated:
            return       # the returned state's own tensors, rewrapped
        if self._buf is None:
            share = _POOL_FIELDS if self.donate else ()
            own = {}
            for name, t in _state_tensors(state):
                own[name] = t if name in share else t.clone()
                if name not in share:
                    self._count(name, t)
            self._buf = EngineState(
                map=MapState(*(own[f] for f in MapState._fields)),
                pose=own["pose"], frame=own["frame"],
                tracking_lost=own["tracking_lost"],
                n_integrated=own["n_integrated"], frame_host=1)
            self._phase = torch.zeros_like(own["frame"])
            return
        for (name, dst), (_, src) in zip(_state_tensors(self._buf),
                                         _state_tensors(state)):
            if _same(dst, src):
                continue
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"make_step: state field {name} is "
                                 f"{tuple(src.shape)} {src.dtype}, the "
                                 f"step's is {tuple(dst.shape)} "
                                 f"{dst.dtype}")
            dst.copy_(src)
            self._count(name, src)

    def _count(self, name: str, t) -> None:
        n = t.numel() * t.element_size()
        if name in _POOL_FIELDS:
            self.pool_bytes_adopted += n
        else:
            self.bytes_adopted += n

    def _check(self, given: dict, device) -> tuple:
        """The names of the call's inputs, held with their shapes to the
        first call's, which makes the static input buffers."""
        names = tuple(k for k, v in given.items() if v is not None)
        shapes = {k: tuple(given[k].shape if hasattr(given[k], "shape")
                           else np.shape(given[k])) for k in names}
        if self._inputs is None:
            self._inputs = {
                k: torch.empty(shapes[k], device=device,
                               dtype=torch.int32 if k == "bitmask"
                               else torch.float32) for k in names}
        if names != tuple(self._inputs):
            raise ValueError(f"make_step: inputs {names} after "
                             f"{tuple(self._inputs)}: give color on every "
                             "call or on none")
        for k in names:
            want = tuple(self._inputs[k].shape)
            if shapes[k] != want:
                raise ValueError(f"make_step: {k} is {shapes[k]}, expected "
                                 f"{want}")
        if self.with_stream_mask and self._bitmask_input(given["bitmask"],
                                                         device):
            names = tuple(k for k in names if k != "bitmask")
        return names

    def _bitmask_input(self, b, device) -> bool:
        """Make the bitmask the graphs read ``b``: True when that is ``b``
        itself, so that nothing is staged. A contiguous int32 tensor on
        the step's device is read where it lies (a streaming manager's
        bitmask, updated in place between calls, costs no copy a frame);
        given another tensor, the step reads that one instead, and given
        anything else, copies it into a buffer of its own. Either change
        drops the graphs that read the bitmask (captured again at their
        next frame)."""
        cur = self._inputs["bitmask"]
        if b is cur:
            return True
        here = isinstance(b, torch.Tensor) and b.device == device \
            and b.dtype == torch.int32 and b.is_contiguous()
        if not (here or self._bitmask_shared):
            return False
        self._inputs["bitmask"] = b if here else torch.empty_like(cur)
        self._bitmask_shared = here
        from . import streaming
        self._host_work = streaming.host_work(b) if here else None
        for graphs in (self.graphs, self.traced):
            for key in [k for k in graphs if k.startswith(("back",
                                                           "fused"))]:
                graphs.pop(key).graph.reset()
        return here

    def _stage(self, given: dict, names, last: bool = True) -> None:
        """Copy the inputs ``names`` into the static input buffers; host
        inputs through the frame's pinned set. ``last``: the frame's last
        inputs (the event behind the set's copies is recorded)."""
        turn = self._turn
        pinned = self._staging[turn]
        for k in names:
            dst, src = self._inputs[k], given[k]
            if not isinstance(src, torch.Tensor):
                src = torch.as_tensor(np.asarray(src))
            if src.device.type == "cpu" and dst.device.type == "cuda":
                if not self._filling:
                    ev = self._staged[turn]
                    if ev is not None and not ev.query():
                        ev.synchronize()
                    self._filling = True
                if k not in pinned:
                    pinned[k] = torch.empty(dst.shape, dtype=dst.dtype,
                                            pin_memory=True)
                pinned[k].copy_(src)
                dst.copy_(pinned[k], non_blocking=True)
            else:
                dst.copy_(src)
        if last and self._filling:
            ev = torch.cuda.Event()
            ev.record()
            self._staged[turn] = ev
            self._turn, self._filling = 1 - turn, False

    # -- segments (the functions the graphs capture) ---------------------

    def _view_fn(self, mark=_no_mark, tracer=None) -> View:
        """The front's view half on the step's buffers (no input but the
        hint)."""
        return _view(self._buf, self.cfg, self._inputs.get("hint"), mark)

    def _front_fn(self, view: Optional[View] = None, mark=_no_mark,
                  tracer=None) -> Front:
        """The front segment on the step's buffers (after ``view``, or
        with its own), then the state's small fields: the alloc phase is
        the frame counter before it counts this frame. ``tracer``: takes
        the frame's counters."""
        b, inp = self._buf, self._inputs
        front = _front(b, inp["depth"], inp.get("color"), self.cfg,
                       inp.get("hint"), mark=mark,
                       tally=None if tracer is None else tracer.tally,
                       view=view)
        tr = front.tr
        self._phase.copy_(b.frame)
        b.frame.add_(1)
        b.pose.copy_(tr.pose)
        b.tracking_lost.copy_(~tr.valid)
        b.n_integrated.add_(tr.valid.to(torch.int32))
        mark("track")
        return front

    def _back_fn(self, starve: bool, front: Front, mark=_no_mark,
                 tracer=None) -> Back:
        """The back segment on the step's buffers; the map fields it
        replaced are copied into them (with the maintain flags, the stage
        ``maintain`` of a graphed frame)."""
        b = self._buf
        back = _back(b.map, front.frame, front.tr.pose, self.cfg,
                     self._phase, starve,
                     stream_bitmask=self._inputs.get("bitmask"),
                     reuse_active=front.reuse,
                     model_depth=front.model_depth, mark=mark,
                     tally=None if tracer is None else tracer.tally)
        for dst, src in zip(b.map, back.map):
            if src is not dst:
                dst.copy_(src)
        mark("maintain")
        return back._replace(map=b.map)

    def _fused_fn(self, starve: bool, mark=_no_mark, tracer=None):
        """Both segments in one graph (trajectory replay), the front in
        the eager step's order."""
        front = self._front_fn(None, mark, tracer)
        return front, self._back_fn(starve, front, mark, tracer)

    def _run(self, key: str, fn, tr=None):
        """``fn(mark, tracer)`` eagerly (CPU), or the replay of its graph
        (CUDA), captured at the first call with ``key``. With the tracer
        ``tr``: in a ``replay`` span, with its stamps (on the card the
        traced variant of the graph)."""
        cuda = self._buf.pose.device.type == "cuda"
        if tr is None:
            if not cuda:
                return fn(_no_mark, None)
            g = self.graphs.get(key)
            if g is None:
                g = self._capture(key, lambda: fn(_no_mark, None),
                                  self.graphs)
            g.replay()
            return g.out
        tr.open("replay", key)
        captured = False
        if not cuda:
            st = tr.stamps(key)
            out = st.around(fn, tr)
        else:
            g = self.traced.get(key)
            if g is None:
                st = tr.stamps(key, self._buf.pose.device)
                g = self._capture(key, lambda: st.around(fn, tr),
                                  self.traced)
                g.stamps, captured = st, True
            g.replay()
            out, st = g.out, g.stamps
        tr.close()
        tr.ran(key, st, captured)
        return out

    def _capture(self, key: str, fn, graphs: dict) -> CountedGraph:
        dev = self._buf.pose.device
        hash_table.reserve(dev, self.cfg.map)
        raymarch.reserve(dev, math.prod(raymarch.tiles(self.cfg.camera,
                                                        self.cfg.raycast)))
        if self._stream is None:
            _build.prime()
            self._stream = torch.cuda.Stream(dev)
            self._pool = torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        # the front segment writes nothing: one eager run on the capture
        # stream sets up what is made at first use (libraries, handles,
        # workspaces) outside the capture. Its launches are set-up, not a
        # frame's, and are not counted. The back segment, which updates
        # the map, never runs outside its frame: frame 0's eager step was
        # its warm-up.
        self._stream.wait_stream(torch.cuda.current_stream(dev))
        if not key.startswith("back"):
            with _taken_back(_launch_counters(), {}), \
                    torch.cuda.stream(self._stream):
                _front(self._buf, self._inputs["depth"],
                       self._inputs.get("color"), self.cfg,
                       self._inputs.get("hint"))
        torch.cuda.current_stream(dev).wait_stream(self._stream)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            g = capture(fn, graph, torch.cuda.graph(
                graph, pool=self._pool, stream=self._stream,
                capture_error_mode="thread_local"))
            graph.instantiate()
        except RuntimeError as e:
            raise RuntimeError(f"make_step: capturing the {key!r} segment "
                               f"failed: {e}") from e
        g.capture_ms = (time.perf_counter() - t0) * 1000.0
        g.nodes = _graph_nodes(graph)
        graphs[key] = g
        return g

    # -- the step ----------------------------------------------------------

    def __call__(self, state: EngineState, depth, color, *extra
                 ) -> Tuple[EngineState, FrameDiagnostics]:
        n_extra = int(self.with_hint) + int(self.with_stream_mask)
        if len(extra) != n_extra:
            raise TypeError(f"make_step: expected {3 + n_extra} arguments, "
                            f"got {3 + len(extra)}")
        cfg = self.cfg
        dev = state.pose.device
        fh = state.frame_host
        given = {"depth": depth, "color": color,
                 "hint": extra[0] if self.with_hint else None,
                 "bitmask": extra[-1] if self.with_stream_mask else None}
        names = self._check(given, dev)
        tr = self.trace
        sp = _NO_SPANS if tr is None else tr
        if tr is not None:
            if tr is not self._traced_for:
                self._drop_traced()
                self._traced_for = tr
            tr.begin(fh, dev)
            tr.open("inputs")
        if fh == 0:
            self._stage(given, names)
            hooks = {}
            if tr is not None:
                tr.close()
                hooks = tr.eager()
            # a copy of the hint: under replay it becomes the state's pose,
            # and the next call overwrites the input buffer
            inp = self._inputs
            hint = inp.get("hint")
            out = step(state if self.donate else _clone_state(state),
                       inp["depth"], inp.get("color"), cfg,
                       pose_hint=None if hint is None else hint.clone(),
                       stream_bitmask=inp.get("bitmask"), **hooks)
            if tr is not None:
                tr.end()
            return out

        self._adopt(state)
        replay = cfg.use_trajectory and self.with_hint
        keys = graph_keys(cfg, fh, replay)
        starve = keys[-1].endswith("_starve")
        fd = bd = None       # the copies of the front's and back's fields
        if replay:
            self._stage(given, names)
            sp.close()
            front, back = self._run(
                keys[0], lambda m, t: self._fused_fn(starve, m, t), tr)
            if self._host_work is not None:
                self._host_work()
        else:
            # the view graph reads no input but the hint: the frame's
            # inputs are staged while it runs
            if "hint" in names:
                self._stage(given, ("hint",), last=False)
            sp.close()
            view = self._run(keys[0], self._view_fn, tr)
            sp.open("inputs")
            self._stage(given, tuple(k for k in names if k != "hint"))
            if dev.type == "cuda":
                self.inputs_behind += 1
                if tr is not None:
                    tr.frames[-1].inputs_behind = True
            sp.close()
            front = self._run(
                keys[1], lambda m, t: self._front_fn(view, m, t), tr)
            sp.open("diagnostics")
            fd = _copied(_front_diagnostics(front))
            sp.close()
            if self._host_work is not None:
                self._host_work()
            back = None
            sp.open("read_valid")
            tracked = bool(front.tr.valid)
            sp.read_done(anchor=not tracked)
            if tracked:
                back = self._run(
                    keys[2], lambda m, t: self._back_fn(starve, front, m, t),
                    tr)
                sp.open("diagnostics")
                bd = _copied(_back_diagnostics(cfg, back, self._buf.map))
                sp.close()
        if back is not None:
            sp.open("read_flags")
            due = blockmap.need_maintain(back.flags, cfg.map, fh)
            sp.read_done(anchor=True)
            if due:
                sp.open("maintain")
                self._adopt(self._buf._replace(
                    map=blockmap.compact_pool(self._buf.map, cfg.map)))
                sp.close()
                bd = None        # n_allocated_blocks reads the new map
        if fd is None or bd is None:
            sp.open("diagnostics")
            if fd is None:
                fd = _copied(_front_diagnostics(front))
            bd = _copied(_back_diagnostics(cfg, back, self._buf.map))
            sp.close()
        diag = FrameDiagnostics(**fd, **bd)
        new = self._buf._replace(frame_host=fh + 1)
        if tr is not None:
            tr.end()
        if not self.donate:
            return _clone_state(new), diag
        self._returned = new
        return new, diag

    def _drop_traced(self) -> None:
        for g in self.traced.values():
            g.graph.reset()
        self.traced = {}

    def close(self) -> None:
        """Free the graphs, the step's buffers and its staging memory."""
        for g in self.graphs.values():
            g.graph.reset()
        self.graphs = {}
        self._drop_traced()
        self._traced_for = None
        self._buf = self._returned = self._phase = self._inputs = None
        self._host_work = None
        self._bitmask_shared = False
        self._staging, self._staged = [{}, {}], [None, None]
        self._filling = False
        self._stream = self._pool = None


def make_step(cfg: EngineConfig, with_hint: bool = False,
              donate: bool = True, with_stream_mask: bool = False
              ) -> GraphStep:
    """The step for a fixed config, with JAX's argument order:
    ``fn(state, depth, color[, hint][, bitmask]) -> (state, diag)``
    (:class:`GraphStep`: CUDA graphs on a CUDA state).

    ``donate``: the given state is consumed and its pool updated in place
    (essential at a map of gigabytes). ``with_stream_mask``: the step takes
    the streaming eviction bitmask as its last argument. The step's
    ``trace`` (None: off) takes a ``diagnostics.StepTracer`` between calls
    (:class:`GraphStep`).

    Not cached, unlike JAX's ``lru_cache``: a step owns a map-sized state
    and its graphs; call ``close()`` when done with it.
    """
    return GraphStep(cfg, with_hint=with_hint, donate=donate,
                     with_stream_mask=with_stream_mask)


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
