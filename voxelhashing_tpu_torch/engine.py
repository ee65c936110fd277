"""The per-frame reconstruction engine (PyTorch port of
``voxelhashing_tpu.engine``).

    preprocess -> compactify -> render (splat or march) -> ICP track
    (depth only, or RGB-D) -> (lost? skip) -> DDA alloc -> fused integrate
    -> garbage collect -> maintain

The frame is two segments: :func:`_front` (preprocess to track; reads
the map, writes nothing) and :func:`_back` (alloc to GC, and the maintain
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
with those two reads between them; on a CPU state it runs the same
functions eagerly.

``step(..., mark=f)`` calls ``f(stage)`` each time a stage's work has been
issued, in the order of :data:`STAGES`; ``chip_smoke.py`` records a CUDA
event there to time the stages.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config import EngineConfig, resolve_device
from . import blockmap, geometry as geom, integrate as integ, raycast, tracking
from . import streaming
from .blockmap import MapState
from .ops import _build, hash_table
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


def _front(state: EngineState, depth_raw, color_raw, cfg: EngineConfig,
           hint=None, first: bool = False, mark=_no_mark) -> Front:
    """preprocess -> compactify -> render -> track, with no host read and
    no write to the map. ``hint``: the pose hint (a device tensor) or None;
    ``first``: frame 0 (no model yet: the pose is kept)."""
    cam = cfg.camera
    dev = state.pose.device
    frame = preprocess(depth_raw, color_raw, cam, cfg.filter)
    mark("preprocess")

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
    reuse = None if cfg.offline else (active_idx, n_active, overflow0)
    return Front(frame=frame, tr=tr, model_depth=model.depth,
                 splat_overflow=model.splat_overflow, reuse=reuse)


def _back(state: MapState, frame: FrameInputs, pose, cfg: EngineConfig,
          phase, starve: bool, stream_bitmask=None, reuse_active=None,
          model_depth=None, mark=_no_mark, key_filter=None) -> Back:
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
    mark("gc")
    return Back(map=state, n_active=n_active, overflow=overflow,
                alloc_missed=alloc_missed,
                flags=blockmap.maintain_flags(state, mp))


def _integrate_frame(state: MapState, frame: FrameInputs, pose,
                     cfg: EngineConfig, frame_idx: int, stream_bitmask=None,
                     reuse_active=None, model_depth=None, mark=_no_mark,
                     key_filter=None):
    """:func:`_back` at host frame ``frame_idx``, then the maintain
    decision (one host read) and, when needed, ``compact_pool``. Returns
    (map, n_active, overflow, alloc_missed)."""
    back = _back(state, frame, pose, cfg, frame_idx,
                 _is_starve(cfg.map, frame_idx),
                 stream_bitmask=stream_bitmask, reuse_active=reuse_active,
                 model_depth=model_depth, mark=mark, key_filter=key_filter)
    state = back.map
    if blockmap.need_maintain(back.flags, cfg.map, frame_idx):
        state = blockmap.compact_pool(state, cfg.map)
    mark("maintain")
    return state, back.n_active, back.overflow, back.alloc_missed


def _diagnostics(cfg: EngineConfig, front: Front, back: Optional[Back],
                 map_state: MapState) -> FrameDiagnostics:
    """The frame's diagnostics; ``back`` None: the frame was not
    integrated."""
    tr = front.tr
    if back is None:
        n_act = overflow = alloc_missed = torch.zeros(
            (), dtype=torch.int32, device=tr.pose.device)
    else:
        n_act, overflow, alloc_missed = (back.n_active, back.overflow,
                                         back.alloc_missed)
    return FrameDiagnostics(
        n_allocated_blocks=cfg.map.num_blocks - map_state.n_free,
        n_active_blocks=n_act,
        active_overflow=overflow,
        splat_overflow=front.splat_overflow,
        alloc_missed=alloc_missed,
        icp_residual=tr.residual,
        icp_corr_count=tr.corr_count,
        icp_condition=tr.condition,
        icp_level_stats=tr.level_stats,
        icp_iter_residuals=tr.iter_residuals,
        tracking_valid=tr.valid,
        icp_planarity=tr.planarity,
    )


def step(state: EngineState, depth_raw, color_raw, cfg: EngineConfig,
         pose_hint=None, mark=_no_mark, stream_bitmask=None
         ) -> Tuple[EngineState, FrameDiagnostics]:
    """Process one RGB-D frame (tensors on the state's device), eagerly.

    ``pose_hint``: optional external pose. With ``cfg.use_trajectory`` the
    hint is the pose; with ``use_trajectory_only_init`` it seeds ICP and
    the model render. ``stream_bitmask``: the streaming manager's
    eviction bitmask (``streaming.StreamingManager.bitmask``), which keeps
    allocation out of evicted chunks. ``mark``: called with each stage's name when its
    work has been issued (see :data:`STAGES`).
    """
    dev = state.pose.device
    is_first = state.frame_host == 0
    hint = None if pose_hint is None else torch.as_tensor(
        pose_hint, dtype=torch.float32, device=dev)
    front = _front(state, depth_raw, color_raw, cfg, hint, first=is_first,
                   mark=mark)
    tr = front.tr
    replay = cfg.use_trajectory and hint is not None
    integrate_now = is_first or replay or bool(tr.valid)
    mark("track")
    if integrate_now:
        new_map, n_act, overflow, alloc_missed = _integrate_frame(
            state.map, front.frame, tr.pose, cfg, state.frame_host,
            stream_bitmask=stream_bitmask, reuse_active=front.reuse,
            model_depth=front.model_depth, mark=mark)
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
    then the constant True) one graph, ``"fused"``; else ``"front"`` and,
    when the frame tracked, ``"back"``. A starve frame's back half is a
    graph of its own (``"_starve"``)."""
    if frame_idx == 0:
        return ("eager",)
    tail = "_starve" if _is_starve(cfg.map, frame_idx) else ""
    return ("fused" + tail,) if replay else ("front", "back" + tail)


def _launch_counters():
    """(owner, attribute) of every kernel launch count."""
    from .ops import fused_integrate as fa, icp_update as iu, solve6 as s6
    from .ops import icp_linearize as il, splat_zbuf as sb
    from .ops import alloc_candidates as ac, preprocess as pp
    from .ops import hash_table as ht, raymarch as rm
    return ((pp.preprocess_depth, "launches"),
            (ac.alloc_candidates, "launches"),
            (ht.allocate, "launches"),
            (ht.delete_blocks, "launches"),
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
            (s6.solve6, "launches"))


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


class GraphStep:
    """The step of :func:`make_step`: ``step_fn(state, depth, color[,
    hint][, bitmask]) -> (state, diagnostics)``.

    Frame 0 is an eager :func:`step`. On a CUDA state every later frame is
    a replay of CUDA graphs captured from :func:`_front` and :func:`_back`
    (:func:`graph_keys`), each captured on the first frame that needs it,
    all in one memory pool: a tracked frame replays the front graph,
    reads ``valid`` and, when it tracked, replays a back graph and reads
    the two maintain flags; a trajectory-replay frame replays one graph
    and reads the flags. When maintenance is due, ``compact_pool`` runs
    eagerly between frames and the step takes its result into its own
    buffers. A capture that fails raises; no frame after frame 0 runs the
    eager step. On a CPU state the same functions run eagerly.

    The step owns the state's tensors (the graphs read and write them at
    fixed addresses). A call adopts the given state: each tensor that is
    not already the step's own is copied in (the first call after frame 0,
    and after anything that replaced a field: ``compact_pool``, a
    streaming manager's deletes and inserts). ``bytes_adopted`` and
    ``pool_bytes_adopted`` count those bytes (the pool rows ``sdf``,
    ``weight``, ``color`` apart). With ``donate=True`` the returned state's
    tensors are the step's own and the given state is consumed (as under
    JAX donation: the pool is updated in place); ``donate=False`` leaves
    the given state unchanged and returns copies. Diagnostics are always
    copies.

    Inputs on the host (numpy arrays, CPU tensors) reach the card through
    two pinned staging sets used in turn; a set is reused only after the
    event recorded behind its copies has completed. Device inputs are
    copied into the step's input buffers.

    ``close()`` frees the graphs and buffers.
    """

    def __init__(self, cfg: EngineConfig, with_hint: bool = False,
                 donate: bool = True, with_stream_mask: bool = False):
        self.cfg = cfg
        self.with_hint = with_hint
        self.donate = donate
        self.with_stream_mask = with_stream_mask
        self.graphs = {}                 # key -> CountedGraph (CUDA)
        self.bytes_adopted = 0
        self.pool_bytes_adopted = 0
        self._buf = None                 # the step's own EngineState
        self._phase = None               # int32[] the frame's alloc phase
        self._inputs = None              # name -> static input tensor
        self._staging = [{}, {}]         # pinned host copies, two sets
        self._staged = [None, None]      # event behind each set's copies
        self._turn = 0
        self._stream = None
        self._pool = None

    # -- buffers ---------------------------------------------------------

    def _adopt(self, state: EngineState) -> None:
        """Make the step's buffers hold ``state`` (see the class)."""
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

    def _stage(self, given: dict, device) -> None:
        """Copy the call's inputs into the static input buffers."""
        names = tuple(k for k, v in given.items() if v is not None)
        if self._inputs is None:
            self._inputs = {}
            for k in names:
                src = given[k]
                shape = tuple(src.shape if hasattr(src, "shape")
                              else np.shape(src))
                dtype = torch.int32 if k == "bitmask" else torch.float32
                self._inputs[k] = torch.empty(shape, dtype=dtype,
                                              device=device)
        if names != tuple(self._inputs):
            raise ValueError(f"make_step: inputs {names} after "
                             f"{tuple(self._inputs)}: give color on every "
                             "call or on none")
        turn = self._turn
        pinned = self._staging[turn]
        host_copies = False
        for k in names:
            dst, src = self._inputs[k], given[k]
            if not isinstance(src, torch.Tensor):
                src = torch.as_tensor(np.asarray(src))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"make_step: {k} is {tuple(src.shape)}, "
                                 f"expected {tuple(dst.shape)}")
            if src.device.type == "cpu" and dst.device.type == "cuda":
                if not host_copies:
                    ev = self._staged[turn]
                    if ev is not None and not ev.query():
                        ev.synchronize()
                    host_copies = True
                if k not in pinned:
                    pinned[k] = torch.empty(dst.shape, dtype=dst.dtype,
                                            pin_memory=True)
                pinned[k].copy_(src)
                dst.copy_(pinned[k], non_blocking=True)
            else:
                dst.copy_(src)
        if host_copies:
            ev = torch.cuda.Event()
            ev.record()
            self._staged[turn] = ev
            self._turn = 1 - turn

    # -- segments (the functions the graphs capture) ---------------------

    def _front_fn(self) -> Front:
        """The front segment on the step's buffers, then the state's small
        fields: the alloc phase is the frame counter before it counts this
        frame."""
        b, inp = self._buf, self._inputs
        front = _front(b, inp["depth"], inp.get("color"), self.cfg,
                       inp.get("hint"))
        tr = front.tr
        self._phase.copy_(b.frame)
        b.frame.add_(1)
        b.pose.copy_(tr.pose)
        b.tracking_lost.copy_(~tr.valid)
        b.n_integrated.add_(tr.valid.to(torch.int32))
        return front

    def _back_fn(self, starve: bool, front: Front) -> Back:
        """The back segment on the step's buffers; the map fields it
        replaced are copied into them."""
        b = self._buf
        back = _back(b.map, front.frame, front.tr.pose, self.cfg,
                     self._phase, starve,
                     stream_bitmask=self._inputs.get("bitmask"),
                     reuse_active=front.reuse,
                     model_depth=front.model_depth)
        for dst, src in zip(b.map, back.map):
            if src is not dst:
                dst.copy_(src)
        return back._replace(map=b.map)

    def _fused_fn(self, starve: bool):
        """Both segments in one graph (trajectory replay)."""
        front = self._front_fn()
        return front, self._back_fn(starve, front)

    def _run(self, key: str, fn):
        """``fn()`` eagerly (CPU), or the replay of its graph (CUDA),
        captured at the first call with ``key``."""
        if self._buf.pose.device.type != "cuda":
            return fn()
        g = self.graphs.get(key)
        if g is None:
            g = self._capture(key, fn)
        g.replay()
        return g.out

    def _capture(self, key: str, fn) -> CountedGraph:
        dev = self._buf.pose.device
        hash_table.reserve(dev, self.cfg.map.table_size)
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
        self.graphs[key] = g
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
        self._stage({"depth": depth, "color": color,
                     "hint": extra[0] if self.with_hint else None,
                     "bitmask": extra[-1] if self.with_stream_mask
                     else None}, dev)
        inp = self._inputs
        fh = state.frame_host
        if fh == 0:
            # a copy of the hint: under replay it becomes the state's pose,
            # and the next call overwrites the input buffer
            hint = inp.get("hint")
            return step(state if self.donate else _clone_state(state),
                        inp["depth"], inp.get("color"), cfg,
                        pose_hint=None if hint is None else hint.clone(),
                        stream_bitmask=inp.get("bitmask"))

        self._adopt(state)
        replay = cfg.use_trajectory and self.with_hint
        keys = graph_keys(cfg, fh, replay)
        starve = keys[-1].endswith("_starve")
        if replay:
            front, back = self._run(keys[0],
                                    lambda: self._fused_fn(starve))
        else:
            front = self._run(keys[0], self._front_fn)
            back = None
            if bool(front.tr.valid):
                back = self._run(keys[1],
                                 lambda: self._back_fn(starve, front))
        if back is not None and blockmap.need_maintain(back.flags, cfg.map,
                                                       fh):
            self._adopt(self._buf._replace(
                map=blockmap.compact_pool(self._buf.map, cfg.map)))
        diag = FrameDiagnostics(*(t.clone() for t in _diagnostics(
            cfg, front, back, self._buf.map)))
        new = self._buf._replace(frame_host=fh + 1)
        return (new if self.donate else _clone_state(new)), diag

    def close(self) -> None:
        """Free the graphs, the step's buffers and its staging memory."""
        for g in self.graphs.values():
            g.graph.reset()
        self.graphs = {}
        self._buf = self._phase = self._inputs = None
        self._staging, self._staged = [{}, {}], [None, None]
        self._stream = self._pool = None


def make_step(cfg: EngineConfig, with_hint: bool = False,
              donate: bool = True, with_stream_mask: bool = False
              ) -> GraphStep:
    """The step for a fixed config, with JAX's argument order:
    ``fn(state, depth, color[, hint][, bitmask]) -> (state, diag)``
    (:class:`GraphStep`: CUDA graphs on a CUDA state).

    ``donate``: the given state is consumed and its pool updated in place
    (essential at a map of gigabytes). ``with_stream_mask``: the step takes
    the streaming eviction bitmask as its last argument.

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
