"""Hash-partitioned multi-device map: the distributed per-frame step
(port of ``voxelhashing_tpu.parallel.sharded`` on ``torch.distributed``).

One rank per process, where the JAX package runs ``shard_map`` over a
device mesh:

* **Map parallelism.** Voxel blocks are partitioned by key hash: rank
  ``r`` of ``D`` owns key ``k`` iff ``mix(k) % D == r``. Every rank holds a
  plain :class:`~voxelhashing_tpu_torch.blockmap.MapState` of 1/D capacity
  (``local_map_config``), so allocation, integration (kernel A), GC and
  maintenance are local.
* **Frame data is replicated**: every rank is handed the same frame.
* **Surface prediction.** Splat: every rank renders its own blocks (kernel
  B, or the color render under RGB-D) and one MIN all-reduce of the
  z-buffers gives the global one; under RGB-D one SUM all-reduce of the
  winning colors and the win counts (both in one buffer) gives the color.
  March: every TSDF fetch is a SUM all-reduce over the partition
  (``raycast.render_march(group=)``).
* **Tracking.** Each rank builds the ICP systems over its row shard of the
  frame (``torch.tensor_split`` style: every row goes to a rank); each
  tuple of partial sums is one SUM all-reduce, and every rank solves the
  same reduced system, so the pose and the ``valid`` flag are replicated.

No rank decides on the host from anything but a replicated value (the
host frame counter, the reduced ``valid``): a rank that branched alone
would leave the others waiting in a collective.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from ..config import CameraConfig, EngineConfig, MapConfig, resolve_device
from .. import blockmap, engine, geometry as geom, raycast, tracking
from ..blockmap import MapState
from ..geometry import INVALID_KEY
from ..ops.image import color_to_intensity, preprocess
from ..raycast import RaycastResult
from ..streaming import insert_blocks
from . import collectives

AXIS = "d"     # the JAX package's mesh axis name, kept for reference


def local_map_config(cfg: MapConfig, n_devices: int) -> MapConfig:
    """Per-rank map config: 1/D of the pool, table and active capacity."""
    return dataclasses.replace(
        cfg,
        num_blocks=max(cfg.num_blocks // n_devices, 64),
        table_size=max(cfg.table_size // n_devices, 256),
        max_active_blocks=max(cfg.max_active_blocks // n_devices, 64),
    )


def owner(keys, n_devices: int):
    """The rank that owns each key: ``mix(k) % D`` (int32)."""
    return (blockmap._mix(keys) % n_devices).to(torch.int32)


def _owned(keys, rank: int, n_devices: int):
    """Candidate keys masked to ``rank``'s hash partition."""
    return torch.where((owner(keys, n_devices) == rank)
                       & (keys != INVALID_KEY), keys, INVALID_KEY)


def row_range(height: int, rank: int, n_devices: int) -> Tuple[int, int]:
    """Rows [r0, r1) of ``rank``'s shard of a frame: ``torch.tensor_split``
    of ``height`` rows into ``n_devices`` parts, the first ``height % D``
    parts one row longer."""
    q, extra = divmod(height, n_devices)
    r0 = rank * q + min(rank, extra)
    return r0, r0 + q + (1 if rank < extra else 0)


class ShardedState(NamedTuple):
    """One rank's part of the JAX ``ShardedState``: its local map, the
    replicated pose and frame counter, and the host copies of the frame
    counter and of the last frame's ``valid`` flag (both replicated)."""

    map: MapState          # this rank's shard, local_map_config capacity
    pose: torch.Tensor     # f32[4,4] camera-to-world, replicated
    frame: torch.Tensor    # int32[] frame counter, replicated
    frame_host: int = 0
    valid_host: bool = True


def create_sharded(cfg: EngineConfig, group=None, initial_pose=None,
                   device="cuda") -> Tuple[ShardedState, MapConfig]:
    """This rank's fresh sharded state on ``device`` (the card unless the
    caller asks for the CPU), and the per-rank map config."""
    _, n_dev = collectives.world(group)
    lcfg = local_map_config(cfg.map, n_dev)
    device = resolve_device(device)
    pose = torch.eye(4, dtype=torch.float32, device=device) \
        if initial_pose is None else torch.as_tensor(
            initial_pose, dtype=torch.float32, device=device)
    return ShardedState(map=blockmap.create(lcfg, device), pose=pose,
                        frame=torch.zeros((), dtype=torch.int32,
                                          device=device)), lcfg


def make_sharded_step(cfg: EngineConfig, group=None,
                      with_stream_mask: bool = False):
    """The distributed per-frame step of this rank in ``group``.

    Returns ``fn(state, depth, color) -> (state, pose)``, or with
    ``with_stream_mask`` ``fn(state, depth, color, bitmask)``, whose
    eviction bitmask (``ShardedStreamingManager.bitmask``) keeps
    allocation out of streamed-out chunks. Every rank calls it with the
    same frame; the pose it returns is the same on every rank."""
    group = collectives.resolve(group)
    me, n_dev = collectives.world(group)
    lcfg = local_map_config(cfg.map, n_dev)
    shard_cfg = dataclasses.replace(cfg, map=lcfg)
    cam = cfg.camera
    use_rgbd = cfg.tracker.use_rgbd
    r0, r1 = row_range(cam.height, me, n_dev)

    def own(keys):
        return _owned(keys, me, n_dev)

    def local_step(state: ShardedState, depth, color, bitmask=None):
        mstate, pose = state.map, state.pose
        dev = pose.device
        frame = preprocess(depth, color, cam, cfg.filter)

        # ---- render own blocks, combine --------------------------------
        view = geom.invert_rigid(pose)
        active_idx, n_active, _ = blockmap.compactify(mstate, view, cam,
                                                      lcfg)
        active_mask = torch.arange(active_idx.shape[0], device=dev) \
            < n_active
        gmodel_int = None
        if cfg.raycast.mode == "march":
            gmodel = raycast.render_march(mstate, pose, cam, lcfg,
                                          cfg.raycast, active_idx=active_idx,
                                          active_mask=active_mask,
                                          group=group)
            gpts, gnrm = gmodel.points, gmodel.normals
            if use_rgbd:
                gmodel_int = torch.where(torch.isfinite(gmodel.depth),
                                         color_to_intensity(gmodel.color),
                                         torch.nan)
        else:
            model = raycast.render_splat(mstate, pose, cam, lcfg,
                                         cfg.raycast, active_idx=active_idx,
                                         active_mask=active_mask,
                                         with_color=use_rgbd)
            zloc = torch.where(torch.isfinite(model.depth), model.depth,
                               torch.inf)
            zglob = collectives.all_reduce(zloc, "min", group)
            gdepth = torch.where(torch.isfinite(zglob), zglob, torch.nan)
            u, v = geom.pixel_grid(cam.width, cam.height, dev)
            gpts = geom.screen_to_camera(u, v, gdepth, cam)
            gpts = torch.where(torch.isfinite(gdepth)[..., None], gpts,
                               torch.nan)
            gnrm = geom.normals_from_points(gpts)
            if use_rgbd:
                # the rank at the global z-min gives its color; a tie (two
                # ranks at one depth) averages
                win = ((zloc == zglob) & torch.isfinite(zglob)).to(
                    torch.float32)
                both = collectives.all_reduce(
                    torch.cat([model.color * win[..., None],
                               win[..., None]], dim=-1), "sum", group)
                wsum = both[..., 3]
                gcol = both[..., :3] / torch.clamp(wsum, min=1.0)[..., None]
                gmodel_int = torch.where(wsum > 0.0,
                                         color_to_intensity(gcol), torch.nan)

        # ---- track: row-shard systems, one all-reduce per sum ----------
        is_first = state.frame_host == 0
        if is_first:
            # frame 0 keeps its pose (there is no model yet)
            new_pose, valid = pose, True
        else:
            in_int = (frame.intensity[r0:r1]
                      if use_rgbd and frame.intensity is not None else None)
            tr = _track_distributed(frame.points[r0:r1],
                                    frame.normals[r0:r1], gpts, gnrm, pose,
                                    cam, cfg.tracker, group,
                                    input_intensity=in_int,
                                    model_intensity=gmodel_int)
            # the step's one read; replicated, since every rank solved the
            # same reduced system
            valid = bool(tr.valid)
            new_pose = tr.pose

        # ---- allocate + integrate own partition (kernel A) -------------
        if is_first or valid:
            mstate = engine._integrate_frame(
                mstate, frame, new_pose, shard_cfg, state.frame_host,
                stream_bitmask=bitmask, key_filter=own)[0]
        return ShardedState(map=mstate, pose=new_pose,
                            frame=state.frame + 1,
                            frame_host=state.frame_host + 1,
                            valid_host=valid), new_pose

    if with_stream_mask:
        def step(state: ShardedState, depth, color, bitmask):
            return local_step(state, depth, color, bitmask)
    else:
        def step(state: ShardedState, depth, color):
            return local_step(state, depth, color)
    return step


def _track_distributed(in_p, in_n, md_p, md_n, last_pose, cam: CameraConfig,
                       cfg, group=None, input_intensity=None,
                       model_intensity=None):
    """``tracking.track`` with every tuple of partial sums SUM-reduced over
    ``group`` in one all-reduce. The input maps are this rank's row shard;
    the model maps are global."""
    return tracking.track(in_p, in_n, md_p, md_n, last_pose, cam, cfg,
                          input_intensity=input_intensity,
                          model_intensity=model_intensity,
                          weight_depth=cfg.weight_depth,
                          weight_color=cfg.weight_color,
                          color_sigma=cfg.color_sigma,
                          reduce_fn=lambda sums: collectives.sum_tuple(
                              sums, group))


def make_sharded_render(cfg: EngineConfig, group=None):
    """The distributed ``render_march`` of the hash-partitioned map, color
    included: every TSDF fetch is summed over ``group``. Returns ``fn(state, pose) -> RaycastResult``,
    the same on every rank."""
    group = collectives.resolve(group)
    _, n_dev = collectives.world(group)
    lcfg = local_map_config(cfg.map, n_dev)
    cam = cfg.camera

    def render(state: ShardedState, pose) -> RaycastResult:
        dev = state.pose.device
        pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
        view = geom.invert_rigid(pose)
        active_idx, n_active, _ = blockmap.compactify(state.map, view, cam,
                                                      lcfg)
        active_mask = torch.arange(active_idx.shape[0], device=dev) \
            < n_active
        res = raycast.render_march(state.map, pose, cam, lcfg, cfg.raycast,
                                   active_idx=active_idx,
                                   active_mask=active_mask, group=group)
        return res._replace(splat_overflow=torch.zeros(
            (), dtype=torch.int32, device=dev))

    return render


def gather_map(state: ShardedState, lcfg: MapConfig, cfg: MapConfig,
               group=None, dst: int = 0):
    """Merge every rank's shard into one map of ``cfg`` capacity on rank
    ``dst`` (for meshing, checkpoints, checks): each rank's allocated rows
    go to ``dst`` (counts first, then the rows padded to the longest) and
    are inserted there in rank order. Returns the merged ``MapState`` on
    ``dst`` and None on every other rank; every rank must call it."""
    me, _ = collectives.world(group)
    m = state.map
    rows = torch.nonzero(m.block_key != INVALID_KEY).flatten()
    got = collectives.gather_rows(
        [m.block_key[rows], m.sdf[rows].to(torch.float32),
         m.weight[rows].to(torch.float32), m.color[rows]], group, dst)
    if me != dst:
        return None
    merged = blockmap.create(cfg, m.block_key.device)
    for keys, sdf, weight, color in got:
        if keys.shape[0]:
            merged, _, _ = insert_blocks(merged, keys, sdf, weight, color,
                                         cfg)
    return merged
