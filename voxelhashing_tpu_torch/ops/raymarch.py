"""The march renderer: the per-tile ray bounds (``ray_bounds_kernel``) and
the march itself (``raymarch_kernel<kGradients>``), in
``csrc/raymarch.cu``.

No TPU kernel: the JAX package runs the march as XLA
(``voxelhashing_tpu/raycast.py:148`` ``ray_interval_splat``, :455
``render_march``, :509 ``march_core``, :83 ``trilinear_sample_soa``, :119
``sdf_gradient``; ``voxelhashing_tpu/blockmap.py:156`` ``lookup``, :520
``gather_voxels_soa``). The plain versions here are those functions op for
op (the CPU path, and the reference on the card): :func:`ray_bounds_plain`
and :func:`march_plain`, which runs the batched ``raycast.march_hits``
with the map's hash sampler. ``raycast.ray_interval_splat`` and
``raycast.render_march`` keep their names and reach :func:`ray_bounds` and
:func:`march`.

On CUDA tensors :func:`ray_bounds` is one launch (in place of ~150 small
torch launches; its accumulators persist, :func:`reserve`) and
:func:`march` one launch a render (in place of the [num_samples, P]
sample pass, ~29.5M hash lookups a 320x240 frame at 48 samples, and its
secant steps): ``MARCH_LANES`` lanes a ray that
take its samples in windows and stop at the window past its band or
holding its first crossing, a warp's block lookups listed and shared.
Both are bit-equal to their plain versions:
the bounds, and the march's :class:`MarchHits` (t_hit, found, p_hit,
color and, with gradients, the raw gradient and its validity), which
``raycast.march_epilogue`` turns into the predicted frame for either. On
CPU tensors the wrappers run the plain versions; any other device raises.
There is no fallback: a missing ``nvcc`` or a failed build or launch
raises.

:func:`prepare_bounds` and :func:`prepare_march` check the inputs and make
the outputs; :func:`launch` issues a prepared kernel on the current stream
(the only place that does; it adds one to ``ray_bounds.launches`` or
``march.launches``). The plain versions count their calls on CUDA tensors
(``cuda_calls``). The least time of a call is the larger of
:func:`bytes_moved` over the memory rate and :func:`operations` over the
f32 rate, from :func:`work_counts`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build
from .. import geometry as geom
from ..config import CameraConfig, MapConfig, RaycastConfig
from ..geometry import INVALID_KEY

SPAN = 4                  # tiles a block may span per axis, else it widens all
NEAR_Z = 1e-3             # a block's z min must pass it to be scattered
IDENTITY = 0x7F800000     # csrc: every accumulator's start, image(+inf)
TOMBSTONE = 0x7FFFFFFE    # blockmap.TOMBSTONE
MARCH_LANES = 4           # csrc/raymarch.cu: kMarchLanes, lanes a ray
MARCH_THREADS = 256       # csrc/raymarch.cu: kMarchThreads, a CTA
MARCH_TILE_X = 8          # csrc/raymarch.cu: kMarchTileX, a CTA's rays wide

_ACCUMULATORS = {}        # (device, tile count) -> the bounds' accumulators


class MarchHits(NamedTuple):
    """What a march finds along each ray (flat [P], row-major pixels),
    before ``raycast.march_epilogue``. Rays with no kept hit hold NaN
    ``t_hit``, ``p_hit`` and ``grad``, 0 ``color`` and False ``grad_ok``."""

    t_hit: torch.Tensor              # f32[P]   z-depth of the hit
    found: torch.Tensor              # bool[P]
    p_hit: torch.Tensor              # f32[P,3] world position of the hit
    color: torch.Tensor              # f32[P,3] in [0, 1]
    grad: Optional[torch.Tensor]     # f32[P,3] (s(p+e) - s(p-e)) * 0.5
    grad_ok: Optional[torch.Tensor]  # bool[P]


def _device(t, what):
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for {dev}")
    return dev


def tiles(cam: CameraConfig, rc: RaycastConfig):
    """(tiles_y, tiles_x) of the bounds grid."""
    tile = rc.splat_tile
    return -(-cam.height // tile), -(-cam.width // tile)


def reserve(device, n_tiles: int):
    """The bounds kernel's persistent accumulators on ``device`` for a grid
    of ``n_tiles`` tiles: int32 [2 n + 4] (the tiles' z min and max
    images, the global widening and the last-CTA counter), ``IDENTITY``
    between launches (each launch's last CTA restores them), made at the
    first call. Raises inside a CUDA graph capture when they are not made
    yet: a buffer made there would belong to the graph's pool. Two bounds
    launches that share them must not run at once (one stream a
    process)."""
    device = torch.device(device)
    key = (device, int(n_tiles))
    acc = _ACCUMULATORS.get(key)
    if acc is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "raymarch: reserve(device, n_tiles) before a CUDA graph "
                "capture; the bounds' accumulators are not made yet")
        acc = torch.full((2 * n_tiles + 4,), IDENTITY, dtype=torch.int32,
                         device=device)
        _ACCUMULATORS[key] = acc
    return acc


# ---------------------------------------------------------------------------
# The plain versions (the CPU path; the reference on the card)
# ---------------------------------------------------------------------------

class RowBounds(NamedTuple):
    """Each active row's part in the tile bounds ([M] each)."""

    z_min: torch.Tensor      # f32, the block's corners' z range
    z_max: torch.Tensor
    t0x: torch.Tensor        # int32, its tile box (clamped to the grid)
    t1x: torch.Tensor
    t0y: torch.Tensor
    t1y: torch.Tensor
    scatter: torch.Tensor    # bool, scattered into its box
    overflow: torch.Tensor   # bool, widens every tile instead


def row_bounds(block_key, active_idx, active_mask, view_matrix,
               cam: CameraConfig, cfg: MapConfig, rc: RaycastConfig):
    """The per-row half of :func:`ray_bounds_plain`: each active block's 8
    corners projected, its z range and screen box, the tiles it spans and
    whether it scatters into them or overflows."""
    tile = rc.splat_tile
    ty, tx = tiles(cam, rc)
    dev = active_idx.device

    blocks = geom.unpack_block_key(block_key[active_idx.long()],
                                   cfg.world_blocks)                 # [M,3]
    corner0 = geom.block_to_world(blocks, cfg.voxel_size)
    # the 8 corner offsets in _CORNER_LIST order, made on the device (a
    # host list copied up would wait for the stream)
    k = torch.arange(8, device=dev)
    offs = torch.stack([k & 1, (k >> 1) & 1, (k >> 2) & 1], dim=-1)
    corners = corner0[:, None, :] + cfg.block_size_world * offs.to(
        torch.float32)
    p_cam = geom.transform_points(view_matrix, corners)              # [M,8,3]

    z = p_cam[..., 2]
    z_min = torch.amin(z, dim=-1)
    z_max = torch.amax(z, dim=-1)
    near_ok = z_min > NEAR_Z

    uv = geom.camera_to_screen(p_cam, cam)                           # [M,8,2]
    u_min = torch.floor(torch.amin(uv[..., 0], dim=-1)).to(torch.int32)
    u_max = torch.floor(torch.amax(uv[..., 0], dim=-1)).to(torch.int32)
    v_min = torch.floor(torch.amin(uv[..., 1], dim=-1)).to(torch.int32)
    v_max = torch.floor(torch.amax(uv[..., 1], dim=-1)).to(torch.int32)

    def tile_of(x, n):
        return torch.clamp(torch.div(x, tile, rounding_mode="floor"), 0,
                           n - 1)

    t0x, t1x = tile_of(u_min, tx), tile_of(u_max, tx)
    t0y, t1y = tile_of(v_min, ty), tile_of(v_max, ty)
    on_screen = ((u_max >= 0) & (u_min < cam.width)
                 & (v_max >= 0) & (v_min < cam.height))

    fits = (t1x - t0x < SPAN) & (t1y - t0y < SPAN)
    return RowBounds(z_min, z_max, t0x, t1x, t0y, t1y,
                     active_mask & near_ok & on_screen & fits,
                     active_mask & on_screen & ~(near_ok & fits))


def ray_bounds_plain(block_key, active_idx, active_mask, view_matrix,
                     cam: CameraConfig, cfg: MapConfig, rc: RaycastConfig):
    """Per-screen-tile [min,max] z-depth bounds of the active blocks
    (``raycast.ray_interval_splat``'s plain version): each block's 8
    corners projected, its screen box and depth range scatter-min/maxed
    into a (tiles_y, tiles_x) grid over a span of at most 4x4 tiles;
    blocks that span more (or cross the near plane) widen every tile.
    Tiles no block touches get t_min=+inf > t_max=-inf."""
    if block_key.device.type == "cuda":
        ray_bounds_plain.cuda_calls += 1
    ty, tx = tiles(cam, rc)
    dev = active_idx.device
    r = row_bounds(block_key, active_idx, active_mask, view_matrix, cam,
                   cfg, rc)
    any_overflow = torch.any(r.overflow)
    g_min = torch.amin(torch.where(
        r.overflow, torch.clamp(r.z_min, min=cam.depth_min), torch.inf))
    g_max = torch.amax(torch.where(r.overflow, r.z_max, -torch.inf))

    n = ty * tx
    t_min = torch.full((n + 1,), torch.inf, dtype=torch.float32, device=dev)
    t_max = torch.full((n + 1,), -torch.inf, dtype=torch.float32, device=dev)
    for dy in range(SPAN):
        for dx in range(SPAN):
            iy = r.t0y + dy
            ix = r.t0x + dx
            ok = r.scatter & (iy <= r.t1y) & (ix <= r.t1x)
            lin = torch.where(ok, iy * tx + ix, n).long()   # n = dropped
            t_min.scatter_reduce_(0, lin, r.z_min, "amin", include_self=True)
            t_max.scatter_reduce_(0, lin, r.z_max, "amax", include_self=True)
    t_min = t_min[:n].reshape(ty, tx)
    t_max = t_max[:n].reshape(ty, tx)
    t_min = torch.where(any_overflow, torch.minimum(t_min, g_min), t_min)
    t_max = torch.where(any_overflow, torch.maximum(t_max, g_max), t_max)
    return t_min, t_max


ray_bounds_plain.cuda_calls = 0


def ray_interval(bounds, device, cam: CameraConfig, cfg: MapConfig,
                 rc: RaycastConfig):
    """Each ray's [t_min, t_max] (flat [P]): its tile's bounds less and
    plus the truncation, clamped to the camera's depth range, or (no
    ``bounds``) the camera's range."""
    h, w = cam.height, cam.width
    if bounds is None:
        return (torch.full((h * w,), cam.depth_min, dtype=torch.float32,
                           device=device),
                torch.full((h * w,), cam.depth_max, dtype=torch.float32,
                           device=device))
    tmin_t, tmax_t = bounds
    tile = rc.splat_tile
    iy = torch.div(torch.arange(h, device=device), tile,
                   rounding_mode="floor")
    ix = torch.div(torch.arange(w, device=device), tile,
                   rounding_mode="floor")
    t_min = torch.clamp(tmin_t[iy[:, None], ix[None, :]]
                        - cfg.truncation, min=cam.depth_min).reshape(-1)
    t_max = torch.clamp(tmax_t[iy[:, None], ix[None, :]]
                        + cfg.truncation, max=cam.depth_max).reshape(-1)
    return t_min, t_max


def march_plain(state, pose, cam: CameraConfig, cfg: MapConfig,
                rc: RaycastConfig, bounds=None) -> MarchHits:
    """The march's plain version: the batched ``raycast.march_hits`` (all
    ``rc.num_samples`` samples of every ray in one pass) with the map's
    hash sampler, each ray in its interval (:func:`ray_interval` of
    ``bounds``, the tile grids of :func:`ray_bounds`, or the camera's
    range); with ``rc.use_gradients`` the raw gradient samples at the
    hits."""
    from .. import raycast
    if state.sdf.device.type == "cuda":
        march_plain.cuda_calls += 1
    t_min, t_max = ray_interval(bounds, pose.device, cam, cfg, rc)

    def sample_soa(px, py, pz, with_color=False):
        return raycast.trilinear_sample_soa(state, px, py, pz, cfg,
                                            with_color=with_color)

    gradient_fn = None
    if rc.use_gradients:
        def gradient_fn(p_world):
            return raycast.sdf_gradient_samples(state, p_world, cfg)

    d = rc.derived(cfg)
    return raycast.march_hits(sample_soa, pose, cam, t_min, t_max,
                              num_samples=rc.num_samples,
                              ray_inc=d["ray_increment"],
                              thres_sample_dist=d["thres_sample_dist"],
                              thres_dist=d["thres_dist"],
                              gradient_fn=gradient_fn)


march_plain.cuda_calls = 0


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

def _check(t, dtype, shape, what, dev):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != dev or not t.is_contiguous():
        raise ValueError(f"raymarch: {what} must be contiguous {dtype} "
                         f"{tuple(shape)} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def prepare_bounds(block_key, active_idx, active_mask, view_matrix,
                   cam: CameraConfig, cfg: MapConfig, rc: RaycastConfig):
    """Check the inputs and make the outputs (t_min, t_max f32 [ty, tx]);
    returns (launch arguments, (t_min, t_max)). The accumulators are the
    persistent ones of :func:`reserve`."""
    dev = block_key.device
    _check(block_key, torch.int32, (block_key.shape[0],), "block_key", dev)
    m = active_idx.shape[0]
    _check(active_idx, torch.int32, (m,), "active_idx", dev)
    _check(active_mask, torch.bool, (m,), "active_mask", dev)
    _check(view_matrix, torch.float32, (4, 4), "view", dev)
    if rc.splat_tile < 1:
        raise ValueError("raymarch: splat_tile must be >= 1")
    ty, tx = tiles(cam, rc)
    n = ty * tx
    acc = reserve(dev, n)
    t_min = torch.empty((ty, tx), dtype=torch.float32, device=dev)
    t_max = torch.empty((ty, tx), dtype=torch.float32, device=dev)
    p = _build.ptr
    args = ("ray_bounds",
            (p(block_key), p(active_idx), p(active_mask), m, p(view_matrix),
             cam.width, cam.height, rc.splat_tile, ty, tx,
             int(cfg.world_blocks), float(cam.fx), float(cam.fy),
             float(cam.cx), float(cam.cy), float(cam.depth_min),
             float(cfg.voxel_size), float(cfg.block_size_world),
             float(NEAR_Z), p(acc), p(t_min), p(t_max)),
            (block_key, active_idx, active_mask, view_matrix, acc), dev)
    return args, (t_min, t_max)


def prepare_march(state, pose, cam: CameraConfig, cfg: MapConfig,
                  rc: RaycastConfig, bounds=None):
    """Check the map, the pose and the bounds and make the outputs;
    returns (launch arguments, :class:`MarchHits`)."""
    dev = state.sdf.device
    h_tab = cfg.table_size
    if h_tab < 1 or h_tab & (h_tab - 1):
        raise ValueError("raymarch: the table size must be a power of two")
    n_pool = state.sdf.shape[0]
    _check(state.table_key, torch.int32, (h_tab,), "table_key", dev)
    _check(state.table_val, torch.int32, (h_tab,), "table_val", dev)
    _check(state.sdf, torch.bfloat16, (n_pool, 512), "sdf", dev)
    _check(state.weight, torch.bfloat16, (n_pool, 512), "weight", dev)
    _check(state.color, torch.int32, (n_pool, 512), "color", dev)
    _check(pose, torch.float32, (4, 4), "pose", dev)
    if rc.num_samples < 2:
        raise ValueError("raymarch: the march takes at least 2 samples")
    ty, tx = tiles(cam, rc)
    if bounds is not None:
        _check(bounds[0], torch.float32, (ty, tx), "tile t_min", dev)
        _check(bounds[1], torch.float32, (ty, tx), "tile t_max", dev)
    p_n = cam.height * cam.width
    hits = MarchHits(
        t_hit=torch.empty((p_n,), dtype=torch.float32, device=dev),
        found=torch.empty((p_n,), dtype=torch.bool, device=dev),
        p_hit=torch.empty((p_n, 3), dtype=torch.float32, device=dev),
        color=torch.empty((p_n, 3), dtype=torch.float32, device=dev),
        grad=(torch.empty((p_n, 3), dtype=torch.float32, device=dev)
              if rc.use_gradients else None),
        grad_ok=(torch.empty((p_n,), dtype=torch.bool, device=dev)
                 if rc.use_gradients else None))
    d = rc.derived(cfg)
    p, pn = _build.ptr, _build.ptr_or_null
    args = ("march",
            (p(state.table_key), p(state.table_val), p(state.sdf),
             p(state.weight), p(state.color), h_tab, int(cfg.max_probes),
             int(cfg.world_blocks), float(cfg.voxel_size), p(pose),
             pn(None if bounds is None else bounds[0]),
             pn(None if bounds is None else bounds[1]), cam.width,
             cam.height, rc.splat_tile, tx, rc.num_samples, float(cam.fx),
             float(cam.fy), float(cam.cx), float(cam.cy),
             float(cam.depth_min), float(cam.depth_max),
             float(cfg.truncation), float(rc.num_samples - 1),
             float(d["ray_increment"]), float(d["thres_sample_dist"]),
             float(d["thres_dist"]), float(1e-12), p(hits.t_hit),
             p(hits.found), p(hits.p_hit), p(hits.color),
             pn(hits.grad), pn(hits.grad_ok)),
            (state, pose, bounds), dev)
    return args, hits


def launch(args) -> None:
    """Launch a prepared kernel (:func:`prepare_bounds`:
    ``ray_bounds_kernel``; :func:`prepare_march`: ``raymarch_kernel``) on
    the current stream: the only place that does; counts the launch."""
    kind, kernel_args, _keep, device = args
    lib = _build.library("raymarch")
    stream = _build.stream_ptr(device)
    if kind == "ray_bounds":
        _build.check(lib.vh_ray_bounds(*kernel_args, stream), "raymarch")
        ray_bounds.launches += 1
    else:
        _build.check(lib.vh_raymarch(*kernel_args, stream), "raymarch")
        march.launches += 1


def ray_bounds(block_key, active_idx, active_mask, view_matrix,
               cam: CameraConfig, cfg: MapConfig, rc: RaycastConfig):
    """Per-tile z bounds of the active blocks (see
    :func:`ray_bounds_plain`): the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if _device(block_key, "ray_bounds").type == "cpu":
        return ray_bounds_plain(block_key, active_idx, active_mask,
                                view_matrix, cam, cfg, rc)
    args, out = prepare_bounds(block_key, active_idx, active_mask,
                               view_matrix, cam, cfg, rc)
    launch(args)
    return out


ray_bounds.launches = 0


def march(state, pose, cam: CameraConfig, cfg: MapConfig,
          rc: RaycastConfig, bounds=None) -> MarchHits:
    """The march from ``pose`` over the map, each ray in its interval
    (see :func:`march_plain`): the kernel on a CUDA map, the plain version
    on a CPU map."""
    if _device(state.sdf, "march").type == "cpu":
        return march_plain(state, pose, cam, cfg, rc, bounds)
    args, hits = prepare_march(state, pose, cam, cfg, rc, bounds)
    launch(args)
    return hits


march.launches = 0


# ---------------------------------------------------------------------------
# The bound
# ---------------------------------------------------------------------------

class MarchWork(NamedTuple):
    """What one march does on its data (:func:`work_counts`)."""

    rays: int            # P
    samples: int         # march samples taken (in band, up to a crossing)
    crossed: int         # rays with a crossing: 3 secant samples and a hit
    found: int           # rays with a kept hit (6 gradient samples each)
    lookups: int         # block lookups (the cache missed, key valid)
    probe_rounds: int    # table slots read by those lookups
    slots: int           # distinct table slots read
    rows: int            # distinct pool rows touched (a value read each)
    voxels: int          # distinct voxels read (sdf and weight)
    color_voxels: int    # distinct voxels whose color was read
    tiles: int           # tiles of the bounds read (0 without bounds)
    gradients: bool
    issued: int          # samples the kernel takes, wasted ones included
    chain: int           # the most dependent sample steps of any warp


# f32/int operations, hand-counted from the plain version's ops: a ray's
# set-up (its interval (four), band and step (four), limit (one), direction
# (fourteen)); a sample's position (eight with its t and band test), its
# trilinear core (18: division, floor, casts, fractions) and 8 corners (20
# each: the key and range test, the cache test, the weight (two), its sum
# (two), the validity), the crossing test (five); a color sample's extra
# 8 x 3 channels (four each) and 3 divisions; a lookup's two hashes
# (sixteen) and a probe round (five); a secant step (sixteen); a found
# ray's gradient (24).
RAY_OPS, SAMPLE_OPS, COLOR_OPS = 23, 8 + 18 + 8 * 20 + 5, 8 * 3 * 4 + 3
LOOKUP_OPS, PROBE_OPS, SECANT_OPS, GRADIENT_OPS = 16, 5, 16, 24
# a bounds row: its key unpacked (eight), 8 corners (three world, fifteen
# for the product and translation, six to the screen, five reductions),
# the box's floors and tiles (twelve), the tests (ten); a tile write two
BOUNDS_ROW_OPS, BOUNDS_TILE_OPS = 8 + 8 * (3 + 15 + 6 + 5) + 12 + 10, 2


def bytes_moved(work: MarchWork) -> int:
    """The least bytes one march must move: each table slot it reads (4
    B; 4 B more for the pool row of each key found), each voxel's sdf
    and weight (2 + 2 B) and color (4 B) it reads, the tile bounds (8 B a
    tile), the pose (64 B), and the outputs (t_hit, found, p_hit, color:
    29 B a ray; 13 B more with gradients)."""
    return (4 * work.slots + 4 * work.rows + 4 * work.voxels
            + 4 * work.color_voxels + 8 * work.tiles + 64
            + work.rays * (29 + (13 if work.gradients else 0)))


def operations(work: MarchWork) -> int:
    """Operations of one march on its data."""
    samples = (work.samples + 4 * work.crossed
               + (6 * work.found if work.gradients else 0))
    return (RAY_OPS * work.rays + SAMPLE_OPS * samples
            + COLOR_OPS * work.crossed + LOOKUP_OPS * work.lookups
            + PROBE_OPS * work.probe_rounds + SECANT_OPS * 3 * work.crossed
            + (GRADIENT_OPS * work.found if work.gradients else 0))


def bounds_bytes(m: int, n_active: int, n_tiles: int) -> int:
    """The least bytes of one bounds call: the active list and mask (5 B
    a row), an active row's key (4 B), the view (64 B), the tile grids
    written (8 B a tile)."""
    return 5 * m + 4 * n_active + 64 + 8 * n_tiles


def bounds_operations(n_active: int, n_tile_writes: int) -> int:
    """Operations of one bounds call: ``n_active`` rows projected,
    ``n_tile_writes`` (row, tile) pairs scattered."""
    return BOUNDS_ROW_OPS * n_active + BOUNDS_TILE_OPS * n_tile_writes


def bounds_work(block_key, active_idx, active_mask, view_matrix,
                cam: CameraConfig, cfg: MapConfig, rc: RaycastConfig):
    """(active rows, (row, tile) pairs scattered) of one bounds call, from
    the plain version's per-row box on the inputs' device."""
    ty, tx = tiles(cam, rc)
    blocks = geom.unpack_block_key(block_key[active_idx.long()],
                                   cfg.world_blocks)
    k = torch.arange(8, device=active_idx.device)
    offs = torch.stack([k & 1, (k >> 1) & 1, (k >> 2) & 1], dim=-1)
    corners = geom.block_to_world(blocks, cfg.voxel_size)[:, None, :] \
        + cfg.block_size_world * offs.to(torch.float32)
    p_cam = geom.transform_points(view_matrix, corners)
    uv = geom.camera_to_screen(p_cam, cam)
    t = rc.splat_tile
    lo = torch.floor(torch.amin(uv, dim=1)).to(torch.int32)
    hi = torch.floor(torch.amax(uv, dim=1)).to(torch.int32)
    nmax = torch.tensor([tx - 1, ty - 1], device=lo.device)
    t0 = torch.minimum(torch.clamp(torch.div(lo, t, rounding_mode="floor"),
                                   min=0), nmax)
    t1 = torch.minimum(torch.clamp(torch.div(hi, t, rounding_mode="floor"),
                                   min=0), nmax)
    span = t1 - t0 + 1
    on = ((hi >= 0) & (lo < torch.tensor([cam.width, cam.height],
                                         device=lo.device))).all(dim=1)
    fit = (span <= SPAN).all(dim=1) \
        & (torch.amin(p_cam[..., 2], dim=1) > NEAR_Z)
    writes = torch.where(active_mask & on & fit, span[:, 0] * span[:, 1], 0)
    return int(active_mask.sum()), int(writes.sum())


def _corner_keys(px, py, pz, cfg: MapConfig):
    """Block keys [8, ...] (INVALID_KEY out of the world's range) and
    voxel indices within their blocks of the 8 corners of each sample, in
    the sampler's corner order."""
    vs = cfg.voxel_size
    b = [torch.floor(geom.div_const(q, vs)).to(torch.int32)
         for q in (px, py, pz)]
    half, wb = cfg.world_blocks // 2, cfg.world_blocks
    keys, local = [], []
    for c in range(8):
        v = [b[0] + (c & 1), b[1] + ((c >> 1) & 1), b[2] + ((c >> 2) & 1)]
        g = [torch.div(x, 8, rounding_mode="floor") + half for x in v]
        ok = ((g[0] >= 0) & (g[0] < wb) & (g[1] >= 0) & (g[1] < wb)
              & (g[2] >= 0) & (g[2] < wb))
        keys.append(torch.where(ok, (g[2] * wb + g[1]) * wb + g[0],
                                INVALID_KEY))
        local.append((torch.remainder(v[2], 8) * 8 + torch.remainder(v[1], 8))
                     * 8 + torch.remainder(v[0], 8))
    return torch.stack(keys), torch.stack(local)


def warp_of(cam: CameraConfig, lanes: int):
    """The warp of each ray (flat [P], row-major pixels, int64) in the
    march kernel's layout at ``lanes`` lanes a ray: a CTA of
    ``MARCH_THREADS`` threads walks a tile ``MARCH_TILE_X`` rays wide,
    ray r of the tile (row-major) on lanes r * lanes .. r * lanes + lanes
    - 1. ``lanes`` 1 is one thread a ray on 16 x 16 tiles (the march's
    first design)."""
    tx = 16 if lanes == 1 else MARCH_TILE_X
    ty = MARCH_THREADS // lanes // tx
    y = torch.arange(cam.height)[:, None]
    x = torch.arange(cam.width)[None, :]
    cta = (y // ty) * -(-cam.width // tx) + x // tx
    within = (y % ty) * tx + x % tx
    return (cta * (MARCH_THREADS // 32) + within // (32 // lanes)).reshape(-1)


def ray_steps(n_in, crossed, first, found, lanes: int, gradients: bool):
    """(samples issued, dependent sample steps) of each ray at ``lanes``
    lanes a ray, from its in-band samples ``n_in``, whether it crossed,
    the crossing's first sample and whether its hit was kept (int64 [P]
    and bool [P] tensors). Windows of ``lanes`` samples until the one
    that crosses or leaves the band; three secant steps; then the hit and
    the gradient's six samples, the first ``lanes`` of them at once and
    the rest only for a kept hit."""
    w = lanes
    windows = torch.div(first + 1, w, rounding_mode="floor") + 1
    main = torch.where(crossed, torch.minimum(n_in, windows * w), n_in)
    n_hit = 7 if gradients else 1
    first_step = min(w, n_hit)
    c, f = crossed.to(torch.int64), (found & crossed).to(torch.int64)
    issued = main + 3 * c + first_step * c + (n_hit - first_step) * f
    steps = (torch.div(main + w - 1, w, rounding_mode="floor") + 4 * c
             + (-(-n_hit // w) - 1) * f)
    return issued, steps


def work_counts(state, pose, cam: CameraConfig, cfg: MapConfig,
                rc: RaycastConfig, bounds=None,
                lanes: int = MARCH_LANES) -> MarchWork:
    """What the march does on these inputs, from the plain version's
    samples on the map's device. The bound's basis, whatever implements
    it: the samples the plain algorithm needs (each ray in band, up to its
    first crossing's second sample, then the secant, hit and gradient
    samples), the lookups a last-block cache misses on them in the
    corners' order, their probe rounds, and the distinct slots, rows and
    voxels they read. The kernel at ``lanes`` lanes a ray
    (:func:`ray_steps`, :func:`warp_of`): the samples it issues, and the
    most dependent sample steps of any of its warps."""
    from .. import raycast
    t_min, t_max = ray_interval(bounds, pose.device, cam, cfg, rc)
    rec = []

    def sample_soa(px, py, pz, with_color=False):
        out = raycast.trilinear_sample_soa(state, px, py, pz, cfg,
                                           with_color=with_color)
        rec.append((px, py, pz, out[0], out[1]))
        return out

    d = rc.derived(cfg)
    hits = raycast.march_hits(sample_soa, pose, cam, t_min, t_max,
                              rc.num_samples, d["ray_increment"],
                              d["thres_sample_dist"], d["thres_dist"])
    dev = t_min.device
    s_n = rc.num_samples
    band = torch.clamp(t_max - t_min, min=0.0)
    dt = torch.clamp(geom.div_const(band, s_n - 1), min=d["ray_increment"])
    si = torch.arange(s_n, dtype=torch.float32, device=dev)[:, None]
    ts = t_min[None, :] + si * dt[None, :]
    in_band = ts <= (t_max[None, :] + dt[None, :])
    mx, my, mz, sdf_s, ok_s = rec[0]
    ok_s = ok_s & in_band
    cross = (ok_s[:-1] & ok_s[1:] & (sdf_s[:-1] > 0.0) & (sdf_s[1:] < 0.0)
             & (sdf_s[:-1] - sdf_s[1:] < d["thres_sample_dist"]))
    crossed = torch.any(cross, dim=0)
    first = torch.argmax(cross.to(torch.int8), dim=0)
    last = torch.where(crossed, first + 1, s_n - 1)
    taken_main = in_band & (si.to(torch.int64) <= last[None, :])
    found = hits.found
    # the kernel's sample order: march, 3 secants, the hit, 6 gradients
    pts = [(mx, my, mz)] + [r[:3] for r in rec[1:5]]
    taken = [taken_main] + [crossed[None, :]] * 4
    if rc.use_gradients:
        ph = hits.p_hit
        for ax in range(3):
            for sign in (1.0, -1.0):
                e = torch.zeros(3, dtype=torch.float32, device=dev)
                e[ax] = cfg.voxel_size
                q = ph + e if sign > 0 else ph - e
                pts.append((q[:, 0], q[:, 1], q[:, 2]))
                taken.append(found[None, :])
    keys, local, valid, color = [], [], [], []
    for i, (x, y, z) in enumerate(pts):
        k, l = _corner_keys(x.reshape(-1, x.shape[-1]),
                            y.reshape(-1, y.shape[-1]),
                            z.reshape(-1, z.shape[-1]), cfg)   # [8, n, P]
        keys.append(k.transpose(0, 1).reshape(-1, k.shape[-1]))
        local.append(l.transpose(0, 1).reshape(-1, l.shape[-1]))
        tk = taken[i].expand(k.shape[1], -1)
        valid.append(tk.repeat_interleave(8, dim=0))
        color.append(torch.full_like(valid[-1], i == 4))
    keys, local = torch.cat(keys), torch.cat(local)            # [K*8, P]
    valid, color = torch.cat(valid), torch.cat(color) & torch.cat(valid)
    # the key of each entry's previous valid entry along the ray
    n_e = keys.shape[0]
    pos = torch.arange(n_e, device=dev)[:, None].expand(-1, keys.shape[1])
    lastv = torch.cummax(torch.where(valid, pos, -1), dim=0).values
    prev = torch.cat([torch.full_like(lastv[:1], -1), lastv[:-1]])
    prev_key = torch.gather(keys, 0, prev.clamp(min=0))
    miss = valid & ((prev < 0) | (prev_key != keys))
    need = miss & (keys != INVALID_KEY)
    q = keys[need].to(torch.int32)
    from .. import blockmap
    hashes = blockmap._hashes(q)
    alive = torch.ones_like(q, dtype=torch.bool)
    rounds = torch.zeros_like(q, dtype=torch.int64)
    slots = []
    for r in range(cfg.max_probes):
        slot = blockmap._slot(hashes, r, cfg.table_size)
        tk = state.table_key[slot]
        rounds += alive.to(torch.int64)
        slots.append(slot[alive])
        alive = alive & (tk != q) & (tk != INVALID_KEY)
    # rows and voxels: every valid entry's corner, through the lookup
    row, hit = blockmap.lookup(state, torch.where(valid, keys, INVALID_KEY),
                               cfg)
    read = valid & hit
    lin = row.to(torch.int64) * 512 + local
    n_in = in_band.sum(dim=0)
    issued, steps = ray_steps(n_in, crossed, first, found, lanes,
                              bool(rc.use_gradients))
    warp = warp_of(cam, lanes).to(dev)
    per_warp = torch.zeros(int(warp.max()) + 1, dtype=torch.int64,
                           device=dev).scatter_reduce_(0, warp, steps, "amax")
    return MarchWork(
        rays=int(t_min.numel()), samples=int(taken_main.sum()),
        crossed=int(crossed.sum()), found=int(found.sum()),
        lookups=int(need.sum()), probe_rounds=int(rounds.sum()),
        slots=int(torch.unique(torch.cat(slots)).numel()),
        rows=int(torch.unique(row[read]).numel()),
        voxels=int(torch.unique(lin[read]).numel()),
        color_voxels=int(torch.unique(lin[read & color]).numel()),
        tiles=0 if bounds is None else int(bounds[0].numel()),
        gradients=bool(rc.use_gradients), issued=int(issued.sum()),
        chain=int(per_warp.max()))


# ---------------------------------------------------------------------------
# An edge bank: the maps and views where the kernels go wrong first
# ---------------------------------------------------------------------------

EDGE_CASES = ("tilted_plane", "overflow_behind", "overflow_near",
              "crossing_pairs", "zero_plateau", "jump", "tiny_denom",
              "world_edge", "no_active", "crowded_tile", "near_plane")
TINY_SDF = 2.0 ** -44     # two of them differ by less than 1e-12


def _edge_cam(depth_min, depth_max):
    # the principal point on a pixel: that ray runs along the view axis
    return CameraConfig(width=24, height=16, fx=20.0, fy=20.0, cx=12.0,
                        cy=8.0, depth_min=depth_min, depth_max=depth_max)


def _edge_cfg(**kw):
    base = dict(voxel_size=0.02, truncation=0.06, truncation_scale=0.0,
                num_blocks=2048, table_size=4096, max_active_blocks=2048,
                world_blocks=1024)
    base.update(kw)
    return MapConfig(**base)


def _box(x, y, z):
    g = np.stack(np.meshgrid(np.arange(*x), np.arange(*y), np.arange(*z),
                             indexing="ij"), -1).reshape(-1, 3)
    return [tuple(b) for b in g]


def _layers(vz, bounds, values):
    """sdf by voxel z index: ``values[i]`` up to ``bounds[i]`` (inclusive),
    the last value beyond."""
    out = np.full(vz.shape, values[-1], np.float32)
    for b, v in zip(bounds[::-1], values[-2::-1]):
        out[vz <= b] = v
    return out


def _edge_table(keys, cfg: MapConfig, tombstones: bool = True):
    """The hash table of ``keys`` (row i holds keys[i]); with
    ``tombstones`` every third key is placed past a tombstone of its own
    probe chain."""
    tk = np.full(cfg.table_size, INVALID_KEY, np.int32)
    tv = np.zeros(cfg.table_size, np.int32)
    from .hash_table import probe_slots
    for row, key in enumerate(keys):
        tomb = tombstones and row % 3 == 0
        for r in range(cfg.max_probes):
            s = probe_slots(np.array([key]), r, cfg.table_size)[0]
            if tk[s] != INVALID_KEY:
                continue
            if tomb:
                tk[s], tomb = TOMBSTONE, False
                continue
            tk[s], tv[s] = key, row
            break
        else:
            raise RuntimeError("raymarch edge bank: a key found no slot")
    return tk, tv


def _edge_map(cfg: MapConfig, blocks, field, rng, tombstones: bool = True):
    """A map holding ``blocks`` (block coordinates, rows in order) whose
    voxels take ``field(vx, vy, vz) -> (sdf, weight)`` (voxel indices;
    sdf rounded to bf16 when the map is made), with random colors."""
    b = np.asarray(blocks, np.int64)
    half, wb = cfg.world_blocks // 2, cfg.world_blocks
    g = b + half
    keys = ((g[:, 2] * wb + g[:, 1]) * wb + g[:, 0]).astype(np.int32)
    tk, tv = _edge_table(keys, cfg, tombstones)
    loc = np.arange(512)
    v = [b[:, a, None] * 8 + (loc >> (3 * a)) % 8 for a in range(3)]
    sdf, w = field(*v)
    n, cap = len(b), cfg.num_blocks
    pool = np.zeros((cap, 512), np.float32)
    weight = np.zeros((cap, 512), np.float32)
    color = np.zeros((cap, 512), np.int32)
    pool[:n], weight[:n] = sdf, w
    color[:n] = rng.integers(0, 1 << 24, (n, 512))
    block_key = np.full(cap, INVALID_KEY, np.int32)
    block_key[:n] = keys
    return {"table_key": tk, "table_val": tv, "block_key": block_key,
            "sdf": pool, "weight": weight, "color": color, "n": n}


def edge_bank(seed: int = 17):
    """Seeded maps and views with the cases the kernels get wrong first,
    each a dict: ``case``, ``cam``, ``cfg``, ``rc`` (march mode; run it
    with ``use_gradients`` both ways), ``pose`` ([4,4] f32), ``map``
    (numpy arrays, :func:`edge_inputs` makes the ``MapState``) and
    ``active`` ("all": every row active, with masked padding; "none": all
    masked; None: no active list, the camera's range). A 24x16 camera.
    Every table puts every third key past a tombstone of its probe chain.

    * "tilted_plane": a rotated view of a tilted plane over part of the
      screen (untouched tiles; corners in unallocated blocks at the box's
      edges);
    * "overflow_behind": a block behind the camera on screen is the only
      one that overflows: the global z max is negative;
    * "overflow_near" (2-pixel tiles): a near block spans more than 4
      tiles, one behind the camera clamps the global z min, and one has
      corners at z = 0 (infinite and NaN projections, off screen);
    * "crossing_pairs" (8 samples, no bounds): the first crossing at the
      first sample pair on the left, at the last pair on the right, and a
      column of unallocated blocks;
    * "zero_plateau" (16 samples): sdf exactly 0 over 15 voxels (no
      crossing) on the left, over 2 on the right (a secant sample, the hit
      and the next denominator are exactly 0);
    * "jump" (1/64 m voxels, exact sample positions on the central ray):
      a jump of exactly the f32 ``thres_sample_dist`` (1.0, 1.000000005 in
      f64: not a crossing), one above it, and a crossing after them;
    * "tiny_denom": sdf +-2^-44 (|denom| <= 1e-12 at every secant step)
      on the left; on the right a two-voxel layer of zero weight between
      the crossing's samples (every secant sample and the hit invalid);
    * "world_edge" (a 16-block world): rays that leave the world's range
      (INVALID_KEY corners) and never cross;
    * "no_active": every active row masked: every tile untouched;
    * "crowded_tile": 128 blocks far off on one 16-pixel tile (every lane
      of each warp of the bounds kernel on one tile, the other untouched);
    * "near_plane" (4-pixel tiles): a plane of blocks and two blocks whose
      z ranges cross the near plane (finite projections on both sides),
      which widen every tile."""
    rng = np.random.default_rng(seed)
    out = []

    def plane_z(z0, trunc, vs):
        def field(vx, vy, vz):
            return (np.clip(z0 - vz * vs, -trunc, trunc).astype(np.float32),
                    np.ones(vz.shape, np.float32))
        return field

    def halves(left, right):
        def field(vx, vy, vz):
            sl, wl = left(vx, vy, vz)
            sr, wr = right(vx, vy, vz)
            return np.where(vx < 0, sl, sr), np.where(vx < 0, wl, wr)
        return field

    def layered(bounds, values, zero_weight=()):
        def field(vx, vy, vz):
            w = np.ones(vz.shape, np.float32)
            for k in zero_weight:
                w[vz == k] = 0.0
            return _layers(vz, bounds, values), w
        return field

    for case in EDGE_CASES:
        cam = _edge_cam(0.2, 3.0)
        cfg = _edge_cfg()
        rc = RaycastConfig(mode="march")
        pose = np.eye(4, dtype=np.float32)
        active = "all"
        if case == "tilted_plane":
            nrm = np.array([0.2, 0.1, -1.0]) / np.linalg.norm([0.2, 0.1,
                                                                -1.0])

            def field(vx, vy, vz, nrm=nrm):
                p = np.stack([vx, vy, vz], -1) * cfg.voxel_size
                dist = (p - np.array([0.0, 0.0, 1.0])) @ nrm
                w = np.where(dist < -0.2, 0.0, 1.0).astype(np.float32)
                return (np.clip(dist, -0.06, 0.06).astype(np.float32), w)
            blocks = _box((-4, 2), (-3, 3), (4, 9))
            a, c = 0.1, -0.05
            ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                           [-np.sin(a), 0, np.cos(a)]])
            rx = np.array([[1, 0, 0], [0, np.cos(c), -np.sin(c)],
                           [0, np.sin(c), np.cos(c)]])
            pose[:3, :3] = ry @ rx
            pose[:3, 3] = (0.05, -0.03, 0.02)
            rc = RaycastConfig(mode="march", splat_tile=4)
        elif case in ("overflow_behind", "overflow_near", "no_active"):
            field = plane_z(1.0, 0.06, cfg.voxel_size)
            # the right fifth of the screen holds no block
            blocks = _box((-3, 1), (-2, 2), (5, 8)) + [(0, 0, -2)]
            if case == "overflow_near":
                blocks += [(-1, -1, 2), (1, 0, 0)]
            rc = RaycastConfig(mode="march",
                               splat_tile=2 if case == "overflow_near"
                               else 4)
            active = "none" if case == "no_active" else "all"
        elif case == "crossing_pairs":
            cam = _edge_cam(0.2, 1.0)
            field = halves(layered([11], [0.05, -0.05]),
                           layered([46], [0.05, -0.05]))
            blocks = [b for b in _box((-5, 5), (-4, 4), (0, 8))
                      if (b[0], b[1]) != (2, 1)]
            rc = RaycastConfig(mode="march", num_samples=8)
            active = None
        elif case == "zero_plateau":
            cam = _edge_cam(0.2, 1.0)
            field = halves(layered([20, 35], [0.05, 0.0, -0.05]),
                           layered([20, 22], [0.05, 0.0, -0.05]))
            blocks = _box((-5, 5), (-4, 4), (0, 8))
            rc = RaycastConfig(mode="march", num_samples=16)
            active = None
        elif case == "jump":
            cam = _edge_cam(0.25, 1.125)
            cfg = _edge_cfg(voxel_size=0.015625, truncation=0.0625)
            field = halves(layered([44, 60, 68], [0.75, -0.75, 0.25, -0.25]),
                           layered([44, 60, 68], [0.5, -0.5, 0.25, -0.25]))
            blocks = _box((-6, 6), (-4, 4), (0, 10))
            rc = RaycastConfig(mode="march", num_samples=8,
                               thres_sample_dist_factor=20.0000001)
            active = None
        elif case == "tiny_denom":
            cam = _edge_cam(0.2, 1.0)
            cfg = _edge_cfg(truncation=0.1)
            field = halves(layered([23], [TINY_SDF, -TINY_SDF]),
                           layered([23, 25], [0.05, 0.0, -0.05],
                                   zero_weight=(24, 25)))
            blocks = _box((-5, 5), (-4, 4), (0, 8))
            rc = RaycastConfig(mode="march", num_samples=8)
            active = None
        elif case == "crowded_tile":
            field = plane_z(2.4, 0.06, cfg.voxel_size)
            blocks = _box((-2, 2), (-2, 2), (12, 20))
            rc = RaycastConfig(mode="march", splat_tile=16)
        elif case == "near_plane":
            field = plane_z(1.0, 0.06, cfg.voxel_size)
            blocks = _box((-3, 1), (-2, 2), (5, 8)) + [(0, 0, 0),
                                                       (-1, -1, 0)]
            pose[:3, 3] = (0.01, 0.02, 0.05)
            rc = RaycastConfig(mode="march", splat_tile=4)
        else:                                           # world_edge
            cfg = _edge_cfg(world_blocks=16)
            field = halves(plane_z(1.0, 0.06, cfg.voxel_size),
                           layered([0], [0.05, 0.05]))
            blocks = _box((-6, 6), (-4, 4), (0, 8))
            active = None
        out.append({"case": case, "cam": cam, "cfg": cfg, "rc": rc,
                    "pose": pose, "map": _edge_map(cfg, blocks, field, rng),
                    "active": active})
    return out


def edge_inputs(e, device):
    """(MapState, pose, active_idx, active_mask) of an edge case on
    ``device``; the active list is None for a case without one. The map's
    sdf and weight are rounded to bf16 here."""
    from ..blockmap import MapState
    m, cfg = e["map"], e["cfg"]
    n, cap = m["n"], cfg.num_blocks

    def t(a, dtype=None):
        x = torch.from_numpy(np.ascontiguousarray(a))
        return (x if dtype is None else x.to(dtype)).to(device)

    state = MapState(
        table_key=t(m["table_key"]), table_val=t(m["table_val"]),
        block_key=t(m["block_key"]), sdf=t(m["sdf"], torch.bfloat16),
        weight=t(m["weight"], torch.bfloat16), color=t(m["color"]),
        surf=t(np.zeros(cap, bool)),
        free_stack=t(np.r_[np.arange(cap - 1, n - 1, -1),
                           np.zeros(n)].astype(np.int32)),
        n_free=t(np.array(cap - n, np.int32)),
        n_tombstones=t(np.array((m["table_key"] == TOMBSTONE).sum(),
                                np.int32)),
        dense_upto=t(np.array(n, np.int32)))
    pose = t(e["pose"])
    if e["active"] is None:
        return state, pose, None, None
    pad = 5                                     # masked entries at row 0
    idx = np.r_[np.arange(n), np.zeros(pad)].astype(np.int32)
    mask = np.r_[np.full(n, e["active"] == "all"), np.zeros(pad, bool)]
    return state, pose, t(idx), t(mask)
