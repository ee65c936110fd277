"""The allocator's candidate keys: a 3D-DDA through block space over each
ray's truncation band, the neighbour-shift dedup and the per-column rank
fold (``csrc/alloc_candidates.cu``).

No TPU kernel: the JAX package runs this step as XLA
(``voxelhashing_tpu/integrate.py:39`` ``_dda_band_keys``, :137
``_dedup_and_fold``, :177 ``alloc_candidates``). The plain versions here
are those functions op for op (the CPU path, and the reference on the
card); ``integrate.alloc_candidates`` keeps its name and reaches
:func:`alloc_candidates`.

On a CUDA tensor :func:`alloc_candidates` is one launch of
``alloc_candidates_kernel`` a frame (in place of ~1,500 small torch
launches), whose flat int32 keys equal the plain version's position for
position (``blockmap.allocate`` assigns pool slots by prefix rank, so the
order is part of the map). The tile phase reaches the kernel as a host int
or, under ``engine.make_step``, by pointer to the device int32 scalar, so
a captured graph reads each frame's. The wrapper decides the launch: the
instantiation (:data:`KERNELS`, :func:`kernel_index`), the grid
(:func:`cta_grid`) and whether tile mode stages its footprint in shared
memory (tiles up to :data:`STAGE_TILE`; a larger tile pools from global
memory); the kernel's entry point checks that the choice fits its source.
On a CPU tensor the wrapper runs the plain version; any other device
raises. There is no fallback.

:func:`prepare` checks the inputs and makes the output, :func:`launch`
issues the kernel on the current stream (the only place that does; it
adds one to ``alloc_candidates.launches``, and to
``alloc_candidates.by_kernel`` under the instantiation it passed). The
plain version counts its
calls on CUDA tensors (``alloc_candidates_plain.cuda_calls``). The least
time of a launch is the larger of :func:`bytes_moved` over the memory rate
and :func:`operations` over the f32 rate.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from . import _build
from .. import geometry as geom
from ..config import CameraConfig, MapConfig, SDF_BLOCK_SIZE
from ..geometry import INVALID_KEY

MAX_STEPS = 16                      # csrc: alloc_steps up to 16
DEFAULT_STEPS = 8                   # csrc kDefaultSteps: a template
BLOCK = {2: (4, 8), 1: (4, 16)}     # csrc Geo: a CTA's (rows, cols) by rays
# the largest tile whose footprint (and the keys of 16 steps) fits the
# 227 KB of shared memory an H100 CTA may opt in to: 214,084 + 5,808 B
STAGE_TILE = 30
# vh_alloc_candidates's instantiations, by the index the wrapper passes
KERNELS = ("alloc_candidates_kernel<2, 8>", "alloc_candidates_kernel<2, 0>",
           "alloc_candidates_kernel<1, 8>", "alloc_candidates_kernel<1, 0>")
ARG_KERNEL, ARG_GRID, ARG_STAGE = 29, 30, 32    # in the launch arguments


# ---------------------------------------------------------------------------
# The plain version (the CPU path; the reference on the card)
# ---------------------------------------------------------------------------

def _dda_band_keys(d, valid, xn, yn, pose, cfg: MapConfig):
    """Keys [alloc_steps, P] of the blocks the band [d-t, d+t] along each
    ray (xn, yn, 1) crosses; reference tie order x, z, y. Invalid entries
    are INVALID_KEY."""
    maxd = cfg.max_integration_distance
    valid = valid & torch.isfinite(d) & (d > 0.0) & (d < maxd)
    d = torch.where(valid, d, 1.0)

    t = cfg.truncation_at(d)
    min_d = torch.clamp(d - t, max=maxd)
    max_d = torch.clamp(d + t, max=maxd)
    valid = valid & (min_d < max_d)

    r, tr = pose[:3, :3], pose[:3, 3]

    def to_world(depth_along):
        cx_, cy_, cz_ = xn * depth_along, yn * depth_along, depth_along
        return (r[0, 0] * cx_ + r[0, 1] * cy_ + r[0, 2] * cz_ + tr[0],
                r[1, 0] * cx_ + r[1, 1] * cy_ + r[1, 2] * cz_ + tr[1],
                r[2, 0] * cx_ + r[2, 1] * cy_ + r[2, 2] * cz_ + tr[2])

    ox, oy, oz = to_world(min_d)
    ex, ey, ez = to_world(max_d)
    dx, dy, dz = ex - ox, ey - oy, ez - oz
    rl = torch.clamp(torch.sqrt(dx * dx + dy * dy + dz * dz), min=1e-12)
    dx, dy, dz = dx / rl, dy / rl, dz / rl

    block_world = cfg.block_size_world
    vs = cfg.voxel_size

    def block_of(p):
        q = geom.div_const(p, vs)
        return torch.div((q + torch.sign(q) * 0.5).to(torch.int32),
                         SDF_BLOCK_SIZE, rounding_mode="floor")

    def axis_setup(c, e, o, dirc):
        step = torch.sign(dirc).to(torch.int32)
        boundary = (c + torch.clamp(step, 0, 1)).to(torch.float32) \
            * block_world - 0.5 * vs
        safe = torch.where(dirc == 0.0, 1e-12, dirc)
        t_max = (boundary - o) / safe
        t_delta = (step.to(torch.float32) * block_world) / safe
        degen = (dirc == 0.0) | (boundary - o == 0.0)
        return (step, torch.where(degen, torch.inf, t_max),
                torch.where(degen, torch.inf, t_delta), e + step)

    cx_, cy_, cz_ = block_of(ox), block_of(oy), block_of(oz)
    sx, tmx, tdx, bx = axis_setup(cx_, block_of(ex), ox, dx)
    sy, tmy, tdy, by = axis_setup(cy_, block_of(ey), oy, dy)
    sz, tmz, tdz, bz = axis_setup(cz_, block_of(ez), oz, dz)

    half = cfg.world_blocks // 2
    wb = cfg.world_blocks
    alive = valid
    keys = []
    for _ in range(cfg.alloc_steps):
        gx, gy, gz = cx_ + half, cy_ + half, cz_ + half
        ok = alive & (gx >= 0) & (gx < wb) & (gy >= 0) & (gy < wb) \
            & (gz >= 0) & (gz < wb)
        keys.append(torch.where(ok, (gz * wb + gy) * wb + gx, INVALID_KEY))
        takex = (tmx < tmy) & (tmx < tmz)
        takez = ~takex & (tmz < tmy)
        takey = ~takex & ~takez
        cx_ = cx_ + torch.where(takex, sx, 0)
        cy_ = cy_ + torch.where(takey, sy, 0)
        cz_ = cz_ + torch.where(takez, sz, 0)
        hit_bound = (takex & (cx_ == bx)) | (takey & (cy_ == by)) \
            | (takez & (cz_ == bz))
        tmx = torch.where(takex, tmx + tdx, tmx)
        tmy = torch.where(takey, tmy + tdy, tmy)
        tmz = torch.where(takez, tmz + tdz, tmz)
        alive = alive & ~hit_bound
    return torch.stack(keys).to(torch.int32)


def _dedup_and_fold(k3, fold: int):
    """West/north neighbour-shift dedup over the [S, h, w] key grid, then
    per-column rank-fold into the first ``fold`` step slots. Returns flat
    int32[fold * h * w] (or [S * h * w] when no fold applies)."""
    s, h, w = k3.shape
    west = torch.cat([torch.full((s, h, 1), INVALID_KEY, dtype=k3.dtype,
                                 device=k3.device), k3[:, :, :-1]], dim=2)
    north = torch.cat([torch.full((s, 1, w), INVALID_KEY, dtype=k3.dtype,
                                  device=k3.device), k3[:, :-1, :]], dim=1)
    dup = ((k3 == west) | (k3 == north)) & (k3 != INVALID_KEY)
    k3 = torch.where(dup, INVALID_KEY, k3)
    if fold < s:
        k2 = k3.reshape(s, h * w)
        vmask = k2 != INVALID_KEY
        rank = torch.cumsum(vmask, 0, dtype=torch.int32) - 1
        out = [torch.amin(torch.where(vmask & (rank == j), k2, INVALID_KEY),
                          dim=0) for j in range(fold)]
        return torch.stack(out).reshape(-1)
    return k3.reshape(-1)


def tile_mode(depth, tile: int) -> bool:
    """Whether ``tile`` pools the frame: tile > 1 and dividing both sides
    (else one ray a pixel)."""
    h, w = depth.shape
    return tile > 1 and h % tile == 0 and w % tile == 0


def _tile_rays(depth, cam: CameraConfig, cfg: MapConfig, tile: int,
               phase=None, model_depth=None):
    """Tile mode's two rays a tile: (dmin, dmax, any_v, xn, yn) [ht * wt],
    the band depths over the rotated pooling grid (``phase``) after the
    novelty mask (``model_depth``) and the tile centres' directions."""
    h, w = depth.shape
    dev = depth.device
    ht, wt = h // tile, w // tile
    pv = torch.isfinite(depth) & (depth > 0.0) \
        & (depth < cfg.max_integration_distance)
    if model_depth is not None:
        agree = (torch.isfinite(model_depth)
                 & (torch.abs(depth - model_depth)
                    < 0.5 * cfg.truncation_at(depth)))
        pv = pv & ~agree
    lo = torch.where(pv, depth, torch.inf)
    hi = torch.where(pv, depth, -torch.inf)
    py = px = 0
    if isinstance(phase, torch.Tensor):
        p = phase.to(torch.int64)
        py = torch.remainder(p, tile)
        px = torch.remainder(torch.div(p, tile, rounding_mode="floor"),
                             tile)
        rows = torch.arange(h, device=dev)
        cols = torch.arange(w, device=dev)
        # torch.roll by (-py, -px) as a gather
        ridx = torch.remainder(rows + py, h)
        cidx = torch.remainder(cols + px, w)
        lo = lo[ridx][:, cidx]
        hi = hi[ridx][:, cidx]
        wrap = (rows[:, None] >= h - py) | (cols[None, :] >= w - px)
        lo = torch.where(wrap, torch.inf, lo)
        hi = torch.where(wrap, -torch.inf, hi)
        px, py = px.to(torch.float32), py.to(torch.float32)
    elif phase is not None:
        py = int(phase) % tile
        px = (int(phase) // tile) % tile
        lo = torch.roll(lo, shifts=(-py, -px), dims=(0, 1))
        hi = torch.roll(hi, shifts=(-py, -px), dims=(0, 1))
        rows = torch.arange(h, device=dev)[:, None]
        cols = torch.arange(w, device=dev)[None, :]
        wrap = (rows >= h - py) | (cols >= w - px)
        lo = torch.where(wrap, torch.inf, lo)
        hi = torch.where(wrap, -torch.inf, hi)
        px, py = float(px), float(py)
    for sl in (lambda a, o: a[:, o::tile], lambda a, o: a[o::tile, :]):
        lo = torch.amin(torch.stack([sl(lo, o) for o in range(tile)]), 0)
        hi = torch.amax(torch.stack([sl(hi, o) for o in range(tile)]), 0)
    dmin = lo.reshape(-1)
    dmax = hi.reshape(-1)
    any_v = torch.isfinite(dmin)
    dmin = torch.where(any_v, dmin, 1.0)
    dmax = torch.where(any_v, dmax, 1.0)
    uc = (torch.arange(wt, dtype=torch.float32, device=dev) + 0.5) \
        * tile - 0.5 + px
    vc = (torch.arange(ht, dtype=torch.float32, device=dev) + 0.5) \
        * tile - 0.5 + py
    u = uc[None, :].expand(ht, wt).reshape(-1)
    v = vc[:, None].expand(ht, wt).reshape(-1)
    xn = geom.div_const(u - cam.cx, cam.fx)
    yn = geom.div_const(v - cam.cy, cam.fy)
    return dmin, dmax, any_v, xn, yn


def alloc_candidates_plain(depth, pose, cam: CameraConfig, cfg: MapConfig,
                           tile: int = 1, phase=None, model_depth=None):
    """Block keys touched by the truncation bands of a depth frame.

    ``tile=1``: one DDA ray per pixel (exact, offline replay). ``tile>1``:
    two rays (min- and max-depth band) per ``tile x tile`` tile, the grid
    origin rotated by ``phase`` (the frame counter: a host int, or a device
    int32 scalar, which gives the same keys with no host read: the roll is
    then a gather and the offset an f32 add of the same small integer).
    ``model_depth``: drop pixels whose depth agrees with the model within
    half a truncation (novelty-driven online allocation).
    Returns flat int32 keys; invalid entries are INVALID_KEY.
    """
    if depth.device.type == "cuda":
        alloc_candidates_plain.cuda_calls += 1
    h, w = depth.shape
    dev = depth.device
    if tile > 1 and h % tile == 0 and w % tile == 0:
        ht, wt = h // tile, w // tile
        dmin, dmax, any_v, xn, yn = _tile_rays(depth, cam, cfg, tile,
                                               phase, model_depth)
        s = cfg.alloc_steps
        ka3 = _dda_band_keys(dmin, any_v, xn, yn, pose,
                             cfg).reshape(s, ht, wt)
        kb3 = _dda_band_keys(dmax, any_v, xn, yn, pose,
                             cfg).reshape(s, ht, wt)
        dup = kb3 == ka3
        dup |= kb3 == torch.cat([ka3[1:], ka3[:1]], dim=0)
        dup |= kb3 == torch.cat([ka3[-1:], ka3[:-1]], dim=0)
        kb3 = torch.where(dup & (kb3 != INVALID_KEY), INVALID_KEY, kb3)
        k3 = torch.cat([ka3, kb3], dim=0)
        return _dedup_and_fold(k3, min(cfg.alloc_fold_tile, 2 * s))

    d = depth.reshape(-1)
    valid = torch.ones(d.shape, dtype=torch.bool, device=dev)
    u, v = geom.pixel_grid(w, h, dev)
    xn = geom.div_const(u.reshape(-1) - cam.cx, cam.fx)
    yn = geom.div_const(v.reshape(-1) - cam.cy, cam.fy)
    keys = _dda_band_keys(d, valid, xn, yn, pose, cfg)
    k3 = keys.reshape(cfg.alloc_steps, h, w)
    return _dedup_and_fold(k3, min(cfg.alloc_fold, cfg.alloc_steps))


alloc_candidates_plain.cuda_calls = 0


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

def layout(depth, cfg: MapConfig, tile: int):
    """(tile mode, rows, cols, slots a column, rank-folded) of the output
    for a frame shaped like ``depth``: its keys are [slots, rows, cols]
    flattened."""
    h, w = depth.shape
    s = cfg.alloc_steps
    if tile_mode(depth, tile):
        total, fold = 2 * s, min(cfg.alloc_fold_tile, 2 * s)
        rows, cols = h // tile, w // tile
    else:
        total, fold = s, min(cfg.alloc_fold, s)
        rows, cols = h, w
    compact = fold < total
    return tile_mode(depth, tile), rows, cols, (fold if compact
                                                else total), compact


def footprint(tile: int):
    """(rows, cols) of the pixels a tile-mode CTA stages (csrc
    ``footprint``): every pixel that some phase pools for its columns and
    their west/north halo. Staged for tiles up to :data:`STAGE_TILE`."""
    r, c = BLOCK[2]
    return (r + 1) * tile + tile - 1, (c + 1) * tile + tile - 1


def cta_grid(rows: int, cols: int, tiled: bool):
    """(CTAs down, CTAs across) of a launch over a rows x cols key grid:
    :data:`BLOCK`'s columns a CTA."""
    r, c = BLOCK[2 if tiled else 1]
    return -(-rows // r), -(-cols // c)


def kernel_index(tiled: bool, cfg: MapConfig) -> int:
    """The instantiation a frame launches (its index in :data:`KERNELS`):
    ``alloc_candidates_kernel<2, .>`` in tile mode, ``<1, .>`` in pixel
    mode; ``8`` for the default 8 steps a ray, ``0`` for any other count."""
    return (0 if tiled else 2) + (cfg.alloc_steps != DEFAULT_STEPS)


def _device(t):
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"alloc_candidates: no kernel for {dev}")
    return dev


def _map(t, h, w, what):
    if t.dtype != torch.float32 or tuple(t.shape) != (h, w):
        raise ValueError(f"alloc_candidates: {what} must be f32 {(h, w)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    return t.stride()


def prepare(depth, pose, cam: CameraConfig, cfg: MapConfig, tile: int = 1,
            phase=None, model_depth=None):
    """Check the inputs and make the output int32 [slots * rows * cols]
    (:func:`layout`); returns (launch arguments, keys)."""
    dev = depth.device
    if depth.ndim != 2:
        raise ValueError("alloc_candidates: depth must be [h, w]")
    h, w = depth.shape
    d_s = _map(depth, h, w, "depth")
    if not 1 <= cfg.alloc_steps <= MAX_STEPS:
        raise ValueError(f"alloc_candidates: the kernel walks 1 to "
                         f"{MAX_STEPS} steps a ray, got {cfg.alloc_steps}")
    if pose.dtype != torch.float32 or tuple(pose.shape) != (4, 4) \
            or pose.device != dev:
        raise ValueError("alloc_candidates: pose must be f32 [4,4] on the "
                         "depth's device")
    pose = pose.contiguous()
    tiled, rows, cols, slots, compact = layout(depth, cfg, tile)
    md, m_s = None, (0, 0)
    phase_t, px, py = None, 0, 0
    if tiled:
        if model_depth is not None:
            if model_depth.device != dev:
                raise ValueError("alloc_candidates: model depth on the "
                                 "depth's device")
            md, m_s = model_depth, _map(model_depth, h, w, "model depth")
        if isinstance(phase, torch.Tensor):
            if phase.dtype != torch.int32 or phase.numel() != 1 \
                    or phase.device != dev:
                raise ValueError("alloc_candidates: a device phase must be "
                                 "one int32 on the depth's device")
            phase_t = phase
        elif phase is not None:
            py = int(phase) % tile
            px = (int(phase) // tile) % tile
    keys = torch.empty((slots * rows * cols,), dtype=torch.int32, device=dev)
    p, pn = _build.ptr, _build.ptr_or_null
    args = (p(depth), *d_s, h, w, pn(md), *m_s, p(pose), pn(phase_t),
            tile if tiled else 1, rows, cols, cfg.alloc_steps, slots,
            int(compact), px, py, float(cam.fx), float(cam.fy),
            float(cam.cx), float(cam.cy),
            float(cfg.max_integration_distance), float(cfg.truncation),
            float(cfg.truncation_scale), float(cfg.block_size_world),
            float(0.5 * cfg.voxel_size), float(cfg.voxel_size),
            int(cfg.world_blocks), kernel_index(tiled, cfg),
            *cta_grid(rows, cols, tiled)[::-1],
            int(tiled and tile <= STAGE_TILE), p(keys), pose, dev)
    return args, keys


def launch(args) -> None:
    """Launch the kernel on prepared arguments, on the current stream (the
    only place that does; counts the launch)."""
    *kernel_args, _pose, device = args
    _build.check(_build.library("alloc_candidates").vh_alloc_candidates(
        *kernel_args, _build.stream_ptr(device)), "alloc_candidates")
    alloc_candidates.launches += 1
    alloc_candidates.by_kernel[KERNELS[kernel_args[ARG_KERNEL]]] += 1


def alloc_candidates(depth, pose, cam: CameraConfig, cfg: MapConfig,
                     tile: int = 1, phase=None, model_depth=None):
    """Block keys touched by the truncation bands of a depth frame (see
    :func:`alloc_candidates_plain`): the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if _device(depth).type == "cpu":
        return alloc_candidates_plain(depth, pose, cam, cfg, tile=tile,
                                      phase=phase, model_depth=model_depth)
    args, keys = prepare(depth, pose, cam, cfg, tile, phase, model_depth)
    launch(args)
    return keys


alloc_candidates.launches = 0
alloc_candidates.by_kernel = collections.Counter()


# ---------------------------------------------------------------------------
# The bound
# ---------------------------------------------------------------------------

# f32/int operations, hand-counted from the plain version's ops: a pixel's
# gate (five), its novelty test (six more); a tile's pooling (two a
# pixel); a column's ray set-up (its pixel direction (four), the band (six),
# two points (2 x 15), the direction and its length (twelve), six block
# rounds (4 each), three axes (11 each)); a live DDA step (the key (eleven),
# the axis choice (five), the step and bound test (eight), the t update
# (three)); a column's dedup (three compares a key with two neighbours,
# and three more for the second ray's) and fold (two a key).
PIXEL_OPS, NOVELTY_OPS, POOL_OPS = 5, 6, 2
RAY_OPS, STEP_OPS, DEDUP_OPS, FOLD_OPS = 109, 27, 3, 2


def bytes_moved(n_pixels: int, n_keys: int, novelty: bool) -> int:
    """The least bytes one launch must move: the depth read (4 B a pixel),
    the model depth with ``novelty`` (4 B a pixel), the pose (64 B), the
    phase (4 B) and the ``n_keys`` keys written (4 B each)."""
    return 4 * n_pixels * (2 if novelty else 1) + 64 + 4 + 4 * n_keys


def operations(n_pixels: int, n_rays: int, n_steps: int, n_keys_in: int,
               tiled: bool, novelty: bool) -> int:
    """Operations of one launch: ``n_pixels`` pixels gated (and pooled in
    tile mode), ``n_rays`` valid rays set up, ``n_steps`` live DDA steps
    taken, ``n_keys_in`` keys deduplicated and folded."""
    px = n_pixels * (PIXEL_OPS + (NOVELTY_OPS if novelty else 0)
                     + (POOL_OPS if tiled else 0))
    return (px + RAY_OPS * n_rays + STEP_OPS * n_steps
            + (DEDUP_OPS + FOLD_OPS) * n_keys_in)


def work_counts(depth, pose, cam: CameraConfig, cfg: MapConfig, tile: int,
                phase=None, model_depth=None):
    """(n_pixels, n_rays, n_steps, n_keys_in, tiled, novelty) of this frame
    for :func:`operations`, from the plain version's rays on ``depth``'s
    device: a ray is valid where its first key is, a step live where its
    key is."""
    tiled = tile_mode(depth, tile)
    novelty = tiled and model_depth is not None
    h, w = depth.shape
    if tiled:
        dmin, dmax, any_v, xn, yn = _tile_rays(depth, cam, cfg, tile, phase,
                                               model_depth)
        raw = torch.cat([_dda_band_keys(dmin, any_v, xn, yn, pose, cfg),
                         _dda_band_keys(dmax, any_v, xn, yn, pose, cfg)],
                        dim=1)
    else:
        d = depth.reshape(-1)
        u, v = geom.pixel_grid(w, h, depth.device)
        xn = geom.div_const(u.reshape(-1) - cam.cx, cam.fx)
        yn = geom.div_const(v.reshape(-1) - cam.cy, cam.fy)
        raw = _dda_band_keys(d, torch.ones_like(d, dtype=torch.bool), xn,
                             yn, pose, cfg)
    live = raw != INVALID_KEY
    return (h * w, int(live[0].sum()), int(live.sum()), raw.numel(), tiled,
            novelty)


# ---------------------------------------------------------------------------
# An edge bank: the frames where the kernel goes wrong first
# ---------------------------------------------------------------------------

EDGE_CASES = ("edge_values", "world_box", "all_invalid", "no_tile_divides",
              "axis_aligned", "tile_2", "tile_8", "steps_1", "steps_16",
              "fold_small", "odd_grid", "tile_30", "tile_32")


def edge_bank(seed: int = 7):
    """Seeded frames with the cases the kernel gets wrong first, each a
    dict: ``case``, ``cam``, ``cfg``, ``tile``, ``depth`` and
    ``model_depth`` ([h,w] f32 numpy; the model depth differs from the
    depth by ~1 truncation on a third of the pixels and is NaN on some),
    ``pose`` ([4,4] f32) and ``phases`` (the tile phases to run). A 32x24
    frame of a noisy tilted plane at 1.2-2.2 m with NaN, +-inf, 0,
    negative, exactly ``max_integration_distance`` and beyond it
    ("edge_values"); a world box of 16 blocks a side (rays leave it,
    "world_box"); every pixel invalid ("all_invalid"); a 30x22 frame that
    no tile of 4 divides (the pixel fallback, "no_tile_divides"); an
    identity pose with the principal point on a pixel and on a tile
    centre, so that rays run along the z axis and the x and y axes' steps
    are 0 ("axis_aligned"); tiles of 2 and 8 at every phase class
    ("tile_2", "tile_8"); one and sixteen DDA steps a ray (the kernel's
    general instantiation, "steps_1", "steps_16"); folds of 2 slots a
    tile and 1 a pixel, fewer than a column's surviving keys
    ("fold_small"); a 44x28 frame whose 11x7 key grid (tile 4) and
    44x28 pixel grid no CTA's columns divide ("odd_grid"); and tiles of 30,
    the largest whose footprint tile mode stages ("tile_30", 90x60), and
    of 32, whose tiles it pools from global memory ("tile_32", 96x64)."""
    rng = np.random.default_rng(seed)
    out = []
    for case in EDGE_CASES:
        w, h = {"no_tile_divides": (30, 22), "odd_grid": (44, 28),
                "tile_30": (90, 60), "tile_32": (96, 64)}.get(case, (32, 24))
        # cx 13.5: a tile centre of tile 4 at phase 0 (col 3); cy 12.0: a
        # pixel row, and a tile centre at phase 2 (row 2 + 0.5, ... 12.0)
        cx, cy = ((13.5, 12.0) if case == "axis_aligned"
                  else ((w - 1) / 2.0, (h - 1) / 2.0))
        cam = CameraConfig(width=w, height=h, fx=w * 0.9, fy=w * 0.9,
                           cx=cx, cy=cy)
        steps = {"steps_1": 1, "steps_16": 16}.get(case, 8)
        folds = (2, 1) if case == "fold_small" else (8, 4)
        cfg = MapConfig(voxel_size=0.02, truncation=0.06,
                        truncation_scale=0.01,
                        world_blocks=16 if case == "world_box" else 1024,
                        alloc_steps=steps, alloc_fold_tile=folds[0],
                        alloc_fold=folds[1])
        tile = {"tile_2": 2, "tile_8": 8, "tile_30": 30,
                "tile_32": 32}.get(case, 4)
        phases = {"tile_2": (None, 0, 1, 2, 3, 6),
                  "tile_8": (None, 0, 9, 23, 63, 64),
                  "tile_30": (None, 0, 31, 467, 899),
                  "tile_32": (None, 0, 33, 529, 1023)}.get(
                      case, (None, 0, 2, 5, 15))
        v, u = np.meshgrid(np.arange(h, dtype=np.float64),
                           np.arange(w, dtype=np.float64), indexing="ij")
        depth = (1.2 + 0.6 * u / w + 0.4 * v / h
                 + rng.normal(0.0, 0.01, (h, w)))
        depth[rng.random((h, w)) < 0.1] += 0.35           # depth edges
        depth = depth.astype(np.float32)
        model = depth + rng.normal(0.0, 0.04, (h, w)).astype(np.float32)
        model[rng.random((h, w)) < 0.1] = np.nan
        if case not in ("all_invalid", "axis_aligned"):
            flat = depth.reshape(-1)
            pick = rng.permutation(flat.size)
            maxd = cfg.max_integration_distance
            vals = [np.nan, np.inf, -np.inf, 0.0, -0.5, maxd,
                    np.nextafter(np.float32(maxd), np.float32(0)),
                    maxd + 0.5, 3.9, 0.05]
            for k, val in enumerate(vals):
                flat[pick[6 * k:6 * k + 6]] = val
        if case == "all_invalid":
            depth[:] = np.nan
            depth[::2, ::3] = 0.0
        pose = np.eye(4, dtype=np.float32)
        if case != "axis_aligned":
            ang = rng.normal(0.0, 0.2, 3)
            c, s = np.cos(ang), np.sin(ang)
            rz = np.array([[c[0], -s[0], 0], [s[0], c[0], 0], [0, 0, 1]])
            ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
            rx = np.array([[1, 0, 0], [0, c[2], -s[2]], [0, s[2], c[2]]])
            pose[:3, :3] = rz @ ry @ rx
            pose[:3, 3] = rng.normal(0.0, 0.3, 3)
        out.append({"case": case, "cam": cam, "cfg": cfg, "tile": tile,
                    "depth": depth, "model_depth": model, "pose": pose,
                    "phases": phases})
    return out
