"""The march renderer's plain versions (``ops/raymarch.py``: the tile
bounds ``ray_bounds_plain`` and the march ``march_plain``, the CPU path
and the reference of ``ray_bounds_kernel`` and ``raymarch_kernel`` on the
card) against the JAX package's ``ray_interval_splat`` and
``render_march`` on ``raymarch.edge_bank``, a numpy model of the march
kernel's per-ray loop against ``march_plain``, and the bound's counts.

Tolerances: the tile bounds bit for bit; a rendered frame at the bounds
of ``tests/test_torch_raycast_march.py`` (coverage equal on all but 1e-3
of the pixels, depth within 1e-5 m on all but 1e-3 of those both cover,
points and colors within 1e-5 where the depths agree, normals within 1e-3
on 99.5% of the pixels both have). The numpy model (one ray at a time,
f32 arithmetic in the plain version's order, a stop past the band and at
the first crossing, the last block's lookup cached) holds every field of
``march_plain``'s ``MarchHits`` bit for bit, and its sample, lookup and
probe counts equal ``raymarch.work_counts``'.
"""

import dataclasses
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voxelhashing_tpu import blockmap as jbm, config as jcfg
from voxelhashing_tpu import raycast as jray
from voxelhashing_tpu_torch import convert, geometry as geom
from voxelhashing_tpu_torch import raycast as tray
from voxelhashing_tpu_torch.config import (CameraConfig, MapConfig,
                                           RaycastConfig)
from voxelhashing_tpu_torch.geometry import INVALID_KEY
from voxelhashing_tpu_torch.ops import _build, raymarch as rm
from voxelhashing_tpu_torch.ops.hash_table import probe_slots

F = np.float32
BOUNDED = [e for e in rm.EDGE_CASES
           if e in ("tilted_plane", "overflow_behind", "overflow_near",
                    "no_active", "crowded_tile", "near_plane")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs one worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _case(name):
    """(bank entry, the port's inputs on the CPU, the JAX map)."""
    e = next(e for e in rm.edge_bank() if e["case"] == name)
    st, pose, aidx, mask = rm.edge_inputs(e, "cpu")
    js = jbm.MapState(**{k: jnp.asarray(v) for k, v in
                         convert.map_state_to_numpy(st).items()})
    return e, (st, pose, aidx, mask), js


def _jax(cfg):
    return getattr(jcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _bounds(e, st, pose, aidx, mask, rc):
    if aidx is None:
        return None
    return tray.ray_interval_splat(st, aidx, mask, geom.invert_rigid(pose),
                                   e["cam"], e["cfg"], rc)


@pytest.mark.parametrize("case", BOUNDED)
def test_ray_bounds_plain_matches_jax_on_the_edge_bank(case):
    e, (st, pose, aidx, mask), js = _case(case)
    view = geom.invert_rigid(pose)
    got = rm.ray_bounds_plain(st.block_key, aidx, mask, view, e["cam"],
                              e["cfg"], e["rc"])
    ref = jray.ray_interval_splat(js, jnp.asarray(aidx.numpy()),
                                  jnp.asarray(mask.numpy()),
                                  jnp.asarray(view.numpy()),
                                  _jax(e["cam"]), _jax(e["cfg"]),
                                  _jax(e["rc"]))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      np.asarray(b).view(np.int32))
    t_min, t_max = (g.numpy() for g in got)
    if case == "tilted_plane":           # untouched tiles and touched ones
        assert np.isinf(t_min).any() and np.isfinite(t_min).any()
    if case == "overflow_behind":        # the global z max is negative
        assert (t_max < 0).any() and (t_max > 0).any()
        assert (t_min == F(e["cam"].depth_min)).all()
    if case == "overflow_near":          # a block spans more than 4 tiles
        assert (t_max > 0).all()
    if case == "no_active":
        assert np.isposinf(t_min).all() and np.isneginf(t_max).all()
    if case == "crowded_tile":           # every block on the first tile
        assert np.isfinite(t_min[0, 0]) and np.isposinf(t_min[0, 1:]).all()
    if case == "near_plane":             # a block's z range crosses 1e-3
        assert (t_min == F(e["cam"].depth_min)).all()
        assert (t_max >= F(0.11)).all()


def _close(out_t, out_j):
    """``test_torch_raycast_march._compare``'s bounds, without its minimum
    coverage (some edge cases hit nothing)."""
    dt, dj = out_t.depth.numpy(), np.asarray(out_j.depth)
    cover_t, cover_j = np.isfinite(dt), np.isfinite(dj)
    assert (cover_t != cover_j).mean() <= 1e-3
    both = cover_t & cover_j
    close = np.abs(dt - dj) <= 1e-5
    assert (~close[both]).mean() <= 1e-3 if both.any() else True
    agree = both & close
    np.testing.assert_allclose(out_t.points.numpy()[agree],
                               np.asarray(out_j.points)[agree], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(out_t.color.numpy()[agree],
                               np.asarray(out_j.color)[agree], atol=1e-5,
                               rtol=0)
    n_t, n_j = out_t.normals.numpy(), np.asarray(out_j.normals)
    nboth = np.isfinite(n_t[..., 0]) & np.isfinite(n_j[..., 0])
    if nboth.any():
        assert (np.abs(n_t[nboth] - n_j[nboth]).max(axis=-1)
                < 1e-3).mean() > 0.995


@pytest.mark.parametrize("use_gradients", [False, True])
@pytest.mark.parametrize("case", rm.EDGE_CASES)
def test_march_plain_matches_jax_on_the_edge_bank(case, use_gradients):
    """``render_march`` on the CPU (``march_plain`` and the shared
    epilogue) against JAX's."""
    e, (st, pose, aidx, mask), js = _case(case)
    rc = dataclasses.replace(e["rc"], use_gradients=use_gradients)
    out_t = tray.render_march(st, pose, e["cam"], e["cfg"], rc,
                              active_idx=aidx, active_mask=mask)
    kw = ({} if aidx is None else
          {"active_idx": jnp.asarray(aidx.numpy()),
           "active_mask": jnp.asarray(mask.numpy())})
    out_j = jray.render_march(js, jnp.asarray(pose.numpy()), _jax(e["cam"]),
                              _jax(e["cfg"]), _jax(rc), **kw)
    _close(out_t, out_j)
    hits = rm.march_plain(st, pose, e["cam"], e["cfg"], rc,
                          _bounds(e, st, pose, aidx, mask, rc))
    found = hits.found.numpy()
    np.testing.assert_array_equal(found, np.isfinite(out_t.depth.numpy())
                                  .reshape(-1))
    assert np.isnan(hits.p_hit.numpy()[~found]).all()
    assert (hits.color.numpy()[~found] == 0).all()
    if use_gradients:
        assert not hits.grad_ok.numpy()[~found].any()


# ---------------------------------------------------------------------------
# A numpy model of the march kernel's loop
# ---------------------------------------------------------------------------

class _Model:
    """``raymarch_kernel`` one ray at a time in numpy f32 scalars, at
    ``lanes`` lanes a ray: windows of ``lanes`` consecutive samples, each
    sample's distinct blocks resolved once for its 8 corners, the first
    crossing found per window (a pair across two windows from the last
    window's last sample), the three secant steps, and the hit with the
    gradient's six samples, the first ``lanes`` of them in one step.
    ``lanes`` 1 is one thread a ray. Counts what it does (the samples it
    issues, each ray's dependent steps; and, on the samples the plain
    algorithm needs in their serial order, the lookups a last-block cache
    misses: the bound's basis) and which edges it met."""

    def __init__(self, st, cam: CameraConfig, cfg: MapConfig,
                 rc: RaycastConfig, bounds, lanes: int):
        self.sdf = st.sdf.float().numpy().reshape(-1)
        self.w = st.weight.float().numpy().reshape(-1)
        self.col = st.color.numpy().reshape(-1)
        self.tk, self.tv = st.table_key.numpy(), st.table_val.numpy()
        self.cam, self.cfg, self.rc, self.lanes = cam, cfg, rc, lanes
        self.bounds = None if bounds is None else [b.numpy().reshape(-1)
                                                   for b in bounds]
        d = rc.derived(cfg)
        self.ray_inc, self.thr = F(d["ray_increment"]), \
            F(d["thres_sample_dist"])
        self.thres_dist = F(d["thres_dist"])
        self.probes = {}
        self.n = dict(samples=0, lookups=0, probe_rounds=0, crossed=0,
                      found=0, issued=0, resolves=0)
        self.steps = []
        self.edges = set()

    def _probe(self, key):
        if key not in self.probes:
            cfg, found, row, r = self.cfg, False, 0, 0
            tomb = False
            for r in range(cfg.max_probes):
                s = probe_slots(np.array([key]), r, cfg.table_size)[0]
                tk = self.tk[s]
                if tk == key:
                    found, row = True, int(self.tv[s])
                    break
                if tk == INVALID_KEY:
                    break
                tomb |= tk == rm.TOMBSTONE
            self.probes[key] = (found, row, r + 1, tomb and found)
        return self.probes[key]

    def sample(self, p, with_color=False):
        """(sdf, valid, color, the corners' block keys in corner order)."""
        vs = F(self.cfg.voxel_size)
        q = [c / vs for c in p]
        b = [int(np.floor(c)) for c in q]
        f = [q[a] - F(b[a]) for a in range(3)]
        g = [F(1.0) - f[a] for a in range(3)]
        wb = self.cfg.world_blocks
        half = wb // 2
        # per axis the blocks of the corners at offset 0 and 1
        k = [[((b[a] + o) >> 3) + half for o in (0, 1)] for a in range(3)]
        split = sum(1 << a for a in range(3) if k[a][0] != k[a][1])
        if split:
            self.edges.add("block_split")
        if split == 7:
            self.edges.add("eight_blocks")
        block = {}
        for d in range(8):
            if d & ~split:
                continue
            kd = [k[a][(d >> a) & 1] for a in range(3)]
            key = ((kd[2] * wb + kd[1]) * wb + kd[0]
                   if all(0 <= x < wb for x in kd) else INVALID_KEY)
            found, row = False, 0
            if key == INVALID_KEY:
                self.edges.add("out_of_world")
            else:
                found, row, _, tomb = self._probe(key)
                self.n["resolves"] += 1
                if tomb:
                    self.edges.add("tombstone_chain")
                if not found:
                    self.edges.add("unallocated")
            block[d] = (key, found, row)
        s, valid, col, keys = F(0.0), True, [F(0.0)] * 3, []
        for c in range(8):
            o = (c & 1, (c >> 1) & 1, (c >> 2) & 1)
            v = [b[a] + o[a] for a in range(3)]
            key, found, row = block[c & split]
            keys.append(key)
            sd = w = F(0.0)
            pk = 0
            if found:
                lin = row * 512 + ((v[2] & 7) * 8 + (v[1] & 7)) * 8 \
                    + (v[0] & 7)
                sd, w, pk = self.sdf[lin], self.w[lin], int(self.col[lin])
            valid = valid and w > F(0.0)
            tw = ((f[0] if o[0] else g[0]) * (f[1] if o[1] else g[1])) \
                * (f[2] if o[2] else g[2])
            s = s + tw * sd
            if with_color:
                col = [col[i] + tw * F((pk >> sh) & 0xFF)
                       for i, sh in enumerate((16, 8, 0))]
        return s, valid, [c / F(255.0) for c in col], keys

    def _serial_lookups(self, needed):
        """The lookups a last-block cache misses on the needed samples'
        corners in their serial order, and their probe rounds."""
        last = -1
        for keys in needed:
            for key in keys:
                if key != last:
                    last = key
                    if key != INVALID_KEY:
                        self.n["lookups"] += 1
                        self.n["probe_rounds"] += self._probe(key)[2]

    def ray(self, pose, row, col_px):
        cam, rc, cfg, w_l = self.cam, self.rc, self.cfg, self.lanes
        r = pose
        xn = (F(col_px) - F(cam.cx)) / F(cam.fx)
        yn = (F(row) - F(cam.cy)) / F(cam.fy)
        d = [r[a, 0] * xn + r[a, 1] * yn + r[a, 2] for a in range(3)]
        o = [r[a, 3] for a in range(3)]
        t_min, t_max = F(cam.depth_min), F(cam.depth_max)
        if self.bounds is not None:
            tx = -(-cam.width // rc.splat_tile)
            t = (row // rc.splat_tile) * tx + col_px // rc.splat_tile
            t_min = self.bounds[0][t] - F(cfg.truncation)
            t_min = F(cam.depth_min) if t_min < F(cam.depth_min) else t_min
            t_max = self.bounds[1][t] + F(cfg.truncation)
            t_max = F(cam.depth_max) if t_max > F(cam.depth_max) else t_max
        band = t_max - t_min
        band = F(0.0) if band < F(0.0) else band
        dt = band / F(rc.num_samples - 1)
        dt = self.ray_inc if dt < self.ray_inc else dt
        limit = t_max + dt
        n_s = rc.num_samples

        def at(t):
            return [o[a] + d[a] * t for a in range(3)]

        steps, needed = 0, []
        prev = (F(0.0), F(0.0), False)
        crossed = None
        for base in range(0, n_s, w_l):
            win = []
            for lane in range(w_l):
                s = base + lane
                ts = t_min + F(s) * dt
                inn = s < n_s and ts <= limit
                sd, ok, keys = F(0.0), False, None
                if inn:
                    sd, ok, _, keys = self.sample(at(ts))
                    self.n["issued"] += 1
                    if ok and sd == F(0.0):
                        self.edges.add("sdf_zero")
                win.append((ts, sd, ok, inn, keys))
            steps += any(x[3] for x in win)
            cross = None
            for lane, (ts, sd, ok, inn, keys) in enumerate(win):
                pt, ps, pok = prev if lane == 0 else win[lane - 1][:3]
                if pok and ok and ps > F(0.0) and sd < F(0.0):
                    if ps - sd < self.thr:
                        cross = lane
                        break
                    self.edges.add("jump_rejected")
            last = len(win) if cross is None else cross + 1
            needed += [x[4] for x in win[:last] if x[3]]
            if cross is not None:
                if cross == 0 and base > 0:
                    self.edges.add("pair_across_windows")
                if cross < w_l - 1 and win[cross + 1][3]:
                    self.edges.add("wasted_samples")
                pt, ps, _ = prev if cross == 0 else win[cross - 1][:3]
                crossed = (pt, ps, win[cross][1], base + cross - 1)
                break
            if not all(x[3] for x in win):
                if w_l > 1 and win[0][3]:
                    self.edges.add("band_ends_in_window")
                break
            prev = win[-1][:3]
        self.n["samples"] += len(needed)
        out = dict(t=F(np.nan), found=False, p=[F(np.nan)] * 3,
                   c=[F(0.0)] * 3, g=[F(np.nan)] * 3, gok=False)
        if crossed is None:
            self._serial_lookups(needed)
            self.steps.append(steps)
            return out
        b_t0, b_s0, b_s1, first = crossed
        self.n["crossed"] += 1
        if first == 0:
            self.edges.add("first_pair")
        if first == rc.num_samples - 2:
            self.edges.add("last_pair")
        b_t1 = b_t0 + dt

        def alpha_of(s0, s1):
            den = s0 - s1
            if np.abs(den) > F(1e-12):
                return s0 / den
            self.edges.add("tiny_denom")
            return F(0.5)
        for _ in range(3):
            tm = b_t0 + alpha_of(b_s0, b_s1) * (b_t1 - b_t0)
            sm, ok, _, keys = self.sample(at(tm))
            needed.append(keys)
            if not ok:
                self.edges.add("secant_invalid")
            if ok and sm == F(0.0):
                self.edges.add("sdf_zero")
            if ok and sm < F(0.0):
                b_t1, b_s1 = tm, sm
            if ok and sm >= F(0.0):
                b_t0, b_s0 = tm, sm
        self.n["issued"] += 3
        t_hit = b_t0 + alpha_of(b_s0, b_s1) * (b_t1 - b_t0)
        h = at(t_hit)
        # the hit and the gradient's samples at h + e and h - e
        pts = [h]
        if rc.use_gradients:
            for ax in range(3):
                e = [F(cfg.voxel_size) if k == ax else F(0.0)
                     for k in range(3)]
                pts.append([h[k] + e[k] for k in range(3)])
                pts.append([h[k] - e[k] for k in range(3)])
        first_step = min(w_l, len(pts))
        got = [self.sample(q, with_color=j == 0)
               for j, q in enumerate(pts[:first_step])]
        s_hit, ok, c, keys = got[0]
        needed.append(keys)
        found = ok and np.abs(s_hit) < self.thres_dist
        self.n["issued"] += first_step
        steps += 4
        if found and len(pts) > first_step:
            got += [self.sample(q) for q in pts[first_step:]]
            self.n["issued"] += len(pts) - first_step
            steps += -(-(len(pts) - first_step) // w_l)
        self.steps.append(steps)
        if not found:
            self._serial_lookups(needed)
            return out
        needed += [x[3] for x in got[1:]]
        self._serial_lookups(needed)
        self.n["found"] += 1
        out.update(t=t_hit, found=True, p=h, c=c)
        if rc.use_gradients:
            g = [(got[1 + 2 * ax][0] - got[2 + 2 * ax][0]) * F(0.5)
                 for ax in range(3)]
            gok = all(x[1] for x in got[1:])
            out.update(g=g, gok=gok)
        return out

    def run(self, pose):
        cam = self.cam
        rays = [self.ray(pose, r, c) for r in range(cam.height)
                for c in range(cam.width)]
        warp = rm.warp_of(cam, self.lanes).numpy()
        per_warp = np.zeros(warp.max() + 1, np.int64)
        np.maximum.at(per_warp, warp, np.array(self.steps, np.int64))
        self.n["chain"] = int(per_warp.max())
        return rm.MarchHits(
            t_hit=np.array([x["t"] for x in rays], F),
            found=np.array([x["found"] for x in rays]),
            p_hit=np.array([x["p"] for x in rays], F),
            color=np.array([x["c"] for x in rays], F),
            grad=np.array([x["g"] for x in rays], F),
            grad_ok=np.array([x["gok"] for x in rays]))


@functools.lru_cache(maxsize=None)
def _modelled(case, lanes=rm.MARCH_LANES):
    """(model, its hits, march_plain's hits) with gradients on."""
    e, (st, pose, aidx, mask), _ = _case(case)
    rc = dataclasses.replace(e["rc"], use_gradients=True)
    bounds = _bounds(e, st, pose, aidx, mask, rc)
    model = _Model(st, e["cam"], e["cfg"], rc, bounds, lanes)
    with np.errstate(all="ignore"):
        got = model.run(pose.numpy())
    ref = rm.march_plain(st, pose, e["cam"], e["cfg"], rc, bounds)
    return model, got, ref, (st, pose, e, rc, bounds)


@pytest.mark.parametrize("lanes", [1, rm.MARCH_LANES])
@pytest.mark.parametrize("case", rm.EDGE_CASES)
def test_kernel_model_matches_march_plain(case, lanes):
    """The kernel's loop at 1 lane a ray and at ``MARCH_LANES`` (windows
    that stop past the band and at the first crossing, every sample's
    blocks resolved together) gives ``march_plain``'s hits bit for bit,
    and ``work_counts`` counts what it did: the bound's basis (the
    samples the plain algorithm needs, their cache-missed lookups and
    probe rounds) and the kernel's issued samples and chain."""
    model, got, ref, (st, pose, e, rc, bounds) = _modelled(case, lanes)
    for f in rm.MarchHits._fields:
        a, b = getattr(got, f), getattr(ref, f).numpy()
        assert a.shape == b.shape, f
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=f)
    work = rm.work_counts(st, pose, e["cam"], e["cfg"], rc, bounds,
                          lanes=lanes)
    n = model.n
    assert (work.samples + 4 * work.crossed + 6 * work.found
            == n["samples"] + 4 * n["crossed"] + 6 * n["found"])
    assert (work.crossed, work.found) == (n["crossed"], n["found"])
    assert work.lookups == n["lookups"]
    assert work.probe_rounds == n["probe_rounds"]
    assert (work.issued, work.chain) == (n["issued"], n["chain"])
    if lanes == 1:
        assert n["issued"] == n["samples"] + 4 * n["crossed"] + 6 * n["found"]


def _image(f):
    i = np.asarray(f, np.float32).view(np.int32)
    return np.where(i >= 0, i, i ^ np.int32(0x7FFFFFFF))


def _from_image(i):
    i = np.asarray(i, np.int32)
    return np.where(i >= 0, i, i ^ np.int32(0x7FFFFFFF)).view(np.float32)


def _model_bounds(e, st, pose, aidx, mask, rows=1, shared=True,
                  matched=False):
    """``ray_bounds_kernel`` in numpy: CTAs of 256 threads, ``rows`` active
    rows a thread; each row's atomic min of its images into every tile of
    its box (or, ``matched``, the order ``kernel_probes`` measures beside
    it: each warp walks its rows' boxes in step, row-major, the lanes on
    one tile reduced to one atomic); the overflow reduced over the warp;
    the CTA's touched box flushed into the global accumulators
    (``shared``; else every atomic is global); the last CTA's floats and
    widening. Returns (t_min, t_max, counts)."""
    cam, cfg, rc = e["cam"], e["cfg"], e["rc"]
    r = rm.row_bounds(st.block_key, aidx, mask, geom.invert_rigid(pose),
                      cam, cfg, rc)
    r = rm.RowBounds(*(t.numpy() for t in r))
    ty, tx = rm.tiles(cam, rc)
    n, m = ty * tx, aidx.shape[0]
    ident = np.int32(rm.IDENTITY)
    lo, hi = _image(r.z_min), ~_image(r.z_max)
    zc = np.where(r.z_min < F(cam.depth_min), F(cam.depth_min), r.z_min)
    g = np.full(3, ident)
    acc = np.full(2 * n, ident)
    counts = {"row_tiles": 0, "atomics": 0, "flushed": 0, "steps": 0}
    per_cta = 256 * rows
    for cta in range(max(1, -(-m // per_cta))):
        s = np.full(2 * n, ident) if shared else acc
        box = None
        for w0 in range(cta * per_cta, (cta + 1) * per_cta, 32):
            lanes = np.arange(w0, min(w0 + 32, m))
            if lanes.size == 0:
                continue
            sc = r.scatter[lanes]
            wd = (r.t1x - r.t0x + 1)[lanes]
            cnt = np.where(sc, wd * (r.t1y - r.t0y + 1)[lanes], 0)
            counts["row_tiles"] += int(cnt.sum())
            for k in range(int(cnt.max(initial=0))):
                counts["steps"] += 1
                on = k < cnt
                t = ((r.t0y[lanes] + k // wd) * tx + r.t0x[lanes]
                     + k % wd)
                groups = ([on & (t == tile) for tile in np.unique(t[on])]
                          if matched else
                          [on & (lanes == j) for j in lanes[on]])
                for grp in groups:
                    tile = t[grp][0]
                    s[tile] = min(s[tile], lo[lanes][grp].min())
                    s[n + tile] = min(s[n + tile], hi[lanes][grp].min())
                    counts["atomics"] += 1
            if sc.any():
                b = (r.t0y[lanes][sc].min(), r.t0x[lanes][sc].min(),
                     r.t1y[lanes][sc].max(), r.t1x[lanes][sc].max())
                box = b if box is None else (
                    min(box[0], b[0]), min(box[1], b[1]),
                    max(box[2], b[2]), max(box[3], b[3]))
            ov = r.overflow[lanes]
            if ov.any():
                g[0] = min(g[0], _image(zc[lanes][ov]).min())
                g[1] = min(g[1], hi[lanes][ov].min())
                g[2] = 0
        if shared and box is not None:
            for y in range(box[0], box[2] + 1):
                for x in range(box[1], box[3] + 1):
                    for t in (y * tx + x, n + y * tx + x):
                        if s[t] != ident:
                            acc[t] = min(acc[t], s[t])
                            counts["flushed"] += 1
    t_min, t_max = _from_image(acc[:n]), _from_image(~acc[n:])
    if g[2] != ident:
        g_min, g_max = _from_image(g[0]), _from_image(~g[1])
        t_min = np.where(np.isnan(t_min) | (t_min < g_min), t_min, g_min)
        t_max = np.where(np.isnan(t_max) | (t_max > g_max), t_max, g_max)
    return t_min.reshape(ty, tx), t_max.reshape(ty, tx), counts


@pytest.mark.parametrize("matched", [False, True])
@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("case", BOUNDED)
def test_bounds_kernel_model_matches_plain(case, rows, matched):
    """The bounds kernel's order (shared atomics, the touched-box flush,
    the last CTA), modelled in numpy at one and two rows a thread, through
    shared and global memory, one atomic a row and tile (the kernel) or a
    warp's lanes on one tile matched first (measured beside it), equals
    ``ray_bounds_plain`` bit for bit; matched, a warp on one tile makes
    one atomic a step."""
    e, (st, pose, aidx, mask), _ = _case(case)
    view = geom.invert_rigid(pose)
    ref = rm.ray_bounds_plain(st.block_key, aidx, mask, view, e["cam"],
                              e["cfg"], e["rc"])
    for shared in (True, False):
        t_min, t_max, counts = _model_bounds(e, st, pose, aidx, mask, rows,
                                             shared, matched)
        for a, b in ((t_min, ref[0]), (t_max, ref[1])):
            np.testing.assert_array_equal(a.view(np.int32),
                                          b.numpy().view(np.int32))
    if not matched:
        assert counts["atomics"] == counts["row_tiles"]
        return
    assert counts["atomics"] <= counts["row_tiles"]
    if case == "crowded_tile":           # 128 rows, 4 warps, one tile
        assert counts["row_tiles"] == 128
        assert counts["atomics"] == counts["steps"] == 4
    if case == "tilted_plane":           # neighbours share their tiles
        assert counts["atomics"] < counts["row_tiles"] / 2


def test_edge_bank_covers_its_cases():
    edges = set()
    for case in rm.EDGE_CASES:
        edges |= _modelled(case)[0].edges
    assert edges >= {"first_pair", "last_pair", "sdf_zero", "jump_rejected",
                     "unallocated", "out_of_world", "tombstone_chain",
                     "tiny_denom", "secant_invalid", "block_split",
                     "eight_blocks", "pair_across_windows",
                     "wasted_samples", "band_ends_in_window"}, edges
    # the central ray of "jump" meets a jump of exactly the f32 threshold
    # (1.0; 1.000000005 in f64) first, and crosses only at the last pair
    model, got, _, (_, _, e, _, _) = _modelled("jump")
    centre = 8 * 24 + 12
    assert got.found[centre] and got.t_hit[centre] > F(1.0)
    d = e["rc"].derived(e["cfg"])["thres_sample_dist"]
    assert F(d) == F(1.0) and 1.0 < d


def test_work_counts_and_bound_by_hand():
    """One ray along the z axis through blocks (0, 0, k) at exact 1/64 m
    voxel positions: samples at z-voxels 16, 24, ..., 48 (+0.05 up to 44,
    -0.05 past it), a crossing at the pair (40, 48), secants at 44, 46,
    45 and the hit at 44.5 (s = 0): 5 + 4 samples, 6 lookups of 5 keys
    (the secants go back to block 5), one round each, 56 distinct voxels
    (8 a sample at 16, 24, 32, 40, 48; 16 more at z 44-47), 8 with color,
    5 rows, 5 slots. The kernel: at 8 lanes one window of all 8 samples
    (3 wasted past the crossing), the secants and the hit: 12 issued in
    5 steps; at 4 lanes two windows, the pair across them: 12 in 6; at
    one lane a ray 9 in 9. The layout ``warp_of`` models is the kernel's
    (``csrc/raymarch.cu``'s constants)."""
    src = (_build.CSRC / "raymarch.cu").read_text()
    for name, value in (("kMarchThreads", rm.MARCH_THREADS),
                        ("kMarchLanes", rm.MARCH_LANES),
                        ("kMarchTileX", rm.MARCH_TILE_X)):
        assert f"constexpr int {name} = {value};" in src, name
    cam = CameraConfig(width=1, height=1, fx=1.0, fy=1.0, cx=0.0, cy=0.0,
                       depth_min=0.25, depth_max=1.125)
    cfg = MapConfig(voxel_size=0.015625, truncation=0.0625,
                    truncation_scale=0.0, num_blocks=64, table_size=1024,
                    world_blocks=1024)
    rc = RaycastConfig(mode="march", num_samples=8)
    blocks = [(x, y, z) for z in range(12) for y in (-1, 0) for x in (-1, 0)]
    keys = [((z + 512) * 1024 + (y + 512)) * 1024 + x + 512
            for x, y, z in blocks]
    assert len({int(probe_slots(np.array([k]), 0, 1024)[0])
                for k in keys}) == len(keys)      # every key at round 0
    rng = np.random.default_rng(0)
    m = rm._edge_map(cfg, blocks, lambda vx, vy, vz: (
        np.where(vz <= 44, 0.05, -0.05).astype(np.float32),
        np.ones(vz.shape, np.float32)), rng, tombstones=False)
    st, pose, _, _ = rm.edge_inputs({"map": m, "cfg": cfg, "active": None,
                                     "pose": np.eye(4, dtype=np.float32)},
                                    "cpu")
    w = rm.work_counts(st, pose, cam, cfg, rc, lanes=8)
    assert w == rm.MarchWork(rays=1, samples=5, crossed=1, found=1,
                             lookups=6, probe_rounds=6, slots=5, rows=5,
                             voxels=56, color_voxels=8, tiles=0,
                             gradients=False, issued=12, chain=5)
    for lanes, issued, chain in ((4, 12, 6), (1, 9, 9)):
        assert rm.work_counts(st, pose, cam, cfg, rc, lanes=lanes) == \
            w._replace(issued=issued, chain=chain)
    assert rm.bytes_moved(w) == 4 * 5 + 4 * 5 + 4 * 56 + 4 * 8 + 64 + 29
    assert rm.operations(w) == (rm.RAY_OPS + rm.SAMPLE_OPS * 9
                                + rm.COLOR_OPS + rm.LOOKUP_OPS * 6
                                + rm.PROBE_OPS * 6 + rm.SECANT_OPS * 3)
    hits = rm.march_plain(st, pose, cam, cfg, rc)
    assert bool(hits.found[0]) and float(hits.t_hit[0]) == 0.6953125


def test_bounds_work_by_hand():
    """Two active blocks at z 0.96-1.12 in a 24x16 view with 4-pixel
    tiles: (0, 0, 6) covers one tile, (-1, 0, 6) two; a masked row adds
    nothing."""
    cam = CameraConfig(width=24, height=16, fx=20.0, fy=20.0, cx=12.0,
                       cy=8.0, depth_min=0.2, depth_max=3.0)
    cfg = MapConfig(voxel_size=0.02, world_blocks=1024)
    rc = RaycastConfig(mode="march", splat_tile=4)
    key = [((6 + 512) * 1024 + 512) * 1024 + x + 512 for x in (0, -1)]
    block_key = torch.tensor(key + [INVALID_KEY], dtype=torch.int32)
    aidx = torch.tensor([0, 1, 2], dtype=torch.int32)
    mask = torch.tensor([True, True, False])
    view = torch.eye(4)
    n_active, writes = rm.bounds_work(block_key, aidx, mask, view, cam, cfg,
                                      rc)
    assert (n_active, writes) == (2, 3)
    assert rm.bounds_bytes(3, 2, 24) == 5 * 3 + 4 * 2 + 64 + 8 * 24
    assert rm.bounds_operations(2, 3) == 2 * rm.BOUNDS_ROW_OPS + 3 * 2
    t_min, _ = rm.ray_bounds_plain(block_key, aidx, mask, view, cam, cfg, rc)
    assert int(torch.isfinite(t_min).sum()) == 2


def test_wrappers_refuse_what_the_kernels_cannot_take():
    """A tensor on neither the CPU nor CUDA is refused; the prepare steps
    refuse shapes and types the kernels would misread (they check before
    anything is launched, on any device)."""
    e, (st, pose, aidx, mask), _ = _case("tilted_plane")
    meta = torch.device("meta")
    mst = type(st)(*(t.to(meta) for t in st))
    with pytest.raises(ValueError, match="no kernel"):
        rm.march(mst, pose.to(meta), e["cam"], e["cfg"], e["rc"])
    with pytest.raises(ValueError, match="no kernel"):
        rm.ray_bounds(mst.block_key, aidx.to(meta), mask.to(meta),
                      pose.to(meta), e["cam"], e["cfg"], e["rc"])
    with pytest.raises(ValueError, match="active_idx"):
        rm.prepare_bounds(st.block_key, aidx.long(), mask, pose, e["cam"],
                          e["cfg"], e["rc"])
    with pytest.raises(ValueError, match="pose"):
        rm.prepare_march(st, pose.double(), e["cam"], e["cfg"], e["rc"])
    with pytest.raises(ValueError, match="tile t_min"):
        rm.prepare_march(st, pose, e["cam"], e["cfg"], e["rc"],
                         (torch.zeros(2, 2), torch.zeros(2, 2)))
    with pytest.raises(ValueError, match="2 samples"):
        rm.prepare_march(st, pose, e["cam"], e["cfg"],
                         dataclasses.replace(e["rc"], num_samples=1))
    assert rm.march.launches == 0 and rm.ray_bounds.launches == 0
