"""The port's ``engine.make_step`` (the step as replays of captured CUDA
graphs; on a CPU state the same segment functions run eagerly) against
JAX's ``make_step``, on ``tests/test_engine.py``'s 160x120 configuration.

Tolerances, those of ``tests/test_torch_engine.py``: online, free tracking
and trajectory replay, 8 frames through both give the same valid flags,
poses within 1e-4 and allocated-block counts within 0.5%; offline with a
streaming eviction bitmask (free tracking and replay), poses within 1e-5.
Each variant runs with ``donate`` True and False. Against the port's own
eager ``step`` the graphed step is bit-equal, and the segmented ``step``
is bit-equal to the unsegmented one it replaced (:func:`_unsegmented_step`
here); ``alloc_candidates`` with the phase on the device is bit-equal to
the host-int phase, and ``starve`` through ``blockmap.set_rows_`` to the
boolean-index form. The segments read nothing on the host. The card's
tests (graph against eager, host syncs) are in
``tests/test_torch_kernels_cuda.py``.
"""

import contextlib
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voxelhashing_tpu import engine as jeng
from voxelhashing_tpu.config import (CameraConfig, EngineConfig, FilterConfig,
                                     MapConfig, RaycastConfig, StreamingConfig,
                                     TrackerConfig)
from voxelhashing_tpu.io.synthetic import Scene, make_trajectory, render_depth
from voxelhashing_tpu_torch import blockmap as tbm, convert, engine as teng
from voxelhashing_tpu_torch import geometry as tgeom, integrate as tint
from voxelhashing_tpu_torch import raycast as trc, tracking as ttr
from voxelhashing_tpu_torch.ops.fused_integrate import fused_integrate
from voxelhashing_tpu_torch.ops.image import color_to_intensity, preprocess

CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                   cx=79.5, cy=59.5)
CFG = EngineConfig(
    camera=CAM,
    map=MapConfig(voxel_size=0.02, truncation=0.06, truncation_scale=0.01,
                  num_blocks=16384, table_size=65536,
                  max_active_blocks=16384, world_blocks=1024,
                  gc_starve_interval=4),
    tracker=TrackerConfig(levels=2, max_outer_iter=(6, 4),
                          max_inner_iter=(1, 1),
                          dist_thres=(0.15, 0.15), normal_thres=(0.9, 0.9),
                          angle_trans_thres=(1.0, 1.0),
                          dist_trans_thres=(1.0, 1.0),
                          residual_early_out=(1e-9, 1e-9)),
    raycast=RaycastConfig(),
    filter=FilterConfig(depth_filter=False),
    offline=False,
)
N_FRAMES = 8
SCFG = StreamingConfig(enabled=True, chunk_size=0.64, grid_dim=65)
# (with_hint, with_stream_mask): the hint is the pose (trajectory replay);
# the bitmask runs offline, as in test_torch_engine.py
VARIANTS = {"plain": (False, False), "hint": (True, False),
            "mask": (False, True), "hint+mask": (True, True)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    poses = make_trajectory(N_FRAMES)
    out = []
    for i, pose in enumerate(poses):
        d, c = render_depth(pose, CAM, Scene(), noise_sigma=0.002, seed=i)
        out.append((pose, d, c))
    return out


def _bitmask_words():
    """uint32 eviction words with the chunks x in [0, 3], y in [-3, 3],
    z in [0, 6] set (the right half of the test scene)."""
    g = SCFG.grid_dim
    cc = np.array([(x, y, z) for x in range(4) for y in range(-3, 4)
                   for z in range(7)], np.int64)
    ids = ((cc[:, 2] + g // 2) * g + cc[:, 1] + g // 2) * g + cc[:, 0] + g // 2
    words = np.zeros(((g ** 3 + 31) // 32,), np.uint32)
    np.bitwise_or.at(words, ids // 32,
                     np.uint32(1) << (ids % 32).astype(np.uint32))
    return words


def _config(variant):
    hint, mask = VARIANTS[variant]
    cfg = dataclasses.replace(CFG, use_trajectory=hint)
    if mask:
        cfg = dataclasses.replace(cfg, offline=True, streaming=SCFG)
    return cfg


_JAX_RUNS = {}


def _jax_run(variant, frames):
    """JAX's make_step over the frames: (poses, valid flags, allocated
    blocks), once per variant."""
    if variant not in _JAX_RUNS:
        cfg = _config(variant)
        hint, mask = VARIANTS[variant]
        jstep = jeng.make_step(cfg, with_hint=hint, donate=False,
                               with_stream_mask=mask)
        js = jeng.create(cfg, initial_pose=frames[0][0])
        words = jnp.asarray(_bitmask_words())
        out = []
        for pose, d, c in frames:
            extra = ((jnp.asarray(pose),) if hint else ()) + (
                (words,) if mask else ())
            js, jd = jstep(js, jnp.asarray(d), jnp.asarray(c), *extra)
            out.append((np.asarray(js.pose), bool(jd.tracking_valid),
                        int(jd.n_allocated_blocks)))
        _JAX_RUNS[variant] = out
    return _JAX_RUNS[variant]


def _port_run(variant, frames, donate, step=None):
    """The port's make_step (or ``step``) over the frames on the CPU:
    (final state, [(pose, valid, allocated)], diagnostics)."""
    cfg = convert.config_from(_config(variant))
    hint, mask = VARIANTS[variant]
    step = step or teng.make_step(cfg, with_hint=hint, donate=donate,
                                  with_stream_mask=mask)
    ts = teng.create(cfg, initial_pose=frames[0][0], device="cpu")
    words = convert.bitmask_from_numpy(_bitmask_words(), device="cpu")
    out, diags = [], []
    for pose, d, c in frames:
        extra = ((pose,) if hint else ()) + ((words,) if mask else ())
        ts, td = step(ts, torch.from_numpy(d), torch.from_numpy(c), *extra)
        out.append((ts.pose.numpy().copy(), bool(td.tracking_valid),
                    int(td.n_allocated_blocks)))
        diags.append(td)
    return ts, out, diags


@pytest.mark.parametrize("donate", [True, False])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_make_step_matches_jax(variant, donate, frames):
    jout = _jax_run(variant, frames)
    ts, tout, _ = _port_run(variant, frames, donate)
    offline = VARIANTS[variant][1]
    for (jp, jv, jn), (tp, tv, tn) in zip(jout, tout):
        assert tv == jv
        np.testing.assert_allclose(tp, jp, atol=1e-5 if offline else 1e-4,
                                   rtol=0)
        assert abs(tn - jn) <= 0.005 * jn, (tn, jn)
    assert all(v for _, v, _ in tout)
    assert ts.frame_host == N_FRAMES == int(ts.frame)
    viol = tbm.check_invariants(ts.map, convert.config_from(CFG.map))
    assert all(v == 0 for v in viol.values()), viol


def _equal(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and (
        torch.equal(a, b) or torch.equal(torch.isnan(a), torch.isnan(b))
        and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def _states_equal(a, b):
    return (all(_equal(x, y) for x, y in zip(a.map, b.map))
            and all(_equal(getattr(a, f), getattr(b, f))
                    for f in ("pose", "frame", "tracking_lost",
                              "n_integrated"))
            and a.frame_host == b.frame_host)


@pytest.mark.parametrize("variant", ["plain", "hint+mask"])
def test_make_step_is_the_eager_step_bit_for_bit(variant, frames):
    """The CPU make_step (the functions the card captures, with the alloc
    phase on the device) against ``engine.step``: every state field and
    diagnostic bit-equal on every frame, starve frames included."""
    cfg = convert.config_from(_config(variant))
    hint, mask = VARIANTS[variant]
    words = convert.bitmask_from_numpy(_bitmask_words(), device="cpu")
    step = teng.make_step(cfg, with_hint=hint, with_stream_mask=mask)
    a = teng.create(cfg, initial_pose=frames[0][0], device="cpu")
    b = teng.create(cfg, initial_pose=frames[0][0], device="cpu")
    for pose, d, c in frames:
        d, c = torch.from_numpy(d), torch.from_numpy(c)
        a, da = teng.step(a, d, c, cfg, pose_hint=pose if hint else None,
                          stream_bitmask=words if mask else None)
        extra = ((pose,) if hint else ()) + ((words,) if mask else ())
        b, db = step(b, d, c, *extra)
        assert _states_equal(a, b)
        assert all(_equal(x, y) for x, y in zip(da, db))
    assert step.pool_bytes_adopted == 0


def _unsegmented_step(state, depth_raw, color_raw, cfg):
    """``engine.step`` as it was before the segments (online, no hint, no
    bitmask): one body, the alloc phase a host int (``torch.roll``), the
    starve a boolean-index write, and ``maybe_maintain``'s own read."""
    cam, mp = cfg.camera, cfg.map
    dev = state.pose.device
    frame = preprocess(depth_raw, color_raw, cam, cfg.filter)
    is_first = state.frame_host == 0
    view = tgeom.invert_rigid(state.pose)
    active_idx, n_active, _ = tbm.compactify(state.map, view, cam, mp)
    active_mask = torch.arange(active_idx.shape[0]) < n_active
    use_rgbd = cfg.tracker.use_rgbd
    model = trc.render(state.map, state.pose, cam, mp, cfg.raycast,
                       active_idx=active_idx, active_mask=active_mask,
                       with_color=use_rgbd)
    if is_first:
        zstats, zcurve = ttr.empty_stats(cfg.tracker, dev)
        zero_f = torch.zeros(())
        tr = ttr.TrackingResult(
            pose=state.pose, valid=torch.ones((), dtype=torch.bool),
            residual=zero_f, corr_count=torch.zeros((), dtype=torch.int32),
            condition=zero_f, level_stats=zstats, iter_residuals=zcurve,
            planarity=zero_f if use_rgbd else ttr.planarity_probe(
                frame.points, frame.normals, cfg.tracker))
    else:
        rgbd = {}
        if use_rgbd:
            rgbd = dict(input_intensity=frame.intensity,
                        model_intensity=torch.where(
                            torch.isfinite(model.depth),
                            color_to_intensity(model.color), torch.nan),
                        weight_depth=cfg.tracker.weight_depth,
                        weight_color=cfg.tracker.weight_color,
                        color_sigma=cfg.tracker.color_sigma)
        tr = ttr.track(frame.points, frame.normals, model.points,
                       model.normals, state.pose, cam, cfg.tracker, **rgbd)
    m = state.map
    if is_first or bool(tr.valid):
        fi = state.frame_host
        keys = tint.alloc_candidates(frame.depth, tr.pose, cam, mp,
                                     tile=mp.alloc_tile, phase=fi,
                                     model_depth=(model.depth
                                                  if mp.alloc_novelty
                                                  else None))
        n_free_before = m.n_free
        m, _ = tbm.allocate(m, keys, mp, rounds=1)
        cap_a = active_idx.shape[0]
        n_new = n_free_before - m.n_free
        j = torch.arange(mp.alloc_insert_cap, dtype=torch.int32)
        slots_new = m.free_stack[torch.clamp(m.n_free + j, 0,
                                             mp.num_blocks - 1).long()]
        pos = n_active + j
        aidx = tbm.put(active_idx, pos, slots_new, (j < n_new) & (pos < cap_a))
        n_act = torch.clamp(n_active + n_new, max=cap_a)
        amask = torch.arange(cap_a) < n_act
        m, stats = fused_integrate(m, frame.depth, frame.color, tr.pose, cam,
                                   mp, aidx, n_act)
        if fi > 0 and fi % mp.gc_starve_interval == 0:
            idx = aidx.long()
            w = torch.clamp(m.weight[idx] - 1.0, min=0.0)
            m.weight[idx[amask]] = w[amask]
            m = tint.garbage_collect(m, aidx, amask, mp)
        else:
            m = tint.garbage_collect(m, aidx, amask, mp, cached_stats=stats)
        need = m.n_tombstones > mp.table_size // 8
        if fi % mp.maintain_interval == 0:
            need = need | (m.dense_upto - (mp.num_blocks - m.n_free)
                           > mp.num_blocks // 16)
        if bool(need):
            m = tbm.compact_pool(m, mp)
    return teng.EngineState(
        map=m, pose=tr.pose, frame=state.frame + 1,
        tracking_lost=~tr.valid,
        n_integrated=state.n_integrated + tr.valid.to(torch.int32),
        frame_host=state.frame_host + 1), tr


def _with_garbage(state, cfg):
    """``state`` with empty blocks allocated behind the test scene's wall
    (900 keys, z 2.9-3.8 m, in view): no frame updates them, so GC culls
    them and their table slots become tombstones."""
    mp = cfg.map
    vox = mp.voxel_size * 8
    b = torch.stack(torch.meshgrid(
        torch.arange(-7, 8), torch.arange(-5, 5),
        torch.arange(int(2.9 / vox), int(2.9 / vox) + 6), indexing="ij"),
        dim=-1).reshape(-1, 3).to(torch.int32)
    keys = tgeom.pack_block_key(b, mp.world_blocks)
    m, n = tbm.allocate(state.map, keys, mp, rounds=8)
    assert int(n) > 800
    return state._replace(map=m)


@pytest.mark.parametrize("maintain", [False, True])
def test_segmented_step_is_the_unsegmented_one(maintain, frames):
    """``engine.step`` against :func:`_unsegmented_step` and ``make_step``,
    bit for bit on every frame. With ``maintain``, empty blocks behind
    the wall after frame 1 (:func:`_with_garbage`) in a 4,096-slot table:
    GC culls them, their tombstones pass 1/8 of the table, ``compact_pool``
    runs, and ``make_step`` takes the compacted pool into its own
    buffers."""
    cfg = convert.config_from(CFG)
    if maintain:
        cfg = dataclasses.replace(cfg, map=dataclasses.replace(
            cfg.map, table_size=4096, num_blocks=2048))
    a = teng.create(cfg, initial_pose=frames[0][0], device="cpu")
    b = teng.create(cfg, initial_pose=frames[0][0], device="cpu")
    c = teng.create(cfg, initial_pose=frames[0][0], device="cpu")
    step = teng.make_step(cfg)
    compacted = 0
    for i, (_, d, col) in enumerate(frames):
        d, col = torch.from_numpy(d), torch.from_numpy(col)
        if maintain and i == 2:
            a, b, c = (_with_garbage(s, cfg) for s in (a, b, c))
        before = int(b.map.n_tombstones)
        a, _ = _unsegmented_step(a, d, col, cfg)
        b, _ = teng.step(b, d, col, cfg)
        c, _ = step(c, d, col)
        compacted += int(b.map.n_tombstones) < before
        assert _states_equal(a, b) and _states_equal(b, c)
    assert (compacted > 0) == maintain
    assert (step.pool_bytes_adopted > 0) == maintain


def test_alloc_phase_on_the_device_is_the_host_phase(frames):
    """``alloc_candidates`` with the phase as a device int32 scalar gives
    the host-int phase's keys bit for bit, for all 16 phases of a 4x4 tile
    (with and without the novelty mask)."""
    mp = convert.config_from(CFG.map)
    pose, d, _ = frames[3]
    depth = torch.from_numpy(d)
    pose_t = torch.from_numpy(pose).float()
    model = torch.from_numpy(frames[2][1])
    for novelty in (None, model):
        for phase in range(16):
            host = tint.alloc_candidates(depth, pose_t, CAM, mp, tile=4,
                                         phase=phase, model_depth=novelty)
            dev = tint.alloc_candidates(
                depth, pose_t, CAM, mp, tile=4,
                phase=torch.tensor(phase, dtype=torch.int32),
                model_depth=novelty)
            assert torch.equal(host, dev), phase
            assert (host != tgeom.INVALID_KEY).any()


@pytest.mark.parametrize("kept", ["none", "some", "all"])
def test_starve_without_a_host_read_is_the_boolean_index_form(kept):
    """``integrate.starve`` (``blockmap.set_rows_``) against the write of
    the rows ``active_idx[active_mask]``, bit for bit."""
    rng = np.random.default_rng(3)
    mp = convert.config_from(CFG.map)
    state = tbm.create(dataclasses.replace(mp, num_blocks=64), "cpu")
    w = torch.from_numpy(rng.integers(0, 4, (64, 512)).astype(np.float32))
    state = state._replace(weight=w.to(tbm.POOL_DTYPE))
    aidx = torch.from_numpy(rng.permutation(64)[:40].astype(np.int32))
    mask = {"none": torch.zeros(40, dtype=torch.bool),
            "some": torch.from_numpy(rng.random(40) < 0.5),
            "all": torch.ones(40, dtype=torch.bool)}[kept]
    ref = state.weight.clone()
    idx = aidx.long()
    ref[idx[mask]] = torch.clamp(ref[idx] - 1.0, min=0.0)[mask]
    got = tint.starve(state, aidx, mask).weight
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))
    assert kept == "none" or not torch.equal(got, w.to(tbm.POOL_DTYPE))


def test_graph_keys():
    """Frame 0 is eager; a tracked frame runs the view graph, the front
    graph and a back graph; a starve frame (the multiples of
    ``gc_starve_interval``, 15 by default) has its own back graph; under
    replay one fused graph a frame."""
    cfg = convert.config_from(dataclasses.replace(
        CFG, map=dataclasses.replace(CFG.map, gc_starve_interval=15)))
    for i in range(41):
        starve = i > 0 and i % 15 == 0
        tail = "_starve" if starve else ""
        want = ("eager",) if i == 0 else ("view", "front", "back" + tail)
        assert teng.graph_keys(cfg, i, replay=False) == want
        want = ("eager",) if i == 0 else ("fused" + tail,)
        assert teng.graph_keys(cfg, i, replay=True) == want
    off = dataclasses.replace(cfg, map=dataclasses.replace(
        cfg.map, gc_enabled=False))
    assert teng.graph_keys(off, 15, replay=False) == ("view", "front",
                                                      "back")


_READS = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist",
          "numpy", "cpu")


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    """Every Python-level read of a tensor's value inside the block
    raises."""
    def refuse(self, *args, **kwargs):
        raise AssertionError("a tensor was read on the host")

    with monkeypatch.context() as m:
        for name in _READS:
            m.setattr(torch.Tensor, name, refuse)
        yield


@pytest.mark.parametrize("rgbd", [False, True])
def test_segments_read_nothing_on_the_host(rgbd, frames, monkeypatch):
    """``_front`` and ``_back`` (a starve frame, the phase on the device)
    and the make_step functions around them (the view half, the staging,
    the front after the view) make no host read; the step reads ``valid``
    and the maintain flags between them."""
    cfg = convert.config_from(dataclasses.replace(
        CFG, tracker=dataclasses.replace(CFG.tracker, use_rgbd=rgbd)))
    step = teng.make_step(cfg)
    state = teng.create(cfg, initial_pose=frames[0][0], device="cpu")
    for _, d, c in frames[:2]:
        state, _ = step(state, torch.from_numpy(d), torch.from_numpy(c))
    d, c = torch.from_numpy(frames[2][1]), torch.from_numpy(frames[2][2])
    with _no_host_reads(monkeypatch):
        front = teng._front(state, d, c, cfg)
        teng._back(state.map, front.frame, front.tr.pose, cfg,
                   torch.tensor(4, dtype=torch.int32), True,
                   reuse_active=front.reuse, model_depth=front.model_depth)
        view = step._view_fn()
        step._stage({"depth": d, "color": c}, ("depth", "color"))
        f2 = step._front_fn(view)
        step._back_fn(True, f2)
    assert bool(front.tr.valid)


def test_donation():
    """``donate=False`` leaves the given state bit-equal and returns
    copies; ``donate=True`` returns the step's own tensors, the given pool
    among them (updated in place), and copies nothing in on the next
    call."""
    cfg = convert.config_from(CFG)
    poses = make_trajectory(3)
    ins = []
    for i, pose in enumerate(poses):
        d, c = render_depth(pose, CAM, Scene(), noise_sigma=0.002, seed=i)
        ins.append((d, c))               # numpy inputs: staged as given
    for donate in (False, True):
        step = teng.make_step(cfg, donate=donate)
        s = teng.create(cfg, initial_pose=poses[0], device="cpu")
        s, _ = step(s, *ins[0])
        s, _ = step(s, *ins[1])
        kept = teng._clone_state(s)
        new, diag = step(s, *ins[2])
        assert bool(diag.tracking_valid) and new.frame_host == 3
        if donate:
            assert all(x is y for x, y in zip(new.map, s.map))
            assert not torch.equal(kept.map.weight, s.map.weight)
            adopted = step.bytes_adopted
            step(new, *ins[2])
            assert step.bytes_adopted == adopted
            assert step.pool_bytes_adopted == 0
        else:
            assert _states_equal(kept, s)
            assert not any(x.data_ptr() == y.data_ptr()
                           for x, y in zip(new.map, step._buf.map))
        step.close()


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _Kernel:
    launches = 0


def test_counted_graph_bookkeeping():
    """A capture takes back the launch counts its wrappers added (a capture
    launches nothing); every replay adds them again."""
    kernel, other = _Kernel(), _Kernel()
    kernel.launches, other.launches = 5, 2
    counters = ((kernel, "launches"), (other, "launches"))

    def fn():
        kernel.launches += 3              # three launches captured
        return "out"

    fake = _FakeGraph()
    g = teng.capture(fn, fake, contextlib.nullcontext(), counters)
    assert g.out == "out" and g.counts == {(kernel, "launches"): 3}
    assert (kernel.launches, other.launches) == (5, 2)
    for _ in range(4):
        g.replay()
    assert fake.replays == 4
    assert (kernel.launches, other.launches) == (5 + 12, 2)


def test_inputs_must_keep_their_shape():
    cfg = convert.config_from(CFG)
    step = teng.make_step(cfg)
    d, c = render_depth(make_trajectory(1)[0], CAM, Scene(), seed=0)
    s = teng.create(cfg, device="cpu")
    s, _ = step(s, d, c)
    with pytest.raises(ValueError):
        step(s, d[:-1], c)
    with pytest.raises(ValueError):
        step(s, d, None)
    with pytest.raises(TypeError):
        step(s, d, c, np.eye(4))
