"""The host schedule of ``engine.make_step``'s step (``GraphStep``): the
order in which a graphed frame replays its segments, stages its inputs,
copies its diagnostics and makes its two reads, and that the diagnostics
so copied are those of the eager ``engine.step``, bit for bit, on every
frame (a maintenance frame and a lost frame among them). On a CPU state
the segments run eagerly in the graphed order. The file imports only the
port; the card's test (graphs against eager) is in
``tests/test_torch_kernels_cuda.py``.
"""

import dataclasses

import pytest
import torch

from voxelhashing_tpu_torch import blockmap, engine
from voxelhashing_tpu_torch import geometry as geom
from voxelhashing_tpu_torch.config import (CameraConfig, EngineConfig,
                                           FilterConfig, MapConfig,
                                           TrackerConfig)
from voxelhashing_tpu_torch.io.synthetic import (Scene, make_trajectory,
                                                 render_depth)

CAM = CameraConfig(width=64, height=48, fx=52.0, fy=52.0, cx=31.5, cy=23.5)
CFG = EngineConfig(
    camera=CAM,
    map=MapConfig(voxel_size=0.04, truncation=0.12, truncation_scale=0.01,
                  num_blocks=2048, table_size=4096, max_active_blocks=2048,
                  gc_enabled=True, gc_starve_interval=3),
    tracker=TrackerConfig(levels=2, max_outer_iter=(3, 2),
                          max_inner_iter=(1, 1)),
    filter=FilterConfig(depth_filter=False), offline=False)
N_LAP = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lap():
    poses = make_trajectory(N_LAP)
    return poses, [render_depth(p, CAM, Scene(), noise_sigma=0.002, seed=i,
                                device="cpu") for i, p in enumerate(poses)]


def _lost(frame):
    """The frame with no valid depth: the tracker finds no
    correspondence."""
    d, c = frame
    return torch.full_like(d, float("nan")), c


def _recorded(step, monkeypatch, log):
    """``step`` with its segment runs, its staging, the copies of its
    diagnostics and its two reads appended to ``log`` as they are
    issued."""
    run, stage = step._run, step._stage
    front_diag, back_diag = engine._front_diagnostics, \
        engine._back_diagnostics
    need = blockmap.need_maintain
    to_bool = torch.Tensor.__bool__

    def run_(key, fn, tr=None):
        log.append(key)
        return run(key, fn, tr)

    def stage_(given, names, last=True):
        log.append(("stage",) + tuple(names))
        return stage(given, names, last)

    def front_(front):
        log.append("copy front")
        return front_diag(front)

    def back_(cfg, back, map_state):
        log.append("copy back")
        return back_diag(cfg, back, map_state)

    def need_(flags, cfg, frame_idx):
        log.append("read flags")
        return need(flags, cfg, frame_idx)

    def bool_(t):
        log.append("read valid")
        return to_bool(t)

    step._run, step._stage = run_, stage_
    monkeypatch.setattr(engine, "_front_diagnostics", front_)
    monkeypatch.setattr(engine, "_back_diagnostics", back_)
    monkeypatch.setattr(blockmap, "need_maintain", need_)
    monkeypatch.setattr(torch.Tensor, "__bool__", bool_)


@pytest.mark.parametrize("variant", ["depth", "rgbd", "hint"])
def test_graphed_frame_issues_its_host_work_behind_a_graph(variant, lap,
                                                           monkeypatch):
    """Frames 1-5 (frame 3 starves, frame 5 is lost) of a depth-only, an
    RGB-D and a hinted step (``use_trajectory_only_init``: the view renders
    at the hint, staged before it): the view segment, the inputs staged,
    the front segment, its diagnostics copied, ``valid`` read, the back
    segment, its diagnostics copied, the flags read; a lost frame copies
    the back's fields after its read."""
    poses, frames = lap
    cfg = CFG
    if variant == "rgbd":
        cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(
            cfg.tracker, use_rgbd=True))
    hint = variant == "hint"
    if hint:
        cfg = dataclasses.replace(cfg, use_trajectory_only_init=True)
    step = engine.make_step(cfg, with_hint=hint)
    state = engine.create(cfg, initial_pose=poses[0], device="cpu")
    extra = (lambda i: (poses[i],)) if hint else (lambda i: ())
    state, _ = step(state, *frames[0], *extra(0))
    log = []
    with monkeypatch.context() as m:
        _recorded(step, m, log)
        for i in range(1, 6):
            log.append(i)
            d, c = _lost(frames[i]) if i == 5 else frames[i]
            state, diag = step(state, d, c, *extra(i))
    staged = [("stage", "hint")] if hint else []
    inputs = ("stage", "depth", "color")
    want = []
    for i in range(1, 6):
        back = "back_starve" if i % 3 == 0 else "back"
        want += [i] + staged + ["view", inputs, "front", "copy front",
                                "read valid"]
        want += ["copy back"] if i == 5 else [back, "copy back",
                                              "read flags"]
    assert log == want
    assert not bool(diag.tracking_valid)
    assert step.inputs_behind == 0          # no graph queued on the CPU
    step.close()


def _with_garbage(state, cfg):
    """``state`` with empty blocks allocated behind the scene's wall (in
    view): no frame updates them, so GC culls them and their table slots
    become tombstones, past an eighth of the 4,096-slot table."""
    mp = cfg.map
    vox = mp.voxel_size * 8
    b = torch.stack(torch.meshgrid(
        torch.arange(-7, 8), torch.arange(-5, 5),
        torch.arange(int(2.9 / vox), int(2.9 / vox) + 6), indexing="ij"),
        dim=-1).reshape(-1, 3).to(torch.int32)
    keys = geom.pack_block_key(b, mp.world_blocks)
    m, n = blockmap.allocate(state.map, keys, mp, rounds=8)
    assert int(n) > 512
    return state._replace(map=m)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _equal(a, b):
    return a.dtype == b.dtype and torch.equal(torch.nan_to_num(_bits(a)),
                                              torch.nan_to_num(_bits(b)))


def test_graphed_diagnostics_are_the_eager_ones_and_copies(lap):
    """20 frames (the lap there and back) through ``make_step`` and the
    eager step, empty blocks behind the wall after frame 1 (GC culls them:
    a maintenance frame), frame 12 lost: every state field and diagnostic
    bit-equal on every frame, and each frame's diagnostics unchanged by the
    calls after it."""
    poses, frames = lap
    order = list(range(N_LAP)) + list(range(N_LAP - 2, -1, -1)) + [1, 2, 3,
                                                                  4, 5]
    order = order[:20]
    a = engine.create(CFG, initial_pose=poses[0], device="cpu")
    b = engine.create(CFG, initial_pose=poses[0], device="cpu")
    step = engine.make_step(CFG)
    kept, diags, maintained, lost = [], [], 0, 0
    for n, i in enumerate(order):
        if n == 2:
            a, b = _with_garbage(a, CFG), _with_garbage(b, CFG)
        d, c = _lost(frames[i]) if n == 12 else frames[i]
        before = int(a.map.n_tombstones)
        a, da = engine.step(a, d, c, CFG)
        b, db = step(b, d, c)
        maintained += int(a.map.n_tombstones) < before
        lost += not bool(da.tracking_valid)
        for (name, x), (_, y) in zip(engine._state_tensors(a),
                                     engine._state_tensors(b)):
            assert _equal(x, y), (n, name)
        assert all(_equal(x, y) for x, y in zip(da, db)), n
        kept.append([t.clone() for t in db])
        diags.append(db)
    assert maintained > 0 and lost == 1
    assert step.pool_bytes_adopted > 0      # the compacted pool taken in
    for n, (k, db) in enumerate(zip(kept, diags)):
        assert all(_equal(x, y) for x, y in zip(k, db)), n
    step.close()
