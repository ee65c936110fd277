"""The step tracer (``diagnostics.StepTracer``, a step's ``trace``): a
traced step leaves the state, the diagnostics and the launch counts as an
untraced one does; its host spans nest under ``step``; its stage marks
come in ``engine.STAGES`` order; its counters are what the host reads from
the state before and after; ``diagnostics.trace_summary`` on a hand-made
trace. The CPU tests run the segments eagerly on a 64x48 map (frames 3
and 6 starve). On a machine with a card:

    python -m pytest --noconftest -m cuda tests/test_torch_trace.py

holds the traced graphs against the untraced ones: the state bit-equal,
the untraced graphs' node counts those of a step that never traced, two
host syncs in a traced graphed frame. The file imports only the port.
"""

import dataclasses

import pytest
import torch

from voxelhashing_tpu_torch import diagnostics as dg, engine
from voxelhashing_tpu_torch.config import (CameraConfig, EngineConfig,
                                           FilterConfig, MapConfig,
                                           TrackerConfig)
from voxelhashing_tpu_torch.geometry import INVALID_KEY
from voxelhashing_tpu_torch.io.synthetic import (Scene, make_trajectory,
                                                 render_depth)

CAM = CameraConfig(width=64, height=48, fx=52.0, fy=52.0, cx=31.5, cy=23.5)
CFG = EngineConfig(
    camera=CAM,
    map=MapConfig(voxel_size=0.04, truncation=0.12, truncation_scale=0.01,
                  num_blocks=2048, table_size=8192, max_active_blocks=2048,
                  gc_enabled=True, gc_starve_interval=3),
    tracker=TrackerConfig(levels=2, max_outer_iter=(3, 2),
                          max_inner_iter=(1, 1)),
    filter=FilterConfig(depth_filter=False), offline=False)
N_FRAMES = 7
VIEW = ("start", "compactify", "render", "end")
FRONT = ("start", "preprocess", "track", "counters", "end")
BACK = ("start",) + engine.STAGES[4:] + ("counters", "end")
FUSED = ("start",) + engine.STAGES + ("counters", "end")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lap():
    poses = make_trajectory(N_FRAMES)
    return poses, [render_depth(p, CAM, Scene(), noise_sigma=0.002, seed=i,
                                device="cpu") for i, p in enumerate(poses)]


def _launches():
    return [getattr(o, a) for o, a in engine._launch_counters()]


def _run(lap, trace, replay=False, device="cpu"):
    """The lap through ``make_step``; (state, each frame's diagnostics,
    launches, the states before each frame)."""
    poses, frames = lap
    cfg = dataclasses.replace(CFG, use_trajectory=replay)
    state = engine.create(cfg, initial_pose=poses[0], device=device)
    step = engine.make_step(cfg, with_hint=replay)
    step.trace = trace
    c0 = _launches()
    diags, befores = [], []
    for (d, c), p in zip(frames, poses):
        befores.append(state.map._replace(
            block_key=state.map.block_key.clone(),
            n_free=state.map.n_free.clone()))
        state, diag = step(state, d, c, *((p,) if replay else ()))
        diags.append(diag)
    launches = [n - m for n, m in zip(_launches(), c0)]
    step.close()
    return state, diags, launches, befores


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("replay", [False, True], ids=["tracked", "replay"])
def test_tracer_leaves_the_step_as_it_is(lap, replay):
    a, da, la, _ = _run(lap, None, replay)
    tr = dg.StepTracer()
    b, db, lb, _ = _run(lap, tr, replay)
    for x, y in zip(engine._state_tensors(a), engine._state_tensors(b)):
        assert torch.equal(_bits(x[1]), _bits(y[1])), x[0]
    for fa, fb in zip(da, db):
        for x, y in zip(fa, fb):
            assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))
    assert la == lb
    assert [f.host for f in tr.records()] == list(range(N_FRAMES))


def test_spans_nest_in_order_and_marks_follow_the_stages(lap):
    tr = dg.StepTracer()
    _run(lap, tr)
    for f in tr.records():
        step = f.spans[0]
        assert step.name == "step" and step.parent == -1
        assert all(s.frame == f.host for s in f.spans)
        for s in f.spans[1:]:
            p = f.spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        ends = [s.end_ns for s in f.spans[1:]]
        assert ends == sorted(ends)
        names = [(s.name, s.key) for s in f.spans[1:]]
        labels = [(k, tuple(lab for lab, _ in st)) for k, st in f.segments]
        if f.host == 0:
            assert f.eager and names == [("inputs", None)]
            assert labels == [("eager", ("start",) + engine.STAGES
                               + ("counters", "end"))]
            continue
        back = "back_starve" if f.host % 3 == 0 else "back"
        assert names == [("inputs", None), ("replay", "view"),
                         ("inputs", None), ("replay", "front"),
                         ("diagnostics", None), ("read_valid", None),
                         ("replay", back), ("diagnostics", None),
                         ("read_flags", None)]
        assert labels == [("view", VIEW), ("front", FRONT), (back, BACK)]
        assert not f.inputs_behind          # no graph queued on the CPU
        for _, st in f.segments:
            t = [ns for _, ns in st]
            assert t == sorted(t)


def test_counters_are_what_the_state_reads(lap):
    tr = dg.StepTracer()
    state, diags, _, befores = _run(lap, tr)
    afters = befores[1:] + [state.map]
    for f, diag, before, after in zip(tr.records(), diags, befores, afters):
        c = f.counts
        live = int(torch.sum(~torch.isnan(diag.icp_iter_residuals)))
        assert c["icp_live_iters"] == live
        assert c["blocks_inserted"] - c["blocks_freed"] == \
            int(before.n_free) - int(after.n_free)
        # rows taken and rows given back; a row inserted and freed in the
        # same frame shows in neither
        was = before.block_key != INVALID_KEY
        now = after.block_key != INVALID_KEY
        taken, freed = int(torch.sum(~was & now)), int(torch.sum(was & ~now))
        assert c["blocks_inserted"] - taken == c["blocks_freed"] - freed >= 0
    counts = [f.counts for f in tr.frames]
    assert sum(c["blocks_inserted"] for c in counts) > 0
    assert 0 < sum(c["icp_live_iters"] for c in counts) \
        < (N_FRAMES - 1) * sum(CFG.tracker.max_outer_iter)


def test_spans_are_profiler_ranges(lap):
    from torch.profiler import ProfilerActivity, profile
    tr = dg.StepTracer()
    poses, frames = lap
    state = engine.create(CFG, initial_pose=poses[0], device="cpu")
    step = engine.make_step(CFG)
    step.trace = tr
    state, _ = step(state, *frames[0])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = step(state, *frames[1])
    step.close()
    names = {e.name for e in prof.events()}
    assert {"vh:step", "vh:inputs", "vh:replay", "vh:read_valid",
            "vh:read_flags", "vh:diagnostics"} <= names


MS = 1_000_000      # ns


def _frame(host, t0, extra=0.0, key="back", eager=False, captured=False,
           counts=(3, 20, 2), behind=True):
    """A hand-made graphed frame from ``t0`` ms: spans and stamps (ms after
    ``t0``) as the comments below, the back segment and the spans after it
    ``extra`` ms longer; the next frame starts 2.5 + ``extra`` ms on."""
    def S(name, key, a, b):
        return dg.Span(name, key, round((t0 + a) * MS),
                       round((t0 + b) * MS), -1 if name == "step" else 0,
                       host)
    x = extra
    # adopt; the view's launch; the inputs staged behind it; the front's
    # launch and its copies; the read; the back's launch and its copies
    spans = [S("step", None, 0.0, 1.75 + x), S("inputs", None, 0.0, 0.05),
             S("replay", "view", 0.05, 0.1), S("inputs", None, 0.1, 0.4),
             S("replay", "front", 0.4, 0.45),
             S("diagnostics", None, 0.45, 0.55),
             S("read_valid", None, 0.55, 1.0), S("replay", key, 1.0, 1.1),
             S("diagnostics", None, 1.1, 1.2),
             S("read_flags", None, 1.2, 1.7 + x)]

    def st(pairs):
        return tuple((lab, round((t0 + t) * MS)) for lab, t in pairs)
    view = st(zip(VIEW, (0.08, 0.38, 0.58, 0.585)))
    front = st(zip(FRONT, (0.59, 0.61, 0.95, 0.955, 0.96)))
    back = st(zip(BACK, (1.15, 1.25, 1.45, 1.55 + x, 1.62 + x, 1.64 + x,
                         1.65 + x)))
    return dg.FrameTrace(host, host, spans,
                         [("view", view), ("front", front), (key, back)],
                         dict(zip(dg.TRACE_COUNTERS, counts)), eager=eager,
                         captured=captured, inputs_behind=behind)


def test_trace_summary_on_a_hand_made_trace():
    # frame 0 eager and frame 1 captured: left out, whatever they read;
    # frame 5's inputs staged with no graph queued
    frames = [_frame(0, 0.0, 9.0, eager=True, counts=(0, 999, 0)),
              _frame(1, 20.0, 5.0, "back_starve", captured=True,
                     counts=(18, 999, 99)),
              _frame(2, 30.0),
              _frame(3, 32.5, 0.4, "back_starve", counts=(5, 0, 10)),
              _frame(4, 35.4),
              _frame(5, 37.9, behind=False)]
    s = dg.trace_summary(frames)
    assert s["frames"] == 4 and s["starve_frames"] == 1
    assert s["windows"] == 3          # frame 5 has no next frame
    assert s["inputs_behind_share"] == pytest.approx(4 / 5)
    ap = pytest.approx
    # compactify and render from the view segment, preprocess and track
    # from the front segment
    assert s["preprocess_graph_ms"] == ap(0.02)
    assert s["compactify_graph_ms"] == ap(0.3)
    assert s["render_graph_ms"] == ap(0.2)
    assert s["track_graph_ms"] == ap(0.34)
    assert s["map_update_graph_ms"] == ap((0.4 * 3 + 0.8) / 4)
    # the counters' work (0.005 ms in front, 0.01 in back) is the tracer's
    assert s["front_cover"] == ap((0.5 + 0.36) / (0.505 + 0.365))
    assert s["back_cover"] == ap((0.4 * 3 + 0.8) / (0.49 * 3 + 0.89))
    assert s["maintain_graph_ms"] == ap(0.07)
    assert s["tracer_graph_ms"] == ap(0.015)
    assert s["starve_extra_ms"] == ap(0.4)
    # each window: idle [0, 0.08] (inputs to 0.05, then the view's
    # replay), [0.585, 0.59] (read_valid), [0.96, 1.15] (read_valid to
    # 1.0, replay to 1.1, diagnostics), [1.65, 2.5] (read_flags to 1.7,
    # step to 1.75, then caller); the staging and the front's copies lie
    # under the view and front segments
    assert s["idle_inputs_ms"] == ap(0.05)
    assert s["idle_launch_ms"] == ap(0.13)
    assert s["idle_reads_ms"] == ap(0.095)
    assert s["idle_diag_ms"] == ap(0.05)
    assert s["idle_caller_ms"] == ap(0.75)
    assert s["idle_by_span"]["step"] == ap(0.05)
    assert s["wall_ms"] == ap(2.5 + 0.4 / 3)
    assert s["busy_ms"] == ap(1.375 + 0.4 / 3)
    assert s["idle_ms"] == ap(sum(s["idle_by_span"].values()))
    assert s["icp_live_iters_per_frame"] == ap(3.5)
    assert s["blocks_inserted_per_frame"] == ap(15.0)
    assert s["blocks_freed_per_frame"] == ap(4.0)


def test_trace_summary_leaves_out_unanchored_frames_and_reads_fused():
    f = _frame(2, 30.0)
    f.anchored = False
    # a trajectory-replay frame: its inputs staged, one fused segment
    # (0.35 to 1.65), the flags read, its diagnostics copied
    t0 = 32.5
    fused = _frame(3, t0, behind=False)
    fused.spans = [dg.Span(name, key, round((t0 + a) * MS),
                           round((t0 + b) * MS), -1 if name == "step" else 0,
                           3)
                   for name, key, a, b in (
                       ("step", None, 0.0, 2.0), ("inputs", None, 0.0, 0.3),
                       ("replay", "fused", 0.3, 0.4),
                       ("read_flags", None, 0.4, 1.7),
                       ("diagnostics", None, 1.7, 1.9))]
    fused.segments = [("fused", tuple(
        (lab, round((t0 + t) * MS)) for lab, t in zip(
            FUSED, (0.35, 0.45, 0.65, 0.75, 0.95, 1.25, 1.45, 1.55, 1.62,
                    1.64, 1.65))))]
    s = dg.trace_summary([f, fused, _frame(4, 35.0)])
    assert s["frames"] == 2 and s["windows"] == 1
    assert s["inputs_behind_share"] == pytest.approx(2 / 3)
    # the fused segment's track to gc, and frame 4's back segment
    assert s["map_update_graph_ms"] == pytest.approx((0.6 + 0.4) / 2)
    assert s["compactify_graph_ms"] == pytest.approx((0.2 + 0.3) / 2)
    # one segment from 0.35 to 1.65: no idle between front and back
    assert s["idle_inputs_ms"] == pytest.approx(0.3)
    assert s["idle_launch_ms"] == pytest.approx(0.05)
    assert s["idle_reads_ms"] == pytest.approx(0.05)
    assert s["idle_diag_ms"] == pytest.approx(0.2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_traced_graphs_on_the_card(cuda):
    """12 frames (starve frames 3, 6 and 9) through a step that is never
    traced and one traced on frames 4-8 and, by a second tracer (its own
    traced graphs), on frames 10-11: the same state bit for bit, the
    untraced graphs' node counts equal, two host syncs in traced frame 11,
    the counters those the state reads, every timed frame's stamps in
    order inside its step. A tracer's first frame has no anchor before it
    and frames 4, 6 and 10 capture; an anchor whose launch the host took
    long over is dropped, so a frame after it may go untimed."""
    cam = CameraConfig(width=128, height=96, fx=104.0, fy=104.0, cx=63.5,
                       cy=47.5)
    cfg = dataclasses.replace(CFG, camera=cam, map=dataclasses.replace(
        CFG.map, voxel_size=0.02, truncation=0.06, num_blocks=4096,
        table_size=16384, max_active_blocks=4096))
    poses = make_trajectory(12)
    frames = [render_depth(p, cam, Scene(), noise_sigma=0.002, seed=i,
                           device=cuda) for i, p in enumerate(poses)]
    sa, sb = engine.make_step(cfg), engine.make_step(cfg)
    try:
        _hold_traced_graphs(cfg, poses, frames, sa, sb)
    finally:
        sa.close()
        sb.close()


def _hold_traced_graphs(cfg, poses, frames, sa, sb):
    from vhbench.harness import sync_count
    dev = frames[0][0].device
    tr, tr2 = dg.StepTracer(), dg.StepTracer()
    a = engine.create(cfg, initial_pose=poses[0], device=dev)
    b = engine.create(cfg, initial_pose=poses[0], device=dev)
    n_free, diags = [], []
    for i, (d, c) in enumerate(frames):
        a, _ = sa(a, d, c)
        sb.trace = tr if 4 <= i <= 8 else tr2 if i >= 10 else None
        n_free.append(int(b.map.n_free))
        if i == 11:
            with sync_count() as syncs:
                b, db = sb(b, d, c)
        else:
            b, db = sb(b, d, c)
        diags.append(db)
    n_free.append(int(b.map.n_free))
    assert syncs[0] == 2, syncs
    for x, y in zip(engine._state_tensors(a), engine._state_tensors(b)):
        assert torch.equal(_bits(x[1]), _bits(y[1])), x[0]
    keys = {"view", "front", "back", "back_starve"}
    assert set(sa.graphs) == set(sb.graphs) == keys
    assert set(sb.traced) == {"view", "front", "back"}      # tr2's
    for k in keys:
        assert sb.graphs[k].nodes == sa.graphs[k].nodes
    for k in sb.traced:
        assert sb.traced[k].nodes > sa.graphs[k].nodes
    for t, hosts, timed in ((tr, [4, 5, 6, 7, 8], [5, 7, 8]),
                            (tr2, [10, 11], [11])):
        recs = t.records()
        assert [f.host for f in recs] == hosts
        got = [f.host for f in recs if f.anchored and not f.captured]
        assert set(got) <= set(timed), (got, timed)
        for f in recs:
            c, i = f.counts, f.host
            assert c["icp_live_iters"] == int(torch.sum(~torch.isnan(
                diags[i].icp_iter_residuals))), (i, c)
            assert c["blocks_inserted"] - c["blocks_freed"] == \
                n_free[i] - n_free[i + 1], (i, c, n_free[i], n_free[i + 1])
            assert c["blocks_inserted"] >= 0 and c["blocks_freed"] >= 0, c
            if f.host in got:
                lo, hi = f.spans[0].start_ns, f.spans[0].end_ns
                t0 = lo
                for key, st in f.segments:
                    ns = [v for _, v in st]
                    assert ns == sorted(ns) and t0 <= ns[0] < ns[-1] <= hi, \
                        (i, key, [v - lo for v in ns], hi - lo)
                    t0 = ns[-1]
        summary = dg.trace_summary(recs)
        assert summary["frames"] == len(got)
        assert summary["inputs_behind_share"] == 1.0
        assert all(f.inputs_behind for f in recs)
    assert sum(f.counts["icp_live_iters"] for f in tr.records()) > 0
    assert tr.frames[-1].anchored, "frame 8 from frame 7's anchor"
