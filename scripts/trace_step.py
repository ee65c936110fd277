"""Trace the graphed step of one benchmark cell on the card
(a ``diagnostics.StepTracer`` as ``engine.make_step``'s step's ``trace``):

    python3 scripts/trace_step.py --workload vh_4mm_icp_splat.room_orbit \
        --seed 7 [--rounds 4] [--out out/trace.jsonl]

The cell's configuration, lap and frame loop are the benchmark's
(``vhbench/harness.py``): one lap of set-up (every untraced graph
captured), then the untraced graphs' node counts; laps with the tracer
off and on in turns (off, on, on, off, ...; one traced lap first captures
the traced graphs), each timed as the benchmark's window times a frame;
one traced lap read by ``diagnostics.trace_summary`` (all its frames, the
starve frames and the others apart; the anchors' jitter, the stamps'
smallest step, the stamps against the spans that bound them, the host
time of ``step`` outside its child spans); the host syncs of 16 traced
frames, by frame; and the benchmark's eager stage split of the same cell
for comparison, all in one JSON line (also appended to ``--out``). Then,
the device's part of the tracer's cost: the view, front and back graphs
replayed as a frame without its host reads, untraced and traced in
turns, in a second line (the frame's inputs stay those of the last
frame). A cell that streams adds a lap with the streaming manager's
tracer (``diagnostics.StreamTracer``): its spans and counters, the bytes
the step adopted a frame and the manager's graph replays a half
(``stream``). On a tree whose program has no tracer it prints the node
counts alone.
"""

import argparse
import gc
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def lap_frames(prog, k: int, n: int):
    """``n`` frames from ``k`` through the benchmark window's per-frame
    loop: (frames/s on the host clock, each frame's CUDA-event ms, the
    next frame)."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    times = []
    t0 = time.perf_counter()
    for _ in range(n):
        a.record()
        prog.frame(k)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        bool(prog.lost)
        k += 1
    return n / (time.perf_counter() - t0), times, k


def replay_ms(step, n: int = 20) -> dict:
    """Median device ms of the view and front graphs and of the view,
    front and back graphs together, untraced and traced in turns
    (untraced, traced, traced, untraced, ...), ``n`` of each, between CUDA
    events, and the host ms of their launch calls."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    ms = {}
    for keys in (("view", "front"), ("view", "front", "back")):
        for r in range(2 * n):
            name = "untraced" if r % 4 in (0, 3) else "traced"
            graphs = step.graphs if name == "untraced" else step.traced
            label = f"{'+'.join(keys)} {name}"
            a.record()
            t0 = time.perf_counter()
            for key in keys:
                graphs[key].graph.replay()
            t1 = time.perf_counter()
            b.record()
            b.synchronize()
            ms.setdefault(label, []).append(a.elapsed_time(b))
            ms.setdefault(label + " launch (host)", []).append(
                1000 * (t1 - t0))
    return {k: statistics.median(v) for k, v in ms.items()}


def causality(recs) -> dict:
    """How the anchored stamps sit against the host spans that bound them
    (us; negative: the stamp placed before what caused it): a segment's
    start after its replay span's start, the back segment's end before the
    read of the flags returned."""
    lead, lag = [], []
    for f in recs:
        if f.eager or f.captured or not f.anchored:
            continue
        seg = dict(f.segments)
        for sp in f.spans:
            if sp.name == "replay" and sp.key in seg:
                lead.append((dict(seg[sp.key])["start"] - sp.start_ns) / 1e3)
            if sp.name == "read_flags":
                ends = [dict(st)["end"] for k, st in f.segments
                        if k.startswith("back")]
                lag += [(sp.end_ns - e) / 1e3 for e in ends]
    return {name: {"min": min(v), "median": statistics.median(v)}
            for name, v in (("start_after_launch", lead),
                            ("end_before_read", lag)) if v}


def quartiles(v):
    q = statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3
    return {"median": q[1], "q1": q[0], "q3": q[2],
            "max_abs": max(abs(x) for x in v)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=4,
                    help="pairs of off/on laps for the tracer's cost")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-2:])
    sys.path.insert(0, str(ROOT))
    import torch
    torch.set_num_threads(1)
    from vhbench import harness as H
    from vhbench.traffic import generator
    from voxelhashing_tpu_torch import diagnostics as dg

    bench = H.load_benchmark(ROOT)
    wl, conf_entry, _, _ = H.cell_of(bench, args.workload)
    with open(ROOT / conf_entry["file"]) as f:
        conf = json.load(f)
    cfg = H.program_config(conf["engine"])
    mix = generator.load_mix(wl["traffic"], ROOT / "vhbench" / "traffic")
    dev = torch.device("cuda")
    out = {"workload": args.workload, "seed": args.seed,
           "card": H.gpu_line()}
    lap = generator.make_lap(mix, cfg.camera, args.seed, dev)
    prog = H.Program(cfg, lap, dev, bool(mix.get("sessions")))
    n = len(lap.poses)
    for i in range(n):
        prog.frame(i)
        prog.sync()
    k = n
    gc.collect()
    gc.freeze()
    out["nodes"] = {key: g.nodes for key, g in prog.step.graphs.items()}
    if not hasattr(dg, "StepTracer"):
        print(json.dumps(out), flush=True)
        return 0

    tr = dg.StepTracer()
    prog.step.trace = tr
    _, _, k = lap_frames(prog, k, n)            # captures the traced graphs
    out["traced_nodes"] = {key: g.nodes
                           for key, g in prog.step.traced.items()}
    fps = {"off": [], "on": []}
    ms = {"off": [], "on": []}
    for r in range(2 * args.rounds):
        mode = "off" if r % 4 in (0, 3) else "on"
        prog.step.trace = tr if mode == "on" else None
        f, t, k = lap_frames(prog, k, n)
        fps[mode].append(f)
        ms[mode].append(statistics.median(t))
    out["fps"], out["frame_ms_median"] = fps, ms

    prog.step.trace = tr
    first = len(tr.frames)
    _, _, k = lap_frames(prog, k, n)
    prog.step.trace = None
    recs = tr.records()[first:]
    out["summary"] = dg.trace_summary(recs)
    parts = {"starve": [], "other": []}
    for f in recs:
        s = dg.trace_summary([f])
        if s["frames"]:
            starve = any(key.endswith("_starve") for key, _ in f.segments)
            parts["starve" if starve else "other"].append(s)
    out["split"] = {
        name: {m: statistics.mean(s[m] for s in v if s.get(m) is not None)
               for m in ("preprocess_graph_ms", "compactify_graph_ms",
                         "render_graph_ms", "track_graph_ms",
                         "map_update_graph_ms", "front_cover", "back_cover")
               if any(s.get(m) is not None for s in v)}
        for name, v in parts.items() if v}
    out["anchor_gap_ms"] = (quartiles(tr.anchor_gaps_ms)
                            if tr.anchor_gaps_ms else None)
    out["causality_us"] = causality(recs)
    own = [(f.spans[0].end_ns - f.spans[0].start_ns
            - sum(sp.end_ns - sp.start_ns for sp in f.spans if sp.parent == 0))
           / 1e3 for f in recs if not (f.eager or f.captured)]
    out["step_own_host_us"] = statistics.mean(own) if own else None
    diffs = [b - a for f in recs for _, st in f.segments
             for (_, a), (_, b) in zip(st, st[1:])]
    out["stamp_steps_ns"] = {"smallest": min((d for d in diffs if d > 0),
                                             default=None),
                             "gcd": math.gcd(*diffs) if diffs else None}

    if prog.mgr is not None and hasattr(dg, "StreamTracer"):
        out["stream"], k = stream_lap(prog, k, n, dg.StreamTracer())

    prog.step.trace = tr
    syncs = {}
    for _ in range(H.SYNC_FRAMES):
        with H.sync_count() as count:
            prog.frame(k)
        syncs[prog.host_index(k)] = count[0]
        k += 1
    prog.sync()
    prog.step.trace = None
    out["syncs_by_frame"] = syncs

    stage_ms, _, k = H.stage_split(prog, cfg, k)
    prog.frame(k)
    prog.sync()
    out["eager_stage_ms"] = stage_ms
    emit(out, args.out)
    if prog.step.traced:
        emit({"workload": args.workload,
              "graph_replay_ms": replay_ms(prog.step)}, args.out)
    prog.step.close()
    return 0


def stream_lap(prog, k: int, n: int, st):
    """A lap with the streaming manager's tracer set (the step's off):
    its spans and counters (``diagnostics.StreamTracer.summary``), the
    bytes the step adopted a frame (table fields and pool rows apart),
    the manager's graph replays a half, and frames/s beside an untraced
    lap's."""
    mgr, step = prog.mgr, prog.step
    fps_off, _, k = lap_frames(prog, k, n)
    adopted = (step.bytes_adopted, step.pool_bytes_adopted)
    replays, halves = mgr.replays, prog.halves
    mgr.trace = st
    fps_on, _, k = lap_frames(prog, k, n)
    prog.settle()
    mgr.trace = None
    out = st.summary()
    out.update(
        bytes_adopted_per_frame=(step.bytes_adopted - adopted[0]) / n,
        pool_bytes_adopted_per_frame=(step.pool_bytes_adopted
                                      - adopted[1]) / n,
        replays_per_half=(mgr.replays - replays) / max(
            prog.halves - halves, 1),
        fps_untraced=fps_off, fps_traced=fps_on)
    return out, k


def emit(out: dict, path) -> None:
    line = json.dumps(out)
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.exit(main())
