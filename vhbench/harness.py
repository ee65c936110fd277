"""The benchmark of ``voxelhashing_tpu_torch``: one cell of
``BENCHMARK.json`` a run.

    python3 vhbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell names a configuration (``configs/<name>.json``: the program's
``EngineConfig`` groups under ``engine``, the source, the limits of the
comparison under ``check``) and a traffic mix (``traffic/<name>.json``,
read by ``traffic/generator.py``). Per-layer metrics are readers of their
own (``layer_metrics/<name>.py``, a ``read(ctx)`` that returns a number or
None). The harness finds each by its name in ``BENCHMARK.json``.

The run: the lap of frames is made from the seed and kept in host memory;
``engine.make_step(cfg, donate=True)`` runs one whole lap (set-up: it
builds the map the window revisits and captures every graph the window
replays); then the window hands frame after frame to the step as soon as
the previous call returned, reads each frame's pose back to the host, and
runs for ``--seconds``. ``--trace 1`` profiles a sub-window of one whole
lap inside the window and, once it has closed, splits a few eager frames
by stage. Every run then holds the program to the reference
(``check.py``) and prints one JSON line last.

A configuration that streams runs its map out of core as ``run_slam``'s
live loop does: the step takes the streaming manager's bitmask, and each
frame's streaming half (the manager's step at the frame's tracked
position) runs at the start of the next frame's call, once the window
has read that position back (:class:`Program`); the check then holds the
streamed frames, the host store and the bitmask to the reference's.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import importlib.util
import json
import os
import resource
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "voxelhashing_tpu")
STAGE_FRAMES = 5         # eager frames split by stage (trace runs)
SYNC_FRAMES = 16         # graphed frames whose host syncs are counted


def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_of(bench: dict, name: str):
    """(workload, configuration entry, end-to-end metrics, per-layer
    metrics) of the cell ``name``."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return w, conf, mine(bench["end_to_end"]), mine(bench["per_layer"])


def program_config(groups: dict):
    """The program's ``EngineConfig`` from a configuration file's groups."""
    import dataclasses
    from voxelhashing_tpu_torch import config as pc
    kinds = {f.name: f for f in dataclasses.fields(pc.EngineConfig)}
    kw = {}
    for k, v in groups.items():
        if isinstance(v, dict):
            cls = kinds[k].default_factory
            v = cls(**{a: tuple(b) if isinstance(b, list) else b
                       for a, b in v.items()})
        kw[k] = v
    return pc.EngineConfig(**kw)


def gpu_line() -> str:
    """The card's name, power limit, SM clock and maximum SM clock, power
    draw and temperature from nvidia-smi."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
         "clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


class HostSample(NamedTuple):
    """What the host reads at one moment: the process's own usage and the
    cores' clocks (Linux's ``/proc/cpuinfo``, read only)."""

    t: float
    usage: object      # resource.getrusage of this process
    mhz: list          # the cores' clocks, where the kernel reports them


def host_sample() -> HostSample:
    mhz = []
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f
                   if line.startswith("cpu MHz")]
    except (OSError, ValueError):
        pass
    return HostSample(time.perf_counter(),
                      resource.getrusage(resource.RUSAGE_SELF), mhz)


def host_line(a: HostSample, b: HostSample, rates) -> str:
    """The host over a window, for the run's diagnostics: the machine's
    uptime, this process's cores, CPU seconds and involuntary switches,
    the cores' clocks, and frames/s in each fifth of the window."""
    ua, ub = a.usage, b.usage
    mhz = (f"{min(b.mhz):.0f}-{max(b.mhz):.0f}" if b.mhz else "n/a")
    try:
        with open("/proc/uptime") as f:
            up = f"up {float(f.read().split()[0]):.0f} s, "
    except (OSError, ValueError):
        up = ""
    return (f"host: {up}cores {sorted(os.sched_getaffinity(0))}; process "
            f"user {ub.ru_utime - ua.ru_utime:.2f} s sys "
            f"{ub.ru_stime - ua.ru_stime:.2f} s of {b.t - a.t:.2f} s, "
            f"{ub.ru_nivcsw - ua.ru_nivcsw} involuntary switches; "
            f"cores {mhz} MHz; frames/s by fifths "
            + " ".join(f"{r:.1f}" for r in rates))


@contextlib.contextmanager
def sync_count():
    """Count the host syncs made on the main thread inside the block:
    torch's sync debug mode warns at each (as ``chip_smoke.py``'s
    ``_sync_sites`` counts them). Yields a one-element list."""
    import torch
    count = [0]

    def record(message, *_, **__):
        if ("called a synchronizing CUDA operation" in str(message)
                and threading.current_thread() is threading.main_thread()):
            count[0] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield count
        finally:
            torch.cuda.set_sync_debug_mode("default")


class StageRanges:
    """``engine.step``'s ``mark`` for the profiler: each stage's work in a
    ``record_function`` range ``stage:<name>`` closed after a synchronize
    (a copy of ``chip_smoke.py``'s ``_StageRanges``)."""

    def __init__(self, stages):
        self.stages = tuple(stages)
        self._rf = None

    def _open(self, name):
        from torch.profiler import record_function
        self._rf = record_function(f"stage:{name}")
        self._rf.__enter__()

    def _close(self):
        import torch
        torch.cuda.synchronize()
        self._rf.__exit__(None, None, None)
        self._rf = None

    def start(self):
        self._open(self.stages[0])

    def mark(self, stage):
        self._close()
        k = self.stages.index(stage) + 1
        self._open(self.stages[k] if k < len(self.stages) else "other")

    def end(self):
        self._close()


def device_events(prof):
    """(name, start us, end us) of every device op of a profile, and the
    host ranges (name, start, end)."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith("stage:"):
                dev.append((e.name, tr.start, tr.end))
        else:
            host.append((e.name, tr.start, tr.end))
    dev.sort(key=lambda x: x[1])
    return dev, host


def busy_us(dev, lo, hi) -> float:
    """Microseconds of [lo, hi] in which some device op ran."""
    busy, end = 0.0, lo
    for _, a, b in dev:
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    return busy


def breakdown(dev, host, lo, hi, n=10) -> dict:
    """The device ops that took most time and the longest idle gaps on the
    device, each named by the innermost host range open at its middle."""
    by_name = collections.defaultdict(float)
    for name, a, b in dev:
        by_name[name] += (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    gaps, end = [], lo
    for _, a, b in dev:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:n]:
        mid = (a + b) / 2
        inner = [h for h in host if h[1] <= mid <= h[2]]
        name = min(inner, key=lambda h: h[2] - h[1])[0] if inner else "?"
        out.append([name, (b - a) / 1e6])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": out}


def find_reader(root: Path, name: str):
    """The per-layer metric reader ``vhbench/layer_metrics/<name>.py``."""
    path = root / "vhbench" / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"vhbench.layer_metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted(k for k in sys.modules if k.split(".")[0] in FORBIDDEN)


class Program:
    """The system under test as the window drives it: the graphed step of
    ``engine.make_step(cfg, donate=True)`` on a fresh map, fed the lap's
    host frames, with each frame's pose and lost flag read back.

    A configuration that streams (``cfg.streaming.enabled``) runs as
    ``run_slam``'s live loop runs it: the step made with
    ``with_stream_mask=True`` takes the manager's bitmask
    (``streaming.AsyncStreamingManager``), and after each frame the
    manager's step moves blocks between the map and the host store with
    the camera at the frame's tracked position. That position is the pose
    the frame already copies to the host, complete once the caller has
    waited for the frame; so the streaming half of a frame runs at the
    start of the next call (:meth:`stream_half`), before that frame's
    step, in the same order as ``run_slam``'s loop and with no host sync
    of its own. Until then it is due."""

    def __init__(self, cfg, lap, dev, sessions=False, faults=None):
        import torch
        from voxelhashing_tpu_torch import engine
        self.cfg, self.dev, self.sessions = cfg, dev, sessions
        self.lap, self.on_card = lap, dev.type == "cuda"
        streamed = cfg.streaming.enabled
        self.step = engine.make_step(cfg, donate=True,
                                     with_stream_mask=streamed)
        if faults is not None:
            self.step = faults(self.step)
        self.mgr = None
        self.due = False         # the last frame's streaming half
        self.halves = 0          # streaming halves run
        self.stream_s = 0.0      # host seconds inside the manager's step
        if streamed:
            if sessions:
                raise ValueError("a mix with sessions cannot stream")
            from voxelhashing_tpu_torch import streaming
            self.mgr = streaming.AsyncStreamingManager(
                cfg.map, cfg.streaming, device=dev)
            self.ready = torch.cuda.Event() if self.on_card else None
        self.state = engine.create(cfg, device=dev)
        self.pose = torch.empty((4, 4), dtype=torch.float32,
                                pin_memory=self.on_card)
        self.lost = torch.empty((), dtype=torch.bool,
                                pin_memory=self.on_card)
        # the active and surface blocks the program dropped (past its
        # caps), summed over every frame on the device
        self.dropped = torch.zeros((), dtype=torch.int32, device=dev)
        self.diag = None

    def host_index(self, k: int) -> int:
        """The program's frame counter at the window's frame ``k``: the
        frames since its map was made."""
        return k % len(self.lap.poses) if self.sessions else k

    def frame(self, k: int) -> None:
        """Frame ``k`` of the lap (taken cyclically; under sessions a new
        lap starts on a fresh map): the step, the blocks it dropped added
        up, then its pose and lost flag copied to the host (complete after
        a sync)."""
        from voxelhashing_tpu_torch import engine
        lap = self.lap
        i = k % len(lap.poses)
        if self.sessions and i == 0 and k > 0:
            self.state = engine.create(self.cfg, device=self.dev)
        extra = ()
        if self.mgr is not None:
            self.stream_half()
            extra = (self.mgr.bitmask,)
        self.state, self.diag = self.step(self.state, lap.depth[i],
                                          lap.color[i], *extra)
        self.dropped.add_(self.diag.active_overflow).add_(
            self.diag.splat_overflow)
        self.pose.copy_(self.state.pose, non_blocking=self.on_card)
        self.lost.copy_(self.state.tracking_lost, non_blocking=self.on_card)
        if self.mgr is not None:
            self._due()

    def _due(self) -> None:
        """The frame's streaming half is due, at the pose copied to the
        host (complete when the event recorded now has passed)."""
        if self.ready is not None:
            self.ready.record()
        self.due = True

    def stream_half(self) -> None:
        """The last frame's streaming half, if it is due: the manager's
        step with the camera at that frame's tracked position."""
        if not self.due:
            return
        if self.ready is not None:
            self.ready.synchronize()
        cam = self.pose.numpy()[:3, 3].copy()
        t = time.perf_counter()
        m = self.mgr.step(self.state.map, cam)
        self.stream_s += time.perf_counter() - t
        self.state = self.state._replace(map=m)
        self.halves += 1
        self.due = False

    def next_part(self) -> int:
        """The pool part the manager's next step sweeps: it sweeps part 0
        first and the next part each step after (``streaming``'s
        stream-out), so the harness counts its steps rather than read the
        manager's own state."""
        return self.halves % self.cfg.streaming.out_parts

    def settle(self) -> None:
        """Run the due streaming half, then wait for the manager's host
        work (``flush``)."""
        if self.mgr is None:
            return
        self.stream_half()
        self.mgr.flush()

    def close(self) -> None:
        if self.mgr is not None:
            self.mgr.close()
        self.step.close()

    def sync(self) -> None:
        if self.on_card:
            import torch
            torch.cuda.synchronize()


class Window(NamedTuple):
    """What a window measured."""

    times: list          # ms a frame, handed over to pose on the host
    lost: int            # frames the tracker reported lost
    seconds: float       # the window's wall seconds
    next: int            # the frame after its last
    prof: object         # the profile of its traced sub-window, or None
    prof_frames: int     # the frames profiled (one lap)
    prof_s: float        # wall seconds of the profiled frames
    other_ms: float      # wall ms a frame of the frames not profiled
    ends: list           # host seconds at each frame's end, from the start
    marks: list          # (streaming halves, seconds in them) at its start,
                         # the profile's start and end, and its end


def warm_profiler(device) -> None:
    """One tiny op, synchronized, at a profile's start: the first kernel
    of a profile is lost while the profiler sets up its buffers."""
    import torch
    torch.ones(1, device=device).add_(1)
    torch.cuda.synchronize()


def window(prog: Program, k: int, seconds: float, trace: bool) -> Window:
    """Frames from ``k`` on, each handed to the step as soon as the last
    returned, for ``seconds``; with ``trace``, a profiler over one whole
    lap of frames from a third of the way in. Each frame's time runs from
    handing it to the step to its pose's copy to the host, between two
    CUDA events, which the device stamps in its stream (on the CPU, the
    host clock)."""
    import torch
    n_prof = len(prog.lap.poses)
    times, ends, lost = [], [], 0
    prof, first, prof_s, prof_cost = None, None, 0.0, 0.0
    marks = [(prog.halves, prog.stream_s)]
    a = b = None
    if prog.on_card:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    now = t0
    while now < t0 + seconds or (first is not None and not prof_s):
        if trace and prof is None and now - t0 >= seconds / 3:
            from torch.profiler import ProfilerActivity, profile
            prog.sync()
            tp0 = time.perf_counter()
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
            warm_profiler(prog.state.pose.device)
            marks.append((prog.halves, prog.stream_s))
            first, tp1 = len(times), time.perf_counter()
        if prog.on_card:
            a.record()
            prog.frame(k)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            ta = time.perf_counter()
            prog.frame(k)
            times.append(1000 * (time.perf_counter() - ta))
        lost += bool(prog.lost)
        k += 1
        now = time.perf_counter()
        ends.append(now - t0)
        if first is not None and not prof_s \
                and len(times) - first == n_prof:
            prog.sync()
            prof_s = time.perf_counter() - tp1
            marks.append((prog.halves, prog.stream_s))
            prof.__exit__(None, None, None)
            now = time.perf_counter()
            prof_cost = now - tp0
    prog.sync()
    window_s = time.perf_counter() - t0
    marks.append((prog.halves, prog.stream_s))
    n_other = len(times) - (n_prof if prof is not None else 0)
    return Window(times, lost, window_s, k, prof, n_prof, prof_s,
                  1000 * (window_s - prof_cost) / max(n_other, 1), ends,
                  marks)


def fifth_rates(ends: list, seconds: float) -> list:
    """Frames/s in each fifth of a window (``ends``: each frame's end)."""
    counts = [0] * 5
    for t in ends:
        counts[min(4, int(5 * t / seconds))] += 1
    return [5 * c / seconds for c in counts]


def compare(prog: Program, cfg, rcfg, k: int, seed: int, snap, ctl):
    """The comparison with the reference (``check.py``): the start from the
    set-up's snapshot, then the check frames from frame ``k`` on (a
    session's first frame from a fresh map of the reference's own).
    ``ctl``: the control's roundings (``check.CONTROLS``), or None."""
    import torch
    from . import check
    from .reference import engine as reng
    lap, dev = prog.lap, prog.state.pose.device
    readings = check.Readings(prog.mgr is not None)
    check.start(readings, rcfg, lap, snap, dev, ctl)
    picks = check.check_frames(seed, k, cfg.map.gc_starve_interval,
                               cfg.map.maintain_interval, prog.host_index,
                               len(lap.poses))
    if prog.mgr is not None:
        compare_streamed(prog, rcfg, k, picks, readings, ctl)
        readings.dropped(int(prog.dropped))
        return readings
    for f in range(k, picks[-1] + 1):
        if f not in picks:
            prog.frame(f)
            prog.sync()
            continue
        h = prog.host_index(f)
        if h == 0:
            before = reng.create(rcfg, dev)
            last = torch.eye(4, dtype=torch.float32, device=dev)
        else:
            before = check.map_copy(prog.state.map)
            last = prog.state.pose.clone()
            h = prog.state.frame_host
        prog.frame(f)
        prog.sync()
        i = f % len(lap.poses)
        d = torch.from_numpy(lap.depth[i]).to(dev)
        c = torch.from_numpy(lap.color[i]).to(dev)
        pose, valid = prog.pose.numpy().copy(), not bool(prog.lost)
        check.frame(readings, rcfg, before, last, d, c, h, pose, valid,
                    prog.state.map, ctl)
        prog.sync()
    readings.dropped(int(prog.dropped))
    return readings


def stream_state(mgr, part: int):
    """The program's streaming state as the reference holds one
    (``reference.streaming.Stream``), its host work waited for
    (``flush``): the store's chunks in the store's order, each one's rows
    in filing order, read through the store's own interface; a copy of
    the bitmask; ``part``, the next pool part to sweep
    (:meth:`Program.next_part`), and the transfer cap."""
    from .reference import streaming as rstream
    if hasattr(mgr, "flush"):
        mgr.flush()
    store = {}
    for c in mgr.store.chunk_coords():
        store[tuple(int(v) for v in c)] = rstream.Rows(
            *mgr.store.peek_chunks(c.reshape(1, 3)))
    return rstream.Stream(store, mgr.bitmask.clone(), part, mgr.out_cap)


def compare_streamed(prog: Program, rcfg, k: int, picks, readings, ctl):
    """The check frames of a configuration that streams: ``picks`` and,
    where they hold no frame whose streaming half files blocks out or none
    whose half brings blocks in, the first such frame past them within a
    lap of frames from ``k`` (the frames between run uncompared; none
    found reads infinite). Before each frame the manager's host work is
    waited for and the map copied; after the frame's step, whether its
    streaming half will move blocks is read from the program's map, store
    and camera; a compared frame then copies the streaming state, runs
    the half as the window runs it (its worker may file the half's
    stream-out before or after the pop), waits for its host work, and
    hands the states before and after the half to ``check.frame``."""
    import torch
    from . import check
    from .reference import streaming as rstream
    lap, dev, mgr = prog.lap, prog.state.pose.device, prog.mgr
    mp, scfg = rcfg.map, rcfg.streaming
    seen = [False, False]                  # filed out, brought in
    f, end = k, k + len(lap.poses)
    while f <= picks[-1] or (not all(seen) and f < end):
        prog.settle()
        before = check.map_copy(prog.state.map)
        last = prog.state.pose.clone()
        h = prog.state.frame_host
        prog.frame(f)
        prog.sync()
        cam = prog.pose.numpy()[:3, 3].copy()
        out = rstream.select_out(prog.state.map, torch.from_numpy(cam).to(
            dev), prog.next_part(), mp, scfg, mgr.out_cap)[2] > 0
        inn = any(rstream.inside(c, cam, scfg)
                  for c in mgr.store.chunk_coords())
        if f not in picks and not (out and not seen[0]) \
                and not (inn and not seen[1]):
            del before
            f += 1
            continue
        st = stream_state(mgr, prog.next_part())
        prog.settle()
        prog.sync()
        i = f % len(lap.poses)
        d = torch.from_numpy(lap.depth[i]).to(dev)
        c = torch.from_numpy(lap.color[i]).to(dev)
        pose, valid = prog.pose.numpy().copy(), not bool(prog.lost)
        moved = check.frame(readings, rcfg, before, last, d, c, h, pose,
                            valid, prog.state.map, ctl, stream=st,
                            prog_stream=stream_state(mgr, prog.next_part()))
        seen = [seen[0] or moved[0] > 0, seen[1] or moved[1] > 0]
        print(f"check frame {f} (lap frame {i}): reference's streaming "
              f"half filed {moved[0]} blocks out, brought {moved[1]} in",
              file=sys.stderr)
        prog.sync()
        f += 1
    if not all(seen):
        readings.stream_kinds_missing()


def run(args, t_start: float, root: Path, device: str = "cuda",
        faults=None) -> dict:
    """One run of one cell; returns the result line's object. ``device``
    "cpu" and ``faults`` (a callable given the step, returning the step
    to drive) are for the benchmark's own tests."""
    import torch
    from . import check
    from .reference import config as rconfig
    from .traffic import generator

    bench = load_benchmark(root)
    wl, conf_entry, e2e, layer = cell_of(bench, args.workload)
    with open(root / conf_entry["file"]) as f:
        conf = json.load(f)
    cfg = program_config(conf["engine"])
    rcfg = rconfig.from_dict(conf["engine"])
    mix = generator.load_mix(wl["traffic"], root / "vhbench" / "traffic")
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    print(f"card: {gpu_line() if on_card else 'cpu'}", flush=True)

    lap = generator.make_lap(mix, cfg.camera, args.seed, dev)
    prog = Program(cfg, lap, dev, bool(mix.get("sessions")), faults)
    # set-up: one whole lap, the start of which the comparison keeps
    poses, valid, snap_map, in_view = [], [], None, []
    snap_stream = None
    for i in range(len(lap.poses)):
        prog.frame(i)
        prog.sync()
        in_view.append(int(prog.diag.n_active_blocks)
                       + int(prog.diag.active_overflow))
        if i < check.START_FRAMES:
            poses.append(prog.pose.numpy().copy())
            valid.append(not bool(prog.lost))
            if i == check.START_FRAMES - 1:
                if prog.mgr is not None:
                    prog.settle()
                    snap_stream = stream_state(prog.mgr, prog.next_part())
                snap_map = check.snapshot_map(prog.state.map)
    if prog.mgr is not None:
        prog.settle()
        moved0 = prog.mgr.blocks_out + prog.mgr.blocks_in
    # objects made so far are left out of the collector's passes, which
    # would otherwise pause the window for milliseconds now and then
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    h0 = host_sample()
    w = window(prog, len(lap.poses), args.seconds, bool(args.trace))
    h1 = host_sample()
    k = w.next
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    print(f"card after the window: {gpu_line() if on_card else 'cpu'}",
          file=sys.stderr)
    print(host_line(h0, h1, fifth_rates(w.ends, w.seconds)),
          file=sys.stderr)
    adopted = getattr(prog.step, "pool_bytes_adopted", None)
    print(f"lap: blocks in view (active and past the cap) {min(in_view)}"
          f"-{max(in_view)}, cap {cfg.map.max_active_blocks}; set-up "
          f"{setup_s:.2f} s; pool bytes adopted {adopted}; unprofiled "
          f"frames {w.other_ms:.4f} ms a frame", file=sys.stderr)
    result = {"correct": False, "attempted": len(w.times), "failed": w.lost}
    stream = None
    if prog.mgr is not None:
        stream = stream_window(prog, w, moved0)
    extra = {}
    if args.trace:
        metrics, extra, k = layer_metrics(prog, cfg, layer, k, w, root,
                                          stream)
    else:
        values = {"fps": len(w.times) / w.seconds,
                  "frame_ms_p95": float(np.percentile(w.times, 95)),
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in e2e}
    readings = compare(prog, cfg, rcfg, k, args.seed,
                       check.Snapshot(poses, valid, snap_map, snap_stream),
                       check.CONTROLS[args.control])
    limits = conf.get("check", {})
    checks = {name: {"value": v, "limit": limits.get(name)}
              for name, v in readings.values.items()}
    result["correct"] = all(c["limit"] is not None
                            and c["value"] <= c["limit"]
                            for c in checks.values())
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": 1, "memory_peak_bytes": int(peak), **extra.get("device",
                                                                 {})}
    if "breakdown" in extra:
        result["breakdown"] = extra["breakdown"]
    result["checks"] = checks
    prog.close()
    return result


def stream_window(prog: Program, w: Window, moved0: int):
    """What the window's streaming halves did, once the manager's host
    work has ended (``moved0``: blocks moved before the window): host ms a
    half inside the manager's step over the frames not profiled; on
    standard error with the blocks filed out and brought in a half and
    the host store's blocks by chunk row (z) after the window."""
    mgr = prog.mgr
    mgr.flush()
    (h0, s0), *mid, (h1, s1) = w.marks
    if mid:
        (p0, q0), (p1, q1) = mid
        h1, s1 = h1 - (p1 - p0), s1 - (q1 - q0)
    halves = w.marks[-1][0] - w.marks[0][0]
    out = SimpleNamespace(ms=1000.0 * (s1 - s0) / max(h1 - h0, 1))
    by_z = collections.Counter()
    for c in mgr.store.chunk_coords():
        by_z[int(c[2])] += mgr.store.peek_count(c.reshape(1, 3))
    print(f"stream: {halves} halves in the window, {out.ms:.4f} host ms a "
          f"half (unprofiled), "
          f"{(mgr.blocks_out + mgr.blocks_in - moved0) / max(halves, 1):.3f}"
          f" blocks moved a half; host store blocks by chunk row z "
          f"{dict(sorted(by_z.items()))}", file=sys.stderr)
    return out


def stage_split(prog: Program, cfg, k: int):
    """:data:`STAGE_FRAMES` eager frames from frame ``k`` in one profile,
    after one more that is not counted (a profile's first kernels may be
    lost while it sets up): each stage's ops in a ``stage:<name>`` range
    closed after a synchronize, each frame in a ``frame:<j>`` range, each
    frame's work counted afterwards on a copy of its map before it.
    Returns (device ms a frame by stage, each frame's kernels and work,
    the next frame)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from voxelhashing_tpu_torch import engine
    from . import check, work

    lap, dev = prog.lap, prog.state.pose.device
    befores, lasts, diags, afters = [], [], [], []
    streamed = prog.mgr is not None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        warm_profiler(dev)
        for j in range(-1, STAGE_FRAMES):
            if prog.host_index(k) == 0:     # a session's fresh map
                prog.frame(k)
                k += 1
            i = k % len(lap.poses)
            d = torch.from_numpy(lap.depth[i]).to(dev)
            c = torch.from_numpy(lap.color[i]).to(dev)
            mask = {}
            if streamed:
                # the last frame's streaming half, outside any frame
                prog.stream_half()
                mask = {"stream_bitmask": prog.mgr.bitmask}
            if j >= 0:
                befores.append(check.map_copy(prog.state.map))
                lasts.append(prog.state.pose.clone())
            ranges = StageRanges(engine.STAGES)
            prog.sync()
            with record_function(f"frame:{j}"):
                ranges.start()
                prog.state, diag = engine.step(prog.state, d, c, cfg,
                                               mark=ranges.mark, **mask)
                ranges.end()
            diags.append(diag)
            if streamed:
                # the map as the frame left it, before its streaming half
                if j >= 0:
                    afters.append(check.map_copy(prog.state.map))
                prog.pose.copy_(prog.state.pose)
                prog._due()
            k += 1
    ev, host = device_events(p)
    spans = sorted((a, b, nm) for nm, a, b in host
                   if nm.startswith(("stage:", "frame:")))
    stage_ms = collections.defaultdict(float)
    kernels = [collections.defaultdict(float) for _ in range(STAGE_FRAMES)]
    for name, a, b in ev:
        inside = [nm for sa, sb, nm in spans if sa <= a < sb]
        fr = [int(nm[6:]) for nm in inside if nm.startswith("frame:")]
        if not fr or fr[0] < 0:
            continue
        kernels[fr[0]][name] += (b - a) / 1000
        for nm in inside:
            if nm.startswith("stage:"):
                stage_ms[nm[6:]] += (b - a) / 1000 / STAGE_FRAMES
    frames = []
    if not streamed:
        afters = befores[1:] + [prog.state.map]
    for j in range(STAGE_FRAMES):
        fr = {"kernels": dict(kernels[j]),
              "n_active": int(diags[j + 1].n_active_blocks),
              "n_updated": work.updated_voxels(befores[j], afters[j])}
        if cfg.raycast.mode == "splat" and not cfg.tracker.use_rgbd:
            fr["splat"] = work.splat_counts(befores[j], lasts[j], cfg)
        if cfg.raycast.mode == "march":
            fr["march"] = work.march_counts(befores[j], lasts[j], cfg)
        frames.append(fr)
    return dict(stage_ms), frames, k


def layer_metrics(prog: Program, cfg, layer, k: int, w: Window,
                  root: Path, stream=None):
    """The per-layer metrics of a traced run from the window's profiled
    sub-window (one whole lap: its device-busy and wall time), the host
    syncs of :data:`SYNC_FRAMES` graphed frames, and :data:`STAGE_FRAMES`
    eager frames split by stage, each with the work its kernels had, and
    under streaming the window's streaming halves (``stream``, from
    :func:`stream_window`); each metric's reader picks its number from
    these. Returns (metrics, the device's busy and window seconds and the
    breakdown, the next frame)."""
    from . import work

    dev_ops, host = device_events(w.prof)
    lo = min(a for _, a, _ in dev_ops)
    hi = max(b for _, _, b in dev_ops)
    busy_s = busy_us(dev_ops, lo, hi) / 1e6

    with sync_count() as syncs:
        for _ in range(SYNC_FRAMES):
            prog.frame(k)
            k += 1
    prog.sync()

    stage_ms, frames, k = stage_split(prog, cfg, k)
    prog.frame(k)            # the graphed step takes the state back
    k += 1
    prog.sync()

    ctx = SimpleNamespace(
        cfg=cfg, prof_frames=w.prof_frames,
        frame_ms=1000 * w.prof_s / w.prof_frames,
        busy_ms=1000 * busy_s / w.prof_frames,
        syncs_per_frame=syncs[0] / SYNC_FRAMES,
        stage_ms=stage_ms, frames=frames, work=work,
        device_ops=dev_ops, stream=stream)
    metrics = {}
    for m in layer:
        v = find_reader(root, m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    print("split frames: active rows "
          + " ".join(str(fr["n_active"]) for fr in frames), file=sys.stderr)
    extra = {"device": {"busy_s": busy_s, "window_s": w.prof_s},
             "breakdown": breakdown(dev_ops, host, lo, hi)}
    return metrics, extra, k


def main(argv=None, t_start=None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1))
    ap.add_argument("--control", type=int, default=0, choices=(0, 1, 2),
                    help="put the reference in the program's place, 1: in "
                         "bfloat16 (the comparison's control), 2: every "
                         "float32 value its fusion computes moved one ulp "
                         "(what a change of rounding alone there reads)")
    args = ap.parse_args(argv)
    root = HERE.parent
    if not (root / "voxelhashing_tpu_torch").is_dir():
        print("vhbench: the program (voxelhashing_tpu_torch) is not in "
              f"{root}", file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(1)
    bench = load_benchmark(root)
    wl = cell_of(bench, args.workload)[0]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"vhbench: {wl['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    result = run(args, t_start, root)
    bad = forbidden_modules()
    if bad:
        print(f"vhbench: loaded {bad} (the JAX package or JAX)",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
