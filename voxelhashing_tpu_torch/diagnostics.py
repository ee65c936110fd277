"""Diagnostics: per-stage timing, hash histograms, tracking confidence
(port of ``voxelhashing_tpu.diagnostics``).

``TimingLog.stop(stage, sync=t)`` waits for the device of ``t`` before it
reads the clock (``torch.cuda.synchronize``), as the JAX version waits
with ``jax.block_until_ready``. ``hash_histogram`` runs on the map's
device and reads its numbers back in one transfer. The ICP logs read the
engine's ``FrameDiagnostics.icp_level_stats`` and ``icp_iter_residuals``
(tensors on any device, or numpy).

``StepTracer`` (no JAX counterpart) traces ``engine.make_step``'s frames
from inside its CUDA graphs: host spans, device stamps at each stage's
end, counters; ``trace_summary`` reads them. ``StreamTracer`` times the
host spans of ``streaming.AsyncStreamingManager``'s halves and counts
their blocks.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import statistics
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .config import MapConfig
from .blockmap import MapState, TOMBSTONE, _probe_slot
from .geometry import INVALID_KEY
from .ops import _build


def _host(x) -> np.ndarray:
    """A tensor (any device) or array-like as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _synchronize(sync) -> None:
    """Wait for the devices of the CUDA tensors in ``sync`` (a tensor or a
    sequence of them)."""
    items = sync if isinstance(sync, (list, tuple)) else (sync,)
    for t in items:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)


class TimingLog:
    """Per-stage wall-clock accumulators and windowed whole-frame stats
    (the last ``window`` frames)."""

    def __init__(self, window: int = 128):
        self.window = window
        self.stage_total: Dict[str, float] = defaultdict(float)
        self.stage_count: Dict[str, int] = defaultdict(int)
        self.frame_times: List[float] = []
        self._t0: Dict[str, float] = {}
        self._frame_t0: Optional[float] = None

    def start(self, stage: str):
        self._t0[stage] = time.perf_counter()

    def stop(self, stage: str, sync=None):
        """End ``stage``; with ``sync`` (a tensor or tensors) wait for their
        device first, so the stage's device work is inside its time."""
        if sync is not None:
            _synchronize(sync)
        dt = time.perf_counter() - self._t0.pop(stage)
        self.stage_total[stage] += dt
        self.stage_count[stage] += 1
        return dt

    def frame_start(self):
        self._frame_t0 = time.perf_counter()

    def frame_stop(self):
        dt = time.perf_counter() - self._frame_t0
        self.frame_times.append(dt)
        if len(self.frame_times) > self.window:
            self.frame_times.pop(0)
        return dt

    def averages(self) -> Dict[str, float]:
        """Per-stage mean seconds."""
        return {k: self.stage_total[k] / max(self.stage_count[k], 1)
                for k in self.stage_total}

    def benchmark(self) -> Dict[str, float]:
        """Windowed whole-frame stats."""
        if not self.frame_times:
            return {}
        a = np.asarray(self.frame_times)
        return {
            "frames": len(a),
            "mean_ms": float(a.mean() * 1e3),
            "min_ms": float(a.min() * 1e3),
            "max_ms": float(a.max() * 1e3),
            "stddev_ms": float(a.std() * 1e3),
            "fps": float(1.0 / a.mean()),
        }

    def report(self) -> str:
        lines = ["stage averages (ms):"]
        for k, v in sorted(self.averages().items()):
            lines.append(f"  {k:24s} {v*1e3:9.2f}")
        b = self.benchmark()
        if b:
            lines.append(
                f"frame window: {b['mean_ms']:.1f} ms avg "
                f"({b['fps']:.2f} fps), min {b['min_ms']:.1f}, "
                f"max {b['max_ms']:.1f}, stddev {b['stddev_ms']:.1f}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# StepTracer: spans, device stamps and counters inside engine.make_step
# ---------------------------------------------------------------------------

# the counters a traced frame keeps on the device
TRACE_COUNTERS = ("icp_live_iters", "blocks_inserted", "blocks_freed")
# device idle time a frame, by the innermost host span open at the time
# (None: no span, the caller's time between step calls)
IDLE_METRICS = {"inputs": "idle_inputs_ms", "replay": "idle_launch_ms",
                "read_valid": "idle_reads_ms", "read_flags": "idle_reads_ms",
                "diagnostics": "idle_diag_ms", None: "idle_caller_ms"}
_STAMPS = 16             # stamps a segment may take
# the ring's row a frame: a view (or fused) segment's stamps, a front
# segment's, a back segment's, the counters, the anchor
_FRONT_COL = _STAMPS
_BACK_COL = 2 * _STAMPS
_COUNT_COL = 3 * _STAMPS
_ANCHOR_COL = _COUNT_COL + len(TRACE_COUNTERS)
_WIDTH = _ANCHOR_COL + 1
_RING = 1 << 12          # frames the device holds between copies
_ANCHOR_NS = 10 ** 9     # an older anchor places no stamp
_ANCHOR_LAUNCH_NS = 100_000  # an anchor whose launch took longer is dropped
_now = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled


class Span(NamedTuple):
    """A host span of a traced frame (``time.perf_counter_ns``)."""

    name: str
    key: Optional[str]    # the graph key of a ``replay`` span
    start_ns: int
    end_ns: int
    parent: int           # index of the enclosing span; -1 for ``step``
    frame: int            # the frame's host index (``frame_host``)


@dataclasses.dataclass
class FrameTrace:
    """One traced frame: its host spans in opening order, the stamps of
    each segment it ran (``(key, ((label, ns), ...))`` on the host clock),
    and its counters; complete once :meth:`StepTracer.records` read
    them."""

    host: int
    seq: int                          # the frame's ring row, in order
    spans: list = dataclasses.field(default_factory=list)
    segments: list = dataclasses.field(default_factory=list)
    counts: dict = dataclasses.field(default_factory=dict)
    eager: bool = False               # frame 0's eager step
    captured: bool = False            # it captured a traced graph
    anchored: bool = True             # every stamp was placed on the host
    inputs_behind: bool = False       # staged with the view graph queued


class _Stamps:
    """A segment's stamps, in order: on the card, launches of the stamp
    kernel into the segment's columns of the frame's ring row (graph nodes
    inside a capture; a view or fused segment's first stamp opens the
    row); elsewhere the host clock."""

    def __init__(self, tracer=None, base: int = 0, opens: bool = False):
        self.labels = []
        self.times = []
        self.tracer, self.base, self.opens = tracer, base, opens

    def __call__(self, label: str, counters=()) -> None:
        if self.tracer is None:
            self.times.append(_now())
        else:
            if len(self.labels) == _STAMPS:
                raise ValueError(f"StepTracer: more than {_STAMPS} stamps "
                                 "in a segment")
            self.tracer._stamp(self.base + len(self.labels),
                               self.opens and not self.labels, counters)
        self.labels.append(label)

    def around(self, fn, tracer):
        """``fn(self, tracer)`` between the stamps ``start`` and ``end``;
        the counters it handed over are written behind the stamp
        ``counters``, after its last mark."""
        self("start")
        out = fn(self, tracer)
        tracer.flush(self)
        self("end")
        return out


class StepTracer:
    """Spans, device stamps and counters of the frames of
    ``engine.make_step``'s step while it is the step's ``trace``.

    - Host spans (``time.perf_counter_ns``), one tree a frame under
      ``step``, in the step's order: ``inputs`` (adopting the state and
      staging a hint; then staging the frame's inputs behind the view
      graph), ``replay`` (one a segment run, with its graph key),
      ``diagnostics`` (the copies of a segment's fields), ``read_valid``,
      ``read_flags`` and ``maintain``. Under a recording
      torch profiler each is also a ``record_function`` range
      ``vh:<name>``.
    - Device stamps: each traced segment stamps its start, each stage's
      end (``engine.STAGES``' marks) and its end, by a one-thread kernel
      (``csrc/trace_stamp.cu``, a graph node of its traced graph) that
      writes the card's global nanosecond timer into the frame's row of a
      ring on the device. They are placed on the host clock by the last
      anchor: a stamp launched, and the host clock read, right after the
      frame's last read, when the stream is idle. On the CPU the stamps
      are the host clock.
    - Counters (:data:`TRACE_COUNTERS`): each worked out where its work
      happens (a device scalar: one to three small kernels in its stage)
      and written with the segment's stamp ``counters`` after its last
      mark.

    The ring is copied to the host by :meth:`records` (or, every
    :data:`_RING` frames, by the next frame, one wait): a traced graphed
    frame makes no host read the untraced one does not make.
    """

    def __init__(self):
        self.frames: List[FrameTrace] = []
        # device less host ms between consecutive anchors (their jitter),
        # filled by records()
        self.anchor_gaps_ms: List[float] = []
        self._stack = []          # open spans
        self._spans = None        # the frame's spans (tuples until read)
        self._eager = None        # frame 0's stamps, until its end
        self._held = []           # the segment's (column, counter value)
        self._device = self._ring = self._slot = None
        self._launch = self._ring_p = self._slot_p = None
        self._seq = self._base = 0
        self._runs = {}           # seq -> [(key, stamps)] on the card
        self._rows = {}           # seq -> the ring row, once copied
        self._anchor = None       # (seq, host ns) of the last anchor
        self._anchored = {}       # seq -> (anchor seq, host ns) it uses
        self._anchor_ns = {}      # seq -> host ns of the frame's anchor
        self._anchor_dev = {}     # seq -> device ns of it, once copied

    # -- host spans --------------------------------------------------------

    def begin(self, host: int, device) -> None:
        """A new frame at host index ``host`` on ``device``; opens
        ``step``."""
        while self._stack:          # a step that raised
            self.close()
        if self._ring is None:
            self._bind(device)
        elif device != self._device:
            raise ValueError("StepTracer: a tracer follows one device "
                             f"({self._device}), not {device}")
        if self._seq - self._base == _RING:
            self._drain()
        f = FrameTrace(host, self._seq,
                       counts=dict.fromkeys(TRACE_COUNTERS, 0))
        self.frames.append(f)
        self._spans = f.spans
        self._seq += 1
        self.open("step")

    def _bind(self, device) -> None:
        """The ring and its slot on ``device``, where the tracer stays."""
        self._device = device
        self._ring = torch.zeros((_RING, _WIDTH), dtype=torch.int64,
                                 device=device)
        self._slot = torch.full((1,), -1, dtype=torch.int64, device=device)
        if self._ring.is_cuda:
            self._launch = _build.library("trace_stamp").vh_trace_stamp
            self._ring_p = self._ring.data_ptr()
            self._slot_p = self._slot.data_ptr()
            self._stamp(_ANCHOR_COL, False)   # warm: no row is open yet

    def open(self, name: str, key: Optional[str] = None) -> None:
        rf = None
        if _profiling():
            rf = torch.profiler.record_function(f"vh:{name}")
            rf.__enter__()
        spans = self._spans
        self._stack.append((len(spans), name, key,
                            self._stack[-1][0] if self._stack else -1, rf,
                            _now()))
        spans.append(None)

    def close(self) -> None:
        t = _now()
        i, name, key, parent, rf, t0 = self._stack.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        self._spans[i] = (name, key, t0, t, parent)

    def end(self) -> None:
        """Close every open span (the last is ``step``)."""
        if self._eager is not None:
            st, self._eager = self._eager, None
            self.flush(st)
            st("end")
            self.frames[-1].segments.append(
                ("eager", tuple(zip(st.labels, st.times))))
        while self._stack:
            self.close()

    # -- device stamps -----------------------------------------------------

    def stamps(self, key: str, device=None) -> _Stamps:
        """Segment ``key``'s stamps: kernel launches on ``device`` (a card),
        else the host clock."""
        if device is None:
            return _Stamps()
        if key.startswith(("view", "fused")):
            return _Stamps(self, 0, True)
        return _Stamps(self, _FRONT_COL if key == "front" else _BACK_COL)

    def eager(self) -> dict:
        """The hooks of frame 0's eager step (host-clock stamps)."""
        self.frames[-1].eager = True
        self._eager = st = _Stamps()
        st("start")
        return {"mark": st, "tally": self.tally}

    def ran(self, key: str, st: _Stamps, captured: bool = False) -> None:
        """Segment ``key`` ran with the stamps ``st`` (``captured``: its
        graph was captured for it)."""
        f = self.frames[-1]
        f.captured |= captured
        if st.tracer is None:
            f.segments.append((key, tuple(zip(st.labels, st.times))))
            return
        runs = self._runs.setdefault(f.seq, [])
        if not runs:
            a = self._anchor
            if a is not None and _now() - a[1] <= _ANCHOR_NS:
                self._anchored[f.seq] = a
        runs.append((key, st))

    def read_done(self, anchor: bool) -> None:
        """Close the read span that has just waited for the stream;
        ``anchor``: it is the frame's last read (the stream is idle: the
        anchor of the stamps that follow)."""
        self.close()
        if anchor and self._ring.is_cuda:
            t0 = _now()
            rc = self._launch(self._ring_p, self._slot_p, _RING, _WIDTH,
                              _ANCHOR_COL, 0, 0, None, None, None, 0, 0, 0,
                              0, torch.cuda.current_stream(
                                  self._ring.device).cuda_stream)
            t = _now()
            _build.check(rc, "trace_stamp")
            if t - t0 <= _ANCHOR_LAUNCH_NS:     # else the last one stays
                seq = self.frames[-1].seq
                self._anchor = (seq, t)
                self._anchor_ns[seq] = t

    def _stamp(self, col: int, opens: bool, counters=()) -> None:
        """One stamp kernel on the current stream: the timer into column
        ``col`` of the frame's row (``opens``: the next row, zeroed), with
        ``counters`` ((column, int32 or int64 device scalar), up to 3)."""
        ring = self._ring
        if len(counters) > 3 or any(
                v.dtype not in (torch.int32, torch.int64) or v.numel() != 1
                or v.device != ring.device for _, v in counters):
            raise ValueError("StepTracer: a stamp carries up to 3 int32 or "
                             "int64 scalars on the ring's device")
        ptrs = [_build.ptr(v) for _, v in counters]
        ptrs += [ctypes.c_void_p(None)] * (3 - len(ptrs))
        cols = [c for c, _ in counters] + [0] * (3 - len(counters))
        wide = sum(1 << k for k, (_, v) in enumerate(counters)
                   if v.dtype == torch.int64)
        _build.check(self._launch(
            self._ring_p, self._slot_p, _RING, _WIDTH, col, int(opens),
            len(counters), *ptrs, *cols, wide,
            _build.stream_ptr(ring.device)), "trace_stamp")

    # -- counters ----------------------------------------------------------

    def tally(self, name: str, value: torch.Tensor) -> None:
        """Counter ``name`` of the frame: ``value``, a device scalar that
        nothing writes to later."""
        self._held.append((_COUNT_COL + TRACE_COUNTERS.index(name), value))

    def flush(self, st: _Stamps) -> None:
        """The segment's counters, with its stamp ``counters``."""
        held, self._held = self._held, []
        if not held:
            return
        if st.tracer is not None:
            st("counters", held)
            return
        st("counters")
        if self._ring.is_cuda:           # frame 0's eager step on the card
            self._stamp(0, True, held)
            return
        counts = self.frames[-1].counts
        for col, value in held:
            counts[TRACE_COUNTERS[col - _COUNT_COL]] = int(value)

    # -- reading -----------------------------------------------------------

    def _drain(self) -> None:
        """Copy the ring's rows of the frames since the last copy."""
        if self._ring.is_cuda and self._base < self._seq:
            ring = self._ring.cpu().numpy()
            for seq in range(self._base, self._seq):
                self._rows[seq] = row = ring[seq % _RING]
                if seq in self._anchor_ns:
                    self._anchor_dev[seq] = int(row[_ANCHOR_COL])
        self._base = self._seq

    def records(self) -> List[FrameTrace]:
        """Every frame traced so far, with its stamps on the host clock and
        its counters (on the card: one wait and one copy of the ring)."""
        if self._ring is None:
            return self.frames
        self._drain()
        for f in self.frames:
            f.spans = [s if s is None or isinstance(s, Span)
                       else Span(*s, f.host) for s in f.spans]
            row = self._rows.pop(f.seq, None)
            if row is None:
                continue
            f.counts = {c: int(row[_COUNT_COL + i])
                        for i, c in enumerate(TRACE_COUNTERS)}
            runs = self._runs.pop(f.seq, [])
            a = self._anchored.pop(f.seq, None)
            if runs and (a is None or a[0] not in self._anchor_dev):
                f.anchored = False
                continue
            for key, st in runs:
                dev0 = self._anchor_dev[a[0]]
                f.segments.append((key, tuple(
                    (lab, a[1] + int(row[st.base + j]) - dev0)
                    for j, lab in enumerate(st.labels))))
        seqs = sorted(self._anchor_dev)
        dev, host = self._anchor_dev, self._anchor_ns
        for s0, s1 in zip(seqs, seqs[1:]):
            self.anchor_gaps_ms.append(
                ((dev[s1] - dev[s0]) - (host[s1] - host[s0])) / 1e6)
        for s in seqs[:-1]:
            del dev[s], host[s]
        return self.frames


# the front stages' marks in each kind of segment, in order
_FRONT_MARKS = {"view": ("compactify", "render"),
                "front": ("preprocess", "track"),
                "fused": ("preprocess", "compactify", "render", "track")}


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def trace_summary(frames: List[FrameTrace]) -> dict:
    """What :meth:`StepTracer.records` says of a run of graphed frames,
    frames that captured a graph, frame 0's eager step and frames with a
    stamp not placed on the host clock left out; ms are means a frame.

    - ``<stage>_graph_ms``: the view segment's stamps, start to the mark
      ``compactify``, to ``render``, the front segment's, start to
      ``preprocess``, to ``track`` (a fused segment's, start to
      ``preprocess``, to ``compactify``, to ``render``, to ``track``);
      ``map_update_graph_ms``: the back segment's start (a fused segment's
      ``track``) to ``gc``; ``maintain_graph_ms``: ``gc`` to the mark
      ``maintain`` (the maintain flags and the map fields copied back into
      the step's buffers); ``front_cover``, ``back_cover``: the share of
      their segments' own device time (to the stamp ``counters``) the
      front's four intervals and ``map_update_graph_ms`` cover;
      ``tracer_graph_ms``: the tracer's counter work (``counters`` to
      ``end``).
    - ``starve_extra_ms``: the median device ms a frame (first segment's
      start to last segment's end) of starve frames less that of the
      others.
    - Idle: a frame's window runs from its ``step`` span's start to the
      next frame's. Its device idle time (the window less its segments) is
      cut at every host span's ends, and each piece goes to the innermost
      span open at its middle, or to the caller (no span open): by span in
      ``idle_by_span``, summed into :data:`IDLE_METRICS`; ``wall_ms``,
      ``busy_ms``, ``idle_ms``: the windows, the segments in them, the
      difference.
    - ``inputs_behind_share``: the share of the graphed frames (captures
      included) whose inputs were staged with the view graph queued.
    - ``<counter>``: :data:`TRACE_COUNTERS` a frame, named
      ``icp_live_iters_per_frame``, ``blocks_inserted_per_frame``,
      ``blocks_freed_per_frame``.
    """
    used = [f for f in frames
            if not (f.eager or f.captured) and f.anchored and f.segments
            and None not in f.spans]
    ids = {id(f) for f in used}
    stage = defaultdict(list)
    cover = np.zeros(4)
    dev_ms = []
    for f in used:
        lo = min(dict(st)["start"] for _, st in f.segments)
        hi = max(dict(st)["end"] for _, st in f.segments)
        dev_ms.append(((hi - lo) / 1e6,
                       any(key.endswith("_starve") for key, _ in f.segments)))
        tracer_ns = 0
        for key, stamps in f.segments:
            d = dict(stamps)
            own = d.get("counters", d["end"])   # the tracer's work follows
            tracer_ns += d["end"] - own
            marks = _FRONT_MARKS.get(key.split("_")[0])
            if marks:
                for a, b in zip(("start",) + marks, marks):
                    stage[f"{b}_graph_ms"].append((d[b] - d[a]) / 1e6)
                cover[0] += (d[marks[-1]] - d["start"]) / 1e6
                cover[1] += ((d["track"] if key.startswith("fused") else own)
                             - d["start"]) / 1e6
            if key.startswith(("back", "fused")):
                t0 = d["start" if key.startswith("back") else "track"]
                stage["map_update_graph_ms"].append((d["gc"] - t0) / 1e6)
                stage["maintain_graph_ms"].append(
                    (d.get("maintain", own) - d["gc"]) / 1e6)
                cover[2] += (d["gc"] - t0) / 1e6
                cover[3] += (own - t0) / 1e6
        stage["tracer_graph_ms"].append(tracer_ns / 1e6)
    out = {"frames": len(used)}
    for name, v in stage.items():
        out[name] = float(np.mean(v))
    out["front_cover"] = cover[0] / cover[1] if cover[1] else None
    out["back_cover"] = cover[2] / cover[3] if cover[3] else None
    graphed = [f for f in frames if not f.eager]
    out["inputs_behind_share"] = (
        sum(f.inputs_behind for f in graphed) / len(graphed)
        if graphed else None)
    s = [ms for ms, st in dev_ms if st]
    o = [ms for ms, st in dev_ms if not st]
    out["starve_frames"] = len(s)
    out["starve_extra_ms"] = (float(np.median(s) - np.median(o))
                              if s and o else None)

    idle = defaultdict(float)
    wall = busy = 0.0
    windows = 0
    for f, nxt in zip(frames, frames[1:]):
        if id(f) not in ids or not nxt.spans or nxt.spans[0] is None:
            continue
        lo, hi = f.spans[0].start_ns, nxt.spans[0].start_ns
        runs = _merged([(max(lo, dict(st)["start"]), min(hi, dict(st)["end"]))
                        for _, st in f.segments])
        runs = [(a, b) for a, b in runs if b > a]
        windows += 1
        wall += (hi - lo) / 1e6
        busy += sum(b - a for a, b in runs) / 1e6
        cuts = sorted({t for s in f.spans for t in (s.start_ns, s.end_ns)
                       if lo < t < hi})
        gaps, t = [], lo
        for a, b in runs + [(hi, hi)]:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        for a, b in gaps:
            edges = [a] + [c for c in cuts if a < c < b] + [b]
            for x, y in zip(edges, edges[1:]):
                mid = (x + y) / 2
                inner = None
                for s in f.spans:
                    if s.start_ns <= mid <= s.end_ns:
                        inner = s.name
                idle[inner] += (y - x) / 1e6
    n = max(windows, 1)
    out["windows"] = windows
    out["wall_ms"], out["busy_ms"] = wall / n, busy / n
    out["idle_ms"] = (wall - busy) / n
    out["idle_by_span"] = {("caller" if k is None else k): v / n
                           for k, v in idle.items()}
    for span, name in IDLE_METRICS.items():
        out[name] = out.get(name, 0.0) + idle.get(span, 0.0) / n
    counted = [f.counts for f in used if f.counts]
    for c in TRACE_COUNTERS:
        out[f"{c}_per_frame"] = (float(np.mean([k[c] for k in counted]))
                                 if counted else None)
    return out


STREAM_SPANS = ("stream_cam", "stream_out", "stream_submit", "stream_pop",
                "stream_in")
STREAM_JOBS = ("stream_file", "stream_refile")


class StreamTracer:
    """Host spans and counters of a streaming manager's halves, set as
    ``streaming.AsyncStreamingManager``'s ``trace`` (None, the default, is
    off: one ``is None`` test a half).

    Each half (a manager ``step``) records the host seconds of its spans
    (:data:`STREAM_SPANS`: the camera's write, the stream-out's replay, the
    host job's queueing, the pop, and the bits, staging and insert's
    replay), its whole call, the blocks it brought in and the store's
    blocks after it. The host jobs, which run behind a graphed step's
    graphs or at the next half, record their own seconds and blocks
    (:data:`STREAM_JOBS`: blocks filed out, blocks re-filed).
    :meth:`summary` reads them."""

    def __init__(self):
        self.halves: List[dict] = []
        self.jobs: List[tuple] = []      # (name, seconds, blocks)
        self._cur = None
        self._span = None

    def begin(self) -> None:
        self._cur = {"t0": time.perf_counter()}

    def open(self, name: str) -> None:
        self._span = (name, time.perf_counter())

    def close(self) -> None:
        name, t = self._span
        self._cur[name] = self._cur.get(name, 0.0) + time.perf_counter() - t

    def end(self, brought_in: int, stored: int) -> None:
        cur = self._cur
        cur["host"] = time.perf_counter() - cur.pop("t0")
        cur["brought_in"], cur["stored"] = brought_in, stored
        self.halves.append(cur)

    def job(self, name: str, seconds: float, blocks: int) -> None:
        self.jobs.append((name, seconds, blocks))

    def summary(self) -> dict:
        """Median host ms a half by span and of the whole call (the halves
        that brought blocks in apart), the host jobs' median ms a job, and
        blocks a half: filed out, brought in, re-filed; the store's blocks
        after the last half."""
        h = self.halves
        n = max(len(h), 1)
        med = lambda v: statistics.median(v) if v else None   # noqa: E731
        out = {"halves": len(h),
               "halves_in": sum(1 for x in h if x["brought_in"])}
        for name in STREAM_SPANS + ("host",):
            out[f"{name}_ms"] = med([1000 * x.get(name, 0.0) for x in h])
        out["host_ms_in"] = med([1000 * x["host"] for x in h
                                 if x["brought_in"]])
        out["host_ms_out_only"] = med([1000 * x["host"] for x in h
                                       if not x["brought_in"]])
        jobs = self.jobs
        for name in STREAM_JOBS:
            mine = [j for j in jobs if j[0] == name]
            out[f"{name}_ms"] = med([1000 * j[1] for j in mine])
            out[f"{name}_jobs"] = len(mine)
        out["filed_out_per_half"] = sum(
            j[2] for j in jobs if j[0] == "stream_file") / n
        out["refiled_per_half"] = sum(
            j[2] for j in jobs if j[0] == "stream_refile") / n
        out["brought_in_per_half"] = sum(x["brought_in"] for x in h) / n
        out["store_blocks"] = h[-1]["stored"] if h else None
        return out


def hash_histogram(state: MapState, cfg: MapConfig) -> Dict[str, object]:
    """Probe-distance histogram of every allocated key (bin r: found at
    probe round r; bin max_probes: not found within the probe budget),
    table occupancy, and a consistency check: as many live table slots as
    allocated blocks, and every allocated block reachable."""
    keys = state.block_key
    allocated = keys != INVALID_KEY
    found = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    dist = torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    for r in range(cfg.max_probes):
        slots = _probe_slot(keys, r, cfg.table_size)
        hit = (state.table_key[slots] == keys) & allocated & ~found
        dist = torch.where(hit, r, dist)
        found |= hit
    bin_idx = torch.where(allocated,
                          torch.where(found, dist, cfg.max_probes),
                          cfg.max_probes + 1)     # unallocated: dropped
    hist = torch.bincount(bin_idx.long(),
                          minlength=cfg.max_probes + 2)[:cfg.max_probes + 1]
    tk = state.table_key
    n_used = torch.sum((tk != INVALID_KEY) & (tk != TOMBSTONE))
    n_alloc = torch.sum(allocated)
    n_unreachable = torch.sum(allocated & ~found)
    # one transfer for every number
    host = torch.cat([hist, torch.stack([n_used, n_alloc, n_unreachable]),
                      state.n_tombstones.reshape(1).long()]).cpu().numpy()
    hist_np = host[:cfg.max_probes + 1].astype(np.int32)
    n_used, n_alloc, n_unreachable, n_tomb = (int(v) for v in
                                              host[cfg.max_probes + 1:])
    return {
        "probe_histogram": hist_np,
        "table_used": n_used,
        "table_size": cfg.table_size,
        "load_factor": float(n_used) / cfg.table_size,
        "allocated_blocks": n_alloc,
        "tombstones": n_tomb,
        "consistent": n_used == n_alloc and n_unreachable == 0,
    }


@dataclasses.dataclass
class LinearSystemConfidence:
    """Per-solve confidence record."""

    sum_residual: float = 0.0
    sum_weight: float = 0.0
    num_corr: int = 0
    condition: float = 0.0
    matrix_condition: float = 0.0
    tracking_lost: bool = False

    def is_tracking_lost(self) -> bool:
        """Aggregate heuristics: condition > 150, sum residual > 2000, or
        mean residual per correspondence > 1.5."""
        if self.condition > 150.0:
            return True
        if self.sum_residual > 2000.0:
            return True
        if self.num_corr > 0 and \
                self.sum_residual / max(self.num_corr, 1) > 1.5:
            return True
        return False


class ICPErrorLog:
    """Per-frame, per-level solve records."""

    def __init__(self):
        self.frames: List[List[LinearSystemConfidence]] = []

    def new_frame(self):
        self.frames.append([])

    def record(self, conf: LinearSystemConfidence):
        if not self.frames:
            self.new_frame()
        self.frames[-1].append(conf)

    def last(self) -> Optional[LinearSystemConfidence]:
        if self.frames and self.frames[-1]:
            return self.frames[-1][-1]
        return None

    def record_frame_levels(self, level_stats) -> List[LinearSystemConfidence]:
        """Record one frame's per-level stats: ``icp_level_stats``
        ([levels, 4] = mean_residual, condition, corr_count, sum_weight,
        row 0 = finest), recorded coarsest first."""
        self.new_frame()
        for res, cond, corr, sum_w in _host(level_stats)[::-1]:
            self.record(LinearSystemConfidence(
                sum_residual=float(res * sum_w),
                sum_weight=float(sum_w),
                num_corr=int(corr),
                condition=float(cond),
                matrix_condition=float(cond)))
        return self.frames[-1]

    def report_last(self) -> str:
        """One line per level for the last frame."""
        if not self.frames or not self.frames[-1]:
            return "icp: (no records)"
        lines = []
        n = len(self.frames[-1])
        for i, c in enumerate(self.frames[-1]):
            mean = c.sum_residual / max(c.sum_weight, 1e-12)
            lines.append(
                f"  icp L{n - 1 - i}: res={mean:.3e} cond={c.condition:8.2f}"
                f" corr={c.num_corr:6d} lost={c.is_tracking_lost()}")
        return "\n".join(lines)


class ConvergenceAnalysis:
    """Residual-versus-iteration curves, saved as a plottable table."""

    def __init__(self):
        self.curves: List[List[float]] = []

    def new_curve(self):
        self.curves.append([])

    def record(self, residual: float):
        if not self.curves:
            self.new_curve()
        self.curves[-1].append(residual)

    def record_frame(self, iter_residuals):
        """Record ``icp_iter_residuals`` ([levels, max_iters], NaN-padded)
        as one curve per level, coarsest first."""
        for row in _host(iter_residuals)[::-1]:
            self.new_curve()
            for r in row:
                if not math.isnan(r):
                    self.record(float(r))

    def save(self, path: str):
        with open(path, "w") as f:
            f.write("# iteration residual (one curve per column)\n")
            n = max((len(c) for c in self.curves), default=0)
            for i in range(n):
                row = [f"{c[i]:.6e}" if i < len(c) else ""
                       for c in self.curves]
                f.write("\t".join([str(i)] + row) + "\n")


def memory_report(state: MapState, cfg: MapConfig) -> Dict[str, float]:
    """Device memory of the map's arrays (MB) and its capacity."""
    def mb(t):
        return t.numel() * t.element_size() / 1e6

    return {
        "pool_mb": mb(state.sdf) + mb(state.weight) + mb(state.color),
        "table_mb": mb(state.table_key) + mb(state.table_val),
        "block_keys_mb": mb(state.block_key),
        "voxels_total": state.sdf.numel(),
        "blocks_capacity": cfg.num_blocks,
    }
