"""The comparison that decides a run's ``correct``: the program's frames
against the plain reference (``reference/``), which imports nothing of
the program.

The program's map is a 4 GB state built over thousands of frames, and the
reference runs a frame in about a third of a second on the card, so the
reference follows the program frame by frame from the program's own
state, as a served model's reference follows its served tokens:

- **the start**: from an empty map, the reference runs the lap's first
  :data:`START_FRAMES` frames itself, each fused at the program's pose
  for that frame and tracked from the program's previous pose; its
  tracked poses are compared with the program's, and its map after the
  last of them with a snapshot of the program's taken then;
- **the window's state**: once the window has closed, the program runs
  :data:`CHECK_FRAMES` further frames of the lap through the same step
  object, at the same sizes, among them a starve frame and a frame on
  which the maintenance is decided (and, under sessions, the next
  session's first two frames: its eager frame on a fresh map and the
  first graphed frame that takes that map in); before each, the
  program's state is cloned, and the reference runs the frame from the
  clone (a session's first from a fresh map of its own): its tracked pose
  is compared with the program's, and the map it leaves, fused at the
  program's pose, with the program's.

Numbers compared, each against its limit (``check`` in the
configuration's file):

- ``pose_gap_um``: the largest distance between the program's and the
  reference's camera positions over the compared frames (micrometres;
  infinite where their trackers disagree on whether the frame was lost);
- ``rot_gap_urad``: the largest angle between their rotations
  (microradians; infinite likewise);
- ``map_mismatch_ppm``: voxels whose sdf, weight or color bits differ,
  plus entries of the hash table, the pool keys, the surface flags and the
  free list that differ, per million weighted voxels of the reference's
  map (the largest over the compared maps);
- ``dropped_blocks``: the blocks in view that the program left out of a
  frame's active list and the surface blocks past its splat cap
  (``FrameDiagnostics.active_overflow`` and ``splat_overflow``), summed
  over every frame of the run; the reference drops none;
- ``stream_mismatch`` (configurations that stream only): the rows of the
  host chunk store that differ between the program and the reference (a
  key or a voxel's bits at a chunk's position, or a row one side lacks),
  plus the bitmask words that differ, plus the blocks in chunks the
  reference's bitmask marks (space whose blocks are on the host) that one
  map holds and the other does not, the largest over the compared frames;
  infinite where the compared frames hold no frame whose streaming half
  files blocks out or none whose streaming half brings blocks in.

Under streaming (``reference/streaming.py``) every compared frame runs
the streaming half after the map's update, the program's (the manager's
step) and the reference's, each from the same copies of the program's
state before the frame (the map, the bitmask, the store's rows read
through its own interface, the next part as the harness counts the
manager's steps), the camera at the program's tracked position; the
reference's allocation honours the bitmask. The compared maps are those
after the streaming half. The program's half runs as in the window, its
worker filing the stream-out before or after the pop as it happens; the
one thing that can change is which chunks inside the sphere the store
gives first, a choice the semantics leave open, so the reference takes
the chunks the program took where they lie inside the sphere and takes
the others itself. What differs from the window is only that the host
work of the half before a compared frame is waited for first, so that
the copies hold it; that moves no row and no bit.

The control (:data:`CONTROLS`) puts the reference in the program's place,
computed with every float32 value it hands between stages, and the
fusion's own, rounded to bfloat16; the variant ``2`` instead moves each
float32 value the fusion computes one ulp (what a change of rounding
alone in the fusion, such as a contracted multiply-add or another order
of a sum, reads).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch

from .reference import engine as reng, streaming as rstream
from .reference.blockmap import MapState

START_FRAMES = 3
CHECK_FRAMES = 4
CHECK_SPAN = 45          # the check frames lie within this many frames
NUMBERS = ("pose_gap_um", "rot_gap_urad", "map_mismatch_ppm",
           "dropped_blocks")
STREAM_NUMBER = "stream_mismatch"


def f32_ulp(x):
    """A float32 tensor with each finite nonzero value moved one ulp, up
    where its last mantissa bit is 0 and down where it is 1; zeros, which
    mark what is missing, and infinities stay (other dtypes unchanged)."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        odd = (x.view(torch.int32) & 1) == 1
        moved = torch.where(odd, torch.nextafter(x, torch.full_like(
            x, -math.inf)), torch.nextafter(x, torch.full_like(x, math.inf)))
        return torch.where((x == 0) | ~torch.isfinite(x), x, moved)
    return x


# --control: the roundings of the reference put in the program's place
CONTROLS = (None, {"rnd": reng.to_bf16}, {"fuse_rnd": f32_ulp})


class Snapshot(NamedTuple):
    """The program's start, as the comparison needs it."""

    poses: List[np.ndarray]       # the program's pose after each frame
    valid: List[bool]             # its tracker's verdict each frame
    map: MapState                 # its map after the last frame, the pool
                                  # rows cut at ``dense_upto``
    stream: object = None         # under streaming, its streaming state
                                  # then (``rstream.Stream``)


def snapshot_map(m) -> MapState:
    """The program's map ``m`` in host memory, its pool rows cut at
    ``dense_upto`` (every row past it is free and zero)."""
    du = int(m.dense_upto)
    return MapState(*((t[:du] if name in ("sdf", "weight", "color") else t)
                      .to("cpu", copy=True)
                      for name, t in zip(MapState._fields, m)))


def unsnapshot_map(m: MapState, rows: int, device) -> MapState:
    """:func:`snapshot_map`'s map on ``device`` with its ``rows`` pool
    rows, those past ``dense_upto`` zero."""
    def full(t):
        out = torch.zeros((rows,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=device)
        out[:t.shape[0]] = t.to(device)
        return out
    return MapState(*(full(t) if name in ("sdf", "weight", "color")
                      else t.to(device)
                      for name, t in zip(MapState._fields, m)))


def map_copy(m) -> MapState:
    """A copy of the map fields of ``m`` (a program's ``MapState``) as the
    reference's ``MapState``, where they are."""
    return MapState(*(t.clone() for t in m))


def _rot_gap(a: np.ndarray, b: np.ndarray) -> float:
    """The angle of a's rotation to b's, accurate for small angles too."""
    r = a[:3, :3].astype(np.float64).T @ b[:3, :3].astype(np.float64)
    s = 0.5 * np.linalg.norm([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0],
                              r[1, 0] - r[0, 1]])
    return math.atan2(s, 0.5 * (np.trace(r) - 1.0))


def pose_gaps(prog: np.ndarray, prog_valid: bool, ref: np.ndarray,
              ref_valid: bool):
    """(position gap um, rotation gap urad) of two camera-to-world poses."""
    if prog_valid != ref_valid:
        return math.inf, math.inf
    dt = np.linalg.norm(prog[:3, 3].astype(np.float64)
                        - ref[:3, 3].astype(np.float64))
    return 1e6 * float(dt), 1e6 * _rot_gap(prog, ref)


def map_mismatch_ppm(prog: MapState, ref: MapState) -> float:
    """Differing voxels and list entries of two maps per million weighted
    voxels of ``ref``."""
    differ = 0
    rows = prog.sdf.shape[0]
    for lo in range(0, rows, 1 << 16):
        sl = slice(lo, min(rows, lo + (1 << 16)))
        d = torch.zeros((sl.stop - sl.start, prog.sdf.shape[1]),
                        dtype=torch.bool, device=prog.sdf.device)
        for f in ("sdf", "weight", "color"):
            a, b = getattr(prog, f)[sl], getattr(ref, f)[sl]
            if a.dtype == torch.bfloat16:
                a, b = a.view(torch.int16), b.view(torch.int16)
            d |= a != b.to(a.device)
        differ += int(d.sum())
    for f in ("table_key", "table_val", "block_key", "surf", "free_stack",
              "n_free", "n_tombstones", "dense_upto"):
        a, b = getattr(prog, f), getattr(ref, f).to(getattr(prog, f).device)
        differ += int((a != b).sum())
    weighted = sum(int((ref.weight[lo:lo + (1 << 16)] > 0).sum())
                   for lo in range(0, rows, 1 << 16))
    return 1e6 * differ / max(weighted, 1)


class Readings:
    """The largest reading of each number over the compared frames
    (``streamed``: with :data:`STREAM_NUMBER`)."""

    def __init__(self, streamed: bool = False):
        self.values = {k: 0.0 for k in NUMBERS
                       + ((STREAM_NUMBER,) if streamed else ())}

    def pose(self, prog, prog_valid, ref, ref_valid):
        t, r = pose_gaps(prog, prog_valid, ref, ref_valid)
        self.values["pose_gap_um"] = max(self.values["pose_gap_um"], t)
        self.values["rot_gap_urad"] = max(self.values["rot_gap_urad"], r)

    def map(self, prog: MapState, ref: MapState):
        self.values["map_mismatch_ppm"] = max(
            self.values["map_mismatch_ppm"], map_mismatch_ppm(prog, ref))

    def dropped(self, n: int):
        self.values["dropped_blocks"] = float(n)

    def stream(self, prog: "rstream.Stream", ref: "rstream.Stream",
               prog_map: MapState, ref_map: MapState, rcfg):
        self.values[STREAM_NUMBER] = max(
            self.values[STREAM_NUMBER], float(rstream.mismatch(
                prog, ref, prog_map, ref_map, rcfg.map, rcfg.streaming)))

    def stream_kinds_missing(self):
        """No compared frame filed blocks out, or none brought any in."""
        self.values[STREAM_NUMBER] = math.inf


def start(readings: Readings, rcfg, lap, snap: Snapshot, device, ctl):
    """The start: the reference from an empty map over the lap's first
    frames, at the program's poses (or, with the control's roundings
    ``ctl``, the rounded reference against the reference); under
    streaming each frame runs the streaming half, from an empty store."""
    control = ctl is not None
    streamed = snap.stream is not None
    ref_map = reng.create(rcfg, device)
    ctl_map = reng.create(rcfg, device) if control else None
    ref_st = ctl_st = None
    if streamed:
        ref_st = rstream.Stream.empty(rcfg.streaming, snap.stream.cap, device)
        ctl_st = ref_st.copy() if control else None
    last = torch.eye(4, dtype=torch.float32, device=device)
    for f, (pose, valid) in enumerate(zip(snap.poses, snap.valid)):
        d = torch.from_numpy(lap.depth[f]).to(device)
        c = torch.from_numpy(lap.color[f]).to(device)
        p = torch.from_numpy(pose).to(device)
        out = reng.step(ref_map, last, d, c, rcfg, f, pose=p,
                        integrate=valid, stream_bitmask=_bits(ref_st))
        ref_map = _half(out.map, ref_st, pose, rcfg)
        if control:
            c_out = reng.step(ctl_map, last, d, c, rcfg, f, pose=p,
                              integrate=valid, stream_bitmask=_bits(ctl_st),
                              **ctl)
            ctl_map = _half(c_out.map, ctl_st, pose, rcfg)
            if f > 0:
                readings.pose(c_out.pose.cpu().numpy(), c_out.valid,
                              out.pose.cpu().numpy(), out.valid)
        elif f > 0:
            readings.pose(pose, valid, out.pose.cpu().numpy(), out.valid)
        last = p
    prog_map = ctl_map if control else unsnapshot_map(
        snap.map, ref_map.sdf.shape[0], device)
    readings.map(prog_map, ref_map)
    if streamed:
        readings.stream(ctl_st if control else snap.stream, ref_st,
                        prog_map, ref_map, rcfg)
    del ref_map, ctl_map, prog_map


def _bits(st):
    return None if st is None else st.bitmask


def _half(m: MapState, st, pose: np.ndarray, rcfg, prefer=()) -> MapState:
    """The reference's streaming half on ``m`` and ``st`` with the camera
    at ``pose``'s position (``m`` as it is without streaming)."""
    if st is None:
        return m
    return rstream.half(m, st, pose[:3, 3], rcfg.map, rcfg.streaming,
                        prefer)[0]


def check_frames(seed: int, first: int, starve: int, maintain: int,
                 host_index, lap: int) -> List[int]:
    """The check frames after the window: frames from ``first`` on, drawn
    from ``seed`` within :data:`CHECK_SPAN` frames, among them the first
    starve frame there and the first on which the maintenance is decided
    (``host_index(k)``, the program's frame counter at frame k, a positive
    multiple of ``starve``, of ``maintain``); and where a map starts
    within a ``lap`` of frames (a session's counter 0), that frame and the
    next."""
    rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), 7])
    span = [k for k in range(first, first + CHECK_SPAN) if host_index(k)]
    s = {*[k for k in span if host_index(k) % starve == 0][:1],
         *[k for k in span if host_index(k) % maintain == 0][:1]}
    others = rng.choice([k for k in span if k not in s],
                        CHECK_FRAMES - len(s), replace=False)
    starts = [k for k in range(first, first + lap) if host_index(k) == 0]
    return sorted({*s, *map(int, others), *starts[:1],
                   *[k + 1 for k in starts[:1]]})


def frame(readings: Readings, rcfg, before: MapState, last, depth, color,
          frame_idx: int, pose: np.ndarray, valid: bool, prog_map,
          ctl, stream=None, prog_stream=None):
    """One check frame: the reference from ``before`` (a copy of the
    program's map before the frame; consumed) and the program's previous
    pose ``last``, fused at the program's ``pose``, against the program's
    pose and map after the frame (with the control's roundings ``ctl``:
    the rounded reference against the reference). Under streaming,
    ``stream`` is a copy of the program's streaming state before the frame
    (consumed) and ``prog_stream`` the program's after it: the reference
    runs the streaming half too, the chunks the program took in first
    (``rstream.taken``), and the stores are compared. Returns the
    blocks the reference's streaming half filed out and brought in (0, 0
    without streaming)."""
    p = torch.from_numpy(pose).to(last.device)
    ctl_map = map_copy(before) if ctl is not None else None
    ctl_st = stream.copy() if (ctl is not None and stream is not None) \
        else None
    ref = reng.step(before, last, depth, color, rcfg, frame_idx, pose=p,
                    integrate=valid, stream_bitmask=_bits(stream))
    ref_map, moved = ref.map, (0, 0)
    prefer = rstream.taken(stream, prog_stream) if stream is not None else ()
    if stream is not None:
        ref_map, n_out, n_in = rstream.half(ref_map, stream, pose[:3, 3],
                                            rcfg.map, rcfg.streaming, prefer)
        moved = (n_out, n_in)
    if ctl is not None:
        c_out = reng.step(ctl_map, last, depth, color, rcfg, frame_idx,
                          pose=p, integrate=valid,
                          stream_bitmask=_bits(ctl_st), **ctl)
        readings.pose(c_out.pose.cpu().numpy(), c_out.valid,
                      ref.pose.cpu().numpy(), ref.valid)
        c_map = _half(c_out.map, ctl_st, pose, rcfg, prefer)
        readings.map(c_map, ref_map)
        if stream is not None:
            readings.stream(ctl_st, stream, c_map, ref_map, rcfg)
    else:
        readings.pose(pose, valid, ref.pose.cpu().numpy(), ref.valid)
        readings.map(prog_map, ref_map)
        if stream is not None:
            readings.stream(prog_stream, stream, prog_map, ref_map, rcfg)
    return moved
