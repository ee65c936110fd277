"""Diagnostics: per-stage timing, hash histograms, tracking confidence
(port of ``voxelhashing_tpu.diagnostics``).

``TimingLog.stop(stage, sync=t)`` waits for the device of ``t`` before it
reads the clock (``torch.cuda.synchronize``), as the JAX version waits
with ``jax.block_until_ready``. ``hash_histogram`` runs on the map's
device and reads its numbers back in one transfer. The ICP logs read the
engine's ``FrameDiagnostics.icp_level_stats`` and ``icp_iter_residuals``
(tensors on any device, or numpy).
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from .config import MapConfig
from .blockmap import MapState, TOMBSTONE, _probe_slot
from .geometry import INVALID_KEY


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
