"""A whole run on the CPU at tiny sizes (the harness's look for a card
skipped): the result line's shape, ``correct`` true for the program and
false for the control and for each fault the cells can have, a cell, a
mix and a metric added by files alone, and the refusals of the command
line."""

import json
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from conftest import REPO, make_tiny_root
from vhbench import harness

SEED = 2 ** 33 + 5


def _run(root, control=0, faults=None, seconds=1.0, workload="tiny.room"):
    torch.set_num_threads(4)
    args = SimpleNamespace(workload=workload, seed=SEED, seconds=seconds,
                           trace=0, control=control)
    return harness.run(args, time.perf_counter(), root, device="cpu",
                       faults=faults)


def test_program_is_correct_and_the_line_has_the_contract_shape(tiny_root):
    res = _run(tiny_root)
    _shape_and_correct(res)


def test_sessions_are_correct(tmp_path):
    """Under sessions every lap starts on a fresh map; the window crosses
    a session's start and the check frames run after it."""
    root = make_tiny_root(tmp_path, mix="corridor_sessions", frames=20)
    _shape_and_correct(_run(root, seconds=4.0))


def _shape_and_correct(res):
    assert list(res)[:3] == ["correct", "attempted", "failed"]
    assert list(res)[-1] == "checks"
    assert {"metrics", "device"} <= set(res)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"fps", "frame_ms_p95", "setup_s"}
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_control_is_not_correct(tiny_root):
    res = _run(tiny_root, control=1)
    assert res["correct"] is False
    assert res["checks"]["map_mismatch_ppm"]["value"] > 1000
    assert res["checks"]["pose_gap_um"]["value"] > 100


def test_a_change_of_rounding_alone_is_correct(tiny_root):
    """The reference with every float32 value its fusion computes moved
    one ulp (``--control 2``, what a contracted multiply-add or another
    order of a sum reads) stays inside the configuration's limits, though
    its map differs from the program's."""
    res = _run(tiny_root, control=2)
    assert res["checks"]["map_mismatch_ppm"]["value"] > 0
    assert res["correct"] is True, res["checks"]


class _Unchanged:
    """A step that returns the state it was given, unchanged."""

    def __init__(self, step):
        self.step = step

    def __call__(self, state, depth, color):
        from voxelhashing_tpu_torch.engine import _clone_state
        keep = _clone_state(state)
        _, diag = self.step(state, depth, color)
        return keep._replace(frame_host=state.frame_host + 1), diag

    def close(self):
        self.step.close()


class _PoseAltered(_Unchanged):
    """A step whose pose is moved 0.5 mm along x where it is produced."""

    def __call__(self, state, depth, color):
        state, diag = self.step(state, depth, color)
        state.pose[0, 3] += 0.0005
        return state, diag


class _HalfRows(_Unchanged):
    """A step whose fusion leaves out half of the active rows."""

    def __call__(self, state, depth, color):
        from voxelhashing_tpu_torch import engine
        fuse = engine.fused_integrate

        def half(st, d, c, pose, cam, mp, active_idx, n_active):
            return fuse(st, d, c, pose, cam, mp, active_idx, n_active // 2)
        engine.fused_integrate = half
        try:
            return self.step(state, depth, color)
        finally:
            engine.fused_integrate = fuse


@pytest.mark.parametrize("fault", [_Unchanged, _PoseAltered, _HalfRows],
                         ids=["state_unchanged", "pose_altered",
                              "half_the_rows"])
def test_a_broken_step_is_not_correct(tiny_root, fault):
    assert _run(tiny_root, faults=fault)["correct"] is False


def test_cell_mix_and_metric_added_by_files_alone(tmp_path):
    """A new mix, a new cell and a new per-layer metric need only new
    files and new BENCHMARK.json entries; the harness finds each by its
    name. (On the CPU a traced run cannot profile the card, so the new
    reader is found and called through the harness's lookup.)"""
    root = make_tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "vhbench").rglob("*")
              if p.is_file()}
    mix = json.loads((root / "vhbench/traffic/tiny_mix.json").read_text())
    mix["path"] = {"kind": "sway", "frames": 12, "shift": [0.1, 0.0, 0.0],
                   "turn": [0.05, 0.0]}
    (root / "vhbench/traffic/new_mix.json").write_text(json.dumps(mix))
    (root / "vhbench/layer_metrics/new_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.new", "config": "tiny",
                               "traffic": "new_mix", "chips": 1,
                               "why": "added by a file"})
    bench["per_layer"].append({"name": "new_metric", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "engine", "moves": "fps"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        assert p.read_bytes() == data
    res = _run(root, workload="tiny.new")
    assert res["correct"] is True and res["attempted"] > 0
    _, _, _, layer = harness.cell_of(bench, "tiny.new")
    assert "new_metric" in [m["name"] for m in layer]
    assert harness.find_reader(root, "new_metric")(None) == 42.0


def _cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "vhbench/run.py", "--workload",
         "vh_4mm_icp_splat.room_orbit", "--seed", "3", "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = _cli(REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "vhbench", tmp_path / "vhbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the chip")
    out = _cli(REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"


def test_a_cap_that_drops_blocks_is_not_correct(tmp_path):
    """A configuration whose active list is shorter than the blocks in
    view drops blocks from the frame: ``dropped_blocks`` counts them and
    the run is not correct, though the reference, at the same cap, agrees
    with the program."""
    root = make_tiny_root(tmp_path)
    path = root / "vhbench/configs/tiny.json"
    conf = json.loads(path.read_text())
    conf["engine"]["map"]["max_active_blocks"] = 1024
    path.write_text(json.dumps(conf))
    res = _run(root)
    assert res["checks"]["dropped_blocks"]["value"] > 0
    assert res["correct"] is False
