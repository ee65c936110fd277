"""Shared fixtures of the benchmark's own tests: a tiny copy of the
benchmark (a 160x120 camera, an 8,192-block map, a 20-frame lap) that
runs on the CPU, and a tiny streamed copy on the hallway mix."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")


def tiny_groups(groups: dict) -> dict:
    g = json.loads(json.dumps(groups))
    g["camera"].update(width=160, height=120, fx=131.325, fy=131.325,
                       cx=79.75, cy=59.75)
    g["map"].update(voxel_size=0.01, truncation=0.04, num_blocks=8192,
                    table_size=32768, max_active_blocks=8192,
                    alloc_insert_cap=2048, alloc_stage_cap=4096,
                    gc_delete_cap=256)
    return g


def make_tiny_root(dest: Path, config="vh_4mm_icp_splat",
                   mix="room_orbit", frames=20) -> Path:
    """A directory holding BENCHMARK.json and a copy of vhbench whose one
    cell, ``tiny.room``, is ``config`` on ``mix`` cut to tiny sizes, with
    the configuration's own limits."""
    shutil.copytree(REPO / "vhbench", dest / "vhbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    conf = json.loads((REPO / f"vhbench/configs/{config}.json").read_text())
    conf["engine"] = tiny_groups(conf["engine"])
    (dest / "vhbench/configs/tiny.json").write_text(json.dumps(conf))
    m = json.loads((REPO / f"vhbench/traffic/{mix}.json").read_text())
    m["path"]["frames"] = frames
    (dest / "vhbench/traffic/tiny_mix.json").write_text(json.dumps(m))
    bench["configs"] = [{"name": "tiny", "source": "a test",
                         "file": "vhbench/configs/tiny.json",
                         "reduced": [], "why": "a test"}]
    bench["workloads"] = [{"name": "tiny.room", "config": "tiny",
                           "traffic": "tiny_mix", "chips": 1,
                           "why": "a test"}]
    for m in bench["per_layer"]:
        m.pop("workloads", None)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


def make_stream_root(dest: Path, frames: int = 120) -> Path:
    """A tiny streamed cell: ``vh_10mm_scan`` cut to tiny sizes with a
    3.0 m sphere, 1.2 m chunks and 8 stream-out parts, on the hallway
    walked out and back at 5 cm a frame (to 3 m and back in 120 frames):
    the lap files the blocks left behind out and brings the spheres'
    chunks back, and the wall's chunks come back into view marked before
    they come back."""
    root = make_tiny_root(dest, config="vh_10mm_scan",
                          mix="hallway_stream", frames=frames)
    path = root / "vhbench/configs/tiny.json"
    conf = json.loads(path.read_text())
    conf["engine"]["streaming"].update(chunk_size=1.2, radius=3.0,
                                       out_parts=8)
    path.write_text(json.dumps(conf))
    path = root / "vhbench/traffic/tiny_mix.json"
    mix = json.loads(path.read_text())
    mix["path"]["step"] = [0.05, 0.0, 0.0]
    path.write_text(json.dumps(mix))
    return root


@pytest.fixture(scope="module")
def stream_root(tmp_path_factory):
    return make_stream_root(tmp_path_factory.mktemp("stream"))
