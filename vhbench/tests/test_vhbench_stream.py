"""The streamed cell on the CPU at tiny sizes: a lap that files blocks out
and brings them back reads ``correct`` with ``stream_mismatch`` 0; a
manager that loses a filed block, a step that ignores the bitmask and the
control are not correct; traffic that stops streaming reads infinite; and
the reference's streaming half equals the program's managers bit for bit,
step after step from the same state."""

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import REPO, make_tiny_root, tiny_groups
from vhbench import check, harness
from vhbench.reference import config as rconfig, streaming as rstream

SEED = 2 ** 33 + 11


def _run(root, control=0, faults=None, seconds=1.0):
    torch.set_num_threads(4)
    args = SimpleNamespace(workload="tiny.room", seed=SEED, seconds=seconds,
                           trace=0, control=control)
    return harness.run(args, time.perf_counter(), root, device="cpu",
                       faults=faults)


def test_streamed_lap_is_correct(stream_root, capfd):
    """The check compares a frame whose streaming half files blocks out
    and one whose half brings blocks in (else ``stream_mismatch`` reads
    infinite), and the program agrees with the reference on both."""
    res = _run(stream_root)
    err = capfd.readouterr().err
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["stream_mismatch"] == {"value": 0.0, "limit": 0.0}
    assert res["failed"] == 0
    halves = [line for line in err.splitlines()
              if "reference's streaming half" in line]
    moved = [tuple(int(w) for w in line.split() if w.isdigit())[-2:]
             for line in halves]
    assert any(o > 0 for o, _ in moved) and any(i > 0 for _, i in moved)


class _IgnoresBitmask:
    """A step that allocates in chunks the bitmask marks: it is handed
    an empty bitmask."""

    def __init__(self, step):
        self.step = step

    def __call__(self, state, depth, color, bitmask):
        return self.step(state, depth, color, torch.zeros_like(bitmask))

    def close(self):
        self.step.close()


def _loses_a_filed_block(monkeypatch):
    """The manager's worker files each stream-out but its last block."""
    from voxelhashing_tpu_torch import streaming
    file = streaming.AsyncStreamingManager._worker_file

    def lossy(self, ev, count, keys, sdf, w, c):
        return file(self, ev, torch.clamp(count - 1, min=0), keys, sdf, w,
                    c)
    monkeypatch.setattr(streaming.AsyncStreamingManager, "_worker_file",
                        lossy)


@pytest.mark.parametrize("fault", ["loses_a_filed_block", "ignores_bitmask"])
def test_a_broken_streamed_program_is_not_correct(stream_root, monkeypatch,
                                                  fault):
    faults = None
    if fault == "loses_a_filed_block":
        _loses_a_filed_block(monkeypatch)
    else:
        faults = _IgnoresBitmask
    res = _run(stream_root, faults=faults)
    assert res["correct"] is False
    assert res["checks"]["stream_mismatch"]["value"] > 0


def test_streamed_control_is_not_correct(stream_root):
    """The control (the reference in bfloat16 between stages, put in the
    program's place with its own streaming half) fails a limit."""
    res = _run(stream_root, control=1)
    assert res["correct"] is False
    assert res["checks"]["pose_gap_um"]["value"] > 30


def test_traffic_that_stops_streaming_reads_infinite(tmp_path):
    """With a sphere no block ever leaves, no compared frame files blocks
    out or brings any in: ``stream_mismatch`` reads infinite."""
    root = make_tiny_root(tmp_path, config="vh_10mm_scan", mix="room_orbit")
    path = root / "vhbench/configs/tiny.json"
    conf = json.loads(path.read_text())
    conf["engine"]["streaming"]["radius"] = 1000.0
    path.write_text(json.dumps(conf))
    res = _run(root)
    assert res["checks"]["stream_mismatch"]["value"] == float("inf")
    assert res["correct"] is False


def test_unstreamed_configurations_report_no_stream_number(tiny_root):
    res = _run(tiny_root)
    assert "stream_mismatch" not in res["checks"]


# -- the reference's streaming half against the program's managers --------


def _configs():
    groups = tiny_groups(json.loads(
        (REPO / "vhbench/configs/vh_10mm_scan.json").read_text())["engine"])
    groups["streaming"].update(chunk_size=1.2, radius=3.0, out_parts=4)
    return harness.program_config(groups), rconfig.from_dict(groups)


def _seeded_map(cfg, n=1500, seed=3):
    """A program map holding ``n`` blocks spread over x -2..6 m, y -1..1 m
    and z 0..2.4 m, with seeded rows (sdf and weight exact in bfloat16)."""
    from voxelhashing_tpu_torch import blockmap, geometry as geom, streaming
    mp = cfg.map
    rng = np.random.default_rng(seed)
    bs = mp.block_size_world
    lo = np.floor(np.array([-2.0, -1.0, 0.0]) / bs).astype(int)
    hi = np.floor(np.array([6.0, 1.0, 2.4]) / bs).astype(int)
    blocks = np.unique(rng.integers(lo, hi, size=(3 * n, 3)), axis=0)
    blocks = blocks[rng.permutation(len(blocks))[:n]]
    keys = geom.pack_block_key(torch.from_numpy(blocks.astype(np.int32)),
                               mp.world_blocks).to(torch.int32)
    sdf = torch.from_numpy(rng.uniform(-1, 1, (n, 512)).astype(np.float32))
    w = torch.from_numpy(rng.integers(0, 8, (n, 512)).astype(np.float32))
    c = torch.from_numpy(rng.integers(0, 1 << 24, (n, 512)).astype(np.int32))
    state = blockmap.create(mp, "cpu")
    state, _, placed = streaming.insert_blocks(
        state, keys, sdf.to(torch.bfloat16).float(),
        w.to(torch.bfloat16).float(), c, mp)
    assert bool(placed.all())
    return state


@pytest.mark.parametrize("kind", ["StreamingManager",
                                  "AsyncStreamingManager"])
def test_reference_half_matches_the_manager(kind):
    """At each camera position of a walk out to 6 m and back, the
    reference's half from copies of the manager's state (the map, the
    store read through its interface, the bitmask, the next part), taking
    first the chunks the manager took, leaves the same map, store and
    bitmask as the manager's step, bit for bit; the walk files blocks out
    and brings them back, and the manager takes a chunk inside the sphere
    each time there is one."""
    from voxelhashing_tpu_torch import streaming
    cfg, rcfg = _configs()
    mgr = getattr(streaming, kind)(cfg.map, cfg.streaming, device="cpu")
    state = _seeded_map(cfg)
    path = list(np.arange(0.0, 6.01, 0.5)) + list(np.arange(5.5, -0.01,
                                                           -0.5))
    moved, steps = [0, 0], 0
    for x in path:
        cam = np.array([x, 0.0, 0.0], np.float32)
        for _ in range(cfg.streaming.out_parts):
            part = steps % cfg.streaming.out_parts
            st = harness.stream_state(mgr, part)
            ref_map = check.map_copy(state)
            state = mgr.step(state, cam)
            steps += 1
            after = harness.stream_state(mgr, steps % cfg.streaming.out_parts)
            ref_map, n_out, n_in = rstream.half(
                ref_map, st, cam, rcfg.map, rcfg.streaming,
                rstream.taken(st, after))
            assert st.part == after.part
            for name, a, b in zip(state._fields, state, ref_map):
                assert torch.equal(a, b), (x, name)
            assert rstream.mismatch(after, st, state, ref_map, rcfg.map,
                                    rcfg.streaming) == 0, x
            moved[0] += n_out
            moved[1] += n_in
    assert moved[0] > 100 and moved[1] > 100, moved
    if kind == "AsyncStreamingManager":
        mgr.close()


def test_the_streamed_configuration_and_its_reader():
    """``vh_10mm_scan`` streams and has a limit for every number a
    streamed check reads, ``stream_mismatch`` at 0; the streaming layer's
    reader gives the window's host ms a half, and nothing without
    streaming."""
    conf = json.loads((REPO / "vhbench/configs/vh_10mm_scan.json")
                      .read_text())
    assert conf["engine"]["streaming"]["enabled"] is True
    assert set(conf["check"]) == set(check.NUMBERS) | {check.STREAM_NUMBER}
    assert conf["check"][check.STREAM_NUMBER] == 0.0
    read = harness.find_reader(REPO, "stream_ms")
    assert read(SimpleNamespace(stream=SimpleNamespace(ms=6.5))) == 6.5
    assert read(SimpleNamespace(stream=None)) is None
