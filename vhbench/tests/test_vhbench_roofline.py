"""The roofline arithmetic and the trace reduction against hand-computed
cases."""

from types import SimpleNamespace

import pytest

from vhbench import harness, work
from vhbench.reference.config import CameraConfig, EngineConfig, MapConfig

ONE_PIXEL = CameraConfig(width=1, height=1)


def test_bound_picks_the_larger_time():
    assert work.bound_ms(3.35e9, 0) == pytest.approx((1.0, "bytes"))
    ms, by = work.bound_ms(0, 67e9)
    assert (ms, by) == (pytest.approx(1.0), "operations")
    ms, by = work.bound_ms(3.35e9, 2 * 67e9)
    assert (ms, by) == (pytest.approx(2.0), "operations")


def test_integrate_bytes_and_ops_by_hand():
    # one row: 512 voxels x (2 + 2) B read, the one-pixel frame (4 B depth
    # and 12 B RGB), 9 B for the row, 8 B stats for each of 2 rows, the
    # view (64 B) and n_active (4 B); 3 updated voxels: 12 B each
    assert work.integrate_bytes(1, 3, 2, ONE_PIXEL) == \
        2048 + 36 + 16 + 9 + 16 + 68
    assert work.integrate_ops(1, 3) == 46 * 512 + 28 * 3


def test_splat_bytes_and_ops_by_hand():
    # two surface rows: 2 x 2048 B of voxels, 2 x 8 B of list and key,
    # 5 B of mask, one 4 B pixel, the view
    assert work.splat_bytes(2, 5, ONE_PIXEL) == 4096 + 16 + 5 + 4 + 64
    assert work.splat_ops(2, 10) == 3 * 512 * 2 + 36 * 10


def test_march_bytes_and_ops_by_hand():
    w = work.MarchWork(rays=2, samples=10, crossed=1, lookups=4,
                       probe_rounds=6, slots=3, rows=2, voxels=20,
                       color_voxels=8, tiles=1)
    assert work.march_bytes(w) == 12 + 8 + 80 + 32 + 8 + 64 + 58
    assert work.march_ops(w) == (23 * 2 + 191 * 14 + 99 + 16 * 4 + 5 * 6
                                 + 16 * 3)


def test_roofline_reader_is_bound_over_time():
    """A frame whose kernel took exactly its bound reads 100%, one that
    took twice as long 50%, and a frame without the kernel nothing."""
    from vhbench.layer_metrics import integrate_roofline as reader
    cfg = EngineConfig(camera=ONE_PIXEL, map=MapConfig(max_active_blocks=2))
    nbytes = work.integrate_bytes(10, 100, 2, ONE_PIXEL)
    least = work.bound_ms(nbytes, work.integrate_ops(10, 100))[0]
    frame = {"n_active": 10, "n_updated": 100,
             "kernels": {"void fused_integrate_kernel<false>(...)": least}}
    ctx = SimpleNamespace(cfg=cfg, work=work, frames=[frame])
    assert reader.read(ctx) == pytest.approx(100.0)
    frame["kernels"] = {"fused_integrate_kernel<false>": 2 * least}
    assert reader.read(ctx) == pytest.approx(50.0)
    ctx.frames = [{"n_active": 1, "n_updated": 1, "kernels": {}}]
    assert reader.read(ctx) is None


def test_busy_time_is_the_union_of_ops():
    ops = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("c", 20.0, 25.0)]
    assert harness.busy_us(ops, 0.0, 30.0) == pytest.approx(17.0)
    assert harness.busy_us(ops, 6.0, 22.0) == pytest.approx(8.0)


def test_breakdown_names_ops_and_gaps():
    ops = [("k1", 0.0, 10.0), ("k2", 30.0, 35.0), ("k1", 36.0, 40.0)]
    host = [("bench:frame", 0.0, 50.0), ("cudaStreamSynchronize", 12.0,
                                         29.0)]
    b = harness.breakdown(ops, host, 0.0, 50.0)
    assert b["device_ops"][0] == ["k1", pytest.approx(14e-6)]
    assert b["idle_gaps"][0] == ["cudaStreamSynchronize",
                                 pytest.approx(20e-6)]
    assert b["idle_gaps"][1] == ["bench:frame", pytest.approx(10e-6)]
