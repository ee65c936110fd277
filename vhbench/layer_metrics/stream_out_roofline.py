"""Streaming layer: the sweep (``stream_sweep_kernel``) against the least
bytes a sweep of a pool part must move (``vhbench/stream_work.py``: one
key a row of the part, a 32-byte sector each at the part's stride), over
its profiled time in the lap. The rows it lists, and their copies, are
left out: the reader cannot see them. None where the program has no sweep
kernel."""


def read(ctx):
    from vhbench import stream_work
    took = [b - a for name, a, b in ctx.device_ops
            if "stream_sweep_kernel" in name]
    if not took:
        return None
    least = ctx.work.bound_ms(stream_work.sweep_bytes(
        ctx.cfg.map, ctx.cfg.streaming), 0)[0]
    return 100.0 * least * len(took) / (sum(took) / 1000.0)
