"""Engine layer: wall ms a frame less device-busy ms a frame, both over
the profiled sub-window (one whole lap of graphed frames): the time a
frame the device waits on the host. The profiler's own host work is in
it."""


def read(ctx):
    return ctx.frame_ms - ctx.busy_ms
