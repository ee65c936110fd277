"""Device: the share of the profiled sub-window (one whole lap of graphed
frames) in which no device op runs: 1 less its device-busy time over its
wall time, the ``busy_s`` and ``window_s`` of the run's ``device``."""


def read(ctx):
    return 100.0 * (1.0 - ctx.busy_ms / ctx.frame_ms)
