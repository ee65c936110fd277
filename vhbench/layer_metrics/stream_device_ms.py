"""Streaming layer: device ms a frame of the streaming half's own kernels
over the profiled lap: the sweep (``stream_sweep_kernel``), the rows'
copy into the ring slot (``stream_extract_kernel``), the bitmask's sets
and clears (``stream_bits_kernel``) and the stream-out delete
(``hash_delete_kernel<false>``). Left out, since their names are shared
with the step's: the delete's and the insert's table copies, and the
insert's ``hash_alloc_kernel`` and plain torch launches. None where the
program has no sweep kernel (its half then runs as plain torch)."""

NAMES = ("stream_sweep_kernel", "stream_extract_kernel",
         "stream_bits_kernel", "hash_delete_kernel<false>")


def read(ctx):
    ops = [(name, a, b) for name, a, b in ctx.device_ops
           if any(k in name for k in NAMES)]
    if not any(NAMES[0] in name for name, _, _ in ops):
        return None
    return sum(b - a for _, a, b in ops) / 1000.0 / ctx.prof_frames
