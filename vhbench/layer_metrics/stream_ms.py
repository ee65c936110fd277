"""Streaming layer: host ms a frame inside the streaming manager's step
(``AsyncStreamingManager.step``: the stream-out sweep and delete queued,
the host store's pop, the bitmask's updates and the stream-in insert
queued), by the host clock around each call, over the window's frames
that were not profiled."""


def read(ctx):
    return None if ctx.stream is None else ctx.stream.ms
