"""Device ms a frame of the map's update: the alloc, integrate and gc
stages of the eager frames split by stage."""


def read(ctx):
    parts = [ctx.stage_ms.get(s) for s in ("alloc", "integrate", "gc")]
    return None if any(p is None for p in parts) else sum(parts)
