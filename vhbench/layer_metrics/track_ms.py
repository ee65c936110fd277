"""Device ms a frame of the track stage: the ops that started inside its
``stage:track`` range of the eager frames split by stage."""


def read(ctx):
    return ctx.stage_ms.get("track")
