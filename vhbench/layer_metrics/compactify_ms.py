"""Device ms a frame of the compactify stage: the ops that started inside its
``stage:compactify`` range of the eager frames split by stage."""


def read(ctx):
    return ctx.stage_ms.get("compactify")
