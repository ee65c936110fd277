"""Device ms a frame of the render stage: the ops that started inside its
``stage:render`` range of the eager frames split by stage."""


def read(ctx):
    return ctx.stage_ms.get("render")
