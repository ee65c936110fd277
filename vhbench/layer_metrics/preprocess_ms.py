"""Device ms a frame of the preprocess stage: the ops that started inside its
``stage:preprocess`` range of the eager frames split by stage."""


def read(ctx):
    return ctx.stage_ms.get("preprocess")
