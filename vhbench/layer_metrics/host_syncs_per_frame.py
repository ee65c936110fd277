"""Engine layer: host syncs a graphed frame, counted by torch's sync
debug mode at the program's lines over steady frames."""


def read(ctx):
    return ctx.syncs_per_frame
