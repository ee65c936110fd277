"""Kernel A (``fused_integrate_kernel``): the least time for the bytes and
operations its frame needs (its active rows and updated voxels) over its
profiled time, summed over the eager frames split by stage."""


def read(ctx):
    w, cam, mp = ctx.work, ctx.cfg.camera, ctx.cfg.map
    least = took = 0.0
    for fr in ctx.frames:
        ms = sum(v for k, v in fr["kernels"].items()
                 if "fused_integrate_kernel" in k)
        if ms <= 0.0:
            continue
        least += w.bound_ms(
            w.integrate_bytes(fr["n_active"], fr["n_updated"],
                              mp.max_active_blocks, cam),
            w.integrate_ops(fr["n_active"], fr["n_updated"]))[0]
        took += ms
    return 100.0 * least / took if took > 0.0 else None
