"""Kernel B (``splat_zbuf_kernel<false>``, the depth-only splat render):
the least time for the bytes and operations its frame needs (its surface
rows and band voxels) over its profiled time, summed over the eager
frames split by stage."""


def read(ctx):
    w, cam, mp = ctx.work, ctx.cfg.camera, ctx.cfg.map
    least = took = 0.0
    for fr in ctx.frames:
        ms = sum(v for k, v in fr["kernels"].items()
                 if "splat_zbuf_kernel<false>" in k)
        if ms <= 0.0 or "splat" not in fr:
            continue
        rows, band = fr["splat"]
        least += w.bound_ms(w.splat_bytes(rows, mp.max_active_blocks, cam),
                            w.splat_ops(rows, band))[0]
        took += ms
    return 100.0 * least / took if took > 0.0 else None
