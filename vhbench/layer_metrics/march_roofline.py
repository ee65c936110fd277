"""The march (``raymarch_kernel``): the least time for the operations and
bytes the frame's rays need (the plain march's samples, lookups and
reads) over its profiled time, summed over the eager frames split by
stage."""


def read(ctx):
    w = ctx.work
    least = took = 0.0
    for fr in ctx.frames:
        ms = sum(v for k, v in fr["kernels"].items()
                 if "raymarch_kernel" in k)
        if ms <= 0.0 or "march" not in fr:
            continue
        least += w.bound_ms(w.march_bytes(fr["march"]),
                            w.march_ops(fr["march"]))[0]
        took += ms
    return 100.0 * least / took if took > 0.0 else None
