"""The collectives of the multi-device path, over ``torch.distributed``.

Each helper takes a process group (``None``: the default group) and
tensors on the rank's device, and returns tensors on that device. Under
gloo, which reduces in host memory, a CUDA tensor is staged explicitly
through a pinned host buffer: copied down, reduced, copied back. The
computation stays on the card and gloo only ever sees host tensors, so
every reduction op and dtype it has on the CPU is available. NCCL takes
the CUDA tensors as they are.

These are the counterparts of the JAX package's mesh collectives
(``lax.pmin``/``pmax``/``psum`` over the mesh axis). A failed collective
raises; nothing here catches it.

``all_reduce.calls`` counts the all-reduces, for the per-frame numbers of
``chip_smoke.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def resolve(group=None):
    """``group``, or the default group for None. The hooks of the
    single-device modules (``raycast.render_march(group=)``, ...) read
    None as "no reduction", so the sharded path hands them this."""
    return dist.group.WORLD if group is None else group


def world(group=None) -> Tuple[int, int]:
    """(rank, world size) in ``group``; (0, 1) when no process group is
    initialized and ``group`` is None (this process alone)."""
    if group is None and not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _on_host(group) -> bool:
    return dist.get_backend(group) == dist.Backend.GLOO


def _to_comm(t, group):
    """A contiguous copy of ``t`` where the backend reads it: for gloo a
    CUDA tensor goes to pinned host memory, anything else is copied where
    it is."""
    if t.is_cuda and _on_host(group):
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        return buf
    return t.clone(memory_format=torch.contiguous_format)


def _back(buf, like):
    """``buf`` on ``like``'s device (an asynchronous upload from pinned
    memory; the caching host allocator keeps the buffer until it ran)."""
    if buf.device == like.device:
        return buf
    return buf.to(like.device, non_blocking=buf.is_pinned())


def all_reduce(t, op: str = "sum", group=None):
    """``t`` reduced over the ranks with ``op`` ("sum", "min" or "max");
    ``t`` itself is left unchanged."""
    buf = _to_comm(t, group)
    dist.all_reduce(buf, op=_OPS[op], group=group)
    out = _back(buf, t)
    all_reduce.calls += 1
    return out


all_reduce.calls = 0


def sum_tuple(sums: Sequence[torch.Tensor], group=None):
    """Sum a tuple of partial sums over the ranks in ONE all-reduce: the
    parts are flattened into one f32 buffer and split back into their
    shapes and dtypes. Integer parts (correspondence counts) must stay
    below 2^24, where f32 holds them exactly."""
    flat = torch.cat([s.reshape(-1).to(torch.float32) for s in sums])
    red = all_reduce(flat, "sum", group)
    out, i = [], 0
    for s in sums:
        n = s.numel()
        out.append(red[i:i + n].reshape(s.shape).to(s.dtype))
        i += n
    return tuple(out)


def broadcast(t, src: int = 0, group=None):
    """``t`` as rank ``src`` holds it, on every rank (every rank passes a
    tensor of the same shape and dtype)."""
    buf = _to_comm(t, group)
    dist.broadcast(buf, src=src, group=group)
    return _back(buf, t)


def broadcast_int(value: Optional[int], src: int = 0, group=None,
                  device="cpu") -> int:
    """Rank ``src``'s Python int on every rank (others pass anything)."""
    t = torch.tensor([0 if value is None else int(value)], dtype=torch.int64,
                     device=device)
    return int(broadcast(t, src, group)[0])


def all_gather_counts(n: int, group=None, device="cpu") -> List[int]:
    """Every rank's ``n``, in rank order, on every rank."""
    _, size = world(group)
    t = _to_comm(torch.tensor([int(n)], dtype=torch.int64, device=device),
                 group)
    outs = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(outs, t, group=group)
    return [int(o[0]) for o in outs]


def gather_rows(rows: Sequence[torch.Tensor], group=None, dst: int = 0
                ) -> Optional[List[List[torch.Tensor]]]:
    """Gather each rank's rows (tensors of equal leading length n_r) to
    rank ``dst``: the counts first, then the rows padded to the longest.
    Returns on ``dst`` one list per rank of its rows (on ``dst``'s
    device), and None elsewhere."""
    me, size = world(group)
    n = int(rows[0].shape[0])
    counts = all_gather_counts(n, group, rows[0].device)
    n_max = max(counts)
    out = [[] for _ in range(size)] if me == dst else None
    for t in rows:
        pad = torch.zeros((n_max,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        pad[:n] = t
        buf = _to_comm(pad, group)
        parts = ([torch.empty_like(buf) for _ in range(size)]
                 if me == dst else None)
        dist.gather(buf, gather_list=parts, dst=dst, group=group)
        if me == dst:
            for r, p in enumerate(parts):
                out[r].append(_back(p[:counts[r]], t))
    return out


def scatter_rows(parts: Optional[Sequence[torch.Tensor]], like, group=None,
                 src: int = 0):
    """Rank ``src`` sends ``parts[r]`` (each shaped and typed as ``like``)
    to rank r; every rank returns its part on ``like``'s device."""
    me, _ = world(group)
    buf = _to_comm(torch.empty_like(like), group)
    send = ([_to_comm(p, group) for p in parts] if me == src else None)
    dist.scatter(buf, scatter_list=send, src=src, group=group)
    return _back(buf, like)
