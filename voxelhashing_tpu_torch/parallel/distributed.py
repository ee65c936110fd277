"""Process-group runtime of the sharded engine (port of
``voxelhashing_tpu.parallel.distributed`` on ``torch.distributed``).

Host-side only:

* **Bring-up**: :func:`initialize` over ``dist.init_process_group`` with
  an explicit address (``tcp://host:port`` or ``file://path``), world size
  and rank: nothing on the machine announces a cluster. The default
  backend is NCCL when every rank has a card of its own, and gloo on the
  CPU or when ranks share a card (NCCL refuses two ranks on one device;
  ``collectives`` stages CUDA tensors through pinned memory for gloo).
* **Devices and state**: :func:`rank_device` picks a rank's card,
  :func:`create_sharded_global` builds the rank's empty shard there (no
  process ever holds the whole pool), :func:`replicate` uploads the host's
  copy of replicated data (every rank is handed the same frame) and
  :func:`fetch_replicated` reads a replicated result back.
* **Launch**: :func:`spawn` starts the ranks of one host as processes
  (start method ``spawn``), with a time limit.

A two-rank session::

    from voxelhashing_tpu_torch.parallel import distributed, sharded
    distributed.initialize("file:///tmp/vh_store", world_size=2, rank=r)
    state, lcfg = distributed.create_sharded_global(cfg)
    step = sharded.make_sharded_step(cfg)
    for depth, color in frames:
        state, pose = step(state, distributed.replicate(depth),
                           distributed.replicate(color))
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import EngineConfig, MapConfig, resolve_device
from . import sharded
from .sharded import ShardedState


def default_backend(world_size: int) -> str:
    """NCCL when this host has a card for every rank, else gloo."""
    if torch.cuda.is_available() \
            and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def initialize(init_method: str, world_size: int, rank: int,
               backend: Optional[str] = None) -> None:
    """Bring up the default process group (``backend`` None: see
    :func:`default_backend`)."""
    backend = backend or default_backend(world_size)
    if backend == "nccl":
        torch.cuda.set_device(rank_device(rank))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def rank_device(rank: Optional[int] = None, device="cuda") -> torch.device:
    """The device of a rank: ``cuda:(local_rank % device_count)`` (the
    local rank is ``LOCAL_RANK`` when set, else ``rank``, else the rank in
    the default group), or the CPU when ``device`` asks for it. Raises
    when a card is asked for and there is none."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if "LOCAL_RANK" in os.environ:
        local = int(os.environ["LOCAL_RANK"])
    elif rank is not None:
        local = rank
    else:
        local = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", local % torch.cuda.device_count())


def create_sharded_global(cfg: EngineConfig, group=None, initial_pose=None,
                          device="cuda") -> Tuple[ShardedState, MapConfig]:
    """This rank's empty shard and the replicated pose on the rank's
    device (:func:`rank_device`)."""
    rank = dist.get_rank(group) if dist.is_initialized() else None
    return sharded.create_sharded(cfg, group, initial_pose,
                                  device=rank_device(rank, device))


def replicate(x, device=None):
    """The host's copy of replicated data on the rank's device (``device``
    None: :func:`rank_device`)."""
    device = rank_device() if device is None else resolve_device(device)
    return torch.as_tensor(np.asarray(x)).to(device)


def fetch_replicated(x) -> np.ndarray:
    """A replicated result (the pose) back on the host."""
    return x.detach().cpu().numpy()


def spawn(fn, world_size: int, args: tuple = (),
          timeout: Optional[float] = None) -> None:
    """Run ``fn(rank, *args)`` in ``world_size`` new processes (start
    method ``spawn``; ``fn`` and ``args`` are pickled) and wait for all.
    A rank that raises stops the others and its error is raised here;
    after ``timeout`` seconds every rank is killed and ``TimeoutError``
    raised. Each rank brings up its own process group."""
    ctx = torch.multiprocessing.start_processes(
        fn, args=args, nprocs=world_size, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world_size} ranks still running "
                                   f"after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
