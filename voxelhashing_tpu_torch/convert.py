"""Bit-exact converters between the JAX package's states and the port's,
and from the JAX package's configs to the port's.

The JAX side is handed over as numpy (``np.asarray`` of every leaf); bf16
arrays arrive as ``ml_dtypes.bfloat16`` and travel through an int16 view,
uint32 colors and eviction-bitmask words through an int32 view. Both
packages start every parity test from one state and one configuration this
way; a sharded state converts rank by rank. Nothing here imports the
JAX package: it reads the objects it is given.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import config
from .blockmap import MapState
from .densegrid import DenseGrid, DenseGridConfig
from .engine import EngineState
from .parallel.sharded import ShardedState

_TPU_TIERS = {"alloc_insert_small"}


def config_from(cfg):
    """The port's config with the values of ``cfg``, a JAX package config
    (``EngineConfig``, ``MapConfig``, ...; nested configs convert too).

    A field the port's class does not have must hold its JAX default, or
    this raises: that part of the configuration is not ported. The one
    exception is a TPU dispatch tier (``_TPU_TIERS``): the port always
    takes the full width, which gives the same result.
    """
    cls = getattr(config, type(cfg).__name__)
    keep = {f.name for f in dataclasses.fields(cls)}
    kw = {}
    for f in dataclasses.fields(cfg):
        value = getattr(cfg, f.name)
        if f.name in keep:
            kw[f.name] = (config_from(value)
                          if dataclasses.is_dataclass(value) else value)
            continue
        if f.name in _TPU_TIERS:
            continue
        default = (f.default if f.default is not dataclasses.MISSING
                   else f.default_factory())
        if value != default:
            raise ValueError(f"{type(cfg).__name__}.{f.name}={value!r} is "
                             "not ported (only its default is accepted)")
    return cls(**kw)


def dense_config_from(cfg) -> DenseGridConfig:
    """The port's ``DenseGridConfig`` with the values of ``cfg``, a JAX
    ``densegrid.DenseGridConfig`` (the same fields; raises if they
    differ)."""
    names = [f.name for f in dataclasses.fields(DenseGridConfig)]
    if [f.name for f in dataclasses.fields(cfg)] != names:
        raise ValueError(f"{type(cfg).__name__} has other fields than "
                         f"DenseGridConfig: {dataclasses.fields(cfg)}")
    return DenseGridConfig(**{n: getattr(cfg, n) for n in names})


def _tensor(a, device, view=None):
    device = config.resolve_device(device)
    a = np.asarray(a)
    if view is not None:
        a = a.view(view)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _array(t, view=None):
    a = t.detach().cpu().numpy()
    return a if view is None else a.view(view)


def map_state_from_numpy(ms, device="cuda") -> MapState:
    """JAX ``MapState`` (leaves as numpy or anything ``np.asarray`` takes)
    -> port ``MapState`` on ``device`` (the card unless the caller asks for
    the CPU)."""
    return MapState(
        table_key=_tensor(ms.table_key, device),
        table_val=_tensor(ms.table_val, device),
        block_key=_tensor(ms.block_key, device),
        sdf=_tensor(ms.sdf, device, np.int16).view(torch.bfloat16),
        weight=_tensor(ms.weight, device, np.int16).view(torch.bfloat16),
        color=_tensor(ms.color, device, np.int32),
        surf=_tensor(ms.surf, device),
        free_stack=_tensor(ms.free_stack, device),
        n_free=_tensor(ms.n_free, device),
        n_tombstones=_tensor(ms.n_tombstones, device),
        dense_upto=_tensor(ms.dense_upto, device),
    )


def map_state_to_numpy(ms: MapState) -> dict:
    """Port ``MapState`` -> dict of numpy arrays in the JAX dtypes
    (bf16 pool rows as ``ml_dtypes.bfloat16``, color as uint32)."""
    import ml_dtypes

    return {
        "table_key": _array(ms.table_key),
        "table_val": _array(ms.table_val),
        "block_key": _array(ms.block_key),
        "sdf": _array(ms.sdf.view(torch.int16), ml_dtypes.bfloat16),
        "weight": _array(ms.weight.view(torch.int16), ml_dtypes.bfloat16),
        "color": _array(ms.color, np.uint32),
        "surf": _array(ms.surf),
        "free_stack": _array(ms.free_stack),
        "n_free": _array(ms.n_free),
        "n_tombstones": _array(ms.n_tombstones),
        "dense_upto": _array(ms.dense_upto),
    }


def bitmask_from_numpy(words, device="cuda"):
    """JAX eviction bitmask (uint32 words) -> the port's int32 words, the
    same bits."""
    return _tensor(np.asarray(words, np.uint32), device, np.int32)


def bitmask_to_numpy(words) -> np.ndarray:
    """The port's int32 eviction bitmask -> uint32 words as JAX holds them."""
    return _array(words, np.uint32)


def dense_grid_from_numpy(g, device="cuda") -> DenseGrid:
    """JAX ``DenseGrid`` (leaves as numpy or anything ``np.asarray`` takes)
    -> the port's on ``device``: sdf and weight as they are, the uint32
    color as int32 with the same bits."""
    return DenseGrid(sdf=_tensor(g.sdf, device),
                     weight=_tensor(g.weight, device),
                     color=_tensor(g.color, device, np.int32))


def dense_grid_to_numpy(g: DenseGrid) -> dict:
    """The port's ``DenseGrid`` -> dict of numpy arrays in the JAX dtypes
    (color as uint32)."""
    return {"sdf": _array(g.sdf), "weight": _array(g.weight),
            "color": _array(g.color, np.uint32)}


def engine_state_from_numpy(es, device="cuda") -> EngineState:
    """JAX ``EngineState`` -> port ``EngineState`` (the host frame counter
    is read from ``es.frame``)."""
    frame = _tensor(es.frame, device)
    return EngineState(
        map=map_state_from_numpy(es.map, device),
        pose=_tensor(es.pose, device),
        frame=frame,
        tracking_lost=_tensor(es.tracking_lost, device),
        n_integrated=_tensor(es.n_integrated, device),
        frame_host=int(np.asarray(es.frame)),
    )


def engine_state_to_numpy(es: EngineState) -> dict:
    """Port ``EngineState`` -> dict with the JAX fields as numpy arrays
    (``map`` is a nested dict, see :func:`map_state_to_numpy`)."""
    return {
        "map": map_state_to_numpy(es.map),
        "pose": _array(es.pose),
        "frame": _array(es.frame),
        "tracking_lost": _array(es.tracking_lost),
        "n_integrated": _array(es.n_integrated),
    }


def sharded_state_from_numpy(ss, rank: int, device="cuda"):
    """Rank ``rank``'s part of a JAX ``ShardedState`` (map leaves with a
    leading device axis, pose and frame replicated; numpy or anything
    ``np.asarray`` takes) -> the port's per-rank
    ``parallel.sharded.ShardedState`` on ``device``."""
    local = type(ss.map)(*(np.asarray(leaf)[rank] for leaf in ss.map))
    return ShardedState(map=map_state_from_numpy(local, device),
                        pose=_tensor(ss.pose, device),
                        frame=_tensor(ss.frame, device),
                        frame_host=int(np.asarray(ss.frame)))


def sharded_state_to_numpy(states) -> dict:
    """The port's per-rank ``ShardedState`` objects, in rank order -> a
    dict of numpy arrays in the JAX ``ShardedState`` layout: ``map`` with
    every leaf stacked on a leading device axis (see
    :func:`map_state_to_numpy`), ``pose`` and ``frame`` from the first."""
    maps = [map_state_to_numpy(s.map) for s in states]
    return {"map": {k: np.stack([m[k] for m in maps]) for k in maps[0]},
            "pose": _array(states[0].pose),
            "frame": _array(states[0].frame)}
