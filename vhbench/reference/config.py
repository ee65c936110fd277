"""Configuration of the reference: a frozen copy of the dataclasses of
``voxelhashing_tpu_torch.config`` (the same field names and defaults), and
:func:`from_dict`, which builds an :class:`EngineConfig` from the groups
of a configuration file.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

SDF_BLOCK_SIZE = 8
VOXELS_PER_BLOCK = SDF_BLOCK_SIZE ** 3


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole intrinsics at the working resolution."""

    width: int = 320
    height: int = 240
    fx: float = 262.65
    fy: float = 262.65
    cx: float = 159.75
    cy: float = 119.75
    depth_min: float = 0.5
    depth_max: float = 5.0


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Sparse TSDF voxel-block map parameters (see the JAX
    ``MapConfig`` for what each one does)."""

    voxel_size: float = 0.004
    truncation: float = 0.02
    truncation_scale: float = 0.01
    max_integration_distance: float = 4.0
    integration_weight_sample: float = 10.0
    integration_weight_max: float = 255.0
    num_blocks: int = 1 << 17
    table_size: int = 1 << 19
    max_probes: int = 8
    insert_probes: int = 3
    max_active_blocks: int = 1 << 15
    alloc_insert_cap: int = 1 << 13
    alloc_stage_cap: int = 1 << 14
    alloc_steps: int = 8
    alloc_fold: int = 4
    alloc_tile: int = 4
    alloc_fold_tile: int = 8
    alloc_novelty: bool = True
    world_blocks: int = 1024
    gc_starve_interval: int = 15
    maintain_interval: int = 32
    gc_enabled: bool = True
    gc_delete_cap: int = 1024
    # bilinear color sample (integrate._bilinear_color; kernel A's
    # bilinear variant on the card) in place of the nearest pixel's
    bilinear_color: bool = False
    alloc_rounds_offline: int = 3

    @property
    def block_size_world(self) -> float:
        return self.voxel_size * SDF_BLOCK_SIZE

    def truncation_at(self, z):
        """Linear truncation model."""
        return self.truncation + self.truncation_scale * z


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Multi-resolution projective-ICP parameters; ``use_rgbd`` adds the
    photometric rows (weighted ``weight_depth`` / ``weight_color``,
    intensity residuals cut off at ``color_sigma``)."""

    levels: int = 3
    max_outer_iter: Tuple[int, ...] = (8, 6, 4)
    max_inner_iter: Tuple[int, ...] = (1, 1, 1)
    dist_thres: Tuple[float, ...] = (0.15, 0.15, 0.15)
    normal_thres: Tuple[float, ...] = (0.97, 0.97, 0.97)
    angle_trans_thres: Tuple[float, ...] = (1.0, 1.0, 1.0)
    dist_trans_thres: Tuple[float, ...] = (1.0, 1.0, 1.0)
    residual_early_out: Tuple[float, ...] = (0.01, 0.01, 0.01)
    cond_thres: float = 2.0e4
    normal_aniso_thres: float = 4.0e-3
    use_rgbd: bool = False
    weight_depth: float = 1.0
    weight_color: float = 0.1
    color_sigma: float = 0.1


@dataclasses.dataclass(frozen=True)
class RaycastConfig:
    """Surface prediction parameters: ``mode`` "splat" (voxel splatting,
    kernel B) or "march" (trilinear ray march, ``num_samples`` samples per
    ray inside per-tile depth bounds of ``splat_tile`` pixels)."""

    ray_increment_factor: float = 0.8
    thres_sample_dist_factor: float = 50.5
    thres_dist_factor: float = 50.0
    use_gradients: bool = False
    mode: str = "splat"
    hole_fill_rounds: int = 2
    refine_trilinear: bool = False
    num_samples: int = 48
    splat_enabled: bool = True
    splat_tile: int = 16

    def derived(self, map_cfg: MapConfig):
        ray_increment = self.ray_increment_factor * map_cfg.truncation
        return {
            "ray_increment": ray_increment,
            "thres_sample_dist": self.thres_sample_dist_factor * ray_increment,
            "thres_dist": self.thres_dist_factor * ray_increment,
        }


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Depth/color prefiltering."""

    depth_sigma_d: float = 2.0
    depth_sigma_r: float = 0.1
    depth_filter: bool = True
    color_sigma_d: float = 2.0
    color_sigma_r: float = 0.1
    color_filter: bool = False


@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    """Device <-> host block tiering: an active sphere around the camera,
    a coarse chunk grid on the host, and an eviction bitmask over that
    grid that keeps streamed-out space from being re-allocated."""

    enabled: bool = False
    chunk_size: float = 1.0       # chunk edge (m)
    grid_dim: int = 257           # chunks per bitmask grid edge
    radius: float = 4.0           # active sphere radius (m)
    out_parts: int = 80           # the pool is swept 1/out_parts per frame
    in_chunks_per_frame: int = 1


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Mesh extraction."""

    max_triangles: int = 2_500_000
    thresh_factor: float = 10.0   # max corner sdf span, in voxels


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level configuration."""

    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    map: MapConfig = dataclasses.field(default_factory=MapConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    raycast: RaycastConfig = dataclasses.field(default_factory=RaycastConfig)
    filter: FilterConfig = dataclasses.field(default_factory=FilterConfig)
    streaming: StreamingConfig = dataclasses.field(
        default_factory=StreamingConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    offline: bool = True
    use_trajectory: bool = False
    use_trajectory_only_init: bool = False


def from_dict(groups: dict) -> EngineConfig:
    """An :class:`EngineConfig` from ``{"camera": {...}, "map": {...},
    ..., "offline": false}``: each group's keys are its dataclass's
    fields (lists become tuples); a key no dataclass has raises."""
    kinds = {f.name: f for f in dataclasses.fields(EngineConfig)}
    kw = {}
    for name, value in groups.items():
        if name not in kinds:
            raise KeyError(f"EngineConfig has no field {name!r}")
        if isinstance(value, dict):
            cls = kinds[name].default_factory
            known = {f.name for f in dataclasses.fields(cls)}
            bad = set(value) - known
            if bad:
                raise KeyError(f"{cls.__name__} has no fields {sorted(bad)}")
            value = cls(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in value.items()})
        kw[name] = value
    return EngineConfig(**kw)
