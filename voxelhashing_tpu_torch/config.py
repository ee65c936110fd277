"""Configuration of the PyTorch port (mirrors ``voxelhashing_tpu.config``).

The same frozen dataclasses, field names and defaults as the JAX package,
without its TPU-only dispatch tier (``alloc_insert_small``), and the same
reader of the reference's ``key = value;`` parameter files
(:func:`parse_parameter_file`, :func:`engine_config_from_parameters`).
``convert.config_from`` builds these from a JAX config and refuses one
that sets a left-out field away from its default.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

SDF_BLOCK_SIZE = 8
VOXELS_PER_BLOCK = SDF_BLOCK_SIZE ** 3


def resolve_device(device="cuda"):
    """The ``torch.device`` an entry point builds on: the card unless the
    caller names another device (``None`` also means the card). Raises a
    ``RuntimeError`` when the card is asked for and there is none; the CPU
    is used only when asked for with ``device="cpu"``."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(dev)!r} but no CUDA device is available; pass "
            f"device=\"cpu\" to run on the CPU")
    return dev


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


_KV_RE = re.compile(
    r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s*(?:\[(\d+)\])?\s*=\s*(.*?)\s*;?\s*(?://.*)?$"
)


def parse_parameter_file(text: str) -> dict:
    """Parse a reference-style ``key = value;`` parameter file.

    Same grammar as mLib's ParameterFile consumed by GlobalAppState::readMembers:
    one ``key = value;`` per line, ``//`` comments, optional ``[i]`` vector
    indices, trailing f suffixes on floats, quoted strings, booleans.
    Returns a flat dict; vector keys become lists.
    """
    out: dict = {}
    for line in text.splitlines():
        line = line.split("//", 1)[0].strip()
        if not line:
            continue
        m = _KV_RE.match(line)
        if not m:
            continue
        key, idx, raw = m.group(1), m.group(2), m.group(3).rstrip(";").strip()
        val = _parse_value(raw)
        if idx is None:
            out[key] = val
        else:
            lst = out.setdefault(key, [])
            i = int(idx)
            while len(lst) <= i:
                lst.append(None)
            lst[i] = val
    return out


def _parse_value(raw: str):
    if raw.startswith('"') and raw.endswith('"'):
        return raw[1:-1]
    low = raw.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    # space-separated numeric vectors ("1.0f 1.0f 1.0f",
    # "513 513 513" — the s_streaming* vec3 grammar)
    toks = raw.split()
    if len(toks) > 1:
        vals = [_parse_scalar(t) for t in toks]
        if all(isinstance(v, (int, float)) for v in vals):
            return vals
    return _parse_scalar(raw)


def _parse_scalar(raw: str):
    raw = raw.rstrip("fF") if re.match(r"^-?[\d.]+([eE][-+]?\d+)?[fF]$", raw) else raw
    try:
        if re.match(r"^-?\d+$", raw):
            return int(raw)
        return float(raw)
    except ValueError:
        return raw


def engine_config_from_parameters(params: dict,
                                  base: Optional[EngineConfig] = None) -> EngineConfig:
    """Build an EngineConfig from parsed reference-style parameters.

    Applies the same key semantics as GlobalAppState/GlobalCameraTrackingState
    (warn-and-default on missing keys -> here: just default).
    """
    cfg = base or EngineConfig()
    cam = cfg.camera
    if "s_adapterWidth" in params or "s_adapterHeight" in params:
        cam = dataclasses.replace(
            cam,
            width=int(params.get("s_adapterWidth", cam.width)),
            height=int(params.get("s_adapterHeight", cam.height)),
        )
    cam = dataclasses.replace(
        cam,
        depth_min=float(params.get("s_sensorDepthMin", cam.depth_min)),
        depth_max=float(params.get("s_sensorDepthMax", cam.depth_max)),
    )
    mp = dataclasses.replace(
        cfg.map,
        voxel_size=float(params.get("s_SDFVoxelSize", cfg.map.voxel_size)),
        truncation=float(params.get("s_SDFTruncation", cfg.map.truncation)),
        truncation_scale=float(
            params.get("s_SDFTruncationScale", cfg.map.truncation_scale)),
        max_integration_distance=float(
            params.get("s_SDFMaxIntegrationDistance",
                       cfg.map.max_integration_distance)),
        integration_weight_sample=float(
            params.get("s_SDFIntegrationWeightSample",
                       cfg.map.integration_weight_sample)),
        integration_weight_max=float(
            params.get("s_SDFIntegrationWeightMax",
                       cfg.map.integration_weight_max)),
        gc_enabled=bool(params.get("s_garbageCollectionEnabled",
                                   cfg.map.gc_enabled)),
        gc_starve_interval=int(params.get("s_garbageCollectionStarve",
                                          cfg.map.gc_starve_interval)),
    )
    # Map capacities (zParametersDefault.txt:34-36): the pool size follows
    # s_hashNumSDFBlocks directly; the open-addressing table replaces the
    # bucketed table (s_hashNumBuckets x HASH_BUCKET_SIZE slots) and is
    # sized to the next power of two >= max(2*num_blocks, numBuckets) so
    # probe chains stay short at the requested load.
    if "s_hashNumSDFBlocks" in params or "s_hashNumBuckets" in params:
        nb = int(params.get("s_hashNumSDFBlocks", mp.num_blocks))
        want = max(2 * nb, int(params.get("s_hashNumBuckets", 0)), 256)
        mp = dataclasses.replace(
            mp, num_blocks=nb,
            table_size=1 << (want - 1).bit_length(),
            max_active_blocks=min(mp.max_active_blocks, nb))
    rc = dataclasses.replace(
        cfg.raycast,
        ray_increment_factor=float(
            params.get("s_SDFRayIncrementFactor",
                       cfg.raycast.ray_increment_factor)),
        thres_sample_dist_factor=float(
            params.get("s_SDFRayThresSampleDistFactor",
                       cfg.raycast.thres_sample_dist_factor)),
        thres_dist_factor=float(
            params.get("s_SDFRayThresDistFactor",
                       cfg.raycast.thres_dist_factor)),
        use_gradients=bool(params.get("s_SDFUseGradients",
                                      cfg.raycast.use_gradients)),
    )
    flt = dataclasses.replace(
        cfg.filter,
        depth_sigma_d=float(params.get("s_depthSigmaD", cfg.filter.depth_sigma_d)),
        depth_sigma_r=float(params.get("s_depthSigmaR", cfg.filter.depth_sigma_r)),
        depth_filter=bool(params.get("s_depthFilter", cfg.filter.depth_filter)),
        color_sigma_d=float(params.get("s_colorSigmaD", cfg.filter.color_sigma_d)),
        color_sigma_r=float(params.get("s_colorSigmaR", cfg.filter.color_sigma_r)),
        color_filter=bool(params.get("s_colorFilter", cfg.filter.color_filter)),
    )
    tk = cfg.tracker
    if "s_maxLevels" in params:
        n = int(params["s_maxLevels"])

        def vec(key, default):
            v = params.get(key)
            if v is None:
                return tuple(default[:n]) if len(default) >= n else tuple(
                    list(default) + [default[-1]] * (n - len(default)))
            v = v[:n]
            return tuple(x if x is not None else default[min(i, len(default) - 1)]
                         for i, x in enumerate(v))

        tk = dataclasses.replace(
            tk,
            levels=n,
            max_outer_iter=tuple(int(x) for x in vec("s_maxOuterIter", tk.max_outer_iter)),
            max_inner_iter=tuple(int(x) for x in vec("s_maxInnerIter", tk.max_inner_iter)),
            dist_thres=vec("s_distThres", tk.dist_thres),
            normal_thres=vec("s_normalThres", tk.normal_thres),
            angle_trans_thres=vec("s_angleTransThres", tk.angle_trans_thres),
            dist_trans_thres=vec("s_distTransThres", tk.dist_trans_thres),
            residual_early_out=vec("s_residualEarlyOut", tk.residual_early_out),
            # RGBD variant weights (GlobalCameraTrackingState.h:13-25);
            # scalar here — the finest level's value is taken
            weight_depth=float(vec("s_weightsDepth",
                                   (tk.weight_depth,) * n)[0]),
            weight_color=float(vec("s_weightsColor",
                                   (tk.weight_color,) * n)[0]),
        )
    mesh = dataclasses.replace(
        cfg.mesh,
        max_triangles=int(params.get("s_marchingCubesMaxNumTriangles",
                                     cfg.mesh.max_triangles)),
        thresh_factor=float(params.get("s_SDFMarchingCubeThreshFactor",
                                       cfg.mesh.thresh_factor)),
    )
    def _vec0(v, default):
        """First component of a vec3 key (chunks are isotropic here; the
        reference's own chunk math treats the extents per-axis but every
        shipped config uses equal components)."""
        if v is None:
            return default
        return v[0] if isinstance(v, list) else v

    streaming = dataclasses.replace(
        cfg.streaming,
        enabled=bool(params.get("s_streamingEnabled", cfg.streaming.enabled)),
        out_parts=int(params.get("s_streamingOutParts", cfg.streaming.out_parts)),
        chunk_size=float(_vec0(params.get("s_streamingVoxelExtents"),
                               cfg.streaming.chunk_size)),
        grid_dim=int(_vec0(params.get("s_streamingGridDimensions"),
                           cfg.streaming.grid_dim)),
        # the reference marks s_streamingRadius "NOT USED; computed
        # automatically" (zParametersDefault.txt:99) but honours the key
        # when present; same here
        radius=float(params.get("s_streamingRadius", cfg.streaming.radius)),
    )
    return dataclasses.replace(
        cfg, camera=cam, map=mp, tracker=tk, raycast=rc, filter=flt,
        mesh=mesh, streaming=streaming,
        offline=bool(params.get("s_offlineProcessing", cfg.offline)),
        use_trajectory=bool(params.get("s_binaryDumpSensorUseTrajectory",
                                       cfg.use_trajectory)),
        use_trajectory_only_init=bool(
            params.get("s_binaryDumpSensorUseTrajectoryOnlyInit",
                       cfg.use_trajectory_only_init)),
    )
