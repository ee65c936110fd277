"""Build and load the port's CUDA kernels (``csrc/*.cu``).

At first use ``nvcc`` compiles each source into a shared library of its
own with a plain C interface for Hopper (``sm_90a``), one ``nvcc`` per
source, all started together, in ``build/voxelhashing_tpu_torch/`` at the
repository root, named by the source and a hash of the sources and flags;
each library is loaded with ctypes. Nothing is fetched and no binary is
committed. A missing ``nvcc`` or a failed build raises.

``-fmad=false`` keeps nvcc from contracting multiply-adds, so the kernels
round exactly like their plain PyTorch versions. ``-Xptxas -v`` reports
each kernel's registers, shared memory and spills into ``<library>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "voxelhashing_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
# exported functions of each library: argument types (all return int)
_SIGNATURES = {
    "fused_integrate": {
        "vh_fused_integrate": [_P] * 11 + [_I] * 3 + [_F] * 12 + [_I, _P],
        "vh_fused_integrate_grid": [],
        "vh_fused_integrate_bilinear":
            [_P] * 11 + [_I] * 3 + [_F] * 12 + [_I, _P],
        "vh_fused_integrate_bilinear_grid": [],
        "vh_frame_color_words": [_P, _P, _I, _P],
    },
    "splat_zbuf": {
        "vh_splat_zbuf": [_P] * 7 + [_I] * 3 + [_F] * 7 + [_I, _P],
        "vh_splat_zbuf_grid": [],
        "vh_splat_zbuf_color": [_P] * 10 + [_I] * 3 + [_F] * 7 + [_I, _P],
        "vh_splat_zbuf_color_grid": [],
    },
    "icp_linearize": {
        "vh_icp_pass": [_P, _I, _P, _I, _I, _P],
        "vh_icp_linearize_grid": [],
    },
    "preprocess": {
        "vh_preprocess": [_P, _LL, _LL, _I, _I, _P] + [_LL] * 3 + [_F] * 2
        + [_I] * 2 + [_F] * 4 + [_I, _P] + [_F] * 7 + [_P] * 4 + [_I] * 2
        + [_P],
        "vh_preprocess_grid": [],
        "vh_preprocess_check_division": [_F] * 4 + [_P, _P],
    },
    "alloc_candidates": {
        "vh_alloc_candidates": [_P, _LL, _LL, _I, _I, _P, _LL, _LL, _P, _P]
        + [_I] * 8 + [_F] * 10 + [_I] * 5 + [_P, _P],
        "vh_alloc_candidates_grid": [],
    },
    "hash_alloc": {
        "vh_hash_alloc": [_P] + [_I] * 10 + [_P] * 9 + [_I] + [_P] * 6,
        "vh_hash_alloc_grid": [],
    },
    "hash_delete": {
        "vh_hash_delete": [_P] * 2 + [_I] + [_P] * 13 + [_I] * 3 + [_P] * 2,
        "vh_hash_gc": [_P] * 4 + [_I] * 3 + [_F, _I] + [_P] * 13
        + [_I] * 3 + [_P] * 2 + [_I, _P, _P],
        "vh_hash_delete_grid": [],
    },
    "raymarch": {
        "vh_ray_bounds": [_P] * 3 + [_I, _P] + [_I] * 6 + [_F] * 8
        + [_P] * 4,
        "vh_raymarch": [_P] * 5 + [_I] * 3 + [_F] + [_P] * 3 + [_I] * 5
        + [_F] * 12 + [_P] * 7,
        "vh_raymarch_grid": [],
    },
    "solve6": {
        "vh_solve6": [_P, _P, _LL, _I, _LL, _F] + [_P] * 4 + [_I, _P],
        "vh_icp_update": [_P] * 21 + [_I] * 4 + [_F] * 6 + [_P],
        "vh_empty": [_P],
    },
    "trace_stamp": {
        "vh_trace_stamp": [_P, _P] + [_I] * 5 + [_P] * 3 + [_I] * 4 + [_P],
        "vh_trace_stamp_grid": [],
    },
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return path


def sources():
    return sorted(CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` for the current sources and
    flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libvhtorch_{name}_{h.hexdigest()[:16]}.so"


def build() -> Dict[str, Path]:
    """Compile every library that does not exist yet, one ``nvcc`` per
    source, side by side; returns {name: path}. Each compiler's resource
    report (-Xptxas -v) is kept beside its library as ``.log``."""
    out = {src.stem: library_path(src.stem) for src in sources()}
    todo = [(src, out[src.stem]) for src in sources()
            if not out[src.stem].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src, lib in todo:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs.append((src, lib, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, lib, tmp, proc in procs:
        report, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{report}")
            continue
        lib.with_suffix(".log").write_text(report)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built at first use)."""
    lib = ctypes.CDLL(str(build()[name]))
    for fn_name, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.vh_error_string.argtypes = [ctypes.c_int]
    lib.vh_error_string.restype = ctypes.c_char_p
    return lib


def prime() -> None:
    """Load every library and run each kernel's occupancy query (which
    loads its module on the card), so that no first-use set-up falls
    inside a CUDA graph capture."""
    for name, fns in _SIGNATURES.items():
        lib = library(name)
        for fn in fns:
            if fn.endswith("_grid"):
                getattr(lib, fn)()


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = library(what).vh_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def ptr_or_null(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
