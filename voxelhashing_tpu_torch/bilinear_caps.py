"""Kernel A's bilinear variant under register caps, on one card.

    python -m voxelhashing_tpu_torch.bilinear_caps [N ...]

Builds ``csrc/fused_integrate.cu`` as it is and once for each N (default
9, 8 and 7) with ``__launch_bounds__(128, N)`` on the bilinear
instantiation (the nearest-color one then gets a minimum of 1, which is
not its own bound: only the bilinear kernel is timed), prints the ptxas
report of each build's bilinear kernel, and at ``chip_smoke.py``'s phase-2
state with bilinear color holds each build bit for bit against the plain
version and times it (``chip_smoke.hold_a`` and ``time_a``). Needs one
CUDA card and nvcc; the builds go to ``build/voxelhashing_tpu_torch/``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import re
import shutil
import subprocess
import sys

import torch

from . import ab_step
from .ops import _build

_BOUND = "__launch_bounds__(kRowThreads)"


def variant_source(ctas_per_sm):
    """The kernel source with the bilinear instantiation bounded to
    ``ctas_per_sm`` CTAs an SM (None: the source as it is)."""
    src = (_build.CSRC / "fused_integrate.cu").read_text()
    if src.count(_BOUND) != 1:
        raise RuntimeError(f"fused_integrate.cu: expected one {_BOUND}")
    if ctas_per_sm is None:
        return src
    return src.replace(_BOUND, f"__launch_bounds__(kRowThreads, kBilinear "
                               f"? {ctas_per_sm} : 1)")


def _build_all(caps):
    """Compile every variant side by side; returns {name: library path}."""
    out = _build.BUILD_DIR / "bilinear_caps"
    out.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.iterdir():
        shutil.copy(f, out / f.name)
    procs = {}
    for n in (None, *caps):
        name = "as is" if n is None else f"{n} CTAs an SM"
        src = out / f"fused_integrate_{n or 0}.cu"
        src.write_text(variant_source(n))
        procs[name] = (src.with_suffix(".so"), subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(src.with_suffix(".so")), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({name}):\n{report}")
        # the bilinear kernel's lines follow its "Compiling ... ILb1E" line
        lines = report.splitlines()
        at = next(i for i, ln in enumerate(lines)
                  if "Compiling" in ln and "ILb1E" in ln)
        usage = [ln.split(": ", 1)[-1].strip() for ln in lines[at + 1:at + 4]
                 if re.search(r"registers|spill", ln)]
        print(f"ptxas, bilinear kernel, {name}: {'; '.join(usage)}")
        libs[name] = lib
    return libs


def _load(path):
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _build._SIGNATURES["fused_integrate"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.vh_error_string.argtypes = [ctypes.c_int]
    lib.vh_error_string.restype = ctypes.c_char_p
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("caps", type=int, nargs="*", default=[9, 8, 7],
                    help="CTAs an SM for __launch_bounds__")
    args = ap.parse_args(argv)
    libs = _build_all(args.caps)
    smoke = ab_step._smoke()
    device, gpu = torch.device("cuda", 0), smoke._smi()
    cfg = smoke._config()
    snap, est, depth, color, _, _ = smoke.phase_step(cfg, device, gpu)
    cfg = dataclasses.replace(cfg, map=dataclasses.replace(
        cfg.map, bilinear_color=True))
    base, d, c, aidx, n_act = smoke._a_inputs(cfg, snap.map, depth[11],
                                              color[11], est[11], 11)
    library = _build.library
    try:
        for name, path in libs.items():
            lib = _load(path)
            # kernel A's wrapper launches through _build.library
            _build.library = (lambda n, lib=lib: lib
                              if n == "fused_integrate" else library(n))
            grid = lib.vh_fused_integrate_bilinear_grid()
            label = f"bilinear A, {name} ({grid} CTAs)"
            smoke.hold_a(cfg, base, d, c, est[11], aidx, n_act, label)
            smoke.time_a(cfg, base, d, c, est[11], aidx, n_act, label, gpu)
    finally:
        _build.library = library
    return 0


if __name__ == "__main__":
    sys.exit(main())
