"""Two checkouts compared on one card, each run in a fresh process whose
working directory is the checkout, so that the checkout's own
``voxelhashing_tpu_torch`` and kernels are imported.

    python -m voxelhashing_tpu_torch.ab_step DIR_A DIR_B [--pairs 10]

Needs one CUDA card. Two reports:

1. Phase 1 of ``chip_smoke.py`` (fused frames/s of the 20-frame step at the
   reference's default map capacity), alternating which side goes first:
   pair k runs A then B when k is even, B then A when it is odd. Each
   process runs the checkout's own phase 1 twice; the first run warms the
   caches and the second is the one compared. Prints every pair, each
   side's median and quartiles, and how many pairs B won.
2. The kernels, in the order A, B, B, A: ``chip_smoke.kernel_times_here``
   of THIS tree drives each checkout's port to the phase-2/3 state (then
   phase 4, the per-stage times of the step) and to the state just after
   the large scan's first stream-in, and times there through the public
   wrappers kernels A and B at both states, and a color render and A's
   bilinear variant (where the checkout has one) at the phase-2/3 state:
   torch.profiler's device time per call (every kernel of the call), the
   wrapper's own time, and the bound from this tree's byte and operation
   counts (``chip_smoke._work_a``, ``_work_b``, ``_work_color`` and
   ``_bound``), phase 4's device split of the alloc, integrate, render
   and GC stages, and the streamed large scan's frames/s. Prints every
   run and each side's medians.

Each process builds its checkout's kernels (cached in that checkout's
``build/``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

_FPS_CHILD = ("import json, torch, chip_smoke as c\n"
              "cfg, g = c._config(), c._smi()\n"
              "d = torch.device('cuda', 0)\n"
              "fps = [c.phase_step(cfg, d, g)[5] for _ in range(2)]\n"
              "print('AB_RESULT', json.dumps(fps))\n")
_KERNELS_CHILD = ("import importlib.util, json, sys\n"
                  "spec = importlib.util.spec_from_file_location(\n"
                  "    'smoke', sys.argv[1])\n"
                  "m = importlib.util.module_from_spec(spec)\n"
                  "spec.loader.exec_module(m)\n"
                  "print('AB_RESULT', json.dumps(m.kernel_times_here()))\n")
_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"
# kernel_times_here's results by key: what was timed and at which state
_STATES = {"a": ("kernel A", "phase 2"),
           "bl": ("bilinear A with its color-word image", "phase 2"),
           "b": ("kernel B", "phase 3"),
           "c": ("color render (B and its second walk, or the color walk "
                 "and the resolve)", "phase 3"),
           "a5": ("kernel A", "phase 5"), "b5": ("kernel B", "phase 5")}
_STAGES = ("alloc", "integrate", "render", "gc")


def _child(path: str, code: str, *args: str):
    res = subprocess.run([sys.executable, "-c", code, *args], cwd=path,
                         capture_output=True, text=True, check=False)
    if res.returncode != 0:
        sys.stderr.write(res.stdout[-4000:] + res.stderr[-4000:])
        raise RuntimeError(f"child failed in {path} ({res.returncode})")
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("AB_RESULT")]
    return json.loads(line[-1].split(" ", 1)[1])


def _smoke():
    """This tree's ``chip_smoke.py`` as a module (it imports only the
    standard library until a function is called)."""
    spec = importlib.util.spec_from_file_location("smoke", _SMOKE)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def _bound(smoke, key: str, k: dict):
    """(ms, what bounds it) for kernel ``key``'s counts ``k``."""
    import dataclasses
    cfg = smoke._large_scan_config() if key.endswith("5") \
        else smoke._config()
    if key == "bl":
        cfg = dataclasses.replace(cfg, map=dataclasses.replace(
            cfg.map, bilinear_color=True))
    if key.startswith(("a", "bl")):
        work = smoke._work_a(cfg, k["rows"], k["updated_voxels"],
                             k["max_rows"], k["with_color"])
    elif key == "c":
        work = smoke._work_color(cfg, k["rows"], k["band_voxels"],
                                 k["covered"], k["max_rows"])
    else:
        work = smoke._work_b(cfg, k["rows"], k["band_voxels"],
                             k["max_rows"])
    return smoke._bound(*work)


def _fmt(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def _median(xs):
    xs = [x for x in xs if x is not None]
    return statistics.median(xs) if xs else None


def phase1_pairs(dirs: dict, pairs: int) -> None:
    fps = {"A": [], "B": []}
    for k in range(pairs):
        order = ("A", "B") if k % 2 == 0 else ("B", "A")
        for side in order:
            fps[side].append(_child(dirs[side], _FPS_CHILD)[-1])
        print(f"pair {k}: {order[0]} first; A {fps['A'][-1]:.4f} "
              f"B {fps['B'][-1]:.4f} fused frames/s", flush=True)
    for side in ("A", "B"):
        q1, _, q3 = statistics.quantiles(fps[side], n=4)
        print(f"{side}: median {statistics.median(fps[side]):.4f}, "
              f"quartiles {q1:.4f}-{q3:.4f}, runs "
              f"{' '.join(f'{x:.4f}' for x in fps[side])}")
    wins = sum(b > a for a, b in zip(fps["A"], fps["B"]))
    ties = sum(b == a for a, b in zip(fps["A"], fps["B"]))
    print(f"B won {wins} of {pairs} pairs ({ties} ties)", flush=True)


def kernel_report(dirs: dict) -> None:
    smoke = _smoke()
    runs = {"A": [], "B": []}
    for side in ("A", "B", "B", "A"):
        r = _child(dirs[side], _KERNELS_CHILD, str(_SMOKE))
        runs[side].append(r)
        print(f"{side} ({dirs[side]}) on {r['card']}:", flush=True)
        for key, (what, state) in _STATES.items():
            k = r.get(key)
            if k is None:
                print(f"  {what} at the {state} state: not in this "
                      f"checkout", flush=True)
                continue
            bound, by = _bound(smoke, key, k)
            share = (f"{100 * bound / k['device_ms']:.1f}%"
                     if k["device_ms"] else "not measured")
            print(f"  {what} at the {state} state: device "
                  f"{_fmt(k['device_ms'])} ms (torch.profiler), wrapper "
                  f"{k['wrapper_ms']:.4f} ms, bound {bound:.4f} ms by {by} "
                  f"({share}), {k['rows']} rows", flush=True)
        st = r["stages"]
        split = st.get("device_split", {})
        print(f"  phase 4, ms/frame: "
              + ", ".join(f"{s} {st[s]:.3f}" for s in _STAGES)
              + f"; device {st['device_ms']:.3f} ms and "
              f"{st['device_ops']:.0f} ops per frame"
              + "".join(f"; {s} {split[s][0]:.3f} ms and {split[s][1]:.1f} "
                        f"ops" for s in _STAGES if s in split), flush=True)
        if "scan_fps" in r:
            print(f"  large scan, streamed, frames/s: out "
                  f"{r['scan_fps']['out']:.3f}, back "
                  f"{r['scan_fps']['back']:.3f}", flush=True)
    for stage in _STAGES:
        med = {s: statistics.median(r["stages"][stage] for r in runs[s])
               for s in runs}
        print(f"phase 4 {stage} stage, ms/frame: A median {med['A']:.3f}, "
              f"B median {med['B']:.3f}")
    for key, (what, state) in _STATES.items():
        for field in ("device_ms", "wrapper_ms"):
            med = {s: _median([r[key][field] for r in runs[s]
                               if r.get(key) is not None])
                   for s in runs}
            ratio = (f" (B/A {med['B'] / med['A']:.3f})"
                     if med["A"] and med["B"] else "")
            print(f"{what} at the {state} state, {field}: "
                  f"A median {_fmt(med['A'])}, B median {_fmt(med['B'])}"
                  f"{ratio}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dir_a")
    ap.add_argument("dir_b")
    ap.add_argument("--pairs", type=int, default=10,
                    help="phase 1 pairs (0 runs the kernel report alone)")
    args = ap.parse_args(argv)
    dirs = {"A": args.dir_a, "B": args.dir_b}
    if args.pairs > 0:
        phase1_pairs(dirs, args.pairs)
    kernel_report(dirs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
