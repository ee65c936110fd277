"""Phase 1 of ``chip_smoke.py`` (fused frames/s of the 20-frame step at the
reference's default map capacity) in two checkouts, each run in a fresh
process, alternating which side goes first: pair k runs A then B when k
is even, B then A when it is odd.

    python -m voxelhashing_tpu_torch.ab_step DIR_A DIR_B [--pairs 10]

Needs one CUDA card. Each process builds its checkout's kernels (cached in
that checkout's ``build/``) and runs phase 1 twice; the first run warms
the caches and the second is the one compared. Prints every pair, each
side's median and quartiles, and how many pairs B won.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

_CHILD = ("import json, torch, chip_smoke as c\n"
          "cfg, g = c._config(), c._smi()\n"
          "d = torch.device('cuda', 0)\n"
          "fps = [c.phase_step(cfg, d, g)[-1] for _ in range(2)]\n"
          "print('AB_FPS', json.dumps(fps))\n")


def _phase1_fps(path: str) -> float:
    res = subprocess.run([sys.executable, "-c", _CHILD], cwd=path,
                         capture_output=True, text=True, check=False)
    if res.returncode != 0:
        sys.stderr.write(res.stdout[-4000:] + res.stderr[-4000:])
        raise RuntimeError(f"phase 1 failed in {path} ({res.returncode})")
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("AB_FPS")]
    return json.loads(line[-1].split(" ", 1)[1])[-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dir_a")
    ap.add_argument("dir_b")
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args(argv)
    fps = {"A": [], "B": []}
    for k in range(args.pairs):
        order = ("A", "B") if k % 2 == 0 else ("B", "A")
        for side in order:
            fps[side].append(_phase1_fps(args.dir_a if side == "A"
                                         else args.dir_b))
        print(f"pair {k}: {order[0]} first; A {fps['A'][-1]:.4f} "
              f"B {fps['B'][-1]:.4f} fused frames/s", flush=True)
    for side in ("A", "B"):
        q1, _, q3 = statistics.quantiles(fps[side], n=4)
        print(f"{side}: median {statistics.median(fps[side]):.4f}, "
              f"quartiles {q1:.4f}-{q3:.4f}, runs "
              f"{' '.join(f'{x:.4f}' for x in fps[side])}")
    wins = sum(b > a for a, b in zip(fps["A"], fps["B"]))
    ties = sum(b == a for a, b in zip(fps["A"], fps["B"]))
    print(f"B won {wins} of {args.pairs} pairs ({ties} ties)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
