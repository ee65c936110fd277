"""What the benchmark loads: none of JAX or the JAX package, and a
reference that loads nothing of the program."""

import json
import subprocess
import sys

from conftest import REPO

HARNESS = ["vhbench.harness", "vhbench.check", "vhbench.work",
           "vhbench.traffic.generator", "voxelhashing_tpu_torch.engine",
           "voxelhashing_tpu_torch.streaming",
           "voxelhashing_tpu_torch.native"]
REFERENCE = ["vhbench.reference.engine", "vhbench.reference.streaming",
             "vhbench.check", "vhbench.work", "vhbench.traffic.generator"]


def _loaded(modules):
    """Top-level names of every module loaded after importing
    ``modules`` (and the per-layer readers) in a fresh interpreter."""
    code = (
        "import importlib, json, sys, pathlib\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "from vhbench import harness\n"
        "root = pathlib.Path(harness.__file__).parent\n"
        "for p in sorted((root / 'layer_metrics').glob('*.py')):\n"
        "    if p.stem != '__init__':\n"
        "        harness.find_reader(root.parent, p.stem)\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=REPO)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_loads_jax_or_the_jax_package():
    top = _loaded(HARNESS)
    assert "vhbench" in top and "voxelhashing_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "voxelhashing_tpu"}


def test_reference_loads_nothing_of_the_program():
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"for m in {REFERENCE!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=REPO)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"voxelhashing_tpu_torch", "voxelhashing_tpu", "jax",
                      "jaxlib"}
