"""The reference is the program's plain path: on the CPU, where the
program runs its plain versions, the reference's frames equal the
program's eager step's bit for bit, in the pose and in every map field."""

import json

import pytest
import torch

from conftest import REPO, tiny_groups
from vhbench import harness
from vhbench.reference import config as rconfig, engine as reng
from vhbench.traffic import generator


@pytest.mark.parametrize("config,frames", [("vh_4mm_icp_splat", 6),
                                           ("vh_4mm_rgbd_march", 3)])
def test_reference_equals_the_programs_plain_step(config, frames):
    from voxelhashing_tpu_torch import engine
    torch.set_num_threads(4)
    groups = tiny_groups(json.loads(
        (REPO / f"vhbench/configs/{config}.json").read_text())["engine"])
    cfg, rcfg = harness.program_config(groups), rconfig.from_dict(groups)
    mix = generator.load_mix("room_orbit")
    mix["path"]["frames"] = 40
    lap = generator.make_lap(mix, cfg.camera, 12345, torch.device("cpu"))
    prog = engine.create(cfg, device="cpu")
    ref = reng.create(rcfg, "cpu")
    last = torch.eye(4)
    for i in range(frames):
        d, c = torch.from_numpy(lap.depth[i]), torch.from_numpy(lap.color[i])
        prog, diag = engine.step(prog, d, c, cfg)
        out = reng.step(ref, last, d, c, rcfg, i, pose=prog.pose,
                        integrate=bool(diag.tracking_valid))
        ref, last = out.map, prog.pose.clone()
        assert bool(diag.tracking_valid)
        assert out.valid
        assert torch.equal(out.pose, prog.pose)
        for name, a, b in zip(prog.map._fields, prog.map, ref):
            assert torch.equal(a, b), (i, name)
