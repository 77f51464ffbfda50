"""The frozen reference agrees with the port at a tiny size on the CPU:
the same scenes through the port's pipeline (its plain versions on the
CPU) and through portbench/reference/."""
import json
from types import SimpleNamespace

import pytest
import torch

from portbench.bench import harness
from portbench.bench import relocalize as driver

TINY = {"scene_pairs": 2, "objects": 3, "points": 1200, "min_points": 1050, "pool": 1,
        "warmup_calls": 0, "check_calls": 1, "reference_block": 8}


def tiny_cell(config: str, seed: int):
    parts = {"config": json.loads((harness.BENCH / "configs" / f"{config}.json").read_text()),
             "traffic": dict(json.loads((harness.BENCH / "traffic" / "relocalize.json")
                                        .read_text()), **TINY)}
    ctx = SimpleNamespace(root=harness.ROOT, config=parts["config"], traffic=parts["traffic"],
                          seed=seed, device=torch.device("cpu"))
    return driver.Cell(ctx)


@pytest.mark.parametrize("config", ["vnattn_r5", "vecdgcnn"])
def test_port_and_reference_agree(config):
    cell = tiny_cell(config, 2 ** 31 + 11)
    cell.call(0)
    numbers = cell.check()
    assert numbers["code_gap_p50"] < 1e-4
    assert numbers["match_diff"] == 0 and numbers["match_slack"] == 0
    assert abs(numbers["pose_gap_p50"]) < 1e-5
    limits = json.loads((harness.BENCH / "limits" / f"{config}.relocalize.json").read_text())
    assert all(numbers[k] <= v for k, v in limits.items()), numbers
