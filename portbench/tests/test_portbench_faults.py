"""A run with the timed path broken underneath comes out not correct.

The harness's look for a card is skipped: `harness.execute` drives the
rest of a run of each relocalization cell (set-up, the window, the
comparison with the reference and its limits) on the CPU at a tiny size,
with each fault of bench/faults.py planted in the program for the
window's calls. vecdgcnn.relocalize compares no matching (its seeded
weights leave near-ties in the matching at float32; PERF.md), so its
"match" fault is left to vnattn_r5.relocalize, which runs the same
matcher.
"""
import contextlib
import json
import time
from types import SimpleNamespace

import pytest
import torch

from portbench.bench import faults, harness

TINY = {"scene_pairs": 2, "objects": 3, "points": 1200, "min_points": 1050, "pool": 1,
        "warmup_calls": 0, "check_calls": 1, "reference_block": 8}


CASES = ([("vnattn_r5.relocalize", f) for f in (None, *faults.FAULTS)]
         + [("vecdgcnn.relocalize", f) for f in (None, "answer", "unchanged", "half")])


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_run_is_not_correct(cell, fault):
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    parts = harness.cell_parts(manifest, cell)
    parts["traffic"] = dict(parts["traffic"], **TINY)
    ctx = SimpleNamespace(root=harness.ROOT, config=parts["config"], traffic=parts["traffic"],
                          seed=77, device=torch.device("cpu"))
    with faults.planted(fault) if fault else contextlib.nullcontext():
        line, numbers = harness.execute(manifest, parts, ctx, 0.0, 0, time.perf_counter())
    assert line["correct"] is (fault is None), (fault, line["checks"])
    assert list(line)[-2:] == ["checks", "setup_s"]
