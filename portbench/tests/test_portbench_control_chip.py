"""On the card: the control (the reference in float32 with TF32 on, in
the program's place) comes out not correct, and the program itself
correct, at each relocalization cell's own size on three seeds.

    python -m pytest portbench/tests/test_portbench_control_chip.py -m chip

About two minutes a cell on an H100; skips without a card.
"""
import json

import pytest

from portbench.bench import harness, readings

SEEDS = (2000001, 2000002, 2000003)


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["vnattn_r5.relocalize", "vecdgcnn.relocalize"])
def test_the_control_fails_and_the_program_passes(card, cell):
    limits = json.loads((harness.BENCH / "limits" / f"{cell}.json").read_text())
    rows = readings.readings(cell, SEEDS, control=True)
    for row in rows:
        ok = all(row[k] <= v for k, v in limits.items())
        assert ok is (row["side"] == "program"), row
