"""The counting functions against hand counts at tiny shapes."""
import json

import pytest

from portbench.bench import harness
from portbench.counts import encoder as E
from portbench.counts import peaks


def test_fps_and_knn():
    assert E.fps(1, 5, 3) == 2 * 5 * 9  # two rounds over five points
    assert E.knn(2, 3, 4, 3) == 2 * 3 * 4 * (2 * 3 + 2)


def test_lna():
    # W 3 -> 4 (6 c o), D 4 x 4 (6 o o), the activation (29 o), two points
    assert E.lna(2, 3, 4) == 2 * (72 + 96 + 116)
    assert E.lna(2, 3, 4, shared=True) == 2 * (72 + 24 + 116)


def test_edge_layers():
    # B 1, two source and two destination points, C 1, O 2, K 2: 4 edges;
    # per point the cheaper of W then D (36) and [W | D W] (24, plus 8 once)
    assert E.edge_layer("mean", 1, 2, 2, 1, 2, 2) == 2 * 56 + 4 * 2 * 32
    assert E.edge_layer("attention", 1, 2, 2, 1, 2, 2) == 2 * 2 * 56 + 4 * 2 * 80
    assert E.edge_layer("layer0", 1, 2, 2, 1, 2, 2) == 24 + 4 * (24 + 2 * 56)


def test_least_seconds():
    assert peaks.least_seconds(67e12, 0.0) == pytest.approx(1.0)
    assert peaks.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)
    assert peaks.least_seconds(67e12, 2 * 3.35e12) == pytest.approx(2.0)


@pytest.mark.parametrize("name", ["vnattn_r5", "vecdgcnn"])
def test_encode_stage_grows_with_the_clouds(name):
    cfg = json.loads((harness.BENCH / "configs" / f"{name}.json").read_text())
    f1, b1 = E.encode_stage(cfg, 1, 4096, 0.0)
    f2, b2 = E.encode_stage(cfg, 2, 4096, 0.0)
    assert f1 > 0 and b1 > 0
    # linear but for the products formed once a call (D W of each layer)
    assert f1 < f2 <= 2 * f1 and f2 == pytest.approx(2 * f1, rel=0.05)
    assert b2 == pytest.approx(2 * b1)
