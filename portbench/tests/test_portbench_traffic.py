"""The traffic generator repeats bit for bit from a seed."""
import json

import pytest
import torch

from portbench.bench import harness, scenes

MIX = dict(json.loads((harness.BENCH / "traffic" / "relocalize.json").read_text()),
           scene_pairs=2, objects=3, points=256, min_points=64)


def draw(seed):
    gen = torch.Generator().manual_seed(seed)
    return scenes.scene_pairs(gen, MIX, torch.device("cpu"))


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7, 3 * 2 ** 32 + 1])
def test_same_seed_same_scenes(seed):
    a, b = draw(seed), draw(seed)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_other_seed_other_scenes():
    assert not torch.equal(draw(1)[0], draw(2)[0])


def test_shapes_masks_and_motion():
    ref, res, ref_mask, res_mask = draw(5)
    assert ref.shape == res.shape == (2, 3, 256, 3) and ref.dtype == torch.float32
    for m in (ref_mask, res_mask):
        counts = m.sum(-1)
        assert (counts >= 64).all() and (counts <= 256).all()
        # the valid points lead, the padding repeats the first point
        assert torch.equal(m, torch.arange(256) < counts[..., None])
    pad = ~ref_mask
    assert torch.equal(ref[pad], ref[..., :1, :].expand_as(ref)[pad])
    # a rescan object is a rigid motion of a resample of the same shape:
    # its spread about its centre matches its ref object's (noise and
    # resampling aside); the permutation keeps every scene's set
    def spread(x, m):
        c = (x * m[..., None]).sum(-2) / m.sum(-1, keepdim=True)
        return (((x - c[..., None, :]) ** 2).sum(-1) * m).sum(-1) / m.sum(-1)
    a = torch.sort(spread(ref, ref_mask), dim=-1).values
    b = torch.sort(spread(res, res_mask), dim=-1).values
    assert torch.allclose(a, b, rtol=0.2)


def test_points_lie_on_the_surface():
    gen = torch.Generator().manual_seed(3)
    shape = scenes._draw_shapes(gen, 4, [0, 1, 2], torch.device("cpu"))
    pts = scenes.surface_points(gen, shape, 128)
    assert scenes.sdf(pts, shape).abs().max() < 2e-2
