"""The port's program trace (livingscenes_tpu_torch/tracing.py) on the CPU:
off it is a shared no-op; on, a scene-pair pipeline call at the sizes of
test_torch_port_pipeline.py gives the span tree of one call; the ICP
counters equal a direct count of the pairs frozen at each iteration; a
torch profiler turns the recorder on without ranges, and profile_trace
asks for them and writes the spans out."""
import json

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from livingscenes_tpu_torch import tracing
from livingscenes_tpu_torch.models.shape_prior import ShapePrior, ShapePriorConfig
from livingscenes_tpu_torch.ops.icp import iterative_closest_point
from livingscenes_tpu_torch.solver.pipeline import PipelineConfig, build_scene_pair_pipeline
from livingscenes_tpu_torch.solver.registration import RegistrationConfig
from livingscenes_tpu_torch.utils.debugging import profile_trace
from test_torch_port_pipeline import SMALL, make_scenes
from torch_threads import intra_op_share  # noqa: F401 (autouse)

# (name, parent's index) of a call's spans, in the order they are entered
CALL = [("pipeline.call", None), ("pipeline.encode", 0), ("pipeline.fps", 1),
        ("solver.match", 0), ("solver.register", 0), ("register.kabsch", 4)]
SPANS = {
    "plain": CALL + [("register.icp", 4), ("register.accept", 4)],
    "optim": CALL + [("register.refine", 4), ("register.icp", 4), ("register.accept", 4)],
    "recon": CALL + [("register.icp", 4), ("register.accept", 4), ("pipeline.recon", 0)],
}
CONFIGS = {
    "plain": PipelineConfig(encode_fps=True, registration=RegistrationConfig(icp_iterations=10)),
    "optim": PipelineConfig(encode_fps=True, optim=True, registration=RegistrationConfig(
        icp_iterations=3, n_steps=2)),
    "recon": PipelineConfig(encode_fps=True, recon=True, recon_resolution0=4,
                            recon_upsampling_steps=1,
                            registration=RegistrationConfig(icp_iterations=3)),
}


@pytest.fixture(autouse=True)
def clean():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return ShapePrior(ShapePriorConfig(**SMALL), device="cpu")


def test_off_is_a_shared_no_op(model):
    assert not tracing.on()
    assert tracing.span("a") is tracing.span("b", "cpu")
    tracing.count("n", 3)
    assert tracing.icp_frozen_log() is None
    ref, rescan, mask, _ = make_scenes(0)
    build_scene_pair_pipeline(model, CONFIGS["plain"])(ref, rescan, mask, mask)
    snap = tracing.snapshot()
    assert snap["spans"] == []
    assert snap["counters"] == {"icp.calls": 0, "icp.active_pair_iterations": 0,
                                "icp.iters_needed": 0}


@pytest.mark.parametrize("kind", sorted(SPANS))
def test_pipeline_call_span_tree(model, kind):
    ref, rescan, mask, _ = make_scenes(0)
    pipe = build_scene_pair_pipeline(model, CONFIGS[kind])
    with tracing.recording():
        assert tracing.on()
        for _ in range(2):
            pipe(ref, rescan, mask, mask)
    assert not tracing.on()
    spans = tracing.snapshot()["spans"]
    n = len(SPANS[kind])
    assert len(spans) == 2 * n
    for c in range(2):
        call = spans[c * n:(c + 1) * n]
        assert [(s["name"], s["parent"]) for s in call] == [
            (name, None if p is None else c * n + p) for name, p in SPANS[kind]]
        assert {s["call"] for s in call} == {call[0]["call"]}
        for s in call:
            assert s["host_start_ms"] <= s["host_end_ms"]
            assert s["device_start_ms"] is None and s["device_end_ms"] is None
            if s["parent"] is not None:
                p = spans[s["parent"]]
                assert p["host_start_ms"] <= s["host_start_ms"]
                assert s["host_end_ms"] <= p["host_end_ms"]
    assert spans[0]["call"] != spans[n]["call"]
    counters = tracing.snapshot()["counters"]
    iters = CONFIGS[kind].registration.icp_iterations
    assert counters["icp.calls"] == 2 and counters["icp.iterations"] == 2 * iters
    assert counters["icp.pair_iterations"] == 2 * iters * 8


def icp_pairs(masked):
    """8 noisy rigid copies, moved by growing angles, so that the pairs
    freeze at different iterations; with `masked` the last 16 source
    points of every other pair are masked out (the Kabsch path)."""
    rng = np.random.default_rng(3)
    B, N = 8, 64
    tgt = rng.uniform(-0.5, 0.5, (B, N, 3)) * np.array([1.0, 0.6, 0.3])
    angles = np.linspace(0.02, 0.5, B)[:, None] * Rotation.random(
        B, random_state=4).as_rotvec() / np.pi
    R = Rotation.from_rotvec(angles).as_matrix()
    src = np.einsum("bij,bnj->bni", R, tgt) + 0.05 * angles[:, None, :]
    src = src + rng.normal(scale=0.002, size=src.shape)
    args = dict(src=torch.from_numpy(src), tgt=torch.from_numpy(tgt), relative_rmse_thr=1e-3)
    if masked:
        keep = np.ones((B, N), bool)
        keep[::2, -16:] = False
        args["src_mask"] = torch.from_numpy(keep)
    return args


@pytest.mark.parametrize("path", ["fused", "masked", "early_exit"])
def test_icp_counters_equal_a_direct_count(path):
    args = icp_pairs(path == "masked")
    iterations = 40
    early = path == "early_exit"
    with tracing.recording():
        res = iterative_closest_point(max_iterations=iterations, early_exit=early, **args)
    counters = tracing.snapshot()["counters"]
    tracing.reset()
    # the frozen flags each iteration k starts with: a run of k iterations'
    ran = counters["icp.iterations"]
    frozen = torch.stack([iterative_closest_point(max_iterations=k, **args).converged
                          for k in range(ran)])
    active = torch.logical_not(frozen).sum(0)
    assert 1 <= int(active.min()) < int(active.max())  # pairs freeze at other times
    assert bool(res.converged.all())
    assert ran == (int(active.max()) if early else iterations)
    assert counters == {
        "icp.iterations": ran, "icp.pair_iterations": ran * 8, "icp.calls": 1,
        "icp.active_pair_iterations": int(active.sum()),
        "icp.iters_needed": int(active.max())}


def test_snapshot_is_cached_until_new_records():
    with tracing.recording():
        with tracing.span("a"):
            tracing.count("n", 2)
        first = tracing.snapshot()
        assert tracing.snapshot() is first
        tracing.count("n")
    second = tracing.snapshot()
    assert second is not first and second["counters"]["n"] == 3
    tracing.reset()
    assert tracing.snapshot()["spans"] == []


def test_profiler_turns_recording_on_without_ranges(model):
    ref, rescan, mask, _ = make_scenes(0)
    pipe = build_scene_pair_pipeline(model, CONFIGS["plain"])
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        assert tracing.on()
        pipe(ref, rescan, mask, mask)
    assert not tracing.on()
    names = {name for name, _ in SPANS["plain"]}
    assert [s["name"] for s in tracing.snapshot()["spans"]] == [n for n, _ in SPANS["plain"]]
    events = {e.name for e in prof.events()}
    assert events and not names & events


def test_profile_trace_opens_ranges_and_writes_the_spans(model, tmp_path):
    ref, rescan, mask, _ = make_scenes(0)
    pipe = build_scene_pair_pipeline(model, CONFIGS["plain"])
    with profile_trace(str(tmp_path), label="call"):
        pipe(ref, rescan, mask, mask)
    names = [n for n, _ in SPANS["plain"]]
    chrome = json.load(open(tmp_path / "call.json"))
    assert set(names) <= {e.get("name") for e in chrome["traceEvents"]}
    snap = json.load(open(tmp_path / "call.spans.json"))
    assert [s["name"] for s in snap["spans"]] == names
    assert snap["counters"]["icp.calls"] == 1
