"""The readers of the program's spans and counters against a hand-made
snapshot, and their silence where the program has no recorder."""
import sys
from types import SimpleNamespace

import pytest

from portbench.bench import harness


def span(name, call, host, device):
    return {"name": name, "parent": None, "call": call, "host_start_ms": host[0],
            "host_end_ms": host[1], "device_start_ms": device[0], "device_end_ms": device[1]}


# two calls: encode on the card 10-40 and 200-250; the matcher entered at 41
# and 251 (host), registration ending on the card at 120 and 330
SNAPSHOT = {
    "spans": [
        span("pipeline.call", 0, (0, 130), (1, 121)),
        span("pipeline.encode", 0, (1, 20), (10, 40)),
        span("solver.match", 0, (41, 45), (41, 44)),
        span("solver.register", 0, (45, 100), (44, 120)),
        span("pipeline.call", 1, (190, 340), (191, 331)),
        span("pipeline.encode", 1, (191, 215), (200, 250)),
        span("solver.match", 1, (251, 253), (251, 252)),
        span("solver.register", 1, (253, 300), (252, 330)),
    ],
    "counters": {"icp.iterations": 200, "icp.pair_iterations": 200 * 256, "icp.calls": 2,
                 "icp.active_pair_iterations": 12800, "icp.iters_needed": 150},
}
EXPECTED = {
    "encode_wall_ms.relocalize": (30 + 50) / 2,
    "register_wall_ms.relocalize": ((120 - 41) + (330 - 251)) / 2,
    "register_host_ms.relocalize": (4 + 55 + 2 + 47) / 2,
    "icp_active_share.relocalize": 25.0,
    "icp_iters_needed.relocalize": 75.0,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_from_a_hand_made_snapshot(name, monkeypatch):
    from livingscenes_tpu_torch import tracing

    monkeypatch.setattr(tracing, "snapshot", lambda: SNAPSHOT)
    assert harness.read_metric(name, SimpleNamespace(calls=2)) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_is_silent_without_a_recorder(name, monkeypatch):
    import livingscenes_tpu_torch

    monkeypatch.delattr(livingscenes_tpu_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "livingscenes_tpu_torch.tracing", None)
    with pytest.raises(ImportError):
        from livingscenes_tpu_torch import tracing  # noqa: F401
    assert harness.read_metric(name, SimpleNamespace(calls=2)) is None
