"""BENCHMARK.json against the benchmark's contract, and every file it
names."""
import json
import re

import pytest

from portbench.bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")

MANIFEST = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def test_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MANIFEST["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in MANIFEST["paths"])
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert all(LINE.match(w) for w in MANIFEST["command"])
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert 1 <= len(MANIFEST["configs"]) <= 24 and 1 <= len(MANIFEST["workloads"]) <= 24
    assert 1 <= len(MANIFEST["end_to_end"]) <= 16 and 1 <= len(MANIFEST["per_layer"]) <= 128


def test_entries_have_just_their_keys():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_lines(kind):
    entries = MANIFEST[kind]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "source", "layer"):
            if key in e:
                assert LINE.match(e[key]), (e["name"], key)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        assert all(NAME.match(k) for k in e.get("reduced", []))


def test_every_moves_is_reported_by_each_of_its_cells():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", [w])


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in MANIFEST["workloads"]:
        names = [m["name"] for m in harness.end_to_end(MANIFEST, w["name"])]
        assert "setup_s" in names and len(names) >= 2
        assert harness.per_layer(MANIFEST, w["name"])


def test_one_layer_name_per_layer():
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    assert all(LINE.match(x) for x in layers)


def test_files_found_by_name():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == set(configs)
    assert len({c["file"] for c in configs.values()}) == len(configs)
    for c in configs.values():
        assert c["file"].startswith(tuple(p + "/" for p in MANIFEST["paths"]))
        json.loads((harness.ROOT / c["file"]).read_text())
    for w in MANIFEST["workloads"]:
        parts = harness.cell_parts(MANIFEST, w["name"])
        assert (harness.BENCH / "bench" / f"{parts['traffic']['driver']}.py").is_file()
        assert parts["limits"]
    for m in MANIFEST["per_layer"]:
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").is_file()
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)
