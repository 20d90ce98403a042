"""Everything BENCHMARK.json names is found by name, and its entries keep
to the contract's forms."""

import json
import os
import re

import pytest

from benchmark import harness

SPEC = harness.spec_of()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        < 64 * 1024


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_found(cfg):
    assert NAME.match(cfg["name"])
    path = os.path.join(harness.ROOT, cfg["file"])
    data = harness.load_json(path)
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    assert data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    for key in cfg["reduced"]:
        assert NAME.match(key)


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_found_by_name(cell):
    assert NAME.match(cell["name"]) and cell["chips"] in (1, 4)
    assert cell["config"] in {c["name"] for c in SPEC["configs"]}
    traffic = harness.load_json(os.path.join(
        harness.HERE, "traffic", f"{cell['traffic']}.json"))
    assert os.path.isfile(os.path.join(harness.HERE, "drivers",
                                       f"{traffic['driver']}.py"))
    found = harness.load_json(os.path.join(
        harness.HERE, "limits", f"{cell['name']}.json"))
    limits = found["limits"]
    assert limits and all(v >= 0 for v in limits.values())
    assert not set(limits) & set(found.get("not_compared", {}))
    ends = [m for m in SPEC["end_to_end"] if harness.applies(m, cell["name"])]
    assert "setup_s" in {m["name"] for m in ends} and len(ends) >= 2
    assert any(harness.applies(m, cell["name"]) for m in SPEC["per_layer"])
    assert len(cell["why"]) <= 200


def test_pairs_and_names_unique():
    pairs = [(c["config"], c["traffic"]) for c in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_forms(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {c["name"] for c in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        ends = {m["name"]: m for m in SPEC["end_to_end"]}
        assert metric["moves"] in ends
        moved = ends[metric["moves"]]
        for cell in metric.get("workloads", cells):
            assert harness.applies(moved, cell)


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_reader_found_and_silent_without_a_trace(metric):
    mod = harness.reader(metric["name"])
    run = harness.Run({"name": "x"}, {}, {}, {"limits": {}}, 0, 1.0, True,
                      0.0, "cpu")
    assert mod.read(run) is None


def test_bounds_json_round_trips():
    assert json.loads(json.dumps(SPEC)) == SPEC
