"""The result line's keys, and the check for JAX in the process."""

import sys
import types

import pytest

from benchmark import harness, trace


def fake_run(trace_on):
    spec = harness.spec_of()
    cell = spec["workloads"][0]
    run = harness.Run(cell, {}, {}, {"limits": {"a": 1.0, "b": 0.0},
                                     "not_compared": {"c": "no upper"}},
                      0, 1.0, trace_on, 0.0, "cpu")
    for m in spec["end_to_end"]:
        run.e2e[m["name"]] = 1.5
    run.check("a", 0.5)
    run.check("b", 0.0)
    if trace_on:
        run.probe = trace.Probe([("k_brick_conv3", 0.0, 5.0),
                                 ("other", 10.0, 5.0)],
                                [("aten::item", 4.0, 7.0)], 0.0, 20.0, [0])
        run.work.update(window_flops=1e9, window_s=1.0, k1_flops=1e8,
                        k1_bytes=1e6, dtype="float32")
    return spec, run


def test_untraced_line_has_the_end_to_end_metrics():
    spec, run = fake_run(False)
    out = harness.result_of(spec, run, 1)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True
    names = {m["name"] for m in spec["end_to_end"]
             if harness.applies(m, run.cell["name"])}
    assert set(out["metrics"]) == names
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["checks"]["a"] == {"value": 0.5, "limit": 1.0}


def test_traced_line_has_layer_metrics_and_breakdown():
    spec, run = fake_run(True)
    out = harness.result_of(spec, run, 1)
    assert list(out)[-1] == "checks"
    assert out["device"]["busy_s"] == 10e-6
    assert out["device"]["window_s"] == 20e-6
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["breakdown"]["idle_gaps"][0][0] == "aten::item"
    for m in spec["per_layer"]:
        if harness.applies(m, run.cell["name"]):
            assert 0 < out["metrics"][m["name"]]["value"] <= 100


def test_a_check_past_its_limit_is_not_correct():
    _, run = fake_run(False)
    run.check("b", 1e-9)
    assert not run.correct()


def test_a_number_without_a_limit_is_an_error():
    _, run = fake_run(False)
    run.compare({"a": 0.25, "c": 3.0})
    assert run.readings == {"c": 3.0} and run.checks[-1] == ("a", 0.25, 1.0)
    with pytest.raises(KeyError, match="d"):
        run.compare({"d": 0.0})


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "dropclip_tpu_torch_like",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlibrary", types.ModuleType("x"))
    assert "jaxlib" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "dropclip_tpu.sparse",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert {"dropclip_tpu", "jax"} <= set(harness.forbidden_modules())
