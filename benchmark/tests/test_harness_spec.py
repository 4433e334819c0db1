"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found by name."""

from __future__ import annotations

import json
import re

import pytest

from conftest import BENCH, CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= len(spec["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in spec["paths"])
    assert not any(p.endswith("_torch") for p in spec["paths"])
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    assert 1200 + (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 2 * 90 <= 43200


def test_names_and_units_use_allowed_characters(spec):
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for e in spec[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in spec["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in spec["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_entries_have_just_the_contract_keys(spec):
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"])
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and one_line(m["layer"])
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in spec["end_to_end"])


def test_every_cell_finds_its_files_by_name(spec):
    from harness import core

    assert CELLS == tuple(w["name"] for w in spec["workloads"])
    configs = {c["name"] for c in spec["configs"]}
    assert configs == {w["config"] for w in spec["workloads"]}
    for w in spec["workloads"]:
        cell = core.load_cell(w["name"], ROOT)
        assert (BENCH / "drivers" / f"{cell.traffic['driver']}.py").is_file()
        assert (BENCH / "families" / f"{cell.config['family']}.py").is_file()
        for fn in ("setup", "window", "check"):
            assert callable(getattr(cell.driver, fn))
        # what the tests and tools take from the driver and the family
        assert isinstance(cell.driver.TINY, dict) and cell.driver.FAULTS
        assert callable(core.family_of(cell.config).tiny)
        assert cell.limits and all(v >= 0 for v in cell.limits.values())
        for name in cell.per_layer:
            assert cell.metrics[name].LAYER == next(m["layer"] for m in spec["per_layer"] if m["name"] == name)


def test_each_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_metric(spec):
    for w in spec["workloads"]:
        e2e = [m["name"] for m in spec["end_to_end"] if "workloads" not in m or w["name"] in m["workloads"]]
        per = [m["name"] for m in spec["per_layer"] if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in e2e and len(e2e) >= 2 and per, w["name"]


def test_per_layer_metrics_move_an_end_to_end_metric_their_cells_report(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", [w["name"] for w in spec["workloads"]]):
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)
    layers = {m["layer"] for m in spec["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"**{layer}**" in perf, f"PERF.md's list of layers lacks {layer!r}"


def test_roofline_and_mfu_names(spec):
    for m in spec["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"
    assert any("mfu" in m["name"] and m["moves"] == "sweep_qps" for m in spec["per_layer"])


def test_files_under_the_benchmark_are_named_from_name_characters():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts or ".pytest_cache" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
