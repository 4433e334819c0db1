"""Every cell end to end at a CPU test's size through the harness's run
loop: a sound run comes out correct, the control (the port's path in the
precision below the configuration's) and each fault the cell can have,
planted in the port underneath the timed path, come out not correct.

Each driver names the faults a run of it can have (``FAULTS``): a step
that returns its state unchanged, half of the batch left out, an answer or
a token altered where it is produced. One card runs each cell, so no
exchange between chips can be left out.
"""

from __future__ import annotations

import pytest
import torch

from conftest import CELLS, control_cell, run_tiny, tiny_cell


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name, tmp_path):
    res = run_tiny(tiny_cell(name), tmp_path)
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "check"


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reports_its_per_layer_metrics(name, tmp_path):
    cell = tiny_cell(name)
    res = run_tiny(cell, tmp_path, trace=True)
    assert res["correct"]
    assert set(res["metrics"]) <= set(cell.per_layer) and res["metrics"]
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def _faults():
    from harness import core

    return [(n, f) for n in CELLS for f in core.load_cell(n).driver.FAULTS]


@pytest.mark.parametrize("name,fault", _faults())
def test_each_fault_makes_the_run_not_correct(name, fault, tmp_path, monkeypatch):
    pytest.importorskip("tokenizers")
    cell = tiny_cell(name)
    target, attr, broken = cell.driver.FAULTS[fault](cell)
    monkeypatch.setattr(target, attr, broken)
    res = run_tiny(cell, tmp_path)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name, tmp_path):
    """The control at a test's size: the search cells' int8 store, the
    encoders' int8 weights (at the width where the port quantizes)."""
    res = run_tiny(control_cell(name), tmp_path, variant="control")
    assert not res["correct"], res["check"]
