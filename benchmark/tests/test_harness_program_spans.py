"""The per-layer metrics read from the port's own spans and counters
(``codemix_dense_retrieval_torch.utils.timing``), each cell traced at a CPU
test's size: every such metric of a cell gives a number in its cells (the
device-timed ``search.tail_share.sweep`` none off the card), and none from
an untraced run, in which the port records nothing."""

from __future__ import annotations

import pathlib

import pytest

from conftest import CELLS, run_tiny, tiny_cell

READS_SPANS = "from codemix_dense_retrieval_torch.utils import timing"
DEVICE_TIMED = {"search.tail_share.sweep"}


def _span_metrics(cell):
    """The cell's metrics whose reader reads the port's span registry."""
    return [m for m in cell.per_layer
            if READS_SPANS in pathlib.Path(cell.metrics[m].__file__).read_text()]


@pytest.fixture
def timing():
    from codemix_dense_retrieval_torch.utils import timing

    timing.reset()
    yield timing
    timing.reset()


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reads_the_ports_spans(name, tmp_path, timing):
    cell = tiny_cell(name)
    names = _span_metrics(cell)
    assert names, name
    res = run_tiny(cell, tmp_path, trace=True)
    assert res["correct"], res["check"]
    for m in names:
        if m in DEVICE_TIMED:
            assert m not in res["metrics"], m          # no card: no device seconds
        else:
            assert 0.0 < res["metrics"][m]["value"] <= 100.0, (m, res["metrics"].get(m))
    assert timing.records()


@pytest.mark.parametrize("name", CELLS)
def test_an_untraced_run_leaves_nothing_to_read(name, tmp_path, timing):
    from harness import core

    cell = tiny_cell(name)
    res = run_tiny(cell, tmp_path)
    assert res["correct"], res["check"]
    assert timing.totals() == {"spans": {}, "counters": {}}
    untraced = core.Readings(window_s=1.0, trace=None, counters={}, config=cell.config)
    # a trace summary, to show the readers find no spans, not only no trace
    traced = core.Readings(window_s=1.0, trace=object(), counters={}, config=cell.config)
    for m in _span_metrics(cell):
        assert cell.metrics[m].read(untraced) is None and cell.metrics[m].read(traced) is None, m
