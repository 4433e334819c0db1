"""Shared set-up of the harness tests: the benchmark's folder and the repo
root on ``sys.path``, the ``chip`` marker, and tiny versions of the cells
that run on the CPU (the port's plain paths, no card)."""

from __future__ import annotations

import copy
import json
import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# the cells of BENCHMARK.json, in its order
CELLS = tuple(w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"])


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one (run on the card)")


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided when the test runs, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run `pytest benchmark/tests -m chip` on the card)")
    return torch.device("cuda", 0)


def tiny_cell(name: str, layers: int = 2, hidden: int = 64):
    """The cell ``name`` with its configuration and traffic cut to a CPU
    test's size: its model family's ``tiny`` (a ``layers``-layer model of
    width ``hidden`` over a 1,000-word vocabulary) in float32, a 20,000-row
    index of that width, and its driver's ``TINY`` traffic. Its limits are
    the committed ones."""
    from harness import core

    cell = core.load_cell(name, ROOT)
    c, t = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    if "family" in c:
        # wide enough a spread that a few narrow layers tell texts apart;
        # float32, the port's dtype off the card
        c["init_std"], c["served_dtype"] = 0.2, "float32"
        core.family_of(c).tiny(c, layers, hidden)
    if "index" in c:
        c["index"].update(rows=20_000, dim=hidden)
    t.update(copy.deepcopy(cell.driver.TINY))
    cell.config, cell.traffic = c, t
    return cell


def control_cell(name: str):
    """``tiny_cell`` at the size its driver's ``TINY_CONTROL`` asks for: the
    control's lower-precision path may need a wider model to engage."""
    from harness import core

    return tiny_cell(name, **getattr(core.load_cell(name, ROOT).driver, "TINY_CONTROL", {}))


def run_tiny(cell, tmp_path, *, seed: int = 2**31 + 77, seconds: float = 1.0, trace: bool = False,
             variant=None):
    """One run of a tiny cell on the CPU, through the harness's run loop."""
    import torch

    from harness import core

    ctx = core.Context(cell=cell.name, config=cell.config, traffic=cell.traffic, seed=seed, seconds=seconds,
                       trace=trace, device=torch.device("cpu"), tmp=tmp_path, limits=cell.limits,
                       variant=variant)
    return core.run_cell(ctx, cell)
