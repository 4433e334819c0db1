"""Every cell through the one command on the card, with a short window
(skips without a card; ``pytest benchmark/tests -m chip`` on the card)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import CELLS, ROOT


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_a_cell_runs_on_the_card_and_is_correct(name, card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed", str(2**31 + 11),
                          "--seconds", "5", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
