"""What the benchmark loads: nothing whose top-level name is ``jax``,
``jaxlib``, ``flax`` or the JAX package (names compared whole: the port's
name begins with the JAX package's), and a reference that loads nothing of
the port."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "codemix_dense_retrieval_tpu"}
PORT = "codemix_dense_retrieval_torch"


def _loaded_after(code: str) -> set:
    """Top-level names in ``sys.modules`` after ``code`` runs in a fresh
    interpreter with the benchmark and the repo on its path."""
    prog = (f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_of_every_cell_loads_no_jax():
    code = (
        "import pathlib, tempfile\n"
        "sys.path.insert(0, " + repr(str(BENCH / "tests")) + ")\n"
        "from conftest import CELLS, tiny_cell, run_tiny\n"
        "for name in CELLS:\n"
        "    assert run_tiny(tiny_cell(name), pathlib.Path(tempfile.mkdtemp()))['correct']\n"
        "from harness import core\n"
        "assert core.forbidden_loaded() == []\n"
    )
    loaded = _loaded_after(code)
    assert PORT in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded_after("import reference, reference.xlmr, reference.qwen3, reference.search, "
                           "reference.tokenizer")
    assert PORT not in loaded and not loaded & FORBIDDEN


def test_no_benchmark_source_imports_jax_and_the_reference_sources_no_port():
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names.add(node.module.split(".")[0])
        assert not names & FORBIDDEN, (path, names & FORBIDDEN)
        if path.parent.name == "reference":
            assert PORT not in names and "harness" not in names, path


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    from harness import core

    monkeypatch.setitem(sys.modules, "codemix_dense_retrieval_tpu_lookalike", sys)
    assert "codemix_dense_retrieval_tpu" not in core.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in core.forbidden_loaded()
