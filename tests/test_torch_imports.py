"""The PyTorch port stands alone: no module of it (nor chip_smoke.py, nor
the port's scripts/torch_*.py) imports JAX, Flax or the JAX package, and
its entry points refuse to run on the CPU unless asked to."""

import ast
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "codemix_dense_retrieval_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "codemix_dense_retrieval_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import codemix_dense_retrieval_torch as P\n"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(json.dumps({'modules': names, 'bad': bad}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(res["modules"]) >= 32
    for name in ("models.packing", "ops.weight_quant", "models.checkpoint", "utils.autotune",
                 "utils.profiling", "utils.timing", "utils.seeding", "version", "io.naming",
                 "analysis.embedding_space", "analysis.plots", "orchestrate.scheduler", "datagen.bands",
                 "parallel.mesh", "parallel.tp", "parallel.multihost"):
        assert f"codemix_dense_retrieval_torch.{name}" in res["modules"]
    assert res["bad"] == []


def _sources():
    files = sorted(PORT.rglob("*.py")) + sorted((REPO / "scripts").glob("torch_*.py"))
    smoke = REPO / "chip_smoke.py"
    if smoke.exists():
        files.append(smoke)
    return files


def test_sources_cover_the_multi_device_modules():
    names = {str(p.relative_to(PORT)) for p in _sources() if PORT in p.parents}
    assert {"parallel/mesh.py", "parallel/tp.py", "parallel/multihost.py", "parallel/sharded_search.py"} <= names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), f"{path}:{node.lineno} imports {names}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny_cfg():
    from codemix_dense_retrieval_torch.models.xlmr import XLMRConfig

    return XLMRConfig.tiny(vocab_size=50, hidden_size=16, num_heads=2, intermediate_size=32)


def _entry_text_encoder():
    from codemix_dense_retrieval_torch.models.encoder import TextEncoder

    TextEncoder("BAAI/bge-m3", _tiny_cfg())


def _entry_load_encoder():
    from codemix_dense_retrieval_torch.models.registry import load_encoder

    load_encoder("BAAI/bge-m3")


def _entry_index_to_device():
    from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex

    DenseFlatIndex.build(np.ones((4, 8), np.float32), list("abcd")).to_device()


def _entry_index_search():
    from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex

    DenseFlatIndex.build(np.ones((4, 8), np.float32), list("abcd")).search(np.ones((1, 8)), 2)


def _entry_index_adaptive_search():
    from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex

    DenseFlatIndex.build(np.ones((4, 8), np.float32), list("abcd")).search(np.ones((1, 8)), 2, approx="adaptive")


def _entry_index_reorder_rows():
    from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex

    DenseFlatIndex.build(np.ones((4, 8), np.float32), list("abcd")).reorder_rows()


def _entry_index_add():
    from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex

    DenseFlatIndex.build(np.ones((4, 8), np.float32), list("abcd")).add(np.ones((1, 8), np.float32), ["e"])


def _entry_runner(tmp_path):
    from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex
    from codemix_dense_retrieval_torch.pipeline.runs import run_vector_mix_search

    idx = DenseFlatIndex.build(np.ones((4, 8), np.float32), list("abcd"))
    v = np.ones((2, 8), np.float32)
    run_vector_mix_search(idx, ["q1", "q2"], v, v, [0.5], tmp_path, k=2)


def _entry_cli(tmp_path):
    from codemix_dense_retrieval_torch.cli import main
    from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex
    from codemix_dense_retrieval_torch.io.tsv import write_queries_tsv

    DenseFlatIndex.build(np.ones((4, 16), np.float32), list("abcd")).save(tmp_path / "ix")
    write_queries_tsv(tmp_path / "a.tsv", [("q1", "hello")])
    main([
        "run-mix", "--index", str(tmp_path / "ix"), "--smoke_dim", "16",
        "--query_tsv", f"en={tmp_path / 'a.tsv'}", f"zh={tmp_path / 'a.tsv'}",
        "--outdir", str(tmp_path / "runs"),
    ])


def _entry_serve_cli(tmp_path):
    from codemix_dense_retrieval_torch.cli import main
    from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex

    DenseFlatIndex.build(np.ones((4, 16), np.float32), list("abcd")).save(tmp_path / "ix")
    main(["serve", "--index", str(tmp_path / "ix"), "--smoke_dim", "16", "--port", "0"])


def _entry_encode_corpus_cli(tmp_path):
    from codemix_dense_retrieval_torch.cli import main

    (tmp_path / "c.tsv").write_text("d1\tsome passage\n")
    main(["encode-corpus", "--corpus_tsv", f"xx={tmp_path / 'c.tsv'}", "--storage_dtype", "int8",
          "--out", str(tmp_path / "ix"), "--smoke_dim", "16"])


def _entry_encode_corpus_pack_cli(tmp_path):
    from codemix_dense_retrieval_torch.cli import main

    (tmp_path / "c.tsv").write_text("d1\tsome passage\n")
    main(["encode-corpus", "--corpus_tsv", f"xx={tmp_path / 'c.tsv'}", "--pack",
          "--out", str(tmp_path / "ix"), "--smoke_dim", "16"])


def _entry_quantized_text_encoder():
    from codemix_dense_retrieval_torch.models.encoder import TextEncoder

    TextEncoder("BAAI/bge-m3", _tiny_cfg(), weight_quant="int8")


def _entry_cache_queries_cli(tmp_path):
    from codemix_dense_retrieval_torch.cli import main
    from codemix_dense_retrieval_torch.io.tsv import write_queries_tsv

    write_queries_tsv(tmp_path / "a.tsv", [("q1", "hello")])
    main(["cache-queries", "--query_tsv", f"en={tmp_path / 'a.tsv'}", "--cache_root", str(tmp_path / "c"),
          "--smoke_dim", "16", "--weight_quant", "nf4"])


def _entry_profile_cli():
    from codemix_dense_retrieval_torch.cli import main

    main(["profile", "--docs", "64", "--dim", "8", "--queries", "2", "--k", "2"])


def _entry_tune_cli():
    from codemix_dense_retrieval_torch.cli import main

    main(["tune", "--dry_run", "--rows", "2048", "--dim", "8", "--batch", "2", "--ks", "4"])


def _entry_analyze_cli(tmp_path):
    from codemix_dense_retrieval_torch.cli import main
    from codemix_dense_retrieval_torch.io.tsv import write_queries_tsv

    for lang in ("en", "zh", "cm"):
        write_queries_tsv(tmp_path / f"{lang}.tsv", [("q1", f"{lang} text"), ("q2", "more")])
    main(["analyze", "--query_tsv", *(f"{lang}={tmp_path / (lang + '.tsv')}" for lang in ("en", "zh", "cm")),
          "--outdir", str(tmp_path / "out"), "--smoke_dim", "16"])


def _entry_make_mesh():
    from codemix_dense_retrieval_torch.parallel.mesh import make_mesh

    make_mesh()


def _entry_hubness_stats():
    from codemix_dense_retrieval_torch.analysis.embedding_space import hubness_stats

    hubness_stats(np.eye(8, dtype=np.float32), k=2)


@pytest.mark.parametrize("entry", [
    _entry_text_encoder, _entry_load_encoder, _entry_index_to_device,
    _entry_index_search, _entry_index_adaptive_search, _entry_index_reorder_rows, _entry_index_add,
    _entry_runner, _entry_cli, _entry_serve_cli, _entry_encode_corpus_cli, _entry_encode_corpus_pack_cli,
    _entry_quantized_text_encoder, _entry_cache_queries_cli, _entry_profile_cli, _entry_tune_cli,
    _entry_analyze_cli, _entry_hubness_stats, _entry_make_mesh,
], ids=lambda f: f.__name__.removeprefix("_entry_"))
def test_entry_points_raise_without_cuda(entry, no_cuda, tmp_path):
    args = (tmp_path,) if entry.__code__.co_argcount else ()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry(*args)


def test_cpu_is_taken_only_when_named(no_cuda):
    from codemix_dense_retrieval_torch.models.encoder import TextEncoder

    enc = TextEncoder("BAAI/bge-m3", _tiny_cfg(), device="cpu")
    assert next(enc.model.parameters()).device.type == "cpu"
    out = enc.encode_queries(["a b c", "d"])
    assert out.shape == (2, 16) and np.isfinite(out).all()


def test_serve_cli_on_the_cpu_answers_healthz(tmp_path):
    """``serve --device cpu`` in a process of its own: it prints its
    ``serving`` line, ``GET /healthz`` answers 200, and it ends on SIGINT."""
    import http.client
    import queue
    import signal
    import threading
    import urllib.parse

    from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex

    rows = np.random.default_rng(0).standard_normal((64, 16)).astype(np.float32)
    DenseFlatIndex.build(rows, [f"d{i}" for i in range(64)]).save(tmp_path / "ix")
    proc = subprocess.Popen(
        [sys.executable, "-m", "codemix_dense_retrieval_torch", "serve", "--device", "cpu", "--port", "0",
         "--smoke_dim", "16", "--index", str(tmp_path / "ix"), "--verbosity", "0"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
    try:
        info = None
        deadline = time.monotonic() + 120
        while info is None and time.monotonic() < deadline and proc.poll() is None:
            try:
                line = lines.get(timeout=1)
            except queue.Empty:
                continue
            if line.startswith("{") and "serving" in line:
                info = json.loads(line)
        assert info is not None, proc.stderr.read() if proc.poll() is not None else "no serving line in 120 s"
        assert info["docs"] == 64
        url = urllib.parse.urlparse(info["serving"])
        conn = http.client.HTTPConnection(url.hostname, url.port, timeout=30)
        try:
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            body = json.loads(resp.read())
        finally:
            conn.close()
        assert resp.status == 200 and body["ok"] and body["docs"] == 64
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
