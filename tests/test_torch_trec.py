"""io/trec.py and io/_fastio.py: both port writers (the native library built
from csrc/fastio.cpp, and the pure-Python path) against the JAX package's
pure-Python write_run, write_run_entries and collapse_run_max, byte for
byte: scores tied at 6 decimals, first-seen qid order, docids with and
without a language tag."""

import numpy as np
import pytest

from codemix_dense_retrieval_torch.io import _fastio as port_fastio
from codemix_dense_retrieval_torch.io import trec as port
from codemix_dense_retrieval_tpu.io import trec as ref


@pytest.fixture
def ref_python(monkeypatch):
    """The JAX package's writer with its native library switched off."""
    monkeypatch.setattr(ref, "_native", lambda: None)


@pytest.fixture(params=["native", "python"])
def port_path(request, monkeypatch):
    if request.param == "native":
        assert port_fastio.available(), "g++ should build csrc/fastio.cpp here"
    else:
        monkeypatch.setattr(port_fastio, "_lib", lambda: None)
    before = dict(port.WRITES)
    yield request.param
    assert port.WRITES[request.param] > before[request.param]


def _table(seed, nq=7, k=9):
    """Scores with ties at 6 decimals (and below), qids out of sorted order,
    docids with language tags."""
    rng = np.random.default_rng(seed)
    qids = [f"q{i}" for i in rng.permutation(nq) * 3 + 10]
    scores = np.sort(rng.random((nq, k)).astype(np.float32), axis=1)[:, ::-1].copy()
    scores[:, 3] = scores[:, 2]                       # exact ties
    scores[:, 5] = scores[:, 4] - np.float32(1e-8)    # equal once printed
    docs = np.array([[f"d{rng.integers(40)}#{'ab'[j % 2]}" for j in range(k)] for _ in range(nq)],
                    dtype=object)
    return qids, docs, scores


@pytest.mark.parametrize("precision", [4, 6])
def test_write_run_is_byte_identical(tmp_path, ref_python, port_path, precision):
    qids, docs, scores = _table(0)
    n_port = port.write_run(tmp_path / "p" / "run.trec", qids, docs, scores, tag="t", precision=precision)
    n_ref = ref.write_run(tmp_path / "r" / "run.trec", qids, docs, scores, tag="t", precision=precision)
    assert n_port == n_ref == scores.size
    assert (tmp_path / "p" / "run.trec").read_bytes() == (tmp_path / "r" / "run.trec").read_bytes()


def test_write_run_empty(tmp_path, ref_python, port_path):
    assert port.write_run(tmp_path / "p.trec", [], [], np.zeros((0, 3))) == 0
    assert ref.write_run(tmp_path / "r.trec", [], [], np.zeros((0, 3))) == 0
    assert (tmp_path / "p.trec").read_bytes() == (tmp_path / "r.trec").read_bytes() == b""


def test_collapse_run_max_is_byte_identical(tmp_path, ref_python, port_path):
    qids, docs, scores = _table(1, nq=6, k=12)
    raw = tmp_path / "raw.trec"
    ref.write_run(raw, qids, docs, scores, tag="raw", precision=6)
    port.collapse_run_max(raw, tmp_path / "p" / "base.trec", tag="bi")
    ref.collapse_run_max(raw, tmp_path / "r" / "base.trec", tag="bi")
    got = (tmp_path / "p" / "base.trec").read_bytes()
    assert got == (tmp_path / "r" / "base.trec").read_bytes()
    lines = got.decode().splitlines()
    assert list(dict.fromkeys(ln.split()[0] for ln in lines)) == qids  # first-seen qid order
    assert all("#" not in ln.split()[2] and "\t" not in ln for ln in lines)


def test_write_run_entries_and_read_run_match(tmp_path):
    entries = [port.RunEntry("q2", "d1", 1, 0.1234567, "x"), port.RunEntry("q1", "d9", 1, -0.5, "x")]
    ref_entries = [ref.RunEntry(*e.__dict__.values()) for e in entries]
    assert port.write_run_entries(tmp_path / "p.trec", entries) == 2
    ref.write_run_entries(tmp_path / "r.trec", ref_entries)
    assert (tmp_path / "p.trec").read_bytes() == (tmp_path / "r.trec").read_bytes()
    got = port.read_run(tmp_path / "p.trec")
    assert [e.__dict__ for e in got] == [e.__dict__ for e in ref.read_run(tmp_path / "r.trec")]


def test_native_library_is_rebuilt_per_source(tmp_path, monkeypatch):
    """The library's name carries a hash of its source: an edited source
    gets a library of its own."""
    src = tmp_path / "fastio.cpp"
    src.write_bytes(port_fastio.SOURCE.read_bytes())
    monkeypatch.setattr(port_fastio, "SOURCE", src)
    monkeypatch.setattr(port_fastio, "BUILD_DIR", tmp_path / "build")
    first = port_fastio.library_path()
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    assert port_fastio.library_path() != first
    assert port_fastio.build() and port_fastio.library_path().exists()
    assert port_fastio.library_path().parent == tmp_path / "build"


def test_fields_the_native_writer_cannot_take_fall_back(tmp_path, ref_python):
    """A docid holding a newline would shift the native writer's fields: the
    call goes to the Python path, which writes what the JAX package writes."""
    assert port_fastio.available()
    qids, docs, scores = _table(2, nq=3)
    docs[1, 2] = "bad\nid"
    before = dict(port.WRITES)
    port.write_run(tmp_path / "p.trec", qids, docs, scores)
    ref.write_run(tmp_path / "r.trec", qids, docs, scores)
    assert port.WRITES["python"] == before["python"] + 1 and port.WRITES["native"] == before["native"]
    assert (tmp_path / "p.trec").read_bytes() == (tmp_path / "r.trec").read_bytes()
