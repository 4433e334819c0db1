"""io/trec.py and io/_fastio.py: both port writers (the native library built
from csrc/fastio.cpp, and the pure-Python path) against the JAX package's
pure-Python write_run, write_run_entries and collapse_run_max, byte for
byte: scores tied at 6 decimals, first-seen qid order, docids with and
without a language tag, string rows and row ids into a docid table; the
native core's score printing against printf's."""

import ctypes

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


def _docid_table_case(case):
    """(qids, docid strings per row (None for a hole), row ids (Q, k),
    scores, precision) of one table case."""
    rng = np.random.default_rng(len(case))
    n, nq, k, precision = 60, 7, 9, 4
    docids = [f"d{i}" for i in range(n)]
    if case == "precision6":
        precision = 6
    elif case == "lang_tags_utf8":
        docids = [f"文書{i}#{'ab'[i % 2]}" if i % 3 else f"dé{i}#hi-Deva" for i in range(n)]
    elif case == "k1":
        k = 1
    elif case == "empty":
        nq = 0
    elif case == "holes":
        docids = [None if i % 4 == 3 else f"live{i}" for i in range(n)]
    live = np.flatnonzero([d is not None for d in docids])
    qids = [f"q{i}" for i in rng.permutation(nq) * 3 + 10]
    ids = np.asarray([rng.choice(live, k, replace=False) for _ in range(nq)], np.int64).reshape(nq, k)
    scores = np.sort(rng.random((nq, k)).astype(np.float32), axis=1)[:, ::-1].copy()
    if k > 1:
        scores[:, 1] = scores[:, 0]                       # exact ties
    return qids, np.asarray(docids, dtype=object), ids, scores, precision


@pytest.mark.parametrize("case", ["precision4", "precision6", "lang_tags_utf8", "k1", "empty", "holes"])
def test_table_write_is_byte_identical(tmp_path, ref_python, port_path, case):
    """Row ids into a DocidTable write what the JAX package writes from the
    ids' docid strings; a hole no id points at is an empty field."""
    qids, docids, ids, scores, precision = _docid_table_case(case)
    table = port.DocidTable.build(docids)
    assert len(table) == len(docids)
    before = port.WRITES["table"]
    n_port = port.write_run(tmp_path / "p.trec", qids, ids, scores, tag="t", precision=precision, table=table)
    n_ref = ref.write_run(tmp_path / "r.trec", qids, docids[ids], scores, tag="t", precision=precision)
    assert n_port == n_ref == ids.size and port.WRITES["table"] == before + 1
    assert (tmp_path / "p.trec").read_bytes() == (tmp_path / "r.trec").read_bytes()
    holes = [i for i, d in enumerate(docids) if d is None]
    assert table.rows(np.asarray([holes], np.int64)).tolist() == [[""] * len(holes)]
    with pytest.raises(ValueError, match="offsets must rise"):
        port.DocidTable(table.blob, table.offsets + 1)
    with pytest.raises(ValueError, match="outside a docid table"):
        port.write_run(tmp_path / "bad.trec", ["q"], np.asarray([[len(docids)]]), np.zeros((1, 1)), table=table)


def _printf(values, precision):
    libc = ctypes.CDLL(None)
    buf = ctypes.create_string_buffer(512)
    out = []
    with np.errstate(invalid="ignore"):   # signalling NaN bit patterns
        values = values.astype(np.float64)
    for x in values.tolist():
        libc.snprintf(buf, ctypes.c_size_t(512), b"%.*f", ctypes.c_int(precision), ctypes.c_double(x))
        out.append(buf.value.decode())
    return out


@pytest.mark.parametrize("precision", [4, 6])
def test_native_scores_print_as_printf(tmp_path, precision):
    """The native core prints a float32 score from an exact fixed-point
    integer: the same bytes as snprintf("%.*f") for 10^5 random bit
    patterns and the edge cases (half-way ties round to even, signed
    zeros, the snprintf fallback past 2^53 and for inf and nan)."""
    assert port_fastio.available()
    rng = np.random.default_rng(precision)
    bits = rng.integers(0, 2**32, 100_000, dtype=np.uint64).astype(np.uint32).view(np.float32)
    odd = np.arange(1, 64, 2, dtype=np.float64)
    ties = np.concatenate([odd * 2.0**-e for e in (5, 6, 7, 8)] + [[12345 + 2.0**-5, 1 + 2.0**-7, 0.5, 2.5]])
    edges = [-0.0, 0.0, -1e-7, -4e-5, -4e-7, 1e12, -1e12, 3.4e38, -3.4e38, np.inf, -np.inf, np.nan,
             1.4e-45, 9.0072e11, 9.0072e9, 0.99995, 0.9999995]
    values = np.concatenate([bits, ties.astype(np.float32), -ties.astype(np.float32),
                             np.asarray(edges, np.float32)])
    scores = values[None]
    docs = np.asarray([["d"] * values.size], dtype=object)
    assert port_fastio.write_run(str(tmp_path / "s.trec"), ["q"], docs, scores, "t", precision) == values.size
    got = [line.split("\t")[4] for line in (tmp_path / "s.trec").read_text().splitlines()]
    assert got == _printf(values, precision)
