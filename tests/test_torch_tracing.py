"""utils/timing.py, the port's spans and counters: nothing recorded and one
shared no-op while no profiler runs; nested spans as the profiler's host
events with the registry's counts, seconds, self seconds and parents; a
helper thread's span handed the caller's decision, on the trace's clock;
the spans and counters of the alpha sweep and of the corpus encode; and the
same TREC files and store rows with tracing on and off."""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex
from codemix_dense_retrieval_torch.io.shards import ShardStore
from codemix_dense_retrieval_torch.models.encoder import TextEncoder
from codemix_dense_retrieval_torch.models.tokenizer import bucket_length
from codemix_dense_retrieval_torch.models.xlmr import XLMRConfig
from codemix_dense_retrieval_torch.pipeline.corpus import encode_corpus
from codemix_dense_retrieval_torch.pipeline.runs import run_vector_mix_search
from codemix_dense_retrieval_torch.utils import timing

TINY = dict(vocab_size=300, hidden_size=32, num_heads=4, intermediate_size=64, max_position_embeddings=80)
BUCKETS = (16, 32, 64)
ALPHAS = [0.0, 0.5, 1.0]


def profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def host_events(prof):
    """{name: [(start_ns, end_ns)]} of the profiler's host events."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


@pytest.fixture(autouse=True)
def fresh_registry():
    timing.reset()
    yield
    timing.reset()


@pytest.fixture(scope="module")
def encoder():
    return TextEncoder("BAAI/bge-m3", XLMRConfig.tiny(**TINY, use_flash=False), seed=5, device="cpu",
                       length_buckets=BUCKETS)


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(1)
    docs = rng.standard_normal((3000, 32)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    return DenseFlatIndex.build(docs, [f"doc{i}" for i in range(len(docs))]).to_device("cpu")


def _texts(seed, n=45):
    rng = np.random.default_rng(seed)
    return [" ".join(f"t{x}" for x in rng.integers(0, 250, rng.integers(1, 50))) for _ in range(n)]


def _queries(n=20, d=32):
    rng = np.random.default_rng(2)
    a = rng.standard_normal((n, d)).astype(np.float32)
    return [f"q{i}" for i in range(n)], a, a + 0.5 * rng.standard_normal((n, d)).astype(np.float32)


def test_off_records_nothing_through_one_shared_noop(index, tmp_path):
    assert not timing.tracing() and timing.handoff() is None
    assert timing.span("a") is timing.span("b", device=torch.device("cpu"))
    with timing.span("a") as inner:
        assert inner is None
        timing.count("c", 3)
    qids, a, b = _queries()
    run_vector_mix_search(index, qids, a, b, ALPHAS, tmp_path, k=5, query_block=8)
    assert timing.totals() == {"spans": {}, "counters": {}} and timing.records() == []


def test_off_a_phase_counter_still_gets_the_seconds():
    stats = {"wait": 0.0}
    with timing.span("x.wait", stat=(stats, "wait")):
        time.sleep(0.002)
    assert stats["wait"] >= 0.002 and timing.records() == []
    assert timing.span("x.wait", stat=(None, "wait")) is timing.span("y")


def test_nested_spans_are_host_events_with_counts_self_seconds_and_parents():
    with profiled() as prof:
        assert timing.tracing()
        for _ in range(2):
            with timing.span("outer", device=torch.device("cpu")):
                with timing.span("inner"):
                    time.sleep(0.002)
                time.sleep(0.001)
        timing.count("things", 2)
        timing.count("things")
    events = host_events(prof)
    assert len(events["outer"]) == len(events["inner"]) == 2
    tot = timing.totals()
    outer, inner = tot["spans"]["outer"], tot["spans"]["inner"]
    assert outer["count"] == inner["count"] == 2
    assert (outer["parent"], inner["parent"]) == (None, "outer")
    assert inner["seconds"] >= 0.004 and outer["seconds"] >= inner["seconds"] + 0.002
    assert outer["self_seconds"] == pytest.approx(outer["seconds"] - inner["seconds"], rel=1e-9, abs=1e-12)
    assert inner["self_seconds"] == inner["seconds"]
    assert outer["device_seconds"] is None           # no card: no device time
    assert tot["counters"] == {"things": 3}
    recs = timing.records()
    assert [r.name for r in recs] == ["inner", "outer"] * 2
    # each record lies inside the profiler's host event of the same span
    for r, (e0, e1) in zip([r for r in recs if r.name == "outer"], events["outer"]):
        assert e0 <= r.start_ns <= r.end_ns <= e1


def test_a_helper_thread_span_takes_the_callers_decision_and_clock():
    seen = {}

    def work(handed):
        seen["profiled_here"] = torch.autograd._profiler_enabled()
        with timing.span("helper.work", within=handed):
            time.sleep(0.002)
        timing.count("helper.items", 4, within=handed)

    with profiled() as prof:
        with timing.span("caller"):
            handed = timing.handoff()
            th = threading.Thread(target=work, args=(handed,), name="helper-0")
            th.start()
            th.join(timeout=30)
    assert not th.is_alive()
    (c0, c1), = host_events(prof)["caller"]
    rec, = [r for r in timing.records() if r.name == "helper.work"]
    assert (rec.parent, rec.thread) == ("caller", "helper-0")
    assert c0 <= rec.start_ns < rec.end_ns <= c1
    tot = timing.totals()
    assert tot["spans"]["helper.work"]["parent"] == "caller"
    assert tot["counters"] == {"helper.items": 4}
    assert seen["profiled_here"] is False            # why the decision is handed over


def test_the_alpha_sweep_spans_and_counters(index, tmp_path):
    """The docid table is built before the traced window (as a warm-up
    builds it), so the window counts no build and one table write an alpha;
    the runner looks up no docid strings (no ``search.docids``)."""
    qids, a, b = _queries()
    index.docid_table()
    with profiled():
        run_vector_mix_search(index, qids, a, b, ALPHAS, tmp_path, k=5, query_block=8)
    tot = timing.totals()
    spans, counters = tot["spans"], tot["counters"]
    blocks = len(ALPHAS) * -(-len(qids) // 8)
    want = {"runs.alpha": (len(ALPHAS), None), "runs.mix": (len(ALPHAS), "runs.alpha"),
            "search.call": (len(ALPHAS), "runs.alpha"), "search.fit_block": (len(ALPHAS), "search.call"),
            "search.block": (blocks, "search.call"), "search.phase1": (blocks, "search.block"),
            "search.tail": (blocks, "search.block"), "search.readback": (len(ALPHAS), "search.call"),
            "trec.write": (len(ALPHAS), "runs.alpha")}
    for name, (n, parent) in want.items():
        assert (spans[name]["count"], spans[name]["parent"]) == (n, parent), name
    assert "search.docids" not in spans
    writer = "trec.native_write" if "trec.native_write" in spans else "trec.python_write"
    assert spans[writer]["count"] == len(ALPHAS) and spans[writer]["parent"] == "trec.write"
    lines = sum(len(p.read_text().splitlines()) for p in tmp_path.glob("*.trec"))
    nbytes = sum(p.stat().st_size for p in tmp_path.glob("*.trec"))
    assert counters == {"runs.queries": len(ALPHAS) * len(qids), "search.blocks": blocks,
                        "search.queries": len(ALPHAS) * len(qids), "trec.lines": lines, "trec.bytes": nbytes,
                        "trec.table_writes": len(ALPHAS)}
    assert lines == len(ALPHAS) * len(qids) * 5


@pytest.mark.parametrize("pack", [False, True])
def test_the_encoders_spans_counters_and_phase_stats(encoder, pack):
    texts = _texts(0)
    with profiled():
        encoder.encode_documents(texts, batch_size=8, pack=pack)
    stats = encoder.last_phase_stats
    tot = timing.totals()
    spans, counters = tot["spans"], tot["counters"]
    # one clock reading feeds the phase counter and the span
    for key, name in (("tokenize_work", "encoder.tokenize"), ("tokenize_wait", "encoder.tokenize_wait"),
                      ("readback_work", "encoder.readback"), ("readback_wait", "encoder.readback_wait")):
        assert spans[name]["seconds"] == pytest.approx(stats[key], rel=1e-12, abs=0), name
        assert spans[name]["parent"] == "encoder.encode"
    assert spans["encoder.encode"]["count"] == 1 and spans["encoder.forward"]["parent"] == "encoder.encode"
    assert spans["encoder.tokenize"]["count"] == spans["encoder.readback"]["count"] == stats["batches"]
    assert counters["encoder.batches"] == spans["encoder.forward"]["count"]
    threads = {r.thread for r in timing.records()}
    assert {"MainThread"} < threads and any(t.startswith("encoder-prefetch") for t in threads)
    assert any(t.startswith("encoder-reader") for t in threads)
    lens = [int(encoder.tokenizer.encode_batch([t], 78)[1].sum()) for t in texts]
    assert counters["encoder.tokens"] == sum(lens)
    if not pack:
        # length-sorted batches of 8, each padded to its bucket
        order = encoder._length_order(texts)
        sizes = [[lens[i] for i in order[j : j + 8]] for j in range(0, len(texts), 8)]
        assert counters["encoder.padded_tokens"] == sum(len(s) * bucket_length(max(s), BUCKETS) for s in sizes)
        assert counters["encoder.batches"] == len(sizes)
    else:
        # rows of the last bucket (64), whole forwards of them
        assert counters["encoder.padded_tokens"] % 64 == 0 and counters["encoder.padded_tokens"] > sum(lens)


def test_the_corpus_encode_spans_and_counters(encoder, tmp_path):
    texts = _texts(3, n=50)
    with profiled():
        encode_corpus(encoder, {"xx": [(f"d{i}", t) for i, t in enumerate(texts)]}, tmp_path,
                      batch_size=20, enc_batch=8)
    tot = timing.totals()
    spans = tot["spans"]
    assert spans["corpus.batch"]["count"] == 3 and spans["corpus.select"]["parent"] == "corpus.batch"
    assert spans["encoder.encode"]["parent"] == spans["store.append"]["parent"] == "corpus.batch"
    assert spans["store.append"]["count"] == 3 and spans["store.finalize"]["count"] == 1
    assert tot["counters"]["store.rows"] == len(texts)


def _trec_files(index, root, on):
    qids, a, b = _queries()
    with profiled() if on else contextlib.nullcontext():
        run_vector_mix_search(index, qids, a, b, ALPHAS, root, k=7, query_block=8)
    return {p.name: p.read_bytes() for p in sorted(root.glob("*.trec"))}


def _store_files(encoder, root, on):
    docs = [(f"d{i}", t) for i, t in enumerate(_texts(4, n=30))]
    with profiled() if on else contextlib.nullcontext():
        encode_corpus(encoder, {"xx": docs}, root, batch_size=16, enc_batch=8)
    store = ShardStore.open(root / "xx")
    assert store.count == len(docs)
    return {p.name: p.read_bytes() for p in sorted((root / "xx").iterdir())}


@pytest.mark.parametrize("what", ["trec", "store"])
def test_outputs_are_byte_equal_with_tracing_on_and_off(what, encoder, index, tmp_path):
    make = {"trec": lambda root, on: _trec_files(index, root, on),
            "store": lambda root, on: _store_files(encoder, root, on)}[what]
    off = make(tmp_path / "off", False)
    on = make(tmp_path / "on", True)
    assert timing.records() and off and off == on


def _cli_inputs(root):
    """A 32-wide index, a passage TSV and two query TSVs at ``--smoke_dim 32``."""
    rng = np.random.default_rng(9)
    DenseFlatIndex.build(rng.standard_normal((400, 32)).astype(np.float32),
                         [f"d{i}" for i in range(400)]).save(root / "ix")
    (root / "xx.tsv").write_text("".join(f"p{i}\t{t}\n" for i, t in enumerate(_texts(6, n=24))))
    for lang, text in (("en", "w1 w2 w3"), ("zh", "w3 w9")):
        (root / f"{lang}.tsv").write_text("".join(f"q{i}\t{text} w{i}\n" for i in range(5)))
    bands = root / "bands"
    bands.mkdir()
    (bands / "queries-cm0-20.tsv").write_text("".join(f"q{i}\tband query {i}\n" for i in range(4)))


@pytest.mark.parametrize("command", ["encode-corpus", "run-mix", "run-mono"])
def test_cli_commands_write_their_spans_under_cdr_profile_dir(command, tmp_path, monkeypatch):
    import json

    from codemix_dense_retrieval_torch.cli import main

    _cli_inputs(tmp_path)
    monkeypatch.setenv("CDR_PROFILE_DIR", str(tmp_path / "prof"))
    common = ["--device", "cpu", "--smoke_dim", "32"]
    argv = {
        "encode-corpus": ["--corpus_tsv", f"xx={tmp_path / 'xx.tsv'}", "--out", str(tmp_path / "out"),
                          "--batch", "10", "--enc_batch", "4"],
        "run-mix": ["--index", str(tmp_path / "ix"), "--k", "7", "--cm_alphas", "0", "0.5",
                    "--query_tsv", f"en={tmp_path / 'en.tsv'}", f"zh={tmp_path / 'zh.tsv'}",
                    "--outdir", str(tmp_path / "runs")],
        "run-mono": ["--index", str(tmp_path / "ix"), "--k", "6", "--queries", str(tmp_path / "bands"),
                     "--outdir", str(tmp_path / "runs")],
    }[command]
    main([command, *common, *argv])
    out = tmp_path / "prof" / command
    tot = json.loads((out / "spans.json").read_text())
    spans, counters = tot["spans"], tot["counters"]
    assert spans["encoder.forward"]["device_seconds"] is None   # no card
    assert counters["encoder.batches"] == spans["encoder.forward"]["count"]
    assert counters["encoder.padded_tokens"] >= counters["encoder.tokens"] > 0
    if command == "encode-corpus":
        assert counters["store.rows"] == 24 and spans["corpus.batch"]["count"] == 3
    else:
        runs = sorted((tmp_path / "runs").glob("*.trec"))
        lines = sum(len(p.read_text().splitlines()) for p in runs)
        assert counters["trec.lines"] == lines > 0
        assert counters["trec.bytes"] == sum(p.stat().st_size for p in runs)
        assert counters["runs.queries"] == {"run-mix": 2 * 5, "run-mono": 4}[command]
        assert spans["search.call"]["count"] == counters["search.blocks"] >= 1
    trace = json.loads((out / "trace.json").read_text())
    rows = {e["name"] for e in trace["traceEvents"] if e.get("cat") == "span"}
    assert set(spans) == rows
