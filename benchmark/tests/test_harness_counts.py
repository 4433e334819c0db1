"""The operation and byte counts behind the per-layer shares, held to hand
counts at small shapes, and the trace reduction on made-up intervals."""

from __future__ import annotations

import pytest

from conftest import BENCH, tiny_cell


def metric(name):
    from harness import core

    return core.load_module(BENCH / "metrics" / f"{name}.py", f"metrics.{name}")


def readings(**kw):
    from harness.core import Readings

    base = dict(window_s=2.0, trace=None, counters={}, config={})
    base.update(kw)
    return Readings(**base)


def test_sweep_mfu_counts_two_n_d_per_search():
    m = metric("sweep.mfu")
    # 10 searches over 1,000 rows of 8: 2 * 10 * 1000 * 8 = 160,000 operations
    assert m.flops(10, 1000, 8) == 160_000
    r = readings(window_s=2.0, counters={"searches": 10, "rows": 1000, "dim": 8})
    assert m.read(r) == pytest.approx(100 * 160_000 / (2.0 * 989e12))
    assert m.read(readings(counters={})) is None


def test_bin_scores_roofline_counts_rows_queries_and_bin_maxima_once():
    m = metric("bin_scores_roofline")
    # one launch, B = 4, N = 64, d = 8: bytes 64*8*2 + 4*8*2 + 4*64/8*4 = 1024 + 64 + 128;
    # operations 2*4*64*8 = 4096: bytes bound it (1216 / 3.35e12 > 4096 / 989e12)
    assert m.least_seconds(1, 4, 64, 8) == pytest.approx(1216 / 3.35e12)
    # B = 1024, N = 8,841,823, d = 1024 is bound by its operations
    ops = 2 * 1024 * 8_841_823 * 1024
    assert m.least_seconds(7, 7 * 1024, 8_841_823, 1024) == pytest.approx(7 * ops / 989e12)

    class Trace:
        def kernel_time(self, fragment):
            return (7, 0.2) if fragment == "bin_scores" else (0, 0.0)

    r = readings(trace=Trace(), counters={"padded_queries": 7 * 1024, "rows": 8_841_823, "dim": 1024})
    assert m.read(r) == pytest.approx(100 * 7 * ops / 989e12 / 0.2)
    assert m.read(readings(trace=None)) is None


def test_encode_mfu_counts_each_passage_at_its_own_length():
    m = metric("encode.mfu")
    xlmr = tiny_cell("bge-m3.encode-corpus").config
    h, f, n = 64, 128, 2
    assert m.matmul_params(xlmr) == n * (4 * h * h + 2 * h * f)
    t = 10
    assert m.passage_flops(xlmr, t) == 2 * n * (4 * h * h + 2 * h * f) * t + 4 * n * t * t * h
    qwen = tiny_cell("qwen3-0.6b.encode-corpus").config
    mq = qwen["model"]
    heads, kv, dh = mq["num_attention_heads"], mq["num_key_value_heads"], mq["head_dim"]
    per_layer = h * heads * dh * 2 + h * kv * dh * 2 + 3 * h * f
    assert m.matmul_params(qwen) == n * per_layer
    assert m.passage_flops(qwen, t) == 2 * n * per_layer * t + 4 * n * t * t * heads * dh / 2
    r = readings(window_s=1.0, config=xlmr, counters={"passes": 3, "pool_tokens": [10, 20]})
    want = 3 * (m.passage_flops(xlmr, 10) + m.passage_flops(xlmr, 20))
    assert m.read(r) == pytest.approx(100 * want / 989e12)


def test_published_widths_give_the_published_parameter_counts():
    from harness import core

    m = metric("encode.mfu")
    bge = core.load_json(BENCH / "configs" / "bge-m3_mmarco-8.8m-bf16.json")
    qwen = core.load_json(BENCH / "configs" / "qwen3-embedding-0.6b.json")
    assert m.matmul_params(bge) == 24 * (4 * 1024 ** 2 + 2 * 1024 * 4096)        # 302M
    assert m.matmul_params(qwen) == 28 * (1024 * 2048 * 2 + 1024 * 1024 * 2 + 3 * 1024 * 3072)  # 440M


def test_trace_union_and_gap_owners():
    from harness.trace import _owners, _union

    covered, gaps = _union([(10, 20), (15, 30), (40, 50)], 0, 60)
    assert covered == 30 and gaps == [(0, 10), (30, 40), (50, 60)]
    host = [(0, 100_000, "outer"), (30_000, 60_000, "inner")]
    owned = dict((n, s) for n, s in _owners([(35_000, 55_000), (70_000, 95_000)], host))
    assert owned == {"inner": pytest.approx(20e-6), "outer": pytest.approx(25e-6)}


def test_share_readers_return_nothing_without_a_reading():
    for name in ("trec.write_share.sweep", "device.idle_share.sweep", "tokenizer.wait_share.encode",
                 "device.idle_share.encode", "encode.mfu"):
        assert metric(name).read(readings()) is None
