"""The operation and byte counts of the mixture-of-experts cell's per-layer
shares, held to hand counts and to the published widths."""

from __future__ import annotations

import pytest

from conftest import BENCH, tiny_cell


def metric(name):
    from harness import core

    return core.load_module(BENCH / "metrics" / f"{name}.py", f"metrics.{name}")


def readings(**kw):
    from harness.core import Readings

    base = dict(window_s=2.0, trace=None, counters={}, config={"model": {}})
    base.update(kw)
    return Readings(**base)


def moonlight():
    from harness import core

    return core.load_json(BENCH / "configs" / "moonlight-16b-a3b-17l.json")


def test_active_mfu_counts_a_tokens_active_parameters():
    m = metric("encode.active_mfu")
    cfg = tiny_cell("moonlight-16b-a3b.encode-corpus").config      # 2 layers: dense, MoE
    mm = cfg["model"]
    h, heads, f, fe = 64, mm["num_attention_heads"], 128, 64
    nope, rope, dv, rank = 16, 8, 16, 32
    attn = h * heads * (nope + rope) + h * (rank + rope) + rank * heads * (nope + dv) + heads * dv * h
    moe = h * 8 + 3 * h * fe * (1 + 2)                 # router, 1 shared, top 2 of 8
    assert m.active_params(cfg) == 2 * attn + moe + 3 * h * f
    t = 10
    assert m.passage_flops(cfg, t) == 2 * m.active_params(cfg) * t + 2 * 2 * t * t * heads * (24 + 16) / 2
    r = readings(window_s=1.0, config=cfg, counters={"passes": 3, "pool_tokens": [10, 20]})
    assert m.read(r) == pytest.approx(100 * 3 * (m.passage_flops(cfg, 10) + m.passage_flops(cfg, 20)) / 989e12)
    assert m.read(readings(config=tiny_cell("qwen3-0.6b.encode-corpus").config,
                           counters={"passes": 1, "pool_tokens": [5]})) is None


def test_the_published_widths_give_2_83_gflop_a_token():
    m = metric("encode.active_mfu")
    # 17 x MLA 13.76M + 16 x (router 0.13M + 8 x 3 x 2048 x 1408) + dense 3 x 2048 x 11264
    attn = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048
    moe = 2048 * 64 + 3 * 2048 * 1408 * 8
    assert m.active_params(moonlight()) == 17 * attn + 16 * moe + 3 * 2048 * 11264
    assert 2 * m.active_params(moonlight()) == pytest.approx(2.825e9, rel=1e-3)


def test_expert_gemm_roofline_counts_each_layer_forward():
    m = metric("expert_gemm_roofline")
    cfg = moonlight()
    # 480 rows an expert at full width: 5,120 tokens x 6 = 30,720 rows;
    # operations 2 x 30,720 x 2048 x 1408 x 3 = 531.5 GFLOP (0.537 ms) against
    # bytes 64 x 3 x 2048 x 1408 x 2 + 30,720 x 4096 x 2 = 1.359 GB (0.406 ms)
    ops = 2 * 30_720 * 2048 * 1408 * 3
    assert m.layer_least_seconds(cfg, 5120) == pytest.approx(ops / 989e12)
    nbytes = 64 * 3 * 2048 * 1408 * 2 + 160 * 6 * 4096 * 2
    assert m.layer_least_seconds(cfg, 160) == pytest.approx(nbytes / 3.35e12)   # a short forward: bytes
    # two forwards of the pool, longest first, through 16 MoE layers
    pool = [5, 1, 3, 2]
    assert m.pass_least_seconds(cfg, pool, 2) == pytest.approx(
        16 * (m.layer_least_seconds(cfg, 8) + m.layer_least_seconds(cfg, 3)))

    class Trace:
        def kernel_time(self, fragment):
            return (64, 0.5) if fragment == "GroupProblemShape" else (0, 0.0)

    r = readings(trace=Trace(), config=cfg, counters={"passes": 2, "pool_tokens": pool,
                                                      "phase_stats": [{"batches": 2}]})
    assert m.read(r) == pytest.approx(100 * 2 * m.pass_least_seconds(cfg, pool, 2) / 0.5)
    assert m.read(readings(trace=None, config=cfg)) is None


def test_moe_overhead_reads_route_dispatch_and_combine(monkeypatch):
    from codemix_dense_retrieval_torch.utils import timing

    m = metric("moe.overhead_share.encode")
    spans = {"moe.route": {"seconds": 0.5, "device_seconds": 0.2},
             "moe.dispatch": {"seconds": 0.5, "device_seconds": 0.3},
             "moe.experts": {"seconds": 9.0, "device_seconds": 9.0},
             "moe.combine": {"seconds": 0.5, "device_seconds": None}}     # no card: its own seconds
    monkeypatch.setattr(timing, "totals", lambda: {"spans": spans, "counters": {}})
    assert m.read(readings(trace=object(), window_s=2.0)) == pytest.approx(100 * (0.2 + 0.3 + 0.5) / 2.0)
    monkeypatch.setattr(timing, "totals", lambda: {"spans": {}, "counters": {}})
    assert m.read(readings(trace=object())) is None
