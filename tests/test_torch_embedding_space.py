"""The port's ``analysis/embedding_space.py`` against the JAX package's on
seeded numpy inputs: every host metric and the ``analyze_triplets`` summary
within 1e-6; ``hubness_stats`` equal at 5,000 rows (both on their exact
top-k, which takes the full sort below 16,384 rows), at 600 rows (numpy
argpartition in both) and after the ``max_vectors`` sample; a failed top-k
inside ``hubness_stats`` fails the call; ``analyze --device cpu`` writes the
JAX CLI's file set with report numbers within 1e-5 (both CLIs load one
small XLM-R checkpoint, so their query embeddings agree to ~1e-6)."""

import csv
import json
import re

import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.analysis import embedding_space as port
from codemix_dense_retrieval_torch.cli import main as port_main
from codemix_dense_retrieval_torch.io.tsv import write_queries_tsv
from codemix_dense_retrieval_tpu.analysis import embedding_space as ref
from codemix_dense_retrieval_tpu.cli import main as ref_main

TOL = 1e-6
TOL_CLI = 1e-5


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _triplets(seed, b=60, d=24):
    rng = np.random.default_rng(seed)
    en = _unit(rng.standard_normal((b, d)) + np.eye(d)[0] * 2).astype(np.float32)
    zh = _unit(rng.standard_normal((b, d)) - np.eye(d)[0] * 2).astype(np.float32)
    t = rng.uniform(0.2, 0.8, (b, 1))
    cm = _unit(t * en + (1 - t) * zh + 0.1 * rng.standard_normal((b, d))).astype(np.float32)
    return en, zh, cm


@pytest.mark.parametrize("seed", [0, 1])
def test_host_metrics_match(seed):
    en, zh, cm = _triplets(seed)
    for got, want in zip(port.line_metrics(en, zh, cm), ref.line_metrics(en, zh, cm)):
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    for got, want in zip(port.linear_reconstruction(en, zh, cm), ref.linear_reconstruction(en, zh, cm)):
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    cloud = np.vstack([en, zh, cm])
    assert port.anisotropy(cloud, num_pairs=5000, seed=seed) == ref.anisotropy(cloud, num_pairs=5000, seed=seed)
    r, delta, _, _ = ref.line_metrics(en, zh, cm)
    cos_mid = np.einsum("bd,bd->b", cm, _unit(en + zh))
    got, want = port.detect_outliers(r, delta, cos_mid), ref.detect_outliers(r, delta, cos_mid)
    assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)
    assert port.gini_coefficient(np.abs(delta)) == ref.gini_coefficient(np.abs(delta))


@pytest.mark.parametrize("seed", [0, 3])
def test_analyze_triplets_summary_matches(seed):
    en, zh, cm = _triplets(seed)
    got = port.analyze_triplets(en, zh, cm, seed=seed, device="cpu")
    want = ref.analyze_triplets(en, zh, cm, seed=seed)
    g, w = got.summary(), want.summary()
    assert g.keys() == w.keys()
    for key in w:
        assert g[key] == pytest.approx(w[key], abs=TOL, nan_ok=True), key
    for key in want.per_query:
        np.testing.assert_allclose(got.per_query[key], want.per_query[key], atol=TOL, rtol=0)


@pytest.mark.parametrize("n,max_vectors,use_device", [
    (5000, 20_000, True),   # both through their exact top-k (the full sort)
    (600, 20_000, None),    # numpy argpartition in both
    (5200, 4200, None),     # sampled to 4,200 rows, then the top-k in both
])
def test_hubness_stats_match(n, max_vectors, use_device):
    rng = np.random.default_rng(n)
    emb = rng.standard_normal((n, 32)).astype(np.float32)
    emb[: n // 10] += 2.0 * rng.standard_normal(32).astype(np.float32)  # a hub region
    got = port.hubness_stats(emb, k=10, max_vectors=max_vectors, seed=5, use_device=use_device, device="cpu")
    want = ref.hubness_stats(emb, k=10, max_vectors=max_vectors, seed=5, use_device=use_device)
    assert got == want
    assert got["n_vectors_used"] == min(n, max_vectors)


def test_hubness_stats_top_k_failure_propagates(monkeypatch):
    from codemix_dense_retrieval_torch.ops import topk

    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(topk, "topk_ip", broken)
    emb = np.random.default_rng(0).standard_normal((4096, 8)).astype(np.float32)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        port.hubness_stats(emb, device="cpu")


def test_hubness_stats_runs_the_top_k_on_the_named_device(monkeypatch):
    from codemix_dense_retrieval_torch.ops import topk

    seen = []
    real = topk.topk_ip

    def spy(q, d, k, **kwargs):
        seen.append((q.device.type, q.dtype, k))
        return real(q, d, k, **kwargs)

    monkeypatch.setattr(topk, "topk_ip", spy)
    emb = np.random.default_rng(1).standard_normal((4100, 8))  # float64 in: the top-k takes f32, as JAX's
    port.hubness_stats(emb, k=7, device="cpu")
    assert seen == [("cpu", torch.float32, 8)]


# --- the analyze CLI ---------------------------------------------------------

H, F, VOCAB, MAXPOS = 32, 64, 120, 66


def _hf_xlmr_dir(path, seed=0):
    """A one-layer XLM-R checkpoint in HF layout (config.json +
    pytorch_model.bin, ``roberta.`` prefix)."""
    rng = np.random.default_rng(seed)
    shapes = {
        "embeddings.word_embeddings.weight": (VOCAB, H), "embeddings.position_embeddings.weight": (MAXPOS, H),
        "embeddings.token_type_embeddings.weight": (1, H),
        "embeddings.LayerNorm.weight": (H,), "embeddings.LayerNorm.bias": (H,),
    }
    pre = "encoder.layer.0."
    for name in ("attention.self.query", "attention.self.key", "attention.self.value", "attention.output.dense"):
        shapes[pre + name + ".weight"], shapes[pre + name + ".bias"] = (H, H), (H,)
    shapes[pre + "intermediate.dense.weight"], shapes[pre + "intermediate.dense.bias"] = (F, H), (F,)
    shapes[pre + "output.dense.weight"], shapes[pre + "output.dense.bias"] = (H, F), (H,)
    for name in ("attention.output.LayerNorm", "output.LayerNorm"):
        shapes[pre + name + ".weight"], shapes[pre + name + ".bias"] = (H,), (H,)
    sd = {"roberta." + k: torch.from_numpy(
        (0.3 * rng.standard_normal(s) + (1.0 if k.endswith("LayerNorm.weight") else 0.0)).astype(np.float32))
        for k, s in shapes.items()}
    path.mkdir(parents=True)
    torch.save(sd, path / "pytorch_model.bin")
    (path / "config.json").write_text(json.dumps({
        "model_type": "xlm-roberta", "vocab_size": VOCAB, "hidden_size": H, "num_hidden_layers": 1,
        "num_attention_heads": 4, "intermediate_size": F, "max_position_embeddings": MAXPOS,
        "type_vocab_size": 1, "pad_token_id": 1, "layer_norm_eps": 1e-5}))
    return path


def _numbers(text):
    return [float(x) for x in re.findall(r"-?\d+\.\d+(?:e-?\d+)?|nan", text)]


def test_analyze_cli_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(9)
    words_en = [f"w{i}" for i in range(40)]
    words_zh = [f"z{i}" for i in range(40)]
    rows_en, rows_zh, rows_cm = [], [], []
    for i in range(48):
        en = list(rng.choice(words_en, 6))
        zh = list(rng.choice(words_zh, 6))
        cut = int(rng.integers(1, 6))
        rows_en.append((f"q{i}", " ".join(en)))
        rows_zh.append((f"q{i}", " ".join(zh)))
        rows_cm.append((f"q{i}", " ".join(en[:cut] + zh[cut:])))
    rows_cm.pop(3)  # a qid the CM set lacks is dropped, texts stay aligned
    for name, rows in (("en", rows_en), ("zh", rows_zh[::-1]), ("cm", rows_cm)):
        write_queries_tsv(tmp_path / f"{name}.tsv", rows)
    ck = _hf_xlmr_dir(tmp_path / "hf")
    common = ["--checkpoint", str(ck), "--smoke_dim", str(H), "--seed", "3",
              "--query_tsv", *(f"{n}={tmp_path / (n + '.tsv')}" for n in ("en", "zh", "cm"))]
    ref_main(["analyze", *common, "--outdir", str(tmp_path / "ref")])
    port_main(["analyze", *common, "--outdir", str(tmp_path / "port"), "--device", "cpu"])
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == ["anisotropy.json", "hubness_stats.json", "per_query_metrics.csv", "projection.png",
                     "projection_3d.html", "report.md"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for name in ("anisotropy.json", "hubness_stats.json"):
        want = json.loads((tmp_path / "ref" / name).read_text())
        got = json.loads((tmp_path / "port" / name).read_text())
        assert got.keys() == want.keys()
        for key in want:
            assert got[key] == pytest.approx(want[key], abs=TOL_CLI), (name, key)
    want_md, got_md = (tmp_path / "ref" / "report.md").read_text(), (tmp_path / "port" / "report.md").read_text()
    assert re.sub(r"-?\d+\.\d+", "#", got_md) == re.sub(r"-?\d+\.\d+", "#", want_md)
    np.testing.assert_allclose(_numbers(got_md), _numbers(want_md), atol=TOL_CLI, rtol=0)
    with open(tmp_path / "ref" / "per_query_metrics.csv") as f:
        want_rows = list(csv.reader(f))
    with open(tmp_path / "port" / "per_query_metrics.csv") as f:
        got_rows = list(csv.reader(f))
    assert len(got_rows) == len(want_rows) == 48  # header + 47 shared qids
    assert [r[0] for r in got_rows] == [r[0] for r in want_rows]
    assert [r[-3:] for r in got_rows] == [r[-3:] for r in want_rows]  # outlier flags
    np.testing.assert_allclose(np.array([r[1:-3] for r in got_rows[1:]], float),
                               np.array([r[1:-3] for r in want_rows[1:]], float), atol=TOL_CLI, rtol=0)
