"""The port's ``analysis/plots.py`` against the JAX package's: ``generate_all``
writes the same file names, every PNG is pixel for pixel equal (read back
with ``matplotlib.image.imread``), each figure function alone draws the
same pixels, and the offline ``write_projection_html`` (plotly is not
installed) is byte for byte equal."""

import numpy as np
import pytest

from codemix_dense_retrieval_torch.analysis import collect as port_col
from codemix_dense_retrieval_torch.analysis import plots as port_plots
from codemix_dense_retrieval_torch.analysis.paper_values import en_absent_split
from codemix_dense_retrieval_torch.cli import main as port_main
from codemix_dense_retrieval_tpu.analysis import plots as ref_plots
from codemix_dense_retrieval_tpu.cli import main as ref_main
from tests.torch_results_tree import build_results_tree


def _assert_same_figures(want_dir, got_dir):
    from matplotlib.image import imread

    names = sorted(p.name for p in want_dir.iterdir())
    assert names and sorted(p.name for p in got_dir.iterdir()) == names
    for name in names:
        if name.endswith(".png"):
            want, got = imread(want_dir / name), imread(got_dir / name)
            assert got.shape == want.shape and np.array_equal(got, want), name
    return names


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return build_results_tree(tmp_path_factory.mktemp("tree"), seed=5)


def _synthetic():
    """Rows and a summary with the model-size and EN-partner entries the
    ablation figures need (the JAX suite's plot fixtures)."""
    rows = []
    for pair, side in (("EN-ZH", "chinese"), ("EN-ZH", "english"), ("EN-ZH", "bilingual-en-zh"),
                       ("AR-ZH", "arabic")):
        for mode in ("embed", "word"):
            for r in (0.0, 25.0, 50.0, 75.0, 100.0):
                rows.append({"pair": pair, "doc_side": side, "mix_mode": mode, "mix_ratio": r,
                             "ndcg10": 25 + 5 * np.sin(r / 30)})
    summary = []
    for i, (pair, side, model) in enumerate([
        ("EN-ZH", "chinese", "qwen3-embedding-0.6b"), ("EN-ZH", "chinese", "qwen3-embedding-4b"),
        ("EN-ZH", "chinese", "qwen3-embedding-8b"), ("EN-ZH", "english", "bge-m3"),
        ("AR-ZH", "arabic", "bge-m3"), ("AR-ZH", "chinese", "bge-m3"),
    ]):
        summary.append({"pair": pair, "doc_side": side, "model": model, "delta_ndcg": 1.0 - 0.3 * i,
                        "lambda_star_mid": 50.0, "best_endpoint_ndcg": 25.0 + i,
                        "best_mixed_ndcg": 26.0 + 0.8 * i, "lang2vec_knn": 0.33 if pair == "EN-ZH" else 0.41,
                        "same_script": pair == "AR-ZH"})
    return rows, summary


def test_plots_cli_same_figures(tree, tmp_path, capsys):
    ref_main(["plots", "--results_root", str(tree), "--outdir", str(tmp_path / "ref")])
    port_main(["plots", "--results_root", str(tree), "--outdir", str(tmp_path / "port")])
    names = _assert_same_figures(tmp_path / "ref", tmp_path / "port")
    assert {"delta_hist.png", "ratio_curves_ndcg10.png", "triad_en_zh.png"} <= set(names)


def test_generate_all_on_synthetic_rows(tmp_path):
    rows, summary = _synthetic()
    got = port_plots.generate_all(rows, summary, tmp_path / "port")
    want = ref_plots.generate_all(rows, summary, tmp_path / "ref")
    assert [p.name for p in got] == [p.name for p in want]
    assert "model_scale" in {p.stem for p in got}
    _assert_same_figures(tmp_path / "ref", tmp_path / "port")


def _calls(collected_rows, collected_summary):
    rows, summary = _synthetic()
    rng = np.random.default_rng(4)
    hub_summary = [
        {"pair": "EN-ZH", "doc_side": "chinese", "delta_ndcg": 1.7}, {"pair": "AR-ZH", "doc_side": "chinese", "delta_ndcg": 0.9},
        {"pair": "ID-ZH", "doc_side": "chinese", "delta_ndcg": 1.1}, {"pair": "EN-AR", "doc_side": "arabic", "delta_ndcg": 2.9},
        {"pair": "AR-ZH", "doc_side": "arabic", "delta_ndcg": 1.5},
        {"pair": "EN-ZH", "doc_side": "bilingual-en-zh", "delta_ndcg": 0.3},
    ]
    return {
        "plot_delta_hist": (collected_summary,),
        "plot_ratio_curves": (collected_rows,),
        "plot_lambda_star": (collected_summary,),
        "plot_en_split": (en_absent_split(collected_summary),),
        "plot_projection_panel": (rng.standard_normal(100) + 2, rng.standard_normal(100) - 2, rng.standard_normal(100)),
        "plot_pair_triad": (collected_rows,),
        "plot_typology_scatter": (summary,),
        "plot_headroom": (collected_summary,),
        "plot_ablation_dumbbells": (summary,),
        "plot_hub_examples": (hub_summary,),
        "plot_mono_alignment_curve": (rows,),
        "plot_model_scale": (summary,),
    }


@pytest.mark.parametrize("name", [
    "plot_delta_hist", "plot_ratio_curves", "plot_lambda_star", "plot_en_split", "plot_projection_panel",
    "plot_pair_triad", "plot_typology_scatter", "plot_headroom", "plot_ablation_dumbbells", "plot_hub_examples",
    "plot_mono_alignment_curve", "plot_model_scale",
])
def test_each_figure_function(tree, tmp_path, name):
    rows = port_col.collect_results(tree)
    args = _calls(rows, port_col.compute_summary(rows))[name]
    extra = {"pair": "EN-ZH"} if name == "plot_pair_triad" else {}
    got = getattr(port_plots, name)(*args, tmp_path / "port", **extra)
    want = getattr(ref_plots, name)(*args, tmp_path / "ref", **extra)
    assert got and [p.name for p in got] == [p.name for p in want]
    _assert_same_figures(tmp_path / "ref", tmp_path / "port")


@pytest.mark.parametrize("n,groups", [(90, 3), (7, 2), (300, 3)])
def test_write_projection_html_byte_equal(tmp_path, n, groups):
    pts = np.random.default_rng(n).standard_normal((n, 3))
    labels = [i % groups for i in range(n)]
    names = ["EN", "ZH", "CM"][:groups]
    got = port_plots.write_projection_html(pts, labels, names, tmp_path / "port.html", title="t")
    want = ref_plots.write_projection_html(pts, labels, names, tmp_path / "ref.html", title="t")
    assert got.read_bytes() == want.read_bytes()
    assert got.read_text().startswith("<!DOCTYPE html>")


@pytest.mark.parametrize("tag", ["qwen3-embedding-0.6b", "Qwen3-Embedding-8B", "bge-m3", "x-12b-y"])
def test_model_size_parse(tag):
    assert port_plots._model_size_b(tag) == ref_plots._model_size_b(tag)
