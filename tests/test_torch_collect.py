"""The port's collectors (``analysis/collect.py``, ``ablation.py``,
``lang_factors.py``) against the JAX package's on a results tree made by the
port on the CPU (:mod:`tests.torch_results_tree`): the ``collect`` CSVs of
both CLIs (plain, ``--reference_format``, ``--ablation`` and both) are byte
for byte equal, and so are the rows and summaries in memory (the bootstrap
CI is seeded, so exact equality holds)."""

import random

import pytest

from codemix_dense_retrieval_torch.analysis import ablation as port_abl
from codemix_dense_retrieval_torch.analysis import collect as port_col
from codemix_dense_retrieval_torch.analysis import lang_factors as port_lf
from codemix_dense_retrieval_torch.cli import main as port_main
from codemix_dense_retrieval_tpu.analysis import ablation as ref_abl
from codemix_dense_retrieval_tpu.analysis import collect as ref_col
from codemix_dense_retrieval_tpu.analysis import lang_factors as ref_lf
from codemix_dense_retrieval_tpu.cli import main as ref_main
from tests.torch_results_tree import build_results_tree


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return build_results_tree(tmp_path_factory.mktemp("tree"))


@pytest.mark.parametrize("flags", [[], ["--reference_format"], ["--ablation"], ["--ablation", "--reference_format"]],
                         ids=["plain", "reference_format", "ablation", "ablation_reference_format"])
def test_collect_cli_csvs_are_byte_equal(tree, tmp_path, flags, capsys):
    ref_main(["collect", "--results_root", str(tree), "--out", str(tmp_path / "ref" / "results.csv"), *flags])
    port_main(["collect", "--results_root", str(tree), "--out", str(tmp_path / "port" / "results.csv"), *flags])
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == ["results.csv", "results_processed.csv"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for name in names:
        want = (tmp_path / "ref" / name).read_bytes()
        assert len(want.splitlines()) > 2, name
        assert (tmp_path / "port" / name).read_bytes() == want, name


def test_collected_rows_and_summaries_equal(tree):
    rows = port_col.collect_results(tree)
    assert rows == ref_col.collect_results(tree)
    assert any("perquery" in r for r in rows) and any("certified_frac" in r for r in rows)
    assert {r["mix_mode"] for r in rows} == {"embed", "word"}
    assert port_col.compute_summary(rows) == ref_col.compute_summary(rows)
    assert port_col.reference_format_rows(rows) == ref_col.reference_format_rows(rows)
    assert port_col.compute_reference_summary(rows) == ref_col.compute_reference_summary(rows)


def test_ablation_rows_and_summaries_equal(tree):
    rows = port_abl.collect_ablation_results(tree)
    assert rows and rows == ref_abl.collect_ablation_results(tree)
    assert port_abl.compute_ablation_summary(rows) == ref_abl.compute_ablation_summary(rows)
    for dir_name in ("vector_mix", None):
        ref_rows = port_abl.reference_format_ablation_rows(tree, dir_name)
        assert ref_rows and ref_rows == ref_abl.reference_format_ablation_rows(tree, dir_name)
        assert (port_abl.compute_reference_ablation_summary(ref_rows)
                == ref_abl.compute_reference_ablation_summary(ref_rows))


@pytest.mark.parametrize("name", [
    "mmarco-100000-bilingual-en-zh-composition-5bands-bge-m3", "mmarco-100000-mono-zh-id-zh-hub-5bands-me5",
    "mmarco-1000-chinese-en-zh-5bands-multilingual-e5-large-instruct-r2", "mmarco-1000-x", "a-b-c",
    "mmarco-1000-english-en-ar-5bands-gte-multilingual-base",
])
def test_parse_ablation_dirname(name):
    assert port_abl.parse_ablation_dirname(name) == ref_abl.parse_ablation_dirname(name)


@pytest.mark.parametrize("stem", ["cm-alpha-0.5", "cm-alpha-1_base", "cm-alpha-0.25_raw", "cm40-60", "cm0",
                                  "cm100_base", "queries", "cm-alpha-x"])
def test_mix_ratio_from_runstem(stem):
    assert port_col.mix_ratio_from_runstem(stem) == ref_col.mix_ratio_from_runstem(stem)


def test_bootstrap_delta_ci_is_seeded_like_jax():
    rng = random.Random(3)
    a = {f"q{i}": rng.random() for i in range(40)}
    b = {f"q{i}": rng.random() for i in range(5, 45)}
    assert port_col.bootstrap_delta_ci(a, b) == ref_col.bootstrap_delta_ci(a, b)


def _all_pairs():
    codes = sorted(ref_lf.LANG_INFO)
    return [f"{a.upper()}-{b.upper()}" for a in codes for b in codes if a != b] + ["EN-XX", "bad"]


@pytest.mark.parametrize("pair", _all_pairs()[::7])
def test_lang_factors(pair):
    assert port_lf.pair_factors(pair) == ref_lf.pair_factors(pair)
    assert port_lf.reference_pair_factors(pair) == ref_lf.reference_pair_factors(pair)
