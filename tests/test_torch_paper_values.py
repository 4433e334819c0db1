"""The port's ``analysis/paper_values.py`` against the JAX package's: the
``paper-values`` report of both CLIs over a results tree made by the port on
the CPU is byte for byte equal at ``--n_boot 50`` (every resampling is
seeded), and so are the statistics helpers on seeded inputs."""

import random

import pytest

from codemix_dense_retrieval_torch.analysis import collect as port_col
from codemix_dense_retrieval_torch.analysis import paper_values as port_pv
from codemix_dense_retrieval_torch.cli import main as port_main
from codemix_dense_retrieval_tpu.analysis import paper_values as ref_pv
from codemix_dense_retrieval_tpu.cli import main as ref_main
from tests.torch_results_tree import build_results_tree


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return build_results_tree(tmp_path_factory.mktemp("tree"), seed=11)


@pytest.fixture(scope="module")
def collected(tree):
    rows = port_col.collect_results(tree)
    return rows, port_col.compute_summary(rows)


def test_paper_values_cli_report_is_byte_equal(tree, tmp_path, capsys):
    ref_main(["paper-values", "--results_root", str(tree), "--out", str(tmp_path / "ref.txt"), "--n_boot", "50"])
    port_main(["paper-values", "--results_root", str(tree), "--out", str(tmp_path / "port.txt"), "--n_boot", "50"])
    want = (tmp_path / "ref.txt").read_bytes()
    assert len(want.splitlines()) > 40
    assert (tmp_path / "port.txt").read_bytes() == want


def test_paper_values_cli_prints_without_out(tree, capsys):
    port_main(["paper-values", "--results_root", str(tree), "--n_boot", "50"])
    got = capsys.readouterr().out
    ref_main(["paper-values", "--results_root", str(tree), "--n_boot", "50"])
    assert got and got == capsys.readouterr().out


@pytest.mark.parametrize("name", ["delta_distribution", "en_absent_split", "peak_lambda_counts", "input_coverage",
                                  "en_best_partner", "bilingual_gains", "headroom_spearman"])
def test_summary_sections_equal(collected, name):
    _, summary = collected
    assert getattr(port_pv, name)(summary) == getattr(ref_pv, name)(summary)


@pytest.mark.parametrize("name", ["endpoint_alignment", "metric_delta_sweep"])
def test_row_sections_equal(collected, name):
    rows, _ = collected
    assert getattr(port_pv, name)(rows) == getattr(ref_pv, name)(rows)


def test_language_factor_probes_equal(collected):
    _, summary = collected
    assert port_pv.language_factor_probes(summary, n_boot=50) == ref_pv.language_factor_probes(summary, n_boot=50)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_statistics_helpers_equal(seed):
    rng = random.Random(seed)
    x = [rng.gauss(0, 1) for _ in range(30)]
    y = [v + rng.gauss(0, 0.5) for v in x]
    groups = {g: [rng.gauss(i, 1) for _ in range(8)] for i, g in enumerate("abc")}
    assert port_pv.spearman_rho(x, y) == ref_pv.spearman_rho(x, y)
    assert port_pv.perm_spearman(x, y, n_perm=200) == ref_pv.perm_spearman(x, y, n_perm=200)
    assert port_pv.anova_f(groups) == ref_pv.anova_f(groups)
    assert port_pv.perm_anova(groups, n_perm=200) == ref_pv.perm_anova(groups, n_perm=200)
    assert port_pv.eta_squared(groups) == ref_pv.eta_squared(groups)
    assert port_pv.omega_squared(groups) == ref_pv.omega_squared(groups)
    assert port_pv.quantile(sorted(x), 0.9) == ref_pv.quantile(sorted(x), 0.9)
