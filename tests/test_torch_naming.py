"""The port's ``io/naming.py`` against the JAX package's: every parser on
the names the JAX suite uses, on the names the plan builders emit, and on
malformed names (exact equality: both are string parsers)."""

import dataclasses

import pytest

from codemix_dense_retrieval_torch.io import naming as port
from codemix_dense_retrieval_torch.orchestrate import plans as port_plans
from codemix_dense_retrieval_tpu.io import naming as ref


def _plan_dirnames():
    plan = port_plans.build_all_pairs_plan(index_root="ix", query_tsv_root="q", result_root="r")
    return sorted({j["outdir"].split("/")[-2] for j in plan["jobs"]})


DIRNAMES = [
    "mmarco-8841823-chinese-en-zh-5bands-bge-m3",
    "mmarco-100000-bilingual-en-zh-5bands-bge-m3",
    "mmarco-1000-arabic-ar-zh-5bands-multilingual-e5-large",
    "mmarco-100000-english-en-zh-3bands-qwen3-embedding-0.6b",
    "not-an-experiment",
    "mmarco-100-Chinese-en-zh-5bands-bge-m3",
    "mmarco-x-chinese-en-zh-5bands-bge-m3",
    "mmarco-100-chinese-eng-zh-5bands-bge-m3",
    "",
    *_plan_dirnames()[:12],
]
STEMS = [
    "cm-alpha-0.5_dev_20260118-184044", "nounderscore", "cm20-40_base_dev_20260101-000000",
    "cm-alpha-1_base_test_20251231-235959", "cm0_dev_2026011-184044", "run_dev_20260118-18404",
    "a_b_c_dev_20260118-184044",
]
ENCODERS = ["BAAI/bge-m3", "intfloat/multilingual-e5-large", "Qwen/Qwen3-Embedding-0.6B/", "plain", ""]


def _as_tuple(x):
    return None if x is None else (dataclasses.astuple(x), x.is_bilingual, x.doc_langs, x.dirname())


@pytest.mark.parametrize("name", DIRNAMES)
def test_parse_experiment_dirname(name):
    assert _as_tuple(port.parse_experiment_dirname(name)) == _as_tuple(ref.parse_experiment_dirname(name))


@pytest.mark.parametrize("stem", STEMS)
def test_parse_eval_stem(stem):
    assert port.parse_eval_stem(stem) == ref.parse_eval_stem(stem)


@pytest.mark.parametrize("name", ENCODERS)
def test_encoder_tag(name):
    assert port.encoder_tag(name) == ref.encoder_tag(name)


def test_language_tables():
    assert port.LANG_NAMES == ref.LANG_NAMES
    assert port.LANG_CODES == ref.LANG_CODES


@pytest.mark.parametrize("args", [
    ("mmarco", 8841823, "chinese", "en", "zh", "bge-m3"),
    ("mmarco", 100000, "bilingual-en-zh", "en", "zh", "bge-m3", 3),
])
def test_experiment_name_roundtrip(args):
    got, want = port.ExperimentName(*args), ref.ExperimentName(*args)
    assert _as_tuple(got) == _as_tuple(want)
    assert _as_tuple(port.parse_experiment_dirname(got.dirname())) == _as_tuple(got)
