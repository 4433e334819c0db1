"""The port's ``datagen/`` against the JAX package's: ``lexid`` and
``mix_ratio`` on the same tokens and texts (exact: host string code),
band generation with the JAX suite's fake generator and with fake OpenAI
clients (the same band files byte for byte, through the library and
through both ``generate-bands`` CLIs, both protocols), and
``download-queries`` with a fake ``datasets.load_dataset`` (the same TSVs).
No test reaches the network: ``openai`` and ``datasets`` are stubbed in
``sys.modules``."""

import json
import re
import sys
import types

import numpy as np
import pytest

from codemix_dense_retrieval_torch.cli import main as port_main
from codemix_dense_retrieval_torch.datagen import bands as port_bands
from codemix_dense_retrieval_torch.datagen import lexid as port_lexid
from codemix_dense_retrieval_torch.datagen import mix_count as port_mc
from codemix_dense_retrieval_torch.io.tsv import write_queries_tsv
from codemix_dense_retrieval_tpu.cli import main as ref_main
from codemix_dense_retrieval_tpu.datagen import bands as ref_bands
from codemix_dense_retrieval_tpu.datagen import lexid as ref_lexid
from codemix_dense_retrieval_tpu.datagen import mix_count as ref_mc

LANGS = ("en", "fr", "es", "pt", "it", "de", "nl", "id", "vi")
TOKENS = ["the", "le", "el", "não", "straße", "zione", "của", "dan", "het", "nación", "keit", "word", "über",
          "qualità", "yang", "và", "des", "los", "xyz", "Été"]
TEXTS = [
    "where do black widow spiders live", "黑寡妇蜘蛛住在哪里", "Where do black widow 蜘蛛 live in the US",
    "see https://example.com/page 42 100% items", "hello мир", "hello مرحبا", "quelle est la capitale de France",
    "what is la capital de España", "wie funktioniert die Übersetzung", "42 100%", "",
    "東京 タワー とは what", "chi è il presidente della república",
]
PAIRS = [("en", "zh"), ("en", "fr"), ("es", "pt"), ("de", "nl"), ("en", "ru"), ("en", "ar"), ("id", "vi"),
         ("ja", "en"), ("it", "es")]


@pytest.mark.parametrize("a,b", [(a, b) for a in LANGS for b in LANGS if a < b][::3])
def test_lexid_classify_pair(a, b):
    got = [port_lexid.classify_pair(t, a, b) for t in TOKENS]
    assert got == [ref_lexid.classify_pair(t, a, b) for t in TOKENS]
    clf_p, clf_r = port_lexid.default_pair_classifier(a, b), ref_lexid.default_pair_classifier(a, b)
    assert [clf_p(t) for t in TOKENS] == [clf_r(t) for t in TOKENS]


@pytest.mark.parametrize("a,b", PAIRS)
def test_mix_ratio_and_counts(a, b):
    for text in TEXTS:
        assert port_mc.mix_ratio(text, a, b) == ref_mc.mix_ratio(text, a, b), text
        assert port_mc.count_two_langs(text, a, b) == ref_mc.count_two_langs(text, a, b), text
        assert port_mc.tokenize(text) == ref_mc.tokenize(text)


def fake_generator(en_text, zh_text, targets, k):
    """The JAX suite's deterministic candidates: a fraction of EN words
    swapped to Han characters."""
    en_words = en_text.split()
    out = []
    for t in targets:
        for j in range(k):
            n_zh = max(0, min(len(en_words), round(len(en_words) * t / 100.0) + (j % 2)))
            out.append(" ".join(["中"] * n_zh + en_words[n_zh:]))
    return out


def fake_band_fn(en_text, zh_text, labels, k_map, attempt):
    """Honours K: the last K EN words become the last K ZH words."""
    en_words, zh_words = en_text.split(), zh_text.split()
    return {lab: " ".join(en_words[: len(en_words) - k_map[lab]] + zh_words[len(zh_words) - k_map[lab]:])
            for lab in labels}


def _pairs(n=7, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        m = int(rng.integers(4, 12))
        out.append((f"q{i}", " ".join(f"word{int(w)}" for w in rng.integers(0, 50, m)),
                    " ".join("一二三四五六七八九十"[int(w)] for w in rng.integers(0, 10, m))))
    return out


def _same_tree(want, got):
    names = sorted(p.name for p in want.iterdir())
    assert names and sorted(p.name for p in got.iterdir()) == names
    for name in names:
        assert (got / name).read_bytes() == (want / name).read_bytes(), name
    return names


@pytest.mark.parametrize("kadapt", [False, True])
def test_generate_band_dataset_same_files(tmp_path, kadapt):
    gen = fake_band_fn if kadapt else fake_generator
    pairs = _pairs()
    s_p = port_bands.generate_band_dataset(pairs, tmp_path / "port", gen, kadapt=kadapt, checkpoint_every=2)
    s_r = ref_bands.generate_band_dataset(pairs, tmp_path / "ref", gen, kadapt=kadapt, checkpoint_every=2)
    assert s_p.common_qids() == s_r.common_qids()
    names = _same_tree(tmp_path / "ref", tmp_path / "port")
    assert "qids-common.tsv" in names

    def explode(*args):
        raise AssertionError("resume must not generate again")

    assert port_bands.generate_band_dataset(pairs, tmp_path / "port", explode, kadapt=kadapt).common_qids() \
        == s_p.common_qids()


@pytest.mark.parametrize("ratio", [0.0, 19.9, 20.0, 55.0, 100.0, 150.0, -1.0])
def test_band_helpers(ratio):
    assert port_bands.band_of(ratio, port_bands.DEFAULT_BANDS) == ref_bands.band_of(ratio, ref_bands.DEFAULT_BANDS)
    lo, hi = 40, 60
    for n in (1, 5, 10):
        assert port_bands.initial_k_for_band(lo, hi, n) == ref_bands.initial_k_for_band(lo, hi, n)
        assert port_bands.adjust_k(3, ratio, lo, hi, n) == ref_bands.adjust_k(3, ratio, lo, hi, n)
    assert port_bands.build_band_prompt([(0, 20), (40, 60)], {"0-20": 1, "40-60": 5}, 10) \
        == ref_bands.build_band_prompt([(0, 20), (40, 60)], {"0-20": 1, "40-60": 5}, 10)


class _Usage:
    prompt_tokens, completion_tokens = 11, 7


class _FakeOpenAI:
    """``openai.OpenAI`` offline: the Responses API answers the band
    protocol's JSON from the prompt's word budgets, the chat API the
    multi-candidate protocol's lines; ``fail_responses`` makes every
    Responses call fail, so the chat fallback answers."""

    fail_responses = False

    def __init__(self, api_key=None):
        outer = self

        class Responses:
            @staticmethod
            def create(**kw):
                if outer.fail_responses:
                    raise RuntimeError("server exploded")
                text = kw["input"][0]["content"][0]["text"]
                return types.SimpleNamespace(output_text=outer._bands(kw["instructions"], text), usage=_Usage())

        class Completions:
            @staticmethod
            def create(**kw):
                if "response_format" in kw:
                    raise RuntimeError("unsupported_parameter: response_format")
                msgs = kw["messages"]
                content = (outer._bands(msgs[0]["content"], msgs[1]["content"]) if len(msgs) == 2
                           else outer._multi(msgs[0]["content"]))
                choice = types.SimpleNamespace(message=types.SimpleNamespace(content=content))
                return types.SimpleNamespace(choices=[choice], usage=_Usage())

        self.responses = Responses()
        self.chat = types.SimpleNamespace(completions=Completions())

    @staticmethod
    def _bands(prompt, user_text):
        en = re.search(r"EN: (.*)", user_text).group(1).split()
        zh = re.search(r"ZH: (.*)", user_text).group(1).split()
        out = {}
        for lab, keep in re.findall(r'"(\d+-\d+)": keep exactly (\d+)', prompt):
            k = len(en) - int(keep)
            out[lab] = " ".join(en[: len(en) - k] + zh[len(zh) - k:])
        return "noise " + json.dumps(out, ensure_ascii=False)

    @staticmethod
    def _multi(prompt):
        en = re.search(r"English: (.*)", prompt).group(1)
        k = int(re.search(r"Produce (\d+)", prompt).group(1))
        targets = [float(t) for t in re.findall(r"(\d+)%", prompt.split("percentages:")[1])]
        return "\n".join(fake_generator(en, "", targets, k))


@pytest.fixture
def fake_openai(monkeypatch):
    mod = types.ModuleType("openai")
    mod.OpenAI = _FakeOpenAI
    monkeypatch.setitem(sys.modules, "openai", mod)
    monkeypatch.setattr(_FakeOpenAI, "fail_responses", False)
    return _FakeOpenAI


@pytest.mark.parametrize("protocol,fail_responses", [("kadapt", False), ("kadapt", True), ("multi", False)])
def test_generate_bands_cli_same_files(tmp_path, capsys, monkeypatch, fake_openai, protocol, fail_responses):
    monkeypatch.setattr(fake_openai, "fail_responses", fail_responses)
    for mod in (port_bands, ref_bands):  # the backoff between retried calls
        monkeypatch.setattr(mod, "_retrying", lambda call, attempts=6, max_backoff=20.0, _r=mod._retrying:
                            _r(call, attempts=2, max_backoff=0.0))
    pairs = _pairs(5, seed=3)
    write_queries_tsv(tmp_path / "en.tsv", [(q, e) for q, e, _ in pairs])
    write_queries_tsv(tmp_path / "zh.tsv", [(q, z) for q, _, z in pairs[::-1]])
    common = ["--en", str(tmp_path / "en.tsv"), "--zh", str(tmp_path / "zh.tsv"), "--protocol", protocol,
              "--max_queries", "4", "--bands", "0-20", "20-40", "40-60", "60-80", "80-100"]
    ref_main(["generate-bands", *common, "--out_dir", str(tmp_path / "ref")])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    port_main(["generate-bands", *common, "--out_dir", str(tmp_path / "port")])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.pop("out_dir").endswith("port") and want.pop("out_dir").endswith("ref")
    assert got == want and got["queries"] == 4 and got["calls"] > 0
    names = _same_tree(tmp_path / "ref", tmp_path / "port")
    assert {"queries-cm0.tsv", "queries-cm100.tsv", "queries-cm40-60.tsv"} <= set(names)


def _fake_datasets(monkeypatch, calls):
    def load_dataset(repo, cfg, split, streaming):
        calls.append((repo, cfg, split, streaming))
        return [{"id": 30, "text": f"third {cfg}"}, {"id": 4, "text": "fourth"}, {"id": "x7", "text": "named"},
                {"id": 100, "text": "hundredth"}]

    mod = types.ModuleType("datasets")
    mod.load_dataset = load_dataset
    monkeypatch.setitem(sys.modules, "datasets", mod)


def test_download_queries_same_tsvs(tmp_path, monkeypatch, capsys):
    calls = []
    _fake_datasets(monkeypatch, calls)
    argv = ["download-queries", "--langs", "english", "Chinese", "klingon", "--split_prefix", "q-"]
    ref_main([*argv, "--out", str(tmp_path / "ref")])
    port_main([*argv, "--out", str(tmp_path / "port")])
    assert _same_tree(tmp_path / "ref", tmp_path / "port") == ["queries.en.tsv", "queries.kl.tsv", "queries.zh.tsv"]
    assert calls[:3] == calls[3:] == [("unicamp-dl/mmarco", f"q-{lang}", "dev", True)
                                      for lang in ("english", "chinese", "klingon")]
    assert (tmp_path / "port" / "queries.en.tsv").read_text().split("\n")[0].startswith("4\t")
