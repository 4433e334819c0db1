"""pipeline/corpus.py + the encode-corpus CLI: the port and the JAX package
encode the same corpus with the same weights (carried across from the Flax
params) into stores with the same docids, the same selection, bf16 rows
within one bf16 ulp and int8 rows within one step (scales rel 1e-4): the
two encoders' f32 outputs differ by ~1e-6, which can move a value across a
rounding boundary. Resume and the CPU CLI are exercised on the port alone.
"""

import json
import pathlib
import random
import subprocess
import sys

import jax
import numpy as np
import pytest

from codemix_dense_retrieval_torch.io.shards import ShardStore as PortStore
from codemix_dense_retrieval_torch.models.encoder import TextEncoder as PortEncoder
from codemix_dense_retrieval_torch.models.xlmr import XLMRConfig as PortCfg
from codemix_dense_retrieval_torch.pipeline import corpus as port
from codemix_dense_retrieval_tpu.io.shards import ShardStore as RefStore
from codemix_dense_retrieval_tpu.models.encoder import TextEncoder as RefEncoder
from codemix_dense_retrieval_tpu.models.xlmr import XLMRConfig as RefCfg
from codemix_dense_retrieval_tpu.pipeline import corpus as ref

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=500, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            max_position_embeddings=66)


@pytest.fixture(scope="module")
def encoders():
    ref_enc = RefEncoder("BAAI/bge-m3", RefCfg.tiny(**TINY, use_flash=False), seed=3)
    params = jax.tree_util.tree_map(np.asarray, ref_enc.params)
    port_enc = PortEncoder("BAAI/bge-m3", PortCfg.tiny(**TINY, use_flash=False), params, device="cpu")
    return ref_enc, port_enc


def _corpus(tmp_path, n=40):
    rng = random.Random(0)
    paths = {}
    for lang in ("xx", "yy"):
        rows = [f"c{i}\t{lang} " + " ".join(f"w{rng.randint(0, 400)}" for _ in range(rng.randint(4, 40)))
                for i in range(n)]
        paths[lang] = tmp_path / f"{lang}.tsv"
        paths[lang].write_text("\n".join(rows) + "\n", encoding="utf-8")
    return paths


def _selection(mod):
    return mod.SelectionState(rel_ids={"c3", "c17", "c30"}, subset_neg_cap=12, neg_prob=0.6, seed=5)


def _encode(mod, enc, paths, out, dtype):
    sources = {lang: mod.TsvCorpusSource(p, lang) for lang, p in paths.items()}
    return mod.encode_corpus(enc, sources, out, selection=_selection(mod), batch_size=8,
                             enc_batch=4, storage_dtype=dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_encode_corpus_matches_jax(encoders, tmp_path, dtype):
    ref_enc, port_enc = encoders
    paths = _corpus(tmp_path)
    got_dirs = _encode(port, port_enc, paths, tmp_path / "port", dtype)
    want_dirs = _encode(ref, ref_enc, paths, tmp_path / "ref", dtype)
    assert list(got_dirs) == list(want_dirs) == ["xx", "yy"]
    for lang in ("xx", "yy"):
        got, want = PortStore.open(got_dirs[lang]), RefStore.open(want_dirs[lang])
        assert got.docids == want.docids and got.derived_ids == want.derived_ids
        assert {"c3", "c17", "c30"} <= set(got.docids) and 3 < got.count < 40
        assert got.manifest.extra == want.manifest.extra and got.manifest.lang == lang
        if dtype == "bfloat16":
            a, b = got.rows().float().numpy(), np.asarray(want.vectors, np.float32)
            ulp = np.maximum(np.abs(a), np.abs(b)) * 2.0 ** -7 + 1e-6
            assert (np.abs(a - b) <= ulp).all()
        else:
            diff = np.abs(np.asarray(got.vectors, np.int16) - np.asarray(want.vectors, np.int16))
            assert diff.max() <= 1
            np.testing.assert_allclose(got.scales, want.scales, rtol=1e-4, atol=0)
    assert (tmp_path / "port" / "docids.txt").read_text() == (tmp_path / "ref" / "docids.txt").read_text()
    got_meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    want_meta = json.loads((tmp_path / "ref" / "meta.json").read_text())
    for key in ("dtype", "langs", "subset_neg_cap", "neg_prob", "rel_ids", "dimension", "tokens_per_doc"):
        assert got_meta[key] == want_meta[key], key
    # a finished language is skipped on a second run (whole-language resume)
    again = _encode(port, port_enc, paths, tmp_path / "port", dtype)
    assert again == got_dirs
    assert (tmp_path / "port" / "docids.txt").read_text() == (tmp_path / "ref" / "docids.txt").read_text()


def test_force_re_encodes_a_finished_language_from_scratch(encoders, tmp_path):
    _, enc = encoders
    paths = _corpus(tmp_path, n=12)
    src = {"xx": port.TsvCorpusSource(paths["xx"], "xx")}
    first = port.encode_corpus(enc, src, tmp_path / "o", batch_size=5, storage_dtype="int8")["xx"]
    want = PortStore.open(first)
    port.encode_corpus(enc, src, tmp_path / "o", batch_size=5, storage_dtype="int8", force=True)
    got = PortStore.open(first)
    assert got.count == 12 and got.docids == want.docids and got.scales.shape == (12,)
    np.testing.assert_array_equal(np.asarray(got.vectors), np.asarray(want.vectors))


class _Crash(Exception):
    pass


def _crashing(source, after):
    for i, doc in enumerate(source):
        if i == after:
            raise _Crash
        yield doc


def test_mid_language_resume_truncates_the_sidecars(encoders, tmp_path):
    _, enc = encoders
    paths = _corpus(tmp_path)
    src = port.TsvCorpusSource(paths["xx"], "xx")
    fresh = port.encode_corpus(enc, {"xx": src}, tmp_path / "fresh", batch_size=10,
                               enc_batch=4, storage_dtype="int8")["xx"]
    out = tmp_path / "resumed"
    with pytest.raises(_Crash):
        port.encode_corpus(enc, {"xx": _crashing(src, 25)}, out, batch_size=10,
                           enc_batch=4, storage_dtype="int8")
    lang_dir = out / "xx"
    assert not PortStore.exists(lang_dir) and (lang_dir / "scales.bin").stat().st_size == 20 * 4
    # a crash between the sidecar writes and the row write: sidecars run one
    # batch ahead and the row file ends in a torn row
    with open(lang_dir / "scales.bin", "ab") as fh:
        fh.write(np.ones(10, np.float32).tobytes())
    with open(lang_dir / "docids.partial.txt", "a") as fh:
        fh.write("".join(f"c{i}\n" for i in range(20, 30)))
    with open(lang_dir / "emb.00000.bin", "ab") as fh:
        fh.write(b"\x01" * 7)
    writer, written = port.ShardWriter.resume_partial(lang_dir, enc.dim, "int8", lang="xx")
    assert writer.count == 20 and written == {f"c{i}" for i in range(20)}
    assert (lang_dir / "scales.bin").stat().st_size == 20 * 4
    writer._fh.close()
    port.encode_corpus(enc, {"xx": src}, out, batch_size=10, enc_batch=4, storage_dtype="int8")
    got, want = PortStore.open(lang_dir), PortStore.open(fresh)
    assert got.count == 40 and got.docids == want.docids
    np.testing.assert_array_equal(np.asarray(got.vectors), np.asarray(want.vectors))
    np.testing.assert_array_equal(got.scales, want.scales)
    assert (out / "docids.txt").read_text().split() == sorted(want.docids)


def test_cli_encode_corpus_then_run_mix_on_cpu(tmp_path):
    paths = _corpus(tmp_path, n=60)
    enc = subprocess.run(
        [sys.executable, "-m", "codemix_dense_retrieval_torch", "encode-corpus", "--device", "cpu",
         "--corpus_tsv", f"xx={paths['xx']}", "--storage_dtype", "int8", "--smoke_dim", "32",
         "--out", str(tmp_path / "ix"), "--batch", "16", "--enc_batch", "8"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert enc.returncode == 0, enc.stderr
    store_dir = pathlib.Path(json.loads(enc.stdout)["xx"])
    store = PortStore.open(store_dir)
    assert store.count == 60 and store.manifest.dtype == "int8" and store.scales.shape == (60,)
    for lang, text in (("en", "w1 w2 w3"), ("zh", "w3 w9")):
        (tmp_path / f"{lang}.tsv").write_text("".join(f"q{i}\t{text} w{i}\n" for i in range(5)))
    run = subprocess.run(
        [sys.executable, "-m", "codemix_dense_retrieval_torch", "run-mix", "--device", "cpu",
         "--index", str(store_dir), "--smoke_dim", "32", "--k", "7", "--cm_alphas", "0", "0.5",
         "--query_tsv", f"en={tmp_path / 'en.tsv'}", f"zh={tmp_path / 'zh.tsv'}",
         "--outdir", str(tmp_path / "runs")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert run.returncode == 0, run.stderr
    lines = (tmp_path / "runs" / "cm-alpha-0.5.trec").read_text().splitlines()
    assert len(lines) == 5 * 7 and all(line.split("\t")[2].endswith("#xx") for line in lines)


def test_cli_run_mono_over_an_int8_store_on_cpu(tmp_path):
    from codemix_dense_retrieval_torch.cli import main
    from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex

    rng = np.random.default_rng(8)
    DenseFlatIndex.build(rng.standard_normal((300, 32)).astype(np.float32),
                         [f"d{i}" for i in range(300)], dtype="int8").save(tmp_path / "ix")
    bands = tmp_path / "bands"
    bands.mkdir()
    (bands / "queries-cm0-20.tsv").write_text("".join(f"q{i}\tband query {i}\n" for i in range(4)))
    main(["run-mono", "--device", "cpu", "--index", str(tmp_path / "ix"), "--smoke_dim", "32",
          "--k", "6", "--queries", str(bands), "--outdir", str(tmp_path / "runs")])
    lines = (tmp_path / "runs" / "cm0-20.trec").read_text().splitlines()
    assert len(lines) == 4 * 6


def test_hf_source_without_datasets_says_what_to_do(monkeypatch):
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(RuntimeError, match="datasets.*--corpus_tsv"):
        next(iter(port.HFCorpusSource("unicamp-dl/mmarco", "collection-english")))


@pytest.mark.parametrize("kw,item", [pytest.param({"pack": True}, "sequence packing",
                                                  id="kw1-sequence packing")])
def test_unported_options_raise_naming_the_roadmap(encoders, tmp_path, kw, item):
    """Sequence packing is ported: ``pack=True`` no longer raises, and its
    store holds the unpacked encode's docids and rows (the packed forward
    sums in another order: rtol 5e-4 / atol 5e-5, as the JAX suite)."""
    _, enc = encoders
    got = port.encode_corpus(enc, {"xx": port.SyntheticCorpusSource(12)}, tmp_path / "packed",
                             storage_dtype="float32", **kw)
    want = port.encode_corpus(enc, {"xx": port.SyntheticCorpusSource(12)}, tmp_path / "plain",
                              storage_dtype="float32")
    a, b = PortStore.open(got["xx"]), PortStore.open(want["xx"])
    assert a.docids == b.docids and a.count == 12
    np.testing.assert_allclose(np.asarray(a.vectors), np.asarray(b.vectors), rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("flag", [pytest.param(["--dp", "2", "--weight_quant", "int8"], id="flag1")])
def test_cli_encode_corpus_refuses_unported_flags(tmp_path, flag):
    """``--dp`` is ported: ``encode-corpus --device cpu --dp 2`` runs and
    writes the one-device store bit for bit."""
    from codemix_dense_retrieval_torch.cli import main

    paths = _corpus(tmp_path, n=30)
    common = ["encode-corpus", "--device", "cpu", "--corpus_tsv", f"xx={paths['xx']}", "--smoke_dim", "32",
              "--batch", "16", "--enc_batch", "8"]
    main(common + ["--out", str(tmp_path / "one")])
    main(common + ["--out", str(tmp_path / "dp"), *flag])
    one, dp = PortStore.open(tmp_path / "one" / "xx"), PortStore.open(tmp_path / "dp" / "xx")
    assert dp.count == 30 and dp.docids == one.docids
    np.testing.assert_array_equal(np.asarray(dp.vectors), np.asarray(one.vectors))


def test_synthetic_source_matches_jax():
    assert list(port.SyntheticCorpusSource(7, "zh", seed=3)) == list(ref.SyntheticCorpusSource(7, "zh", seed=3))
