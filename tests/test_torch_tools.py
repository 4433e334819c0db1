"""The port's tool commands and small utilities against the JAX package's:
``convert [--weight_quant]`` (params.npz entries byte-equal to the JAX
command's, the converted checkpoint loading quantized in both packages),
``convert`` of a Qwen3 checkpoint (a family the JAX command does not
take), ``cache-queries`` (ids equal, vectors within 1e-5 abs, f32 on the
CPU), ``profile`` and ``tune --dry_run`` on ``--device cpu``, and seeding,
version and the torch.save checkpoint of a quantized tree."""

import json
import random

import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.cli import main as port_main
from codemix_dense_retrieval_torch.models import checkpoint as port_ckpt
from codemix_dense_retrieval_torch.models import qwen3 as port_qwen3
from codemix_dense_retrieval_torch.models.encoder import build_model
from codemix_dense_retrieval_torch.models.registry import load_encoder
from codemix_dense_retrieval_torch.ops import weight_quant as port_wq
from codemix_dense_retrieval_torch.pipeline.query_cache import load_query_cache
from codemix_dense_retrieval_torch.utils import autotune
from codemix_dense_retrieval_tpu.cli import main as ref_main
from codemix_dense_retrieval_tpu.models.encoder import TextEncoder as RefTextEncoder

ATOL = 1e-5
H, F, VOCAB, MAXPOS = 256, 512, 120, 66  # hidden 256: every Linear reaches the 65,536 threshold
QUERIES = [("q1", "what is a tuned store"), ("q2", "kurz"), ("q3", "a longer query about many things here")]


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
        (0.05 * rng.standard_normal(s) + (1.0 if k.endswith("LayerNorm.weight") else 0.0)).astype(np.float32))
        for k, s in shapes.items()}
    path.mkdir(parents=True)
    torch.save(sd, path / "pytorch_model.bin")
    (path / "config.json").write_text(json.dumps({
        "model_type": "xlm-roberta", "vocab_size": VOCAB, "hidden_size": H, "num_hidden_layers": 1,
        "num_attention_heads": 4, "intermediate_size": F, "max_position_embeddings": MAXPOS,
        "type_vocab_size": 1, "pad_token_id": 1, "layer_norm_eps": 1e-5}))
    return path


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    return _hf_xlmr_dir(tmp_path_factory.mktemp("hf") / "xlmr")


def _npz_entries(path):
    with np.load(path) as data:
        return [(n, data[n].dtype.str, data[n].shape, data[n].tobytes()) for n in data.files]


@pytest.mark.parametrize("wq", [None, "int8", "nf4"])
def test_convert_npz_equals_jax_and_loads_quantized(hf_dir, tmp_path, wq):
    flag = ["--weight_quant", wq] if wq else []
    ref_main(["convert", "--src", str(hf_dir), "--out", str(tmp_path / "ref"), *flag])
    port_main(["convert", "--src", str(hf_dir), "--out", str(tmp_path / "port"), *flag])
    ref_e, port_e = _npz_entries(tmp_path / "ref" / "params.npz"), _npz_entries(tmp_path / "port" / "params.npz")
    assert port_e == ref_e
    assert any("@wq." in e[0] for e in port_e) == bool(wq)
    ref_cfg = json.loads((tmp_path / "ref" / "encoder_config.json").read_text())
    port_cfg = json.loads((tmp_path / "port" / "encoder_config.json").read_text())
    assert port_cfg.pop("dtype") == "float32" and ref_cfg.pop("dtype")
    assert port_cfg == ref_cfg
    # each package loads the other's converted dir, quantized as stored
    port = load_encoder("BAAI/bge-m3", str(tmp_path / "ref"), device="cpu")
    ref = RefTextEncoder.from_checkpoint("BAAI/bge-m3", tmp_path / "port")
    assert port.weight_quant == ref.weight_quant == ("pre-quantized" if wq else None)
    texts = [t for _, t in QUERIES]
    np.testing.assert_allclose(port.encode_queries(texts), ref.encode_queries(texts), atol=ATOL, rtol=0)


def test_convert_qwen3_checkpoint_loads_like_the_in_memory_quantization(tmp_path):
    cfg = port_qwen3.Qwen3Config.tiny(vocab_size=VOCAB, hidden_size=H, num_heads=4, num_kv_heads=2, head_dim=64,
                                      intermediate_size=F, max_position_embeddings=128)
    with torch.device("meta"):
        module = port_qwen3.Qwen3Encoder(cfg)
    model = build_model(cfg, torch.device("cpu"), seed=3, model=module)
    src = tmp_path / "hf"
    src.mkdir()
    torch.save({f"model.{k}": v for k, v in model.state_dict().items()}, src / "pytorch_model.bin")
    (src / "config.json").write_text(json.dumps({
        "model_type": "qwen3", "vocab_size": VOCAB, "hidden_size": H, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 64, "intermediate_size": F,
        "rope_theta": cfg.rope_theta, "max_position_embeddings": 128}))
    name = "Qwen/Qwen3-Embedding-0.6B"
    port_main(["convert", "--encoder", name, "--src", str(src), "--out", str(tmp_path / "nf4"),
               "--weight_quant", "nf4"])
    assert json.loads((tmp_path / "nf4" / "encoder_config.json").read_text())["model_type"] == "qwen3"
    pre = load_encoder(name, str(tmp_path / "nf4"), device="cpu")
    mem = load_encoder(name, str(src), weight_quant="nf4", device="cpu")
    assert type(pre.model).__name__ == "Qwen3Encoder" and pre.weight_quant == "pre-quantized"
    assert mem.weight_quant == "nf4"
    texts = [t for _, t in QUERIES]
    assert np.array_equal(pre.encode_documents(texts), mem.encode_documents(texts))
    assert (tmp_path / "nf4" / "params.npz").stat().st_size < 0.6 * (src / "pytorch_model.bin").stat().st_size


@pytest.mark.parametrize("wq", [None, "int8"])
def test_cache_queries_matches_jax(hf_dir, tmp_path, wq):
    from codemix_dense_retrieval_torch.io.tsv import write_queries_tsv

    write_queries_tsv(tmp_path / "en.tsv", QUERIES)
    write_queries_tsv(tmp_path / "zh.tsv", [QUERIES[2], ("q9", "only here"), QUERIES[0]])
    common = ["--checkpoint", str(hf_dir), "--query_tsv", f"en={tmp_path / 'en.tsv'}",
              f"zh={tmp_path / 'zh.tsv'}", *(["--weight_quant", wq] if wq else [])]
    ref_main(["cache-queries", *common, "--cache_root", str(tmp_path / "ref")])
    port_main(["cache-queries", *common, "--cache_root", str(tmp_path / "port"), "--device", "cpu"])
    for lang in ("en", "zh"):
        want_ids, want = load_query_cache(tmp_path / "ref" / lang / "queries.npz")
        got_ids, got = load_query_cache(tmp_path / "port" / lang / "queries.npz")
        assert list(got_ids) == list(want_ids) == ["q1", "q3"]  # the two TSVs' shared qids
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_weight_quant_on_encode_corpus_and_run_mix(tmp_path, capsys):
    """--weight_quant on the corpus and search commands (smoke model at
    hidden 256, so its Linear kernels are quantized)."""
    from codemix_dense_retrieval_torch.io.shards import ShardStore
    from codemix_dense_retrieval_torch.io.tsv import write_queries_tsv

    (tmp_path / "c.tsv").write_text("".join(f"d{i}\tpassage number {i} text\n" for i in range(12)))
    common = ["--device", "cpu", "--smoke_dim", "256", "--weight_quant", "int8"]
    port_main(["encode-corpus", *common, "--corpus_tsv", f"xx={tmp_path / 'c.tsv'}", "--out", str(tmp_path / "ix")])
    assert ShardStore.open(tmp_path / "ix" / "xx").count == 12
    write_queries_tsv(tmp_path / "a.tsv", QUERIES)
    port_main(["run-mix", *common, "--index", str(tmp_path / "ix" / "xx"), "--k", "5", "--cm_alphas", "0.5",
               "--query_tsv", f"en={tmp_path / 'a.tsv'}", f"zh={tmp_path / 'a.tsv'}", "--outdir", str(tmp_path / "r")])
    assert len((tmp_path / "r" / "cm-alpha-0.5.trec").read_text().splitlines()) == 3 * 5


def test_profile_on_the_cpu(tmp_path, capsys):
    port_main(["profile", "--device", "cpu", "--docs", "4096", "--dim", "32", "--queries", "16", "--k", "10",
               "--iters", "2", "--trace_dir", str(tmp_path)])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"mean_s", "iters", "queries", "k", "docs", "qps", "trace_dir"} <= set(stats)
    assert stats["docs"] == 4096 and stats["iters"] == 2 and stats["qps"] > 0 and stats["device"] == "cpu"
    trace = json.loads((tmp_path / "search" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_tune_dry_run_and_store_on_the_cpu(tmp_path, monkeypatch, capsys):
    from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex

    store = tmp_path / "tuned.json"
    monkeypatch.setenv("CDR_TUNE_FILE", str(store))
    autotune.invalidate_cache()
    argv = ["tune", "--device", "cpu", "--rows", "2048", "--dim", "32", "--batch", "8", "--ks", "16",
            "--iters", "1", "--skip_flash"]
    port_main([*argv, "--dry_run"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["tune_file"] is None and out["topk.qps.k16"] > 0 and not store.exists()
    rows = np.random.default_rng(2).standard_normal((4096, 32)).astype(np.float32)
    DenseFlatIndex.build(rows, [f"d{i}" for i in range(4096)]).save(tmp_path / "ix")
    port_main([*argv, "--sketch_index", str(tmp_path / "ix"), "--sketch_dim", "16", "--adaptive"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["tune_file"] == str(store)
    assert json.loads(store.read_text())["topk.super_size.k16"] == out["topk.super_size.k16"]
    assert {"probe_bins", "recall"} <= set(out["sketch"]["16"]) and out["adaptive"]["16"]
    autotune.invalidate_cache()


def test_seeding_matches_jax_and_seeds_torch():
    from codemix_dense_retrieval_torch.utils.seeding import seed_everything
    from codemix_dense_retrieval_tpu.utils.seeding import seed_everything as ref_seed

    ref_rng = ref_seed(7)
    want = (random.random(), np.random.rand(), ref_rng.standard_normal(3))
    rng = seed_everything(7)
    got = (random.random(), np.random.rand(), rng.standard_normal(3))
    assert got[0] == want[0] and got[1] == want[1] and np.array_equal(got[2], want[2])
    a = torch.rand(4)
    seed_everything(7)
    assert torch.equal(torch.rand(4), a)


def test_version_matches_jax():
    from codemix_dense_retrieval_torch.version import __version__
    from codemix_dense_retrieval_tpu.version import __version__ as ref_version

    assert __version__ == ref_version


def test_checkpoint_round_trip_with_quantized_leaves(tmp_path):
    rng = np.random.default_rng(5)
    tree = {"params": {
        "layer_0": {"ffn_in": {"kernel": rng.standard_normal((256, 300)).astype(np.float32),
                               "bias": rng.standard_normal(300).astype(np.float32)},
                    "q": {"kernel": rng.standard_normal((256, 256)).astype(np.float32)}},
        "embeddings": {"word_embeddings": {"embedding": rng.standard_normal((50, 256)).astype(np.float32)}},
    }}
    tree["params"]["layer_0"]["q"] = port_wq.quantize_tree(tree["params"]["layer_0"]["q"], "int8")
    tree["params"]["layer_0"]["ffn_in"] = port_wq.quantize_tree(tree["params"]["layer_0"]["ffn_in"], "nf4")
    port_ckpt.save_params(tmp_path / "ck" / "params.pt", tree)
    back = port_ckpt.load_params(tmp_path / "ck" / "params.pt")
    for layer, kind in (("q", "int8"), ("ffn_in", "nf4")):
        want, got = tree["params"]["layer_0"][layer]["kernel"], back["params"]["layer_0"][layer]["kernel"]
        assert isinstance(got, port_wq.QuantizedTensor) and got.kind == kind and got.shape == want.shape
        assert got.codes.tobytes() == want.codes.tobytes() and got.scale.tobytes() == want.scale.tobytes()
    np.testing.assert_array_equal(back["params"]["layer_0"]["ffn_in"]["bias"], tree["params"]["layer_0"]["ffn_in"]["bias"])
    np.testing.assert_array_equal(back["params"]["embeddings"]["word_embeddings"]["embedding"],
                                  tree["params"]["embeddings"]["word_embeddings"]["embedding"])
    assert port_wq.quantized_nbytes(back) == port_wq.quantized_nbytes(tree)
