"""models/: the weight carry (Flax params -> port state dict), the HF
state-dict converter, the hash tokenizer and TextEncoder, each against the
JAX package on the same numpy inputs (f32, tolerance 1e-5 abs)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.models import convert as port_convert
from codemix_dense_retrieval_torch.models import encoder as port_encoder
from codemix_dense_retrieval_torch.models import tokenizer as port_tok
from codemix_dense_retrieval_torch.models import xlmr as port_xlmr
from codemix_dense_retrieval_tpu.models import convert as ref_convert
from codemix_dense_retrieval_tpu.models import encoder as ref_encoder
from codemix_dense_retrieval_tpu.models import tokenizer as ref_tok
from codemix_dense_retrieval_tpu.models import xlmr as ref_xlmr

ATOL = 1e-5
TINY = dict(vocab_size=120, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=66)


def _ids(seed, b=3, s=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 119, size=(b, s)).astype(np.int32)
    ids[:, 0] = 0
    mask = np.ones((b, s), np.int32)
    for i, n in enumerate([s, s - 4, 5][:b]):
        ids[i, n:] = 1
        mask[i, n:] = 0
    return ids, mask


@pytest.fixture(scope="module")
def flax_params():
    cfg = ref_xlmr.XLMRConfig.tiny(**TINY, use_flash=False)
    ids, mask = _ids(0)
    params = ref_xlmr.XLMREncoder(cfg).init(jax.random.key(0), jnp.asarray(ids), jnp.asarray(mask))
    # random (not zero) biases and LayerNorm params so every leaf is exercised
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32),
        params,
    )


def _port_model(params, pooling="cls"):
    cfg = port_xlmr.XLMRConfig.tiny(**TINY, pooling=pooling, use_flash=False)
    return port_encoder.build_model(cfg, torch.device("cpu"), params)


@pytest.mark.parametrize("pooling", ["cls", "mean", "last_token"])
def test_weight_carry_pooled_embeddings_match(flax_params, pooling):
    ids, mask = _ids(2)
    cfg = ref_xlmr.XLMRConfig.tiny(**TINY, pooling=pooling, use_flash=False)
    want = np.asarray(ref_xlmr.XLMREncoder(cfg).apply(flax_params, jnp.asarray(ids), jnp.asarray(mask)))
    model = _port_model(port_convert.params_from_flax(flax_params), pooling)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long()).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_weight_carry_hidden_states_match(flax_params):
    ids, mask = _ids(3)
    cfg = ref_xlmr.XLMRConfig.tiny(**TINY, use_flash=False)
    m = ref_xlmr.XLMREncoder(cfg)
    want = np.asarray(m.apply(flax_params, jnp.asarray(ids), jnp.asarray(mask), method=m.hidden_states))
    model = _port_model(port_convert.params_from_flax(flax_params))
    with torch.no_grad():
        got = model.hidden_states(torch.from_numpy(ids).long(), torch.from_numpy(mask).long()).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_params_round_trip_and_npz_both_ways(flax_params, tmp_path):
    sd = port_convert.params_from_flax(flax_params)
    back = port_convert.flax_from_state_dict(sd)
    flat_ref = jax.tree_util.tree_leaves_with_path(flax_params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(flat_back[path], leaf)
    # port writes, JAX reads
    port_convert.save_params_npz(tmp_path / "p.npz", back)
    loaded = ref_convert.load_params_npz(tmp_path / "p.npz")
    for path, leaf in jax.tree_util.tree_leaves_with_path(loaded):
        np.testing.assert_array_equal(leaf, flat_back[path])
    # JAX writes, port reads
    ref_convert.save_params_npz(tmp_path / "q.npz", flax_params)
    sd2 = port_convert.params_from_flax(port_convert.load_params_npz(tmp_path / "q.npz"))
    assert sd2.keys() == sd.keys()
    for key in sd:
        torch.testing.assert_close(sd2[key], sd[key], rtol=0, atol=0)


def _hf_state_dict(seed, prefix="roberta."):
    rng = np.random.default_rng(seed)
    h, f, L = TINY["hidden_size"], TINY["intermediate_size"], TINY["num_layers"]
    sd = {
        "embeddings.word_embeddings.weight": (TINY["vocab_size"], h),
        "embeddings.position_embeddings.weight": (TINY["max_position_embeddings"], h),
        "embeddings.token_type_embeddings.weight": (1, h),
        "embeddings.LayerNorm.weight": (h,), "embeddings.LayerNorm.bias": (h,),
    }
    for i in range(L):
        pre = f"encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key", "attention.self.value",
                     "attention.output.dense"):
            sd[pre + name + ".weight"] = (h, h)
            sd[pre + name + ".bias"] = (h,)
        sd[pre + "intermediate.dense.weight"] = (f, h)
        sd[pre + "intermediate.dense.bias"] = (f,)
        sd[pre + "output.dense.weight"] = (h, f)
        sd[pre + "output.dense.bias"] = (h,)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[pre + name + ".weight"] = (h,)
            sd[pre + name + ".bias"] = (h,)
    return {prefix + k: (0.05 * rng.standard_normal(shape) + (1.0 if k.endswith("LayerNorm.weight") else 0.0)
                         ).astype(np.float32) for k, shape in sd.items()}


def test_hf_state_dict_into_both_converters():
    hf = _hf_state_dict(4)
    cfg_ref = ref_xlmr.XLMRConfig.tiny(**TINY, use_flash=False)
    cfg_port = port_xlmr.XLMRConfig.tiny(**TINY, use_flash=False)
    prefix = port_convert.detect_prefix(hf)
    assert prefix == ref_convert.detect_prefix(hf) == "roberta."
    params_ref = ref_convert.convert_xlmr_state_dict(hf, cfg_ref, prefix=prefix)
    sd = port_convert.convert_xlmr_state_dict(
        {k: torch.from_numpy(v) for k, v in hf.items()}, cfg_port, prefix=prefix)
    ids, mask = _ids(5)
    want = np.asarray(ref_xlmr.XLMREncoder(cfg_ref).apply(params_ref, jnp.asarray(ids), jnp.asarray(mask)))
    model = port_encoder.build_model(cfg_port, torch.device("cpu"), sd)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long()).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("max_length", [None, 6])
def test_hash_tokenizer_ids_identical(max_length):
    texts = ["hello world, this is a test!", "", "naïve café 北京 123", "a " * 40]
    for vocab in (250_002, 120):
        r_ids, r_mask = ref_tok.HashTokenizer(vocab, 32).encode_batch(texts, max_length)
        g_ids, g_mask = port_tok.HashTokenizer(vocab, 32).encode_batch(texts, max_length)
        np.testing.assert_array_equal(g_ids, r_ids)
        np.testing.assert_array_equal(g_mask, r_mask)
    for n in (1, 16, 17, 600):
        assert port_tok.bucket_length(n) == ref_tok.bucket_length(n)


TEXTS = [
    "what is the capital of france", "short", "a much longer query text about many things " * 2,
    "北京 的 天气", "q5 text", "another one here", "x y z",
]


@pytest.mark.parametrize("name", ["BAAI/bge-m3", "intfloat/multilingual-e5-large"])
def test_text_encoder_matches_jax(flax_params, name):
    pooling = "mean" if "e5" in name else "cls"
    cfg_ref = ref_xlmr.XLMRConfig.tiny(**TINY, pooling=pooling, use_flash=False)
    cfg_port = port_xlmr.XLMRConfig.tiny(**TINY, pooling=pooling, use_flash=False)
    enc_ref = ref_encoder.TextEncoder(name, cfg_ref, flax_params)
    enc_port = port_encoder.TextEncoder(name, cfg_port, flax_params, device="cpu")
    np.testing.assert_allclose(
        enc_port.encode_queries(TEXTS, batch_size=3),
        enc_ref.encode_queries(TEXTS, batch_size=3), atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        enc_port.encode_documents(TEXTS, batch_size=4),
        enc_ref.encode_documents(TEXTS, batch_size=4), atol=ATOL, rtol=0)
    # bf16 readback: both round the same f32 rows to bf16 (one bf16 ulp apart
    # at most where the f32 rows differ in the last bits)
    got = enc_port.encode_documents(TEXTS, batch_size=4, readback_dtype=torch.bfloat16)
    want = enc_ref.encode_documents(TEXTS, batch_size=4, readback_dtype=jnp.bfloat16)
    assert got.dtype == np.float32
    assert (np.abs(got - want) <= np.abs(want) * 2.0 ** -7 + 1e-12).all()


def test_from_checkpoint_reads_the_jax_format(flax_params, tmp_path):
    cfg_port = port_xlmr.XLMRConfig.tiny(**TINY, use_flash=False)
    ref_convert.save_params_npz(tmp_path / "params.npz", flax_params)
    (tmp_path / "encoder_config.json").write_text(json.dumps(cfg_port.to_json_dict()))
    enc_port = port_encoder.TextEncoder.from_checkpoint("BAAI/bge-m3", tmp_path, device="cpu")
    assert enc_port.cfg.dtype == torch.float32
    enc_ref = ref_encoder.TextEncoder.from_checkpoint("BAAI/bge-m3", tmp_path)
    np.testing.assert_allclose(
        enc_port.encode_queries(TEXTS), enc_ref.encode_queries(TEXTS), atol=ATOL, rtol=0)


def test_position_ids_and_lora_refusal():
    """Position ids equal the JAX package's; a task-LoRA config (once
    refused) builds the JAX package's parameter tree, leaf for leaf, and
    its pooled embeddings match on the carried weights."""
    ids = np.array([[0, 5, 6, 2, 1, 1]], np.int32)
    want = np.asarray(ref_xlmr.position_ids_from_input_ids(jnp.asarray(ids), 1))
    got = port_xlmr.position_ids_from_input_ids(torch.from_numpy(ids), 1).numpy()
    np.testing.assert_array_equal(got, want)
    cfg = dict(TINY, lora_rank=4, lora_tasks=5)
    mask = (ids != 1).astype(np.int32)
    params = ref_xlmr.XLMREncoder(ref_xlmr.XLMRConfig.tiny(**cfg, use_flash=False)).init(
        jax.random.key(0), jnp.asarray(ids), jnp.asarray(mask), 0)
    sd = port_convert.params_from_flax(params)
    model = port_xlmr.XLMREncoder(port_xlmr.XLMRConfig.tiny(**cfg, use_flash=False))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {k: tuple(v.shape) for k, v in sd.items()}
    model.load_state_dict(sd)
    want = np.asarray(ref_xlmr.XLMREncoder(ref_xlmr.XLMRConfig.tiny(**cfg, use_flash=False)).apply(
        params, jnp.asarray(ids), jnp.asarray(mask), 2))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long(), task_id=2).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_registry_random_init_matches_jax_family_shapes():
    from codemix_dense_retrieval_torch.models.registry import load_encoder
    from codemix_dense_retrieval_tpu.models.registry import load_encoder as ref_load

    for name in ("BAAI/bge-m3", "intfloat/multilingual-e5-large"):
        got = load_encoder(name, device="cpu")
        want = ref_load(name)
        for field in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                      "intermediate_size", "max_position_embeddings", "pooling"):
            assert getattr(got.cfg, field) == getattr(want.cfg, field), (name, field)
        assert got.cfg.dtype == torch.float32 and not got.cfg.use_flash
        assert got.encode_queries(["a b", "c"]).shape == (2, 64)


@pytest.mark.parametrize("name", ["Qwen/Qwen3-Embedding-0.6B", "Alibaba-NLP/gte-multilingual-base",
                                  "jinaai/jina-embeddings-v3"])
def test_registry_refuses_unported_families(name):
    """The three families the registry once refused now load as the JAX
    package's do: the same module family, config and parameter shapes, and
    a CPU encode of the random-init model."""
    from codemix_dense_retrieval_torch.models.registry import load_encoder
    from codemix_dense_retrieval_tpu.models.registry import load_encoder as ref_load

    got, want = load_encoder(name, device="cpu"), ref_load(name)
    assert type(got.model).__name__ == type(want.model).__name__
    for field in ("vocab_size", "hidden_size", "num_layers", "num_heads", "intermediate_size",
                  "max_position_embeddings", "lora_rank", "lora_tasks"):
        assert getattr(got.cfg, field, None) == getattr(want.cfg, field, None), (name, field)
    assert ({k: tuple(v.shape) for k, v in got.model.state_dict().items()}
            == {k: tuple(v.shape) for k, v in port_convert.params_from_flax(want.params).items()})
    out = got.encode_documents(["a b", "c d e"])
    assert out.shape == (2, got.dim) and np.allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)


def test_registry_loads_a_converted_checkpoint(flax_params, tmp_path):
    from codemix_dense_retrieval_torch.models.registry import load_encoder

    cfg_port = port_xlmr.XLMRConfig.tiny(**TINY)
    port_convert.save_params_npz(tmp_path / "params.npz",
                                 port_convert.flax_from_state_dict(port_convert.params_from_flax(flax_params)))
    (tmp_path / "encoder_config.json").write_text(json.dumps(cfg_port.to_json_dict()))
    enc = load_encoder("BAAI/bge-m3", str(tmp_path), device="cpu")
    assert enc.cfg.use_flash is False and enc.cfg.dtype == torch.float32
    want = ref_encoder.TextEncoder(
        "BAAI/bge-m3", ref_xlmr.XLMRConfig.tiny(**TINY, use_flash=False), flax_params)
    np.testing.assert_allclose(enc.encode_queries(TEXTS), want.encode_queries(TEXTS), atol=ATOL, rtol=0)
