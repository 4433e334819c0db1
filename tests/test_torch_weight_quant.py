"""ops/weight_quant.py and the quantized encoders: the port's int8 / NF4
quantizers, dequantizers, the quantized linear layer and the ``@wq.``
checkpoint entries against the JAX package's on the same numpy inputs.
Codes and scales byte-equal; dequantized kernels bit-equal in f32; the
quantized encoders of the four families within 1e-5 abs of the JAX ones
on the same params (f32, 2 layers at hidden 256, so each Linear reaches the
65,536-element threshold), and within the JAX suite's own cosine bounds of
the full-precision encoder (0.995 int8, 0.95 NF4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.models import convert as port_convert
from codemix_dense_retrieval_torch.models import encoder as port_encoder
from codemix_dense_retrieval_torch.models import gte as port_gte
from codemix_dense_retrieval_torch.models import qwen3 as port_qwen3
from codemix_dense_retrieval_torch.models import xlmr as port_xlmr
from codemix_dense_retrieval_torch.models.tokenizer import HashTokenizer as PortHash
from codemix_dense_retrieval_torch.ops import weight_quant as port_wq
from codemix_dense_retrieval_tpu.models import convert as ref_convert
from codemix_dense_retrieval_tpu.models import encoder as ref_encoder
from codemix_dense_retrieval_tpu.models import gte as ref_gte
from codemix_dense_retrieval_tpu.models import qwen3 as ref_qwen3
from codemix_dense_retrieval_tpu.models import xlmr as ref_xlmr
from codemix_dense_retrieval_tpu.models.tokenizer import HashTokenizer as RefHash
from codemix_dense_retrieval_tpu.ops import weight_quant as ref_wq

ATOL = 1e-5
MIN_COS = {"int8": 0.995, "nf4": 0.95}
MODES = ("int8", "nf4")
TEXTS = ["passage about topic one", "w1 w2 w3 w4 w5", "short", "another longer passage text here"]
XLMR = dict(vocab_size=500, hidden_size=256, num_layers=2, num_heads=4, intermediate_size=512,
            max_position_embeddings=66, use_flash=False)
QWEN = dict(vocab_size=500, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
            intermediate_size=512, max_position_embeddings=128, use_flash=False)
GTE = dict(vocab_size=500, hidden_size=256, num_layers=2, num_heads=4, intermediate_size=512,
           max_position_embeddings=64)

# family -> (name, JAX config, port config, JAX module class or None, port module class or None)
FAMILIES = {
    "xlmr": ("BAAI/bge-m3", ref_xlmr.XLMRConfig.tiny(**XLMR), port_xlmr.XLMRConfig.tiny(**XLMR), None, None),
    "jina": ("jinaai/jina-embeddings-v3", ref_xlmr.XLMRConfig.jina_v3(**XLMR),
             port_xlmr.XLMRConfig.jina_v3(**XLMR), None, None),
    "qwen3": ("Qwen/Qwen3-Embedding-0.6B", ref_qwen3.Qwen3Config.tiny(**QWEN),
              port_qwen3.Qwen3Config.tiny(**QWEN), ref_qwen3.Qwen3Encoder, port_qwen3.Qwen3Encoder),
    "gte": ("Alibaba-NLP/gte-multilingual-base", ref_gte.GTEConfig.tiny(**GTE), port_gte.GTEConfig.tiny(**GTE),
            ref_gte.GTEEncoder, port_gte.GTEEncoder),
}


def _leaf_paths(tree, prefix=()):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_leaf_paths(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = val
    return out


def _as_port(tree):
    """A JAX tree with its QuantizedTensor leaves as the port's (numpy codes)."""
    if isinstance(tree, ref_wq.QuantizedTensor):
        return port_wq.QuantizedTensor(tree.kind, np.asarray(tree.codes), np.asarray(tree.scale), tree.shape)
    if isinstance(tree, dict):
        return {k: _as_port(v) for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module")
def family_params():
    """Each family's parameter tree in the JAX package's layout (f32 numpy):
    the port's seeded init through flax_from_state_dict (the layouts agree,
    tests/test_torch_{xlmr,qwen3,gte,jina}.py), with noise on every leaf so
    biases, norms and jina-v3's LoRA factors are all non-trivial."""
    out = {}
    for fam, (_, _, cfg, _, module_cls) in FAMILIES.items():
        model = None
        if module_cls:
            with torch.device("meta"):
                model = module_cls(cfg)
        model = port_encoder.build_model(cfg, torch.device("cpu"), seed=0, model=model)
        rng = np.random.default_rng(1)
        out[fam] = jax.tree_util.tree_map(
            lambda x: x + 0.02 * rng.standard_normal(x.shape).astype(np.float32),
            port_convert.flax_from_state_dict(model.state_dict()))
    return out


def _ref_encoder(fam, params, **kw):
    name, cfg, _, module_cls, _ = FAMILIES[fam]
    model = module_cls(cfg) if module_cls else None
    return ref_encoder.TextEncoder(name, cfg, params, RefHash(vocab_size=500, max_length=60), model=model, **kw)


def _port_encoder(fam, params, **kw):
    name, _, cfg, _, module_cls = FAMILIES[fam]
    model = None
    if module_cls:
        with torch.device("meta"):
            model = module_cls(cfg)
    return port_encoder.TextEncoder(name, cfg, params, PortHash(vocab_size=500, max_length=60), model=model,
                                    device="cpu", **kw)


# --------------------------------------------------------------------------
# leaves


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(256, 384), (300, 217), (5, 30)])
def test_leaf_codes_and_scales_byte_equal(mode, shape):
    """(300, 217) and (5, 30) leave a ragged NF4 tail (not a multiple of 64);
    a zero column and a zero block exercise the absmax-0 scale."""
    rng = np.random.default_rng(sum(shape))
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    w[:, 3] = 0.0
    w.ravel()[64:128] = 0.0
    want = ref_wq.quantize_tree({"kernel": w}, mode, min_size=1)["kernel"]
    got = port_wq.quantize_tree({"kernel": w}, mode, min_size=1)["kernel"]
    assert isinstance(got, port_wq.QuantizedTensor) and got.kind == want.kind == mode
    assert got.shape == tuple(want.shape) == shape
    for a, b in ((got.codes, want.codes), (got.scale, want.scale)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    deq = got.dequantize(torch.float32).numpy()
    ref = np.asarray(want.dequantize(jnp.float32))
    assert deq.shape == shape and deq.tobytes() == ref.tobytes()


def test_dequantize_tree_bit_equal_and_bf16():
    rng = np.random.default_rng(4)
    tree = {"dense": {"kernel": rng.standard_normal((256, 512)).astype(np.float32),
                      "bias": rng.standard_normal(512).astype(np.float32)},
            "embed": {"embedding": rng.standard_normal((300, 256)).astype(np.float32)}}
    for mode in MODES:
        q_ref = ref_wq.quantize_tree(tree, mode)
        q_port = port_wq.quantize_tree(tree, mode)
        assert isinstance(q_port["embed"]["embedding"], np.ndarray)
        assert port_wq.has_quantized(q_port) and not port_wq.has_quantized(tree)
        want = ref_wq.dequantize_tree(q_ref, jnp.float32)
        got = port_wq.dequantize_tree(q_port, torch.float32)
        assert got["dense"]["kernel"].numpy().tobytes() == np.asarray(want["dense"]["kernel"]).tobytes()
        bf = port_wq.dequantize_tree(q_port, torch.bfloat16)["dense"]["kernel"]
        rbf = np.asarray(ref_wq.dequantize_tree(q_ref, jnp.bfloat16)["dense"]["kernel"]).astype(np.float32)
        assert bf.dtype == torch.bfloat16 and bf.float().numpy().tobytes() == rbf.tobytes()


def test_bad_mode_rejected():
    with pytest.raises(ValueError, match="int8\\|nf4"):
        port_wq.quantize_tree({"kernel": np.ones((4, 4), np.float32)}, "fp2")


# --------------------------------------------------------------------------
# trees of the four families


@pytest.mark.parametrize("fam", list(FAMILIES))
@pytest.mark.parametrize("mode", MODES)
def test_quantized_leaves_match_jax_per_family(family_params, fam, mode):
    """The port decides eligibility on the Flax-layout tree of its state dict
    (quantize_state_dict): the same leaves as JAX's quantize_tree, byte-equal
    codes, and the same resident bytes."""
    params = family_params[fam]
    ref_q = ref_wq.quantize_tree(params, mode)
    sd = port_convert.params_from_flax(params)
    got = port_encoder.quantize_state_dict(sd, mode)
    want = {k: v for k, v in port_convert.params_from_flax(_as_port(ref_q)).items()
            if isinstance(v, port_wq.QuantizedTensor)}
    assert len(want) > 0 and set(got) == set(want)
    for key, q in got.items():
        r = want[key]
        assert q.shape == tuple(r.shape)
        assert np.asarray(q.codes).tobytes() == np.asarray(r.codes).tobytes()
        assert np.asarray(q.scale).tobytes() == np.asarray(r.scale).tobytes()
    if fam == "jina":
        # the 3-D LoRA factors stay, their sibling base kernel is quantized
        assert "layers.0.q.base.weight" in got and "layers.0.q.lora_a" not in got
    port_tree = port_wq.quantize_tree(port_convert.flax_from_state_dict(sd), mode)
    assert port_wq.quantized_nbytes(port_tree) == ref_wq.quantized_nbytes(ref_q)
    assert port_wq.quantized_nbytes(params) == ref_wq.quantized_nbytes(params)


@pytest.mark.parametrize("fam", list(FAMILIES))
@pytest.mark.parametrize("mode", MODES)
def test_quantized_encoder_matches_jax(family_params, fam, mode):
    """TextEncoder(weight_quant=mode) from the same f32 params in both
    packages; and the port's quantized encoder near its full one."""
    params = family_params[fam]
    ref = _ref_encoder(fam, params, weight_quant=mode)
    port = _port_encoder(fam, params, weight_quant=mode)
    assert port.weight_quant == ref.weight_quant == mode
    assert any(isinstance(m, port_wq.QuantLinear) for m in port.model.modules())
    got_q, got_d = port.encode_queries(TEXTS), port.encode_documents(TEXTS)
    np.testing.assert_allclose(got_q, ref.encode_queries(TEXTS), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_d, ref.encode_documents(TEXTS), atol=ATOL, rtol=0)
    full = _port_encoder(fam, params).encode_documents(TEXTS)
    assert (full * got_d).sum(axis=1).min() > MIN_COS[mode]


@pytest.mark.parametrize("mode", MODES)
def test_prequantized_params_load_as_stored(family_params, mode):
    """A JAX-quantized tree (its leaves as the port's class) passed as
    params: the port arms the quantized layers by itself ("pre-quantized")
    and matches the JAX encoder."""
    ref_params = ref_wq.quantize_tree(family_params["xlmr"], mode)
    params = _as_port(ref_params)
    ref = _ref_encoder("xlmr", ref_params)
    port = _port_encoder("xlmr", params)
    assert port.weight_quant == ref.weight_quant == "pre-quantized"
    np.testing.assert_allclose(port.encode_documents(TEXTS), ref.encode_documents(TEXTS), atol=ATOL, rtol=0)
    # the same mode on top is accepted, another one refused
    _port_encoder("xlmr", params, weight_quant=mode)
    other = "int8" if mode == "nf4" else "nf4"
    with pytest.raises(ValueError, match="already quantized"):
        _port_encoder("xlmr", params, weight_quant=other)
    with pytest.raises(ValueError, match="already quantized"):
        _ref_encoder("xlmr", ref_params, weight_quant=other)


def test_bad_mode_refused_by_the_encoder():
    with pytest.raises(ValueError, match="int8\\|nf4"):
        _port_encoder("xlmr", None, weight_quant="fp2")


def test_random_init_quantizes_its_f32_weights():
    """Without params the f32 random init is quantized (on the host) before
    the cast: the codes equal quantize_state_dict of an unquantized twin."""
    cfg = FAMILIES["xlmr"][2]
    quant = port_encoder.TextEncoder("BAAI/bge-m3", cfg, seed=5, weight_quant="nf4", device="cpu")
    twin = port_encoder.build_model(cfg, torch.device("cpu"), seed=5)
    want = port_encoder.quantize_state_dict(twin.state_dict(), "nf4")
    layer = quant.model.layers[1].ffn_out
    assert isinstance(layer, port_wq.QuantLinear)
    np.testing.assert_array_equal(layer.codes.numpy(), want["layers.1.ffn_out.weight"].codes)
    torch.testing.assert_close(layer.bias, twin.layers[1].ffn_out.bias, rtol=0, atol=0)


def test_scale_stays_f32_through_the_bf16_cast():
    """build_model ends in .to(cfg.dtype): the codes and the f32 scales come
    through unchanged, the bias follows the compute dtype, and the forward
    multiplies the f32 scales before its cast."""
    rng = np.random.default_rng(8)
    w = rng.standard_normal((256, 320)).astype(np.float32)
    b = rng.standard_normal(320).astype(np.float32)
    for mode in MODES:
        q = port_wq.quantize_tree({"k": w}, mode, min_size=1)["k"]
        layer = port_wq.QuantLinear(q, torch.from_numpy(b)).to(torch.bfloat16)
        assert layer.weight.scale.dtype == torch.float32
        assert layer.weight.scale.numpy().tobytes() == q.scale.tobytes()
        assert layer.codes.numpy().tobytes() == q.codes.tobytes()
        assert layer.bias.dtype == torch.bfloat16
        x = torch.from_numpy(rng.standard_normal((3, 256)).astype(np.float32)).to(torch.bfloat16)
        want = torch.nn.functional.linear(x, q.dequantize(torch.bfloat16).T, layer.bias)
        assert torch.equal(layer(x), want)
    enc = port_encoder.TextEncoder("BAAI/bge-m3", port_xlmr.XLMRConfig.tiny(**dict(XLMR, dtype=torch.bfloat16)),
                                   seed=1, weight_quant="int8", device="cpu")
    layers = [m for m in enc.model.modules() if isinstance(m, port_wq.QuantLinear)]
    assert layers and all(m.weight.scale.dtype == torch.float32 and m.codes.dtype == torch.int8 for m in layers)
    assert next(enc.model.embeddings.parameters()).dtype == torch.bfloat16


# --------------------------------------------------------------------------
# params.npz with @wq. entries, both ways


def _npz_entries(path):
    with np.load(path) as data:
        return [(n, data[n].dtype.str, data[n].shape, data[n].tobytes()) for n in data.files]


@pytest.mark.parametrize("mode", MODES)
def test_wq_npz_entries_byte_equal_both_ways(family_params, mode, tmp_path):
    params = family_params["xlmr"]
    ref_q = ref_wq.quantize_tree(params, mode)
    port_q = port_wq.quantize_tree(port_convert.flax_from_state_dict(port_convert.params_from_flax(params)), mode)
    ref_convert.save_params_npz(tmp_path / "ref.npz", ref_q)
    port_convert.save_params_npz(tmp_path / "port.npz", port_q)
    ref_entries, port_entries = _npz_entries(tmp_path / "ref.npz"), _npz_entries(tmp_path / "port.npz")
    assert any("@wq." + mode in e[0] for e in ref_entries)
    assert port_entries == ref_entries
    # JAX writes, the port reads; the port writes, JAX reads
    for got, want in ((port_convert.load_params_npz(tmp_path / "ref.npz"), ref_q),
                      (ref_convert.load_params_npz(tmp_path / "port.npz"), port_q)):
        got_l, want_l = _leaf_paths(got), _leaf_paths(want)
        assert set(got_l) == set(want_l)
        for path, w in want_l.items():
            g = got_l[path]
            if hasattr(w, "codes"):
                assert type(g).__name__ == "QuantizedTensor" and g.kind == w.kind and tuple(g.shape) == w.shape
                assert np.asarray(g.codes).tobytes() == np.asarray(w.codes).tobytes()
                assert np.asarray(g.scale).tobytes() == np.asarray(w.scale).tobytes()
            else:
                assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
