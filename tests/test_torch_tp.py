"""parallel/tp.py: tensor parallelism of the Qwen3 and XLM-R encoders
against the JAX package's (tests/test_qwen3_tp.py's cases on its 8 forced
CPU devices) and against the port's own replicated forward, on the same
weights (the Flax params carried across) and the same token ids.

The rule tables give the JAX package's specs for its parameter paths.
The port's TP forward equals its replicated forward within 2e-5, and the
JAX package's TP forward within 2e-5 (f32: the partial sums of the
row-parallel layers add in another order than GSPMD's all-reduce; the
port keeps the partials in f32). A set
whose leaves or heads do not split evenly replicates as a whole, with the
same numbers. int8 kernels split their codes with the kernel's spec and
their scales with its out axis (the two packages' quantizers give the
same codes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch import nn

from codemix_dense_retrieval_torch.models import convert as port_convert
from codemix_dense_retrieval_torch.models import encoder as port_encoder
from codemix_dense_retrieval_torch.models import qwen3 as port_qwen3
from codemix_dense_retrieval_torch.models import xlmr as port_xlmr
from codemix_dense_retrieval_torch.ops.weight_quant import QuantLinear
from codemix_dense_retrieval_torch.ops.weight_quant import quantize_tree as port_quantize_tree
from codemix_dense_retrieval_torch.parallel import tp as port_tp
from codemix_dense_retrieval_torch.parallel.mesh import make_mesh as port_mesh
from codemix_dense_retrieval_tpu.models import qwen3 as ref_qwen3
from codemix_dense_retrieval_tpu.models import xlmr as ref_xlmr
from codemix_dense_retrieval_tpu.ops.weight_quant import dequantize_tree, quantize_tree
from codemix_dense_retrieval_tpu.parallel import make_mesh as ref_mesh
from codemix_dense_retrieval_tpu.parallel import tp as ref_tp

ATOL = 2e-5
QWEN = dict(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=16, intermediate_size=64, max_position_embeddings=128)
XLMR = dict(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            max_position_embeddings=66)


def _ids(seed, b=4, s=8):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 99, size=(b, s)).astype(np.int32)
    mask = np.ones_like(ids)
    ids[1, -3:], mask[1, -3:] = 1, 0  # right padding
    return ids, mask


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


@pytest.fixture(scope="module")
def qwen_params():
    ids, mask = _ids(0)
    cfg = ref_qwen3.Qwen3Config.tiny(**QWEN)
    return _perturbed(ref_qwen3.Qwen3Encoder(cfg).init(jax.random.key(0), jnp.asarray(ids), jnp.asarray(mask)), 1)


@pytest.fixture(scope="module")
def xlmr_params():
    ids, mask = _ids(0)
    cfg = ref_xlmr.XLMRConfig.tiny(**XLMR, use_flash=False)
    return _perturbed(ref_xlmr.XLMREncoder(cfg).init(jax.random.key(0), jnp.asarray(ids), jnp.asarray(mask)), 2)


def _port_model(family, params):
    if family == "qwen3":
        cfg = port_qwen3.Qwen3Config.tiny(**QWEN)
        with torch.device("meta"):
            module = port_qwen3.Qwen3Encoder(cfg)
    else:
        cfg = port_xlmr.XLMRConfig.tiny(**XLMR, use_flash=False)
        with torch.device("meta"):
            module = port_xlmr.XLMREncoder(cfg)
    return port_encoder.build_model(cfg, torch.device("cpu"), port_convert.params_from_flax(params), model=module)


def _ref_module(family):
    if family == "qwen3":
        return ref_qwen3.Qwen3Encoder(ref_qwen3.Qwen3Config.tiny(**QWEN))
    return ref_xlmr.XLMREncoder(ref_xlmr.XLMRConfig.tiny(**XLMR, use_flash=False))


def _run(model, ids, mask):
    with torch.no_grad():
        return model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long()).numpy()


def _jax_tp_forward(family, params, mesh, ids, mask, quantized=False):
    model = _ref_module(family)
    if quantized:
        fwd = jax.jit(lambda p, i, m: model.apply(dequantize_tree(p, jnp.float32), i, m))
    else:
        fwd = jax.jit(lambda p, i, m: model.apply(p, i, m))
    with jax.set_mesh(mesh):
        return np.asarray(fwd(ref_tp.shard_params_tp(params, mesh, family), jnp.asarray(ids), jnp.asarray(mask)))


def test_sharding_rules_match_jax():
    for path, family in [
        ("layer_0/self_attn/q_proj/kernel", "qwen3"), ("layer_0/self_attn/o_proj/kernel", "qwen3"),
        ("layer_0/mlp/down_proj/kernel", "qwen3"), ("layer_0/mlp/gate_proj/kernel", "qwen3"),
        ("norm/weight", "qwen3"), ("embed_tokens/embedding", "qwen3"),
        ("layer_3/q/kernel", "xlmr"), ("layer_3/v/bias", "xlmr"), ("layer_3/ffn_out/kernel", "xlmr"),
        ("layer_3/ffn_in/bias", "xlmr"), ("layer_3/attn_out/bias", "xlmr"),
        ("embeddings/word_embeddings/embedding", "xlmr"), ("layer_0/q/base/kernel", "xlmr"),
    ]:
        assert port_tp.tp_spec_for_path(path, family) == tuple(ref_tp.tp_spec_for_path(path, family)), path
    assert port_tp.tp_spec_for_path("layer_0/self_attn/q_proj/kernel", "qwen3") == tuple(P(None, "tp"))
    assert port_tp.jax_path("layers.3.self_attn.q_proj") == "layer_3/self_attn/q_proj/kernel"
    assert port_tp.jax_path("layers.12.ffn_out") == "layer_12/ffn_out/kernel"


@pytest.mark.parametrize("family", ["qwen3", "xlmr"])
@pytest.mark.parametrize("shard,tp", [(2, 4), (4, 2)])
def test_tp_forward_matches_replicated_and_jax(family, shard, tp, qwen_params, xlmr_params,
                                               eight_cpu_devices):
    """Megatron TP over a (shard, tp) mesh equals the replicated forward
    (the ``device_map="auto"`` replacement) and the JAX package's TP
    forward."""
    params = qwen_params if family == "qwen3" else xlmr_params
    ids, mask = _ids(3)
    model = _port_model(family, params)
    mesh = port_mesh(shard=shard, tp=tp, devices=["cpu"] * 8)
    tp_model = port_tp.shard_params_tp(model, mesh, family)
    replicated = port_tp.replicate_params(model, mesh)
    assert len(replicated) == shard and all(m is model for m in replicated)
    got = _run(tp_model, ids, mask)
    np.testing.assert_allclose(got, _run(model, ids, mask), rtol=0, atol=ATOL)
    want = _jax_tp_forward(family, params, ref_mesh(shard=shard, tp=tp, devices=eight_cpu_devices), ids, mask)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the MLP / FFN splits over every tp device
    layer = tp_model.layers[0]
    block = layer.mlp if family == "qwen3" else layer.ffn
    assert isinstance(block, port_tp.TensorParallel) and len(block.parts) == tp


def test_attention_splits_whole_heads_and_gqa_groups(qwen_params):
    """tp = 2: each half holds 2 of the 4 query heads and 1 of the 2 KV
    heads (a whole GQA group); the model's own layers are untouched."""
    model = _port_model("qwen3", qwen_params)
    tp_model = port_tp.shard_params_tp(model, port_mesh(shard=1, tp=2, devices=["cpu"] * 2), "qwen3")
    attn = tp_model.layers[1].self_attn
    assert isinstance(attn, port_tp.TensorParallel) and len(attn.parts) == 2
    for t, part in enumerate(attn.parts):
        assert (part.cfg.num_heads, part.cfg.num_kv_heads) == (2, 1)
        full = model.layers[1].self_attn
        assert torch.equal(part.q_proj.weight, full.q_proj.weight[t * 32 : (t + 1) * 32])
        assert torch.equal(part.k_proj.weight, full.k_proj.weight[t * 16 : (t + 1) * 16])
        assert isinstance(part.o_proj, port_tp.RowParallelLinear)
        assert torch.equal(part.o_proj.layer.weight, full.o_proj.weight[:, t * 32 : (t + 1) * 32])
    assert isinstance(model.layers[1].self_attn, port_qwen3.Qwen3Attention)


def test_indivisible_sets_replicate_whole(qwen_params, eight_cpu_devices):
    """tp = 8: Qwen3's 4 query / 2 KV heads do not split 8 ways, so the
    attention set runs whole on the first tp device (JAX's GSPMD may still
    split its 64 columns); the MLP splits. The numbers are the same. A
    leaf whose out dim does not divide (JAX's fake (32, 9) kernel) makes
    its set replicate."""
    ids, mask = _ids(4)
    model = _port_model("qwen3", qwen_params)
    mesh = port_mesh(shard=1, tp=8, devices=["cpu"] * 8)
    tp_model = port_tp.shard_params_tp(model, mesh, "qwen3")
    assert isinstance(tp_model.layers[0].self_attn, port_qwen3.Qwen3Attention)
    assert isinstance(tp_model.layers[0].mlp, port_tp.TensorParallel)
    got = _run(tp_model, ids, mask)
    np.testing.assert_allclose(got, _run(model, ids, mask), rtol=0, atol=ATOL)
    want = _jax_tp_forward("qwen3", qwen_params, ref_mesh(shard=1, tp=8, devices=eight_cpu_devices), ids, mask)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    fake = nn.Linear(32, 9)
    assert port_tp._splits([("layers.0.self_attn.q_proj", fake)], "qwen3", 8) is None
    assert port_tp._splits([("layers.0.self_attn.q_proj", nn.Linear(32, 16))], "qwen3", 8) == [port_tp.COLUMN]


def test_tp_with_int8_weight_quant(qwen_params, eight_cpu_devices):
    """int8 kernels TP-split (codes by the kernel's spec, the
    per-out-channel scale by the out axis) and the TP forward equals the
    replicated quantized forward and the JAX package's TP forward over its
    quantized tree (the bitsandbytes-on-2-GPUs setup)."""
    ids, mask = _ids(5)
    qparams = quantize_tree(qwen_params, "int8", min_size=1024)
    model = _port_model("qwen3", port_quantize_tree(qwen_params, "int8", min_size=1024))
    assert isinstance(model.layers[0].mlp.gate_proj, QuantLinear)
    mesh = port_mesh(shard=2, tp=4, devices=["cpu"] * 8)
    tp_model = port_tp.shard_params_tp(model, mesh, "qwen3")
    got = _run(tp_model, ids, mask)
    np.testing.assert_allclose(got, _run(model, ids, mask), rtol=0, atol=ATOL)
    want = _jax_tp_forward("qwen3", qparams, ref_mesh(shard=2, tp=4, devices=eight_cpu_devices), ids, mask,
                           quantized=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    full = model.layers[0].mlp
    for t, part in enumerate(tp_model.layers[0].mlp.parts):
        gate, down = part.gate_proj, part.down_proj.layer
        assert isinstance(gate, QuantLinear) and gate.codes.shape == (32, 16)
        assert torch.equal(gate.codes, full.gate_proj.codes[:, t * 16 : (t + 1) * 16])
        assert torch.equal(gate.weight.scale, full.gate_proj.weight.scale[t * 16 : (t + 1) * 16])
        assert torch.equal(down.codes, full.down_proj.codes[t * 16 : (t + 1) * 16])
        assert torch.equal(down.weight.scale, full.down_proj.weight.scale)


def test_nf4_sets_replicate(qwen_params):
    """NF4 kernels keep their packed blocks whole: their sets run
    replicated, with the same numbers."""
    ids, mask = _ids(6)
    model = _port_model("qwen3", port_quantize_tree(qwen_params, "nf4", min_size=1024))
    tp_model = port_tp.shard_params_tp(model, port_mesh(shard=1, tp=2, devices=["cpu"] * 2), "qwen3")
    assert isinstance(tp_model.layers[0].mlp, port_qwen3.Qwen3Mlp)
    np.testing.assert_allclose(_run(tp_model, ids, mask), _run(model, ids, mask), rtol=0, atol=ATOL)


def test_unknown_family_raises(qwen_params):
    model = _port_model("qwen3", qwen_params)
    with pytest.raises(ValueError, match="unknown tp family"):
        port_tp.shard_params_tp(model, port_mesh(shard=1, tp=2, devices=["cpu"] * 2), "gte")
