"""jina-embeddings-v3 in the port: XLM-R with task-LoRA adapters
(models/xlmr.py::LoraDense), the per-role task choice of the TextEncoder,
the HF adapter conversion, and the registry's five families, each against
the JAX package on the same weights (the Flax params carried across, with
non-zero adapters) and the same inputs. f32, tolerance 1e-5 abs (2e-5 for
the 2-layer encoder outputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.models import convert as port_convert
from codemix_dense_retrieval_torch.models import encoder as port_encoder
from codemix_dense_retrieval_torch.models import xlmr as port_xlmr
from codemix_dense_retrieval_tpu.models import convert as ref_convert
from codemix_dense_retrieval_tpu.models import encoder as ref_encoder
from codemix_dense_retrieval_tpu.models import xlmr as ref_xlmr

TINY = dict(vocab_size=500, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            max_position_embeddings=64, use_flash=False)
TEXTS = ["hello world", "w1 w2 w3 w4", "w5"]


def _bumped(params, seed):
    """``params`` with every lora_b replaced by noise (the JAX init starts
    it at zero, which would make every task the base model)."""
    rng = np.random.default_rng(seed)

    def bump(path, leaf):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if name.endswith("lora_b"):
            return rng.standard_normal(np.shape(leaf)).astype(np.float32) * 0.5
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(bump, params)


@pytest.fixture(scope="module")
def jina():
    cfg = ref_xlmr.XLMRConfig.jina_v3(**TINY)
    ids = np.random.default_rng(0).integers(3, 499, size=(3, 9)).astype(np.int32)
    mask = np.ones_like(ids)
    ids[2, 5:], mask[2, 5:] = 1, 0
    params = ref_xlmr.XLMREncoder(cfg).init(jax.random.key(0), jnp.asarray(ids), jnp.asarray(mask), 0)
    return cfg, _bumped(params, 1), ids, mask


@pytest.mark.parametrize("task", [None, 0, 1, 4])
def test_lora_dense_matches_jax(task):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    m = ref_xlmr.LoraDense(8, rank=4, num_tasks=5, alpha=2.0)
    params = _bumped(m.init(jax.random.key(0), jnp.asarray(x), 0), 2)
    want = np.asarray(m.apply(params, jnp.asarray(x), task))
    layer = port_xlmr.LoraDense(16, 8, rank=4, num_tasks=5, alpha=2.0)
    layer.load_state_dict(port_convert.params_from_flax(params))
    with torch.no_grad():
        got = layer(torch.from_numpy(x), task).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("task", [0, 1, 3])
def test_lora_encoder_matches_jax_per_task(jina, task):
    cfg, params, ids, mask = jina
    want = np.asarray(ref_xlmr.XLMREncoder(cfg).apply(params, jnp.asarray(ids), jnp.asarray(mask), task))
    model = port_encoder.build_model(port_xlmr.XLMRConfig.jina_v3(**TINY), torch.device("cpu"), params)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long(), task_id=task).numpy()
        other = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long(), task_id=task + 1).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert np.abs(got - other).max() > 1e-4  # the adapters are engaged


@pytest.mark.parametrize("pack", [False, True])
def test_text_encoder_picks_the_task_by_role_like_jax(jina, pack):
    cfg, params, _, _ = jina
    ref = ref_encoder.TextEncoder("jinaai/jina-embeddings-v3", cfg, params)
    port = port_encoder.TextEncoder("jinaai/jina-embeddings-v3", port_xlmr.XLMRConfig.jina_v3(**TINY),
                                    params, device="cpu")
    assert port._task_id("query") == ref._task_id("query") == port_xlmr.JINA_V3_TASKS.index("retrieval.query")
    assert port._task_id("passage") == ref._task_id("passage") == 1
    q = port.encode_queries(TEXTS)
    d = port.encode_documents(TEXTS, pack=pack)
    np.testing.assert_allclose(q, ref.encode_queries(TEXTS), atol=2e-5, rtol=0)
    np.testing.assert_allclose(d, ref.encode_documents(TEXTS, pack=pack), atol=2e-5, rtol=0)
    assert np.abs(q - d).max() > 1e-4  # queries and passages take different adapters
    # another family name keeps task 0 on the same weights
    plain = port_encoder.TextEncoder("BAAI/bge-m3", port_xlmr.XLMRConfig.jina_v3(**TINY), params, device="cpu")
    assert plain._task_id("passage") == 0


@pytest.mark.parametrize("adapters", [False, True])
def test_convert_xlmr_state_dict_with_lora_matches_jax(adapters):
    """An HF XLM-R state dict, with jina-v3's parametrized adapters or
    without them (zeros), through both converters."""
    cfg = port_xlmr.XLMRConfig.tiny(vocab_size=120, hidden_size=32, num_layers=1, num_heads=4,
                                    intermediate_size=64, max_position_embeddings=66,
                                    lora_rank=4, lora_tasks=5)
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    hf = {"embeddings.word_embeddings.weight": r(120, 32), "embeddings.position_embeddings.weight": r(66, 32),
          "embeddings.token_type_embeddings.weight": r(1, 32), "embeddings.LayerNorm.weight": r(32),
          "embeddings.LayerNorm.bias": r(32)}
    dims = {"attention.self.query": (32, 32), "attention.self.key": (32, 32), "attention.self.value": (32, 32),
            "attention.output.dense": (32, 32), "intermediate.dense": (64, 32), "output.dense": (32, 64)}
    for name, (n_out, n_in) in dims.items():
        p = f"encoder.layer.0.{name}"
        if adapters:
            hf[f"{p}.parametrizations.weight.original"] = r(n_out, n_in)
            hf[f"{p}.parametrizations.weight.0.lora_A"] = r(5, 4, n_in)
            hf[f"{p}.parametrizations.weight.0.lora_B"] = r(5, n_out, 4)
        else:
            hf[f"{p}.weight"] = r(n_out, n_in)
        hf[f"{p}.bias"] = r(n_out)
    for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
        hf[f"encoder.layer.0.{ln}.weight"] = r(32)
        hf[f"encoder.layer.0.{ln}.bias"] = r(32)
    hf = {f"roberta.{k}": v for k, v in hf.items()}
    got = port_convert.convert_xlmr_state_dict(hf, cfg, prefix="roberta.")
    ref_cfg = ref_xlmr.XLMRConfig.tiny(vocab_size=120, hidden_size=32, num_layers=1, num_heads=4,
                                       intermediate_size=64, max_position_embeddings=66,
                                       lora_rank=4, lora_tasks=5)
    want = port_convert.params_from_flax(ref_convert.convert_xlmr_state_dict(hf, ref_cfg, prefix="roberta."))
    assert set(got) == set(want) == set(port_xlmr.XLMREncoder(cfg).state_dict())
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert bool((got["layers.0.q.lora_b"] != 0).any()) == adapters


def test_params_from_flax_round_trips_the_lora_tree(jina):
    _, params, _, _ = jina
    sd = port_convert.params_from_flax(params)
    assert sd["layers.0.q.lora_a"].shape == (5, 32, 4) and "layers.0.q.base.weight" in sd
    back = port_convert.flax_from_state_dict(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(leaf, flat_b[path])


@pytest.mark.parametrize("name", ["BAAI/bge-m3", "intfloat/multilingual-e5-large", "Qwen/Qwen3-Embedding-0.6B",
                                  "Alibaba-NLP/gte-multilingual-base", "jinaai/jina-embeddings-v3"])
def test_load_encoder_random_init_shapes_match_jax(name):
    from codemix_dense_retrieval_torch.models.registry import load_encoder
    from codemix_dense_retrieval_tpu.models.registry import load_encoder as ref_load

    got, want = load_encoder(name, device="cpu"), ref_load(name)
    assert type(got.model).__name__ == type(want.model).__name__
    for field in ("vocab_size", "hidden_size", "num_layers", "num_heads", "intermediate_size",
                  "max_position_embeddings", "pooling", "lora_rank", "lora_tasks",
                  "num_kv_heads", "head_dim", "rope_theta"):
        assert getattr(got.cfg, field, None) == getattr(want.cfg, field, None), (name, field)
    port_names = {k: tuple(v.shape) for k, v in got.model.state_dict().items()}
    ref_names = {k: tuple(v.shape) for k, v in port_convert.params_from_flax(want.params).items()}
    assert port_names == ref_names
    assert got.encode_queries(["a b", "c"]).shape == (2, got.dim)
