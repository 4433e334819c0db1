"""models/gte.py: the GTE-multilingual encoder against the JAX package's on
the same weights (the Flax params carried across) and the same token ids:
hidden states, CLS pooling, per-token embeddings, the HF converter, and the
refusal of pack=True (GTE has no packed forward in either package). f32,
tolerance 2e-5 abs: the same products summed in another order through 2
post-LN layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.models import convert as port_convert
from codemix_dense_retrieval_torch.models import encoder as port_encoder
from codemix_dense_retrieval_torch.models import gte as port_gte
from codemix_dense_retrieval_tpu.models import encoder as ref_encoder
from codemix_dense_retrieval_tpu.models import gte as ref_gte

ATOL = 2e-5
TINY = dict(vocab_size=200, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            max_position_embeddings=64)
TEXTS = ["w1 w2 w3", "w4", "w5 w6 w7 w8 w9 w10 w11", "w2 w2"]


def _ids(seed, b=3, s=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 199, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    for i, n in enumerate([s, s - 4, 5][:b]):
        ids[i, n:] = 1
        mask[i, n:] = 0
    return ids, mask


@pytest.fixture(scope="module")
def flax_params():
    cfg = ref_gte.GTEConfig.tiny(**TINY)
    ids, mask = _ids(0)
    params = ref_gte.GTEEncoder(cfg).init(jax.random.key(0), jnp.asarray(ids), jnp.asarray(mask))
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def _port(params):
    cfg = port_gte.GTEConfig.tiny(**TINY)
    with torch.device("meta"):
        module = port_gte.GTEEncoder(cfg)
    return port_encoder.build_model(cfg, torch.device("cpu"), params, model=module)


@pytest.mark.parametrize("method", ["__call__", "hidden_states", "token_embeddings"])
def test_forward_matches_jax(flax_params, method):
    ids, mask = _ids(2)
    m = ref_gte.GTEEncoder(ref_gte.GTEConfig.tiny(**TINY))
    kw = {} if method == "__call__" else {"method": getattr(m, method)}
    want = np.asarray(m.apply(flax_params, jnp.asarray(ids), jnp.asarray(mask), **kw))
    model = _port(port_convert.params_from_flax(flax_params))
    fn = model if method == "__call__" else getattr(model, method)
    with torch.no_grad():
        got = fn(torch.from_numpy(ids).long(), torch.from_numpy(mask).long()).numpy()
    if method == "hidden_states":
        valid = mask.astype(bool)
        got, want = got[valid], want[valid]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_text_encoder_matches_jax_and_refuses_packing(flax_params):
    cfg_r = ref_gte.GTEConfig.tiny(**TINY)
    ref = ref_encoder.TextEncoder("Alibaba-NLP/gte-multilingual-base", cfg_r, flax_params,
                                  model=ref_gte.GTEEncoder(cfg_r))
    cfg_p = port_gte.GTEConfig.tiny(**TINY)
    with torch.device("meta"):
        module = port_gte.GTEEncoder(cfg_p)
    port = port_encoder.TextEncoder("Alibaba-NLP/gte-multilingual-base", cfg_p, flax_params,
                                    model=module, device="cpu")
    np.testing.assert_allclose(port.encode_queries(TEXTS), ref.encode_queries(TEXTS), atol=ATOL, rtol=0)
    dv, toks, lens = port.encode_documents_with_tokens(TEXTS)
    rdv, rtoks, rlens = ref.encode_documents_with_tokens(TEXTS)
    np.testing.assert_allclose(dv, rdv, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(lens, rlens)
    for enc in (port, ref):
        with pytest.raises(ValueError, match="packing"):
            enc.encode_documents(TEXTS, pack=True)


def test_convert_gte_state_dict_matches_jax():
    """The same HF NewModel-named state dict through both converters."""
    cfg = port_gte.GTEConfig.tiny(**TINY)
    g = torch.Generator().manual_seed(0)
    h, inter = 32, 64

    def r(*shape):
        return torch.randn(*shape, generator=g)

    hf = {"embeddings.word_embeddings.weight": r(200, h), "embeddings.token_type_embeddings.weight": r(1, h),
          "embeddings.LayerNorm.weight": r(h), "embeddings.LayerNorm.bias": r(h)}
    for i in range(2):
        p = f"encoder.layer.{i}"
        hf.update({f"{p}.attention.qkv_proj.weight": r(3 * h, h), f"{p}.attention.qkv_proj.bias": r(3 * h),
                   f"{p}.attention.o_proj.weight": r(h, h), f"{p}.attention.o_proj.bias": r(h),
                   f"{p}.attn_ln.weight": r(h), f"{p}.attn_ln.bias": r(h),
                   f"{p}.mlp.up_gate_proj.weight": r(2 * inter, h),
                   f"{p}.mlp.down_proj.weight": r(h, inter), f"{p}.mlp.down_proj.bias": r(h),
                   f"{p}.mlp_ln.weight": r(h), f"{p}.mlp_ln.bias": r(h)})
    hf = {f"new.{k}": v for k, v in hf.items()}
    got = port_gte.convert_gte_state_dict(hf, cfg, prefix="new.")
    want = port_convert.params_from_flax(
        ref_gte.convert_gte_state_dict(hf, ref_gte.GTEConfig.tiny(**TINY), prefix="new."))
    with torch.device("meta"):
        names = set(port_gte.GTEEncoder(cfg).state_dict())
    assert set(got) == set(want) == names
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_params_from_flax_round_trips_the_gte_tree(flax_params):
    sd = port_convert.params_from_flax(flax_params)
    back = port_convert.flax_from_state_dict(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(flax_params))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(leaf, flat_b[path])
