"""models/qwen3.py: the Qwen3-Embedding decoder against the JAX package's on
the same weights (the Flax params carried across) and the same token ids.
Hidden states, last-token pooling, the packed forward (RoPE positions
restarting at 0 per segment) and the HF converter; attention with flash on
(kernel B's plain version here, the Pallas kernel in interpret mode there)
and off. f32, tolerance 2e-5 abs: the same products summed in another order
through 2 layers and a softmax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.models import convert as port_convert
from codemix_dense_retrieval_torch.models import encoder as port_encoder
from codemix_dense_retrieval_torch.models import qwen3 as port_qwen3
from codemix_dense_retrieval_torch.models.packing import pack_sequences
from codemix_dense_retrieval_tpu.models import encoder as ref_encoder
from codemix_dense_retrieval_tpu.models import qwen3 as ref_qwen3

ATOL = 2e-5
TINY = dict(vocab_size=120, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=16, intermediate_size=64, max_position_embeddings=128)


def _ids(seed, b=3, s=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 119, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    for i, n in enumerate([s, s - 4, 5][:b]):
        ids[i, n:] = 1
        mask[i, n:] = 0
    return ids, mask


@pytest.fixture(scope="module")
def flax_params():
    cfg = ref_qwen3.Qwen3Config.tiny(**TINY)
    ids, mask = _ids(0)
    params = ref_qwen3.Qwen3Encoder(cfg).init(jax.random.key(0), jnp.asarray(ids), jnp.asarray(mask))
    # perturbed norm scales so every leaf is exercised
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def _port(params, use_flash):
    cfg = port_qwen3.Qwen3Config.tiny(**TINY, use_flash=use_flash)
    with torch.device("meta"):
        module = port_qwen3.Qwen3Encoder(cfg)
    return port_encoder.build_model(cfg, torch.device("cpu"), params, model=module)


def _ref(use_flash):
    return ref_qwen3.Qwen3Encoder(ref_qwen3.Qwen3Config.tiny(**TINY, use_flash=use_flash))


@pytest.mark.parametrize("use_flash", [False, True])
def test_hidden_states_and_last_token_pooling_match_jax(flax_params, use_flash):
    ids, mask = _ids(2)
    m = _ref(use_flash)
    want_h = np.asarray(m.apply(flax_params, jnp.asarray(ids), jnp.asarray(mask), method=m.hidden_states))
    want = np.asarray(m.apply(flax_params, jnp.asarray(ids), jnp.asarray(mask)))
    model = _port(port_convert.params_from_flax(flax_params), use_flash)
    t_ids, t_mask = torch.from_numpy(ids).long(), torch.from_numpy(mask).long()
    with torch.no_grad():
        got_h = model.hidden_states(t_ids, t_mask).numpy()
        got = model(t_ids, t_mask).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got_h[valid], want_h[valid], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("use_flash", [False, True])
def test_packed_embeddings_match_jax(flax_params, use_flash):
    rng = np.random.default_rng(9)
    rows = sorted((rng.integers(3, 119, size=rng.integers(1, 14)).astype(np.int32) for _ in range(9)),
                  key=len, reverse=True)
    p = pack_sequences(rows, 32, 0, 4, pos_offset=0, pos_pad=0)
    m = _ref(use_flash)
    want = np.asarray(m.apply(
        flax_params, jnp.asarray(p.ids), jnp.asarray(p.segment_ids), jnp.asarray(p.position_ids),
        jnp.asarray(p.seg_starts), jnp.asarray(p.seg_lengths), None, max_segments=4,
        method="packed_embeddings"))
    model = _port(port_convert.params_from_flax(flax_params), use_flash)
    args = [torch.from_numpy(np.asarray(a)).long() for a in
            (p.ids, p.segment_ids, p.position_ids, p.seg_starts, p.seg_lengths)]
    args[1] = args[1].int()
    with torch.no_grad():
        got = model.packed_embeddings(*args, max_segments=4).numpy()
        pooled, toks = model.packed_embed_with_tokens(*args, max_segments=4)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(pooled.numpy(), got)
    assert toks.shape == (*p.ids.shape, 32) and (toks.numpy()[p.segment_ids == 0] == 0).all()


def test_text_encoder_packed_encode_matches_jax(flax_params):
    """TextEncoder(model=Qwen3Encoder): the query prompt, last-token pooling
    and pack=True with the per-segment position restart (PACKED_POS)."""
    texts = [" ".join(f"w{(i * 7 + j) % 40}" for j in range(3 + i % 9)) for i in range(21)]
    cfg_r = ref_qwen3.Qwen3Config.tiny(**TINY)
    ref = ref_encoder.TextEncoder("Qwen/Qwen3-Embedding-0.6B", cfg_r, flax_params,
                                  model=ref_qwen3.Qwen3Encoder(cfg_r), length_buckets=(16, 32))
    cfg_p = port_qwen3.Qwen3Config.tiny(**TINY)
    with torch.device("meta"):
        module = port_qwen3.Qwen3Encoder(cfg_p)
    port = port_encoder.TextEncoder("Qwen/Qwen3-Embedding-0.6B", cfg_p, flax_params, model=module,
                                    length_buckets=(16, 32), device="cpu")
    np.testing.assert_allclose(port.encode_queries(texts[:6]), ref.encode_queries(texts[:6]), atol=ATOL, rtol=0)
    want = ref.encode_documents(texts, batch_size=8, pack=True)
    np.testing.assert_allclose(port.encode_documents(texts, batch_size=8, pack=True), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(port.encode_documents(texts, batch_size=8), want, atol=5e-5, rtol=0)


def test_rope_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.tile(np.arange(5), (2, 1)).astype(np.int32)
    pos[1] = [0, 1, 2, 0, 1]
    want = np.asarray(ref_qwen3.rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    got = port_qwen3.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_convert_qwen3_state_dict_matches_jax():
    """The same HF-named state dict through both converters (an LM head and
    a prefix included, as real checkpoints have)."""
    cfg = port_qwen3.Qwen3Config.tiny(**TINY)
    with torch.device("meta"):
        shapes = port_qwen3.Qwen3Encoder(cfg).state_dict()
    g = torch.Generator().manual_seed(0)
    hf = {f"model.{k}": torch.randn(v.shape, generator=g) for k, v in shapes.items()}
    hf["lm_head.weight"] = torch.randn(120, 32, generator=g)
    got = port_qwen3.convert_qwen3_state_dict(hf, cfg, prefix="model.")
    want = ref_qwen3.convert_qwen3_state_dict(hf, ref_qwen3.Qwen3Config.tiny(**TINY), prefix="model.")
    want_sd = port_convert.params_from_flax(want)
    assert set(got) == set(want_sd) == set(shapes)
    for k in got:
        torch.testing.assert_close(got[k], want_sd[k], rtol=0, atol=0)


def test_params_from_flax_round_trips_the_qwen3_tree(flax_params):
    sd = port_convert.params_from_flax(flax_params)
    with torch.device("meta"):
        names = set(port_qwen3.Qwen3Encoder(port_qwen3.Qwen3Config.tiny(**TINY)).state_dict())
    assert set(sd) == names
    back = port_convert.flax_from_state_dict(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(flax_params))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(leaf, flat_b[path])
