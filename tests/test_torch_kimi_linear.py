"""models/kimi_linear.py, ops/kda.py and the expert share of models/moe.py:
a tiny seeded Kimi Linear encoder (three KDA layers, one NoPE latent
attention layer; one dense layer, then MoE layers holding a share of the
experts) against the benchmark's plain float32 reference
(``benchmark/reference/kimi_linear.py``: the KDA state token by token,
written from the published description, importing nothing of the port);
the chunked scan's plain version against the reference's recurrence; the
expert shares of one layer against the uncut layer; the MoE layer and the
latent attention unchanged where every expert is held and rope is on.

f32 on the CPU. Tolerances: 1e-5 in ``1 - cos`` for a whole forward and
1e-5 abs for one layer (the same products summed in another order; 1e-5
of the largest output for eight expert shares summed); 1e-5
relative for the scan (the chunk form against the token loop in f64,
both exact up to f32 rounding over 200 tokens); bit-equal where the code
path is unchanged.
"""

import importlib.util
import pathlib
import sys

import pytest
import torch

from codemix_dense_retrieval_torch.models import deepseek_v3 as ds
from codemix_dense_retrieval_torch.models import kimi_linear as kl
from codemix_dense_retrieval_torch.models import moe
from codemix_dense_retrieval_torch.models.dialects import default_pooling, detect_encoder_family
from codemix_dense_retrieval_torch.models.encoder import build_model
from codemix_dense_retrieval_torch.ops.kda import kda_chunk, kda_chunk_plain

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "benchmark"))   # the reference imports its sibling module
_spec = importlib.util.spec_from_file_location("benchmark_reference_kimi_linear",
                                               ROOT / "benchmark" / "reference" / "kimi_linear.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)
_spec = importlib.util.spec_from_file_location("benchmark_reference_deepseek_v3_k",
                                               ROOT / "benchmark" / "reference" / "deepseek_v3.py")
ref_ds = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref_ds)

STD = 0.2
# Kimi Linear's HF config keys at a CPU test's size: KDA x3 + NoPE MLA,
# 1 dense + 3 MoE layers holding experts [4, 12) of 16
HF = dict(model_type="kimi_linear", vocab_size=200, hidden_size=64, intermediate_size=96,
          moe_intermediate_size=32, num_hidden_layers=4, num_attention_heads=4, num_experts=8,
          expert_shard={"experts_total": 16, "held": [4, 12], "chips": 2}, num_shared_experts=1,
          num_experts_per_token=3, first_k_dense_replace=1, moe_layer_freq=1, kv_lora_rank=24,
          q_lora_rank=None, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=12, num_expert_group=1,
          topk_group=1, moe_router_activation_func="sigmoid", moe_renormalize=True, mla_use_nope=True,
          routed_scaling_factor=2.446, rope_theta=10000, rms_norm_eps=1e-5, max_position_embeddings=256,
          rope_scaling=None, decay_draw_std=STD,
          linear_attn_config={"full_attn_layers": [4], "kda_layers": [1, 2, 3], "head_dim": 16,
                              "num_heads": 2, "short_conv_kernel_size": 4})


def _weights(hf=HF, seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in ref.shapes(hf).items():
        w = torch.randn(shape, generator=g) * STD
        out[name] = w + 1.0 if name.endswith("norm.weight") else w
    return out


def _port_weights(w, hf=HF):
    out = dict(w)
    for name in w:
        if name.endswith("A_log"):
            p = name[: -len("A_log")]
            out[p + "A_log"], out[p + "dt_bias"] = ref.decay_params(w[name], w[p + "dt_bias"], STD)
    return out


def _model(w, hf=HF):
    cfg = kl.KimiLinearConfig.from_hf_config(hf)
    with torch.device("meta"):
        module = kl.KimiLinearEncoder(cfg)
    params = kl.convert_kimi_linear_state_dict(_port_weights(w, hf), cfg)
    return build_model(cfg, torch.device("cpu"), params, model=module)


def _cos(a, b):
    return torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=-1)


def _scan_inputs(b, s, h=2, d=16, seed=1):
    g = torch.Generator().manual_seed(seed)
    q = torch.nn.functional.normalize(torch.randn(b, s, h, d, generator=g), dim=-1) * d ** -0.5
    k = torch.nn.functional.normalize(torch.randn(b, s, h, d, generator=g), dim=-1)
    v = torch.randn(b, s, h, d, generator=g)
    # per-step log decays from 0 to -20, by channel
    rate = torch.cat([torch.zeros(1), torch.logspace(-3, 1.30103, d - 1)])
    gd = -torch.rand(b, s, h, d, generator=g) * rate
    beta = torch.rand(b, s, h, generator=g)
    beta[:, ::5] = 0.0
    beta[:, 2::5] = 1.0
    return q, k, v, gd, beta


def _recurrence(q, k, v, gd, beta, seg):
    """The reference's token loop per segment, in f64."""
    out = torch.zeros(v.shape, dtype=torch.float64)
    for b in range(q.shape[0]):
        for sid in seg[b].unique().tolist():
            if sid == 0:
                continue
            at = (seg[b] == sid).nonzero().flatten()
            out[b, at] = ref.scan(*(t[b, at].double() for t in (q, k, v, gd, beta)))
    return out


@pytest.mark.parametrize("packed", [False, True])
def test_chunked_scan_matches_the_reference_recurrence(packed):
    lengths = torch.tensor([1, 63, 64, 65, 200])
    q, k, v, gd, beta = _scan_inputs(5, 200)
    if packed:
        # segments crossing chunk ends, pads at the ends and between rows
        seg = torch.zeros(5, 200, dtype=torch.int32)
        for b, cuts in enumerate([(0, 30, 100, 190), (0, 64, 65, 129), (0, 5, 70, 200), (3, 67), (0, 1, 2, 200)]):
            for i, (a, z) in enumerate(zip(cuts[:-1], cuts[1:])):
                seg[b, a:z] = i + 1
        got = kda_chunk_plain(q, k, v, gd, beta, segment_ids=seg)
    else:
        seg = (torch.arange(200)[None] < lengths[:, None]).to(torch.int32)
        got = kda_chunk(q, k, v, gd, beta, lengths=lengths)
    want = _recurrence(q, k, v, gd, beta, seg)
    assert torch.isfinite(got).all()
    assert (got.double() - want).abs().max() <= 1e-5 * want.abs().max()
    assert (got[seg == 0] == 0).all()


def test_the_scan_does_not_leak_across_segments():
    q, k, v, gd, beta = _scan_inputs(1, 130)
    seg = torch.ones(1, 130, dtype=torch.int32)
    seg[0, 50:] = 2
    a = kda_chunk_plain(q, k, v, gd, beta, segment_ids=seg)
    v2 = v.clone()
    v2[0, :50] = torch.randn(50, 2, 16)
    b = kda_chunk_plain(q, k, v2, gd, beta, segment_ids=seg)
    assert torch.equal(a[0, 50:], b[0, 50:]) and not torch.equal(a[0, :50], b[0, :50])


@pytest.mark.parametrize("packed", [False, True])
def test_encoder_matches_the_reference(packed):
    w = _weights()
    model = _model(w)
    lengths = (11, 7, 1, 16)
    g = torch.Generator().manual_seed(3)
    texts = [torch.randint(2, HF["vocab_size"], (n,), generator=g) for n in lengths]
    want_rows = [ref.hidden(w, HF, t.tolist()) for t in texts]
    with torch.no_grad():
        if packed:
            # two rows: texts 0 + 2 + 3 and text 1, positions restarting per segment
            rows = [[0, 2, 3], [1]]
            s = 28
            ids = torch.ones(2, s, dtype=torch.long)
            seg = torch.zeros(2, s, dtype=torch.int32)
            pos = torch.zeros(2, s, dtype=torch.long)
            starts, lens = torch.zeros(2, 3, dtype=torch.long), torch.zeros(2, 3, dtype=torch.long)
            for r, members in enumerate(rows):
                at = 0
                for j, m in enumerate(members):
                    n = lengths[m]
                    ids[r, at: at + n], seg[r, at: at + n] = texts[m], j + 1
                    pos[r, at: at + n] = torch.arange(n)
                    starts[r, j], lens[r, j] = at, n
                    at += n
            pooled, tokens = model.packed_embed_with_tokens(ids, seg, pos, starts, lens, max_segments=3)
            got = [pooled[0, 0], pooled[1, 0], pooled[0, 1], pooled[0, 2]]
            got_tok = [tokens[r, starts[r, j]: starts[r, j] + lens[r, j]] for r, ms in enumerate(rows)
                       for j, _ in enumerate(ms)]
            order = [m for ms in rows for m in ms]
            got_tok = [got_tok[order.index(i)] for i in range(4)]
        else:
            s = max(lengths)
            ids = torch.ones(4, s, dtype=torch.long)
            mask = torch.zeros(4, s, dtype=torch.int64)
            for i, t in enumerate(texts):
                ids[i, : len(t)], mask[i, : len(t)] = t, 1
            pooled, tokens = model.embed_with_tokens(ids, mask, token_count=int(mask.sum()))
            got = list(pooled)
            got_tok = [tokens[i, : n] for i, n in enumerate(lengths)]
    want = torch.stack([h[-1] / h[-1].norm() for h in want_rows])
    assert (1 - _cos(torch.stack(got), want)).max() <= 1e-5
    for t, h in zip(got_tok, want_rows):
        assert (1 - _cos(t, h / h.norm(dim=-1, keepdim=True))).max() <= 1e-5


def _moe_cfg(held):
    hf = dict(HF, num_experts=held[1] - held[0], expert_shard={"experts_total": 32, "held": list(held)})
    return hf, kl.KimiLinearConfig.from_hf_config(hf)


def _moe_layer(w, held, layer=1):
    """The port's MoE layer of ``layer`` holding ``held`` of 32 experts,
    loaded from the uncut weights ``w``."""
    hf, cfg = _moe_cfg(held)
    sd = kl.convert_kimi_linear_state_dict(_port_weights(w, dict(HF, num_experts=32, expert_shard=None)), cfg)
    p = f"layers.{layer}.mlp."
    mod = moe.MoeLayer(cfg, held=cfg.experts_held)
    mod.load_state_dict({k[len(p):]: v for k, v in sd.items() if k.startswith(p)})
    return mod.eval()


def test_the_expert_shares_add_up_to_the_uncut_layer():
    full = dict(HF, num_experts=32, expert_shard=None)
    w = _weights(full, seed=4)
    x = torch.randn(2, 9, HF["hidden_size"], generator=torch.Generator().manual_seed(6))
    index = torch.arange(18)
    with torch.no_grad():
        shares = [_moe_layer(w, (lo, lo + 4))(x, index) for lo in range(0, 32, 4)]
        shared = _moe_layer(w, (0, 4)).shared_experts(x)
    summed = sum(shares) - (len(shares) - 1) * shared
    want = ref.moe(w, "layers.1.block_sparse_moe.", full, x.reshape(-1, HF["hidden_size"]), None)
    # 8 partial outputs of size ~5 summed, 7 shared outputs taken back out
    assert (summed.reshape(-1, HF["hidden_size"]) - want).abs().max() <= 1e-5 * want.abs().max()
    # and a share is the reference's layer on that card
    card = dict(full, num_experts=4, expert_shard={"experts_total": 32, "held": [8, 12]})
    want8 = ref.moe(w, "layers.1.block_sparse_moe.", card, x.reshape(-1, HF["hidden_size"]), None)
    assert (shares[2].reshape(-1, HF["hidden_size"]) - want8).abs().max() <= 1e-5


def _todays_forward(self, h, token_index):
    """MoeLayer.forward before expert shares (every expert held)."""
    flat = h.reshape(-1, h.shape[-1])
    n, k = token_index.shape[0], self.top_k
    x = flat.index_select(0, token_index)
    chosen, weights = self.gate(x)
    ids, order = torch.sort(chosen.reshape(-1), stable=True)
    offsets = torch.searchsorted(ids, torch.arange(self.experts_n, dtype=ids.dtype), right=True).to(torch.int32)
    ys = self.experts(x.index_select(0, order // k), offsets)
    rows = torch.empty_like(ys).index_copy_(0, order, ys).reshape(n, k, -1)
    routed = (rows.to(torch.float32) * weights[..., None]).sum(dim=1).to(h.dtype)
    return torch.zeros_like(flat).index_copy_(0, token_index, routed + self.shared_experts(x)).reshape(h.shape)


def test_every_expert_held_is_todays_layer_bit_for_bit():
    cfg = ds.DeepseekV3Config.tiny()
    g = torch.Generator().manual_seed(2)
    layer = moe.MoeLayer(cfg)
    for p in layer.parameters():
        p.data = torch.randn(p.shape, generator=g) * STD
    x = torch.randn(3, 5, cfg.hidden_size, generator=g)
    index = torch.tensor([0, 1, 2, 5, 6, 10, 14])
    held = moe.MoeLayer(cfg, held=(0, cfg.n_routed_experts))
    held.load_state_dict(layer.state_dict())
    with torch.no_grad():
        assert torch.equal(layer(x, index), _todays_forward(layer, x, index))
        assert torch.equal(held(x, index), _todays_forward(layer, x, index))
    with pytest.raises(ValueError):
        moe.MoeLayer(cfg, held=(4, 2))


@pytest.mark.parametrize("use_rope", [True, False])
def test_latent_attention_with_and_without_rope(use_rope):
    hf = dict(model_type="deepseek_v3", vocab_size=50, hidden_size=32, intermediate_size=64,
              moe_intermediate_size=16, num_hidden_layers=1, num_attention_heads=2, n_routed_experts=4,
              n_shared_experts=1,
              num_experts_per_tok=2, first_k_dense_replace=1, kv_lora_rank=16, q_lora_rank=None,
              qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8, rope_theta=10000, rms_norm_eps=1e-5)
    cfg = ds.DeepseekV3Config.from_hf_config(hf)
    g = torch.Generator().manual_seed(8)
    w = {k: torch.randn(s, generator=g) * STD + (1.0 if k.endswith("norm.weight") else 0.0)
         for k, s in ref_ds.shapes(hf).items() if "self_attn" in k}
    attn = ds.MlaAttention(cfg, use_rope=use_rope) if not use_rope else ds.MlaAttention(cfg)
    attn.load_state_dict({k[len("layers.0.self_attn."):]: v for k, v in w.items()})
    x = torch.randn(1, 6, 32, generator=g)
    with torch.no_grad():
        got = attn(x, torch.arange(6)[None], torch.tensor([6]))[0]
    forward = ref_ds.attention if use_rope else ref.attention
    want = forward(w, "layers.0.self_attn.", hf, x[0])
    assert (got - want).abs().max() <= 1e-5


@pytest.mark.parametrize("key,value", [("q_lora_rank", 64), ("num_expert_group", 2),
                                       ("moe_router_activation_func", "softmax"),
                                       ("rope_scaling", {"type": "yarn"}), ("mla_use_nope", False),
                                       ("linear_attn_config", None)])
def test_from_hf_config_raises_on_what_it_does_not_compute(key, value):
    with pytest.raises(ValueError):
        kl.KimiLinearConfig.from_hf_config(dict(HF, **{key: value}))


def test_the_family_is_registered():
    assert detect_encoder_family("moonshotai/Kimi-Linear-48B-A3B-Instruct") == "kimi-linear"
    assert default_pooling("moonshotai/Kimi-Linear-48B-A3B-Instruct") == "last_token"
    cfg = kl.KimiLinearConfig.from_hf_config(HF)
    assert cfg.experts_held == (4, 12) and cfg.n_routed_experts == 16
    assert [cfg.is_kda(i) for i in range(4)] == [True, True, True, False]


def test_load_encoder_reads_an_hf_directory_and_convert_keeps_it(tmp_path):
    """An HF directory holding all 16 experts, whose config.json holds
    [4, 12): loading and ``convert`` stack the held experts."""
    import json

    import numpy as np

    from codemix_dense_retrieval_torch.cli import main
    from codemix_dense_retrieval_torch.models.encoder import TextEncoder
    from codemix_dense_retrieval_torch.models.registry import load_encoder

    name = "moonshotai/Kimi-Linear-48B-A3B-Instruct"
    full = dict(HF, num_experts=16, expert_shard=None)
    w = _weights(full)
    src = tmp_path / "hf"
    src.mkdir()
    (src / "config.json").write_text(json.dumps({**HF, "architectures": ["KimiLinearForCausalLM"]}))
    torch.save({f"model.{k}": v for k, v in _port_weights(w, full).items()}, src / "pytorch_model.bin")
    cfg = kl.KimiLinearConfig.from_hf_config(HF)
    with torch.device("meta"):
        module = kl.KimiLinearEncoder(cfg)
    want_enc = TextEncoder(name, cfg, kl.convert_kimi_linear_state_dict(_port_weights(w, full), cfg), model=module,
                           device="cpu")
    texts = ["a b c", "d e f g h i j", "k"]
    want = want_enc.encode_documents(texts)
    enc = load_encoder(name, str(src), device="cpu")
    assert isinstance(enc.model, kl.KimiLinearEncoder) and enc.cfg.experts_held == (4, 12)
    assert np.abs(enc.encode_documents(texts) - want).max() <= 1e-6
    main(["convert", "--encoder", name, "--src", str(src), "--out", str(tmp_path / "ck")])
    back = load_encoder(name, str(tmp_path / "ck"), device="cpu")
    assert np.abs(back.encode_documents(texts) - want).max() <= 1e-6
