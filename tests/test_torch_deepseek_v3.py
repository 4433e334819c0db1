"""models/deepseek_v3.py and models/moe.py: a tiny seeded DeepSeek-V3-block
encoder (Moonlight's layer pattern: one dense layer, then MoE layers)
against the benchmark's plain float32 reference (``benchmark/reference/
deepseek_v3.py``, written from the published description, importing
nothing of the port), and the MoE layer's pieces on their own: the grouped
products against a loop over experts, the router's bias and weights, the
routing of real tokens only, the interleaved rotary embedding, the
stacking converter, int8 / NF4 quantization of stacked experts, the
family's registration and its spans and counters.

f32 on the CPU. Tolerances: 1e-5 in ``1 - cos`` for a whole forward (the
same products summed in another order through 3 layers); 1e-5 abs for one
layer's outputs; quantizers bit-equal to the host's.
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.models import deepseek_v3 as ds
from codemix_dense_retrieval_torch.models import moe
from codemix_dense_retrieval_torch.models.dialects import default_pooling, detect_encoder_family, query_prefix
from codemix_dense_retrieval_torch.models.encoder import TextEncoder, build_model, quantize_state_dict
from codemix_dense_retrieval_torch.ops import grouped_mm as gmm
from codemix_dense_retrieval_torch.ops import weight_quant as wq
from codemix_dense_retrieval_torch.utils import timing

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "benchmark_reference_deepseek_v3", ROOT / "benchmark" / "reference" / "deepseek_v3.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

# Moonlight's HF config keys at a CPU test's size: 1 dense + 2 MoE layers
HF = dict(model_type="deepseek_v3", vocab_size=200, hidden_size=64, intermediate_size=96,
          moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4, n_routed_experts=8,
          n_shared_experts=1, num_experts_per_tok=2, first_k_dense_replace=1, moe_layer_freq=1,
          kv_lora_rank=24, q_lora_rank=None, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=12,
          n_group=1, topk_group=1, topk_method="noaux_tc", scoring_func="sigmoid", norm_topk_prob=True,
          routed_scaling_factor=2.446, rope_theta=50000, rms_norm_eps=1e-5, max_position_embeddings=256)
STD = 0.2   # wide enough that the routes and the attention differ between tokens


def _weights(seed=0, hf=HF):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in ref.shapes(hf).items():
        w = torch.randn(shape, generator=g) * STD
        out[name] = w + 1.0 if name.endswith("norm.weight") else w
    return out


def _cfg(**kw):
    return ds.DeepseekV3Config.from_hf_config(HF, **kw)


def _model(w, **kw):
    cfg = _cfg(**kw)
    with torch.device("meta"):
        module = ds.DeepseekV3Encoder(cfg)
    return build_model(cfg, torch.device("cpu"), ds.convert_deepseek_v3_state_dict(w, cfg), model=module)


def _batch(lengths=(11, 7, 1, 16), s=16, seed=3):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(2, HF["vocab_size"], size=(len(lengths), s)))
    mask = (torch.arange(s)[None] < torch.tensor(lengths)[:, None]).to(torch.int64)
    return ids.masked_fill(mask == 0, 1), mask


def _cos(a, b):
    return torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=-1)


def test_forward_matches_the_reference_with_the_same_expert_sets():
    w = _weights()
    model = _model(w)
    ids, mask = _batch()
    seen = []
    inner = moe.SigmoidRouter.forward

    def spy(self, x):
        chosen, weights = inner(self, x)
        seen.append(chosen)
        return chosen, weights

    moe.SigmoidRouter.forward = spy
    try:
        with torch.no_grad():
            got = model(ids, mask, token_count=int(mask.sum()))
    finally:
        moe.SigmoidRouter.forward = inner
    refs, want = [], []
    for row, m in zip(ids, mask):
        routes = []
        want.append(ref.embed(w, HF, row[: int(m.sum())].tolist(), routes))
        refs.append(routes)
    assert (1 - _cos(got, torch.stack(want))).max() <= 1e-5
    assert len(seen) == 2
    for layer, chosen in enumerate(seen):
        expect = torch.cat([r[layer] for r in refs])
        assert torch.equal(chosen.sort(dim=1).values, expect.sort(dim=1).values), layer


def test_the_count_read_from_the_card_gives_the_same_forward():
    model = _model(_weights())
    ids, mask = _batch()
    with torch.no_grad():
        a = model(ids, mask, token_count=int(mask.sum()))
        b = model(ids, mask)
    assert torch.equal(a, b)


def test_grouped_products_match_a_loop_over_experts():
    g = torch.Generator().manual_seed(5)
    x, w = torch.randn(20, 12, generator=g), torch.randn(4, 12, 8, generator=g)
    offsets = torch.tensor([3, 3, 11, 20], dtype=torch.int32)    # expert 1 takes no row
    loop = torch.cat([x[:3] @ w[0], x[3:11] @ w[2], x[11:] @ w[3]])
    assert torch.allclose(gmm.grouped_mm_plain(x, w, offsets), loop, atol=1e-6)
    assert torch.allclose(torch._grouped_mm(x, w, offs=offsets), loop, atol=1e-5)
    assert torch.allclose(gmm.grouped_mm(x, w, offsets), loop, atol=1e-6)


def _moe_layer(seed=0, bias=None):
    w = _weights(seed)
    model = _model(w)
    layer = model.layers[1].mlp
    if bias is not None:
        layer.gate.e_score_correction_bias.copy_(bias)
    return layer


def _moe_loop(layer, x):
    """Each token through its chosen experts one at a time (no sorting)."""
    chosen, weights = layer.gate(x)
    gu, down = layer.experts.gate_up_proj.weight, layer.experts.down_proj.weight
    f = layer.experts.width
    out = []
    for t in range(x.shape[0]):
        acc = torch.zeros(x.shape[1])
        for e, wt in zip(chosen[t].tolist(), weights[t]):
            h = gu[e] @ x[t]
            acc += wt * (down[e] @ (torch.nn.functional.silu(h[:f]) * h[f:]))
        out.append(acc)
    return torch.stack(out) + layer.shared_experts(x)


def test_moe_layer_matches_a_token_by_token_loop_and_zeroes_the_pads():
    layer = _moe_layer()
    h = torch.randn(3, 5, 64, generator=torch.Generator().manual_seed(1))
    index = torch.tensor([0, 1, 2, 5, 6, 10])
    with torch.no_grad():
        out = layer(h, index).reshape(15, 64)
        want = _moe_loop(layer, h.reshape(15, 64)[index])
    assert (out[index] - want).abs().max() <= 1e-5
    rest = torch.ones(15, dtype=torch.bool)
    rest[index] = False
    assert torch.equal(out[rest], torch.zeros_like(out[rest]))


def test_the_bias_chooses_but_does_not_weigh_and_the_weights_sum_to_the_scale():
    bias = torch.zeros(8)
    bias[[3, 6]] = 5.0                           # every token chooses experts 3 and 6
    layer = _moe_layer(bias=bias)
    x = torch.randn(9, 64, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        chosen, weights = layer.gate(x)
        s = torch.sigmoid(x @ layer.gate.weight.T)
    assert torch.equal(chosen.sort(dim=1).values, torch.tensor([[3, 6]]).expand(9, 2))
    want = s.gather(1, chosen)
    assert torch.allclose(weights, want / want.sum(dim=1, keepdim=True) * 2.446, atol=1e-6)
    assert torch.allclose(weights.sum(dim=1), torch.full((9,), 2.446), atol=1e-6)


def test_pads_are_never_routed_and_a_skewed_router_drops_no_token(monkeypatch):
    bias = torch.zeros(8)
    bias[[0, 1]] = 50.0                          # all routed rows go to two experts
    layer = _moe_layer(bias=bias)
    seen = []
    inner = gmm.grouped_mm_plain

    def spy(x, w, offsets):
        seen.append(offsets.clone())
        return inner(x, w, offsets)

    monkeypatch.setattr(gmm, "grouped_mm_plain", spy)
    h = torch.randn(2, 8, 64, generator=torch.Generator().manual_seed(4))
    index = torch.tensor([0, 1, 2, 3, 8, 9, 10])   # rows of 4 and 3 real tokens, right-padded
    with torch.no_grad():
        out = layer(h, index).reshape(16, 64)
        want = _moe_loop(layer, h.reshape(16, 64)[index])
    assert len(seen) == 2
    for offsets in seen:
        counts = torch.diff(offsets, prepend=offsets.new_zeros(1))
        assert counts.tolist() == [7, 7, 0, 0, 0, 0, 0, 0]
    assert (out[index] - want).abs().max() <= 1e-5
    assert out[[4, 5, 6, 7, 11, 12, 13, 14, 15]].abs().max() == 0


def test_interleaved_rotary_turns_each_adjacent_pair():
    x = torch.randn(1, 3, 2, 4, generator=torch.Generator().manual_seed(6))
    pos = torch.arange(3)[None]
    got = ds.rope_interleaved(x, pos, 100.0)
    for p in range(3):
        for i, freq in ((0, 1.0), (1, 100.0 ** -0.5)):
            a = p * freq
            x0, x1 = x[0, p, :, 2 * i], x[0, p, :, 2 * i + 1]
            want = torch.stack([x0 * np.cos(a) - x1 * np.sin(a), x0 * np.sin(a) + x1 * np.cos(a)], dim=-1)
            assert torch.allclose(got[0, p, :, 2 * i: 2 * i + 2], want, atol=1e-6)
    # the reference's complex-number rotation agrees
    assert torch.allclose(ref.rotary(x[0].transpose(0, 1), 100.0), got[0].transpose(0, 1), atol=1e-6)


def test_the_converter_stacks_every_hf_expert_and_keeps_every_other_name():
    w = _weights()
    cfg = _cfg()
    hf = {f"model.{k}": v for k, v in w.items()}
    hf["lm_head.weight"] = torch.zeros(200, 64)
    sd = ds.convert_deepseek_v3_state_dict(hf, cfg, prefix="model.")
    with torch.device("meta"):
        names = set(ds.DeepseekV3Encoder(cfg).state_dict())
    assert set(sd) == names
    f = HF["moe_intermediate_size"]
    used = set()
    for name, t in w.items():
        parts = name.split(".")
        if "experts" in parts and "shared_experts" not in parts:
            i, e, proj = parts[1], int(parts[4]), parts[5]
            stack = sd[f"layers.{i}.mlp.experts.{'down_proj' if proj == 'down_proj' else 'gate_up_proj'}.weight"]
            part = {"gate_proj": stack[e, :f], "up_proj": stack[e, f:], "down_proj": stack[e]}[proj]
            assert torch.equal(part, t), name
        else:
            assert torch.equal(sd[name], t), name
        used.add(name)
    assert used == set(w)


def test_family_detection_pooling_and_prefixes():
    for name in ("moonshotai/Moonlight-16B-A3B", "deepseek-ai/DeepSeek-V3", "moonshotai/Kimi-K2-Instruct"):
        assert detect_encoder_family(name) == "deepseek-v3"
        assert default_pooling(name) == "last_token" and query_prefix(name) == ""


@pytest.mark.parametrize("key,value", [("q_lora_rank", 1536), ("n_group", 8), ("scoring_func", "softmax"),
                                       ("topk_method", "greedy"), ("rope_scaling", {"type": "yarn", "factor": 40})])
def test_the_config_refuses_what_the_module_does_not_compute(key, value):
    with pytest.raises(ValueError, match=key):
        ds.DeepseekV3Config.from_hf_config({**HF, key: value})


def test_moonlight_widths_from_its_published_config():
    cfg = json.loads((ROOT / "benchmark" / "configs" / "moonlight-16b-a3b-17l.json").read_text())["model"]
    c = ds.DeepseekV3Config.from_hf_config({**cfg, "num_hidden_layers": 27})
    assert c == ds.DeepseekV3Config()
    assert [c.is_moe(i) for i in range(3)] == [False, True, True]


@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_stacked_quantization_equals_the_host_quantizer_per_expert(mode):
    w = torch.randn(3, 40, 24, generator=torch.Generator().manual_seed(7))
    w[1, :, 5] = 0.0                              # a zero channel: scale 1
    q = wq.quantize_stacked(w, mode)
    leaf = wq._quantize_leaf_int8 if mode == "int8" else wq._quantize_leaf_nf4
    for e in range(3):
        one = leaf(w[e].numpy())
        assert np.array_equal(np.asarray(q.codes[e]), one.codes) and np.array_equal(np.asarray(q.scale[e]), one.scale)
        assert torch.equal(q.dequantize(torch.float32)[e], one.dequantize(torch.float32))
    assert q.shape == (3, 40, 24)


def test_int8_quantizes_every_expert_and_the_dense_kernels_but_not_the_router():
    hf = {**HF, "hidden_size": 256, "moe_intermediate_size": 256, "intermediate_size": 512,
          "kv_lora_rank": 128}
    w = _weights(hf=hf)
    cfg = ds.DeepseekV3Config.from_hf_config(hf)
    sd = ds.convert_deepseek_v3_state_dict(w, cfg)
    q = quantize_state_dict(sd, "int8")
    assert "layers.1.mlp.gate.weight" not in q and "embed_tokens.weight" not in q
    for i in (1, 2):
        for name in ("gate_up_proj", "down_proj"):
            stack = q[f"layers.{i}.mlp.experts.{name}.weight"]
            assert stack.kind == "int8" and stack.shape == tuple(sd[f"layers.{i}.mlp.experts.{name}.weight"]
                                                                  .transpose(1, 2).shape)
    assert "layers.0.mlp.gate_proj.weight" in q and "layers.1.mlp.shared_experts.up_proj.weight" in q
    with torch.device("meta"):
        module = ds.DeepseekV3Encoder(cfg)
    model = build_model(cfg, torch.device("cpu"), sd, model=module, weight_quant="int8")
    assert isinstance(model.layers[2].mlp.experts.down_proj, wq.QuantGroupedLinear)
    with torch.device("meta"):
        module = ds.DeepseekV3Encoder(cfg)
    full = build_model(cfg, torch.device("cpu"), sd, model=module)
    ids, mask = _batch()
    ids = ids % 200
    with torch.no_grad():
        a, b = model(ids, mask), full(ids, mask)
    assert (1 - _cos(a, b)).max() < 0.05 and not torch.equal(a, b)


def _encoder(w, **kw):
    cfg = _cfg()
    with torch.device("meta"):
        module = ds.DeepseekV3Encoder(cfg)
    return TextEncoder("moonshotai/Moonlight-16B-A3B", cfg, ds.convert_deepseek_v3_state_dict(w, cfg),
                       model=module, device="cpu", **kw)


def test_text_encoder_passes_the_real_token_count_and_packs_alike(monkeypatch):
    enc = _encoder(_weights())
    counts = []
    inner = ds.DeepseekV3Encoder.forward

    def spy(self, ids, mask, task_id=None, token_count=None):
        counts.append((token_count, int(mask.sum())))
        return inner(self, ids, mask, task_id, token_count)

    monkeypatch.setattr(ds.DeepseekV3Encoder, "forward", spy)
    texts = ["a b c d e f g", "h i", "j k l m n o p q r s t u v", "w"]
    got = enc.encode_documents(texts, batch_size=3)
    assert counts and all(a == b for a, b in counts)
    packed = enc.encode_documents(texts, batch_size=3, pack=True)
    assert np.abs(got - packed).max() <= 1e-5
    ids, mask = enc.tokenizer.encode_batch(texts, 64)
    with torch.no_grad():
        want = inner(enc.model, torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    assert np.abs(got - want.numpy()).max() <= 1e-5


def test_a_traced_forward_counts_routed_rows_and_times_each_step():
    model = _model(_weights())
    ids, mask = _batch()
    n = int(mask.sum())
    timing.reset()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]), torch.no_grad():
            model(ids, mask, token_count=n)
        t = timing.totals()
    finally:
        timing.reset()
    c, spans = t["counters"], t["spans"]
    assert c["moe.layer_calls"] == 2 and c["moe.routed_rows"] == 2 * n * 2
    assert len(c["moe.expert_rows"]) == 8 and sum(c["moe.expert_rows"]) == c["moe.routed_rows"]
    for name in ("moe.route", "moe.dispatch", "moe.experts", "moe.combine"):
        assert spans[name]["count"] == 2, name
    assert spans["mla.attention"]["count"] == 3


def test_load_encoder_reads_an_hf_directory_and_convert_keeps_it(tmp_path):
    from codemix_dense_retrieval_torch.cli import main
    from codemix_dense_retrieval_torch.models.registry import load_encoder

    w = _weights()
    src = tmp_path / "hf"
    src.mkdir()
    (src / "config.json").write_text(json.dumps({**HF, "architectures": ["DeepseekV3ForCausalLM"]}))
    torch.save({f"model.{k}": v for k, v in w.items()}, src / "pytorch_model.bin")
    texts = ["a b c", "d e f g h i j", "k"]
    want = _encoder(w).encode_documents(texts)
    enc = load_encoder("moonshotai/Moonlight-16B-A3B", str(src), device="cpu")
    assert isinstance(enc.model, ds.DeepseekV3Encoder)
    assert np.abs(enc.encode_documents(texts) - want).max() <= 1e-6
    main(["convert", "--encoder", "moonshotai/Moonlight-16B-A3B", "--src", str(src), "--out", str(tmp_path / "ck")])
    back = load_encoder("moonshotai/Moonlight-16B-A3B", str(tmp_path / "ck"), device="cpu")
    assert np.abs(back.encode_documents(texts) - want).max() <= 1e-6
