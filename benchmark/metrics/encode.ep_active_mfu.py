"""``encode.ep_active_mfu``: one card's forwards in an expert-parallel
deployment, as a share of the card's bf16 peak, counting the work this card
does: each passage of the window at its own unpadded token count T, over
the window's seconds times 989 TFLOP/s.

Per passage: 2 T times the matmul parameters every token is computed with
on this card (KDA's projections q, k, v, o, f_a, f_b, g_a, g_b and b in the
KDA layers; latent attention's q, kv_a, kv_b and o in the others; the dense
layers' gated MLP; each MoE layer's router over all its experts and its
shared expert), the chunk form's operations of each KDA layer's scan
(``kda_chunk_roofline.scan_ops``, all heads), and causal attention's 2 T^2
heads (q/k width + v width) / 2 in each latent-attention layer. To that the
window adds the held experts' rows: ``moe.expert_rows`` (the port's
histogram of the rows each held expert computed, summed over the window's
forwards and MoE layers) times 2 * 3 * hidden * ``moe_intermediate_size``.
Rows routed to experts held elsewhere are not this card's work. Padding
shows up as waste, not as work. None where the port has no such counter.
Moves ``encode_passages_per_s``."""

import importlib.util
import pathlib

from harness.peaks import BF16_FLOPS

LAYER = "encoder"

_spec = importlib.util.spec_from_file_location(
    "metrics.kda_chunk_roofline_counts", pathlib.Path(__file__).with_name("kda_chunk_roofline.py"))
_counts = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_counts)


def token_params(config) -> dict:
    """Matmul parameters a token is computed with, by layer kind, outside
    the routed experts."""
    m = config["model"]
    h, lin = m["hidden_size"], m["linear_attn_config"]
    kh, kd = lin["num_heads"], lin["head_dim"]
    heads, nope, rope, dv, rank = (m["num_attention_heads"], m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                                   m["v_head_dim"], m["kv_lora_rank"])
    kda = 4 * h * kh * kd + 2 * (h * kd + kd * kh * kd) + h * kh
    mla = h * heads * (nope + rope) + h * (rank + rope) + rank * heads * (nope + dv) + heads * dv * h
    experts = m.get("expert_shard", {}).get("experts_total", m["num_experts"])
    moe = h * experts + 3 * h * m["moe_intermediate_size"] * m["num_shared_experts"]
    dense = 3 * h * m["intermediate_size"]
    return {"kda": kda, "mla": mla, "moe": moe, "dense": dense}


def passage_flops(config, tokens: int) -> float:
    m = config["model"]
    lin, p = m["linear_attn_config"], token_params(config)
    layers = m["num_hidden_layers"]
    n_kda = len(lin["kda_layers"])
    n_moe = sum(1 for i in range(layers) if i >= m["first_k_dense_replace"] and i % m.get("moe_layer_freq", 1) == 0)
    params = n_kda * p["kda"] + (layers - n_kda) * p["mla"] + n_moe * p["moe"] + (layers - n_moe) * p["dense"]
    width = m["qk_nope_head_dim"] + m["qk_rope_head_dim"] + m["v_head_dim"]
    attn = 2.0 * (layers - n_kda) * tokens * tokens * m["num_attention_heads"] * width / 2
    scan = n_kda * lin["num_heads"] * _counts.scan_ops(tokens, lin["head_dim"])
    return 2.0 * params * tokens + attn + scan


def read(r):
    c = r.counters
    if r.trace is None or not c.get("passes") or r.window_s <= 0 or "linear_attn_config" not in r.config["model"]:
        return None
    try:
        from codemix_dense_retrieval_torch.utils import timing

        rows = timing.totals()["counters"].get("moe.expert_rows")
    except (ImportError, AttributeError):   # a port without counters
        return None
    if not rows:
        return None
    m = r.config["model"]
    per_pass = sum(passage_flops(r.config, t) for t in c["pool_tokens"])
    expert = 2.0 * sum(rows) * 3 * m["hidden_size"] * m["moe_intermediate_size"]
    return 100.0 * (c["passes"] * per_pass + expert) / (r.window_s * BF16_FLOPS)
