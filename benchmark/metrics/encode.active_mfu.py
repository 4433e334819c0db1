"""``encode.active_mfu``: a mixture-of-experts encoder's forward as a share
of the chip's bf16 peak, counting only the parameters a token is computed
with: each passage of the window at its own unpadded token count T, as 2 *
(active matmul parameters per token) * T plus causal attention's 2 * T^2 *
heads * (q/k width + v width) / 2 a layer, over the window's seconds times
989 TFLOP/s. A token's active parameters: latent attention's four
projections (q, kv_a, kv_b, o) in every layer; the dense layers' gated MLP;
in each MoE layer the router, the shared experts and ``num_experts_per_tok``
routed experts (``encode.mfu`` would count all of the experts held).
Padding shows up as waste, not as work. Moves ``encode_passages_per_s``."""

from harness.peaks import BF16_FLOPS

LAYER = "encoder"


def active_params(config) -> int:
    m = config["model"]
    h, heads = m["hidden_size"], m["num_attention_heads"]
    nope, rope, dv, rank = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"], m["kv_lora_rank"]
    attn = h * heads * (nope + rope) + h * (rank + rope) + rank * heads * (nope + dv) + heads * dv * h
    fe = m["moe_intermediate_size"]
    moe = h * m["n_routed_experts"] + 3 * h * fe * (m["n_shared_experts"] + m["num_experts_per_tok"])
    dense = 3 * h * m["intermediate_size"]
    n_moe = sum(1 for i in range(m["num_hidden_layers"])
                if i >= m["first_k_dense_replace"] and i % m.get("moe_layer_freq", 1) == 0)
    return m["num_hidden_layers"] * attn + n_moe * moe + (m["num_hidden_layers"] - n_moe) * dense


def passage_flops(config, tokens: int) -> float:
    m = config["model"]
    width = m["qk_nope_head_dim"] + m["qk_rope_head_dim"] + m["v_head_dim"]
    attn = 2.0 * m["num_hidden_layers"] * tokens * tokens * m["num_attention_heads"] * width / 2
    return 2.0 * active_params(config) * tokens + attn


def read(r):
    c = r.counters
    if not c.get("passes") or r.window_s <= 0 or "n_routed_experts" not in r.config["model"]:
        return None
    per_pass = sum(passage_flops(r.config, t) for t in c["pool_tokens"])
    return 100.0 * c["passes"] * per_pass / (r.window_s * BF16_FLOPS)
