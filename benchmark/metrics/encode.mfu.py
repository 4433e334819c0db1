"""``encode.mfu``: the corpus encode's forward as a share of the chip's bf16
peak: each passage of the window counted at its own unpadded token count T
as 2 * (matmul parameters outside the embeddings) * T plus attention's
4 * layers * T^2 * (heads * head_dim), halved where attention is causal,
over the window's seconds times 989 TFLOP/s. Padding and packing show up
as waste, not as work. Moves ``encode_passages_per_s``."""

from harness.peaks import BF16_FLOPS

LAYER = "encoder"


def matmul_params(config) -> int:
    m = config["model"]
    h, f, n = m["hidden_size"], m["intermediate_size"], m["num_hidden_layers"]
    heads = m["num_attention_heads"]
    dh = m.get("head_dim", h // heads)
    kv = m.get("num_key_value_heads", heads)
    attn = h * heads * dh * 2 + h * kv * dh * 2          # q, o and k, v
    mlp = (3 if config["mlp"] == "gated" else 2) * h * f
    return n * (attn + mlp)


def passage_flops(config, tokens: int) -> float:
    m = config["model"]
    heads = m["num_attention_heads"]
    dh = m.get("head_dim", m["hidden_size"] // heads)
    attn = 4.0 * m["num_hidden_layers"] * tokens * tokens * heads * dh
    if config["attention"] == "causal":
        attn /= 2
    return 2.0 * matmul_params(config) * tokens + attn


def read(r):
    c = r.counters
    if not c.get("passes") or r.window_s <= 0:
        return None
    per_pass = sum(passage_flops(r.config, t) for t in c["pool_tokens"])
    return 100.0 * c["passes"] * per_pass / (r.window_s * BF16_FLOPS)
