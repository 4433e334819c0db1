"""Qwen3-Embedding (a Qwen3 decoder) in plain float32 PyTorch.

Written from the Qwen3 technical report (arXiv:2505.09388) and Hugging
Face's ``Qwen3Model`` parameter names: token embeddings, then
``num_hidden_layers`` pre-norm blocks (RMSNorm; grouped-query causal
attention whose queries and keys get a per-head RMSNorm and rotary
position embeddings in the half-split convention, base ``rope_theta``;
residual; RMSNorm; a SiLU-gated feed-forward; residual), a final RMSNorm.
Qwen3-Embedding's embedding is the last token's final hidden state,
L2-normalized. One sequence at a time, unpadded.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch


def layer_names(num_layers: int) -> list:
    names = ["embed_tokens.weight"]
    for i in range(num_layers):
        p = f"layers.{i}."
        names += [p + "input_layernorm.weight", p + "post_attention_layernorm.weight",
                  p + "self_attn.q_norm.weight", p + "self_attn.k_norm.weight"]
        names += [p + f"self_attn.{n}_proj.weight" for n in ("q", "k", "v", "o")]
        names += [p + f"mlp.{n}_proj.weight" for n in ("gate", "up", "down")]
    return names + ["norm.weight"]


def shapes(model: Dict) -> Dict[str, tuple]:
    h, f, v = model["hidden_size"], model["intermediate_size"], model["vocab_size"]
    dh, nq, nkv = model["head_dim"], model["num_attention_heads"], model["num_key_value_heads"]
    out = {}
    for name in layer_names(model["num_hidden_layers"]):
        if name == "embed_tokens.weight":
            out[name] = (v, h)
        elif name.endswith("norm.weight"):
            out[name] = (dh,) if "q_norm" in name or "k_norm" in name else (h,)
        elif "q_proj" in name:
            out[name] = (nq * dh, h)
        elif "k_proj" in name or "v_proj" in name:
            out[name] = (nkv * dh, h)
        elif "o_proj" in name:
            out[name] = (h, nq * dh)
        elif "down_proj" in name:
            out[name] = (h, f)
        else:
            out[name] = (f, h)
    return out


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * weight


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (heads, T, dh) at positions 0..T-1: each pair
    (i, i + dh/2) rotated by pos * theta^(-2i/dh)."""
    dh, t = x.shape[-1], x.shape[-2]
    half = dh // 2
    inv = theta ** (-torch.arange(0, half, dtype=torch.float64, device=x.device) * 2 / dh)
    ang = (torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv).to(torch.float32)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def embed(weights: Dict[str, torch.Tensor], model: Dict, ids: Sequence[int]) -> torch.Tensor:
    """The L2-normalized last-token embedding (hidden_size,) of one sequence."""
    w = weights
    dh, nq, nkv = model["head_dim"], model["num_attention_heads"], model["num_key_value_heads"]
    eps, theta = model["rms_norm_eps"], float(model["rope_theta"])
    dev = w["embed_tokens.weight"].device
    tok = torch.as_tensor(list(ids), dtype=torch.long, device=dev)
    t = len(tok)
    x = w["embed_tokens.weight"][tok]
    causal = torch.ones(t, t, dtype=torch.bool, device=dev).tril()
    for i in range(model["num_hidden_layers"]):
        p = f"layers.{i}."
        hdn = rms_norm(x, w[p + "input_layernorm.weight"], eps)
        q = (hdn @ w[p + "self_attn.q_proj.weight"].T).reshape(t, nq, dh).transpose(0, 1)
        k = (hdn @ w[p + "self_attn.k_proj.weight"].T).reshape(t, nkv, dh).transpose(0, 1)
        v = (hdn @ w[p + "self_attn.v_proj.weight"].T).reshape(t, nkv, dh).transpose(0, 1)
        q = rotary(rms_norm(q, w[p + "self_attn.q_norm.weight"], eps), theta)
        k = rotary(rms_norm(k, w[p + "self_attn.k_norm.weight"], eps), theta)
        # query head j reads key / value head j // (nq / nkv)
        k, v = (z.repeat_interleave(nq // nkv, dim=0) for z in (k, v))
        s = (q @ k.transpose(1, 2)) / math.sqrt(dh)
        a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1) @ v
        x = x + a.transpose(0, 1).reshape(t, nq * dh) @ w[p + "self_attn.o_proj.weight"].T
        hdn = rms_norm(x, w[p + "post_attention_layernorm.weight"], eps)
        gate = torch.nn.functional.silu(hdn @ w[p + "mlp.gate_proj.weight"].T)
        x = x + (gate * (hdn @ w[p + "mlp.up_proj.weight"].T)) @ w[p + "mlp.down_proj.weight"].T
    last = rms_norm(x[t - 1], w["norm.weight"], eps)
    return last / last.norm().clamp_min(1e-12)
