"""A DeepSeek-V3-block decoder (Moonlight-16B-A3B) as an embedder, in plain
float32 PyTorch.

Written from the DeepSeek-V3 technical report (arXiv:2412.19437, sections
2.1.1-2.1.2: multi-head latent attention, DeepSeekMoE with sigmoid
affinities and a bias that only selects) and Hugging Face's
``DeepseekV3Model`` parameter names: token embeddings, then
``num_hidden_layers`` pre-norm blocks and a final RMSNorm.

- Attention (no query compression, ``q_lora_rank`` null): per head
  ``q = W_q h`` split into ``q_nope`` (``qk_nope_head_dim``) and ``q_pe``
  (``qk_rope_head_dim``); ``[c_kv | k_pe] = W_kva h`` with ``c_kv`` of
  ``kv_lora_rank``, RMS-normed; ``[k_nope | v] = W_kvb c_kv`` per head;
  rotary embedding on ``q_pe`` and on the single ``k_pe`` every head shares,
  each pair (2i, 2i + 1) taken as one complex number and turned by
  ``pos * rope_theta^(-2i/d)`` (DeepSeek's own code); causal softmax of
  ``[q_nope, q_pe] . [k_nope, k_pe] / sqrt(nope + rope)`` over ``v``, then
  ``W_o``.
- Feed-forward: the first ``first_k_dense_replace`` layers a SiLU-gated
  MLP; the others the mixture of experts: affinities ``s =
  sigmoid(W_g h)``, the ``num_experts_per_tok`` experts of largest ``s +
  e_score_correction_bias`` chosen (one group, so group-limited routing
  chooses among all), gates the chosen ``s`` over their sum times
  ``routed_scaling_factor``; the output is the gated sum of the chosen
  experts' SiLU-gated MLPs plus the shared experts' MLP (``n_shared_experts``
  experts as one MLP of ``n_shared_experts * moe_intermediate_size``).
- The embedding is the last token's final hidden state, L2-normalized, as a
  decoder embedder pools (Qwen3-Embedding's convention).

One sequence at a time, unpadded; the experts each loop over the tokens
that chose them. Departure: HF adds 1e-20 to the sum of the chosen
affinities, which changes no float32 sum of sigmoids; it is left out.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

_MLP = ("gate_proj", "up_proj", "down_proj")


def is_moe(model: Dict, layer: int) -> bool:
    return layer >= model["first_k_dense_replace"] and layer % model.get("moe_layer_freq", 1) == 0


def shapes(model: Dict) -> Dict[str, tuple]:
    """Every parameter's HF name and shape, in HF's order."""
    h, v = model["hidden_size"], model["vocab_size"]
    nh, nope, rope = model["num_attention_heads"], model["qk_nope_head_dim"], model["qk_rope_head_dim"]
    dv, rank = model["v_head_dim"], model["kv_lora_rank"]
    f, fe, e = model["intermediate_size"], model["moe_intermediate_size"], model["n_routed_experts"]
    fs = fe * model["n_shared_experts"]

    def mlp(prefix: str, width: int) -> Dict[str, tuple]:
        return {f"{prefix}gate_proj.weight": (width, h), f"{prefix}up_proj.weight": (width, h),
                f"{prefix}down_proj.weight": (h, width)}

    out = {"embed_tokens.weight": (v, h)}
    for i in range(model["num_hidden_layers"]):
        p = f"layers.{i}."
        out.update({
            p + "input_layernorm.weight": (h,),
            p + "post_attention_layernorm.weight": (h,),
            p + "self_attn.q_proj.weight": (nh * (nope + rope), h),
            p + "self_attn.kv_a_proj_with_mqa.weight": (rank + rope, h),
            p + "self_attn.kv_a_layernorm.weight": (rank,),
            p + "self_attn.kv_b_proj.weight": (nh * (nope + dv), rank),
            p + "self_attn.o_proj.weight": (h, nh * dv),
        })
        if not is_moe(model, i):
            out.update(mlp(p + "mlp.", f))
            continue
        out[p + "mlp.gate.weight"] = (e, h)
        out[p + "mlp.gate.e_score_correction_bias"] = (e,)
        for j in range(e):
            out.update(mlp(f"{p}mlp.experts.{j}.", fe))
        out.update(mlp(p + "mlp.shared_experts.", fs))
    out["norm.weight"] = (h,)
    return out


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * weight


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., T, d) at positions 0..T-1: each pair (2i, 2i + 1) as a complex
    number times exp(j pos theta^(-2i/d))."""
    d, t = x.shape[-1], x.shape[-2]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    ang = (torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv).to(torch.float32)
    turn = torch.polar(torch.ones_like(ang), ang)
    z = torch.view_as_complex(x.reshape(*x.shape[:-1], d // 2, 2).contiguous())
    return torch.view_as_real(z * turn).reshape(x.shape)


def mlp(w: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor) -> torch.Tensor:
    gate = torch.nn.functional.silu(x @ w[prefix + "gate_proj.weight"].T)
    return (gate * (x @ w[prefix + "up_proj.weight"].T)) @ w[prefix + "down_proj.weight"].T


def route(w: Dict[str, torch.Tensor], prefix: str, model: Dict, x: torch.Tensor):
    """(chosen experts (T, k), their gates (T, k)) of the tokens ``x``."""
    s = torch.sigmoid(x @ w[prefix + "gate.weight"].T)
    chosen = torch.topk(s + w[prefix + "gate.e_score_correction_bias"], model["num_experts_per_tok"], dim=-1).indices
    gates = s.gather(1, chosen)
    if model.get("norm_topk_prob", True):
        gates = gates / gates.sum(dim=-1, keepdim=True)
    return chosen, gates * model["routed_scaling_factor"]


def moe(w: Dict[str, torch.Tensor], prefix: str, model: Dict, x: torch.Tensor,
        routes: Optional[List[torch.Tensor]]) -> torch.Tensor:
    chosen, gates = route(w, prefix, model, x)
    if routes is not None:
        routes.append(chosen)
    out = torch.zeros_like(x)
    for e in torch.unique(chosen).tolist():
        tok, slot = (chosen == e).nonzero(as_tuple=True)
        y = mlp(w, f"{prefix}experts.{e}.", x[tok])
        out.index_add_(0, tok, y * gates[tok, slot, None])
    return out + mlp(w, prefix + "shared_experts.", x)


def attention(w: Dict[str, torch.Tensor], p: str, model: Dict, x: torch.Tensor) -> torch.Tensor:
    t = x.shape[0]
    nh, nope, rope = model["num_attention_heads"], model["qk_nope_head_dim"], model["qk_rope_head_dim"]
    dv, rank, theta = model["v_head_dim"], model["kv_lora_rank"], float(model["rope_theta"])
    q = (x @ w[p + "q_proj.weight"].T).reshape(t, nh, nope + rope).transpose(0, 1)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    kva = x @ w[p + "kv_a_proj_with_mqa.weight"].T
    c_kv, k_pe = kva[:, :rank], kva[:, rank:]
    kv = rms_norm(c_kv, w[p + "kv_a_layernorm.weight"], model["rms_norm_eps"]) @ w[p + "kv_b_proj.weight"].T
    kv = kv.reshape(t, nh, nope + dv).transpose(0, 1)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q = torch.cat([q_nope, rotary(q_pe, theta)], dim=-1)
    k = torch.cat([k_nope, rotary(k_pe, theta).expand(nh, t, rope)], dim=-1)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    s = (q @ k.transpose(1, 2)) / math.sqrt(nope + rope)
    a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1) @ v
    return a.transpose(0, 1).reshape(t, nh * dv) @ w[p + "o_proj.weight"].T


def embed(weights: Dict[str, torch.Tensor], model: Dict, ids: Sequence[int],
          routes: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """The L2-normalized last-token embedding (hidden_size,) of one
    sequence; ``routes`` gets each MoE layer's chosen experts (T, k)."""
    w, eps = weights, model["rms_norm_eps"]
    dev = w["embed_tokens.weight"].device
    tok = torch.as_tensor(list(ids), dtype=torch.long, device=dev)
    x = w["embed_tokens.weight"][tok]
    for i in range(model["num_hidden_layers"]):
        p = f"layers.{i}."
        x = x + attention(w, p + "self_attn.", model, rms_norm(x, w[p + "input_layernorm.weight"], eps))
        h = rms_norm(x, w[p + "post_attention_layernorm.weight"], eps)
        x = x + (moe(w, p + "mlp.", model, h, routes) if is_moe(model, i) else mlp(w, p + "mlp.", h))
    last = rms_norm(x[len(tok) - 1], w["norm.weight"], eps)
    return last / last.norm().clamp_min(1e-12)
