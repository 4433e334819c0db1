"""A Kimi Linear decoder (Kimi-Linear-48B-A3B) as an embedder, in plain
float32 PyTorch.

Written from the Kimi Linear report (arXiv:2510.26692: Kimi Delta
Attention, three KDA layers to one latent-attention layer, latent attention
without positional encoding) and the published config.json's names: token
embeddings, then ``num_hidden_layers`` pre-norm blocks and a final RMSNorm.

- KDA (``linear_attn_config["kda_layers"]``, counted from 1), per head of
  ``head_dim``: ``q, k, v = SiLU(causal depthwise conv(x W_{q,k,v}))``
  (``short_conv_kernel_size`` taps, no bias, zeros before the passage);
  ``q, k`` L2-normalized, ``q`` times ``head_dim^-1/2``; the per-channel log
  decay ``g_t = -exp(A_log_h) softplus(f_b(f_a(x_t)) + dt_bias)``; ``beta_t =
  sigmoid(b_proj(x_t))_h``; the state, token by token from ``S = 0``:
  ``S = (I - beta_t k_t k_t^T) Diag(exp g_t) S + beta_t k_t v_t^T``, ``o_t =
  S^T q_t``; then ``o_proj`` of each head's ``RMSNorm(o_t) w *
  sigmoid(g_b(g_a(x_t)))``.
- Latent attention (``full_attn_layers``) as DeepSeek-V3's without rotary
  (``mla_use_nope``): ``Q = [q_nope, q_pe]``, ``K = [k_nope, k_pe]`` as
  projected, causal softmax at ``1/sqrt(nope + rope)`` over ``v``.
- Feed-forward: the first ``first_k_dense_replace`` layers a SiLU-gated MLP;
  the others the mixture of experts: affinities ``s = sigmoid(W_g h)`` over
  all ``experts_total`` experts, the ``num_experts_per_token`` of largest
  ``s + e_score_correction_bias`` chosen, gates the chosen ``s`` over their
  sum (``moe_renormalize``) times ``routed_scaling_factor``; the output is
  the gated sum of the chosen experts' SiLU-gated MLPs plus the shared
  expert's. Under ``expert_shard`` only the held experts ``[lo, hi)`` are
  computed and the others' part is left out, as on one card of the
  deployment.
- The embedding is the last token's final hidden state, L2-normalized.

One sequence at a time, unpadded, the KDA state advanced one token at a
time (not the chunk form). Departures: HF adds 1e-20 to the sum of the
chosen affinities, which changes no float32 sum of sigmoids, and its
L2-norm adds a small epsilon inside the square root; both are left out.
The parameter names are HF's as far as they could be told; the
configuration lists the rest under ``assumed``.

Seeded weights are normal draws; :func:`decay_params` maps the draws of
``A_log`` and ``dt_bias`` to their published initialisation ranges, and
the port's family applies the same function before its converter.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from reference.deepseek_v3 import rms_norm

_MLP = ("gate_proj", "up_proj", "down_proj")
# a routed expert's gate, up and down under HF's names
_EXPERT = ("w1", "w3", "w2")


def is_kda(model: Dict, layer: int) -> bool:
    return layer + 1 in model["linear_attn_config"]["kda_layers"]


def is_moe(model: Dict, layer: int) -> bool:
    return layer >= model["first_k_dense_replace"] and layer % model.get("moe_layer_freq", 1) == 0


def held(model: Dict) -> Tuple[int, int, int]:
    """(lo, hi, experts_total): the experts computed here and the router's
    width."""
    shard = model.get("expert_shard")
    if shard:
        return shard["held"][0], shard["held"][1], shard["experts_total"]
    return 0, model["num_experts"], model["num_experts"]


def shapes(model: Dict) -> Dict[str, tuple]:
    """Every parameter's HF name and shape, in HF's order; the routed
    experts are the held ones, numbered as in the whole model."""
    h, v = model["hidden_size"], model["vocab_size"]
    nh, nope, rope = model["num_attention_heads"], model["qk_nope_head_dim"], model["qk_rope_head_dim"]
    dv, rank = model["v_head_dim"], model["kv_lora_rank"]
    lin = model["linear_attn_config"]
    kh, kd, taps = lin["num_heads"], lin["head_dim"], lin["short_conv_kernel_size"]
    f, fe = model["intermediate_size"], model["moe_intermediate_size"]
    fs = fe * model["num_shared_experts"]
    lo, hi, total = held(model)

    def mlp(prefix: str, width: int, names=_MLP) -> Dict[str, tuple]:
        gate, up, down = names
        return {f"{prefix}{gate}.weight": (width, h), f"{prefix}{up}.weight": (width, h),
                f"{prefix}{down}.weight": (h, width)}

    out = {"embed_tokens.weight": (v, h)}
    for i in range(model["num_hidden_layers"]):
        p = f"layers.{i}."
        a = p + "self_attn."
        out[p + "input_layernorm.weight"] = (h,)
        out[p + "post_attention_layernorm.weight"] = (h,)
        if is_kda(model, i):
            out.update({
                a + "q_proj.weight": (kh * kd, h), a + "k_proj.weight": (kh * kd, h),
                a + "v_proj.weight": (kh * kd, h),
                a + "q_conv1d.weight": (kh * kd, 1, taps), a + "k_conv1d.weight": (kh * kd, 1, taps),
                a + "v_conv1d.weight": (kh * kd, 1, taps),
                a + "A_log": (kh,), a + "dt_bias": (kh * kd,),
                a + "f_a_proj.weight": (kd, h), a + "f_b_proj.weight": (kh * kd, kd),
                a + "b_proj.weight": (kh, h),
                a + "g_a_proj.weight": (kd, h), a + "g_b_proj.weight": (kh * kd, kd),
                a + "o_norm.weight": (kd,), a + "o_proj.weight": (h, kh * kd),
            })
        else:
            out.update({
                a + "q_proj.weight": (nh * (nope + rope), h),
                a + "kv_a_proj_with_mqa.weight": (rank + rope, h),
                a + "kv_a_layernorm.weight": (rank,),
                a + "kv_b_proj.weight": (nh * (nope + dv), rank),
                a + "o_proj.weight": (h, nh * dv),
            })
        if not is_moe(model, i):
            out.update(mlp(p + "mlp.", f))
            continue
        m = p + "block_sparse_moe."
        out[m + "gate.weight"] = (total, h)
        out[m + "gate.e_score_correction_bias"] = (total,)
        for j in range(lo, hi):
            out.update(mlp(f"{m}experts.{j}.", fe, _EXPERT))
        out.update(mlp(m + "shared_experts.", fs))
    out["norm.weight"] = (h,)
    return out


def decay_params(a_draw: torch.Tensor, dt_draw: torch.Tensor, std: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A_log, dt_bias) from seeded normal(0, ``std``) draws, through their
    normal quantile: ``A_log = log U(1, 16)`` per head and ``softplus(dt_bias)``
    log-uniform in [1e-3, 1e-1] per channel, the published initialisation
    (Kimi Linear's and Mamba's). Computed in float64, returned in float32:
    the same draws give the same bits on any device."""

    def unit(draw: torch.Tensor) -> torch.Tensor:
        u = 0.5 * (1.0 + torch.erf(draw.to(torch.float64) / (std * math.sqrt(2.0))))
        return u.clamp(1e-6, 1 - 1e-6)

    a_log = torch.log(1.0 + 15.0 * unit(a_draw))
    dt = torch.exp(math.log(1e-3) + unit(dt_draw) * (math.log(1e-1) - math.log(1e-3)))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    return a_log.to(torch.float32), dt_bias.to(torch.float32)


def mlp(w: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor, names=_MLP) -> torch.Tensor:
    gate, up, down = names
    g = torch.nn.functional.silu(x @ w[f"{prefix}{gate}.weight"].T)
    return (g * (x @ w[f"{prefix}{up}.weight"].T)) @ w[f"{prefix}{down}.weight"].T


def moe(w: Dict[str, torch.Tensor], prefix: str, model: Dict, x: torch.Tensor,
        routes: Optional[List[torch.Tensor]]) -> torch.Tensor:
    lo, hi, _ = held(model)
    s = torch.sigmoid(x @ w[prefix + "gate.weight"].T)
    chosen = torch.topk(s + w[prefix + "gate.e_score_correction_bias"], model["num_experts_per_token"],
                        dim=-1).indices
    gates = s.gather(1, chosen)
    if model.get("moe_renormalize", True):
        gates = gates / gates.sum(dim=-1, keepdim=True)
    gates = gates * model["routed_scaling_factor"]
    if routes is not None:
        routes.append(chosen)
    out = torch.zeros_like(x)
    for e in torch.unique(chosen).tolist():
        if not lo <= e < hi:
            continue   # held on another card
        tok, slot = (chosen == e).nonzero(as_tuple=True)
        y = mlp(w, f"{prefix}experts.{e}.", x[tok], _EXPERT)
        out.index_add_(0, tok, y * gates[tok, slot, None])
    return out + mlp(w, prefix + "shared_experts.", x)


def causal_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """SiLU of the causal depthwise convolution of ``x`` (T, C) by
    ``weight`` (C, 1, K): y_t = sum_m w[:, m] x_{t - K + 1 + m}, zeros
    before the start."""
    taps = weight.shape[-1]
    xp = torch.cat([x.new_zeros((taps - 1, x.shape[1])), x])
    y = sum(weight[:, 0, m] * xp[m: m + x.shape[0]] for m in range(taps))
    return torch.nn.functional.silu(y)


def scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """KDA's recurrence over one sequence, token by token from ``S = 0``:
    q, k (T, H, d), v (T, H, dv), log decays g (T, H, d), beta (T, H) ->
    o (T, H, dv), ``S = (I - beta k k^T) Diag(exp g) S + beta k v^T``, ``o =
    S^T q``."""
    t, nh, d = k.shape
    state = v.new_zeros((nh, d, v.shape[-1]))
    decay = torch.exp(g)[..., None]                    # (T, H, d, 1)
    step_k = (beta[..., None] * k)[..., None]          # (T, H, d, 1): beta k
    rows_k, rows_q = k[:, :, None, :], q[:, :, None, :]  # (T, H, 1, d)
    out = v.new_empty(v.shape)
    for i in range(t):
        state.mul_(decay[i])                                        # Diag(exp g) S
        state.baddbmm_(step_k[i], v[i][:, None, :] - torch.bmm(rows_k[i], state))  # + beta k (v - k^T S)
        out[i] = torch.bmm(rows_q[i], state)[:, 0]                  # S^T q
    return out


def kda(w: Dict[str, torch.Tensor], p: str, model: Dict, x: torch.Tensor) -> torch.Tensor:
    t = x.shape[0]
    lin = model["linear_attn_config"]
    nh, d = lin["num_heads"], lin["head_dim"]
    a_log, dt_bias = decay_params(w[p + "A_log"], w[p + "dt_bias"], model["decay_draw_std"])
    a_log, dt_bias = a_log.to(x.device), dt_bias.to(x.device)
    q = causal_conv(x @ w[p + "q_proj.weight"].T, w[p + "q_conv1d.weight"]).reshape(t, nh, d)
    k = causal_conv(x @ w[p + "k_proj.weight"].T, w[p + "k_conv1d.weight"]).reshape(t, nh, d)
    v = causal_conv(x @ w[p + "v_proj.weight"].T, w[p + "v_conv1d.weight"]).reshape(t, nh, d)
    q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12) * d ** -0.5
    k = k / k.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    raw = ((x @ w[p + "f_a_proj.weight"].T) @ w[p + "f_b_proj.weight"].T + dt_bias).reshape(t, nh, d)
    g = -torch.exp(a_log)[:, None] * torch.nn.functional.softplus(raw)
    beta = torch.sigmoid(x @ w[p + "b_proj.weight"].T)
    o = scan(q, k, v, g, beta)
    gate = ((x @ w[p + "g_a_proj.weight"].T) @ w[p + "g_b_proj.weight"].T).reshape(t, nh, d)
    o = rms_norm(o, w[p + "o_norm.weight"], model["rms_norm_eps"]) * torch.sigmoid(gate)
    return o.reshape(t, nh * d) @ w[p + "o_proj.weight"].T


def attention(w: Dict[str, torch.Tensor], p: str, model: Dict, x: torch.Tensor) -> torch.Tensor:
    t = x.shape[0]
    nh, nope, rope = model["num_attention_heads"], model["qk_nope_head_dim"], model["qk_rope_head_dim"]
    dv, rank = model["v_head_dim"], model["kv_lora_rank"]
    q = (x @ w[p + "q_proj.weight"].T).reshape(t, nh, nope + rope).transpose(0, 1)
    kva = x @ w[p + "kv_a_proj_with_mqa.weight"].T
    c_kv, k_pe = kva[:, :rank], kva[:, rank:]
    kv = rms_norm(c_kv, w[p + "kv_a_layernorm.weight"], model["rms_norm_eps"]) @ w[p + "kv_b_proj.weight"].T
    kv = kv.reshape(t, nh, nope + dv).transpose(0, 1)
    k = torch.cat([kv[..., :nope], k_pe.expand(nh, t, rope)], dim=-1)
    v = kv[..., nope:]
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    s = (q @ k.transpose(1, 2)) / math.sqrt(nope + rope)
    a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1) @ v
    return a.transpose(0, 1).reshape(t, nh * dv) @ w[p + "o_proj.weight"].T


def hidden(weights: Dict[str, torch.Tensor], model: Dict, ids: Sequence[int],
           routes: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """The final RMSNorm's states (T, hidden_size) of one sequence;
    ``routes`` gets each MoE layer's chosen experts (T, k)."""
    w, eps = weights, model["rms_norm_eps"]
    dev = w["embed_tokens.weight"].device
    tok = torch.as_tensor(list(ids), dtype=torch.long, device=dev)
    x = w["embed_tokens.weight"][tok]
    for i in range(model["num_hidden_layers"]):
        p = f"layers.{i}."
        h = rms_norm(x, w[p + "input_layernorm.weight"], eps)
        mix = kda if is_kda(model, i) else attention
        x = x + mix(w, p + "self_attn.", model, h)
        h = rms_norm(x, w[p + "post_attention_layernorm.weight"], eps)
        x = x + (moe(w, p + "block_sparse_moe.", model, h, routes) if is_moe(model, i)
                 else mlp(w, p + "mlp.", h))
    return rms_norm(x, w["norm.weight"], eps)


def embed(weights: Dict[str, torch.Tensor], model: Dict, ids: Sequence[int],
          routes: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """The L2-normalized last-token embedding (hidden_size,) of one
    sequence; ``routes`` gets each MoE layer's chosen experts (T, k)."""
    last = hidden(weights, model, ids, routes)[-1]
    return last / last.norm().clamp_min(1e-12)
