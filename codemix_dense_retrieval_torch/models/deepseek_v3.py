"""DeepSeek-V3-block decoder embedder (Moonlight-16B-A3B) as ``nn.Module``s.

Architecture (HF ``DeepseekV3Model``, ``model_type`` ``deepseek_v3``): token
embeddings, then pre-norm blocks (RMSNorm; multi-head latent attention;
residual; RMSNorm; a feed-forward; residual) and a final RMSNorm; the
embedding is the L2-normalized LAST-token hidden state, as Qwen3-Embedding
pools its decoder (the ``last_token`` dialect).

- Multi-head latent attention (MLA) in its prefill form, without a query
  LoRA: ``q = q_proj(h)`` per head ``[q_nope (128) | q_pe (64)]``;
  ``[c_kv (512) | k_pe (64)] = kv_a_proj_with_mqa(h)``, ``c_kv`` RMS-normed
  (``kv_a_layernorm``), ``[k_nope (128) | v (128)] = kv_b_proj(c_kv)`` per
  head; rotary embedding on ``q_pe`` and on the one ``k_pe`` all heads
  share, rotating the pairs (2i, 2i + 1) by ``pos * theta^(-2i/64)`` (the
  interleaved convention of DeepSeek's code and HF's ``rope_interleave``);
  ``Q = [q_nope, q_pe]``, ``K = [k_nope, k_pe]``, causal softmax at
  ``1/sqrt(192)`` over ``V`` of width 128, then ``o_proj``. Attention is
  the plain path (:func:`~codemix_dense_retrieval_torch.ops.flash_attention.attention_xla`):
  kernel B takes equal q / k / v head widths only. While tracing the block
  is the span ``mla.attention`` with its device time.
- The first ``first_k_dense_replace`` layers' feed-forward is a SiLU-gated
  MLP (:class:`~codemix_dense_retrieval_torch.models.qwen3.Qwen3Mlp`); the
  others are the mixture of experts of
  :mod:`~codemix_dense_retrieval_torch.models.moe`, which routes only the
  batch's real tokens.

Parameter names are HF's (``layers.<i>.self_attn.kv_b_proj``, ...), except
that each MoE layer's experts are stacked:
``mlp.experts.gate_up_proj.weight`` (E, 2F, H) and
``mlp.experts.down_proj.weight`` (E, H, F) hold HF's
``mlp.experts.<e>.{gate,up,down}_proj.weight``
(:func:`convert_deepseek_v3_state_dict`).

The forward takes ``token_count``: how many tokens of the batch are real
(the host's mask sum, which ``TextEncoder`` passes), so that every shape of
the routed path is known on the host and the forward reads nothing back
from the card; without it the count is read from the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from codemix_dense_retrieval_torch.models.moe import MoeLayer
from codemix_dense_retrieval_torch.models.qwen3 import Qwen3Mlp, RMSNorm
from codemix_dense_retrieval_torch.models.xlmr import (
    normalize_tokens,
    pool_and_normalize,
    pool_segments,
)
from codemix_dense_retrieval_torch.ops.flash_attention import attention_xla
from codemix_dense_retrieval_torch.utils import timing


@dataclass(frozen=True)
class DeepseekV3Config:
    """Defaults: moonshotai/Moonlight-16B-A3B's published config.json."""

    vocab_size: int = 163_840
    hidden_size: int = 2048
    num_layers: int = 27
    num_heads: int = 16
    intermediate_size: int = 11_264
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 50_000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 8192
    normalize: bool = True
    dtype: torch.dtype = torch.float32  # compute dtype (bfloat16 on the card)

    @classmethod
    def tiny(cls, **kw) -> "DeepseekV3Config":
        defaults = dict(
            vocab_size=100, hidden_size=32, num_layers=3, num_heads=4, intermediate_size=64,
            moe_intermediate_size=16, n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2,
            kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8,
            rope_theta=10_000.0, max_position_embeddings=128,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def from_hf_config(cls, hf: Dict, **kw) -> "DeepseekV3Config":
        """The config of an HF ``deepseek_v3`` config.json; raises on what
        this module does not compute (a query LoRA, more than one expert
        group, a scoring function other than sigmoid, another top-k method,
        rope scaling)."""
        unsupported = {
            "q_lora_rank": hf.get("q_lora_rank") is not None,
            "n_group": hf.get("n_group", 1) > 1 or hf.get("topk_group", 1) > 1,
            "scoring_func": hf.get("scoring_func", "sigmoid") != "sigmoid",
            "topk_method": hf.get("topk_method", "noaux_tc") != "noaux_tc",
            "rope_scaling": bool(hf.get("rope_scaling")),
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise ValueError(f"deepseek_v3 config: unsupported {', '.join(f'{k}={hf.get(k)!r}' for k in bad)}")
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            intermediate_size=hf["intermediate_size"],
            moe_intermediate_size=hf["moe_intermediate_size"],
            n_routed_experts=hf["n_routed_experts"],
            n_shared_experts=hf.get("n_shared_experts") or 0,
            num_experts_per_tok=hf["num_experts_per_tok"],
            first_k_dense_replace=hf.get("first_k_dense_replace", 0),
            moe_layer_freq=hf.get("moe_layer_freq", 1),
            routed_scaling_factor=hf.get("routed_scaling_factor", 1.0),
            norm_topk_prob=hf.get("norm_topk_prob", True),
            kv_lora_rank=hf["kv_lora_rank"],
            qk_nope_head_dim=hf["qk_nope_head_dim"],
            qk_rope_head_dim=hf["qk_rope_head_dim"],
            v_head_dim=hf["v_head_dim"],
            rope_theta=hf.get("rope_theta", 10_000.0),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
            max_position_embeddings=hf.get("max_position_embeddings", 8192),
            **kw,
        )

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace and layer % self.moe_layer_freq == 0


def rope_interleaved(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding in the interleaved convention: x (B, S, H, d), each
    pair (x[2i], x[2i + 1]) rotated by ``positions (B, S) * theta^(-2i/d)``,
    in f32, cast back to x's dtype."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    angles = positions[..., None].to(torch.float32) * freqs  # (B, S, half)
    cos, sin = torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]
    pairs = x.to(torch.float32).unflatten(-1, (half, 2))
    x0, x1 = pairs[..., 0], pairs[..., 1]
    return torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1).flatten(-2).to(x.dtype)


class MlaAttention(nn.Module):
    """Latent attention (module docstring). ``use_rope=False`` is the NoPE
    variant (Kimi Linear's ``mla_use_nope``): ``q_pe`` and ``k_pe`` enter Q
    and K unrotated, and ``positions`` is not read."""

    def __init__(self, cfg: DeepseekV3Config, use_rope: bool = True) -> None:
        super().__init__()
        self.cfg = cfg
        self.use_rope = use_rope
        h, nope, rope, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        self.q_proj = nn.Linear(cfg.hidden_size, h * (nope + rope), bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(cfg.hidden_size, cfg.kv_lora_rank + rope, bias=False)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b_proj = nn.Linear(cfg.kv_lora_rank, h * (nope + dv), bias=False)
        self.o_proj = nn.Linear(h * dv, cfg.hidden_size, bias=False)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, lengths: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        b, s, _ = x.shape
        h, nope, rope, dv = c.num_heads, c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim
        with timing.span("mla.attention", device=x.device):
            q_nope, q_pe = self.q_proj(x).reshape(b, s, h, nope + rope).split([nope, rope], dim=-1)
            c_kv, k_pe = self.kv_a_proj_with_mqa(x).split([c.kv_lora_rank, rope], dim=-1)
            kv = self.kv_b_proj(self.kv_a_layernorm(c_kv)).reshape(b, s, h, nope + dv)
            k_nope, v = kv.split([nope, dv], dim=-1)
            k_pe = k_pe.reshape(b, s, 1, rope)
            if self.use_rope:
                q_pe = rope_interleaved(q_pe, positions, c.rope_theta)
                k_pe = rope_interleaved(k_pe, positions, c.rope_theta)
            q = torch.cat([q_nope, q_pe], dim=-1)
            k = torch.cat([k_nope, k_pe.expand(b, s, h, rope)], dim=-1)
            # (B, H, S, d) views of the (B, S, H, d) heads
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
            out = attention_xla(q, k, v, lengths, causal=True, segment_ids=segment_ids)
            return self.o_proj(out.transpose(1, 2).reshape(b, s, h * dv))


class DeepseekV3Layer(nn.Module):
    def __init__(self, cfg: DeepseekV3Config, layer: int) -> None:
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = MlaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = MoeLayer(cfg) if cfg.is_moe(layer) else Qwen3Mlp(cfg)

    def forward(self, x, positions, lengths, segment_ids=None, token_index=None):
        x = x + self.self_attn(self.input_layernorm(x), positions, lengths, segment_ids)
        h = self.post_attention_layernorm(x)
        return x + (self.mlp(h, token_index) if isinstance(self.mlp, MoeLayer) else self.mlp(h))


class DeepseekV3Encoder(nn.Module):
    """Decoder-only embedding model over DeepSeek-V3 blocks: last-token pool
    + L2 norm, with Qwen3Encoder's call contract (``task_id`` accepted and
    unused) plus ``token_count`` (see the module docstring)."""

    #: packed-encode position convention: RoPE positions restart at 0 in each segment
    PACKED_POS = "zero"
    #: TextEncoder passes ``token_count`` (the batch's real tokens) to the forward
    ROUTES_TOKENS = True

    def __init__(self, cfg: DeepseekV3Config) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(DeepseekV3Layer(cfg, i) for i in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        # built in the compute dtype, so storage made for it (``to_empty``)
        # holds the stacked experts once, not in f32 first
        self.to(cfg.dtype)

    def _run(self, input_ids, positions, real, token_count, segment_ids=None) -> torch.Tensor:
        """``real`` (B, S): nonzero at real tokens (the attention mask, or
        packed rows' segment ids)."""
        lengths = (real > 0).to(torch.int32).sum(dim=1, dtype=torch.int32)
        flat = (real > 0).reshape(-1).to(torch.int8)
        if token_count is None:
            token_count = int(flat.sum())
        # real positions first, each in batch order; shapes from the host's count
        token_index = torch.argsort(flat, descending=True, stable=True)[:token_count]
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x, positions, lengths, segment_ids, token_index)
        return self.norm(x)

    def hidden_states(self, input_ids, attention_mask, task_id=None, token_count=None) -> torch.Tensor:
        b, s = input_ids.shape
        positions = torch.arange(s, device=input_ids.device)[None].expand(b, s)
        return self._run(input_ids, positions, attention_mask, token_count)

    def forward(self, input_ids, attention_mask, task_id=None, token_count=None) -> torch.Tensor:
        x = self.hidden_states(input_ids, attention_mask, token_count=token_count)
        return pool_and_normalize(x, attention_mask, "last_token", self.cfg.normalize)

    def token_embeddings(self, input_ids, attention_mask, task_id=None, token_count=None) -> torch.Tensor:
        """Per-token L2-normalized f32 embeddings (B, S, d), pads zeroed."""
        x = self.hidden_states(input_ids, attention_mask, token_count=token_count)
        return normalize_tokens(x, attention_mask)

    def embed_with_tokens(self, input_ids, attention_mask, task_id=None,
                          token_count=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One backbone pass -> (pooled, per-token normalized)."""
        x = self.hidden_states(input_ids, attention_mask, token_count=token_count)
        pooled = pool_and_normalize(x, attention_mask, "last_token", self.cfg.normalize)
        return pooled, normalize_tokens(x, attention_mask)

    def _packed_hidden(self, input_ids, segment_ids, position_ids):
        x = self._run(input_ids, position_ids, segment_ids, None, segment_ids)
        return x.to(torch.float32), (segment_ids > 0).to(torch.int32)

    def packed_embeddings(self, input_ids, segment_ids, position_ids, seg_starts, seg_lengths, task_id=None,
                          *, max_segments: int) -> torch.Tensor:
        """Sequence-packed forward (the contract of
        ``Qwen3Encoder.packed_embeddings``): (B, max_segments, d) f32."""
        x, _ = self._packed_hidden(input_ids, segment_ids, position_ids)
        return pool_segments(x, segment_ids, seg_starts, seg_lengths, "last_token",
                             self.cfg.normalize, max_segments)

    def packed_embed_with_tokens(self, input_ids, segment_ids, position_ids, seg_starts, seg_lengths,
                                 task_id=None, *, max_segments: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Packed :meth:`embed_with_tokens`."""
        x, mask = self._packed_hidden(input_ids, segment_ids, position_ids)
        pooled = pool_segments(x, segment_ids, seg_starts, seg_lengths, "last_token",
                               self.cfg.normalize, max_segments)
        return pooled, normalize_tokens(x, mask)


_EXPERT = ("gate_proj", "up_proj", "down_proj")


def convert_deepseek_v3_state_dict(
    state_dict: Mapping[str, object], cfg: DeepseekV3Config, prefix: str = ""
) -> Dict[str, torch.Tensor]:
    """HF ``DeepseekV3Model`` state dict -> :class:`DeepseekV3Encoder` state
    dict: ``prefix`` stripped, the encoder's weights kept (an LM head is
    dropped), names kept but for each MoE layer's experts, stacked per
    layer (``experts.gate_up_proj.weight`` (E, 2F, H): expert e's gate
    rows, then its up rows; ``experts.down_proj.weight`` (E, H, F)). Tensors
    keep their device and dtype; a stack is a new tensor."""
    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    out = {name: sd[name] for name in ("embed_tokens.weight", "norm.weight")}
    attn = ["q_proj", "kv_a_proj_with_mqa", "kv_a_layernorm", "kv_b_proj", "o_proj"]
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        names = [p + "input_layernorm.weight", p + "post_attention_layernorm.weight"]
        names += [f"{p}self_attn.{m}.weight" for m in attn]
        if not cfg.is_moe(i):
            names += [f"{p}mlp.{m}.weight" for m in _EXPERT]
        else:
            names += [p + "mlp.gate.weight", p + "mlp.gate.e_score_correction_bias"]
            names += [f"{p}mlp.shared_experts.{m}.weight" for m in _EXPERT]
            e = f"{p}mlp.experts."
            out[e + "gate_up_proj.weight"] = torch.stack([
                torch.cat([sd[f"{e}{j}.gate_proj.weight"], sd[f"{e}{j}.up_proj.weight"]])
                for j in range(cfg.n_routed_experts)])
            out[e + "down_proj.weight"] = torch.stack(
                [sd[f"{e}{j}.down_proj.weight"] for j in range(cfg.n_routed_experts)])
        out.update((name, sd[name]) for name in names)
    return out
