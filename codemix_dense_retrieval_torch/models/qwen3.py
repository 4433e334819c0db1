"""Qwen3-Embedding decoder (0.6B / 4B / 8B family) as ``nn.Module``s.

Architecture (HF ``Qwen3Model``): RMSNorm before attention and before the
MLP, grouped-query attention with per-head q/k RMSNorm, RoPE, a SiLU-gated
MLP and a causal mask; the embedding is the L2-normalized LAST-token hidden
state (the ``last_token`` pooling dialect). Parameter names follow the JAX
package's Flax tree (``embed_tokens``, ``layers.<i>.self_attn.q_proj``,
...), which are also HF's, so :func:`convert_qwen3_state_dict` only strips
a prefix and :func:`~codemix_dense_retrieval_torch.models.convert.params_from_flax`
maps the Flax tree leaf by leaf.

With ``use_flash`` attention is kernel B
(:func:`~codemix_dense_retrieval_torch.ops.flash_attention.attention_flash`,
causal, GQA-native: 16 query heads read 8 KV heads in place) at every
length, as in the JAX module; packed rows add the block-diagonal segment
mask (causal within each segment, since segments are contiguous in a row).
Without it the KV heads are repeated and attention is plain PyTorch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from codemix_dense_retrieval_torch.models.xlmr import (
    normalize_tokens,
    pool_and_normalize,
    pool_segments,
)
from codemix_dense_retrieval_torch.ops.flash_attention import attention_flash, attention_xla


@dataclass(frozen=True)
class Qwen3Config:
    vocab_size: int = 151_669
    hidden_size: int = 1024
    num_layers: int = 28
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 3072
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    max_position_embeddings: int = 32_768
    tie_word_embeddings: bool = True
    normalize: bool = True
    dtype: torch.dtype = torch.float32  # compute dtype (bfloat16 on the card)
    use_flash: bool = False  # kernel B, causal, at every length

    @classmethod
    def embedding_0p6b(cls, **kw) -> "Qwen3Config":
        """Qwen/Qwen3-Embedding-0.6B's published config.json widths."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "Qwen3Config":
        defaults = dict(
            vocab_size=100, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=64,
            rope_theta=10_000.0, max_position_embeddings=128,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def from_hf_config(cls, hf: Dict, **kw) -> "Qwen3Config":
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
            head_dim=hf.get("head_dim", hf["hidden_size"] // hf["num_attention_heads"]),
            intermediate_size=hf["intermediate_size"],
            rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
            rope_theta=hf.get("rope_theta", 1_000_000.0),
            max_position_embeddings=hf.get("max_position_embeddings", 32_768),
            tie_word_embeddings=hf.get("tie_word_embeddings", True),
            **kw,
        )


class RMSNorm(nn.Module):
    """RMS norm over the last dim, computed in f32 and cast back to the
    input's dtype (the JAX module's order)."""

    def __init__(self, dim: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.weight.to(torch.float32)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, HF half-split convention. x: (B, S, H, Dh),
    positions (B, S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    angles = positions[..., None].to(torch.float32) * freqs  # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class Qwen3Attention(nn.Module):
    def __init__(self, cfg: Qwen3Config) -> None:
        super().__init__()
        self.cfg = cfg
        h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.q_proj = nn.Linear(cfg.hidden_size, h * dh, bias=False)
        self.k_proj = nn.Linear(cfg.hidden_size, kvh * dh, bias=False)
        self.v_proj = nn.Linear(cfg.hidden_size, kvh * dh, bias=False)
        self.o_proj = nn.Linear(h * dh, cfg.hidden_size, bias=False)
        self.q_norm = RMSNorm(dh, cfg.rms_norm_eps)
        self.k_norm = RMSNorm(dh, cfg.rms_norm_eps)

    def forward(
        self, x: torch.Tensor, positions: torch.Tensor, lengths: torch.Tensor,
        segment_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        c = self.cfg
        b, s, _ = x.shape
        h, kvh, dh = c.num_heads, c.num_kv_heads, c.head_dim
        q = self.q_norm(self.q_proj(x).reshape(b, s, h, dh))
        k = self.k_norm(self.k_proj(x).reshape(b, s, kvh, dh))
        v = self.v_proj(x).reshape(b, s, kvh, dh)
        q = rope(q, positions, c.rope_theta)
        k = rope(k, positions, c.rope_theta)
        # (B, H|KVH, S, Dh) views of the (B, S, H, Dh) projections
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        if c.use_flash:
            out = attention_flash(q, k, v, lengths, causal=True, segment_ids=segment_ids)
        else:
            out = attention_xla(q, k, v, lengths, causal=True, segment_ids=segment_ids)
        return self.o_proj(out.transpose(1, 2).reshape(b, s, h * dh))


class Qwen3Mlp(nn.Module):
    """SiLU-gated MLP of width ``intermediate_size`` (the config's by
    default; DeepSeek-V3's shared experts are one such MLP)."""

    def __init__(self, cfg: Qwen3Config, intermediate_size: Optional[int] = None) -> None:
        super().__init__()
        f = intermediate_size or cfg.intermediate_size
        self.gate_proj = nn.Linear(cfg.hidden_size, f, bias=False)
        self.up_proj = nn.Linear(cfg.hidden_size, f, bias=False)
        self.down_proj = nn.Linear(f, cfg.hidden_size, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(nn.functional.silu(self.gate_proj(x)) * self.up_proj(x))


class Qwen3Layer(nn.Module):
    def __init__(self, cfg: Qwen3Config) -> None:
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = Qwen3Attention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = Qwen3Mlp(cfg)

    def forward(self, x, positions, lengths, segment_ids=None):
        x = x + self.self_attn(self.input_layernorm(x), positions, lengths, segment_ids)
        return x + self.mlp(self.post_attention_layernorm(x))


class Qwen3Encoder(nn.Module):
    """Decoder-only embedding model: last-token pool + L2 norm. ``task_id``
    is accepted for the TextEncoder interface and unused: Qwen3-Embedding
    tells queries from passages by prompt, not by adapters."""

    #: packed-encode position convention: RoPE positions restart at 0 in
    #: each segment (XLM-R's learned table starts at pad_id + 1)
    PACKED_POS = "zero"

    def __init__(self, cfg: Qwen3Config) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(Qwen3Layer(cfg) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def _run(self, input_ids, positions, lengths, segment_ids=None) -> torch.Tensor:
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x, positions, lengths, segment_ids)
        return self.norm(x)

    def hidden_states(self, input_ids: torch.Tensor, attention_mask: torch.Tensor, task_id=None) -> torch.Tensor:
        b, s = input_ids.shape
        lengths = attention_mask.to(torch.int32).sum(dim=1, dtype=torch.int32)
        positions = torch.arange(s, device=input_ids.device)[None].expand(b, s)
        return self._run(input_ids, positions, lengths)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor, task_id=None) -> torch.Tensor:
        x = self.hidden_states(input_ids, attention_mask)
        return pool_and_normalize(x, attention_mask, "last_token", self.cfg.normalize)

    def token_embeddings(self, input_ids, attention_mask, task_id=None) -> torch.Tensor:
        """Per-token L2-normalized f32 embeddings (B, S, d), pads zeroed."""
        return normalize_tokens(self.hidden_states(input_ids, attention_mask), attention_mask)

    def embed_with_tokens(self, input_ids, attention_mask, task_id=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One backbone pass -> (pooled, per-token normalized)."""
        x = self.hidden_states(input_ids, attention_mask)
        pooled = pool_and_normalize(x, attention_mask, "last_token", self.cfg.normalize)
        return pooled, normalize_tokens(x, attention_mask)

    def _packed_hidden(self, input_ids, segment_ids, position_ids):
        mask = (segment_ids > 0).to(torch.int32)
        x = self._run(input_ids, position_ids, mask.sum(dim=1, dtype=torch.int32), segment_ids)
        return x.to(torch.float32), mask

    def packed_embeddings(
        self, input_ids, segment_ids, position_ids, seg_starts, seg_lengths, task_id=None,
        *, max_segments: int,
    ) -> torch.Tensor:
        """Sequence-packed forward (the contract of
        ``XLMREncoder.packed_embeddings``): causal attention within each
        segment, RoPE positions restarting per segment, each segment's last
        token pooled and L2-normalized. (B, max_segments, d) f32, empty slots
        zeros."""
        x, _ = self._packed_hidden(input_ids, segment_ids, position_ids)
        return pool_segments(x, segment_ids, seg_starts, seg_lengths, "last_token",
                             self.cfg.normalize, max_segments)

    def packed_embed_with_tokens(
        self, input_ids, segment_ids, position_ids, seg_starts, seg_lengths, task_id=None,
        *, max_segments: int,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Packed :meth:`embed_with_tokens`."""
        x, mask = self._packed_hidden(input_ids, segment_ids, position_ids)
        pooled = pool_segments(x, segment_ids, seg_starts, seg_lengths, "last_token",
                               self.cfg.normalize, max_segments)
        return pooled, normalize_tokens(x, mask)


def convert_qwen3_state_dict(
    state_dict: Mapping[str, object], cfg: Qwen3Config, prefix: str = ""
) -> Dict[str, torch.Tensor]:
    """HF ``Qwen3Model`` state dict -> :class:`Qwen3Encoder` state dict (f32).
    The module names are HF's, and both sides keep torch's (out, in) Linear
    layout, so this strips ``prefix`` and keeps the encoder's weights (an LM
    head or anything else is dropped)."""
    from codemix_dense_retrieval_torch.models.convert import _t

    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    names = ["embed_tokens.weight", "norm.weight"]
    for i in range(cfg.num_layers):
        hf = f"layers.{i}"
        names += [f"{hf}.self_attn.{p}_proj.weight" for p in ("q", "k", "v", "o")]
        names += [f"{hf}.self_attn.q_norm.weight", f"{hf}.self_attn.k_norm.weight",
                  f"{hf}.input_layernorm.weight", f"{hf}.post_attention_layernorm.weight"]
        names += [f"{hf}.mlp.{p}_proj.weight" for p in ("gate", "up", "down")]
    return {name: _t(sd[name]) for name in names}
