"""GTE-multilingual encoder (Alibaba-NLP ``gte-multilingual-base``) as
``nn.Module``s.

The architecture ("NewModel") is a post-LN BERT variant with rotary position
embeddings and a gated GELU MLP:

- embeddings: word + token_type (no absolute positions), LayerNorm;
- per layer: fused ``qkv_proj`` -> RoPE on q/k -> attention -> ``o_proj``
  -> LayerNorm(x + attn); gated MLP ``up_gate_proj`` (up, gate halves,
  ``up * gelu(gate)``) -> ``down_proj`` -> LayerNorm(x + mlp);
- pooling: CLS + L2 norm.

Attention is plain PyTorch (:func:`~codemix_dense_retrieval_torch.ops.flash_attention.attention_xla`),
as the JAX module's is a plain einsum outside any Pallas kernel. GTE has no
packed forward, so ``pack=True`` is refused by the TextEncoder. Parameter
names follow the JAX package's Flax tree (``word_embeddings``,
``layers.<i>.qkv_proj``, ...).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import torch
from torch import nn

from codemix_dense_retrieval_torch.models.qwen3 import rope
from codemix_dense_retrieval_torch.models.xlmr import normalize_tokens, pool_and_normalize
from codemix_dense_retrieval_torch.ops.flash_attention import attention_xla


@dataclass(frozen=True)
class GTEConfig:
    vocab_size: int = 250_048
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-12
    rope_theta: float = 160_000.0
    max_position_embeddings: int = 8192
    pooling: str = "cls"
    normalize: bool = True
    dtype: torch.dtype = torch.float32  # compute dtype (bfloat16 on the card)

    @classmethod
    def tiny(cls, **kw) -> "GTEConfig":
        defaults = dict(
            vocab_size=200, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=64, rope_theta=10_000.0,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def from_hf_config(cls, hf: Dict, **kw) -> "GTEConfig":
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            intermediate_size=hf["intermediate_size"],
            layer_norm_eps=hf.get("layer_norm_eps", 1e-12),
            rope_theta=hf.get("rope_theta", 160_000.0),
            max_position_embeddings=hf.get("max_position_embeddings", 8192),
            **kw,
        )


class GTELayer(nn.Module):
    def __init__(self, cfg: GTEConfig) -> None:
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.qkv_proj = nn.Linear(h, 3 * h)
        self.o_proj = nn.Linear(h, h)
        self.attn_ln = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.up_gate_proj = nn.Linear(h, 2 * cfg.intermediate_size, bias=False)
        self.down_proj = nn.Linear(cfg.intermediate_size, h)
        self.mlp_ln = nn.LayerNorm(h, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, s, h = x.shape
        dh = h // c.num_heads
        q, k, v = torch.chunk(self.qkv_proj(x), 3, dim=-1)
        q = rope(q.reshape(b, s, c.num_heads, dh), positions, c.rope_theta)
        k = rope(k.reshape(b, s, c.num_heads, dh), positions, c.rope_theta)
        v = v.reshape(b, s, c.num_heads, dh)
        attn = attention_xla(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), lengths)
        x = self.attn_ln(x + self.o_proj(attn.transpose(1, 2).reshape(b, s, h)))
        up, gate = torch.chunk(self.up_gate_proj(x), 2, dim=-1)
        y = self.down_proj(up * nn.functional.gelu(gate, approximate="none"))
        return self.mlp_ln(x + y)


class GTEEncoder(nn.Module):
    """Full encoder: ``forward`` returns pooled, L2-normalized f32 sentence
    embeddings. ``task_id`` is accepted for the TextEncoder interface and
    unused."""

    def __init__(self, cfg: GTEConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.emb_ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(GTELayer(cfg) for _ in range(cfg.num_layers))

    def hidden_states(self, input_ids: torch.Tensor, attention_mask: torch.Tensor, task_id=None) -> torch.Tensor:
        b, s = input_ids.shape
        lengths = attention_mask.to(torch.int32).sum(dim=1, dtype=torch.int32)
        positions = torch.arange(s, device=input_ids.device)[None].expand(b, s)
        x = self.word_embeddings(input_ids) + self.token_type_embeddings(torch.zeros_like(input_ids))
        x = self.emb_ln(x)
        for layer in self.layers:
            x = layer(x, positions, lengths)
        return x

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor, task_id=None) -> torch.Tensor:
        x = self.hidden_states(input_ids, attention_mask)
        return pool_and_normalize(x, attention_mask, self.cfg.pooling, self.cfg.normalize)

    def token_embeddings(self, input_ids, attention_mask, task_id=None) -> torch.Tensor:
        """Per-token L2-normalized f32 embeddings (B, S, d), pads zeroed."""
        return normalize_tokens(self.hidden_states(input_ids, attention_mask), attention_mask)

    def embed_with_tokens(self, input_ids, attention_mask, task_id=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One backbone pass -> (pooled, per-token normalized)."""
        x = self.hidden_states(input_ids, attention_mask)
        pooled = pool_and_normalize(x, attention_mask, self.cfg.pooling, self.cfg.normalize)
        return pooled, normalize_tokens(x, attention_mask)


def convert_gte_state_dict(
    state_dict: Mapping[str, object], cfg: GTEConfig, prefix: str = ""
) -> Dict[str, torch.Tensor]:
    """HF ``NewModel`` state dict -> :class:`GTEEncoder` state dict (f32),
    the JAX package's name mapping; a projection without a stored bias gets
    a zero one."""
    from codemix_dense_retrieval_torch.models.convert import _t

    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    out: Dict[str, torch.Tensor] = {
        "word_embeddings.weight": _t(sd["embeddings.word_embeddings.weight"]),
        "token_type_embeddings.weight": _t(sd["embeddings.token_type_embeddings.weight"]),
        "emb_ln.weight": _t(sd["embeddings.LayerNorm.weight"]),
        "emb_ln.bias": _t(sd["embeddings.LayerNorm.bias"]),
    }
    for i in range(cfg.num_layers):
        hf = f"encoder.layer.{i}"
        for name, src, bias in (("qkv_proj", "attention.qkv_proj", True),
                                ("o_proj", "attention.o_proj", True),
                                ("up_gate_proj", "mlp.up_gate_proj", False),
                                ("down_proj", "mlp.down_proj", True)):
            w = _t(sd[f"{hf}.{src}.weight"])
            out[f"layers.{i}.{name}.weight"] = w
            if bias:
                b = sd.get(f"{hf}.{src}.bias")
                out[f"layers.{i}.{name}.bias"] = torch.zeros(w.shape[0]) if b is None else _t(b)
        for ln in ("attn_ln", "mlp_ln"):
            out[f"layers.{i}.{ln}.weight"] = _t(sd[f"{hf}.{ln}.weight"])
            out[f"layers.{i}.{ln}.bias"] = _t(sd[f"{hf}.{ln}.bias"])
    return out
