"""XLM-RoBERTa encoder as ``nn.Module``s — the architecture behind BGE-M3,
multilingual-E5 and LaBSE-style embedding models.

embeddings -> N post-LN transformer layers (exact GELU) -> pooling
(cls | mean | last_token) -> L2 norm. Parameter names follow the JAX
package's Flax tree (``embeddings.word_embeddings``, ``layers.<i>.q``, ...),
so :mod:`~codemix_dense_retrieval_torch.models.convert` maps one onto the
other leaf by leaf. Attention goes through
:func:`~codemix_dense_retrieval_torch.ops.flash_attention.multi_head_attention`
(kernel B past the length crossover).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
from torch import nn

from codemix_dense_retrieval_torch.ops.flash_attention import multi_head_attention


@dataclass(frozen=True)
class XLMRConfig:
    vocab_size: int = 250_002
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 8194
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    pooling: str = "cls"  # cls | mean | last_token
    normalize: bool = True
    dtype: torch.dtype = torch.float32  # compute dtype (bfloat16 on the card)
    use_flash: bool = True
    # Jina-v3 task-LoRA fields, kept so the JAX package's encoder_config.json
    # loads; rank > 0 is not ported yet
    lora_rank: int = 0
    lora_tasks: int = 0
    lora_alpha: float = 1.0

    @classmethod
    def bge_m3(cls, **kw) -> "XLMRConfig":
        """BGE-M3: XLM-R-large backbone, 8192-token window, CLS pooling."""
        return cls(pooling="cls", **kw)

    @classmethod
    def me5_large(cls, **kw) -> "XLMRConfig":
        """multilingual-e5-large: XLM-R-large, 512 window, mean pooling."""
        return cls(max_position_embeddings=514, pooling="mean", **kw)

    @classmethod
    def tiny(cls, **kw) -> "XLMRConfig":
        """Small config for tests."""
        defaults = dict(
            vocab_size=100, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=64,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def from_hf_config(cls, hf: Dict, **kw) -> "XLMRConfig":
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            intermediate_size=hf["intermediate_size"],
            max_position_embeddings=hf["max_position_embeddings"],
            type_vocab_size=hf.get("type_vocab_size", 1),
            layer_norm_eps=hf.get("layer_norm_eps", 1e-5),
            pad_token_id=hf.get("pad_token_id", 1),
            **kw,
        )

    def to_json_dict(self) -> Dict:
        """The ``encoder_config.json`` dict (dtype as a string)."""
        d = dataclasses.asdict(self)
        d["dtype"] = str(d["dtype"]).replace("torch.", "")
        return d


def position_ids_from_input_ids(input_ids: torch.Tensor, pad_token_id: int) -> torch.Tensor:
    """RoBERTa-style position ids: positions count non-pad tokens and start
    at pad_token_id + 1."""
    mask = (input_ids != pad_token_id).to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask + pad_token_id


class XLMREmbeddings(nn.Module):
    def __init__(self, cfg: XLMRConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        pos = position_ids_from_input_ids(input_ids, self.cfg.pad_token_id)
        x = (
            self.word_embeddings(input_ids)
            + self.position_embeddings(pos)
            + self.token_type_embeddings(torch.zeros_like(input_ids))
        )
        return self.LayerNorm(x)


class XLMRLayer(nn.Module):
    def __init__(self, cfg: XLMRConfig) -> None:
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.q = nn.Linear(h, h)
        self.k = nn.Linear(h, h)
        self.v = nn.Linear(h, h)
        self.attn_out = nn.Linear(h, h)
        self.attn_ln = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.ffn_in = nn.Linear(h, cfg.intermediate_size)
        self.ffn_out = nn.Linear(cfg.intermediate_size, h)
        self.ffn_ln = nn.LayerNorm(h, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        attn = multi_head_attention(
            self.q(x), self.k(x), self.v(x), attention_mask,
            num_heads=c.num_heads, use_flash=c.use_flash,
        )
        x = self.attn_ln(x + self.attn_out(attn))
        y = self.ffn_out(nn.functional.gelu(self.ffn_in(x), approximate="none"))
        return self.ffn_ln(x + y)


class XLMREncoder(nn.Module):
    """Full encoder: ``forward`` returns pooled (and optionally normalized)
    f32 sentence embeddings; ``hidden_states`` the last hidden layer."""

    def __init__(self, cfg: XLMRConfig) -> None:
        super().__init__()
        if cfg.lora_rank:
            raise NotImplementedError(
                "task-LoRA (jina-embeddings-v3) is not ported yet (ROADMAP queue 1, other families)"
            )
        self.cfg = cfg
        self.embeddings = XLMREmbeddings(cfg)
        self.layers = nn.ModuleList(XLMRLayer(cfg) for _ in range(cfg.num_layers))

    def hidden_states(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        x = self.embeddings(input_ids)
        for layer in self.layers:
            x = layer(x, attention_mask)
        return x

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        x = self.hidden_states(input_ids, attention_mask)
        return pool_and_normalize(x, attention_mask, self.cfg.pooling, self.cfg.normalize)

    def token_embeddings(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Per-token L2-normalized f32 embeddings (B, S, d) for multi-vector
        (ColBERT / BGE-M3 colbert-head) late interaction; pad tokens zeroed.
        Feed into :mod:`~codemix_dense_retrieval_torch.ops.maxsim`."""
        return normalize_tokens(self.hidden_states(input_ids, attention_mask), attention_mask)

    def embed_with_tokens(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One backbone pass -> (pooled sentence embedding, per-token
        normalized embeddings), so the dense index and the token store are
        built together without a second forward."""
        x = self.hidden_states(input_ids, attention_mask)
        pooled = pool_and_normalize(x, attention_mask, self.cfg.pooling, self.cfg.normalize)
        return pooled, normalize_tokens(x, attention_mask)


def normalize_tokens(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """Hidden states -> f32, L2-normalized per token, pad tokens set to 0."""
    t = hidden.to(torch.float32)
    t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)
    return t * attention_mask.to(torch.float32)[..., None]


def init_random_(model: XLMREncoder, generator: torch.Generator, std: float = 0.02) -> None:
    """Seeded random init in place: normal(0, std) for every matrix and
    embedding, zero biases, unit LayerNorm scales."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Linear, nn.Embedding)):
                module.weight.normal_(0.0, std, generator=generator)
                if getattr(module, "bias", None) is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()


def pool_and_normalize(
    hidden: torch.Tensor,
    attention_mask: torch.Tensor,
    pooling: str,
    normalize: bool,
) -> torch.Tensor:
    """cls | mean | last_token pooling + L2 norm; returns f32."""
    mask = attention_mask.to(hidden.dtype)[..., None]  # (B, S, 1)
    if pooling == "cls":
        pooled = hidden[:, 0]
    elif pooling == "mean":
        pooled = (hidden * mask).sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1e-9)
    elif pooling == "last_token":
        lengths = attention_mask.to(torch.int64).sum(dim=1)
        idx = torch.clamp(lengths - 1, min=0)
        pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]
    else:
        raise ValueError(f"unknown pooling {pooling!r}")
    pooled = pooled.to(torch.float32)
    if normalize:
        pooled = pooled / torch.clamp(
            torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-12
        )
    return pooled
