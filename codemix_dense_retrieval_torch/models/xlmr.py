"""XLM-RoBERTa encoder as ``nn.Module``s — the architecture behind BGE-M3,
multilingual-E5 and LaBSE-style embedding models.

embeddings -> N post-LN transformer layers (exact GELU) -> pooling
(cls | mean | last_token) -> L2 norm; the packed forward
(:meth:`XLMREncoder.packed_embeddings`) runs several passages per row under
a block-diagonal mask and pools each segment. With ``lora_rank`` > 0 every
projection is a :class:`LoraDense` (jina-embeddings-v3's task adapters,
chosen per call by ``task_id``). Parameter names follow the JAX package's
Flax tree (``embeddings.word_embeddings``, ``layers.<i>.q``, ...),
so :mod:`~codemix_dense_retrieval_torch.models.convert` maps one onto the
other leaf by leaf. Attention goes through
:func:`~codemix_dense_retrieval_torch.ops.flash_attention.multi_head_attention`
(kernel B past the length crossover).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

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
    # jina-v3 task-LoRA: rank 0 = plain projections
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
    def jina_v3(cls, **kw) -> "XLMRConfig":
        """jina-embeddings-v3: XLM-R backbone + 5-task LoRA (r=4), mean
        pooling. Task ids follow JINA_V3_TASKS."""
        defaults = dict(pooling="mean", lora_rank=4, lora_tasks=5)
        defaults.update(kw)
        return cls(**defaults)

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

    def forward(self, input_ids: torch.Tensor, position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``position_ids`` default to RoBERTa's (from the pad convention);
        packed rows pass their per-segment positions."""
        pos = position_ids if position_ids is not None else position_ids_from_input_ids(
            input_ids, self.cfg.pad_token_id
        )
        x = (
            self.word_embeddings(input_ids)
            + self.position_embeddings(pos)
            + self.token_type_embeddings(torch.zeros_like(input_ids))
        )
        return self.LayerNorm(x)


# jina-embeddings-v3 task-adapter order (index = task id)
JINA_V3_TASKS = (
    "retrieval.query",
    "retrieval.passage",
    "separation",
    "classification",
    "text-matching",
)


class LoraDense(nn.Module):
    """A Linear layer (``base``) with per-task low-rank adaptation: task t
    adds ``alpha / rank * (x @ lora_a[t]) @ lora_b[t]`` to the frozen base
    projection, with ``lora_a`` (tasks, in, rank) and ``lora_b`` (tasks,
    rank, out) as in the JAX package's tree; no adapters without tasks.
    ``task_id`` None is task 0."""

    def __init__(self, in_features: int, out_features: int, rank: int, num_tasks: int,
                 alpha: float = 1.0) -> None:
        super().__init__()
        self.rank, self.alpha = rank, alpha
        self.base = nn.Linear(in_features, out_features)
        self.lora_a = self.lora_b = None
        if rank and num_tasks:
            self.lora_a = nn.Parameter(torch.zeros(num_tasks, in_features, rank))
            self.lora_b = nn.Parameter(torch.zeros(num_tasks, rank, out_features))

    def forward(self, x: torch.Tensor, task_id: Optional[int] = None) -> torch.Tensor:
        out = self.base(x)
        if self.lora_a is None:
            return out
        t = 0 if task_id is None else int(task_id)
        return out + (self.alpha / self.rank) * ((x @ self.lora_a[t]) @ self.lora_b[t])


class XLMRLayer(nn.Module):
    def __init__(self, cfg: XLMRConfig) -> None:
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size

        def dense(n_in, n_out):
            if cfg.lora_rank:
                return LoraDense(n_in, n_out, cfg.lora_rank, cfg.lora_tasks, cfg.lora_alpha)
            return nn.Linear(n_in, n_out)

        self.q = dense(h, h)
        self.k = dense(h, h)
        self.v = dense(h, h)
        self.attn_out = dense(h, h)
        self.attn_ln = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.ffn_in = dense(h, cfg.intermediate_size)
        self.ffn_out = dense(cfg.intermediate_size, h)
        self.ffn_ln = nn.LayerNorm(h, eps=cfg.layer_norm_eps)

    def _dense(self, layer: nn.Module, x: torch.Tensor, task_id: Optional[int]) -> torch.Tensor:
        return layer(x, task_id) if isinstance(layer, LoraDense) else layer(x)

    def forward(
        self, x: torch.Tensor, attention_mask: torch.Tensor, task_id: Optional[int] = None,
        segment_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        c = self.cfg
        attn = multi_head_attention(
            self._dense(self.q, x, task_id), self._dense(self.k, x, task_id),
            self._dense(self.v, x, task_id), attention_mask,
            num_heads=c.num_heads, use_flash=c.use_flash, segment_ids=segment_ids,
        )
        x = self.attn_ln(x + self._dense(self.attn_out, attn, task_id))
        y = nn.functional.gelu(self._dense(self.ffn_in, x, task_id), approximate="none")
        return self.ffn_ln(x + self._dense(self.ffn_out, y, task_id))


class XLMREncoder(nn.Module):
    """Full encoder: ``forward`` returns pooled (and optionally normalized)
    f32 sentence embeddings; ``hidden_states`` the last hidden layer."""

    def __init__(self, cfg: XLMRConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.embeddings = XLMREmbeddings(cfg)
        self.layers = nn.ModuleList(XLMRLayer(cfg) for _ in range(cfg.num_layers))

    def hidden_states(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor, task_id: Optional[int] = None
    ) -> torch.Tensor:
        x = self.embeddings(input_ids)
        for layer in self.layers:
            x = layer(x, attention_mask, task_id)
        return x

    def forward(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor, task_id: Optional[int] = None
    ) -> torch.Tensor:
        x = self.hidden_states(input_ids, attention_mask, task_id)
        return pool_and_normalize(x, attention_mask, self.cfg.pooling, self.cfg.normalize)

    def token_embeddings(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor, task_id: Optional[int] = None
    ) -> torch.Tensor:
        """Per-token L2-normalized f32 embeddings (B, S, d) for multi-vector
        (ColBERT / BGE-M3 colbert-head) late interaction; pad tokens zeroed.
        Feed into :mod:`~codemix_dense_retrieval_torch.ops.maxsim`."""
        return normalize_tokens(self.hidden_states(input_ids, attention_mask, task_id), attention_mask)

    def embed_with_tokens(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor, task_id: Optional[int] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One backbone pass -> (pooled sentence embedding, per-token
        normalized embeddings), so the dense index and the token store are
        built together without a second forward."""
        x = self.hidden_states(input_ids, attention_mask, task_id)
        pooled = pool_and_normalize(x, attention_mask, self.cfg.pooling, self.cfg.normalize)
        return pooled, normalize_tokens(x, attention_mask)

    def _packed_hidden(
        self, input_ids: torch.Tensor, segment_ids: torch.Tensor, position_ids: torch.Tensor,
        task_id: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(f32 last hidden layer, valid-token mask) of packed rows:
        per-segment positions, attention that never crosses a segment."""
        mask = (segment_ids > 0).to(torch.int32)
        x = self.embeddings(input_ids, position_ids)
        for layer in self.layers:
            x = layer(x, mask, task_id, segment_ids=segment_ids)
        return x.to(torch.float32), mask

    def packed_embeddings(
        self,
        input_ids: torch.Tensor,     # (B, S) packed rows
        segment_ids: torch.Tensor,   # (B, S) int32; 0 = pad, 1..M = sequences
        position_ids: torch.Tensor,  # (B, S) per-segment RoBERTa positions
        seg_starts: torch.Tensor,    # (B, M) first token of each slot
        seg_lengths: torch.Tensor,   # (B, M) tokens per slot (0 = empty)
        task_id: Optional[int] = None,
        *,
        max_segments: int,
    ) -> torch.Tensor:
        """Sequence-packed forward: several passages share a row under a
        block-diagonal attention mask. Returns per-SEGMENT pooled f32
        embeddings (B, max_segments, d), empty slots exact zeros; callers
        unpack with the packer's (row, slot) placement. Equal to the unpacked
        forward up to float reassociation: positions restart per segment,
        attention stays inside a segment and pooling reduces one segment."""
        c = self.cfg
        x, _ = self._packed_hidden(input_ids, segment_ids, position_ids, task_id)
        return pool_segments(x, segment_ids, seg_starts, seg_lengths, c.pooling, c.normalize, max_segments)

    def packed_embed_with_tokens(
        self,
        input_ids: torch.Tensor,
        segment_ids: torch.Tensor,
        position_ids: torch.Tensor,
        seg_starts: torch.Tensor,
        seg_lengths: torch.Tensor,
        task_id: Optional[int] = None,
        *,
        max_segments: int,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Packed :meth:`embed_with_tokens`: one backbone pass -> (per-segment
        pooled (B, M, d) f32, per-token normalized (B, S, d) f32 with pad
        tokens zeroed); callers cut each segment's token block out of its
        row with the packer's (start, length) table."""
        c = self.cfg
        x, mask = self._packed_hidden(input_ids, segment_ids, position_ids, task_id)
        pooled = pool_segments(x, segment_ids, seg_starts, seg_lengths, c.pooling, c.normalize, max_segments)
        return pooled, normalize_tokens(x, mask)


def normalize_tokens(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """Hidden states -> f32, L2-normalized per token, pad tokens set to 0."""
    t = hidden.to(torch.float32)
    t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)
    return t * attention_mask.to(torch.float32)[..., None]


def init_random_(model: nn.Module, generator: torch.Generator, std: float = 0.02) -> None:
    """Seeded random init in place, for any encoder family: normal(0, std)
    for every matrix, embedding and LoRA adapter (both factors, so a random
    jina-v3 model's task choice shows; the JAX package starts ``lora_b`` at
    zero), zero biases, unit norm scales."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Linear, nn.Embedding)):
                module.weight.normal_(0.0, std, generator=generator)
                if getattr(module, "bias", None) is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, LoraDense) and module.lora_a is not None:
                module.lora_a.normal_(0.0, std, generator=generator)
                module.lora_b.normal_(0.0, std, generator=generator)
            elif hasattr(module, "weight") and module.weight.ndim == 1:  # RMSNorm
                module.weight.fill_(1.0)
            elif hasattr(module, "weight") and module.weight.ndim > 1:  # a router, stacked experts
                module.weight.normal_(0.0, std, generator=generator)
                if getattr(module, "e_score_correction_bias", None) is not None:
                    module.e_score_correction_bias.zero_()


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


def pool_segments(
    hidden_f32: torch.Tensor,   # (B, S, d) f32
    segment_ids: torch.Tensor,  # (B, S) int32, 0 = pad
    seg_starts: torch.Tensor,   # (B, M)
    seg_lengths: torch.Tensor,  # (B, M)
    pooling: str,
    normalize: bool,
    max_segments: int,
) -> torch.Tensor:
    """Per-SEGMENT pooling of packed rows -> (B, M, d) f32, empty slots
    exact zeros. Mean pooling is a one-hot segment matrix times the hidden
    states (no scatter, no loop over segments)."""
    x = hidden_f32
    b, _, d = x.shape
    starts = seg_starts.to(torch.int64)
    if pooling == "cls":
        pooled = torch.gather(x, 1, starts[:, :, None].expand(b, max_segments, d))
    elif pooling == "mean":
        slot = torch.arange(1, max_segments + 1, device=x.device, dtype=segment_ids.dtype)
        sel = (segment_ids[:, None, :] == slot[None, :, None]).to(torch.float32)
        pooled = torch.einsum("bms,bsd->bmd", sel, x) / torch.clamp(
            seg_lengths[:, :, None].to(torch.float32), min=1e-9
        )
    elif pooling == "last_token":
        idx = starts + torch.clamp(seg_lengths.to(torch.int64) - 1, min=0)
        pooled = torch.gather(x, 1, idx[:, :, None].expand(b, max_segments, d))
    else:
        raise ValueError(f"unknown pooling {pooling!r}")
    if normalize:
        pooled = pooled / torch.clamp(torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-12)
    return pooled * (seg_lengths > 0)[:, :, None].to(torch.float32)
