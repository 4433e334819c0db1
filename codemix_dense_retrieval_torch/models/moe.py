"""The mixture-of-experts feed-forward of DeepSeek-V3 (Moonlight, Kimi-K2):
a sigmoid router with a selection bias, E routed experts of which each
token takes k, and shared experts every token takes.

For the real tokens ``x`` (n, H) of a batch:

- route (span ``moe.route``): logits ``x W_g^T`` in f32, scores
  ``s = sigmoid(logits)``; each token chooses the k experts of largest
  ``s + e_score_correction_bias`` (the bias chooses, it does not weigh:
  ``noaux_tc`` with one group); its weights are the chosen unbiased ``s``,
  divided by their sum (``norm_topk_prob``), times
  ``routed_scaling_factor``;
- dispatch (``moe.dispatch``): the n k (token, expert) rows sorted by
  expert (stable), each expert's running end found on the device by a
  search of the sorted ids, the rows of ``x`` gathered in that order;
- experts (``moe.experts``): gate and up of every expert as one grouped
  product (E, H, 2F), SiLU(gate) * up, then down as another (E, F, H):
  two launches a layer whatever E is
  (:func:`~codemix_dense_retrieval_torch.ops.grouped_mm.grouped_mm`);
- combine (``moe.combine``): the rows return to token order and each
  token's k rows are summed with their weights in f32, cast back, plus the
  shared experts' SiLU-gated MLP of the token.

No token is dropped and no expert has a capacity. Only the tokens the
caller names are routed (``token_index``, flat positions in the batch);
every other position comes out as zeros. The forward reads nothing back
from the card: every shape follows from ``token_index``'s length. While
tracing, the steps are spans with device times, ``moe.layer_calls`` and
``moe.routed_rows`` (n k) count on the host, and ``moe.expert_rows`` is a
per-expert histogram summed on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from codemix_dense_retrieval_torch.models.qwen3 import Qwen3Mlp
from codemix_dense_retrieval_torch.ops.grouped_mm import GroupedLinear
from codemix_dense_retrieval_torch.utils import timing


class SigmoidRouter(nn.Module):
    """``weight`` (E, H) and ``e_score_correction_bias`` (E,), HF's
    ``DeepseekV3TopkRouter`` with one group."""

    def __init__(self, experts: int, hidden: int, top_k: int, scale: float, normalize: bool) -> None:
        super().__init__()
        self.top_k, self.scale, self.normalize = top_k, scale, normalize
        self.weight = nn.Parameter(torch.empty(experts, hidden))
        self.register_buffer("e_score_correction_bias", torch.zeros(experts))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(chosen experts (n, k) int64, their weights (n, k) f32)."""
        scores = torch.sigmoid(nn.functional.linear(x.to(torch.float32), self.weight.to(torch.float32)))
        chosen = torch.topk(scores + self.e_score_correction_bias.to(torch.float32), self.top_k, dim=-1).indices
        w = scores.gather(1, chosen)
        if self.normalize:
            w = w / w.sum(dim=-1, keepdim=True)
        return chosen, w * self.scale


class RoutedExperts(nn.Module):
    """E SiLU-gated experts of width F, stacked: ``gate_up_proj`` (E, 2F, H)
    holds each expert's gate rows then its up rows, ``down_proj`` (E, H, F)."""

    def __init__(self, experts: int, hidden: int, width: int) -> None:
        super().__init__()
        self.width = width
        self.gate_up_proj = GroupedLinear(experts, hidden, 2 * width)
        self.down_proj = GroupedLinear(experts, width, hidden)

    def forward(self, xs: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
        gu = self.gate_up_proj(xs, offsets)
        return self.down_proj(nn.functional.silu(gu[:, : self.width]) * gu[:, self.width:], offsets)


class MoeLayer(nn.Module):
    """Router, routed experts and shared experts (see the module docstring)
    of a DeepSeek-V3 config (``hidden_size``, ``n_routed_experts``,
    ``moe_intermediate_size``, ``num_experts_per_tok``, ``n_shared_experts``,
    ``routed_scaling_factor``, ``norm_topk_prob``)."""

    def __init__(self, cfg) -> None:
        super().__init__()
        e, h, f = cfg.n_routed_experts, cfg.hidden_size, cfg.moe_intermediate_size
        self.experts_n, self.top_k = e, cfg.num_experts_per_tok
        self.gate = SigmoidRouter(e, h, self.top_k, cfg.routed_scaling_factor, cfg.norm_topk_prob)
        self.experts = RoutedExperts(e, h, f)
        self.shared_experts = Qwen3Mlp(cfg, f * cfg.n_shared_experts)

    def forward(self, h: torch.Tensor, token_index: torch.Tensor) -> torch.Tensor:
        """``h`` (..., H); ``token_index`` (n,) flat positions of the tokens
        to route. Returns ``h``'s shape, zeros where no token was routed."""
        dev, k = h.device, self.top_k
        flat = h.reshape(-1, h.shape[-1])
        n = token_index.shape[0]
        timing.count("moe.layer_calls")
        timing.count("moe.routed_rows", n * k)
        x = flat.index_select(0, token_index)
        with timing.span("moe.route", device=dev):
            chosen, weights = self.gate(x)
        with timing.span("moe.dispatch", device=dev):
            ids, order = torch.sort(chosen.reshape(-1), stable=True)
            experts = torch.arange(self.experts_n, device=dev, dtype=ids.dtype)
            offsets = torch.searchsorted(ids, experts, right=True).to(torch.int32)
            xs = x.index_select(0, order // k)
        if timing.tracing():
            timing.count_device("moe.expert_rows", torch.diff(offsets, prepend=offsets.new_zeros(1)))
        with timing.span("moe.experts", device=dev):
            ys = self.experts(xs, offsets)
        with timing.span("moe.combine", device=dev):
            rows = torch.empty_like(ys).index_copy_(0, order, ys).reshape(n, k, -1)
            routed = (rows.to(torch.float32) * weights[..., None]).sum(dim=1).to(h.dtype)
            out = torch.zeros_like(flat).index_copy_(0, token_index, routed + self.shared_experts(x))
        return out.reshape(h.shape)
