"""Kimi Linear decoder embedder (Kimi-Linear-48B-A3B) as ``nn.Module``s.

Architecture (HF ``model_type`` ``kimi_linear``; the Kimi Linear report,
arXiv:2510.26692): token embeddings, then pre-norm blocks (RMSNorm; token
mixing; residual; RMSNorm; a feed-forward; residual) and a final RMSNorm;
the embedding is the L2-normalized LAST-token hidden state (the
``last_token`` dialect), as for the DeepSeek-V3 blocks.

- Token mixing is Kimi Delta Attention (KDA) in the layers
  ``linear_attn_config["kda_layers"]`` and latent attention without rotary
  (:class:`~codemix_dense_retrieval_torch.models.deepseek_v3.MlaAttention`,
  ``use_rope=False``) in its ``full_attn_layers`` (both counted from 1).
- A KDA block (:class:`KdaAttention`), per head of width 128:
  ``q, k, v = SiLU(causal depthwise conv4(x W_{q,k,v}))`` (no bias, restarted
  at each passage or packed segment); ``q, k`` L2-normalized, q scaled by
  128^-1/2; a per-channel log decay ``g = -exp(A_log_h) softplus(f_b(f_a(x))
  + dt_bias)``; ``beta = sigmoid(b_proj(x))``; the scan of
  :func:`~codemix_dense_retrieval_torch.ops.kda.kda_chunk`; then
  ``o_proj(RMSNorm(o) w * sigmoid(g_b(g_a(x))))`` per head. While tracing
  the block is the span ``kda.attention`` and its scan ``kda.scan`` (both
  with device times; the scan counts ``kda.chunks``).
- The first ``first_k_dense_replace`` layers' feed-forward is a SiLU-gated
  MLP; the others the mixture of experts of
  :mod:`~codemix_dense_retrieval_torch.models.moe` (sigmoid router with a
  selection bias, ``num_experts_per_token`` of ``num_experts``, weights
  renormalized over the chosen and scaled, one shared expert), holding the
  experts ``experts_held`` (all by default; a share under expert
  parallelism, the router keeping all of its outputs).

Parameter names are HF's (``layers.<i>.self_attn.q_conv1d.weight``,
``layers.<i>.self_attn.A_log``, ...), except that each MoE layer lives under
``mlp`` (HF's ``block_sparse_moe``) with its held experts stacked
(:func:`convert_kimi_linear_state_dict`). ``A_log`` (H,) and ``dt_bias``
(H * 128,) are kept in the compute dtype with the rest of the module.

The encoder keeps :class:`~codemix_dense_retrieval_torch.models.deepseek_v3.DeepseekV3Encoder`'s
call contract (``token_count``, packed forwards): a packed segment restarts
the convolutions and the state.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from codemix_dense_retrieval_torch.models.deepseek_v3 import DeepseekV3Encoder, MlaAttention
from codemix_dense_retrieval_torch.models.moe import MoeLayer
from codemix_dense_retrieval_torch.models.qwen3 import Qwen3Mlp, RMSNorm
from codemix_dense_retrieval_torch.ops.kda import decay_gate, gated_rms_norm, kda_chunk, short_conv
from codemix_dense_retrieval_torch.utils import timing

_FULL_ATTN = (4, 8, 12, 16, 20, 24, 27)


@dataclass(frozen=True)
class KimiLinearConfig:
    """Defaults: moonshotai/Kimi-Linear-48B-A3B-Instruct's published
    config.json. The MoE fields carry DeepSeek-V3's names (the shared
    :class:`~codemix_dense_retrieval_torch.models.moe.MoeLayer` reads them):
    ``n_routed_experts`` is the router's width (``num_experts``), and
    ``experts_held`` the experts this module holds."""

    vocab_size: int = 163_840
    hidden_size: int = 2304
    num_layers: int = 27
    num_heads: int = 32                      # latent attention's heads
    intermediate_size: int = 9216
    moe_intermediate_size: int = 1024
    n_routed_experts: int = 256
    experts_held: Tuple[int, int] = (0, 256)
    n_shared_experts: int = 1
    num_experts_per_tok: int = 8
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10_000.0             # unread: the latent attention is NoPE
    kda_heads: int = 32
    kda_head_dim: int = 128
    conv_size: int = 4
    full_attn_layers: Tuple[int, ...] = _FULL_ATTN   # counted from 1
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 8192
    normalize: bool = True
    dtype: torch.dtype = torch.float32

    def __post_init__(self) -> None:
        # a converted checkpoint's JSON gives lists
        object.__setattr__(self, "experts_held", tuple(self.experts_held))
        object.__setattr__(self, "full_attn_layers", tuple(self.full_attn_layers))

    @classmethod
    def tiny(cls, **kw) -> "KimiLinearConfig":
        """4 layers (KDA, KDA, KDA, MLA), 8 experts, heads of 16."""
        defaults = dict(
            vocab_size=100, hidden_size=32, num_layers=4, num_heads=4, intermediate_size=64,
            moe_intermediate_size=16, n_routed_experts=8, experts_held=(0, 8), num_experts_per_tok=2,
            kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8, kda_heads=2,
            kda_head_dim=16, full_attn_layers=(4,), max_position_embeddings=128,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def from_hf_config(cls, hf: Dict, **kw) -> "KimiLinearConfig":
        """The config of an HF ``kimi_linear`` config.json; raises on what
        this module does not compute (a query LoRA, more than one expert
        group, a router activation other than sigmoid, rope scaling, latent
        attention with rotary, KDA heads of unequal key and value widths).
        An ``expert_shard`` key (``{"experts_total": E, "held": [lo, hi]}``)
        holds experts [lo, hi) of E, ``num_experts`` then counting the held."""
        lin = hf.get("linear_attn_config") or {}
        unsupported = {
            "q_lora_rank": hf.get("q_lora_rank") is not None,
            "num_expert_group": hf.get("num_expert_group", 1) > 1 or hf.get("topk_group", 1) > 1,
            "moe_router_activation_func": hf.get("moe_router_activation_func", "sigmoid") != "sigmoid",
            "rope_scaling": bool(hf.get("rope_scaling")),
            "mla_use_nope": not hf.get("mla_use_nope", False),
            "linear_attn_config": not lin or lin.get("head_dim", 128) != lin.get("v_head_dim", lin.get("head_dim")),
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise ValueError(f"kimi_linear config: unsupported {', '.join(f'{k}={hf.get(k)!r}' for k in bad)}")
        shard = hf.get("expert_shard")
        if shard:
            total, held = shard["experts_total"], tuple(shard["held"])
            if held[1] - held[0] != hf["num_experts"]:
                raise ValueError(f"expert_shard holds {held} but num_experts is {hf['num_experts']}")
        else:
            total, held = hf["num_experts"], (0, hf["num_experts"])
        layers = hf["num_hidden_layers"]
        full = tuple(lin.get("full_attn_layers", ()))
        kda = tuple(lin.get("kda_layers", ()))
        if sorted(full + kda) != list(range(1, layers + 1)):
            raise ValueError(f"kimi_linear config: full {full} and KDA {kda} layers do not cover 1..{layers}")
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            num_layers=layers,
            num_heads=hf["num_attention_heads"],
            intermediate_size=hf["intermediate_size"],
            moe_intermediate_size=hf["moe_intermediate_size"],
            n_routed_experts=total,
            experts_held=held,
            n_shared_experts=hf.get("num_shared_experts") or 0,
            num_experts_per_tok=hf["num_experts_per_token"],
            first_k_dense_replace=hf.get("first_k_dense_replace", 0),
            moe_layer_freq=hf.get("moe_layer_freq", 1),
            routed_scaling_factor=hf.get("routed_scaling_factor", 1.0),
            norm_topk_prob=hf.get("moe_renormalize", True),
            kv_lora_rank=hf["kv_lora_rank"],
            qk_nope_head_dim=hf["qk_nope_head_dim"],
            qk_rope_head_dim=hf["qk_rope_head_dim"],
            v_head_dim=hf["v_head_dim"],
            rope_theta=hf.get("rope_theta", 10_000.0),
            kda_heads=lin["num_heads"],
            kda_head_dim=lin["head_dim"],
            conv_size=lin.get("short_conv_kernel_size", 4),
            full_attn_layers=full,
            rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
            max_position_embeddings=hf.get("max_position_embeddings", 8192),
            **kw,
        )

    def is_kda(self, layer: int) -> bool:
        return layer + 1 not in self.full_attn_layers

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace and layer % self.moe_layer_freq == 0


def decay_init_(a_log: torch.Tensor, dt_bias: torch.Tensor, generator: torch.Generator) -> None:
    """The published initialisation of KDA's decay parameters, in place:
    ``A_log = log U(1, 16)`` per head, ``softplus(dt_bias)`` log-uniform in
    [1e-3, 1e-1] per channel."""
    a = torch.empty(a_log.shape, device=a_log.device).uniform_(1.0, 16.0, generator=generator)
    u = torch.rand(dt_bias.shape, device=dt_bias.device, generator=generator)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    a_log.copy_(torch.log(a))
    dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))


class ShortConv(nn.Module):
    """A depthwise causal convolution's ``weight`` (C, 1, K), HF's
    ``ShortConvolution`` without bias (applied by
    :func:`~codemix_dense_retrieval_torch.ops.kda.short_conv`)."""

    def __init__(self, channels: int, taps: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, 1, taps))


class KdaAttention(nn.Module):
    """Kimi Delta Attention (module docstring)."""

    def __init__(self, cfg: KimiLinearConfig) -> None:
        super().__init__()
        self.cfg = cfg
        h, d, hid = cfg.kda_heads, cfg.kda_head_dim, cfg.hidden_size
        self.q_proj = nn.Linear(hid, h * d, bias=False)
        self.k_proj = nn.Linear(hid, h * d, bias=False)
        self.v_proj = nn.Linear(hid, h * d, bias=False)
        self.q_conv1d = ShortConv(h * d, cfg.conv_size)
        self.k_conv1d = ShortConv(h * d, cfg.conv_size)
        self.v_conv1d = ShortConv(h * d, cfg.conv_size)
        self.A_log = nn.Parameter(torch.empty(h))
        self.dt_bias = nn.Parameter(torch.empty(h * d))
        self.f_a_proj = nn.Linear(hid, d, bias=False)
        self.f_b_proj = nn.Linear(d, h * d, bias=False)
        self.b_proj = nn.Linear(hid, h, bias=False)
        self.g_a_proj = nn.Linear(hid, d, bias=False)
        self.g_b_proj = nn.Linear(d, h * d, bias=False)
        self.o_norm = RMSNorm(d, cfg.rms_norm_eps)
        self.o_proj = nn.Linear(h * d, hid, bias=False)

    def init_random_(self, generator: torch.Generator, std: float) -> None:
        """The decay parameters' published initialisation (the encoders'
        seeded random init gives every matrix normal(0, std))."""
        with torch.no_grad():
            decay_init_(self.A_log, self.dt_bias, generator)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        h, d = c.kda_heads, c.kda_head_dim
        with timing.span("kda.attention", device=x.device):
            rows = dict(lengths=None, segment_ids=segment_ids) if segment_ids is not None else dict(lengths=lengths)
            q = short_conv(self.q_proj(x), self.q_conv1d.weight, h, **rows, normalize=True, scale=d ** -0.5)
            k = short_conv(self.k_proj(x), self.k_conv1d.weight, h, **rows, normalize=True)
            v = short_conv(self.v_proj(x), self.v_conv1d.weight, h, **rows)
            g, beta = decay_gate(self.f_b_proj(self.f_a_proj(x)), self.b_proj(x), self.A_log, self.dt_bias)
            with timing.span("kda.scan", device=x.device):
                o = kda_chunk(q, k, v, g, beta, **rows)
            out = gated_rms_norm(o, self.g_b_proj(self.g_a_proj(x)), self.o_norm.weight, c.rms_norm_eps)
            return self.o_proj(out)


class KimiLinearLayer(nn.Module):
    def __init__(self, cfg: KimiLinearConfig, layer: int) -> None:
        super().__init__()
        self.kda = cfg.is_kda(layer)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = KdaAttention(cfg) if self.kda else MlaAttention(cfg, use_rope=False)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = MoeLayer(cfg, held=cfg.experts_held) if cfg.is_moe(layer) else Qwen3Mlp(cfg)

    def forward(self, x, positions, lengths, segment_ids=None, token_index=None):
        h = self.input_layernorm(x)
        if self.kda:
            x = x + self.self_attn(h, lengths, segment_ids)
        else:
            x = x + self.self_attn(h, positions, lengths, segment_ids)
        h = self.post_attention_layernorm(x)
        return x + (self.mlp(h, token_index) if isinstance(self.mlp, MoeLayer) else self.mlp(h))


class KimiLinearEncoder(DeepseekV3Encoder):
    """Decoder-only embedding model over Kimi Linear blocks, with
    :class:`~codemix_dense_retrieval_torch.models.deepseek_v3.DeepseekV3Encoder`'s
    pooling and call contract (``token_count``, packed forwards)."""

    def __init__(self, cfg: KimiLinearConfig) -> None:
        nn.Module.__init__(self)
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(KimiLinearLayer(cfg, i) for i in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.to(cfg.dtype)


_MLP = ("gate_proj", "up_proj", "down_proj")
_KDA = ("q_proj", "k_proj", "v_proj", "q_conv1d", "k_conv1d", "v_conv1d", "f_a_proj", "f_b_proj", "b_proj",
        "g_a_proj", "g_b_proj", "o_norm", "o_proj")
_MLA = ("q_proj", "kv_a_proj_with_mqa", "kv_a_layernorm", "kv_b_proj", "o_proj")


def convert_kimi_linear_state_dict(
    state_dict: Mapping[str, object], cfg: KimiLinearConfig, prefix: str = ""
) -> Dict[str, torch.Tensor]:
    """HF Kimi Linear state dict -> :class:`KimiLinearEncoder` state dict:
    ``prefix`` stripped, an LM head dropped, names kept but for each MoE
    layer: HF's ``block_sparse_moe.`` becomes ``mlp.``, and the held experts
    ``cfg.experts_held`` (numbered as in the checkpoint) are stacked
    (``experts.gate_up_proj.weight`` (E_held, 2F, H): each expert's ``w1``
    (gate) rows then its ``w3`` (up) rows; ``experts.down_proj.weight``
    (E_held, H, F): its ``w2``). ``A_log`` and ``dt_bias`` are flattened
    ((H,), (H * 128,)). Tensors keep their device and dtype; a stack is a
    new tensor."""
    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    out = {name: sd[name] for name in ("embed_tokens.weight", "norm.weight")}
    lo, hi = cfg.experts_held
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        names = [p + "input_layernorm.weight", p + "post_attention_layernorm.weight"]
        a = p + "self_attn."
        if cfg.is_kda(i):
            names += [f"{a}{m}.weight" for m in _KDA]
            out[a + "A_log"] = sd[a + "A_log"].reshape(-1)
            out[a + "dt_bias"] = sd[a + "dt_bias"].reshape(-1)
        else:
            names += [f"{a}{m}.weight" for m in _MLA]
        out.update((name, sd[name]) for name in names)
        if not cfg.is_moe(i):
            out.update((f"{p}mlp.{m}.weight", sd[f"{p}mlp.{m}.weight"]) for m in _MLP)
            continue
        src = f"{p}block_sparse_moe."
        for name in ("gate.weight", "gate.e_score_correction_bias"):
            out[f"{p}mlp.{name}"] = sd[src + name]
        for m in _MLP:
            out[f"{p}mlp.shared_experts.{m}.weight"] = sd[f"{src}shared_experts.{m}.weight"]
        e = f"{src}experts."
        out[f"{p}mlp.experts.gate_up_proj.weight"] = torch.stack([
            torch.cat([sd[f"{e}{j}.w1.weight"], sd[f"{e}{j}.w3.weight"]]) for j in range(lo, hi)])
        out[f"{p}mlp.experts.down_proj.weight"] = torch.stack([sd[f"{e}{j}.w2.weight"] for j in range(lo, hi)])
    return out
