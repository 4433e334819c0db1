"""Kimi Linear (Kimi-Linear-48B-A3B): Hugging Face names, which the port's
converter takes (each MoE layer's held experts stacked, ``block_sparse_moe``
read as the port's ``mlp``). The draws of ``A_log`` and ``dt_bias`` go
through the reference's :func:`~reference.kimi_linear.decay_params` first,
as the reference's forward takes them."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from reference import kimi_linear as reference


def shapes(model: Dict) -> Dict[str, tuple]:
    return reference.shapes(model)


def port_weights(model: Dict, weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The seeded weights with each KDA layer's decay draws mapped to
    ``A_log`` and ``dt_bias`` (new tensors in the weights' dtype; the others
    as they are)."""
    out = dict(weights)
    for name in weights:
        if name.endswith("self_attn.A_log"):
            p = name[: -len("A_log")]
            a_log, dt_bias = reference.decay_params(weights[p + "A_log"], weights[p + "dt_bias"],
                                                    model["decay_draw_std"])
            dtype, dev = weights[name].dtype, weights[name].device
            out[p + "A_log"] = a_log.to(dev, dtype)
            out[p + "dt_bias"] = dt_bias.to(dev, dtype)
    return out


def port_encoder(config: Dict, weights: Dict[str, torch.Tensor], tokenizer, device: torch.device,
                 dtype: torch.dtype, weight_quant: Optional[str] = None):
    from codemix_dense_retrieval_torch.models.encoder import TextEncoder
    from codemix_dense_retrieval_torch.models.kimi_linear import (
        KimiLinearConfig,
        KimiLinearEncoder,
        convert_kimi_linear_state_dict,
    )

    cfg = KimiLinearConfig.from_hf_config(config["model"], dtype=dtype)
    with torch.device("meta"):
        module = KimiLinearEncoder(cfg)
    params = convert_kimi_linear_state_dict(port_weights(config["model"], weights), cfg)
    return TextEncoder(config["encoder_name"], cfg, params, tokenizer, model=module, device=device,
                       weight_quant=weight_quant)


def port_layer():
    """The port's layer module (a fault that returns its state unchanged
    is planted in its ``forward``)."""
    from codemix_dense_retrieval_torch.models.kimi_linear import KimiLinearLayer

    return KimiLinearLayer


def tiny(config: Dict, layers: int, hidden: int) -> None:
    """Cut ``config`` in place to a CPU test's size: ``layers`` layers
    (every fourth and the last latent attention, the others KDA; the first
    dense, the rest MoE) of width ``hidden``, KDA heads of 32, 8 of 16
    experts held (2 a token, 1 shared), small latent widths, over a
    1,000-word vocabulary; the decay draws at the configuration's
    ``init_std``."""
    full = sorted({*range(4, layers + 1, 4), layers})
    lin = dict(config["model"]["linear_attn_config"], num_heads=max(2, hidden // 64), head_dim=32,
               full_attn_layers=full, kda_layers=[i for i in range(1, layers + 1) if i not in full])
    config["model"].update(
        hidden_size=hidden, intermediate_size=2 * hidden, num_hidden_layers=layers,
        num_attention_heads=max(2, hidden // 32), kv_lora_rank=hidden // 2, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, moe_intermediate_size=hidden, num_experts=8,
        expert_shard={"experts_total": 16, "held": [0, 8], "chips": 2}, num_experts_per_token=2,
        num_shared_experts=1, vocab_size=1000, max_position_embeddings=1024, linear_attn_config=lin,
        decay_draw_std=config["init_std"])
    config["tokenizer"].update(words=[0, 990], specials={"[EOS]": 990})
