"""DeepSeek-V3 blocks (Moonlight-16B-A3B): Hugging Face names are the port's
``DeepseekV3Encoder``'s, but for each MoE layer's experts, which the port's
converter stacks."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from reference import deepseek_v3 as reference


def shapes(model: Dict) -> Dict[str, tuple]:
    return reference.shapes(model)


def port_encoder(config: Dict, weights: Dict[str, torch.Tensor], tokenizer, device: torch.device,
                 dtype: torch.dtype, weight_quant: Optional[str] = None):
    from codemix_dense_retrieval_torch.models.deepseek_v3 import (
        DeepseekV3Config,
        DeepseekV3Encoder,
        convert_deepseek_v3_state_dict,
    )
    from codemix_dense_retrieval_torch.models.encoder import TextEncoder

    cfg = DeepseekV3Config.from_hf_config(config["model"], dtype=dtype)
    with torch.device("meta"):
        module = DeepseekV3Encoder(cfg)
    params = convert_deepseek_v3_state_dict(weights, cfg)
    return TextEncoder(config["encoder_name"], cfg, params, tokenizer, model=module, device=device,
                       weight_quant=weight_quant)


def port_layer():
    """The port's layer module (a fault that returns its state unchanged
    is planted in its ``forward``)."""
    from codemix_dense_retrieval_torch.models.deepseek_v3 import DeepseekV3Layer

    return DeepseekV3Layer


def tiny(config: Dict, layers: int, hidden: int) -> None:
    """Cut ``config`` in place to a CPU test's size: ``layers`` layers (the
    first dense, the rest MoE) of width ``hidden``, 8 experts of width
    ``hidden`` (2 a token, 1 shared), small latent widths, over a 1,000-word
    vocabulary."""
    config["model"].update(
        hidden_size=hidden, intermediate_size=2 * hidden, num_hidden_layers=layers,
        num_attention_heads=max(2, hidden // 32), kv_lora_rank=hidden // 2, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, moe_intermediate_size=hidden, n_routed_experts=8,
        num_experts_per_tok=2, n_shared_experts=1, vocab_size=1000, max_position_embeddings=1024)
    config["tokenizer"].update(words=[0, 990], specials={"[EOS]": 990})
