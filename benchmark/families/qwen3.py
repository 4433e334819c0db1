"""Qwen3-Embedding: Hugging Face names are the port's ``Qwen3Encoder``'s."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from reference import qwen3 as reference


def shapes(model: Dict) -> Dict[str, tuple]:
    return reference.shapes(model)


def port_encoder(config: Dict, weights: Dict[str, torch.Tensor], tokenizer, device: torch.device,
                 dtype: torch.dtype, weight_quant: Optional[str] = None):
    from codemix_dense_retrieval_torch.models.encoder import TextEncoder
    from codemix_dense_retrieval_torch.models.qwen3 import Qwen3Config, Qwen3Encoder

    cfg = Qwen3Config.from_hf_config(config["model"], dtype=dtype, use_flash=device.type == "cuda")
    with torch.device("meta"):
        module = Qwen3Encoder(cfg)
    return TextEncoder(config["encoder_name"], cfg, dict(weights), tokenizer, model=module, device=device,
                       weight_quant=weight_quant)


def port_layer():
    """The port's layer module (a fault that returns its state unchanged
    is planted in its ``forward``)."""
    from codemix_dense_retrieval_torch.models.qwen3 import Qwen3Layer

    return Qwen3Layer


def tiny(config: Dict, layers: int, hidden: int) -> None:
    """Cut ``config`` in place to a CPU test's size (``layers`` layers of
    width ``hidden`` over a 1,000-word vocabulary)."""
    heads = max(2, hidden // 32)
    config["model"].update(hidden_size=hidden, intermediate_size=2 * hidden, num_hidden_layers=layers,
                           num_attention_heads=heads, num_key_value_heads=heads // 2, head_dim=16,
                           vocab_size=1000, max_position_embeddings=1024)
    config["tokenizer"].update(words=[0, 990], specials={"<|endoftext|>": 990, "<|im_start|>": 991})
