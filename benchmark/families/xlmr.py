"""XLM-RoBERTa (BGE-M3): Hugging Face names -> the port's ``XLMREncoder``."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from reference import xlmr as reference

# Hugging Face module of each port layer module (models/convert.py's map)
_PORT_LAYER = {
    "attention.self.query": "q",
    "attention.self.key": "k",
    "attention.self.value": "v",
    "attention.output.dense": "attn_out",
    "attention.output.LayerNorm": "attn_ln",
    "intermediate.dense": "ffn_in",
    "output.dense": "ffn_out",
    "output.LayerNorm": "ffn_ln",
}


def shapes(model: Dict) -> Dict[str, tuple]:
    return reference.shapes(model)


def port_name(name: str) -> str:
    if not name.startswith("encoder.layer."):
        return name
    i, rest = name[len("encoder.layer."):].split(".", 1)
    module, leaf = rest.rsplit(".", 1)
    return f"layers.{i}.{_PORT_LAYER[module]}.{leaf}"


def port_encoder(config: Dict, weights: Dict[str, torch.Tensor], tokenizer, device: torch.device,
                 dtype: torch.dtype, weight_quant: Optional[str] = None):
    from codemix_dense_retrieval_torch.models.encoder import TextEncoder
    from codemix_dense_retrieval_torch.models.xlmr import XLMRConfig, XLMREncoder

    cfg = XLMRConfig.from_hf_config(config["model"], pooling=config["pooling"], dtype=dtype,
                                    use_flash=device.type == "cuda")
    with torch.device("meta"):
        module = XLMREncoder(cfg)
    params = {port_name(n): t for n, t in weights.items()}
    return TextEncoder(config["encoder_name"], cfg, params, tokenizer, model=module, device=device,
                       weight_quant=weight_quant)


def port_layer():
    """The port's layer module (a fault that returns its state unchanged
    is planted in its ``forward``)."""
    from codemix_dense_retrieval_torch.models.xlmr import XLMRLayer

    return XLMRLayer


def tiny(config: Dict, layers: int, hidden: int) -> None:
    """Cut ``config`` in place to a CPU test's size (``layers`` layers of
    width ``hidden`` over a 1,000-word vocabulary)."""
    config["model"].update(hidden_size=hidden, intermediate_size=2 * hidden, num_hidden_layers=layers,
                           num_attention_heads=max(2, hidden // 32), vocab_size=1000, max_position_embeddings=514)
    config["tokenizer"].update(words=[4, 995])
    config["tokenizer"]["specials"]["<mask>"] = 999
