"""XLM-RoBERTa (the BGE-M3 encoder) in plain float32 PyTorch.

Written from the published RoBERTa / XLM-R description (Liu et al. 2019,
Conneau et al. 2020) and Hugging Face's ``XLMRobertaModel`` parameter
names: word + absolute position + token-type embeddings, LayerNorm, then
``num_hidden_layers`` post-LN blocks (multi-head softmax attention over the
whole sequence, residual, LayerNorm; a GELU (erf) feed-forward, residual,
LayerNorm). Positions start at ``pad_token_id + 1``. BGE-M3's dense
embedding is the first (``<s>``) token's last hidden state, L2-normalized.
One sequence at a time, unpadded: no mask is needed.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F


def layer_names(num_layers: int) -> list:
    """Every parameter name of the model, in a fixed order."""
    names = [f"embeddings.{n}.weight" for n in ("word_embeddings", "position_embeddings",
                                                 "token_type_embeddings")]
    names += ["embeddings.LayerNorm.weight", "embeddings.LayerNorm.bias"]
    for i in range(num_layers):
        p = f"encoder.layer.{i}."
        for m in ("attention.self.query", "attention.self.key", "attention.self.value",
                  "attention.output.dense", "attention.output.LayerNorm", "intermediate.dense",
                  "output.dense", "output.LayerNorm"):
            names += [p + m + ".weight", p + m + ".bias"]
    return names


def shapes(model: Dict) -> Dict[str, tuple]:
    """Each parameter's shape for a Hugging Face config dict."""
    h, f, v = model["hidden_size"], model["intermediate_size"], model["vocab_size"]
    out = {
        "embeddings.word_embeddings.weight": (v, h),
        "embeddings.position_embeddings.weight": (model["max_position_embeddings"], h),
        "embeddings.token_type_embeddings.weight": (model["type_vocab_size"], h),
    }
    for name in layer_names(model["num_hidden_layers"]):
        if name in out:
            continue
        if "LayerNorm" in name:
            out[name] = (h,)
        elif name.endswith(".bias"):
            out[name] = (f,) if "intermediate.dense" in name else (h,)
        elif "intermediate.dense" in name:
            out[name] = (f, h)
        elif name.endswith("output.dense.weight") and "attention" not in name:
            out[name] = (h, f)
        else:
            out[name] = (h, h)
    return out


def embed(weights: Dict[str, torch.Tensor], model: Dict, ids: Sequence[int]) -> torch.Tensor:
    """The L2-normalized first-token embedding (hidden_size,) of one
    sequence of token ids."""
    w = weights
    h, heads = model["hidden_size"], model["num_attention_heads"]
    dh, eps = h // heads, model["layer_norm_eps"]
    dev = w["embeddings.word_embeddings.weight"].device
    tok = torch.as_tensor(list(ids), dtype=torch.long, device=dev)
    t = len(tok)
    pos = torch.arange(t, device=dev) + model["pad_token_id"] + 1
    x = (w["embeddings.word_embeddings.weight"][tok] + w["embeddings.position_embeddings.weight"][pos]
         + w["embeddings.token_type_embeddings.weight"][0])
    x = F.layer_norm(x, (h,), w["embeddings.LayerNorm.weight"], w["embeddings.LayerNorm.bias"], eps)

    def lin(name, y):
        return y @ w[name + ".weight"].T + w[name + ".bias"]

    for i in range(model["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        q, k, v = (lin(p + "attention.self." + n, x).reshape(t, heads, dh).transpose(0, 1)
                   for n in ("query", "key", "value"))
        a = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(dh), dim=-1) @ v
        a = a.transpose(0, 1).reshape(t, h)
        x = F.layer_norm(x + lin(p + "attention.output.dense", a), (h,),
                         w[p + "attention.output.LayerNorm.weight"], w[p + "attention.output.LayerNorm.bias"], eps)
        y = F.gelu(lin(p + "intermediate.dense", x), approximate="none")
        x = F.layer_norm(x + lin(p + "output.dense", y), (h,),
                         w[p + "output.LayerNorm.weight"], w[p + "output.LayerNorm.bias"], eps)
    cls = x[0]
    return cls / cls.norm().clamp_min(1e-12)
