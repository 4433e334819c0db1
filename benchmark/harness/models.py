"""A configuration's encoder: the port's ``TextEncoder`` over seeded weights,
and the reference's float32 copy of the same weights and tokenizer."""

from __future__ import annotations

from typing import Dict

import torch

from harness import text, weights

SERVED = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def served_dtype(ctx) -> torch.dtype:
    return SERVED[ctx.config["served_dtype"]]


def port_encoder(ctx):
    """The port's encoder (int8 weight quantization in the control), and the
    reference's tokenizer of the same configuration."""
    cfg, model = ctx.config, ctx.config["model"]
    fam = ctx.family()
    w = weights.make(fam.shapes(model), ctx.seed, ctx.device, served_dtype(ctx), cfg["init_std"])
    tok = text.port_tokenizer(cfg["tokenizer"], model["vocab_size"], model["max_position_embeddings"] - 2,
                              ctx.tmp / "tokenizer")
    enc = fam.port_encoder(cfg, w, tok, ctx.device, served_dtype(ctx),
                           weight_quant="int8" if ctx.variant == "control" else None)
    return enc, text.reference_tokenizer(cfg["tokenizer"], model["vocab_size"])


def reference_weights(ctx) -> Dict[str, torch.Tensor]:
    """The same seeded weights, made again, as float32 on the device."""
    w = weights.make(ctx.family().shapes(ctx.config["model"]), ctx.seed, ctx.device, served_dtype(ctx),
                     ctx.config["init_std"])
    return {k: v.to(torch.float32) for k, v in w.items()}


def reference_embed(ctx, texts, ref_tok) -> torch.Tensor:
    """(n, d) float32 reference embeddings of ``texts`` (one at a time)."""
    from reference import true_f32

    fam, model = ctx.family(), ctx.config["model"]
    w = reference_weights(ctx)
    with torch.no_grad(), true_f32():
        return torch.stack([fam.reference.embed(w, model, ref_tok(s)) for s in texts])
