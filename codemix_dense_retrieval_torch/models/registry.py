"""Encoder registry: ``load_encoder(name, checkpoint_dir)`` builds a
TextEncoder for the XLM-R family (BGE-M3, multilingual-E5, LaBSE-class)
from a converted (``params.npz``) or HF-format checkpoint directory, or a
tiny random-init model without one (smoke mode)."""

from __future__ import annotations

import json
import pathlib
from typing import Optional

import torch

from codemix_dense_retrieval_torch.models import dialects
from codemix_dense_retrieval_torch.models.encoder import TextEncoder
from codemix_dense_retrieval_torch.models.xlmr import XLMRConfig
from codemix_dense_retrieval_torch.utils.devices import DeviceLike, default_dtype, resolve_device

_OTHER_FAMILIES = ("qwen3", "gte", "jina-v3")


def _reject_other_family(name: str, model_type: str = "xlm-roberta") -> None:
    family = dialects.detect_encoder_family(name)
    if family in _OTHER_FAMILIES or model_type in ("qwen3", "new"):
        raise NotImplementedError(
            f"encoder family {family!r} (model_type {model_type!r}) is not ported yet: "
            "Qwen3, GTE and jina-v3 are ROADMAP queue 1, other encoder families"
        )


def load_encoder(
    name: str,
    checkpoint_dir: Optional[str] = None,
    *,
    dtype: Optional[torch.dtype] = None,
    use_flash: Optional[bool] = None,
    seed: int = 0,
    mesh=None,
    weight_quant: Optional[str] = None,
    device: DeviceLike = None,
) -> TextEncoder:
    """Build a TextEncoder for an XLM-R-family encoder.

    The compute dtype defaults to bf16 on the card and f32 on the CPU; the
    flash kernel is used on the card. Without ``checkpoint_dir``: a tiny
    random-init model of the family's pooling."""
    dev = resolve_device(device)
    if dtype is None:
        dtype = default_dtype(dev)
    if use_flash is None:
        use_flash = dev.type == "cuda"
    if checkpoint_dir is None:
        _reject_other_family(name)
        return _random_init(name, dtype, use_flash, seed, dev, mesh, weight_quant)
    d = pathlib.Path(checkpoint_dir)
    model_type = "xlm-roberta"
    if not (d / "params.npz").exists():
        model_type = json.loads((d / "config.json").read_text()).get("model_type", model_type)
    _reject_other_family(name, model_type)
    return TextEncoder.from_checkpoint(
        name, d, dtype=dtype, use_flash=use_flash, seed=seed, mesh=mesh,
        weight_quant=weight_quant, device=dev,
    )


def _random_init(name, dtype, use_flash, seed, device, mesh=None, weight_quant=None) -> TextEncoder:
    """Smoke-mode random-init encoder of the family's pooling (tiny)."""
    cfg = XLMRConfig.tiny(
        vocab_size=30_000, hidden_size=64, num_heads=4, intermediate_size=256,
        pooling=dialects.default_pooling(name), dtype=dtype, use_flash=use_flash,
    )
    return TextEncoder(name, cfg, seed=seed, mesh=mesh, weight_quant=weight_quant, device=device)
