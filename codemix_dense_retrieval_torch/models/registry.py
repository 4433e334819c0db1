"""Encoder registry: one entry point for every encoder family.

``load_encoder(name, checkpoint_dir)`` dispatches on the encoder family
(name substring, the dialects' detection) and the checkpoint's
``config.json`` ``model_type``, as the JAX package's registry does:

- XLM-R family (``xlm-roberta``): BGE-M3, multilingual-E5, LaBSE-class;
- Qwen3-Embedding (``qwen3``): decoder, last-token pooling;
- GTE-multilingual (``new``): RoPE post-LN encoder;
- DeepSeek-V3 blocks (``deepseek_v3``: Moonlight-16B-A3B, DeepSeek-V3,
  Kimi-K2): latent attention and sigmoid-routed experts, last-token pooling;
- Kimi Linear (``kimi_linear``: Kimi-Linear-48B-A3B): Kimi Delta Attention
  beside NoPE latent attention, sigmoid-routed experts (a share of them
  where config.json's ``expert_shard`` says so), last-token pooling;
- jina-embeddings-v3: XLM-R with task-LoRA adapters.

Without a checkpoint it builds a tiny random-init model of the family
(smoke mode); with one, an HF-format directory (``config.json`` + weights)
or a pre-converted one (``params.npz`` + ``encoder_config.json``, written by
``convert``; the JAX package converts the XLM-R family only, the port any
family, with ``model_type`` in ``encoder_config.json`` for the families
other than XLM-R).
``weight_quant`` quantizes the encoder's Linear weights in every family.
"""

from __future__ import annotations

import json
import pathlib
from typing import Optional

import torch

from codemix_dense_retrieval_torch.models import dialects
from codemix_dense_retrieval_torch.models.encoder import TextEncoder, encoder_device
from codemix_dense_retrieval_torch.models.tokenizer import load_tokenizer
from codemix_dense_retrieval_torch.models.xlmr import XLMRConfig
from codemix_dense_retrieval_torch.utils.devices import DeviceLike, default_dtype


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
    """Build a TextEncoder for any supported family.

    The compute dtype defaults to bf16 on the card and f32 on the CPU; the
    flash kernel is used on the card. Without ``checkpoint_dir``: a tiny
    random-init model of the family. ``mesh`` (a
    :class:`~codemix_dense_retrieval_torch.parallel.mesh.Mesh`) makes the
    encode data-parallel over its ``shard`` axis, on its devices."""
    dev = encoder_device(device, mesh)
    family = dialects.detect_encoder_family(name)
    if dtype is None:
        dtype = default_dtype(dev)
    if use_flash is None:
        use_flash = dev.type == "cuda"
    kw = dict(seed=seed, mesh=mesh, weight_quant=weight_quant, device=dev)
    if checkpoint_dir is None:
        return _random_init(name, family, dtype, use_flash, **kw)

    d = pathlib.Path(checkpoint_dir)
    if (d / "params.npz").exists():
        # pre-converted (`convert`): the config file names the family
        return TextEncoder.from_checkpoint(name, d, dtype=dtype, use_flash=use_flash, **kw)
    cfg, params, module_cls = load_hf_family(name, d, dtype=dtype, use_flash=use_flash)
    return _build(name, cfg, params, module_cls, d, **kw)


def load_hf_family(name: str, checkpoint_dir, *, dtype: torch.dtype = torch.float32,
                   use_flash: Optional[bool] = None):
    """(config, f32 state dict, module class) of an HF-format directory,
    by the family dispatch of :func:`load_encoder`. ``use_flash`` None keeps
    each config's default."""
    d = pathlib.Path(checkpoint_dir)
    family = dialects.detect_encoder_family(name)
    flash = {} if use_flash is None else {"use_flash": use_flash}
    hf_cfg = json.loads((d / "config.json").read_text())
    model_type = hf_cfg.get("model_type", "xlm-roberta")
    from codemix_dense_retrieval_torch.models.convert import load_state_dict

    sd = load_state_dict(d)

    if model_type == "qwen3" or family == "qwen3":
        from codemix_dense_retrieval_torch.models.qwen3 import (
            Qwen3Config,
            Qwen3Encoder,
            convert_qwen3_state_dict,
        )

        cfg = Qwen3Config.from_hf_config(hf_cfg, dtype=dtype, **flash)
        params = convert_qwen3_state_dict(sd, cfg, prefix=_detect_prefix(sd, "embed_tokens.weight"))
        return cfg, params, Qwen3Encoder

    if model_type == "deepseek_v3" or family == "deepseek-v3":
        from codemix_dense_retrieval_torch.models.deepseek_v3 import (
            DeepseekV3Config,
            DeepseekV3Encoder,
            convert_deepseek_v3_state_dict,
        )

        cfg = DeepseekV3Config.from_hf_config(hf_cfg, dtype=dtype)
        params = convert_deepseek_v3_state_dict(sd, cfg, prefix=_detect_prefix(sd, "embed_tokens.weight"))
        return cfg, params, DeepseekV3Encoder

    if model_type == "kimi_linear" or family == "kimi-linear":
        from codemix_dense_retrieval_torch.models.kimi_linear import (
            KimiLinearConfig,
            KimiLinearEncoder,
            convert_kimi_linear_state_dict,
        )

        cfg = KimiLinearConfig.from_hf_config(hf_cfg, dtype=dtype)
        params = convert_kimi_linear_state_dict(sd, cfg, prefix=_detect_prefix(sd, "embed_tokens.weight"))
        return cfg, params, KimiLinearEncoder

    if model_type == "new" or family == "gte":
        from codemix_dense_retrieval_torch.models.gte import (
            GTEConfig,
            GTEEncoder,
            convert_gte_state_dict,
        )

        cfg = GTEConfig.from_hf_config(hf_cfg, dtype=dtype)
        prefix = _detect_prefix(sd, "embeddings.word_embeddings.weight")
        return cfg, convert_gte_state_dict(sd, cfg, prefix=prefix), GTEEncoder

    # XLM-R family (jina-v3's task LoRA included)
    from codemix_dense_retrieval_torch.models.convert import convert_xlmr_state_dict, detect_prefix
    from codemix_dense_retrieval_torch.models.xlmr import XLMREncoder

    extra = {}
    if family == "jina-v3":
        extra = dict(lora_rank=hf_cfg.get("lora_rank", 4), lora_tasks=5)
    cfg = XLMRConfig.from_hf_config(
        hf_cfg, pooling=dialects.default_pooling(name), dtype=dtype, **flash, **extra
    )
    return cfg, convert_xlmr_state_dict(sd, cfg, prefix=detect_prefix(sd)), XLMREncoder


def _build(name, cfg, params, module_cls, d: pathlib.Path, **kw) -> TextEncoder:
    """TextEncoder of ``module_cls(cfg)`` (built on the meta device, so its
    storage is allocated once, on the target) with the checkpoint's
    tokenizer."""
    with torch.device("meta"):
        model = module_cls(cfg)
    tok = load_tokenizer(d, cfg.max_position_embeddings - 2, vocab_size=cfg.vocab_size)
    return TextEncoder(name, cfg, params, tok, model=model, **kw)


def _detect_prefix(sd, marker: str) -> str:
    for key in sd:
        if key.endswith(marker):
            return key[: -len(marker)]
    raise KeyError(f"no {marker} in state dict")


def _random_init(name, family, dtype, use_flash, **kw) -> TextEncoder:
    """Smoke-mode random-init encoder of the family's shape (tiny). The tiny
    Qwen3 and GTE models attend plainly, as in the JAX package (Qwen3's
    tiny head dim is 16, which kernel B does not take); DeepSeek-V3's
    latent attention always does."""
    if family == "qwen3":
        from codemix_dense_retrieval_torch.models.qwen3 import Qwen3Config, Qwen3Encoder

        cfg = Qwen3Config.tiny(vocab_size=30_000, dtype=dtype)
        with torch.device("meta"):
            model = Qwen3Encoder(cfg)
        return TextEncoder(name, cfg, model=model, **kw)
    if family == "deepseek-v3":
        from codemix_dense_retrieval_torch.models.deepseek_v3 import DeepseekV3Config, DeepseekV3Encoder

        cfg = DeepseekV3Config.tiny(vocab_size=30_000, dtype=dtype)
        with torch.device("meta"):
            model = DeepseekV3Encoder(cfg)
        return TextEncoder(name, cfg, model=model, **kw)
    if family == "kimi-linear":
        from codemix_dense_retrieval_torch.models.kimi_linear import KimiLinearConfig, KimiLinearEncoder

        cfg = KimiLinearConfig.tiny(vocab_size=30_000, dtype=dtype)
        with torch.device("meta"):
            model = KimiLinearEncoder(cfg)
        return TextEncoder(name, cfg, model=model, **kw)
    if family == "gte":
        from codemix_dense_retrieval_torch.models.gte import GTEConfig, GTEEncoder

        cfg = GTEConfig.tiny(vocab_size=30_000, dtype=dtype)
        with torch.device("meta"):
            model = GTEEncoder(cfg)
        return TextEncoder(name, cfg, model=model, **kw)
    extra = dict(lora_rank=4, lora_tasks=5) if family == "jina-v3" else {}
    cfg = XLMRConfig.tiny(
        vocab_size=30_000, hidden_size=64, num_heads=4, intermediate_size=256,
        pooling=dialects.default_pooling(name), dtype=dtype, use_flash=use_flash, **extra,
    )
    return TextEncoder(name, cfg, **kw)
