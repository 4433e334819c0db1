"""Weight carry for the XLM-R encoder family.

- :func:`params_from_flax` maps the JAX package's Flax parameter tree
  (numpy leaves) onto :class:`~codemix_dense_retrieval_torch.models.xlmr.XLMREncoder`'s
  state dict: a Dense ``kernel`` (in, out) becomes ``Linear.weight``
  (out, in), a LayerNorm ``scale`` becomes ``weight``, an Embed
  ``embedding`` becomes ``weight``. :func:`flax_from_state_dict` is the
  inverse, for writing the ``params.npz`` checkpoint format.
- :func:`convert_xlmr_state_dict` maps an HF ``XLMRobertaModel`` state dict
  straight into the module.
- :func:`load_state_dict` reads local safetensors / torch checkpoints;
  :func:`load_params_npz` / :func:`save_params_npz` the flat ``params.npz``
  (names ``params/layer_0/q/kernel``, ...) next to ``encoder_config.json``.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from codemix_dense_retrieval_torch.models.xlmr import XLMRConfig

_DENSE = ("q", "k", "v", "attn_out", "ffn_in", "ffn_out")
_NORMS = ("attn_ln", "ffn_ln")
_EMBEDS = ("word_embeddings", "position_embeddings", "token_type_embeddings")

# HF XLMRobertaModel module path of each port layer module
_HF_LAYER = {
    "q": "attention.self.query",
    "k": "attention.self.key",
    "v": "attention.self.value",
    "attn_out": "attention.output.dense",
    "attn_ln": "attention.output.LayerNorm",
    "ffn_in": "intermediate.dense",
    "ffn_out": "output.dense",
    "ffn_ln": "output.LayerNorm",
}


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.require(np.asarray(x), np.float32, ["W"]))


def _num_layers(names) -> int:
    return len({n.split(".")[1] for n in names if n.startswith("layers.")})


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax XLMREncoder params (``{"params": {...}}`` or the inner dict,
    numpy or array leaves) -> this package's XLMREncoder state dict (f32)."""
    p = tree["params"] if "params" in tree else tree
    emb = p["embeddings"]
    sd: Dict[str, torch.Tensor] = {}
    for name in _EMBEDS:
        sd[f"embeddings.{name}.weight"] = _t(emb[name]["embedding"])
    sd["embeddings.LayerNorm.weight"] = _t(emb["LayerNorm"]["scale"])
    sd["embeddings.LayerNorm.bias"] = _t(emb["LayerNorm"]["bias"])
    i = 0
    while f"layer_{i}" in p:
        layer = p[f"layer_{i}"]
        if "kernel" not in layer["q"]:
            raise NotImplementedError("LoRA-nested (jina-v3) parameter trees are not ported yet")
        for name in _DENSE:
            sd[f"layers.{i}.{name}.weight"] = _t(layer[name]["kernel"]).T.contiguous()
            sd[f"layers.{i}.{name}.bias"] = _t(layer[name]["bias"])
        for name in _NORMS:
            sd[f"layers.{i}.{name}.weight"] = _t(layer[name]["scale"])
            sd[f"layers.{i}.{name}.bias"] = _t(layer[name]["bias"])
        i += 1
    return sd


def flax_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict:
    """Inverse of :func:`params_from_flax`: state dict -> ``{"params": tree}``
    with float32 numpy leaves."""
    def np32(t):
        return t.detach().to("cpu", torch.float32).numpy()

    emb = {name: {"embedding": np32(sd[f"embeddings.{name}.weight"])} for name in _EMBEDS}
    emb["LayerNorm"] = {
        "scale": np32(sd["embeddings.LayerNorm.weight"]),
        "bias": np32(sd["embeddings.LayerNorm.bias"]),
    }
    params: Dict = {"embeddings": emb}
    for i in range(_num_layers(sd)):
        layer: Dict = {}
        for name in _DENSE:
            layer[name] = {
                "kernel": np.ascontiguousarray(np32(sd[f"layers.{i}.{name}.weight"]).T),
                "bias": np32(sd[f"layers.{i}.{name}.bias"]),
            }
        for name in _NORMS:
            layer[name] = {
                "scale": np32(sd[f"layers.{i}.{name}.weight"]),
                "bias": np32(sd[f"layers.{i}.{name}.bias"]),
            }
        params[f"layer_{i}"] = layer
    return {"params": params}


def convert_xlmr_state_dict(
    state_dict: Mapping[str, object],
    cfg: XLMRConfig,
    prefix: str = "",
) -> Dict[str, torch.Tensor]:
    """Map an HF ``XLMRobertaModel`` state dict onto this package's
    XLMREncoder state dict. ``prefix`` strips a leading module path (e.g.
    ``"roberta."`` or ``"0.auto_model."``). Both sides use torch's (out, in)
    Linear layout, so nothing is transposed."""
    if cfg.lora_rank:
        raise NotImplementedError("task-LoRA checkpoints are not ported yet")
    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}

    def dense_weight(hf_name):
        key = f"{hf_name}.weight"
        if key not in sd:
            key = f"{hf_name}.parametrizations.weight.original"
        return _t(sd[key])

    out: Dict[str, torch.Tensor] = {}
    for name in _EMBEDS:
        out[f"embeddings.{name}.weight"] = _t(sd[f"embeddings.{name}.weight"])
    out["embeddings.LayerNorm.weight"] = _t(sd["embeddings.LayerNorm.weight"])
    out["embeddings.LayerNorm.bias"] = _t(sd["embeddings.LayerNorm.bias"])
    for i in range(cfg.num_layers):
        for name, hf in _HF_LAYER.items():
            hf_name = f"encoder.layer.{i}.{hf}"
            if name in _NORMS:
                out[f"layers.{i}.{name}.weight"] = _t(sd[f"{hf_name}.weight"])
            else:
                out[f"layers.{i}.{name}.weight"] = dense_weight(hf_name)
            out[f"layers.{i}.{name}.bias"] = _t(sd[f"{hf_name}.bias"])
    return out


def detect_prefix(state_dict: Mapping[str, object]) -> str:
    """Find the XLMRobertaModel submodule prefix inside a checkpoint."""
    marker = "embeddings.word_embeddings.weight"
    for key in state_dict:
        if key.endswith(marker):
            return key[: -len(marker)]
    raise KeyError("no XLM-R embeddings found in state dict")


def _read_safetensors(path) -> Dict[str, torch.Tensor]:
    from safetensors.torch import load_file

    return load_file(str(path), device="cpu")


def load_state_dict(checkpoint_dir) -> Dict[str, torch.Tensor]:
    """Load an HF-format state dict from a local directory: sharded or single
    ``model.safetensors``, or sharded or single ``pytorch_model.bin``."""
    d = pathlib.Path(checkpoint_dir)
    st_index = d / "model.safetensors.index.json"
    if st_index.exists():
        weight_map = json.loads(st_index.read_text())["weight_map"]
        sd: Dict[str, torch.Tensor] = {}
        for shard_name in sorted(set(weight_map.values())):
            shard = _read_safetensors(d / shard_name)
            missing = [k for k, v in weight_map.items() if v == shard_name and k not in shard]
            if missing:
                raise KeyError(
                    f"weight_map names {missing[:3]}... in {shard_name} "
                    "but the shard does not contain them"
                )
            sd.update(shard)
        absent = set(weight_map) - set(sd)
        if absent:
            raise KeyError(f"index lists missing weights: {sorted(absent)[:3]}")
        return sd
    if (d / "model.safetensors").exists():
        return _read_safetensors(d / "model.safetensors")
    bin_index = d / "pytorch_model.bin.index.json"
    if bin_index.exists():
        weight_map = json.loads(bin_index.read_text())["weight_map"]
        sd = {}
        for shard_name in sorted(set(weight_map.values())):
            sd.update(torch.load(d / shard_name, map_location="cpu", weights_only=True))
        return sd
    if (d / "pytorch_model.bin").exists():
        return torch.load(d / "pytorch_model.bin", map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no model weights under {d}")


def load_hf_checkpoint(checkpoint_dir, cfg: Optional[XLMRConfig] = None, **cfg_overrides):
    """(config, state dict) from an HF-format local directory (config.json +
    weights)."""
    d = pathlib.Path(checkpoint_dir)
    if cfg is None:
        hf_cfg = json.loads((d / "config.json").read_text())
        cfg = XLMRConfig.from_hf_config(hf_cfg, **cfg_overrides)
    sd = load_state_dict(d)
    return cfg, convert_xlmr_state_dict(sd, cfg, prefix=detect_prefix(sd))


def save_params_npz(path, tree: Dict) -> None:
    """Flat ``.npz`` checkpoint of a Flax-layout tree (see
    :func:`flax_from_state_dict`): one entry per leaf named by its path."""
    arrays: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for key, val in node.items():
            name = f"{prefix}/{key}" if prefix else key
            if isinstance(val, dict):
                walk(val, name)
            else:
                arrays[name] = np.asarray(val)

    walk(tree, "")
    np.savez(path, **arrays)


def load_params_npz(path) -> Dict:
    """Read a flat ``params.npz`` back into a nested tree of numpy leaves.
    Weight-quantized entries (``@wq.`` names) are not ported yet."""
    params: Dict = {}
    with np.load(path) as data:
        for name in data.files:
            if "@wq." in name:
                raise NotImplementedError(
                    f"{path}: weight-quantized checkpoints are not ported yet "
                    "(ROADMAP queue 1, quantization)"
                )
            parts = name.split("/")
            node = params
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[name]
    return params
