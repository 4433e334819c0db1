"""Weight carry for every encoder family (XLM-R with or without jina-v3's
task LoRA, Qwen3, GTE).

- :func:`params_from_flax` maps the JAX package's Flax parameter tree
  (numpy leaves) onto the port module's state dict, leaf by leaf: a Dense
  ``kernel`` (in, out) becomes ``Linear.weight`` (out, in), a LayerNorm
  ``scale`` and an Embed ``embedding`` become ``weight``, ``layer_<i>``
  becomes ``layers.<i>``; biases, RMSNorm weights and LoRA factors keep
  their names and layouts. A quantized kernel
  (:class:`~codemix_dense_retrieval_torch.ops.weight_quant.QuantizedTensor`,
  ``(in, out)``) is carried across as it is, under ``weight``.
  :func:`flax_from_state_dict` is the inverse, for writing the
  ``params.npz`` checkpoint format.
- :func:`convert_xlmr_state_dict` maps an HF ``XLMRobertaModel`` state dict
  (jina-v3's parametrized LoRA adapters included) straight into the module;
  the Qwen3 and GTE converters live beside their modules.
- :func:`load_state_dict` reads local safetensors / torch checkpoints;
  :func:`load_params_npz` / :func:`save_params_npz` the flat ``params.npz``
  (names ``params/layer_0/q/kernel``, ...; a quantized kernel as
  ``<name>@wq.<kind>.{codes,scale,shape}``, as the JAX package writes it)
  next to ``encoder_config.json``.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from codemix_dense_retrieval_torch.models.xlmr import XLMRConfig
from codemix_dense_retrieval_torch.ops.weight_quant import QuantizedTensor

_NORMS = ("attn_ln", "ffn_ln")
_EMBEDS = ("word_embeddings", "position_embeddings", "token_type_embeddings")
# the modules whose 2-D ``weight`` is an Embed table or a LayerNorm scale in
# the Flax tree (any other 2-D weight is a Dense kernel, a 1-D one an RMSNorm
# weight)
_FLAX_EMBEDS = {*_EMBEDS, "embed_tokens"}
_FLAX_LAYER_NORMS = {"LayerNorm", *_NORMS, "emb_ln", "mlp_ln"}

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


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax encoder params of any family (``{"params": {...}}`` or the inner
    dict, numpy or array leaves) -> the port module's state dict (f32)."""
    p = tree["params"] if "params" in tree else tree
    sd: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: str) -> None:
        for key, val in node.items():
            if isinstance(val, Mapping):
                name = f"layers.{key[len('layer_'):]}" if key.startswith("layer_") else key
                walk(val, f"{path}{name}.")
            elif key == "kernel":
                sd[f"{path}weight"] = val if isinstance(val, QuantizedTensor) else _t(val).T.contiguous()
            elif key in ("embedding", "scale"):
                sd[f"{path}weight"] = _t(val)
            else:  # bias, an RMSNorm weight, LoRA factors
                sd[f"{path}{key}"] = _t(val)

    walk(p, "")
    return sd


def flax_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict:
    """Inverse of :func:`params_from_flax`: state dict -> ``{"params": tree}``
    with float32 numpy leaves (quantized kernels as they are)."""
    params: Dict = {}
    for name, t in sd.items():
        parts = name.split(".")
        path, leaf = [], parts[-1]
        i = 0
        while i < len(parts) - 1:
            if parts[i] == "layers":
                path.append(f"layer_{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        if isinstance(t, QuantizedTensor):
            leaf, arr = "kernel", t
        else:
            arr = t.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            if path[-1] in _FLAX_EMBEDS:
                leaf = "embedding"
            elif path[-1] in _FLAX_LAYER_NORMS:
                leaf = "scale"
            elif arr.ndim == 2:
                leaf, arr = "kernel", np.ascontiguousarray(arr.T)
        node = params
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = arr
    return {"params": params}


def convert_xlmr_state_dict(
    state_dict: Mapping[str, object],
    cfg: XLMRConfig,
    prefix: str = "",
) -> Dict[str, torch.Tensor]:
    """Map an HF ``XLMRobertaModel`` state dict onto this package's
    XLMREncoder state dict. ``prefix`` strips a leading module path (e.g.
    ``"roberta."`` or ``"0.auto_model."``). Both sides use torch's (out, in)
    Linear layout, so base weights are not transposed. With ``cfg.lora_rank``
    each projection nests under ``base`` and its jina-v3 adapters
    (``parametrizations.weight.0.lora_A`` (tasks, r, in) and ``lora_B``
    (tasks, out, r)) become ``lora_a`` (tasks, in, r) and ``lora_b`` (tasks,
    r, out), zeros where the checkpoint has none."""
    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    lora = bool(cfg.lora_rank)

    def dense(out, name, hf_name):
        key = f"{hf_name}.weight"
        if key not in sd:
            # torch parametrization moves the frozen weight (jina-v3)
            key = f"{hf_name}.parametrizations.weight.original"
        w = _t(sd[key])
        if not lora:
            out[f"{name}.weight"] = w
            out[f"{name}.bias"] = _t(sd[f"{hf_name}.bias"])
            return
        out[f"{name}.base.weight"] = w
        out[f"{name}.base.bias"] = _t(sd[f"{hf_name}.bias"])
        if not cfg.lora_tasks:
            return
        la = f"{hf_name}.parametrizations.weight.0.lora_A"
        lb = f"{hf_name}.parametrizations.weight.0.lora_B"
        if la in sd and lb in sd:
            out[f"{name}.lora_a"] = _t(sd[la]).permute(0, 2, 1).contiguous()
            out[f"{name}.lora_b"] = _t(sd[lb]).permute(0, 2, 1).contiguous()
        else:
            out[f"{name}.lora_a"] = torch.zeros(cfg.lora_tasks, w.shape[1], cfg.lora_rank)
            out[f"{name}.lora_b"] = torch.zeros(cfg.lora_tasks, cfg.lora_rank, w.shape[0])

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
                out[f"layers.{i}.{name}.bias"] = _t(sd[f"{hf_name}.bias"])
            else:
                dense(out, f"layers.{i}.{name}", hf_name)
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


def flatten_params(tree: Dict) -> Dict[str, np.ndarray]:
    """A Flax-layout tree as flat ``params.npz`` entries: one per leaf named
    by its path, in the JAX package's (sorted) order; a quantized kernel as
    three entries, ``<name>@wq.<kind>.codes``, ``.scale`` and ``.shape``
    (int64)."""
    arrays: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for key in sorted(node):
            val = node[key]
            name = f"{prefix}/{key}" if prefix else key
            if isinstance(val, dict):
                walk(val, name)
            elif isinstance(val, QuantizedTensor):
                arrays[f"{name}@wq.{val.kind}.codes"] = np.asarray(val.codes)
                arrays[f"{name}@wq.{val.kind}.scale"] = np.asarray(val.scale)
                arrays[f"{name}@wq.{val.kind}.shape"] = np.asarray(val.shape, np.int64)
            else:
                arrays[name] = np.asarray(val)

    walk(tree, "")
    return arrays


def unflatten_params(arrays: Mapping[str, np.ndarray]) -> Dict:
    """Inverse of :func:`flatten_params`: a nested tree of the arrays,
    ``@wq.`` entries as :class:`QuantizedTensor` leaves."""
    params: Dict = {}
    pending: Dict[str, dict] = {}

    def put(name, val):
        parts = name.split("/")
        node = params
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val

    for name, val in arrays.items():
        if "@wq." in name:
            base, tag = name.split("@wq.", 1)
            kind, part = tag.split(".", 1)
            pending.setdefault(base, {"kind": kind})[part] = val
        else:
            put(name, val)
    for base, rec in pending.items():
        put(base, QuantizedTensor(rec["kind"], rec["codes"], rec["scale"],
                                  tuple(int(x) for x in rec["shape"])))
    return params


def save_params_npz(path, tree: Dict) -> None:
    """Flat ``.npz`` checkpoint of a Flax-layout tree (see
    :func:`flax_from_state_dict` and :func:`flatten_params`)."""
    np.savez(path, **flatten_params(tree))


def load_params_npz(path) -> Dict:
    """Read a flat ``params.npz`` back into a nested tree of numpy leaves
    (:func:`unflatten_params`)."""
    with np.load(path) as data:
        return unflatten_params({name: data[name] for name in data.files})
