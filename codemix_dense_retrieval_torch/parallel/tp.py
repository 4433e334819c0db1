"""Tensor-parallel encoders over the mesh's ``tp`` axis.

Replaces HF accelerate's ``device_map="auto"`` layer placement (used for
Qwen3-4B/8B) with Megatron-style 1-D tensor parallelism: the Q/K/V and
gate/up projections are column-parallel, the attention output and down
projections row-parallel. The JAX package places parameters with
``NamedSharding`` and lets GSPMD insert the all-reduces; the port builds the
partitioned modules itself. Each coupled set (a layer's attention, or its
MLP) becomes a :class:`TensorParallel` block: part t holds the columns and
rows of tp device t and runs there (its attention on its ``h / T`` query and
``kvh / T`` KV heads, through kernel B on the card), and the parts' partial
outputs are summed on the first tp device, where the row-parallel bias is
added once. The partials are kept in f32 (:class:`RowParallelLinear`) and
the sum is rounded to the model's dtype once, as the replicated layer's
f32-accumulated GEMM rounds its output once: bf16 partials would add a
rounding per part to every layer. Everything else (embeddings, norms,
pooling) runs on that device.

Which leaves split follows the JAX package's rule tables, matched against
the JAX parameter path of each module (:func:`jax_path`). GSPMD can split a
head or replicate one indivisible leaf of a set; the port's parts need whole
heads and whole GQA groups, so a set replicates (runs whole on the first tp
device) when any of its leaves does not split evenly, when a head count does
not divide by T, or when a leaf is NF4 (whose packed blocks do not follow
the kernel's axes). The numbers are the same either way; only the memory
saving is lost. int8 kernels split their codes with the kernel's spec and
their per-output-channel scales with its out axis.
"""

from __future__ import annotations

import copy
import dataclasses
import re
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from codemix_dense_retrieval_torch.ops.flash_attention import multi_head_attention
from codemix_dense_retrieval_torch.ops.weight_quant import QuantizedTensor, QuantLinear
from codemix_dense_retrieval_torch.parallel.mesh import Mesh, reduce_sum_to

#: a leaf's placement on its (in, out) kernel axes, as the JAX package's
#: ``PartitionSpec``: column parallel, row parallel, replicated
COLUMN: Tuple = (None, "tp")
ROW: Tuple = ("tp", None)
REPLICATED: Tuple = ()

# (JAX parameter path regex, spec): first match wins
_QWEN3_RULES: Tuple[Tuple[str, Tuple], ...] = (
    (r"self_attn/(q_proj|k_proj|v_proj)/kernel", COLUMN),
    (r"self_attn/o_proj/kernel", ROW),
    (r"mlp/(gate_proj|up_proj)/kernel", COLUMN),
    (r"mlp/down_proj/kernel", ROW),
    (r"embed_tokens/embedding", (None, None)),
    (r".*", REPLICATED),  # norms etc.
)

_XLMR_RULES: Tuple[Tuple[str, Tuple], ...] = (
    (r"layer_\d+/(q|k|v)/kernel", COLUMN),
    (r"layer_\d+/(q|k|v)/bias", ("tp",)),
    (r"layer_\d+/attn_out/kernel", ROW),
    (r"layer_\d+/ffn_in/kernel", COLUMN),
    (r"layer_\d+/ffn_in/bias", ("tp",)),
    (r"layer_\d+/ffn_out/kernel", ROW),
    (r".*", REPLICATED),
)

RULE_SETS = {"qwen3": _QWEN3_RULES, "xlmr": _XLMR_RULES}


def tp_spec_for_path(path: str, family: str) -> Tuple:
    """The spec of the JAX parameter ``path`` (``layer_0/self_attn/q_proj/kernel``)."""
    for pattern, spec in RULE_SETS[family]:
        if re.search(pattern, path):
            return spec
    return REPLICATED


def jax_path(module_name: str) -> str:
    """The JAX parameter path of a port Linear module's kernel:
    ``layers.3.self_attn.q_proj`` -> ``layer_3/self_attn/q_proj/kernel``."""
    return re.sub(r"(^|\.)layers\.(\d+)", r"\1layer_\2", module_name).replace(".", "/") + "/kernel"


class TensorParallel(nn.Module):
    """A column -> row parallel pair over ``devices``: ``parts[t]`` (on
    ``devices[t]``) maps the full input to its partial output; the partials
    are summed on ``devices[0]`` in part order and ``bias`` (the
    row-parallel layer's) is added once. Every part is launched before any
    partial is read."""

    def __init__(self, parts: Sequence[nn.Module], devices: Sequence[torch.device],
                 bias: Optional[torch.Tensor] = None) -> None:
        super().__init__()
        self.parts = nn.ModuleList(parts)
        self.devices = list(devices)
        self.bias = None if bias is None else nn.Parameter(bias.detach().to(self.devices[0]),
                                                           requires_grad=False)

    def forward(self, x: torch.Tensor, *args, **kw) -> torch.Tensor:
        def move(a, dev):
            return a.to(dev, non_blocking=True) if isinstance(a, torch.Tensor) else a

        outs = [
            part(move(x, dev), *(move(a, dev) for a in args), **{k: move(v, dev) for k, v in kw.items()})
            for part, dev in zip(self.parts, self.devices)
        ]
        y = reduce_sum_to(outs, self.devices[0])
        return (y if self.bias is None else y + self.bias).to(x.dtype)


class RowParallelLinear(nn.Module):
    """A row-parallel part (``layer``: a Linear or int8 QuantLinear over
    this device's input rows, without bias) whose partial output is f32:
    on the card a half-precision GEMM with f32 output (``torch.mm`` with
    ``out_dtype``), elsewhere the layer's own f32 product."""

    def __init__(self, layer: nn.Module) -> None:
        super().__init__()
        self.layer = layer

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cuda" or x.dtype == torch.float32:
            return self.layer(x).float()
        w = self.layer.weight
        w = w.dequantize(x.dtype) if isinstance(w, QuantizedTensor) else w.T  # (in, out)
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], out.shape[-1])


def _is_nf4(layer: nn.Module) -> bool:
    return isinstance(layer, QuantLinear) and layer.kind != "int8"


def _split(layer: nn.Module, spec: Tuple, lo: int, hi: int, device: torch.device) -> nn.Module:
    """The part of a Linear / int8 QuantLinear (``(in, out)`` kernel) that
    ``spec`` gives one tp device: out columns ``[lo, hi)`` with their bias
    (COLUMN), or in rows ``[lo, hi)`` without the bias, as a
    :class:`RowParallelLinear` (ROW: the bias is added once after the
    sum)."""
    if spec == ROW:
        return RowParallelLinear(_slice(layer, spec, lo, hi, device))
    return _slice(layer, spec, lo, hi, device)


def _slice(layer: nn.Module, spec: Tuple, lo: int, hi: int, device: torch.device) -> nn.Module:
    col = spec == COLUMN
    bias = None
    if col and layer.bias is not None:
        bias = layer.bias.detach()[lo:hi]
    if isinstance(layer, QuantLinear):
        w = layer.weight
        codes = w.codes[:, lo:hi] if col else w.codes[lo:hi, :]
        scale = w.scale[lo:hi] if col else w.scale
        shape = (w.shape[0], hi - lo) if col else (hi - lo, w.shape[1])
        return QuantLinear(QuantizedTensor("int8", codes.contiguous(), scale.contiguous(), shape),
                           bias, device=device)
    weight = layer.weight.detach()
    weight = weight[lo:hi, :] if col else weight[:, lo:hi]
    out = nn.Linear(weight.shape[1], weight.shape[0], bias=bias is not None,
                    device=device, dtype=weight.dtype)
    with torch.no_grad():
        out.weight.copy_(weight)
        if bias is not None:
            out.bias.copy_(bias)
    return out.requires_grad_(False)


def _splits(layers: Sequence[Tuple[str, nn.Module]], family: str, tp: int) -> Optional[List[Tuple]]:
    """Each layer's spec when every one of the set splits evenly over
    ``tp`` by the family's rules (COLUMN or ROW, no NF4); else None."""
    specs = []
    for name, layer in layers:
        spec = tp_spec_for_path(jax_path(name), family)
        if spec not in (COLUMN, ROW) or _is_nf4(layer) or not isinstance(layer, (nn.Linear, QuantLinear)):
            return None
        n_in, n_out = (layer.in_features, layer.out_features)
        if (n_out if spec == COLUMN else n_in) % tp:
            return None
        specs.append(spec)
    return specs


def _parts_of(layers, specs, devices) -> List[List[nn.Module]]:
    """``parts[t][i]``: layer i's part on tp device t."""
    tp = len(devices)
    out = []
    for t, dev in enumerate(devices):
        row = []
        for (_, layer), spec in zip(layers, specs):
            size = (layer.out_features if spec == COLUMN else layer.in_features) // tp
            row.append(_split(layer, spec, t * size, (t + 1) * size, dev))
        out.append(row)
    return out


def _row_bias(layer: nn.Module) -> Optional[torch.Tensor]:
    return None if layer.bias is None else layer.bias.detach()


# ---------------------------------------------------------------- Qwen3


def _qwen3_layer_tp(name: str, layer: nn.Module, devices: Sequence[torch.device]) -> None:
    """Swap a Qwen3 layer's attention and MLP for TensorParallel blocks
    (each set whose leaves and heads split evenly)."""
    from codemix_dense_retrieval_torch.models.qwen3 import Qwen3Attention, Qwen3Mlp

    tp = len(devices)
    attn, cfg = layer.self_attn, layer.self_attn.cfg
    names = ("q_proj", "k_proj", "v_proj", "o_proj")
    leaves = [(f"{name}.self_attn.{n}", getattr(attn, n)) for n in names]
    specs = _splits(leaves, "qwen3", tp)
    if specs is not None and cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0:
        part_cfg = dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                                       num_kv_heads=cfg.num_kv_heads // tp)
        parts = []
        for dev, row in zip(devices, _parts_of(leaves, specs, devices)):
            with torch.device("meta"):
                part = Qwen3Attention(part_cfg)
            for n, sub in zip(names, row):
                setattr(part, n, sub)
            part.q_norm = copy.deepcopy(attn.q_norm).to(dev)
            part.k_norm = copy.deepcopy(attn.k_norm).to(dev)
            parts.append(part)
        layer.self_attn = TensorParallel(parts, devices)
    mlp = layer.mlp
    names = ("gate_proj", "up_proj", "down_proj")
    leaves = [(f"{name}.mlp.{n}", getattr(mlp, n)) for n in names]
    specs = _splits(leaves, "qwen3", tp)
    if specs is not None:
        part_cfg = dataclasses.replace(cfg, intermediate_size=cfg.intermediate_size // tp)
        parts = []
        for row in _parts_of(leaves, specs, devices):
            with torch.device("meta"):
                part = Qwen3Mlp(part_cfg)
            for n, sub in zip(names, row):
                setattr(part, n, sub)
            parts.append(part)
        layer.mlp = TensorParallel(parts, devices)


# ---------------------------------------------------------------- XLM-R


class _XLMRAttentionPart(nn.Module):
    """One tp device's attention: its Q/K/V columns (``num_heads`` heads)
    and its rows of the output projection, without that projection's bias
    (a set that runs whole: the layers themselves, bias included)."""

    def __init__(self, q, k, v, out, num_heads: int, use_flash: bool) -> None:
        super().__init__()
        self.q, self.k, self.v, self.out = q, k, v, out
        self.num_heads, self.use_flash = num_heads, use_flash

    def forward(self, x, attention_mask, segment_ids=None):
        attn = multi_head_attention(
            self.q(x), self.k(x), self.v(x), attention_mask,
            num_heads=self.num_heads, use_flash=self.use_flash, segment_ids=segment_ids,
        )
        return self.out(attn)


class _XLMRFfnPart(nn.Module):
    """One tp device's FFN: its ``ffn_in`` columns and ``ffn_out`` rows,
    without ``ffn_out``'s bias (run whole: the layers themselves)."""

    def __init__(self, inner, outer) -> None:
        super().__init__()
        self.inner, self.outer = inner, outer

    def forward(self, x):
        return self.outer(nn.functional.gelu(self.inner(x), approximate="none"))


class XLMRLayerTP(nn.Module):
    """An XLM-R layer (post-LN, exact GELU) over TensorParallel attention
    and FFN blocks; a set that does not split runs as one part, whole, on
    the first tp device."""

    def __init__(self, attn: TensorParallel, attn_ln: nn.Module, ffn: TensorParallel,
                 ffn_ln: nn.Module) -> None:
        super().__init__()
        self.attn, self.attn_ln, self.ffn, self.ffn_ln = attn, attn_ln, ffn, ffn_ln

    def forward(self, x, attention_mask, task_id=None, segment_ids=None):
        x = self.attn_ln(x + self.attn(x, attention_mask, segment_ids=segment_ids))
        return self.ffn_ln(x + self.ffn(x))


def _xlmr_layer_tp(name: str, layer: nn.Module, devices: Sequence[torch.device]) -> nn.Module:
    """The TP form of an XLM-R layer; a LoRA layer (jina-v3, whose paths
    the rules do not match) stays as it is."""
    if any(not isinstance(getattr(layer, n), (nn.Linear, QuantLinear))
           for n in ("q", "k", "v", "attn_out", "ffn_in", "ffn_out")):
        return layer
    cfg, tp = layer.cfg, len(devices)

    def block(names, make, heads_ok):
        leaves = [(f"{name}.{n}", getattr(layer, n)) for n in names]
        specs = _splits(leaves, "xlmr", tp) if heads_ok else None
        if specs is None:  # the set runs whole on the first tp device
            return TensorParallel([make([sub for _, sub in leaves], 1)], devices[:1])
        parts = [make(row, tp) for row in _parts_of(leaves, specs, devices)]
        return TensorParallel(parts, devices, _row_bias(leaves[-1][1]))

    attn = block(
        ("q", "k", "v", "attn_out"),
        lambda row, t: _XLMRAttentionPart(*row, cfg.num_heads // t, cfg.use_flash),
        cfg.num_heads % tp == 0,
    )
    ffn = block(("ffn_in", "ffn_out"), lambda row, t: _XLMRFfnPart(*row), True)
    return XLMRLayerTP(attn, layer.attn_ln, ffn, layer.ffn_ln)


def shard_params_tp(model: nn.Module, mesh: Mesh, family: str) -> nn.Module:
    """A tensor-parallel copy of ``model`` (a Qwen3 or XLM-R encoder) over
    the ``tp`` devices of the mesh's first shard row: each layer's
    attention and MLP / FFN split as the module docstring says; the rest of
    the model on the first tp device. ``model`` itself is left as it is.
    Its forward methods are ``model``'s."""
    if family not in RULE_SETS:
        raise ValueError(f"unknown tp family {family!r}; expected one of {sorted(RULE_SETS)}")
    devices = list(mesh.devices[0])
    out = copy.deepcopy(model).to(devices[0])
    for i, layer in enumerate(out.layers):
        if family == "qwen3":
            _qwen3_layer_tp(f"layers.{i}", layer, devices)
        else:
            out.layers[i] = _xlmr_layer_tp(f"layers.{i}", layer, devices)
    return out


def replicate_params(model: nn.Module, mesh: Mesh) -> List[nn.Module]:
    """``model`` on each shard device of ``mesh``, in shard order: the
    model itself on its own device, one copy on each other distinct device,
    shared where a device repeats (the identity placement on every device)."""
    own = next(iter(model.parameters())).device
    copies = {own: model}
    out = []
    for dev in mesh.shard_devices():
        if dev not in copies:
            copies[dev] = copy.deepcopy(model).to(dev)
        out.append(copies[dev])
    return out
