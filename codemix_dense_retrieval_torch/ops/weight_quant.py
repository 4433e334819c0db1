"""Encoder weight quantization: the port of the JAX package's
``ops/weight_quant.py`` (the reference's bitsandbytes ``load_in_8bit`` /
``load_in_4bit`` path, `onepass_dense_run.py:100-103,177-187`).

- :func:`quantize_tree` replaces every large 2-D kernel of a Flax-layout
  parameter tree (kernels ``(in, out)``) by a :class:`QuantizedTensor`:
  ``int8`` per output channel, symmetric (W8A16), or ``nf4``, blockwise
  4-bit NormalFloat in blocks of 64 with two codes per byte and one f32
  absmax per block (QLoRA's scheme without the double quantization). The
  quantizers are the JAX package's numpy code, run on the host, so the
  codes and scales are byte-equal to its own.
- :class:`QuantLinear` is the layer the port's encoders run with such a
  weight: the codes stay resident on the device and each forward
  dequantizes them into the compute dtype before a plain ``F.linear``
  (the JAX package lets XLA fuse the same dequantize into the matmul).
- :func:`quantize_stacked` quantizes a stack of E experts' kernels
  ``(E, in, out)`` (a mixture-of-experts layer's
  :class:`~codemix_dense_retrieval_torch.ops.grouped_mm.GroupedLinear`) on
  its own device, each expert as the host quantizers quantize one kernel;
  :class:`QuantGroupedLinear` runs it.

Embeddings and 1-D parameters stay in full precision, as bitsandbytes
quantizes ``nn.Linear`` layers only.
"""

from __future__ import annotations

import functools
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from codemix_dense_retrieval_torch.ops.grouped_mm import GroupedLinear, grouped_mm

NF4_BLOCK = 64

# the 16 NormalFloat-4 quantiles (QLoRA): equal-mass bins of N(0,1),
# scaled so the extremes hit +-1 exactly, with a true zero code
NF4_TABLE = np.array([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
], dtype=np.float32)

MODES = ("int8", "nf4")


class QuantizedTensor:
    """A quantized ``(in, out)`` kernel: ``codes`` (int8 ``(in, out)``, or
    uint8 ``(blocks, 32)`` holding two NF4 codes a byte) and f32 ``scale``
    (per output channel, or per block of 64), numpy arrays on the host or
    tensors on a device. ``shape`` is the unpadded ``(in, out)``. A stack
    of E experts' kernels has ``shape`` ``(E, in, out)`` and a leading E on
    its codes and scales."""

    def __init__(self, kind: str, codes, scale, shape: tuple):
        self.kind = kind
        self.codes = codes
        self.scale = scale
        self.shape = tuple(int(s) for s in shape)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"QuantizedTensor({self.kind}, shape={self.shape})"

    def dequantize(self, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """The ``(in, out)`` kernel on the codes' device: ``f32(codes) *
        scale``, then the cast to ``dtype``, as the JAX package computes it
        (bit-equal in f32)."""
        codes = torch.as_tensor(self.codes)
        scale = torch.as_tensor(self.scale, device=codes.device)
        if self.kind == "int8":
            return (codes.to(torch.float32) * scale.unsqueeze(-2)).to(dtype)
        # nf4: each byte's two levels (high nibble first) in one lookup, * absmax
        pairs = F.embedding(codes.to(torch.int32), _nf4_pairs(codes.device))  # (..., blocks, 32, 2)
        vals = pairs.reshape(*codes.shape[:-1], -1) * scale[..., None]
        size = int(np.prod(self.shape[-2:]))
        lead = tuple(self.shape[:-2])
        return vals.reshape(*lead, -1)[..., :size].reshape(self.shape).to(dtype)


@functools.lru_cache(maxsize=None)
def _nf4_pairs(device: torch.device) -> torch.Tensor:
    """(256, 2) f32: the NF4 levels of a packed byte's high and low nibble,
    made once per device (a host copy in every forward would wait on it)."""
    b = np.arange(256)
    return torch.from_numpy(np.stack([NF4_TABLE[b >> 4], NF4_TABLE[b & 0xF]], axis=1)).to(device)


def _quantize_leaf_int8(w: np.ndarray) -> QuantizedTensor:
    """Per-output-channel symmetric int8: W (in, out) -> codes int8 +
    scale f32 (out,). absmax/127 scaling, round-to-nearest-even."""
    absmax = np.abs(w).max(axis=0)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    codes = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return QuantizedTensor("int8", codes, scale, w.shape)


def _quantize_leaf_nf4(w: np.ndarray) -> QuantizedTensor:
    """Blockwise NF4: flatten (row-major over (in, out)), pad to NF4_BLOCK,
    per-block absmax, nearest NF4 level, two 4-bit codes packed per uint8."""
    flat = w.astype(np.float32).ravel()
    pad = (-len(flat)) % NF4_BLOCK
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    blocks = flat.reshape(-1, NF4_BLOCK)
    absmax = np.abs(blocks).max(axis=1, keepdims=True)
    absmax = np.where(absmax > 0, absmax, 1.0).astype(np.float32)
    normed = blocks / absmax
    # nearest of the 16 levels; table is sorted -> searchsorted midpoints
    mids = (NF4_TABLE[1:] + NF4_TABLE[:-1]) / 2
    codes = np.searchsorted(mids, normed).astype(np.uint8)  # (nb, B)
    packed = ((codes[:, 0::2] << 4) | codes[:, 1::2]).astype(np.uint8)
    return QuantizedTensor("nf4", packed, absmax[:, 0], w.shape)


def quantize_stacked(w: torch.Tensor, mode: str) -> QuantizedTensor:
    """A stack of E kernels ``w`` (E, in, out) quantized on its own device,
    each expert's kernel as :func:`_quantize_leaf_int8` /
    :func:`_quantize_leaf_nf4` quantize one (the same codes and scales):
    int8 per output channel (scale (E, out)), or NF4 in blocks of 64 of
    each expert's row-major kernel (codes (E, blocks, 32), scale (E,
    blocks)). The f32 copy it works in is one stack's."""
    if mode not in MODES:
        raise ValueError(f"weight_quant mode must be int8|nf4, got {mode!r}")
    w = w.to(torch.float32)
    if mode == "int8":
        absmax = w.abs().amax(dim=1)
        scale = torch.where(absmax > 0, absmax / torch.tensor(127.0, device=w.device), 1.0)
        codes = torch.round(w / scale[:, None, :]).clamp_(-127, 127).to(torch.int8)
        return QuantizedTensor("int8", codes, scale, w.shape)
    flat = w.reshape(w.shape[0], -1)
    flat = F.pad(flat, (0, (-flat.shape[1]) % NF4_BLOCK))
    blocks = flat.reshape(w.shape[0], -1, NF4_BLOCK)
    absmax = blocks.abs().amax(dim=-1, keepdim=True)
    absmax = torch.where(absmax > 0, absmax, 1.0)
    table = torch.from_numpy(NF4_TABLE).to(w.device)
    codes = torch.searchsorted((table[1:] + table[:-1]) / 2, blocks / absmax).to(torch.uint8)
    packed = (codes[..., 0::2] << 4) | codes[..., 1::2]
    return QuantizedTensor("nf4", packed, absmax[..., 0], w.shape)


def quantize_tree(
    params,
    mode: str = "int8",
    *,
    min_size: int = 65_536,
    skip_substrings: tuple = ("embed",),
):
    """A copy of the Flax-layout tree with every eligible 2-D float kernel
    replaced by a :class:`QuantizedTensor` (eligible: at least ``min_size``
    elements, no lower-cased path component containing any of
    ``skip_substrings``); quantized leaves pass through."""
    if mode not in MODES:
        raise ValueError(f"weight_quant mode must be int8|nf4, got {mode!r}")
    quant = _quantize_leaf_int8 if mode == "int8" else _quantize_leaf_nf4

    def rec(node, path):
        if isinstance(node, QuantizedTensor):
            return node
        if isinstance(node, Mapping):
            return {k: rec(v, path + (k.lower(),)) for k, v in node.items()}
        w = np.asarray(node)
        if (
            w.ndim == 2
            and w.size >= min_size
            and np.issubdtype(w.dtype, np.floating)
            and not any(s in p for s in skip_substrings for p in path)
        ):
            return quant(w.astype(np.float32))
        return node

    return rec(params, ())


def dequantize_tree(params, dtype: torch.dtype = torch.bfloat16):
    """Inverse of :func:`quantize_tree`: every quantized leaf becomes its
    dequantized ``(in, out)`` tensor in ``dtype``."""

    def rec(node):
        if isinstance(node, QuantizedTensor):
            return node.dequantize(dtype)
        if isinstance(node, Mapping):
            return {k: rec(v) for k, v in node.items()}
        return node

    return rec(params)


def _leaves(node):
    if isinstance(node, Mapping):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node


def has_quantized(params) -> bool:
    """True if any leaf of the tree (or state dict) is a
    :class:`QuantizedTensor`: the loaders arm the dequantizing layers for
    pre-quantized checkpoints with it."""
    return any(isinstance(x, QuantizedTensor) for x in _leaves(params))


def quantized_kinds(params) -> set:
    """The quantization kinds stored in a tree (empty when none)."""
    return {x.kind for x in _leaves(params) if isinstance(x, QuantizedTensor)}


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    a = np.asarray(a)
    return int(a.size) * int(a.dtype.itemsize)


def quantized_nbytes(params) -> int:
    """Resident bytes of a (possibly quantized) tree or state dict: a
    quantized leaf counts its codes and scales."""
    total = 0
    for leaf in _leaves(params):
        if isinstance(leaf, QuantizedTensor):
            total += _nbytes(leaf.codes) + _nbytes(leaf.scale)
        else:
            total += _nbytes(leaf)
    return total


class QuantLinear(nn.Module):
    """``nn.Linear`` over a quantized weight. ``codes`` stay on the device
    as buffers; every forward dequantizes them into the input's dtype
    (``f32(codes) * scale``, then the cast) and runs ``F.linear``, so no
    full-precision copy of the weight outlives the call.

    The f32 ``scale`` is held as its int32 bit pattern (``scale_bits``):
    ``Module.to(torch.bfloat16)``, which ``build_model`` applies to the
    whole encoder, casts every floating buffer, and would round the scales
    the JAX package multiplies in f32. The buffers are not persistent: a
    state dict of the module carries ``bias`` alone, and the weight goes
    through :class:`QuantizedTensor`."""

    def __init__(self, weight: QuantizedTensor, bias: Optional[torch.Tensor] = None,
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        self.kind = weight.kind
        self.shape = weight.shape
        self.in_features, self.out_features = weight.shape[-2:]
        self.register_buffer("codes", torch.as_tensor(weight.codes).to(device), persistent=False)
        scale = torch.as_tensor(weight.scale, dtype=torch.float32)
        self.register_buffer("scale_bits", scale.view(torch.int32).to(device), persistent=False)
        if bias is None:
            self.register_parameter("bias", None)
        else:
            self.bias = nn.Parameter(bias.detach().to(device))

    @property
    def weight(self) -> QuantizedTensor:
        return QuantizedTensor(self.kind, self.codes, self.scale_bits.view(torch.float32), self.shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.dequantize(x.dtype).T, self.bias)

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}, kind={self.kind}"


class QuantGroupedLinear(QuantLinear):
    """:class:`~codemix_dense_retrieval_torch.ops.grouped_mm.GroupedLinear`
    over a quantized ``(E, in, out)`` stack: every forward dequantizes the
    stack into the input's dtype for one grouped product."""

    def kernel(self, dtype: torch.dtype) -> torch.Tensor:
        return self.weight.dequantize(dtype)

    def forward(self, x: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
        return grouped_mm(x, self.kernel(x.dtype), offsets)


def install_quantized_(model: nn.Module, state_dict: Mapping) -> dict:
    """Replace each ``nn.Linear`` of ``model`` whose ``<name>.weight`` in
    ``state_dict`` is a :class:`QuantizedTensor` by a :class:`QuantLinear`
    on the model's device (its bias taken from ``<name>.bias``, which stays
    among the entries, as the layer's state dict holds it), and each such
    ``GroupedLinear`` by a :class:`QuantGroupedLinear`; returns the entries
    left for ``load_state_dict``."""
    rest = dict(state_dict)
    for key, w in state_dict.items():
        if not isinstance(w, QuantizedTensor):
            continue
        name = key.removesuffix(".weight")
        parent_name, _, child = name.rpartition(".")
        parent = model.get_submodule(parent_name)
        old = getattr(parent, child)
        if isinstance(old, GroupedLinear) and tuple(old.weight.shape) == (w.shape[0], *w.shape[:0:-1]):
            del rest[key]
            setattr(parent, child, QuantGroupedLinear(w, device=old.weight.device))
            continue
        if not isinstance(old, nn.Linear) or (old.in_features, old.out_features) != w.shape:
            raise ValueError(f"{key}: quantized {w.shape} does not replace {old!r}")
        bias = state_dict.get(f"{name}.bias")
        if (bias is None) != (old.bias is None):
            raise ValueError(f"{key}: bias does not match the layer's")
        del rest[key]
        setattr(parent, child, QuantLinear(w, bias, device=old.weight.device))
    return rest
