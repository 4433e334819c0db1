"""Seeded random weights of a model, made on the device in its served dtype.

One flat buffer of every parameter, filled from one generator in a few
large calls of normal values of the configuration's ``init_std``; norm
scales are ``1 +`` such a value.
The parameters are views of the buffer, named as Hugging Face names them
(the reference's names). Made again from the same seed on the same kind of
device, the buffer is the same bits, so the reference takes its own copy
instead of anything the port holds.
"""

from __future__ import annotations

from typing import Dict

import torch

from harness.data import torch_gen

FILL_CHUNK = 1 << 26   # values drawn per call


def make(shapes: Dict[str, tuple], seed: int, device, dtype: torch.dtype, std: float) -> Dict[str, torch.Tensor]:
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    total = sum(sizes)
    flat = torch.empty(total, dtype=dtype, device=device)
    g = torch_gen(device, seed, "weights")
    for c0 in range(0, total, FILL_CHUNK):
        c1 = min(total, c0 + FILL_CHUNK)
        flat[c0:c1] = (torch.randn(c1 - c0, device=device, generator=g) * std).to(dtype)
    out, off = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        view = flat[off: off + n].view(shape)
        if _is_norm_scale(name):
            view.add_(1.0)
        out[name] = view
        off += n
    return out


def _is_norm_scale(name: str) -> bool:
    return name.endswith("norm.weight") or name.endswith("LayerNorm.weight")
