"""Grouped matrix products of a mixture-of-experts layer.

:func:`grouped_mm` multiplies rows sorted by group (expert) with each
group's own matrix: ``x`` (M, K) whose rows ``[offsets[g-1], offsets[g])``
belong to group g, ``w`` (G, K, N), ``offsets`` (G,) int32 running ends of
the groups, on the device. Rows at or past ``offsets[-1]`` are not computed.
On a card it is one launch of ``torch._grouped_mm`` (CUTLASS's grouped bf16
GEMM on sm90, which reads the group sizes on the device), whatever the
number of groups, so the forward reads no count back to the host; the JAX
package has no counterpart (its encoders are dense). Its plain version
:func:`grouped_mm_plain` loops over the groups and is the CPU path.

:class:`GroupedLinear` holds the stacked bias-free weights of E experts'
linear maps, ``weight`` (E, out, in) as each expert's ``nn.Linear`` holds
its own; ``kernel`` gives the (E, in, out) operand of :func:`grouped_mm`.

``LAUNCHES["grouped_mm"]`` counts the card's launches (a plain integer, as
``ops.kernels.LAUNCHES`` counts the hand-written kernels').
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

LAUNCHES: Dict[str, int] = {"grouped_mm": 0}


def grouped_mm_plain(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`grouped_mm`: one product per group (reads
    the offsets on the host); rows past the last group are zeros."""
    out = x.new_zeros((x.shape[0], w.shape[-1]))
    start = 0
    for g, end in enumerate(offsets.tolist()):
        if end > start:
            out[start:end] = x[start:end] @ w[g]
        start = end
    return out


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(M, N) products of the group-sorted rows of ``x`` (M, K) with ``w``
    (G, K, N) (see the module docstring): one ``torch._grouped_mm`` launch
    for CUDA tensors, :func:`grouped_mm_plain` for CPU tensors."""
    if x.device.type != "cuda":
        return grouped_mm_plain(x, w, offsets)
    LAUNCHES["grouped_mm"] += 1
    return torch._grouped_mm(x, w, offs=offsets)


class GroupedLinear(nn.Module):
    """E stacked bias-free linear maps: ``weight`` (E, out, in)."""

    def __init__(self, experts: int, in_features: int, out_features: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(experts, out_features, in_features))

    def kernel(self, dtype: torch.dtype) -> torch.Tensor:
        """The (E, in, out) operand of :func:`grouped_mm` (a view)."""
        return self.weight.to(dtype).transpose(1, 2)

    def forward(self, x: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
        return grouped_mm(x, self.kernel(x.dtype), offsets)
