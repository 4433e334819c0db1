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

A layer that holds a share of its experts computes only the rows routed to
them, which its sort puts first; how many there are is a count on the card
(``offsets[-1:]``). :func:`gather_rows`, :func:`silu_mul_rows` and
:func:`combine_rows` move and combine exactly those rows without reading
the count back: on a card each is one launch of ``csrc/moe_rows.cu``
(``ops.kernels.LAUNCHES["moe_gather"]``, ``["moe_act"]``,
``["moe_combine"]``), which reads the count on the device; CPU tensors
take their plain versions (``*_plain``, on any device), which read it on
the host.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch
from torch import nn

from codemix_dense_retrieval_torch.ops import kernels

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


def _rows_refusal(*tensors: torch.Tensor) -> None:
    """Raise unless the row kernels take these bf16 operands (contiguous,
    16-byte aligned, on one card, widths a multiple of 8)."""
    for t in tensors:
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 16 or t.shape[-1] % 8:
            raise ValueError(f"moe_rows on CUDA takes contiguous, 16-byte aligned bf16 rows of a width that is "
                             f"a multiple of 8; got {t.dtype} {tuple(t.shape)}")


def _rows_fn(name: str, argtypes):
    fn = getattr(kernels.load("moe_rows"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def gather_rows(x: torch.Tensor, src: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """(R, H) rows ``x[src[r]]`` for r < ``count`` (a one-element int32
    tensor on x's device) of ``src`` (R,) int64; rows at or past the count
    are left as they are (zeros in the plain version) and never read."""
    if x.device.type != "cuda":
        return gather_rows_plain(x, src, count)
    _rows_refusal(x)
    out = torch.empty((src.shape[0], x.shape[1]), dtype=x.dtype, device=x.device)
    fn = _rows_fn("moe_gather_launch", [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    rc = kernels.launch(fn, x.device, x.data_ptr(), src.contiguous().data_ptr(), count.data_ptr(), out.data_ptr(),
                        src.shape[0], x.shape[1])
    kernels.check(rc, "moe_gather")
    kernels.LAUNCHES["moe_gather"] += 1
    return out


def silu_mul_rows(gu: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """(R, F) ``SiLU(gu[:, :F]) * gu[:, F:]`` of the rows before ``count``
    of ``gu`` (R, 2F)."""
    f = gu.shape[1] // 2
    if gu.device.type != "cuda":
        return silu_mul_rows_plain(gu, count)
    _rows_refusal(gu)
    out = torch.empty((gu.shape[0], f), dtype=gu.dtype, device=gu.device)
    fn = _rows_fn("moe_act_launch", [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    rc = kernels.launch(fn, gu.device, gu.data_ptr(), count.data_ptr(), out.data_ptr(), gu.shape[0], f)
    kernels.check(rc, "moe_act")
    kernels.LAUNCHES["moe_act"] += 1
    return out


def combine_rows(ys: torch.Tensor, inv: torch.Tensor, weights: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """(n, H): token t's sum over its k slots s of ``weights[t, s] *
    ys[inv[t k + s]]`` where that row is before ``count``, in f32 in slot
    order, cast to ys's dtype. ``inv`` (n k,) int32: each slot's row in the
    sorted order; ``weights`` (n, k) f32."""
    n, k = weights.shape
    if ys.device.type != "cuda":
        return combine_rows_plain(ys, inv, weights, count)
    _rows_refusal(ys)
    out = torch.empty((n, ys.shape[1]), dtype=ys.dtype, device=ys.device)
    fn = _rows_fn("moe_combine_launch", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    rc = kernels.launch(fn, ys.device, ys.data_ptr(), inv.to(torch.int32).contiguous().data_ptr(),
                        weights.to(torch.float32).contiguous().data_ptr(), count.data_ptr(), out.data_ptr(),
                        n, k, ys.shape[1])
    kernels.check(rc, "moe_combine")
    kernels.LAUNCHES["moe_combine"] += 1
    return out


def gather_rows_plain(x: torch.Tensor, src: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gather_rows` on x's device (the count read on
    the host; rows past it zeros)."""
    n = int(count)
    out = x.new_zeros((src.shape[0], x.shape[1]))
    out[:n] = x.index_select(0, src[:n])
    return out


def silu_mul_rows_plain(gu: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`silu_mul_rows` on gu's device."""
    f = gu.shape[1] // 2
    n = int(count)
    out = gu.new_zeros((gu.shape[0], f))
    out[:n] = nn.functional.silu(gu[:n, :f]) * gu[:n, f:]
    return out


def combine_rows_plain(ys: torch.Tensor, inv: torch.Tensor, weights: torch.Tensor,
                       count: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`combine_rows` on ys's device."""
    n, k = weights.shape
    rows = inv.to(torch.long).reshape(n, k)
    live = (rows < int(count))[..., None]
    picked = torch.where(live, ys.index_select(0, rows.reshape(-1).clamp_max(ys.shape[0] - 1)).reshape(
        n, k, -1).to(torch.float32), 0.0)
    return (picked * weights[..., None]).sum(dim=1).to(ys.dtype)
