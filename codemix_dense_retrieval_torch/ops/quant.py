"""Int8 symmetric quantization for embedding storage.

Per-row symmetric int8: ``scale = max|x| / 127`` (1.0 for an all-zero row),
values ``clip(round(x / scale), -127, 127)`` with round-half-to-even
(``np.rint``, ``torch.round``). Scores are exact int8 x int8 inner products,
accumulated as integers and rescaled to f32 in the order
``(acc * d_scale) * q_scale``: f32 multiplication is not associative, and
that order is the one the int8 kernel (``csrc/bin_scores_int8.cu``) and the
JAX package use, so every int8 path ranks bit-identical scores.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

#: K-width of one f32 partial product in :func:`int8_ip_scores`. Each
#: product is at most 127^2 = 16,129, so a partial sum over at most 1040
#: terms stays below 2^24 and is an exact f32 integer in any summation order.
EXACT_F32_K = 1024


def quantize_rows_np(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side per-row symmetric quantization -> (int8 values, f32 scales)."""
    x = np.asarray(x, np.float32)
    amax = np.abs(x).max(axis=1)
    scales = np.where(amax > 0, amax / np.float32(127.0), np.float32(1.0)).astype(np.float32)
    q = np.clip(np.rint(x / scales[:, None]), -127, 127).astype(np.int8)
    return q, scales


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric quantization on ``x``'s device -> (int8 values,
    f32 scales); bit-identical to :func:`quantize_rows_np`, so
    ``quantize_rows(dequantize(q, s)) == (q, s)`` as on the host."""
    x = x.to(torch.float32)
    amax = x.abs().amax(dim=1)
    # a tensor divisor: on CUDA, division by a Python scalar multiplies by
    # its reciprocal, which differs from a true division in the last bit
    scales = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
    q = torch.round(x / scales[:, None]).clamp_(-127, 127).to(torch.int8)
    return q, scales


def int8_ip_acc(q_vals: torch.Tensor, d_vals: torch.Tensor) -> torch.Tensor:
    """Exact integer inner products (B, d) x (N, d) -> (B, N), as f32 when
    ``d <= EXACT_F32_K`` (every value an exact integer) and as int64 above
    (f32 partial products over K chunks of ``EXACT_F32_K``, summed as
    integers), so the result stays exact for d = 4096 models."""
    qf = q_vals.to(torch.float32)
    df = d_vals.to(torch.float32)
    dim = qf.shape[1]
    if dim <= EXACT_F32_K:
        return qf @ df.T
    acc = None
    for k0 in range(0, dim, EXACT_F32_K):
        part = (qf[:, k0 : k0 + EXACT_F32_K] @ df[:, k0 : k0 + EXACT_F32_K].T).to(torch.int64)
        acc = part if acc is None else acc.add_(part)
    return acc


def int8_ip_acc_rows(q_vals: torch.Tensor, cand_vals: torch.Tensor) -> torch.Tensor:
    """Exact integer inner products of each query (B, d) with its own
    candidate rows (B, C, d) -> (B, C), exact as :func:`int8_ip_acc`."""
    qf = q_vals.to(torch.float32)[:, :, None]
    cf = cand_vals.to(torch.float32)
    dim = qf.shape[1]
    if dim <= EXACT_F32_K:
        return torch.bmm(cf, qf)[:, :, 0]
    acc = None
    for k0 in range(0, dim, EXACT_F32_K):
        part = torch.bmm(cf[:, :, k0 : k0 + EXACT_F32_K], qf[:, k0 : k0 + EXACT_F32_K])
        part = part[:, :, 0].to(torch.int64)
        acc = part if acc is None else acc.add_(part)
    return acc


def int8_ip_scores(
    q_vals: torch.Tensor,   # (B, d) int8
    q_scales: torch.Tensor,  # (B,) f32
    d_vals: torch.Tensor,   # (N, d) int8
    d_scales: torch.Tensor,  # (N,) f32
) -> torch.Tensor:
    """Exact int8 inner products rescaled to f32: (B, N), ``(acc * d_scale)
    * q_scale``."""
    acc = int8_ip_acc(q_vals, d_vals).to(torch.float32)
    return acc.mul_(d_scales[None, :]).mul_(q_scales[:, None])


def dequantize(vals: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return vals.to(torch.float32) * scales[:, None]
