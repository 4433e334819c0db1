"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit), and the least time a piece
of work can take on it."""

from __future__ import annotations

from typing import Tuple

BF16_FLOPS = 989e12      # bf16 / f16 tensor cores
TF32_FLOPS = 494.7e12    # tf32 tensor cores
F32_FLOPS = 67e12        # f32 outside the tensor cores
INT8_OPS = 1979e12       # int8 tensor cores
HBM_BYTES_PER_S = 3.35e12


def bound(nbytes: float, ops: float, peak: float = BF16_FLOPS) -> Tuple[float, str]:
    """(least seconds, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
