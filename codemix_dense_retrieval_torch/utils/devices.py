"""Device resolution for the port's entry points.

Entry points run on the CUDA card by default. A caller that wants the CPU
says so (``device="cpu"``); with no CUDA device and no device named, they
raise instead of carrying on on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def default_dtype(device: torch.device) -> torch.dtype:
    """Compute dtype of the encoder: bf16 on the card, f32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32
