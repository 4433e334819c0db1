"""Determinism helper: the reference seeds random / numpy / torch at 42
(`onepass_dense_run.py:122-125`)."""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int = 42) -> "np.random.Generator":
    """Seed Python's, numpy's and torch's global generators (torch's on
    every CUDA device too) and return a fresh numpy Generator of ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return np.random.default_rng(seed)
