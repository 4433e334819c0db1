"""Parameter checkpoints as one ``torch.save`` file: the port's stand-in
for the JAX package's Orbax checkpoint (``models/checkpoint.py``). A
Flax-layout tree, quantized kernels included, is flattened into the
``params.npz`` entry names (``params/layer_0/q/kernel``,
``<name>@wq.<kind>.{codes,scale,shape}``) and saved as a dict of CPU
tensors, so loading needs no pickled classes (``weights_only=True``)."""

from __future__ import annotations

import pathlib
from typing import Dict

import numpy as np
import torch

from codemix_dense_retrieval_torch.models.convert import flatten_params, unflatten_params


def save_params(path, params: Dict) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in flatten_params(params).items()},
               path)


def load_params(path) -> Dict:
    data = torch.load(pathlib.Path(path), map_location="cpu", weights_only=True)
    return unflatten_params({k: v.numpy() for k, v in data.items()})
