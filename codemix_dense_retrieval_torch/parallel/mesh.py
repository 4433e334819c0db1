"""Device mesh and the in-process collectives over it.

The JAX package builds one ``jax.sharding.Mesh`` with two axes and lets
``shard_map`` / GSPMD place work on it. The port keeps the single-controller
model: one process drives every device of its :class:`Mesh`, a (shard, tp)
grid of ``torch.device``s:

- ``shard``: corpus rows (the index's row shards, and the encoder's
  data-parallel replicas);
- ``tp``: tensor parallelism for large encoders (``parallel/tp.py``).

Collectives inside a process are explicit tensor moves onto the gathering
device (:func:`gather_to`, :func:`reduce_sum_to`); across processes they are
``torch.distributed`` calls (``parallel/multihost.py``). Only (B, k)
candidate payloads and tensor-parallel partial sums cross a device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch


class Mesh:
    """A (shard, tp) grid of ``torch.device``s on this process.

    ``shape`` is ``{"shard": S, "tp": T}`` over the whole world: in a
    multi-process mesh (:func:`~codemix_dense_retrieval_torch.parallel.multihost.global_mesh`)
    each of ``process_count`` processes holds ``devices.shape[0]`` contiguous
    shards, and this one's start at global shard ``first_shard``."""

    def __init__(
        self,
        devices: np.ndarray,
        axis_names=("shard", "tp"),
        *,
        process_index: int = 0,
        process_count: int = 1,
    ) -> None:
        if devices.ndim != 2:
            raise ValueError(f"mesh devices must be a 2-D grid, got shape {devices.shape}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.process_index = process_index
        self.process_count = process_count

    @property
    def shape(self) -> Dict[str, int]:
        s, t = self.devices.shape
        return {self.axis_names[0]: s * self.process_count, self.axis_names[1]: t}

    @property
    def local_shards(self) -> int:
        """Shards this process holds."""
        return self.devices.shape[0]

    @property
    def first_shard(self) -> int:
        """Global index of this process's first shard."""
        return self.process_index * self.local_shards

    def shard_devices(self) -> List[torch.device]:
        """The device of each local shard (the first device of its tp row)."""
        return list(self.devices[:, 0])

    def distinct_devices(self) -> List[torch.device]:
        """Every device of this process's grid once, in first-seen order."""
        return list(dict.fromkeys(self.devices.reshape(-1)))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.reshape(-1).tolist()})"


def visible_cards() -> List[torch.device]:
    """Every CUDA card this process sees; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; name the devices (devices=[torch.device('cpu')] * S) "
            "to build a mesh on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    shard: int = -1,
    tp: int = 1,
    *,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    axis_names=("shard", "tp"),
) -> Mesh:
    """Build a (shard, tp) mesh. ``shard=-1`` uses all remaining devices.

    ``devices`` defaults to every visible CUDA card, each once (and raises
    without one). An explicit list may name a device more than once: that
    puts several shards on one device (S shards on the CPU, or on one card)."""
    devs = [torch.device(d) for d in devices] if devices is not None else visible_cards()
    n = len(devs)
    if shard == -1:
        if n % tp:
            raise ValueError(f"{n} devices not divisible by tp={tp}")
        shard = n // tp
    if shard * tp > n:
        raise ValueError(f"mesh {shard}x{tp} needs {shard * tp} devices, have {n}")
    grid = np.empty(shard * tp, dtype=object)
    grid[:] = devs[: shard * tp]
    return Mesh(grid.reshape(shard, tp), axis_names)


def shard_axis_size(mesh: Mesh, axis: str = "shard") -> int:
    return mesh.shape[axis]


def as_mesh(mesh_or_device: Union[Mesh, str, torch.device]) -> Mesh:
    """A :class:`Mesh` as it is; a device as the one-shard mesh on it."""
    if isinstance(mesh_or_device, Mesh):
        return mesh_or_device
    return make_mesh(1, devices=[mesh_or_device])


def gather_to(parts: Sequence[torch.Tensor], device: torch.device, dim: int = 1) -> torch.Tensor:
    """The in-process all-gather: ``parts`` (one per shard, each on its own
    device) moved onto ``device`` and concatenated along ``dim``."""
    return torch.cat([p.to(device, non_blocking=device.type == "cuda") for p in parts], dim=dim)


def reduce_sum_to(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The in-process all-reduce (sum) onto ``device``: the tensor-parallel
    partial sums, added in part order (the same order on every call)."""
    nb = device.type == "cuda"
    out = parts[0].to(device, non_blocking=nb)
    for p in parts[1:]:
        out = out + p.to(device, non_blocking=nb)
    return out
