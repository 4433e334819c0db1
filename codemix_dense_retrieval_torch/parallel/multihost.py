"""Multi-process search over ``torch.distributed``.

The JAX package scales past one host with ``jax.distributed``; the port
links processes with ``torch.distributed``. Every process calls
:func:`initialize_multihost` first, then builds the global mesh
(:func:`global_mesh`): the index's rows shard across all processes' devices,
each process uploading only its own shards' rows
(:func:`shard_rows_multihost`). A search runs each process's shards and
merges them locally (``parallel/sharded_search.py``); the processes then
exchange their (B, k) candidate payloads with ``all_gather_into_tensor``
and merge again (:func:`all_gather_candidates`), so no score matrix and no
index row crosses a process.

Single-process callers never need this module.
"""

from __future__ import annotations

import os
import warnings
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from codemix_dense_retrieval_torch.parallel.mesh import Mesh, make_mesh
from codemix_dense_retrieval_torch.parallel.sharded_search import place_rows, shard_layout


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
) -> bool:
    """Start ``torch.distributed`` from the arguments or from torchrun's
    environment (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``). ``coordinator_address`` is ``host:port`` (or a
    ``tcp://host:port`` URL). The backend is ``backend``, else NCCL when
    CUDA cards are visible and gloo on the CPU. Returns True once the
    process group is up; False (nothing started) without a coordinator, or
    for a world of one process unless ``backend`` is named."""
    coord = coordinator_address
    if coord is None and os.environ.get("MASTER_ADDR"):
        coord = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    nproc = num_processes or int(os.environ.get("WORLD_SIZE", "0") or 0)
    pid = process_id if process_id is not None else int(os.environ.get("RANK", "0") or 0)
    if not coord or nproc < 1 or (nproc == 1 and backend is None):
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    url = coord if "://" in coord else f"tcp://{coord}"
    dist.init_process_group(backend, init_method=url, world_size=nproc, rank=pid)
    return True


def _world() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def default_local_devices() -> List[torch.device]:
    """This process's devices: the card named by torchrun's ``LOCAL_RANK``,
    else every visible card, else the CPU."""
    if not torch.cuda.is_available():
        return [torch.device("cpu")]
    if "LOCAL_RANK" in os.environ:
        return [torch.device("cuda", int(os.environ["LOCAL_RANK"]))]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def global_mesh(
    shard: int = -1,
    tp: int = 1,
    axis_names=("shard", "tp"),
    *,
    local_devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> Mesh:
    """The mesh over all processes' devices: this process's part is a
    (shard / world, tp) grid of ``local_devices`` (default
    :func:`default_local_devices`; a list may repeat a device), its shards
    the world's ``[rank * local, (rank + 1) * local)``. ``shard=-1`` uses
    every local device."""
    rank, world = _world()
    devs = list(local_devices) if local_devices is not None else default_local_devices()
    if shard != -1:
        if shard % world:
            raise ValueError(f"shard={shard} not divisible by {world} processes")
        shard //= world
    local = make_mesh(shard, tp, devices=devs, axis_names=axis_names)
    return Mesh(local.devices, axis_names, process_index=rank, process_count=world)


def process_local_rows(n_total: int, rows_per_shard: int, mesh: Optional[Mesh] = None) -> range:
    """The global row range this process materialises: processes own
    contiguous shard blocks, so ``[first_local_shard * rows_per_shard, ...)``
    over its local shards (``mesh`` default :func:`global_mesh`)."""
    mesh = mesh or global_mesh()
    start = mesh.first_shard * rows_per_shard
    stop = min(n_total, start + rows_per_shard * mesh.local_shards)
    return range(start, max(start, stop))


def shard_rows_multihost(
    rows_fn,
    n_total: int,
    dim: int,
    dtype: torch.dtype,
    mesh: Mesh,
    *,
    pad_multiple: int = 1024,
) -> Tuple[List[torch.Tensor], List[torch.Tensor], int]:
    """Multi-process :func:`~codemix_dense_retrieval_torch.parallel.sharded_search.shard_rows`:
    each process supplies only ITS rows. ``rows_fn(start, stop)`` returns
    the (stop - start, dim) block (numpy, or a tensor on any device: a
    block made on the card is copied there directly) of a global row range
    and is called only for ranges inside this process's
    :func:`process_local_rows` window; a range outside it raises. Returns
    the local shards (rows, valid-row counts, rows_per_shard) in the layout
    every process agrees on."""
    rows_per_shard, _ = shard_layout(n_total, mesh.shape["shard"], pad_multiple)
    local = process_local_rows(n_total, rows_per_shard, mesh)

    def read(start: int, stop: int) -> torch.Tensor:
        if not (local.start <= start and stop <= local.stop):
            raise RuntimeError(
                f"non-local shard requested: [{start}, {stop}) outside "
                f"process-local rows [{local.start}, {local.stop})"
            )
        block = rows_fn(start, stop)
        if not isinstance(block, torch.Tensor):
            block = torch.from_numpy(np.asarray(block))
        return block.to(dtype)

    return place_rows(read, n_total, dim, dtype, mesh, pad_multiple=pad_multiple)


def _host_backend() -> bool:
    return dist.get_backend() == "gloo"


def _all_gather(x: torch.Tensor, world: int) -> torch.Tensor:
    """``all_gather_into_tensor`` of ``x`` (every process the same shape),
    stacked on a new leading axis; through the host for gloo."""
    src = x.cpu() if _host_backend() else x.contiguous()
    out = src.new_empty((world * src.shape[0], *src.shape[1:]))
    with warnings.catch_warnings():  # deprecated in favour of all_gather_single in torch >= 2.13
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, src)
    return out.view(world, *src.shape).to(x.device)


def all_gather_candidates(
    vals: torch.Tensor, gids: torch.Tensor, mesh: Mesh
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every process's (B, k) candidates as (B, world * k), process order:
    the cross-process step of the search merge."""
    world = mesh.process_count
    v = _all_gather(vals, world)
    g = _all_gather(gids, world)
    return v.permute(1, 0, 2).reshape(vals.shape[0], -1), g.permute(1, 0, 2).reshape(gids.shape[0], -1)


def all_reduce_max(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Elementwise max of ``x`` over the processes of ``mesh`` (the adaptive
    tier's unselected bound, the sketch tier's certificate AND), through
    the host for gloo."""
    t = x.cpu() if _host_backend() else x.clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.to(x.device)
