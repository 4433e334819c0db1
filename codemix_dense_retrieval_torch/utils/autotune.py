"""Tuned routing constants: a per-card store the dispatch reads, and the
sweeps that fill it (the port of the JAX package's ``utils/autotune.py``).

``tune`` times the configurations on the live card and persists the
winners to a JSON file per card kind; the pickers read them where the JAX
package's do (``ops.topk._auto_bin_size_two_level``, ``_auto_super_size``
and ``_tile_b``, the one ``tile_b`` rule of the exact routes, and the flash
dispatch in ``ops.flash_attention.multi_head_attention``) and fall back to
:data:`DEFAULTS` where the store has no entry.

Every value in :data:`DEFAULTS` was measured by the JAX package on a TPU
v5e dev chip: they are fallbacks kept for parity, not measurements of any
CUDA card. The JAX table's ``flash.window`` is left out: it sizes the
Pallas kernel's K/V tiles, and kernel B (``csrc/flash_attention.cu``) has
no such parameter. So is its ``topk.tile_b``: without a store entry the
exact routes launch ``ops.topk.TILE_B`` queries.
"""

from __future__ import annotations

import functools
import json
import os
import pathlib
import re
import tempfile
from typing import Dict, Optional, Sequence

_CACHE: Optional[Dict[str, object]] = None
_CACHE_PATH: Optional[str] = None

#: the JAX package's TPU-measured values (fallbacks only, see above)
DEFAULTS = {
    "topk.super_size": 8,
    "topk.bin_size": 8,
    "flash.min_seq": 512,
}


@functools.lru_cache(maxsize=1)
def _device_kind_slug() -> str:
    """``cuda-<card name>`` (``cpu-none`` without a card), file-name safe:
    the store of one kind of card is never read on another, nor a store the
    JAX package wrote for a TPU."""
    import torch

    if torch.cuda.is_available():
        kind = f"cuda-{torch.cuda.get_device_name()}"
    else:
        kind = "cpu-none"
    return re.sub(r"[^A-Za-z0-9_.-]+", "-", kind).lower()


def tune_file_path() -> pathlib.Path:
    """The store: ``$CDR_TUNE_FILE``, or a file per card kind under
    ``$XDG_CACHE_HOME`` (``~/.cache``)."""
    env = os.environ.get("CDR_TUNE_FILE")
    if env:
        return pathlib.Path(env)
    root = pathlib.Path(os.environ.get("XDG_CACHE_HOME", pathlib.Path.home() / ".cache"))
    return root / "codemix_dense_retrieval_torch" / f"tuned-{_device_kind_slug()}.json"


def invalidate_cache() -> None:
    global _CACHE, _CACHE_PATH
    _CACHE, _CACHE_PATH = None, None


def load_tuned() -> Dict[str, object]:
    """Load (and memoize) the store; ``{}`` when it is absent or corrupt."""
    global _CACHE, _CACHE_PATH
    path = str(tune_file_path())
    if _CACHE is not None and _CACHE_PATH == path:
        return _CACHE
    data: Dict[str, object] = {}
    try:
        with open(path) as f:
            raw = json.load(f)
        if isinstance(raw, dict):
            data = raw
    except (OSError, ValueError):
        data = {}
    _CACHE, _CACHE_PATH = data, path
    return data


def get_tuned(key: str, default=None, *, k: Optional[int] = None):
    """A tuned value. With ``k``, ``key.k<k>`` takes precedence over the
    bare ``key`` (per-depth entries); then ``default``, then
    :data:`DEFAULTS`."""
    store = load_tuned()
    if k is not None:
        v = store.get(f"{key}.k{k}")
        if v is not None:
            return v
    v = store.get(key)
    if v is not None:
        return v
    if default is not None:
        return default
    return DEFAULTS.get(key)


def save_tuned(update: Dict[str, object]) -> pathlib.Path:
    """Merge ``update`` into the store atomically (a temporary file in the
    same directory, then a rename)."""
    path = tune_file_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    merged = dict(load_tuned())
    merged.update(update)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(merged, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    invalidate_cache()
    return path


# --------------------------------------------------------------------------
# sweeps
# --------------------------------------------------------------------------

def _timed(fn, iters: int = 3) -> float:
    from codemix_dense_retrieval_torch.utils.profiling import timed_device_fn

    return timed_device_fn(fn, iters=iters, warmup=1)["mean_s"]


def _unit_rows(n: int, d: int, generator, device):
    import torch

    x = torch.randn(n, d, generator=generator, device=device)
    return (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)


def autotune_topk(
    *,
    rows: int = 262_144,
    dim: int = 1024,
    batch: int = 512,
    ks: Sequence[int] = (100, 1000),
    super_sizes: Sequence[int] = (4, 8, 16),
    tile_bs: Sequence[int] = (256, 512, 1024),
    bin_sizes: Sequence[int] = (8, 16),
    iters: int = 3,
    seed: int = 0,
    device=None,
) -> Dict[str, object]:
    """Sweep the two-level cover's (bin_size, super_size, tile_b) per depth
    on seeded bf16 unit rows made on ``device`` (the card by default);
    returns the tuned keys and each depth's measured queries/s. ``tile_b``
    is the query count of one kernel-A launch (larger tiles read the rows
    fewer times and hold a larger score store); values above ``batch`` are
    left out, as in the JAX sweep."""
    import torch

    from codemix_dense_retrieval_torch.ops.topk import topk_ip_bins_two_level
    from codemix_dense_retrieval_torch.utils.devices import resolve_device

    dev = resolve_device(device)
    tile_bs = [tb for tb in tile_bs if tb <= batch] or [batch]
    gen = torch.Generator(device=dev).manual_seed(seed)
    docs = _unit_rows(rows, dim, gen, dev)
    q = _unit_rows(batch, dim, gen, dev)

    out: Dict[str, object] = {}
    for k in ks:
        best = None
        for g in bin_sizes:
            for m in super_sizes:
                for tb in tile_bs:
                    def run(g=g, m=m, tb=tb):
                        return topk_ip_bins_two_level(q, docs, k, bin_size=g, super_size=m, tile_b=tb)[0]

                    qps = batch / _timed(run, iters=iters)
                    if best is None or qps > best[0]:
                        best = (qps, g, m, tb)
        out[f"topk.bin_size.k{k}"] = best[1]
        out[f"topk.super_size.k{k}"] = best[2]
        out[f"topk.tile_b.k{k}"] = best[3]
        out[f"topk.qps.k{k}"] = round(best[0], 1)
    return out


def autotune_flash(
    *,
    heads: int = 16,
    kv_heads: Optional[int] = None,
    head_dim: int = 64,
    batch: int = 8,
    seqs: Sequence[int] = (128, 256, 512, 1024),
    causal: bool = False,
    iters: int = 3,
    seed: int = 0,
    device=None,
) -> Dict[str, object]:
    """Find the kernel-B / plain-attention crossover (``flash.min_seq``: the
    dispatch takes kernel B at S > min_seq) on the live card, for
    ``heads`` query heads over ``kv_heads`` K/V heads of ``head_dim`` (the
    defaults are BGE-M3's), full-length rows; also returns each length's
    times, ``flash.ms`` = {S: [kernel B ms, plain ms]}. The JAX sweep's
    ``flash.window`` has no counterpart in kernel B and is not timed."""
    import torch

    from codemix_dense_retrieval_torch.ops.flash_attention import attention_flash, attention_xla
    from codemix_dense_retrieval_torch.utils.devices import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    kvh = kv_heads or heads

    crossover, times = None, {}
    for s in sorted(seqs):
        q = torch.randn(batch, heads, s, head_dim, generator=gen, device=dev).to(torch.bfloat16)
        kv = torch.randn(batch, kvh, s, head_dim, generator=gen, device=dev).to(torch.bfloat16)
        lengths = torch.full((batch,), s, dtype=torch.int32, device=dev)
        tf = _timed(lambda: attention_flash(q, kv, kv, lengths, causal=causal).float().sum(), iters=iters)
        tx = _timed(lambda: attention_xla(q, kv, kv, lengths, causal=causal).float().sum(), iters=iters)
        times[str(s)] = [tf * 1e3, tx * 1e3]
        if tf < tx and crossover is None:
            crossover = s
    return {
        # the dispatch takes s > min_seq: the crossover length itself flashes
        "flash.min_seq": (crossover - 1) if crossover else max(seqs),
        "flash.ms": times,
    }


def run_autotune(
    *,
    topk: bool = True,
    flash: bool = True,
    save: bool = True,
    **kwargs,
) -> Dict[str, object]:
    """Run the requested sweeps and persist the winners (with the card kind
    under ``_device``); returns the update."""
    update: Dict[str, object] = {}
    if topk:
        tk = {k: v for k, v in kwargs.items()
              if k in ("rows", "dim", "batch", "ks", "super_sizes", "tile_bs", "bin_sizes",
                       "iters", "seed", "device")}
        update.update(autotune_topk(**tk))
    if flash:
        fl = {k: v for k, v in kwargs.items()
              if k in ("heads", "kv_heads", "head_dim", "seqs", "causal", "iters", "seed", "device")}
        update.update(autotune_flash(**fl))
    if save:
        update["_device"] = _device_kind_slug()
        save_tuned(update)
    return update
