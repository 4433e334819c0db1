"""Attention for the encoder stack.

- :func:`attention_xla`: plain PyTorch softmax attention, the path below the
  length crossover (named after its JAX counterpart, which is plain XLA);
- :func:`attention_flash`: kernel B, an online-softmax (flash) kernel
  (``csrc/flash_attention.cu``) for CUDA tensors, with its plain version
  :func:`attention_flash_plain` for CPU tensors;
- :func:`multi_head_attention`: the dispatch between the two;
- :func:`tile_schedule`: a model of kernel B's persistent tile order, for
  tests and for reading a launch's balance (:func:`schedule_balance`).

Layouts follow the JAX package: q (B, H, S, dh), k and v (B, KVH, S, dh)
with KVH dividing H (grouped-query attention), per-sequence key ``lengths``
(B,), optional ``segment_ids`` (B, S) for block-diagonal masking (0 = pad).
A query row that sees no valid key comes out as exact zeros.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from codemix_dense_retrieval_torch.ops import kernels
from codemix_dense_retrieval_torch.utils import autotune

_NEG = -1e30

#: flash/plain dispatch crossover (padded length) where the tuned store
#: has no ``flash.min_seq``: the JAX package's TPU-measured default, carried
#: over for parity; re-deriving it on the H100 is a ROADMAP item.
FLASH_MIN_SEQ = autotune.DEFAULTS["flash.min_seq"]


def _valid_mask(lengths, causal, segment_ids, s_q, s_k, device):
    col = torch.arange(s_k, device=device)
    mask = col[None, None, None, :] < lengths.to(device)[:, None, None, None]
    if segment_ids is not None:
        seg = segment_ids[:, None, :, None]
        mask = mask & (seg == segment_ids[:, None, None, :]) & (seg > 0)
    if causal:
        row = torch.arange(s_q, device=device)
        mask = mask & (col[None, :] <= row[:, None])[None, None]
    return mask


def _repeat_kv(q, k, v):
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    return k, v


def attention_xla(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    causal: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain softmax attention: f32 scores of the given values, softmax in
    f32, probabilities cast to v's dtype before the P.V product (as the JAX
    path does); rows of zero-length sequences and pad segments are zeroed."""
    dh = q.shape[-1]
    k, v = _repeat_kv(q, k, v)
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
    s = s / math.sqrt(dh)
    mask = _valid_mask(lengths, causal, segment_ids, q.shape[2], k.shape[2], q.device)
    s = torch.where(mask, s, _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p.to(v.dtype), v)
    live = (lengths.to(q.device) > 0)[:, None, None, None]
    if segment_ids is not None:
        live = live & (segment_ids > 0)[:, None, :, None]
    return torch.where(live, out, torch.zeros((), dtype=out.dtype, device=out.device))


def attention_flash_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    *,
    causal: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`attention_flash`, on any device: the
    same masked softmax attention entirely in f32 (scores scaled by
    1/sqrt(dh), mask sentinel -1e30), a row with no valid key set to zeros,
    the result cast to q's dtype."""
    dh = q.shape[-1]
    k, v = _repeat_kv(q, k, v)
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
    s = s * (1.0 / math.sqrt(dh))
    mask = _valid_mask(lengths, causal, segment_ids, q.shape[2], k.shape[2], q.device)
    s = torch.where(mask, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    out = torch.matmul(p, v.to(torch.float32)) / p.sum(dim=-1, keepdim=True)
    out = torch.where(mask.any(dim=-1, keepdim=True), out, 0.0)
    return out.to(q.dtype)


#: kernel B's query rows per tile and key rows per block (``WQ``, ``WK``)
TILE_ROWS = 128
#: waves of tiles in a causal chunk (``CAUSAL_CHUNK_WAVES``)
CAUSAL_CHUNK_WAVES = 8
#: the H100's SMs: kernel B's persistent grid
H100_SMS = 132


def tile_schedule(b: int, h: int, kvh: int, s: int, causal: bool, grid: int = H100_SMS):
    """Kernel B's tiles in launch order, as ``csrc/flash_attention.cu``'s
    ``tile_plan`` and ``tile_at`` lay them out: ``(mode, tiles)``, ``tiles``
    an int64 (n, 3) array of (first query row, batch, first q head); block i
    of ``min(n, grid)`` persistent blocks runs tiles i, i + grid, ...

    - ``"head_pairs"`` (S <= 64 and an even GQA group): a tile is 64 rows of
      q heads hq and hq + 1, which read one KV head;
    - ``"causal"``: chunks of whole sequences, about CAUSAL_CHUNK_WAVES waves
      of ``grid`` tiles each, spread evenly; inside a chunk the last query
      tile of every (batch, head) first, (batch, head) fastest;
    - ``"query_fastest"`` (non-causal): (batch, head, query tile), query tile
      fastest."""
    n_qt = -(-s // TILE_ROWS)
    if s <= 64 and (h // kvh) % 2 == 0:
        t = np.arange(b * (h // 2))
        return "head_pairs", np.stack([np.zeros_like(t), t // (h // 2), 2 * (t % (h // 2))], axis=1)
    t = np.arange(n_qt * b * h)
    if not causal:
        return "query_fastest", np.stack([(t % n_qt) * TILE_ROWS, t // n_qt // h, t // n_qt % h], axis=1)
    per_b = h * n_qt
    want = max(1, -(-CAUSAL_CHUNK_WAVES * grid // per_b))
    chunks = -(-b // want)
    chunk_b = -(-b // chunks)
    full = b // chunk_b
    c = np.minimum(t // (chunk_b * per_b), full)
    nb = np.where(c < full, chunk_b, b - full * chunk_b)
    u = t - c * chunk_b * per_b
    bh = u % (nb * h)
    q0 = (n_qt - 1 - u // (nb * h)) * TILE_ROWS
    return "causal", np.stack([q0, c * chunk_b + bh // h, bh % h], axis=1)


def schedule_balance(tiles: np.ndarray, lengths, causal: bool, grid: int = H100_SMS) -> float:
    """The busiest persistent block's key blocks over the mean block's, for
    :func:`tile_schedule`'s ``tiles`` at per-sequence ``lengths``: the share
    of a launch's time the tile order adds past an even split."""
    lengths = np.asarray(lengths)
    q0, bat = tiles[:, 0], tiles[:, 1]
    limit = np.minimum(lengths[bat], q0 + TILE_ROWS) if causal else lengths[bat]
    work = -(-limit // TILE_ROWS)
    g = min(grid, len(tiles))
    per = np.bincount(np.arange(len(tiles)) % g, weights=work, minlength=g)
    return float(per.max() / per.mean()) if per.mean() > 0 else 1.0


_FLASH_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]


def _flash_lib():
    fn = kernels.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = _FLASH_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def check_strided_operand(name: str, t: torch.Tensor) -> None:
    """Raise unless kernel B can read ``t`` (B, heads, S, dh) through its
    strides: a contiguous head dim, every other stride a positive multiple
    of 16 bytes and a 16-byte aligned start. bf16 operands are read by TMA
    tensor maps, which require exactly that (a broadcast, stride-0 view is
    refused); f32 rows are read as 16-byte vectors."""
    vec = 16 // t.element_size()
    if t.stride(3) != 1 or any(st <= 0 or st % vec for st in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(
            f"{name} needs a contiguous head dim, positive strides that are multiples of "
            f"16 bytes and a 16-byte aligned start; got strides {tuple(t.stride())}"
        )


def attention_flash(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    *,
    causal: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel B: flash attention. CPU tensors take
    :func:`attention_flash_plain`; CUDA tensors launch the kernel, which
    takes bf16 (the TMA + wgmma kernel) or f32 (a SIMT kernel), all alike,
    dh 64 or 128, strides as :func:`check_strided_operand` allows, int32
    ``lengths`` (B,) and int32 ``segment_ids`` (B, S). The output has q's
    shape and dtype, in (B, S, H, dh) storage. Causal launches (the Qwen3
    encoder's) count under ``flash_attention_causal``."""
    if q.device.type == "cpu":
        return attention_flash_plain(q, k, v, lengths, causal=causal, segment_ids=segment_ids)
    if q.device.type != "cuda":
        raise ValueError(f"attention_flash: unsupported device {q.device}")
    b, h, s, dh = q.shape
    kvh = k.shape[1]
    if k.shape != (b, kvh, s, dh) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if h % kvh:
        raise ValueError(f"q heads {h} not a multiple of kv heads {kvh}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention_flash takes bf16 or f32 q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if dh not in (64, 128):
        raise ValueError(f"attention_flash takes head dim 64 or 128, got {dh}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        check_strided_operand(name, t)
    if lengths.shape != (b,) or lengths.dtype != torch.int32 or lengths.device != q.device:
        raise ValueError("lengths must be (B,) int32 on q's device")
    lengths = lengths.contiguous()
    seg_ptr = None
    if segment_ids is not None:
        if segment_ids.shape != (b, s) or segment_ids.dtype != torch.int32 or segment_ids.device != q.device:
            raise ValueError("segment_ids must be (B, S) int32 on q's device")
        segment_ids = segment_ids.contiguous()
        seg_ptr = segment_ids.data_ptr()
    # (B, S, H, dh) storage returned as a (B, H, S, dh) view: the caller's
    # merge of heads back into (B, S, H*dh) is then free
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    rc = kernels.launch(
        _flash_lib(), q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lengths.data_ptr(),
        seg_ptr, b, h, kvh, s, dh, strides, int(causal), int(q.dtype == torch.bfloat16),
    )
    kernels.check(rc, "flash_attention")
    kernels.LAUNCHES["flash_attention_causal" if causal else "flash_attention"] += 1
    return out


def multi_head_attention(
    q: torch.Tensor,  # (B, S, H*dh)
    k: torch.Tensor,
    v: torch.Tensor,
    attention_mask: torch.Tensor,  # (B, S) 1 = valid, contiguous prefix
    *,
    num_heads: int,
    use_flash: bool = True,
    causal: bool = False,
    flash_min_seq: Optional[int] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Self-attention over packed (B, S, D) projections.

    The mask is reduced to per-sequence lengths. Dispatch is length-aware:
    the flash kernel takes S > ``flash_min_seq`` (or S >= it for packed
    rows, which are always full); shorter inputs take
    :func:`attention_xla`. ``flash_min_seq`` defaults to the tuned store's
    ``flash.min_seq`` (``tune``), else :data:`FLASH_MIN_SEQ`."""
    if flash_min_seq is None:
        flash_min_seq = int(autotune.get_tuned("flash.min_seq"))
    b, s, d = q.shape
    dh = d // num_heads

    def split(x):
        return x.reshape(b, s, -1, dh).transpose(1, 2)

    lengths = attention_mask.to(torch.int32).sum(dim=1, dtype=torch.int32)
    qh, kh, vh = split(q), split(k), split(v)
    want_flash = s > flash_min_seq or (segment_ids is not None and s >= flash_min_seq)
    if use_flash and want_flash:
        out = attention_flash(qh, kh, vh, lengths, causal=causal, segment_ids=segment_ids)
    else:
        out = attention_xla(qh, kh, vh, lengths, causal=causal, segment_ids=segment_ids)
    return out.transpose(1, 2).reshape(b, s, d)
