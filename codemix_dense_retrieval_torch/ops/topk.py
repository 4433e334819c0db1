"""Exact inner-product top-k over a dense embedding shard: the bin-max
cover algorithm.

1. *Fused pass* (:func:`bin_scores`, a CUDA kernel on the card) computes the
   score matrix ``Q @ D^T`` with f32 accumulation, masks rows at or past
   ``n_valid`` to ``NEG_INF`` and reduces each run of ``G`` consecutive rows
   to its maximum ("bin max").
2. *Cover selection* picks the ``k`` best bins per query (two levels for big
   shards: ``k`` super-bins of ``M`` bins first). **Exactness**: for any true
   top-k element x in bin b, every bin ranked above b either has a max above
   score(x), and so holds one of the at most k-1 elements above x, or ties
   b's max with a lower bin id, whose max element also outranks x under
   (score desc, id asc). So b is among the k selected bins.
3. *Candidate select* gathers the k*G candidate scores and keeps the top k
   by (score desc, id asc).

On the card a bf16 or f16 index takes the two-level cover without a score
matrix (:func:`rescores_cover`): phase 1 is kernel 5
(:func:`binmax_only`), which writes the bin maxima alone, and step 3 reads
the candidates' scores from :func:`cover_rescore`, a kernel that sums each
covered row's score with kernel A's instruction, operand roles and chunk
order. Its scores are the values kernel A would have stored, bit for bit,
and kernel 5's maxima are kernel A's, so the argument above holds unchanged
and the results equal the stored route's. f32 and int8 indexes and CPU
tensors keep the stored route.

The two-level cover's super level (each query's best k + 1 super maxima and
the first k of their ids) is :func:`super_select` on the card: one
hand-written pass over the bin maxima that returns what a reshape-max and a
stable sort of the whole row return, bit for bit, for every route that
selects two levels, at any depth (CPU tensors keep the plain version; the
card raises on bin maxima the kernel does not take).

Two variants share the cover. Over an int8 index (:func:`topk_ip_bins_int8`)
phase 1 is kernel 4 (:func:`bin_scores_int8`): exact int8 products rescaled
per row, queries quantized on the device. The rescore search
(:func:`topk_ip_bins_rescore`, :func:`topk_ip_rescore_two_level`) runs
kernel 5, then gathers the covered bins' doc rows and recomputes their
scores in plain f32 products, in another order than the kernel, with slack
bins for the round-off at the cover boundary.

A shard's exact route is decided here and nowhere else: :func:`shard_topk`
takes its method, bin size and queries per launch (:func:`_tile_b`), and
:func:`block_bytes_per_row` says what its phase 1 holds on the card per
query; ``parallel/sharded_search.py`` places, launches and merges shards.

Tie-break: every selection is a STABLE descending sort followed by a slice,
over domains whose positions ascend with the ids (selected bin ids are
re-sorted ascending at each level), so among equal scores the lower id wins
at every level, the cover boundary included. ``torch.topk`` promises no
order among ties and is not used for selection.

While tracing (:mod:`~codemix_dense_retrieval_torch.utils.timing`) the
exact routes (two-level and single-level cover, bf16 / f16 / f32 and int8)
time each query chunk's phase 1 and tail on the card as the spans
``search.phase1`` and ``search.tail``; inside the tail, the route without a
score matrix times :func:`cover_rescore` as ``search.rescore`` and counts
the rows it scores under ``search.rescored_rows``, and every two-level
selection times its super level as ``search.select`` and counts queries x
supers kept under ``search.selected_supers``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from codemix_dense_retrieval_torch.ops import kernels
from codemix_dense_retrieval_torch.ops.quant import int8_ip_acc_rows, int8_ip_scores, quantize_rows
from codemix_dense_retrieval_torch.utils import autotune, timing

NEG_INF = float(np.finfo(np.float32).min)

#: Routing constants: the JAX package's measured defaults, carried over for
#: parity (re-deriving them on the H100 is a ROADMAP item). The cover's G,
#: M and tile_b come from the tuned store (:mod:`~codemix_dense_retrieval_torch.utils.autotune`).
FULL_SORT_MAX_ROWS = 16_384     # topk_ip(method="auto"): below -> full sort
TWO_LEVEL_MIN_ROWS = 262_144    # at or above -> two-level cover
TILE_B = 256                    # queries per phase-1 launch unless told otherwise

#: the methods :func:`shard_topk` takes
SHARD_METHODS = ("auto", "full", "bins_xla", "bins_pallas", "bins_two_level")
LAYOUTS = ("bin_major", "transposed")
Rows = Union[int, torch.Tensor]


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _auto_bin_size(k: int) -> int:
    """Single-level bin size: candidates scale as k*G, so deeper k favors
    smaller bins."""
    return 8 if k > 200 else 16


def _auto_bin_size_two_level(k: int) -> int:
    """Two-level cover bin size G: the tuned store's ``topk.bin_size[.k<k>]``
    (``tune`` persists it per depth), else 8."""
    return int(autotune.get_tuned("topk.bin_size", k=k, default=8))


def _auto_super_size(k: int) -> int:
    """Super-bin size M: the tuned store's ``topk.super_size[.k<k>]``."""
    return int(autotune.get_tuned("topk.super_size", k=k))


def _tile_b(tile_b: Optional[int], k: int, *, two_level: bool) -> int:
    """Queries per phase-1 launch, the one rule of every exact route:
    ``tile_b`` if given; else on the two-level cover the tuned store's
    ``topk.tile_b[.k<k>]``, which was measured there; else ``TILE_B``. The
    JAX package clamps tuned values above 512 on shards under 1.1M rows, a
    limit of the TPU compiler's scoped VMEM; the card has none, so the port
    does not."""
    if tile_b is not None:
        return int(tile_b)
    if two_level:
        return int(autotune.get_tuned("topk.tile_b", k=k, default=TILE_B))
    return TILE_B


def _shard_method(rows: int) -> str:
    """The method ``auto`` takes on a shard of ``rows`` padded rows."""
    return "bins_two_level" if rows >= TWO_LEVEL_MIN_ROWS else "bins_pallas"


# --------------------------------------------------------------------------
# phase 1: fused scores + bin maxima (kernel A and its plain version)
# --------------------------------------------------------------------------

_PLAIN_ROW_CHUNK = 262_144


def _rows_int(n_valid: Rows) -> int:
    return int(n_valid.reshape(-1)[0]) if isinstance(n_valid, torch.Tensor) else int(n_valid)


def _mask_bin_max(
    scores: torch.Tensor, n_valid: Rows, bin_size: int, layout: str, score_dtype: torch.dtype
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain versions' epilogue on f32 scores (B, N): ``NEG_INF`` at
    rows >= ``n_valid``, bin maxima of the f32 scores, then the score cast
    and the layout."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    b, n = scores.shape
    if n % bin_size:
        raise ValueError(f"rows {n} not a multiple of bin_size {bin_size}")
    nv = _rows_int(n_valid)
    if nv < n:
        scores[:, max(nv, 0):] = NEG_INF
    bin_max = scores.view(b, n // bin_size, bin_size).amax(dim=2)
    scores = scores.to(score_dtype)
    if layout == "transposed":
        return scores.T.contiguous(), bin_max.T.contiguous()
    return scores, bin_max


def bin_scores_plain(
    queries: torch.Tensor,
    docs: torch.Tensor,
    n_valid: Rows,
    bin_size: int,
    *,
    layout: str = "bin_major",
    score_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`bin_scores`, on any device: f32
    products of the given values (rows processed in chunks so no f32 copy of
    the whole shard exists), the ``NEG_INF`` mask, the bin maxima of the f32
    scores, then the score cast and the layout."""
    b, n = queries.shape[0], docs.shape[0]
    qf = queries.to(torch.float32)
    scores = torch.empty((b, n), dtype=torch.float32, device=docs.device)
    for r0 in range(0, n, _PLAIN_ROW_CHUNK):
        r1 = min(r0 + _PLAIN_ROW_CHUNK, n)
        torch.matmul(qf, docs[r0:r1].to(torch.float32).T, out=scores[:, r0:r1])
    return _mask_bin_max(scores, n_valid, bin_size, layout, score_dtype)


#: the index dtypes kernels A, 2 and 5 take on the card
FLOAT_INDEX_DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def _cuda_operands(
    name: str, queries: torch.Tensor, docs: torch.Tensor, dtypes: Sequence[torch.dtype],
    bin_size: int, dim_multiple: int,
) -> Tuple[int, int, int]:
    """Validate a bin kernel's operands on the card (the index one of
    ``dtypes``, the queries of the index dtype); returns (B, d, N)."""
    if docs.device.type != "cuda" or queries.device != docs.device:
        raise ValueError(
            f"{name}: queries on {queries.device}, docs on {docs.device}; "
            "both must be on the same CUDA device (or both on the CPU)"
        )
    dtype = docs.dtype
    if dtype not in dtypes:
        raise ValueError(f"{name} on CUDA takes a {' / '.join(map(str, dtypes))} index, got {dtype}")
    if queries.dtype != dtype:
        raise ValueError(f"{name}: queries must be {dtype} like the index, got {queries.dtype}")
    if queries.ndim != 2 or docs.ndim != 2 or queries.shape[1] != docs.shape[1]:
        raise ValueError(f"shapes {tuple(queries.shape)} x {tuple(docs.shape)} do not contract")
    b, dim = queries.shape
    n = docs.shape[0]
    if bin_size not in (8, 16):
        raise ValueError(f"the CUDA kernel takes bin_size 8 or 16, got {bin_size}")
    if dim % dim_multiple or n % bin_size or b == 0:
        raise ValueError(
            f"the CUDA kernel needs d % {dim_multiple} == 0, N % G == 0, B > 0 "
            f"(d={dim}, N={n}, B={b})"
        )
    for label, t in (("queries", queries), ("docs", docs)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{label} must be contiguous and 16-byte aligned")
    return b, dim, n


def _n_valid_arg(n_valid: Rows, docs: torch.Tensor) -> Tuple[Optional[int], int]:
    """(device pointer, 0) for a one-element int32 tensor, else (None, int)."""
    if isinstance(n_valid, torch.Tensor):
        if (n_valid.device != docs.device or n_valid.dtype != torch.int32
                or n_valid.numel() != 1 or not n_valid.is_contiguous()):
            raise ValueError("n_valid tensor must be one contiguous int32 on the docs' device")
        return n_valid.data_ptr(), 0
    return None, int(n_valid)


def tf32_split_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`tf32_split`: the (2, *x.shape) f32 planes hi =
    tf32(x) and lo = tf32(x - hi), each rounded to 10 fraction bits to
    nearest with ties away from zero (``cvt.rna.tf32.f32``) by adding half a
    tf32 ulp to the magnitude's bits and clearing the 13 bits below it."""

    def rna(v: torch.Tensor) -> torch.Tensor:
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    x = x.to(torch.float32)
    hi = rna(x)
    return torch.stack([hi, rna(x - hi)])


_TF32_SPLIT_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]


def tf32_split(x: torch.Tensor) -> torch.Tensor:
    """The 3xTF32 split of f32 operands that the f32 bin kernels (A, 2, 5
    and 7 in ``csrc/bin_scores_f32.cu``) take for their queries, made once
    per call instead of once per doc tile: (2, *x.shape) f32, hi then lo.
    CPU tensors take :func:`tf32_split_plain`; CUDA tensors (contiguous,
    16-byte aligned, numel % 4 == 0) launch ``tf32_split_kernel``, as part
    of the kernel launch it feeds (no launch count of its own)."""
    if x.device.type == "cpu":
        return tf32_split_plain(x)
    if x.dtype != torch.float32 or not x.is_contiguous() or x.data_ptr() % 16 or x.numel() % 4:
        raise ValueError("tf32_split takes a contiguous, 16-byte aligned f32 tensor of numel % 4 == 0")
    out = torch.empty((2, *x.shape), dtype=torch.float32, device=x.device)
    fn = kernels.load("bin_scores_f32").tf32_split_launch
    if fn.argtypes is None:
        fn.argtypes = _TF32_SPLIT_ARGTYPES
        fn.restype = ctypes.c_int
    kernels.check(kernels.launch(fn, x.device, x.data_ptr(), out.data_ptr(), x.numel()), "tf32_split")
    return out


def _kernel_queries(queries: torch.Tensor) -> torch.Tensor:
    """The query operand of a float bin kernel's C entry: the f32 kernels
    (both layouts) take the queries' tf32 split (:func:`tf32_split`), the
    bf16 and f16 ones the queries."""
    return tf32_split(queries) if queries.dtype == torch.float32 else queries


_BIN_SCORES_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]


def _bin_scores_lib(dtype: torch.dtype):
    fn = kernels.load("bin_scores" + kernels.dtype_suffix(dtype)).bin_scores_launch
    if fn.argtypes is None:
        fn.argtypes = _BIN_SCORES_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def bin_scores(
    queries: torch.Tensor,
    docs: torch.Tensor,
    n_valid: Rows,
    bin_size: int,
    *,
    layout: str = "bin_major",
    score_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernels A and 2: fused scores and bin maxima of ``queries`` (B, d)
    against ``docs`` (N, d), rows at or past ``n_valid`` (an int or a
    one-element int32 tensor on the docs' device) set to ``NEG_INF``.

    ``layout="bin_major"`` (kernel A) returns (scores (B, N) ``score_dtype``,
    binmax (B, N/G) f32); ``"transposed"`` (kernel 2) returns (N, B) and
    (N/G, B). CPU tensors take :func:`bin_scores_plain`; CUDA tensors launch
    the kernel instance of the index dtype (``csrc/bin_scores.cu`` bf16,
    ``bin_scores_f16.cu``, ``bin_scores_f32.cu``: f32-faithful 3xTF32), which
    takes queries of the index dtype, d % 32 == 0, N % G == 0 and G in
    {8, 16}."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if queries.device.type == "cpu" and docs.device.type == "cpu":
        return bin_scores_plain(
            queries, docs, n_valid, bin_size, layout=layout, score_dtype=score_dtype
        )
    b, dim, n = _cuda_operands("bin_scores", queries, docs, FLOAT_INDEX_DTYPES, bin_size, 32)
    if score_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"score_dtype must be float32 or bfloat16, got {score_dtype}")
    nv_ptr, nv_int = _n_valid_arg(n_valid, docs)
    bin_major = layout == "bin_major"
    nb = n // bin_size
    scores = torch.empty((b, n) if bin_major else (n, b), dtype=score_dtype, device=docs.device)
    binmax = torch.empty((b, nb) if bin_major else (nb, b), dtype=torch.float32, device=docs.device)
    q_arg = _kernel_queries(queries)
    rc = kernels.launch(
        _bin_scores_lib(docs.dtype), docs.device,
        q_arg.data_ptr(), docs.data_ptr(), scores.data_ptr(), binmax.data_ptr(),
        nv_ptr, nv_int, b, n, dim, bin_size, int(bin_major),
        int(score_dtype == torch.bfloat16),
    )
    kernels.check(rc, "bin_scores")
    kernels.LAUNCHES[f"bin_scores_{layout}{kernels.dtype_suffix(docs.dtype)}"] += 1
    return scores, binmax


# --------------------------------------------------------------------------
# phase 1 over an int8 index (kernel 4 and its plain version)
# --------------------------------------------------------------------------

def bin_scores_int8_plain(
    q_vals: torch.Tensor,
    q_scales: torch.Tensor,
    d_vals: torch.Tensor,
    d_scales: torch.Tensor,
    n_valid: Rows,
    bin_size: int,
    *,
    layout: str = "bin_major",
    score_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`bin_scores_int8`, on any device:
    exact integer products (:func:`~codemix_dense_retrieval_torch.ops.quant.int8_ip_scores`,
    rows in chunks), ``(acc * d_scale) * q_scale``, the ``NEG_INF`` mask and
    the bin maxima; bit-identical to the kernel."""
    b, n = q_vals.shape[0], d_vals.shape[0]
    scores = torch.empty((b, n), dtype=torch.float32, device=d_vals.device)
    for r0 in range(0, n, _PLAIN_ROW_CHUNK):
        r1 = min(r0 + _PLAIN_ROW_CHUNK, n)
        scores[:, r0:r1] = int8_ip_scores(q_vals, q_scales, d_vals[r0:r1], d_scales[r0:r1])
    return _mask_bin_max(scores, n_valid, bin_size, layout, score_dtype)


_BIN_SCORES_INT8_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]


def _bin_scores_int8_lib():
    fn = kernels.load("bin_scores_int8").bin_scores_int8_launch
    if fn.argtypes is None:
        fn.argtypes = _BIN_SCORES_INT8_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check_scales(name: str, scales: torch.Tensor, rows: torch.Tensor) -> None:
    if (scales.device != rows.device or scales.dtype != torch.float32
            or scales.shape != (rows.shape[0],) or not scales.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous f32 ({rows.shape[0]},) tensor on {rows.device}, "
            f"got {scales.dtype} {tuple(scales.shape)} on {scales.device}"
        )


def bin_scores_int8(
    q_vals: torch.Tensor,
    q_scales: torch.Tensor,
    d_vals: torch.Tensor,
    d_scales: torch.Tensor,
    n_valid: Rows,
    bin_size: int,
    *,
    layout: str = "bin_major",
    score_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 4: fused int8 scores and bin maxima. ``q_vals`` (B, d) and
    ``d_vals`` (N, d) are int8 with per-row f32 scales; scores are
    ``(f32(acc) * d_scale) * q_scale`` with rows at or past ``n_valid`` set
    to ``NEG_INF``. Layouts and outputs as :func:`bin_scores`. CPU tensors
    take :func:`bin_scores_int8_plain`; CUDA tensors launch the kernel
    (``csrc/bin_scores_int8.cu``), which takes d % 64 == 0, N % G == 0 and
    G in {8, 16}."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if q_vals.device.type == "cpu" and d_vals.device.type == "cpu":
        return bin_scores_int8_plain(
            q_vals, q_scales, d_vals, d_scales, n_valid, bin_size,
            layout=layout, score_dtype=score_dtype,
        )
    b, dim, n = _cuda_operands("bin_scores_int8", q_vals, d_vals, (torch.int8,), bin_size, 64)
    _check_scales("q_scales", q_scales, q_vals)
    _check_scales("d_scales", d_scales, d_vals)
    if score_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"score_dtype must be float32 or bfloat16, got {score_dtype}")
    nv_ptr, nv_int = _n_valid_arg(n_valid, d_vals)
    bin_major = layout == "bin_major"
    nb = n // bin_size
    dev = d_vals.device
    scores = torch.empty((b, n) if bin_major else (n, b), dtype=score_dtype, device=dev)
    binmax = torch.empty((b, nb) if bin_major else (nb, b), dtype=torch.float32, device=dev)
    rc = kernels.launch(
        _bin_scores_int8_lib(), dev,
        q_vals.data_ptr(), q_scales.data_ptr(), d_vals.data_ptr(), d_scales.data_ptr(),
        scores.data_ptr(), binmax.data_ptr(), nv_ptr, nv_int, b, n, dim, bin_size,
        int(bin_major), int(score_dtype == torch.bfloat16),
    )
    kernels.check(rc, "bin_scores_int8")
    kernels.LAUNCHES[f"bin_scores_int8_{layout}"] += 1
    return scores, binmax


# --------------------------------------------------------------------------
# phase 1 without the score matrix (kernel 5 and its plain version)
# --------------------------------------------------------------------------

def binmax_only_plain(
    queries: torch.Tensor, docs: torch.Tensor, n_valid: Rows, bin_size: int
) -> torch.Tensor:
    """Plain PyTorch version of :func:`binmax_only`, on any device: the bin
    maxima (B, N/G) of the masked f32 products, one chunk of rows at a time
    (no (B, N) score matrix)."""
    b, n = queries.shape[0], docs.shape[0]
    if n % bin_size:
        raise ValueError(f"rows {n} not a multiple of bin_size {bin_size}")
    nv = _rows_int(n_valid)
    qf = queries.to(torch.float32)
    binmax = torch.empty((b, n // bin_size), dtype=torch.float32, device=docs.device)
    for r0 in range(0, n, _PLAIN_ROW_CHUNK):
        r1 = min(r0 + _PLAIN_ROW_CHUNK, n)
        s = qf @ docs[r0:r1].to(torch.float32).T
        if nv < r1:
            s[:, max(nv - r0, 0):] = NEG_INF
        binmax[:, r0 // bin_size : r1 // bin_size] = s.view(b, -1, bin_size).amax(dim=2)
    return binmax


_BINMAX_ONLY_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]


def _binmax_only_lib(dtype: torch.dtype):
    fn = kernels.load("bin_scores" + kernels.dtype_suffix(dtype)).binmax_only_launch
    if fn.argtypes is None:
        fn.argtypes = _BINMAX_ONLY_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def binmax_only(
    queries: torch.Tensor, docs: torch.Tensor, n_valid: Rows, bin_size: int
) -> torch.Tensor:
    """Kernel 5: the bin maxima (B, N/G) f32 of ``queries @ docs.T`` with
    rows at or past ``n_valid`` set to ``NEG_INF``; the score matrix is
    never stored. CPU tensors take :func:`binmax_only_plain`; CUDA tensors
    launch kernel A's instance of the index dtype with its score store
    compiled out, with kernel A's requirements."""
    if queries.device.type == "cpu" and docs.device.type == "cpu":
        return binmax_only_plain(queries, docs, n_valid, bin_size)
    b, dim, n = _cuda_operands("binmax_only", queries, docs, FLOAT_INDEX_DTYPES, bin_size, 32)
    nv_ptr, nv_int = _n_valid_arg(n_valid, docs)
    binmax = torch.empty((b, n // bin_size), dtype=torch.float32, device=docs.device)
    q_arg = _kernel_queries(queries)
    rc = kernels.launch(
        _binmax_only_lib(docs.dtype), docs.device,
        q_arg.data_ptr(), docs.data_ptr(), binmax.data_ptr(), nv_ptr, nv_int,
        b, n, dim, bin_size,
    )
    kernels.check(rc, "binmax_only")
    kernels.LAUNCHES["binmax_only" + kernels.dtype_suffix(docs.dtype)] += 1
    return binmax


# --------------------------------------------------------------------------
# the covered rows' scores without the score matrix (cover_rescore)
# --------------------------------------------------------------------------

#: the index dtypes ``cover_rescore`` takes on the card: those whose kernel A
#: sums in the same wgmma it reproduces (the f32 instances split operands
#: into tf32 parts in registers)
RESCORE_DTYPES = (torch.bfloat16, torch.float16)
#: the widest rows ``cover_rescore`` takes: the query's chunks stay in shared
#: memory beside the ring of gathered rows
RESCORE_MAX_DIM = 8192


def rescores_cover(docs) -> bool:
    """Whether :func:`topk_ip_bins_two_level` over ``docs`` (anything with
    ``device``, ``dtype`` and ``shape``) runs without a score matrix: kernel
    5's bin maxima, then :func:`cover_rescore`. So it does for a bf16 or f16
    index on a CUDA card with rows of at most ``RESCORE_MAX_DIM`` dims; f32
    and int8 indexes and CPU tensors keep kernel A's store."""
    return (
        docs.device.type == "cuda" and docs.dtype in RESCORE_DTYPES
        and docs.shape[1] <= RESCORE_MAX_DIM
    )


#: card bytes one query of a block takes per padded index row where phase 1
#: stores its scores: its f32 score row and its bin maxima at the smallest
#: bin (G = 8)
BLOCK_BYTES_PER_ROW = 4 + 4 / 8
#: the same where phase 1 writes the bin maxima alone (:func:`rescores_cover`)
BLOCK_BYTES_PER_ROW_BINMAX = 4 / 8


def block_bytes_per_row(shard: Union[torch.device, str, torch.Tensor]) -> float:
    """Card bytes one query takes per padded row of ``shard`` (a shard's
    tensor, or anything with its ``device``, ``dtype`` and ``shape``) in
    phase 1 of :func:`shard_topk`'s ``auto`` route:
    ``BLOCK_BYTES_PER_ROW_BINMAX`` where that is the two-level cover
    without a score matrix, else ``BLOCK_BYTES_PER_ROW``, which a bare
    device also counts."""
    if isinstance(shard, (torch.device, str)):
        return BLOCK_BYTES_PER_ROW
    if _shard_method(shard.shape[0]) == "bins_two_level" and rescores_cover(shard):
        return BLOCK_BYTES_PER_ROW_BINMAX
    return BLOCK_BYTES_PER_ROW


def _check_cover_operands(
    queries: torch.Tensor, docs: torch.Tensor, bin_ids: torch.Tensor, bin_size: int
) -> None:
    """The operands :func:`cover_rescore` takes on any device: queries (B, d)
    of the index dtype, int64 bin ids (B, kb) with 1 <= kb <= N/G, all on
    one device; bin ids sorted ascending and distinct, each in [0, N/G), is
    checked here for CPU tensors and by the kernel on the card (no host
    read)."""
    if not (queries.device == docs.device == bin_ids.device):
        raise ValueError(
            f"cover_rescore: queries on {queries.device}, docs on {docs.device}, "
            f"bin ids on {bin_ids.device}; all must be on one device"
        )
    if not docs.dtype.is_floating_point or queries.dtype != docs.dtype:
        raise ValueError(
            f"cover_rescore takes a float index and queries of its dtype, got {docs.dtype} / {queries.dtype}"
        )
    if bin_ids.dtype != torch.int64:
        raise ValueError(f"cover_rescore: bin ids must be int64, got {bin_ids.dtype}")
    if queries.ndim != 2 or docs.ndim != 2 or queries.shape[1] != docs.shape[1]:
        raise ValueError(f"shapes {tuple(queries.shape)} x {tuple(docs.shape)} do not contract")
    n = docs.shape[0]
    if bin_size <= 0 or n % bin_size:
        raise ValueError(f"rows {n} not a multiple of bin_size {bin_size}")
    nb = n // bin_size
    if bin_ids.ndim != 2 or bin_ids.shape[0] != queries.shape[0] or not 1 <= bin_ids.shape[1] <= nb:
        raise ValueError(f"bin ids {tuple(bin_ids.shape)} must be (B={queries.shape[0]}, kb) with 1 <= kb <= {nb}")
    if docs.device.type == "cpu":
        if bool((bin_ids[:, 1:] <= bin_ids[:, :-1]).any()):
            raise ValueError("cover_rescore: bin ids must be sorted ascending and distinct per query")
        if bool(((bin_ids < 0) | (bin_ids >= nb)).any()):
            raise ValueError(f"cover_rescore: bin ids must lie in [0, {nb})")


def cover_rescore_plain(
    queries: torch.Tensor, docs: torch.Tensor, bin_ids: torch.Tensor, bin_size: int, n_valid: Rows
) -> torch.Tensor:
    """Plain PyTorch version of :func:`cover_rescore`, on any device: the
    covered rows gathered and scored as f32 products (in another order than
    kernel A's), ``NEG_INF`` at rows >= ``n_valid``."""
    b, kb = bin_ids.shape
    cand_idx = _expand_ids(bin_ids, bin_size)
    rows = docs.index_select(0, cand_idx.reshape(-1)).reshape(b, kb * bin_size, -1)
    scores = torch.bmm(rows.to(torch.float32), queries.to(torch.float32)[:, :, None])[:, :, 0]
    return torch.where(cand_idx < n_valid, scores, NEG_INF)


_COVER_RESCORE_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
]


def _cover_rescore_lib():
    fn = kernels.load("cover_rescore").cover_rescore_launch
    if fn.argtypes is None:
        fn.argtypes = _COVER_RESCORE_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def cover_rescore(
    queries: torch.Tensor, docs: torch.Tensor, bin_ids: torch.Tensor, bin_size: int, n_valid: Rows
) -> torch.Tensor:
    """The (B, kb * G) f32 scores of the rows that ``bin_ids`` (B, kb)
    covers, bin ``bin_ids[b, j]``'s row i at column j * G + i, ``NEG_INF``
    at rows >= ``n_valid`` (an int or a one-element int32 tensor on the
    docs' device). CPU tensors take :func:`cover_rescore_plain`; CUDA
    tensors launch ``csrc/cover_rescore.cu``, whose scores equal kernel A's
    stored ones bit for bit (a bf16 or f16 index, d % 32 == 0, d <=
    ``RESCORE_MAX_DIM``, G in {8, 16}, contiguous operands)."""
    _check_cover_operands(queries, docs, bin_ids, bin_size)
    if docs.device.type == "cpu":
        return cover_rescore_plain(queries, docs, bin_ids, bin_size, n_valid)
    b, dim, n = _cuda_operands("cover_rescore", queries, docs, RESCORE_DTYPES, bin_size, 32)
    if dim > RESCORE_MAX_DIM or not bin_ids.is_contiguous():
        raise ValueError(
            f"cover_rescore takes d <= {RESCORE_MAX_DIM} (got {dim}) and contiguous bin ids"
        )
    nv_ptr, nv_int = _n_valid_arg(n_valid, docs)
    kb = bin_ids.shape[1]
    out = torch.empty((b, kb * bin_size), dtype=torch.float32, device=docs.device)
    rc = kernels.launch(
        _cover_rescore_lib(), docs.device,
        queries.data_ptr(), docs.data_ptr(), bin_ids.data_ptr(), out.data_ptr(), nv_ptr, nv_int,
        b, n, dim, kb, bin_size, RESCORE_DTYPES.index(docs.dtype),
    )
    kernels.check(rc, "cover_rescore")
    kernels.LAUNCHES["cover_rescore" + kernels.dtype_suffix(docs.dtype)] += 1
    return out


# --------------------------------------------------------------------------
# selection helpers
# --------------------------------------------------------------------------

def _stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k along dim 1 by value descending, lower position first among
    ties (stable sort, then slice)."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _expand_ids(ids: torch.Tensor, width: int) -> torch.Tensor:
    """(B, m) group ids -> (B, m*width) member ids ``id*width + j``."""
    b, m = ids.shape
    offs = torch.arange(width, device=ids.device, dtype=ids.dtype)
    return (ids[:, :, None] * width + offs).reshape(b, m * width)


def _prep_shard(
    k: int, n_valid: Optional[Rows], tile_n: int, doc_arrays: Sequence[torch.Tensor],
    chunk: Optional[int] = None,
) -> Tuple[List[torch.Tensor], Rows]:
    """The ``k > n_valid`` fail-fast and the zero padding of the row axis of
    every doc array (the rows, and for an int8 shard its per-row scales) to
    the lcm of ``tile_n`` and the two-level ``chunk`` (G*M), so the
    two-level tail sees nb % M == 0. The kernels take any batch, so queries
    are not padded. A shard that is already a multiple is not copied."""
    n_rows = doc_arrays[0].shape[0]
    if n_valid is None:
        n_valid = n_rows
    if isinstance(n_valid, int) and k > n_valid:
        raise ValueError(f"k={k} > num docs {n_valid}")
    lcm_tile = tile_n if chunk is None else tile_n * chunk // math.gcd(tile_n, chunk)
    n_pad = _ceil_to(n_rows, lcm_tile)
    arrays = list(doc_arrays)
    if n_pad != n_rows:
        arrays = [
            torch.nn.functional.pad(a, (0, 0) * (a.ndim - 1) + (0, n_pad - n_rows))
            for a in arrays
        ]
        if isinstance(n_valid, int):
            n_valid = min(n_valid, n_rows)
    return arrays, n_valid


def _by_query_chunks(
    queries: torch.Tensor, tile_b: int,
    fn: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run phase 1 + tail on at most ``tile_b`` queries at a time: one
    launch's phase-1 output is the peak memory, the (tile_b, N) score matrix
    where the route stores one, else the (tile_b, N/G) bin maxima."""
    outs = [fn(queries[i : i + tile_b]) for i in range(0, queries.shape[0], tile_b)]
    if len(outs) == 1:
        return outs[0]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


# --------------------------------------------------------------------------
# full-sort path (small N)
# --------------------------------------------------------------------------

def topk_ip_full(
    queries: torch.Tensor, docs: torch.Tensor, k: int, *, n_valid: Optional[Rows] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k via the full f32 score matrix and a stable sort; for small
    shards. Rows at or past ``n_valid`` (an int or a one-element tensor on
    the docs' device) score ``NEG_INF``."""
    if k > docs.shape[0]:
        raise ValueError(f"k={k} > num docs {docs.shape[0]}")
    scores = queries.to(torch.float32) @ docs.to(torch.float32).T
    if n_valid is not None:
        col = torch.arange(docs.shape[0], device=docs.device)
        scores = torch.where(col[None, :] < n_valid, scores, NEG_INF)
    return _stable_topk(scores, k)


# --------------------------------------------------------------------------
# phase 2: bin cover -> candidate gather -> lexicographic select
# --------------------------------------------------------------------------

def _topk_from_bins(
    scores: torch.Tensor,
    bin_max: torch.Tensor,
    k: int,
    bin_size: int,
    *,
    scores_transposed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``bin_max`` is (B, num_bins); ``scores`` is (B, N) or, from the
    transposed kernel layout, (N, B)."""
    b, num_bins = bin_max.shape
    kb = min(k, num_bins)
    _, bin_ids = _stable_topk(bin_max, kb)
    bin_ids, _ = torch.sort(bin_ids, dim=1)
    cand_idx = _expand_ids(bin_ids, bin_size)
    if scores_transposed:
        cand_scores = torch.gather(scores, 0, cand_idx.T).T
    else:
        cand_scores = torch.gather(scores, 1, cand_idx)
    vals, pos = _stable_topk(cand_scores.to(torch.float32), k)
    return vals, torch.gather(cand_idx, 1, pos)


#: the most supers :func:`super_select`'s kernel sorts in shared memory
#: (``min(k_bins, ns) + 1``); above it the kernel sorts them in a buffer in
#: device memory, (B, the power of two at or above that) int64
SUPER_SELECT_MAX_K = 4096
#: the super sizes M it takes on the card: those whose ``amax`` on the card
#: gives each bin a lane of one shuffle tree, whose order the kernel repeats,
#: in 16-byte loads
SUPER_SELECT_SIZES = (4, 8, 16)


def _check_super_select(bin_max: torch.Tensor, k_bins: int, super_size: int) -> int:
    """The operands the super level takes on any device; returns ns."""
    if bin_max.ndim != 2 or bin_max.dtype != torch.float32:
        raise ValueError(f"super_select takes (B, nb) f32 bin maxima, got {bin_max.dtype} {tuple(bin_max.shape)}")
    b, nb = bin_max.shape
    if super_size <= 0 or nb % super_size or b == 0 or nb == 0:
        raise ValueError(f"{nb} bins not a multiple of super_size {super_size} (B={b})")
    if k_bins < 1:
        raise ValueError(f"k_bins must be >= 1, got {k_bins}")
    return nb // super_size


def _card_refusal(bin_max, super_size: int) -> Optional[str]:
    """Why the kernel does not take these bin maxima (passed
    :func:`_check_super_select`), or None where it does. ``bin_max``: a
    tensor, or anything with its ``device``, ``shape``, ``is_contiguous``
    and ``data_ptr``."""
    if bin_max.device.type != "cuda":
        return f"super_select runs on the CPU or a CUDA card, not {bin_max.device}"
    ns = bin_max.shape[1] // super_size
    if super_size not in SUPER_SELECT_SIZES:
        return f"super_select on CUDA takes M in {SUPER_SELECT_SIZES}, got {super_size}"
    if not bin_max.is_contiguous() or bin_max.data_ptr() % 16:
        return "super_select: bin maxima must be contiguous and 16-byte aligned"
    if ns >= 2**31 - 32:
        return f"super_select takes fewer than 2^31 - 32 supers a query, got {ns}"
    return None


def super_select_plain(
    bin_max: torch.Tensor, k_bins: int, super_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`super_select`, on any device: the
    super maxima by a reshape-max, a stable sort of the whole row, then the
    chosen ids sorted."""
    b, nb = bin_max.shape
    ns = nb // super_size
    super_max = bin_max.reshape(b, ns, super_size).amax(dim=2)
    ks = min(k_bins, ns)
    sup_vals, sup_ids = _stable_topk(super_max, ks + 1)
    sup_ids, _ = torch.sort(sup_ids[:, :ks], dim=1)
    return sup_vals, sup_ids


_SUPER_SELECT_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
]


def _super_select_lib():
    fn = kernels.load("super_select").super_select_launch
    if fn.argtypes is None:
        fn.argtypes = _SUPER_SELECT_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _super_select_cuda(bin_max: torch.Tensor, ks: int, super_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/super_select.cu`` on bin maxima it takes; ks =
    min(k_bins, ns)."""
    b, nb = bin_max.shape
    ns = nb // super_size
    kout = min(ks + 1, ns)
    dev = bin_max.device
    gmax = wide = None
    width = 1 << (kout - 1).bit_length()
    if kout <= SUPER_SELECT_MAX_K:
        gmax = torch.empty((b, -(-ns // 32)), dtype=torch.int32, device=dev)
    else:
        wide = torch.empty((b, width), dtype=torch.int64, device=dev)
    vals = torch.empty((b, kout), dtype=torch.float32, device=dev)
    ids = torch.empty((b, ks), dtype=torch.int64, device=dev)
    rc = kernels.launch(
        _super_select_lib(), bin_max.device,
        bin_max.data_ptr(), None if gmax is None else gmax.data_ptr(), vals.data_ptr(), ids.data_ptr(),
        None if wide is None else wide.data_ptr(), b, nb, super_size, ks, kout, width,
    )
    kernels.check(rc, "super_select")
    kernels.LAUNCHES["super_select"] += 1
    return vals, ids


def super_select(
    bin_max: torch.Tensor, k_bins: int, super_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The super level of the two-level cover over bin maxima (B, nb): with
    ns = nb / M supers of M bins and ks = min(k_bins, ns), returns
    ``(sup_vals, sup_ids)``: the min(ks + 1, ns) best super maxima per query
    in order (value desc, super id asc), (B, min(ks + 1, ns)) f32, and the
    first ks of their ids sorted ascending, (B, ks) int64. CPU tensors take
    :func:`super_select_plain`; CUDA tensors launch ``csrc/super_select.cu``,
    whose values and ids equal the plain version's on the card bit for bit
    (contiguous, 16-byte aligned f32, M in ``SUPER_SELECT_SIZES``, any
    k_bins); it raises on other operands."""
    ns = _check_super_select(bin_max, k_bins, super_size)
    if bin_max.device.type == "cpu":
        return super_select_plain(bin_max, k_bins, super_size)
    refusal = _card_refusal(bin_max, super_size)
    if refusal is not None:
        raise ValueError(refusal)
    return _super_select_cuda(bin_max, min(k_bins, ns), super_size)


def _select_bins_two_level(
    bin_max: torch.Tensor, k_bins: int, super_size: int, *,
    return_unselected_bound: bool = False,
):
    """Two-level bin selection over BIN-MAJOR maxima (B, nb): super-max
    reduce -> best ``k_bins`` supers -> their M-contiguous bin maxima -> best
    ``k_bins`` bins; returns the bin ids sorted ascending. The super level is
    :func:`super_select` (span ``search.select``, counter
    ``search.selected_supers``: queries x supers kept).

    ``return_unselected_bound=True`` also returns, per query, the largest
    bin maximum among the bins NOT selected (the sketch tier's certificate
    bound): the larger of the best unselected super's maximum, which bounds
    all its bins, and the best covered but unselected bin. Each is the
    (k+1)-th value of a stable sort, which ties do not change; ``NEG_INF``
    where every super or every covered bin was selected."""
    with timing.span("search.select", device=bin_max.device):
        sup_vals, sup_ids = super_select(bin_max, k_bins, super_size)
    b, nb = bin_max.shape
    ns = nb // super_size
    ks = sup_ids.shape[1]
    timing.count("search.selected_supers", b * ks)
    bm3 = bin_max.reshape(b, ns, super_size)
    cand_bm = torch.gather(bm3, 1, sup_ids[:, :, None].expand(b, ks, super_size))
    cand_bins = _expand_ids(sup_ids, super_size)
    n_cand = cand_bins.shape[1]
    kb = min(k_bins, n_cand)
    vals2, pos = _stable_topk(cand_bm.reshape(b, -1), kb + 1)
    bin_ids, _ = torch.sort(torch.gather(cand_bins, 1, pos[:, :kb]), dim=1)
    if not return_unselected_bound:
        return bin_ids
    none = torch.full((b,), NEG_INF, dtype=torch.float32, device=bin_max.device)
    unsel_super = sup_vals[:, ks] if ns > ks else none
    unsel_cand = vals2[:, kb] if n_cand > kb else none
    return bin_ids, torch.maximum(unsel_super, unsel_cand)


def _gather_bins(scores_bm: torch.Tensor, bin_ids: torch.Tensor, bin_size: int) -> torch.Tensor:
    """The (B, kb * G) f32 scores of the bins ``bin_ids`` (B, kb) in a
    BIN-MAJOR score store (B, N): one contiguous slice per bin."""
    b, kb = bin_ids.shape
    nb = scores_bm.shape[1] // bin_size
    return torch.gather(
        scores_bm.reshape(b, nb, bin_size), 1, bin_ids[:, :, None].expand(b, kb, bin_size),
    ).reshape(b, kb * bin_size).to(torch.float32)


def _topk_of_covered(
    cand: torch.Tensor, bin_ids: torch.Tensor, k: int, bin_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top k of the covered rows' scores ``cand`` (B, kb * G), bins
    ``bin_ids`` ascending, as (values, row ids): ties go to the lower id."""
    vals, pos = _stable_topk(cand, k)
    return vals, torch.gather(_expand_ids(bin_ids, bin_size), 1, pos)


def _topk_from_bins_two_level_bm(
    scores_bm: torch.Tensor,   # (B, N) bin-major scores
    binmax_bm: torch.Tensor,   # (B, nb) bin-major bin maxima
    k: int,
    bin_size: int,
    super_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-level selection tail on BIN-MAJOR layouts: every candidate read is
    a contiguous slice (supers' bin maxima, then bins' scores)."""
    bin_ids = _select_bins_two_level(binmax_bm, k, super_size)
    return _topk_of_covered(_gather_bins(scores_bm, bin_ids, bin_size), bin_ids, k, bin_size)


def _topk_rescored_two_level(
    queries: torch.Tensor,
    docs: torch.Tensor,
    binmax_bm: torch.Tensor,   # (B, nb) kernel 5's bin-major bin maxima
    k: int,
    bin_size: int,
    super_size: int,
    n_valid: Rows,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two-level tail of :func:`_topk_from_bins_two_level_bm` with the
    covered rows scored by :func:`cover_rescore` instead of read from a
    score store (span ``search.rescore``, counter ``search.rescored_rows``);
    where those scores are kernel A's, the results are that tail's."""
    bin_ids = _select_bins_two_level(binmax_bm, k, super_size)
    with timing.span("search.rescore", device=docs.device):
        cand = cover_rescore(queries, docs, bin_ids, bin_size, n_valid)
    timing.count("search.rescored_rows", cand.numel())
    return _topk_of_covered(cand, bin_ids, k, bin_size)


def _topk_from_bins_two_level_bm_probed(
    scores_bm: torch.Tensor,   # (B, N) bin-major scores
    binmax_bm: torch.Tensor,   # (B, nb) bin-major bin maxima
    k: int,
    bin_size: int,
    super_size: int,
    probe_bins: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two-level tail over ``probe_bins`` bins instead of k, with the
    true maximum over every unselected bin: returns ``(vals, ids, unsel)``.
    ``vals[:, k-1] > unsel`` certifies the probe (every row outside the
    probed bins scores strictly below the k-th candidate); ties at the
    boundary fail the strict comparison and escalate. The bound composes
    over shards: merged k-th > max of the shards' ``unsel``."""
    bin_ids, unsel = _select_bins_two_level(
        binmax_bm, probe_bins, super_size, return_unselected_bound=True
    )
    vals, ids = _topk_of_covered(_gather_bins(scores_bm, bin_ids, bin_size), bin_ids, k, bin_size)
    return vals, ids, unsel


def topk_full_tail_bm(
    scores_bm: torch.Tensor,   # (B, N) bin-major scores (retained phase 1)
    binmax_bm: torch.Tensor,   # (B, nb)
    qsel: torch.Tensor,        # (B_esc,) query rows to escalate
    k: int,
    bin_size: int,
    super_size: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Escalation tail of the probed cover: the full two-level selection for
    the query rows ``qsel`` on the RETAINED phase-1 scores, so kernel A is
    not run again. The selected bins are read where they lie in the score
    store (``kb * bin_size`` elements per query); no row of the store is
    copied (a (B_esc, N) copy is 4.5 GB for 128 queries at 8.8M rows).
    ``super_size`` None takes the tuned store's, as
    :func:`topk_ip_bins_two_level_probed` does. Results equal
    :func:`_topk_from_bins_two_level_bm` on those rows."""
    if super_size is None:
        super_size = _auto_super_size(k)
    nb = binmax_bm.shape[1]
    bin_ids = _select_bins_two_level(binmax_bm.index_select(0, qsel), k, super_size)
    cand = scores_bm.view(scores_bm.shape[0], nb, bin_size)[qsel[:, None], bin_ids]
    return _topk_of_covered(cand.reshape(len(qsel), -1).to(torch.float32), bin_ids, k, bin_size)


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def topk_ip_bins_two_level(
    queries: torch.Tensor,
    docs: torch.Tensor,
    k: int,
    *,
    bin_size: Optional[int] = None,
    super_size: Optional[int] = None,
    tile_b: Optional[int] = None,
    tile_n: int = 1024,
    n_valid: Optional[Rows] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact deep-k top-k via a TWO-LEVEL bin-max cover, bin-major.

    1. kernel A: scores + bin maxima                       [1 pass over D]
    2. super maxima (N/(G*M)) by a reshape-max              [tiny]
    3. top k supers; gather their k*M bin maxima -> top k bins
    4. gather the k*G candidate scores -> final top k

    Exactness is the transitive cover: a super-bin ranked above the one
    holding a true top-k element x holds an element that outranks x, so at
    most k-1 supers rank above it; the same holds at the bin level.

    Where :func:`rescores_cover` holds (a bf16 or f16 index on the card),
    step 1 is kernel 5, which writes the bin maxima alone, and step 4 scores
    the k*G covered rows with :func:`cover_rescore`: kernel A's sums, bit
    for bit, so the results are the same."""
    if bin_size is None:
        bin_size = _auto_bin_size_two_level(k)
    if super_size is None:
        super_size = _auto_super_size(k)
    tile_b = _tile_b(tile_b, k, two_level=True)
    (docs,), n_valid = _prep_shard(k, n_valid, tile_n, [docs], chunk=bin_size * super_size)
    if rescores_cover(docs):
        def run(q):
            with timing.span("search.phase1", device=docs.device):
                binmax_bm = binmax_only(q, docs, n_valid, bin_size)
            with timing.span("search.tail", device=docs.device):
                return _topk_rescored_two_level(q, docs, binmax_bm, k, bin_size, super_size, n_valid)
    else:
        def run(q):
            with timing.span("search.phase1", device=docs.device):
                scores_bm, binmax_bm = bin_scores(q, docs, n_valid, bin_size, layout="bin_major")
            with timing.span("search.tail", device=docs.device):
                return _topk_from_bins_two_level_bm(scores_bm, binmax_bm, k, bin_size, super_size)
    return _by_query_chunks(queries, tile_b, run)


def topk_ip_bins_two_level_probed(
    queries: torch.Tensor,
    docs: torch.Tensor,
    k: int,
    *,
    probe_bins: int,
    bin_size: Optional[int] = None,
    super_size: Optional[int] = None,
    tile_n: int = 1024,
    n_valid: Optional[Rows] = None,
    keep_scores: bool = False,
):
    """Certified probed-exact deep-k: kernel A's bin-major scores at every
    shard size, then the two-level cover over only ``probe_bins`` bins,
    certified per query against the true unselected-bin maxima
    (:func:`_topk_from_bins_two_level_bm_probed`).

    Returns ``(vals, ids, cert, unsel)``, or with ``keep_scores=True``
    ``(vals, ids, cert, unsel, scores_bm, binmax_bm)``, so the caller can
    escalate uncertified queries through :func:`topk_full_tail_bm` without
    running kernel A again. The whole batch is one launch, since the
    escalation reads its score store."""
    if bin_size is None:
        bin_size = _auto_bin_size_two_level(k)
    if probe_bins * bin_size < k:
        raise ValueError(
            f"probe_bins={probe_bins} x bin_size={bin_size} < k={k}: "
            "the probed cover cannot hold k candidates"
        )
    if super_size is None:
        super_size = _auto_super_size(k)
    (docs,), n_valid = _prep_shard(k, n_valid, tile_n, [docs], chunk=bin_size * super_size)
    scores_bm, binmax_bm = bin_scores(queries, docs, n_valid, bin_size, layout="bin_major")
    nb = binmax_bm.shape[1]
    vals, ids, unsel = _topk_from_bins_two_level_bm_probed(
        scores_bm, binmax_bm, k, bin_size, super_size, min(probe_bins, nb)
    )
    cert = vals[:, k - 1] > unsel
    if keep_scores:
        return vals, ids, cert, unsel, scores_bm, binmax_bm
    return vals, ids, cert, unsel


def topk_ip_bins(
    queries: torch.Tensor,
    docs: torch.Tensor,
    k: int,
    *,
    bin_size: Optional[int] = None,
    use_kernel: bool = True,
    tile_b: Optional[int] = None,
    tile_n: int = 1024,
    n_valid: Optional[Rows] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact IP top-k via the single-level bin-max cover.

    ``docs`` may have any row count; it is padded to a tile multiple and
    padded rows are never selected (masked to NEG_INF). ``use_kernel``
    selects kernel 2, phase 1 in the transposed layout (the ``bins_pallas``
    route); otherwise phase 1 is plain PyTorch (the ``bins_xla`` route).
    Returns (values f32 (B, k), row ids (B, k)); ties go to the lower row
    id."""
    if bin_size is None:
        bin_size = _auto_bin_size(k)
    if not use_kernel:
        (docs,), n_valid = _prep_shard(k, n_valid, bin_size, [docs])
        scores, bin_max = bin_scores_plain(queries, docs, n_valid, bin_size)
        return _topk_from_bins(scores, bin_max, k, bin_size)
    (docs,), n_valid = _prep_shard(k, n_valid, tile_n, [docs])

    def run(q):
        with timing.span("search.phase1", device=docs.device):
            scores_t, bin_max_t = bin_scores(q, docs, n_valid, bin_size, layout="transposed")
        with timing.span("search.tail", device=docs.device):
            return _topk_from_bins(scores_t, bin_max_t.T, k, bin_size, scores_transposed=True)

    return _by_query_chunks(queries, _tile_b(tile_b, k, two_level=False), run)


def topk_ip_bins_int8(
    queries: torch.Tensor,
    d_vals: torch.Tensor,
    d_scales: torch.Tensor,
    k: int,
    *,
    bin_size: Optional[int] = None,
    tile_b: Optional[int] = None,
    tile_n: int = 1024,
    n_valid: Optional[Rows] = None,
    super_size: Optional[int] = None,
    two_level: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bin-max-cover top-k over an int8 index (``d_vals`` (N, d) int8 with
    per-row f32 ``d_scales``): float ``queries`` are quantized per row on
    their device, phase 1 is kernel 4 (:func:`bin_scores_int8`). Single
    level uses the transposed layout; ``two_level`` finishes with the
    super-bin cover in the bin-major layout. The scores are exact, so the
    ids equal a stable top-k of the plain int8 scores."""
    if bin_size is None:
        bin_size = _auto_bin_size_two_level(k) if two_level else _auto_bin_size(k)
    if super_size is None:
        super_size = _auto_super_size(k)
    (d_vals, d_scales), n_valid = _prep_shard(
        k, n_valid, tile_n, [d_vals, d_scales],
        chunk=bin_size * super_size if two_level else None,
    )
    layout = "bin_major" if two_level else "transposed"

    def run(q):
        q_vals, q_scales = quantize_rows(q)
        with timing.span("search.phase1", device=d_vals.device):
            scores, bin_max = bin_scores_int8(
                q_vals, q_scales, d_vals, d_scales, n_valid, bin_size, layout=layout
            )
        with timing.span("search.tail", device=d_vals.device):
            if two_level:
                return _topk_from_bins_two_level_bm(scores, bin_max, k, bin_size, super_size)
            return _topk_from_bins(scores, bin_max.T, k, bin_size, scores_transposed=True)

    return _by_query_chunks(queries, _tile_b(tile_b, k, two_level=two_level), run)


# --------------------------------------------------------------------------
# rescore search: kernel 5 bin maxima -> covered bins' rows -> exact rescore
# --------------------------------------------------------------------------

#: Rescore working-set budget (bytes) of one query chunk: the gathered
#: candidate rows, their f32 copy and the candidate scores.
_RESCORE_BUDGET = 2 << 30


def _rescore_chunk(b: int, kb: int, bin_size: int, d: int, itemsize: int) -> int:
    """Largest divisor of ``b`` whose rescore working set fits the budget
    (per query: the gathered rows + their f32 copy + scores)."""
    c = kb * bin_size
    per_q = c * d * (itemsize + 4) + c * 16
    chunk = max(1, min(b, _RESCORE_BUDGET // max(per_q, 1)))
    while b % chunk:
        chunk -= 1
    return chunk


def _rescore_block(
    docs: torch.Tensor, queries: torch.Tensor, bin_ids: torch.Tensor,
    bin_size: int, n_valid: Rows, k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    cand = cover_rescore_plain(queries, docs, bin_ids, bin_size, n_valid)
    return _topk_of_covered(cand, bin_ids, k, bin_size)


def _rescore_candidates(
    docs: torch.Tensor,
    queries: torch.Tensor,
    bin_ids: torch.Tensor,  # (B, kb), sorted ascending
    bin_size: int,
    n_valid: Rows,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared rescore tail: expand the covered bins to candidate row ids,
    gather those doc rows, recompute their scores as f32 products, mask pad
    rows, stable top k. Ties go to the lower id because ``bin_ids`` arrive
    sorted ascending. Query chunks run one after another when the candidate
    working set would exceed ``_RESCORE_BUDGET``."""
    b, kb = bin_ids.shape
    chunk = _rescore_chunk(b, kb, bin_size, docs.shape[1], docs.element_size())
    outs = [
        _rescore_block(docs, queries[i : i + chunk], bin_ids[i : i + chunk], bin_size, n_valid, k)
        for i in range(0, b, chunk)
    ]
    if len(outs) == 1:
        return outs[0]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def _rescore_int8_block(
    d_vals: torch.Tensor, d_scales: torch.Tensor, q_vals: torch.Tensor, q_scales: torch.Tensor,
    bin_ids: torch.Tensor, bin_size: int, n_valid: Rows, k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    b, kb = bin_ids.shape
    cand_idx = _expand_ids(bin_ids, bin_size)
    flat = cand_idx.reshape(-1)
    cand_rows = d_vals.index_select(0, flat).reshape(b, kb * bin_size, -1)
    cand_sc = d_scales.index_select(0, flat).reshape(b, kb * bin_size)
    acc = int8_ip_acc_rows(q_vals, cand_rows).to(torch.float32)
    cand_scores = acc.mul_(cand_sc).mul_(q_scales[:, None])
    cand_scores = torch.where(cand_idx < n_valid, cand_scores, NEG_INF)
    vals, pos = _stable_topk(cand_scores, k)
    return vals, torch.gather(cand_idx, 1, pos)


def _rescore_candidates_int8(
    d_vals: torch.Tensor,    # (N, d) int8
    d_scales: torch.Tensor,  # (N,) f32
    q_vals: torch.Tensor,    # (B, d) int8
    q_scales: torch.Tensor,  # (B,) f32
    bin_ids: torch.Tensor,   # (B, kb), sorted ascending
    bin_size: int,
    n_valid: Rows,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Int8 rescore tail (the sketch tier's refine over a quantized index):
    exact integer products of the covered bins' int8 rows, rescaled in the
    ``(f32(acc) * d_scale) * q_scale`` order of kernel 4's epilogue, so the
    refined scores equal the exact int8 path's bit for bit. Query chunks
    run one after another under ``_RESCORE_BUDGET`` (1 byte per gathered
    element)."""
    b, kb = bin_ids.shape
    chunk = _rescore_chunk(b, kb, bin_size, d_vals.shape[1], 1)
    outs = [
        _rescore_int8_block(
            d_vals, d_scales, q_vals[i : i + chunk], q_scales[i : i + chunk],
            bin_ids[i : i + chunk], bin_size, n_valid, k,
        )
        for i in range(0, b, chunk)
    ]
    if len(outs) == 1:
        return outs[0]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def topk_ip_bins_rescore(
    queries: torch.Tensor,
    docs: torch.Tensor,
    k: int,
    *,
    bin_size: Optional[int] = None,
    slack_bins: int = 16,
    tile_b: Optional[int] = None,
    tile_n: int = 1024,
    n_valid: Optional[Rows] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bin-max cover with candidate rescoring, the least-HBM variant.

    Phase 1 (kernel 5, :func:`binmax_only`) writes only the (B, N/G) bin
    maxima; the score matrix never exists. The top ``k + slack_bins`` bins'
    doc rows are gathered and rescored. Rescoring sums the same products in
    another order than the kernel, so near-ties at the cover boundary may
    differ by round-off; ``slack_bins`` absorbs that. Use the stored-scores
    path where bit-exact parity matters."""
    if bin_size is None:
        bin_size = _auto_bin_size(k)
    (docs,), n_valid = _prep_shard(k, n_valid, tile_n, [docs])

    def run(q):
        bin_max = binmax_only(q, docs, n_valid, bin_size)
        kb = min(k + slack_bins, bin_max.shape[1])
        _, bin_ids = _stable_topk(bin_max, kb)
        bin_ids, _ = torch.sort(bin_ids, dim=1)
        return _rescore_candidates(docs, q, bin_ids, bin_size, n_valid, k)

    return _by_query_chunks(queries, _tile_b(tile_b, k, two_level=False), run)


def topk_ip_rescore_two_level(
    queries: torch.Tensor,
    docs: torch.Tensor,
    k: int,
    *,
    bin_size: int = 8,
    super_size: Optional[int] = None,
    slack_bins: int = 16,
    tile_b: Optional[int] = None,
    tile_n: int = 1024,
    n_valid: Optional[Rows] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact deep-k top-k with no score matrix: kernel 5's bin-major bin
    maxima, the two-level bin selection over contiguous slices
    (:func:`_select_bins_two_level`), then the ``k + slack_bins`` covered
    bins' doc rows rescored. The transitive cover of
    :func:`topk_ip_bins_two_level` selects a superset of the true top-k
    bins; ``slack_bins`` absorbs round-off at the boundary. Ties go to the
    lower id."""
    if super_size is None:
        super_size = _auto_super_size(k)
    (docs,), n_valid = _prep_shard(k, n_valid, tile_n, [docs], chunk=bin_size * super_size)

    def run(q):
        bin_max = binmax_only(q, docs, n_valid, bin_size)
        bin_ids = _select_bins_two_level(bin_max, min(k + slack_bins, bin_max.shape[1]), super_size)
        return _rescore_candidates(docs, q, bin_ids, bin_size, n_valid, k)

    return _by_query_chunks(queries, _tile_b(tile_b, k, two_level=True), run)


def shard_topk(
    queries: torch.Tensor,
    docs: torch.Tensor,
    k: int,
    *,
    n_valid: Optional[Rows],
    doc_scales: Optional[torch.Tensor] = None,
    method: str = "auto",
    bin_size: Optional[int] = None,
    tile_b: Optional[int] = None,
    tile_n: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's exact top k: (values (B, k) f32, row ids (B, k)), ties to
    the lower id, rows at or past ``n_valid`` (an int, a one-element int32
    tensor on the docs' device, or None: every row) never ahead of a valid
    one. The per-shard entry of
    :func:`~codemix_dense_retrieval_torch.parallel.sharded_search.sharded_topk_ip`
    and of :func:`topk_ip`.

    ``method`` (one of ``SHARD_METHODS``; the names are the JAX package's):
    ``auto`` takes the two-level cover, bin-major, on shards of
    ``TWO_LEVEL_MIN_ROWS`` rows or more (on the card kernel 5 and
    :func:`cover_rescore` for a bf16 or f16 index, kernel A for f32, kernel 4
    for int8) and the single-level cover below (``bins_pallas``: kernels 2
    and 4, transposed); ``full`` and ``bins_xla`` score with the plain
    versions. An int8 shard (``docs`` int8 with its per-row f32
    ``doc_scales``) takes float queries, quantized per row on its device.
    ``bin_size`` and ``tile_b`` None take the route's own (:func:`_tile_b`)."""
    if method not in SHARD_METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of {SHARD_METHODS}")
    int8 = docs.dtype == torch.int8
    if int8 and doc_scales is None:
        raise ValueError("int8 index requires doc_scales")
    if method == "auto":
        method = _shard_method(docs.shape[0])
    if int8 and method in ("full", "bins_xla"):
        bin_size = bin_size or _auto_bin_size(k)
        (docs, doc_scales), n_valid = _prep_shard(k, n_valid, bin_size, [docs, doc_scales])
        scores, bin_max = bin_scores_int8_plain(*quantize_rows(queries), docs, doc_scales, n_valid, bin_size)
        return _stable_topk(scores, k) if method == "full" else _topk_from_bins(scores, bin_max, k, bin_size)
    if int8:
        return topk_ip_bins_int8(
            queries, docs, doc_scales, k, bin_size=bin_size, tile_b=tile_b, tile_n=tile_n,
            n_valid=n_valid, two_level=(method == "bins_two_level"),
        )
    if method == "full":
        return topk_ip_full(queries, docs, k, n_valid=n_valid)
    if method == "bins_two_level":
        return topk_ip_bins_two_level(
            queries, docs, k, bin_size=bin_size, tile_b=tile_b, tile_n=tile_n, n_valid=n_valid
        )
    return topk_ip_bins(
        queries, docs, k, bin_size=bin_size, use_kernel=(method == "bins_pallas"),
        tile_b=tile_b, tile_n=tile_n, n_valid=n_valid,
    )


def topk_ip(
    queries: torch.Tensor,
    docs: torch.Tensor,
    k: int,
    *,
    bin_size: Optional[int] = None,
    method: str = "auto",
    **kwargs,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact inner-product top-k over ``docs``: ``bins_rescore`` runs the
    kernel 5 route of :func:`topk_ip_bins_rescore`, any other ``method``
    :func:`shard_topk` (``kwargs``: its ``n_valid``, ``tile_b`` and
    ``tile_n``), except that ``auto`` full-sorts below
    ``FULL_SORT_MAX_ROWS`` rows."""
    if method == "bins_rescore":
        return topk_ip_bins_rescore(queries, docs, k, bin_size=bin_size, **kwargs)
    if method == "auto" and docs.shape[0] < FULL_SORT_MAX_ROWS:
        method = "full"
    return shard_topk(
        queries, docs, k, n_valid=kwargs.pop("n_valid", None), method=method, bin_size=bin_size, **kwargs
    )
