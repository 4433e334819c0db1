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

Two variants share the cover. Over an int8 index (:func:`topk_ip_bins_int8`)
phase 1 is kernel 4 (:func:`bin_scores_int8`): exact int8 products rescaled
per row, queries quantized on the device. The rescore search
(:func:`topk_ip_bins_rescore`, :func:`topk_ip_rescore_two_level`) runs
kernel 5 (:func:`binmax_only`), which writes the bin maxima alone, then
gathers the covered bins' doc rows and recomputes their scores.

Tie-break: every selection is a STABLE descending sort followed by a slice,
over domains whose positions ascend with the ids (selected bin ids are
re-sorted ascending at each level), so among equal scores the lower id wins
at every level, the cover boundary included. ``torch.topk`` promises no
order among ties and is not used for selection.

While tracing (:mod:`~codemix_dense_retrieval_torch.utils.timing`) the
exact routes (two-level and single-level cover, bf16 / f16 / f32 and int8)
time each query chunk's phase 1 and tail on the card as the spans
``search.phase1`` and ``search.tail``.
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


def _tuned_tile_b(k: int, default: Optional[int] = None) -> int:
    """Queries per phase-1 launch: the tuned store's ``topk.tile_b[.k<k>]``,
    else ``default``, else the built-in 512. The JAX package clamps tuned
    values above 512 on shards under 1.1M rows, a limit of the TPU
    compiler's scoped VMEM; the card has none, so the port does not."""
    return int(autotune.get_tuned("topk.tile_b", k=k, default=default))


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


def _bin_scores_xla(
    queries: torch.Tensor, docs: torch.Tensor, bin_size: int, n_valid: Rows
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 1 of the ``bins_xla`` route, which never launches a kernel:
    (scores (B, Npad) f32 with padding = NEG_INF, bin_max (B, Npad/G))."""
    return bin_scores_plain(queries, docs, n_valid, bin_size, layout="bin_major")


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
    """Run phase 1 + tail on at most ``tile_b`` queries at a time: the
    (tile_b, N) score matrix of one launch is the peak memory."""
    outs = [fn(queries[i : i + tile_b]) for i in range(0, queries.shape[0], tile_b)]
    if len(outs) == 1:
        return outs[0]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


# --------------------------------------------------------------------------
# full-sort path (small N)
# --------------------------------------------------------------------------

def topk_ip_full(
    queries: torch.Tensor, docs: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k via the full f32 score matrix and a stable sort; for small
    shards."""
    scores = queries.to(torch.float32) @ docs.to(torch.float32).T
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


def _select_bins_two_level(
    bin_max: torch.Tensor, k_bins: int, super_size: int, *,
    return_unselected_bound: bool = False,
):
    """Two-level bin selection over BIN-MAJOR maxima (B, nb): super-max
    reduce -> best ``k_bins`` supers -> their M-contiguous bin maxima -> best
    ``k_bins`` bins; returns the bin ids sorted ascending.

    ``return_unselected_bound=True`` also returns, per query, the largest
    bin maximum among the bins NOT selected (the sketch tier's certificate
    bound): the larger of the best unselected super's maximum, which bounds
    all its bins, and the best covered but unselected bin. Each is the
    (k+1)-th value of a stable sort, which ties do not change; ``NEG_INF``
    where every super or every covered bin was selected."""
    b, nb = bin_max.shape
    if nb % super_size:
        raise ValueError(f"{nb} bins not a multiple of super_size {super_size}")
    ns = nb // super_size
    bm3 = bin_max.reshape(b, ns, super_size)
    super_max = bm3.amax(dim=2)
    ks = min(k_bins, ns)
    sup_vals, sup_ids = _stable_topk(super_max, ks + 1)
    sup_ids, _ = torch.sort(sup_ids[:, :ks], dim=1)
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


def _topk_from_bins_two_level(
    scores_t: torch.Tensor,    # (N, B) transposed scores
    bin_max_t: torch.Tensor,   # (nb, B) transposed bin maxima
    k: int,
    bin_size: int,
    super_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-level selection tail over the transposed layouts: super-max
    reduce -> super top-k -> covered-bin gather + top-k -> element gather +
    top-k. ``nb`` must divide by ``super_size``; pad rows carry NEG_INF."""
    nb, b = bin_max_t.shape
    if nb % super_size:
        raise ValueError(f"{nb} bins not a multiple of super_size {super_size}")
    ns = nb // super_size
    super_max = bin_max_t.reshape(ns, super_size, b).amax(dim=1).T  # (B, ns)
    ks = min(k, ns)
    _, sup_ids = _stable_topk(super_max, ks)
    sup_ids, _ = torch.sort(sup_ids, dim=1)
    bin_idx = _expand_ids(sup_ids, super_size)
    cand_binmax = torch.gather(bin_max_t, 0, bin_idx.T).T
    kb = min(k, cand_binmax.shape[1])
    _, pos = _stable_topk(cand_binmax, kb)
    bin_ids, _ = torch.sort(torch.gather(bin_idx, 1, pos), dim=1)
    cand_idx = _expand_ids(bin_ids, bin_size)
    cand_scores = torch.gather(scores_t, 0, cand_idx.T).T.to(torch.float32)
    vals, p2 = _stable_topk(cand_scores, k)
    return vals, torch.gather(cand_idx, 1, p2)


def _topk_from_bins_two_level_bm(
    scores_bm: torch.Tensor,   # (B, N) bin-major scores
    binmax_bm: torch.Tensor,   # (B, nb) bin-major bin maxima
    k: int,
    bin_size: int,
    super_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-level selection tail on BIN-MAJOR layouts: every candidate read is
    a contiguous slice (supers' bin maxima, then bins' scores)."""
    b, nb = binmax_bm.shape
    bin_ids = _select_bins_two_level(binmax_bm, k, super_size)
    kb = bin_ids.shape[1]
    cand = torch.gather(
        scores_bm.reshape(b, nb, bin_size), 1,
        bin_ids[:, :, None].expand(b, kb, bin_size),
    ).reshape(b, kb * bin_size).to(torch.float32)
    cand_idx = _expand_ids(bin_ids, bin_size)
    vals, pos = _stable_topk(cand, k)
    return vals, torch.gather(cand_idx, 1, pos)


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
    b, nb = binmax_bm.shape
    bin_ids, unsel = _select_bins_two_level(
        binmax_bm, probe_bins, super_size, return_unselected_bound=True
    )
    kb = bin_ids.shape[1]
    cand = torch.gather(
        scores_bm.reshape(b, nb, bin_size), 1,
        bin_ids[:, :, None].expand(b, kb, bin_size),
    ).reshape(b, kb * bin_size).to(torch.float32)
    cand_idx = _expand_ids(bin_ids, bin_size)
    vals, pos = _stable_topk(cand, k)
    return vals, torch.gather(cand_idx, 1, pos), unsel


def topk_full_tail_bm(
    scores_bm: torch.Tensor,   # (B, N) bin-major scores (retained phase 1)
    binmax_bm: torch.Tensor,   # (B, nb)
    qsel: torch.Tensor,        # (B_esc,) query rows to escalate
    k: int,
    bin_size: int,
    super_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Escalation tail of the probed cover: the full two-level selection for
    the query rows ``qsel`` on the RETAINED phase-1 scores, so kernel A is
    not run again. The selected bins are read where they lie in the score
    store (``kb * bin_size`` elements per query); no row of the store is
    copied (a (B_esc, N) copy is 4.5 GB for 128 queries at 8.8M rows).
    Results equal :func:`_topk_from_bins_two_level_bm` on those rows."""
    nb = binmax_bm.shape[1]
    bin_ids = _select_bins_two_level(binmax_bm.index_select(0, qsel), k, super_size)
    cand = scores_bm.view(scores_bm.shape[0], nb, bin_size)[qsel[:, None], bin_ids]
    cand = cand.reshape(len(qsel), -1).to(torch.float32)
    cand_idx = _expand_ids(bin_ids, bin_size)
    vals, pos = _stable_topk(cand, k)
    return vals, torch.gather(cand_idx, 1, pos)


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
    score_dtype: torch.dtype = torch.float32,
    bin_major: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact deep-k top-k via a TWO-LEVEL bin-max cover.

    1. kernel A: scores + bin maxima                       [1 pass over D]
    2. super maxima (N/(G*M)) by a reshape-max              [tiny]
    3. top k supers; gather their k*M bin maxima -> top k bins
    4. gather the k*G candidate scores -> final top k

    Exactness is the transitive cover: a super-bin ranked above the one
    holding a true top-k element x holds an element that outranks x, so at
    most k-1 supers rank above it; the same holds at the bin level."""
    if bin_size is None:
        bin_size = _auto_bin_size_two_level(k)
    if super_size is None:
        super_size = _auto_super_size(k)
    if tile_b is None:
        tile_b = _tuned_tile_b(k)
    (docs,), n_valid = _prep_shard(k, n_valid, tile_n, [docs], chunk=bin_size * super_size)
    if bin_major:
        def run(q):
            with timing.span("search.phase1", device=docs.device):
                scores_bm, binmax_bm = bin_scores(
                    q, docs, n_valid, bin_size, layout="bin_major", score_dtype=score_dtype
                )
            with timing.span("search.tail", device=docs.device):
                return _topk_from_bins_two_level_bm(scores_bm, binmax_bm, k, bin_size, super_size)
    else:
        def run(q):
            with timing.span("search.phase1", device=docs.device):
                scores_t, bin_max_t = bin_scores(
                    q, docs, n_valid, bin_size, layout="transposed", score_dtype=score_dtype
                )
            with timing.span("search.tail", device=docs.device):
                return _topk_from_bins_two_level(scores_t, bin_max_t, k, bin_size, super_size)
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
    score_dtype: torch.dtype = torch.float32,
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
    scores_bm, binmax_bm = bin_scores(
        queries, docs, n_valid, bin_size, layout="bin_major", score_dtype=score_dtype
    )
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
    tile_b: int = 256,
    tile_n: int = 1024,
    n_valid: Optional[Rows] = None,
    score_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact IP top-k via the single-level bin-max cover.

    ``docs`` may have any row count; it is padded to a tile multiple and
    padded rows are never selected (masked to NEG_INF). ``use_kernel``
    selects kernel 2, phase 1 in the transposed layout (the ``bins_pallas``
    route);
    otherwise phase 1 is plain PyTorch (the ``bins_xla`` route).
    ``score_dtype=torch.bfloat16`` halves the score writes but rounds scores,
    so near-ties may reorder. Returns (values f32 (B, k), row ids (B, k));
    ties go to the lower row id."""
    if bin_size is None:
        bin_size = _auto_bin_size(k)
    if not use_kernel:
        (docs,), n_valid = _prep_shard(k, n_valid, bin_size, [docs])
        scores, bin_max = _bin_scores_xla(queries, docs, bin_size, n_valid)
        return _topk_from_bins(scores, bin_max, k, bin_size)
    (docs,), n_valid = _prep_shard(k, n_valid, tile_n, [docs])

    def run(q):
        with timing.span("search.phase1", device=docs.device):
            scores_t, bin_max_t = bin_scores(
                q, docs, n_valid, bin_size, layout="transposed", score_dtype=score_dtype
            )
        with timing.span("search.tail", device=docs.device):
            return _topk_from_bins(scores_t, bin_max_t.T, k, bin_size, scores_transposed=True)

    return _by_query_chunks(queries, tile_b, run)


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
    score_dtype: torch.dtype = torch.float32,
    super_size: Optional[int] = None,
    two_level: bool = False,
    bin_major: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bin-max-cover top-k over an int8 index (``d_vals`` (N, d) int8 with
    per-row f32 ``d_scales``): float ``queries`` are quantized per row on
    their device, phase 1 is kernel 4 (:func:`bin_scores_int8`). Single
    level uses the transposed layout; ``two_level`` finishes with the
    super-bin cover, in the bin-major layout when ``bin_major`` (the
    two-level route of an int8 shard). The scores are exact, so the ids
    equal a stable top-k of the plain int8 scores."""
    if bin_size is None:
        bin_size = _auto_bin_size_two_level(k) if two_level else _auto_bin_size(k)
    if super_size is None:
        super_size = _auto_super_size(k)
    if tile_b is None:
        tile_b = _tuned_tile_b(k, default=256)
    (d_vals, d_scales), n_valid = _prep_shard(
        k, n_valid, tile_n, [d_vals, d_scales],
        chunk=bin_size * super_size if two_level else None,
    )
    layout = "bin_major" if two_level and bin_major else "transposed"

    def run(q):
        q_vals, q_scales = quantize_rows(q)
        with timing.span("search.phase1", device=d_vals.device):
            scores, bin_max = bin_scores_int8(
                q_vals, q_scales, d_vals, d_scales, n_valid, bin_size,
                layout=layout, score_dtype=score_dtype,
            )
        with timing.span("search.tail", device=d_vals.device):
            if layout == "bin_major":
                return _topk_from_bins_two_level_bm(scores, bin_max, k, bin_size, super_size)
            if two_level:
                return _topk_from_bins_two_level(scores, bin_max, k, bin_size, super_size)
            return _topk_from_bins(scores, bin_max.T, k, bin_size, scores_transposed=True)

    return _by_query_chunks(queries, tile_b, run)


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
    b, kb = bin_ids.shape
    cand_idx = _expand_ids(bin_ids, bin_size)
    cand_rows = docs.index_select(0, cand_idx.reshape(-1)).reshape(b, kb * bin_size, -1)
    cand_scores = torch.bmm(cand_rows.to(torch.float32), queries.to(torch.float32)[:, :, None])[:, :, 0]
    cand_scores = torch.where(cand_idx < n_valid, cand_scores, NEG_INF)
    vals, pos = _stable_topk(cand_scores, k)
    return vals, torch.gather(cand_idx, 1, pos)


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
    tile_b: int = 256,
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

    return _by_query_chunks(queries, tile_b, run)


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
    if tile_b is None:
        tile_b = _tuned_tile_b(k)
    (docs,), n_valid = _prep_shard(k, n_valid, tile_n, [docs], chunk=bin_size * super_size)

    def run(q):
        bin_max = binmax_only(q, docs, n_valid, bin_size)
        bin_ids = _select_bins_two_level(bin_max, min(k + slack_bins, bin_max.shape[1]), super_size)
        return _rescore_candidates(docs, q, bin_ids, bin_size, n_valid, k)

    return _by_query_chunks(queries, tile_b, run)


def topk_ip(
    queries: torch.Tensor,
    docs: torch.Tensor,
    k: int,
    *,
    bin_size: Optional[int] = None,
    method: str = "auto",
    **kwargs,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact inner-product top-k. ``method``: auto | full | bins_xla |
    bins_pallas | bins_two_level | bins_rescore (``bins_pallas`` is the
    kernel 2 route (the transposed layout), ``bins_rescore`` the kernel 5
    route of :func:`topk_ip_bins_rescore`; the names are the JAX
    package's).

    ``auto``: full sort below 16,384 rows, the two-level cover at 262,144
    rows and above, the single-level cover in between."""
    n = docs.shape[0]
    if method == "auto":
        if n < FULL_SORT_MAX_ROWS:
            method = "full"
        elif n >= TWO_LEVEL_MIN_ROWS:
            method = "bins_two_level"
        else:
            method = "bins_pallas"
    if method == "full":
        if k > n:
            raise ValueError(f"k={k} > num docs {n}")
        return topk_ip_full(queries, docs, k)
    if method == "bins_xla":
        return topk_ip_bins(queries, docs, k, bin_size=bin_size, use_kernel=False, **kwargs)
    if method == "bins_pallas":
        return topk_ip_bins(queries, docs, k, bin_size=bin_size, use_kernel=True, **kwargs)
    if method == "bins_two_level":
        return topk_ip_bins_two_level(queries, docs, k, bin_size=bin_size, **kwargs)
    if method == "bins_rescore":
        return topk_ip_bins_rescore(queries, docs, k, bin_size=bin_size, **kwargs)
    raise ValueError(f"unknown method {method!r}")
