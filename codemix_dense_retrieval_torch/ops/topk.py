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

Tie-break: every selection is a STABLE descending sort followed by a slice,
over domains whose positions ascend with the ids (selected bin ids are
re-sorted ascending at each level), so among equal scores the lower id wins
at every level, the cover boundary included. ``torch.topk`` promises no
order among ties and is not used for selection.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from codemix_dense_retrieval_torch.ops import kernels

NEG_INF = float(np.finfo(np.float32).min)

#: Routing and cover constants. They are the JAX package's measured
#: defaults, carried over for parity; re-deriving them on the H100 is a
#: ROADMAP item.
FULL_SORT_MAX_ROWS = 16_384     # topk_ip(method="auto"): below -> full sort
TWO_LEVEL_MIN_ROWS = 262_144    # at or above -> two-level cover
TUNED_DEFAULTS = {
    "topk.super_size": 8,
    "topk.tile_b": 512,
    "topk.bin_size": 8,
}

LAYOUTS = ("bin_major", "transposed")
Rows = Union[int, torch.Tensor]


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _auto_bin_size(k: int) -> int:
    """Single-level bin size: candidates scale as k*G, so deeper k favors
    smaller bins."""
    return 8 if k > 200 else 16


def _auto_bin_size_two_level(k: int) -> int:
    return int(TUNED_DEFAULTS["topk.bin_size"])


def _auto_super_size(k: int) -> int:
    return int(TUNED_DEFAULTS["topk.super_size"])


# --------------------------------------------------------------------------
# phase 1: fused scores + bin maxima (kernel A and its plain version)
# --------------------------------------------------------------------------

_PLAIN_ROW_CHUNK = 262_144


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
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    b = queries.shape[0]
    n = docs.shape[0]
    if n % bin_size:
        raise ValueError(f"rows {n} not a multiple of bin_size {bin_size}")
    nv = int(n_valid.reshape(-1)[0]) if isinstance(n_valid, torch.Tensor) else int(n_valid)
    qf = queries.to(torch.float32)
    scores = torch.empty((b, n), dtype=torch.float32, device=docs.device)
    for r0 in range(0, n, _PLAIN_ROW_CHUNK):
        r1 = min(r0 + _PLAIN_ROW_CHUNK, n)
        torch.matmul(qf, docs[r0:r1].to(torch.float32).T, out=scores[:, r0:r1])
    if nv < n:
        scores[:, max(nv, 0):] = NEG_INF
    bin_max = scores.view(b, n // bin_size, bin_size).amax(dim=2)
    scores = scores.to(score_dtype)
    if layout == "transposed":
        return scores.T.contiguous(), bin_max.T.contiguous()
    return scores, bin_max


_BIN_SCORES_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]


def _bin_scores_lib():
    lib = kernels.load("bin_scores")
    fn = lib.bin_scores_launch
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
    """Kernel A: fused scores and bin maxima of ``queries`` (B, d) against
    ``docs`` (N, d), rows at or past ``n_valid`` (an int or a one-element
    int32 tensor on the docs' device) set to ``NEG_INF``.

    ``layout="bin_major"`` returns (scores (B, N) ``score_dtype``, binmax
    (B, N/G) f32); ``"transposed"`` returns (N, B) and (N/G, B). CPU tensors
    take :func:`bin_scores_plain`; CUDA tensors launch the kernel
    (``csrc/bin_scores.cu``), which takes bf16 rows and queries, d % 32 == 0,
    N % G == 0 and G in {8, 16}."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if queries.device.type == "cpu" and docs.device.type == "cpu":
        return bin_scores_plain(
            queries, docs, n_valid, bin_size, layout=layout, score_dtype=score_dtype
        )
    if docs.device.type != "cuda" or queries.device != docs.device:
        raise ValueError(
            f"bin_scores: queries on {queries.device}, docs on {docs.device}; "
            "both must be on the same CUDA device (or both on the CPU)"
        )
    if docs.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"bin_scores on CUDA takes a bfloat16 index, got {docs.dtype} "
            "(float32/float16 stores on the card are a ROADMAP item)"
        )
    if queries.dtype != torch.bfloat16:
        raise ValueError(f"queries must be cast to the index dtype bfloat16, got {queries.dtype}")
    if score_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"score_dtype must be float32 or bfloat16, got {score_dtype}")
    if queries.ndim != 2 or docs.ndim != 2 or queries.shape[1] != docs.shape[1]:
        raise ValueError(f"shapes {tuple(queries.shape)} x {tuple(docs.shape)} do not contract")
    b, dim = queries.shape
    n = docs.shape[0]
    if bin_size not in (8, 16):
        raise ValueError(f"the CUDA kernel takes bin_size 8 or 16, got {bin_size}")
    if dim % 32 or n % bin_size or b == 0:
        raise ValueError(f"the CUDA kernel needs d % 32 == 0, N % G == 0, B > 0 (d={dim}, N={n}, B={b})")
    for name, t in (("queries", queries), ("docs", docs)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if isinstance(n_valid, torch.Tensor):
        if (n_valid.device != docs.device or n_valid.dtype != torch.int32
                or n_valid.numel() != 1 or not n_valid.is_contiguous()):
            raise ValueError("n_valid tensor must be one contiguous int32 on the docs' device")
        nv_ptr, nv_int = n_valid.data_ptr(), 0
    else:
        nv_ptr, nv_int = None, int(n_valid)
    bin_major = layout == "bin_major"
    nb = n // bin_size
    scores = torch.empty((b, n) if bin_major else (n, b), dtype=score_dtype, device=docs.device)
    binmax = torch.empty((b, nb) if bin_major else (nb, b), dtype=torch.float32, device=docs.device)
    stream = torch.cuda.current_stream(docs.device).cuda_stream
    rc = _bin_scores_lib()(
        queries.data_ptr(), docs.data_ptr(), scores.data_ptr(), binmax.data_ptr(),
        nv_ptr, nv_int, b, n, dim, bin_size, int(bin_major),
        int(score_dtype == torch.bfloat16), stream,
    )
    kernels.check(rc, "bin_scores")
    kernels.LAUNCHES[f"bin_scores_{layout}"] += 1
    return scores, binmax


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
    k: int, n_valid: Optional[Rows], tile_n: int, docs: torch.Tensor,
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, Rows]:
    """The ``k > n_valid`` fail-fast and the zero padding of the shard's row
    axis to the lcm of ``tile_n`` and the two-level ``chunk`` (G*M), so the
    two-level tail sees nb % M == 0. The kernel takes any batch, so queries
    are not padded. A shard that is already a multiple is not copied."""
    n_rows = docs.shape[0]
    if n_valid is None:
        n_valid = n_rows
    if isinstance(n_valid, int) and k > n_valid:
        raise ValueError(f"k={k} > num docs {n_valid}")
    lcm_tile = tile_n if chunk is None else tile_n * chunk // math.gcd(tile_n, chunk)
    n_pad = _ceil_to(n_rows, lcm_tile)
    if n_pad != n_rows:
        docs = torch.nn.functional.pad(docs, (0, 0, 0, n_pad - n_rows))
        if isinstance(n_valid, int):
            n_valid = min(n_valid, n_rows)
    return docs, n_valid


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
    bin_max: torch.Tensor, k_bins: int, super_size: int
) -> torch.Tensor:
    """Two-level bin selection over BIN-MAJOR maxima (B, nb): super-max
    reduce -> best ``k_bins`` supers -> their M-contiguous bin maxima -> best
    ``k_bins`` bins; returns the bin ids sorted ascending."""
    b, nb = bin_max.shape
    if nb % super_size:
        raise ValueError(f"{nb} bins not a multiple of super_size {super_size}")
    ns = nb // super_size
    bm3 = bin_max.reshape(b, ns, super_size)
    super_max = bm3.amax(dim=2)
    ks = min(k_bins, ns)
    _, sup_ids = _stable_topk(super_max, ks)
    sup_ids, _ = torch.sort(sup_ids, dim=1)
    cand_bm = torch.gather(bm3, 1, sup_ids[:, :, None].expand(b, ks, super_size))
    cand_bins = _expand_ids(sup_ids, super_size)
    kb = min(k_bins, cand_bins.shape[1])
    _, pos = _stable_topk(cand_bm.reshape(b, -1), kb)
    bin_ids, _ = torch.sort(torch.gather(cand_bins, 1, pos), dim=1)
    return bin_ids


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
        tile_b = int(TUNED_DEFAULTS["topk.tile_b"])
    docs, n_valid = _prep_shard(k, n_valid, tile_n, docs, chunk=bin_size * super_size)
    if bin_major:
        def run(q):
            scores_bm, binmax_bm = bin_scores(
                q, docs, n_valid, bin_size, layout="bin_major", score_dtype=score_dtype
            )
            return _topk_from_bins_two_level_bm(scores_bm, binmax_bm, k, bin_size, super_size)
    else:
        def run(q):
            scores_t, bin_max_t = bin_scores(
                q, docs, n_valid, bin_size, layout="transposed", score_dtype=score_dtype
            )
            return _topk_from_bins_two_level(scores_t, bin_max_t, k, bin_size, super_size)
    return _by_query_chunks(queries, tile_b, run)


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
    selects kernel A in the transposed layout (the ``bins_pallas`` route);
    otherwise phase 1 is plain PyTorch (the ``bins_xla`` route).
    ``score_dtype=torch.bfloat16`` halves the score writes but rounds scores,
    so near-ties may reorder. Returns (values f32 (B, k), row ids (B, k));
    ties go to the lower row id."""
    if bin_size is None:
        bin_size = _auto_bin_size(k)
    if not use_kernel:
        docs, n_valid = _prep_shard(k, n_valid, bin_size, docs)
        scores, bin_max = _bin_scores_xla(queries, docs, bin_size, n_valid)
        return _topk_from_bins(scores, bin_max, k, bin_size)
    docs, n_valid = _prep_shard(k, n_valid, tile_n, docs)

    def run(q):
        scores_t, bin_max_t = bin_scores(
            q, docs, n_valid, bin_size, layout="transposed", score_dtype=score_dtype
        )
        return _topk_from_bins(scores_t, bin_max_t.T, k, bin_size, scores_transposed=True)

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
    bins_pallas | bins_two_level (``bins_pallas`` is the kernel A route in
    the transposed layout; the name is the JAX package's).

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
        raise NotImplementedError(
            "method='bins_rescore' needs the bin-max-only kernel "
            "(ops/topk.py::_binmax_only_pallas), still to be ported: "
            "ROADMAP queue 2, kernel 5"
        )
    raise ValueError(f"unknown method {method!r}")
