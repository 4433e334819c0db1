"""Approximate inner-product search through a PCA sketch, with a per-query
exactness certificate.

1. **Build**: fit an orthonormal projection ``P (d, ds)`` by *uncentered* PCA
   over a row sample (:func:`fit_sketch`, host numpy, identical to the JAX
   package's). Store the sketch ``S = bf16(X P)`` and per-row tail norms
   ``t_x = ||x - P f32(S_x)||``, computed against the ROUNDED stored sketch,
   so the storage rounding sits inside the bound (:func:`sketch_rows`).
   :func:`cluster_bisect_order` turns a sketch into a row order that puts
   sketch-space neighbours into the same bins (``reorder_rows``).
2. **Probe**: kernel 7 (:func:`binub`) computes the bin maxima of the score
   UPPER BOUND ``ub(x) = s_q . s_x + ||q_tail|| * t_x >= q . x``
   (Cauchy-Schwarz on the orthogonal complement), reading ``ds/d`` of the
   index bytes; the two-level bin cover selects the top ``probe_bins`` bins.
3. **Refine**: the covered bins' full-width rows are gathered and rescored
   exactly (:func:`~codemix_dense_retrieval_torch.ops.topk._rescore_candidates`,
   or the int8 rescore over a quantized index).
4. **Certify**: the largest bin maximum among the bins NOT selected bounds
   every unselected row. If it plus ``cert_margin`` is below the k-th refined
   score, no unselected row can enter the top k, so the query's result is
   the exact one.

The certificate rests on ``ub >= q . x`` for the operands the score kernels
see: queries are rounded to the index dtype before they are sketched, and
every projection and rescore runs in true f32 (TF32 is switched off for the
call, whatever the caller set).
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from codemix_dense_retrieval_torch.ops import kernels
from codemix_dense_retrieval_torch.ops.quant import quantize_rows
from codemix_dense_retrieval_torch.ops.topk import (
    NEG_INF,
    Rows,
    _ceil_to,
    _kernel_queries,
    _n_valid_arg,
    _prep_shard,
    _rescore_candidates,
    _rescore_candidates_int8,
    _rows_int,
    _select_bins_two_level,
)

#: covers f32 accumulation round-off in the ub / refined-score comparison
DEFAULT_CERT_MARGIN = 3e-5
#: the sketch tier's bin geometry (``DenseFlatIndex.calibrate_sketch`` and the
#: sharded sketch search must agree on it)
DEFAULT_BIN_SIZE = 8
DEFAULT_SUPER_SIZE = 8
#: the kernel-geometry kwargs the sketch path understands; callers filter
#: ``to_device(**search_kwargs)`` by it
SKETCH_KERNEL_KWARGS = ("bin_size", "super_size", "tile_n", "tile_b")

# round-to-nearest bf16 relative rounding bound: 8 mantissa bits
# (incl. implicit) -> |v - bf16(v)| <= 2^-8 |v|
_BF16_EPS = 2.0 ** -8
# rows per f32 chunk of the projection and of the plain version of kernel 7
_ROW_CHUNK = 262_144


@contextlib.contextmanager
def full_f32():
    """f32 matrix products in full f32 for the scope (no TF32 on the card),
    whatever the caller set; the previous settings are restored after."""
    prev_flag = torch.backends.cuda.matmul.allow_tf32
    prev_prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev_prec)
        torch.backends.cuda.matmul.allow_tf32 = prev_flag


# --------------------------------------------------------------------------
# build side
# --------------------------------------------------------------------------

def cluster_bisect_order(sketch: np.ndarray, leaf: int = DEFAULT_BIN_SIZE) -> np.ndarray:
    """Variance-guided recursive bisection order over sketch space (host
    numpy; the JAX package's permutation for the same sketch).

    Returns ``perm`` such that ``rows[perm]`` places sketch-space neighbours
    in contiguous ``leaf``-row blocks: the clustering IS the row order, so
    after the reorder each bin of the bin-max kernels is a tight sketch-space
    cell, a query's top-k falls into few bins and the probed cover's
    certificates fire. Each level splits every block at its median along the
    block's maximum-variance dimension among the ``min(ds, 32)`` leading
    (PCA-ordered) ones, about ``log2(n / leaf)`` levels.

    The JAX package's arithmetic, laid out for speed: per-block moments come
    from f32 running sums over the block-sorted sketch (the same sequential
    sums, one contiguous row per dimension, the dimensions on a thread pool),
    and its ``np.lexsort((key, block))`` is one stable argsort of a 64-bit
    (block, key) code, which orders rows alike (``-0.0`` and ``0.0`` tie in
    both; the sketch has no NaN)."""
    sketch = np.ascontiguousarray(np.asarray(sketch, np.float32))
    n, ds = sketch.shape
    order = np.arange(n, dtype=np.int64)
    if n <= leaf:
        return order
    dv = min(ds, 32)
    cols = np.ascontiguousarray(sketch[:, :dv].T)  # (dv, n)
    so = np.empty_like(cols)   # the block-sorted sketch
    cs = np.empty_like(cols)   # its running sums
    cs2 = np.empty_like(cols)  # and running sums of squares
    levels = int(math.ceil(math.log2(n / leaf)))
    bounds = np.array([0, n], dtype=np.int64)

    def moments(j: int) -> None:
        np.take(cols[j], order, out=so[j])
        np.cumsum(so[j], out=cs[j])
        np.cumsum(so[j] * so[j], out=cs2[j])

    with ThreadPoolExecutor(max_workers=min(dv, os.cpu_count() or 1)) as pool:
        for _ in range(levels):
            list(pool.map(moments, range(dv)))
            starts = bounds[:-1]
            sizes = np.diff(bounds)
            cnt = sizes.astype(np.float64)[:, None]
            ends = bounds[1:] - 1
            sums = cs[:, ends].T.astype(np.float64)
            sqs = cs2[:, ends].T.astype(np.float64)
            sums[1:] -= cs[:, ends[:-1]].T
            sqs[1:] -= cs2[:, ends[:-1]].T
            var = sqs / cnt - (sums / cnt) ** 2
            dsel = var.argmax(axis=1)  # split dim per block
            rowblock = np.repeat(np.arange(len(starts), dtype=np.uint64), sizes)
            key = (so[dsel[rowblock.astype(np.int64)], np.arange(n)] + np.float32(0)).view(np.uint32)
            # f32 order as unsigned order: negatives reversed below positives
            key = np.where(key & np.uint32(0x80000000), ~key, key | np.uint32(0x80000000))
            order = order[np.argsort((rowblock << np.uint64(32)) | key, kind="stable")]
            mids = starts + sizes // 2
            bounds = np.unique(np.concatenate([bounds, mids]))
            if np.all(np.diff(bounds) <= leaf):
                break
    return order


def sample_index(n: int, sample: int, seed: int = 0) -> np.ndarray:
    """The sorted rows :func:`fit_sketch` fits on: all ``n`` when
    ``n <= sample``, else ``sample`` drawn without replacement."""
    if n <= sample:
        return np.arange(n)
    idx = np.random.default_rng(seed).choice(n, size=sample, replace=False)
    idx.sort()
    return idx


def fit_sketch(
    rows: np.ndarray, sketch_dim: int, *, sample: int = 131072, seed: int = 0
) -> np.ndarray:
    """Fit an orthonormal (d, ds) projection by uncentered PCA on a row
    sample (:func:`sample_index`): top eigenvectors of ``E[x x^T]``.
    Deterministic."""
    rows = np.asarray(rows)
    n, d = rows.shape
    if not 0 < sketch_dim <= d:
        raise ValueError(f"sketch_dim={sketch_dim} not in (0, {d}]")
    if n > sample:
        rows = rows[sample_index(n, sample, seed)]
    x = rows.astype(np.float32)
    cov = (x.T @ x) / max(1, len(x))
    eigvals, eigvecs = np.linalg.eigh(cov.astype(np.float64))
    order = np.argsort(eigvals)[::-1][:sketch_dim]
    return np.ascontiguousarray(eigvecs[:, order].astype(np.float32))


def _sketch_with_err(
    x: torch.Tensor, proj: torch.Tensor, sketch_dtype: torch.dtype
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(stored sketch ``s`` in ``sketch_dtype``, tail norms
    ``t = ||x - P f32(s)||``, in-range rounding norms ``e = ||P^T x - f32(s)||``)
    of the rows ``x``. Every bound is for the STORED sketch, so
    ``q.x <= s_q.s_d + t_q t_d + e_q||s_d|| + ||s_q|| e_d`` holds with the
    values kernel 7 multiplies. The projection runs in true f32."""
    x = x.to(torch.float32)
    with full_f32():
        s_full = x @ proj.to(x.device, torch.float32)
    s = s_full.to(sketch_dtype)
    s32 = s.to(torch.float32)
    err = s_full - s32
    e = torch.sqrt(torch.sum(err * err, dim=1))
    # ||x - P s32||^2 = ||x||^2 - 2 (P^T x).s32 + ||s32||^2 (P orthonormal);
    # the clamp guards round-off at near-zero tails
    t2 = torch.clamp(
        torch.sum(x * x, dim=1) - 2.0 * torch.sum(s_full * s32, dim=1) + torch.sum(s32 * s32, dim=1),
        min=0.0,
    )
    return s, torch.sqrt(t2), e


def _sketch_chunks(
    n: int, rows_of: Callable[[int, int], torch.Tensor], proj: torch.Tensor,
    device: torch.device, sketch_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sketch and tails of ``n`` rows, ``_ROW_CHUNK`` at a time, so no f32
    copy of a whole shard exists."""
    ds = proj.shape[1]
    sketch = torch.empty((n, ds), dtype=sketch_dtype, device=device)
    tails = torch.empty(n, dtype=torch.float32, device=device)
    for r0 in range(0, n, _ROW_CHUNK):
        r1 = min(r0 + _ROW_CHUNK, n)
        s, t, _ = _sketch_with_err(rows_of(r0, r1), proj, sketch_dtype)
        sketch[r0:r1] = s
        tails[r0:r1] = t
    return sketch, tails


def sketch_rows(
    docs: torch.Tensor, proj: torch.Tensor, sketch_dtype: torch.dtype = torch.bfloat16
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row sketch (N, ds) ``sketch_dtype`` and tail bounds (N,) f32, on
    the rows' device, with ``tails[i] >= ||x_i - P f32(sketch_i)||``. bf16 is
    the stored type on every default path; the in-range rounding is folded
    into the per-query certificate slack by :func:`topk_ip_sketch`."""
    proj = proj.to(docs.device, torch.float32)
    return _sketch_chunks(docs.shape[0], lambda a, b: docs[a:b], proj, docs.device, sketch_dtype)


def sketch_queries(
    queries: torch.Tensor, proj: torch.Tensor, sketch_dtype: torch.dtype = torch.bfloat16
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query-side sketch: (q_sketch (B, ds), q_tail_norm (B,) f32)."""
    return sketch_rows(queries, proj, sketch_dtype)


def sketch_rows_int8(
    d_vals: torch.Tensor, d_scales: torch.Tensor, proj: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sketch and tail bounds of a quantized index's EFFECTIVE corpus, the
    dequantized rows ``vals * scale`` that the int8 scores rank."""
    proj = proj.to(d_vals.device, torch.float32)
    return _sketch_chunks(
        d_vals.shape[0],
        lambda a, b: d_vals[a:b].to(torch.float32) * d_scales[a:b, None],
        proj, d_vals.device, torch.bfloat16,
    )


# --------------------------------------------------------------------------
# phase 1: upper-bound bin maxima (kernel 7 and its plain version)
# --------------------------------------------------------------------------

def binub_plain(
    q_sketch: torch.Tensor,
    q_tail: torch.Tensor,
    d_sketch: torch.Tensor,
    d_tail: torch.Tensor,
    bin_size: int,
    n_valid: Rows,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`binub`, on any device: f32 products of
    the sketches (true f32), ``s + d_tail * q_tail``, rows at or past
    ``n_valid`` set to ``NEG_INF``, bin maxima (B, N/G) f32 bin-major, one
    chunk of rows at a time."""
    b, n = q_sketch.shape[0], d_sketch.shape[0]
    if n % bin_size:
        raise ValueError(f"rows {n} not a multiple of bin_size {bin_size}")
    nv = _rows_int(n_valid)
    qs = q_sketch.to(torch.float32)
    qt = q_tail.reshape(-1).to(torch.float32)
    dt = d_tail.reshape(-1)
    out = torch.empty((b, n // bin_size), dtype=torch.float32, device=d_sketch.device)
    with full_f32():
        for r0 in range(0, n, _ROW_CHUNK):
            r1 = min(r0 + _ROW_CHUNK, n)
            ub = qs @ d_sketch[r0:r1].to(torch.float32).T
            ub = ub + dt[None, r0:r1].to(torch.float32) * qt[:, None]
            if nv < r1:
                ub[:, max(nv - r0, 0):] = NEG_INF
            out[:, r0 // bin_size : r1 // bin_size] = ub.view(b, -1, bin_size).amax(dim=2)
    return out


_BINUB_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
]


def _binub_lib(dtype: torch.dtype):
    fn = kernels.load("bin_scores" + kernels.dtype_suffix(dtype)).binub_launch
    if fn.argtypes is None:
        fn.argtypes = _BINUB_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def binub(
    q_sketch: torch.Tensor,  # (B, ds)
    q_tail: torch.Tensor,    # (B,) f32
    d_sketch: torch.Tensor,  # (N, ds)
    d_tail: torch.Tensor,    # (N,) f32
    bin_size: int,
    n_valid: Rows,
) -> torch.Tensor:
    """Kernel 7: bin maxima (B, N/G) f32, bin-major, of the sketch upper
    bound ``q_sketch . d_sketch + q_tail * d_tail`` with rows at or past
    ``n_valid`` (an int or a one-element int32 tensor on the sketch's device)
    set to ``NEG_INF``. CPU tensors take :func:`binub_plain`; CUDA tensors
    launch the kernel instance of the sketch dtype (``csrc/bin_scores.cu``
    bf16, ``bin_scores_f32.cu`` f32: f32-faithful 3xTF32 products, as the
    JAX package runs its f32 sketch at ``Precision.HIGHEST``), which takes
    ds % 32 == 0, N % G == 0 and G in {8, 16}."""
    if q_sketch.device.type == "cpu" and d_sketch.device.type == "cpu":
        return binub_plain(q_sketch, q_tail, d_sketch, d_tail, bin_size, n_valid)
    dt = d_sketch.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"binub on CUDA takes a bf16 or f32 sketch, got {dt}")
    b, ds = q_sketch.shape
    n = d_sketch.shape[0]
    if q_sketch.device != d_sketch.device or q_sketch.dtype != dt:
        raise ValueError(f"q_sketch must be {dt} on the doc sketch's CUDA device")
    if d_sketch.ndim != 2 or d_sketch.shape[1] != ds:
        raise ValueError(f"sketches {tuple(q_sketch.shape)} x {tuple(d_sketch.shape)} do not contract")
    if bin_size not in (8, 16) or ds % 32 or n % bin_size or b == 0:
        raise ValueError(f"binub needs G in (8, 16), ds % 32 == 0, N % G == 0, B > 0 "
                         f"(G={bin_size}, ds={ds}, N={n}, B={b})")
    q_tail = q_tail.reshape(-1)
    d_tail = d_tail.reshape(-1)
    for label, t, rows in (("q_tail", q_tail, b), ("d_tail", d_tail, n)):
        if (t.device != d_sketch.device or t.dtype != torch.float32 or t.shape != (rows,)
                or not t.is_contiguous()):
            raise ValueError(f"{label} must be a contiguous f32 ({rows},) tensor on {d_sketch.device}")
    for label, t in (("q_sketch", q_sketch), ("d_sketch", d_sketch)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{label} must be contiguous and 16-byte aligned")
    nv_ptr, nv_int = _n_valid_arg(n_valid, d_sketch)
    out = torch.empty((b, n // bin_size), dtype=torch.float32, device=d_sketch.device)
    q_arg = _kernel_queries(q_sketch)
    rc = kernels.launch(
        _binub_lib(dt), d_sketch.device,
        q_arg.data_ptr(), q_tail.data_ptr(), d_sketch.data_ptr(), d_tail.data_ptr(),
        out.data_ptr(), nv_ptr, nv_int, b, n, ds, bin_size,
    )
    kernels.check(rc, "binub")
    kernels.LAUNCHES["binub" + kernels.dtype_suffix(dt)] += 1
    return out


# --------------------------------------------------------------------------
# phase 2: cover + certificate
# --------------------------------------------------------------------------

def _max_row_norm_sq(x: torch.Tensor) -> torch.Tensor:
    """max_i ||x_i||^2 in f32, one chunk of rows at a time."""
    best = torch.zeros((), dtype=torch.float32, device=x.device)
    for r0 in range(0, x.shape[0], _ROW_CHUNK):
        xf = x[r0 : r0 + _ROW_CHUNK].to(torch.float32)
        best = torch.maximum(best, torch.sum(xf * xf, dim=1).max())
    return best


def _sketch_round_slack(d_sketch: torch.Tensor, q_sketch: torch.Tensor, q_err: torch.Tensor):
    """Per-query certificate slack for ROUNDED (bf16-stored) sketches, 0 for
    an f32 sidecar. Kernel 7's ub misses the two in-range rounding cross
    terms ``e_q ||s_d|| + ||s_q|| e_d`` of the score decomposition; e_q is
    exact per query and e_d is bounded by ``_BF16_EPS / (1 - eps)`` times the
    largest ``||s_d||``."""
    if d_sketch.dtype == torch.float32:
        return torch.zeros((), dtype=torch.float32, device=d_sketch.device)
    d_snorm_max = torch.sqrt(_max_row_norm_sq(d_sketch))
    q_snorm = torch.sqrt(torch.sum(q_sketch.to(torch.float32) ** 2, dim=1))
    return d_snorm_max * (q_err + _BF16_EPS * 1.01 * q_snorm)


def _default_probe_bins(k: int, bin_size: int, nb: int, expand: float) -> int:
    min_bins = -(-k // bin_size)
    return max(min(nb, int(math.ceil(min_bins * expand))), min(min_bins + 4, nb))


def topk_ip_sketch(
    queries: torch.Tensor,   # (B, d)
    docs: torch.Tensor,      # (N, d) full-width rows (bf16/f32)
    d_sketch: torch.Tensor,  # (N, ds) from sketch_rows
    d_tail: torch.Tensor,    # (N,) f32 from sketch_rows
    proj: torch.Tensor,      # (d, ds) f32 from fit_sketch
    k: int,
    *,
    probe_bins: Optional[int] = None,
    expand: float = 4.0,
    bin_size: int = DEFAULT_BIN_SIZE,
    super_size: int = DEFAULT_SUPER_SIZE,
    tile_b: int = 512,
    tile_n: int = 1024,
    n_valid: Optional[Rows] = None,
    cert_margin: float = DEFAULT_CERT_MARGIN,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Approximate top-k with per-query exactness certificates.

    Returns (values f32 (B, k), row ids (B, k), certified bool (B,)).
    ``certified[q]`` True means row q's result is provably that of exact
    search: no unselected bin's upper bound reaches the k-th refined score
    (strictly, with ``cert_margin`` absorbing the f32 summation order).
    Queries are rounded to ``docs.dtype`` before scoring, so "exact" is the
    exact top-k of ``round(q) . docs``, the operands the score kernels see."""
    if probe_bins is None:
        nb_est = _ceil_to(docs.shape[0], tile_n) // bin_size
        probe_bins = _default_probe_bins(k, bin_size, nb_est, expand)
    # round-trip the queries through the docs' dtype: ub and the refined
    # scores then see the values the exact path's kernels multiply, and the
    # sketch / tail / bound math stays f32 over those values
    proj = proj.to(docs.device, torch.float32)
    queries = queries.to(docs.device)
    if queries.dtype != docs.dtype and docs.is_floating_point():
        queries = queries.to(docs.dtype).to(torch.float32)
    queries = queries.to(torch.float32)
    sketch_dt = d_sketch.dtype
    q_sketch, q_tail, q_err = _sketch_with_err(queries, proj, sketch_dt)
    cert = torch.as_tensor(cert_margin, dtype=torch.float32, device=docs.device)
    cert = cert + _sketch_round_slack(d_sketch, q_sketch, q_err)
    if docs.element_size() >= 4:
        # f32 docs: the JAX package's DEFAULT-precision kernels round the
        # operands to bf16, so its margin absorbs that product rounding,
        # |kernel - true| <= 2 eps_bf16 ||q|| max||x|| (eps = 2^-9). The
        # port's f32 products are exact, but the term is kept so the
        # certificates equal the JAX package's.
        eps = 2.0 ** -9
        d_snorm_sq = []
        for r0 in range(0, d_sketch.shape[0], _ROW_CHUNK):
            sk = d_sketch[r0 : r0 + _ROW_CHUNK].to(torch.float32)
            sn = torch.sqrt(torch.sum(sk * sk, dim=1))
            if sketch_dt != torch.float32:
                sn = sn * (1.0 + 1.01 * _BF16_EPS)
            tl = d_tail[r0 : r0 + _ROW_CHUNK]
            d_snorm_sq.append((sn * sn + tl * tl).max())
        row_norm_max = torch.sqrt(torch.stack(d_snorm_sq).max())
        q_sk32 = q_sketch.to(torch.float32)
        # ||P^T q|| <= ||s_q32|| + e_q (triangle inequality)
        q_snorm = torch.sqrt(torch.sum(q_sk32 * q_sk32, dim=1)) + q_err
        q_norm = torch.sqrt(q_snorm * q_snorm + q_tail * q_tail)
        cert = cert + 2.0 * eps * q_norm * row_norm_max

    def rescore(doc_payload, q_payload, bin_ids, nv):
        return _rescore_candidates(doc_payload[0], q_payload[0], bin_ids, bin_size, nv, k)

    return _probe_rescore_certify(
        k, n_valid, tile_b, tile_n, bin_size, super_size, probe_bins, cert,
        [docs], [queries], d_sketch, d_tail, q_sketch, q_tail, rescore,
    )


def _probe_rescore_certify(
    k: int, n_valid: Optional[Rows], tile_b: int, tile_n: int, bin_size: int,
    super_size: int, probe_bins: int, cert_margin: torch.Tensor,
    doc_payload: List[torch.Tensor], q_payload: List[torch.Tensor],
    d_sketch: torch.Tensor, d_tail: torch.Tensor, q_sketch: torch.Tensor,
    q_tail: torch.Tensor, rescore,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The certified probe shared by the float and int8 sketch tiers: pad the
    row axis, kernel 7's upper-bound bin maxima, the two-level cover with the
    unselected bound, the payload's rescore, the certificate comparison.
    Queries run ``tile_b`` at a time (the (tile_b, N/G) bin maxima are the
    peak memory); ``rescore(doc_payload, q_payload, bin_ids, n_valid)``
    returns the refined (vals, ids)."""
    (*doc_payload, d_sketch, d_tail), n_valid = _prep_shard(
        k, n_valid, tile_n, [*doc_payload, d_sketch, d_tail.reshape(-1)],
        chunk=bin_size * super_size,
    )
    b = q_sketch.shape[0]
    cert_margin = cert_margin.expand(b) if cert_margin.ndim == 0 else cert_margin
    outs = []
    with full_f32():
        for i in range(0, b, tile_b):
            sl = slice(i, i + tile_b)
            bin_ub = binub(q_sketch[sl].contiguous(), q_tail[sl].contiguous(), d_sketch, d_tail,
                           bin_size, n_valid)
            kb = min(probe_bins, bin_ub.shape[1])
            if kb * bin_size < k:
                raise ValueError(
                    f"probe_bins={kb} x bin_size={bin_size} < k={k}: too few candidates"
                )
            bin_ids, unsel_ub = _select_bins_two_level(
                bin_ub, kb, super_size, return_unselected_bound=True
            )
            del bin_ub
            vals, idx = rescore(doc_payload, [p[sl] for p in q_payload], bin_ids, n_valid)
            outs.append((vals, idx, (unsel_ub + cert_margin[sl]) < vals[:, -1]))
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat([o[j] for o in outs]) for j in range(3))


def topk_ip_sketch_int8(
    queries: torch.Tensor,   # (B, d) float
    d_vals: torch.Tensor,    # (N, d) int8
    d_scales: torch.Tensor,  # (N,) f32 per-row scales
    d_sketch: torch.Tensor,  # (N, ds) from sketch_rows_int8
    d_tail: torch.Tensor,    # (N,) f32
    proj: torch.Tensor,      # (d, ds) f32
    k: int,
    *,
    probe_bins: Optional[int] = None,
    expand: float = 4.0,
    bin_size: int = DEFAULT_BIN_SIZE,
    super_size: int = DEFAULT_SUPER_SIZE,
    tile_b: int = 512,
    tile_n: int = 1024,
    n_valid: Optional[Rows] = None,
    cert_margin: float = DEFAULT_CERT_MARGIN,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Approximate top-k over an INT8 index with exactness certificates;
    "exact" is the int8 path's own top-k (exact integer products,
    ``(acc * d_scale) * q_scale``). The effective corpus is the dequantized
    rows (:func:`sketch_rows_int8`) and the effective query the dequantized
    quantized query, so the float tier's bound applies verbatim; the refine
    gathers 1-byte rows and rescores them bit-identically to the int8 path."""
    if probe_bins is None:
        nb_est = _ceil_to(d_vals.shape[0], tile_n) // bin_size
        probe_bins = _default_probe_bins(k, bin_size, nb_est, expand)
    proj = proj.to(d_vals.device, torch.float32)
    # quantize the queries once: the bound and the rescore see the same
    # effective query as the exact int8 path
    q_i8, q_sc = quantize_rows(queries.to(d_vals.device, torch.float32))
    q_eff = q_i8.to(torch.float32) * q_sc[:, None]
    q_sketch, q_tail, q_err = _sketch_with_err(q_eff, proj, d_sketch.dtype)
    # the rescore is exact; only the sketch-storage rounding terms apply
    cert = torch.as_tensor(cert_margin, dtype=torch.float32, device=d_vals.device)
    cert = cert + _sketch_round_slack(d_sketch, q_sketch, q_err)

    def rescore(doc_payload, q_payload, bin_ids, nv):
        dv, dsc = doc_payload
        qv, qsc = q_payload
        return _rescore_candidates_int8(dv, dsc, qv, qsc, bin_ids, bin_size, nv, k)

    return _probe_rescore_certify(
        k, n_valid, tile_b, tile_n, bin_size, super_size, probe_bins, cert,
        [d_vals, d_scales], [q_i8, q_sc], d_sketch, d_tail, q_sketch, q_tail, rescore,
    )



def shard_topk_sketch(
    queries: torch.Tensor,
    docs: torch.Tensor,
    d_sketch: torch.Tensor,
    d_tail: torch.Tensor,
    proj: torch.Tensor,
    k: int,
    *,
    n_valid: Optional[Rows],
    doc_scales: Optional[torch.Tensor] = None,
    probe_bins: Optional[int] = None,
    expand: float = 4.0,
    bin_size: Optional[int] = None,
    super_size: Optional[int] = None,
    tile_b: Optional[int] = None,
    tile_n: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One padded shard's sketch search, the per-shard entry of
    :func:`~codemix_dense_retrieval_torch.parallel.sharded_search.sharded_topk_ip_sketch`:
    :func:`topk_ip_sketch`, or :func:`topk_ip_sketch_int8` over an int8
    shard (``doc_scales`` its per-row scales). ``bin_size``, ``super_size``
    and ``tile_b`` None take the tier's own; ``probe_bins`` None is worked
    out from the shard's ``docs.shape[0] // bin_size`` bins, as the JAX
    package's sharded tier does."""
    bin_size = bin_size or DEFAULT_BIN_SIZE
    if probe_bins is None:
        probe_bins = _default_probe_bins(k, bin_size, docs.shape[0] // bin_size, expand)
    kw = dict(probe_bins=probe_bins, bin_size=bin_size, super_size=super_size or DEFAULT_SUPER_SIZE,
              tile_n=tile_n, n_valid=n_valid)
    if tile_b is not None:
        kw["tile_b"] = tile_b
    if docs.dtype == torch.int8:
        if doc_scales is None:
            raise ValueError("int8 index requires doc_scales")
        return topk_ip_sketch_int8(queries, docs, doc_scales, d_sketch, d_tail, proj, k, **kw)
    return topk_ip_sketch(queries, docs, d_sketch, d_tail, proj, k, **kw)
