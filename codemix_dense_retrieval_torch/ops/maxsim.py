"""MaxSim late-interaction scoring (ColBERT-style multi-vector rerank):

    score(q, d) = sum_i max_j  q_i . d_j

over valid query tokens i and valid doc tokens j; a candidate with no valid
token scores 0 and an invalid query token adds 0. The two-stage path
(:mod:`~codemix_dense_retrieval_torch.pipeline.rerank`) recalls candidates
with the dense index, then reranks them here: kernel 6 (:func:`maxsim_scores`,
``csrc/maxsim.cu``) on the card, its plain version on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from codemix_dense_retrieval_torch.ops import kernels
from codemix_dense_retrieval_torch.ops.sketch import full_f32
from codemix_dense_retrieval_torch.parallel.sharded_search import _merge_two_key

# f32 bytes of gathered doc tokens per chunk of the plain version
_PLAIN_CHUNK_BYTES = 1 << 30


def maxsim_scores_plain(
    q_tokens: torch.Tensor,  # (B, Tq, d)
    q_mask: torch.Tensor,    # (B, Tq) 1 = valid query token
    d_tokens: torch.Tensor,  # (B, K, Td, d) candidate doc token embeddings
    d_mask: torch.Tensor,    # (B, K, Td)
) -> torch.Tensor:
    """Plain PyTorch version of :func:`maxsim_scores`, on any device: (B, K)
    f32 scores from f32 products (true f32), a few queries at a time so the
    f32 copy of the doc tokens stays near 1 GB."""
    b, k, td, d = d_tokens.shape
    step = max(1, _PLAIN_CHUNK_BYTES // max(1, k * td * d * 4))
    out = []
    with full_f32():
        for i in range(0, b, step):
            sim = torch.einsum(
                "bqd,bktd->bkqt", q_tokens[i : i + step].to(torch.float32),
                d_tokens[i : i + step].to(torch.float32),
            )
            sim = torch.where(d_mask[i : i + step, :, None, :] > 0, sim, -torch.inf)
            best = sim.amax(dim=-1)  # (b, K, Tq)
            best = torch.where(q_mask[i : i + step, None, :] > 0, best, 0.0)
            # candidates with no valid tokens score 0
            best = torch.where(torch.isfinite(best), best, 0.0)
            out.append(best.sum(dim=-1))
    return torch.cat(out) if out else torch.zeros((0, k), dtype=torch.float32, device=d_tokens.device)


_MAXSIM_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]
# the kernel's doc token dtype codes
_DOC_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def _maxsim_lib():
    fn = kernels.load("maxsim").maxsim_launch
    if fn.argtypes is None:
        fn.argtypes = _MAXSIM_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def maxsim_scores(
    q_tokens: torch.Tensor,
    q_mask: torch.Tensor,
    d_tokens: torch.Tensor,
    d_mask: torch.Tensor,
) -> torch.Tensor:
    """Kernel 6: MaxSim scores (B, K) f32 of queries ``q_tokens`` (B, Tq, d)
    against their candidates ``d_tokens`` (B, K, Td, d), with masks (B, Tq)
    and (B, K, Td). CPU tensors take :func:`maxsim_scores_plain`; CUDA
    tensors launch the kernel (``csrc/maxsim.cu``), which takes f32 queries
    (split into bf16 hi + lo inside), bf16, f16 or f32 doc tokens (split
    into bf16 parts inside; int8 stores are dequantized to bf16 by the
    caller), d % 64 == 0 and d <= 1216, B <= 65,535."""
    if q_tokens.device.type == "cpu" and d_tokens.device.type == "cpu":
        return maxsim_scores_plain(q_tokens, q_mask, d_tokens, d_mask)
    dev = d_tokens.device
    if dev.type != "cuda" or q_tokens.device != dev:
        raise ValueError(
            f"maxsim needs q_tokens and d_tokens on one CUDA device (or both on the CPU), "
            f"got {q_tokens.device} and {d_tokens.device}"
        )
    if d_tokens.dtype not in _DOC_DTYPES:
        raise ValueError(
            f"maxsim on CUDA takes bf16, f16 or f32 doc tokens, got {d_tokens.dtype} "
            "(int8 stores are dequantized to bf16 by the caller)"
        )
    b, tq, d = q_tokens.shape
    _, k, td, d2 = d_tokens.shape
    if d_tokens.shape[0] != b or d2 != d or q_mask.shape != (b, tq) or d_mask.shape != (b, k, td):
        raise ValueError(
            f"shapes q {tuple(q_tokens.shape)}, q_mask {tuple(q_mask.shape)}, "
            f"d {tuple(d_tokens.shape)}, d_mask {tuple(d_mask.shape)} do not match"
        )
    if d % 64 or d > 1216 or b > 65_535:
        raise ValueError(f"maxsim needs d % 64 == 0, d <= 1216 and B <= 65535 (d={d}, B={b})")
    out = torch.zeros((b, k), dtype=torch.float32, device=dev)
    if b == 0 or k == 0 or tq == 0 or td == 0:
        return out
    q = q_tokens.to(dev, torch.float32).contiguous()
    dt = d_tokens.contiguous()
    qm = q_mask.to(dev, torch.int32).contiguous()
    dm = d_mask.to(dev, torch.int32).contiguous()
    if q.data_ptr() % 16 or dt.data_ptr() % 16:
        raise ValueError("q_tokens and d_tokens must be 16-byte aligned")
    rc = kernels.launch(
        _maxsim_lib(), dev,
        q.data_ptr(), qm.data_ptr(), dt.data_ptr(), dm.data_ptr(), out.data_ptr(),
        b, k, tq, td, d, _DOC_DTYPES[dt.dtype],
    )
    kernels.check(rc, "maxsim")
    kernels.LAUNCHES["maxsim" + kernels.dtype_suffix(dt.dtype)] += 1
    return out


def maxsim_rerank(
    q_tokens: torch.Tensor,
    q_mask: torch.Tensor,
    d_tokens: torch.Tensor,
    d_mask: torch.Tensor,
    candidate_ids: torch.Tensor,  # (B, K) global ids from the dense stage
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rerank dense-stage candidates by MaxSim: (scores sorted descending,
    reordered candidate ids), ties to the lower id."""
    scores = maxsim_scores(q_tokens, q_mask, d_tokens, d_mask)
    return _merge_two_key(scores, candidate_ids.to(scores.device, torch.int64), scores.shape[1])
