def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1). The search service rounds each
    coalesced batch's depth k and its query count up to it
    (:mod:`~codemix_dense_retrieval_torch.serving`), as the JAX service
    does: the depth sets what ``approx="fast"`` certifies at, and the
    zero-padded batch sets the query blocks the adaptive tier's escalation
    sees, so the buckets are kept for parity of results."""
    return 1 << max(0, int(n - 1).bit_length())
