"""Host-side sequence packing for the corpus encode.

Length bucketing (:mod:`~codemix_dense_retrieval_torch.models.encoder`)
removes the padding between batches; packing removes it inside a bucket:
several short passages share one device row under a block-diagonal
attention mask (``segment_ids`` of
:func:`~codemix_dense_retrieval_torch.ops.flash_attention.multi_head_attention`),
so the forward computes almost no pad tokens.

Packing is best-fit-decreasing: callers feed sequences longest first (the
encoder length-sorts), each sequence goes to the open row with the SMALLEST
sufficient remainder (bisect on a sorted remainder list, O(n log n)), and a
row closes when it is full or holds ``max_segments`` sequences. Per-segment
RoBERTa position ids restart at ``pad_id + 1``, so a packed passage sees the
positions it would see alone. The arrays equal the JAX package's for the
same input.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class PackedRows:
    """Fixed-shape packed batch inputs and the placement map to unpack."""

    ids: np.ndarray           # (R, S) int32, pad_id-filled
    segment_ids: np.ndarray   # (R, S) int32, 0 = pad, 1..M = sequence slot
    position_ids: np.ndarray  # (R, S) int32, restarting per segment
    seg_starts: np.ndarray    # (R, M) int32
    seg_lengths: np.ndarray   # (R, M) int32, 0 = empty slot
    placement: np.ndarray     # (n_seqs, 2) int32: (row, slot) per input sequence

    @property
    def n_rows(self) -> int:
        return self.ids.shape[0]

    @property
    def max_segments(self) -> int:
        return self.seg_starts.shape[1]


def pack_sequences(
    token_rows: Sequence[np.ndarray],
    seq_len: int,
    pad_id: int,
    max_segments: int = 16,
    pos_offset: Optional[int] = None,
    pos_pad: Optional[int] = None,
) -> PackedRows:
    """Pack unpadded token-id arrays into rows of length ``seq_len``.

    Sequences longer than ``seq_len`` are cut (the tokenizer's cap normally
    prevents it). Placement follows input order; feed longest first for
    best-fit-decreasing quality. Each segment's positions are
    ``pos_offset + arange(len)`` and pad slots carry ``pos_pad``; the
    defaults are RoBERTa's (first token at ``pad_id + 1``, pads at
    ``pad_id``)."""
    if pos_offset is None:
        pos_offset = pad_id + 1
    if pos_pad is None:
        pos_pad = pad_id
    n = len(token_rows)
    lengths = [min(len(t), seq_len) for t in token_rows]

    rows: List[List[int]] = []  # row -> its sequence indices
    row_free: List[Tuple[int, int]] = []  # sorted (remaining, row) of OPEN rows
    placement = np.zeros((n, 2), np.int32)
    for i, ln in enumerate(lengths):
        j = bisect.bisect_left(row_free, (ln, -1))
        if j < len(row_free):
            rem, r = row_free.pop(j)  # best fit: the smallest sufficient remainder
        else:
            r = len(rows)
            rows.append([])
            rem = seq_len
        rows[r].append(i)
        placement[i] = (r, len(rows[r]) - 1)
        rem -= ln
        if rem > 0 and len(rows[r]) < max_segments:
            bisect.insort(row_free, (rem, r))

    nr = max(1, len(rows))
    ids = np.full((nr, seq_len), pad_id, np.int32)
    seg = np.zeros((nr, seq_len), np.int32)
    pos = np.full((nr, seq_len), pos_pad, np.int32)
    starts = np.zeros((nr, max_segments), np.int32)
    seg_lens = np.zeros((nr, max_segments), np.int32)
    for r, members in enumerate(rows):
        cursor = 0
        for slot, i in enumerate(members):
            ln = lengths[i]
            ids[r, cursor : cursor + ln] = np.asarray(token_rows[i][:ln], np.int32)
            seg[r, cursor : cursor + ln] = slot + 1
            pos[r, cursor : cursor + ln] = pos_offset + np.arange(ln)
            starts[r, slot] = cursor
            seg_lens[r, slot] = ln
            cursor += ln
    return PackedRows(ids, seg, pos, starts, seg_lens, placement)


def pad_rows_to(batch: PackedRows, n_rows: int, *, pad_id: int) -> PackedRows:
    """Pad with empty rows up to ``n_rows`` (a whole number of device
    batches). ``pad_id`` is required: a pad id read back from the rows
    (``ids[0, -1]``) is a real token whenever row 0 is exactly full."""
    r = batch.n_rows
    if r >= n_rows:
        return batch

    def _pad(a, fill):
        out = np.full((n_rows,) + a.shape[1:], fill, a.dtype)
        out[:r] = a
        return out

    pos_pad = int(batch.position_ids.min()) if batch.position_ids.size else 0
    return PackedRows(
        _pad(batch.ids, pad_id),
        _pad(batch.segment_ids, 0),
        _pad(batch.position_ids, pos_pad),
        _pad(batch.seg_starts, 0),
        _pad(batch.seg_lengths, 0),
        batch.placement,
    )


def packing_efficiency(batch: PackedRows, seq_len: int) -> Tuple[float, int]:
    """(valid-token fraction, rows): the pad-waste diagnostic."""
    valid = int((batch.segment_ids > 0).sum())
    return valid / float(batch.n_rows * seq_len), batch.n_rows
