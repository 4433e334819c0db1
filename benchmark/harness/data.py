"""Seeded inputs of the cells, made the same way for the port and for the
reference.

Every stream of random numbers is named, ``(seed, name, ...)``, and hashed
into a generator seed of its own, so one cell's inputs never depend on how
much another stream drew. Work sizes (how many rows, passages, requests,
tokens) never depend on the seed: a seed draws values and orders from a
fixed set of sizes (:func:`quantile_lengths`), so
two seeds ask for the same work.
"""

from __future__ import annotations

import hashlib
import math
import statistics
from typing import List, Optional, Sequence

import numpy as np
import torch

ROW_CHUNK = 262_144   # rows per generator of an index (a fixed part of the recipe)


def stream_seed(seed: int, *names) -> int:
    """A 63-bit generator seed for the named stream of run seed ``seed``."""
    text = repr((int(seed), *names)).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(), "little") >> 1


def torch_gen(device, seed: int, *names) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, *names))


def np_rng(seed: int, *names) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, *names))


def unit_rows(n: int, d: int, gen: torch.Generator, device) -> torch.Tensor:
    x = torch.randn(n, d, device=device, generator=gen)
    return x / x.norm(dim=1, keepdim=True)


class IndexRows:
    """The rows of an index of ``n`` x ``d`` unit rows in ``dtype``, made on
    ``device`` in blocks of :data:`ROW_CHUNK` rows, each from a generator of
    its own, so any range can be made again alone; ``planted`` rows
    (positions, rows) replace the random ones at their positions."""

    def __init__(self, n: int, d: int, seed: int, device, dtype=torch.bfloat16,
                 planted_pos: Optional[torch.Tensor] = None, planted_rows: Optional[torch.Tensor] = None):
        self.n, self.d, self.seed, self.device, self.dtype = n, d, seed, torch.device(device), dtype
        self.pos = planted_pos
        self.rows = None if planted_rows is None else planted_rows.to(self.device, dtype)

    def chunk(self, c: int) -> torch.Tensor:
        lo, hi = c * ROW_CHUNK, min(self.n, (c + 1) * ROW_CHUNK)
        out = unit_rows(hi - lo, self.d, torch_gen(self.device, self.seed, "rows", c), self.device).to(self.dtype)
        if self.pos is not None:
            sel = (self.pos >= lo) & (self.pos < hi)
            out[self.pos[sel] - lo] = self.rows[sel]
        return out

    def __call__(self, start: int, stop: int) -> torch.Tensor:
        """Rows [start, stop) on the device."""
        parts = []
        for c in range(start // ROW_CHUNK, (stop - 1) // ROW_CHUNK + 1):
            lo = c * ROW_CHUNK
            parts.append(self.chunk(c)[max(start, lo) - lo: min(stop, lo + ROW_CHUNK) - lo])
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def host(self) -> torch.Tensor:
        """All rows as one host tensor (pageable memory)."""
        out = torch.empty((self.n, self.d), dtype=self.dtype)
        for c in range(0, -(-self.n // ROW_CHUNK)):
            lo = c * ROW_CHUNK
            out[lo: lo + ROW_CHUNK].copy_(self.chunk(c))
        return out


def query_pairs(n: int, d: int, noise: float, seed: int, device):
    """(a, b): ``n`` unit query rows and their second-language twins
    ``normalize(a + noise * u)``, u a random unit direction."""
    g = torch_gen(device, seed, "queries")
    a = unit_rows(n, d, g, device)
    b = a + noise * unit_rows(n, d, g, device)
    return a, b / b.norm(dim=1, keepdim=True)


def planted_rows(mixed: torch.Tensor, n_rows: int, spread: float, seed: int, device):
    """(positions, rows): one row per query at a distinct random position,
    ``normalize(mixed + spread * u)``, u a random unit direction."""
    g = torch_gen(device, seed, "planted")
    pos = torch.randperm(n_rows, device=device, generator=g)[: len(mixed)]
    near = mixed + spread * unit_rows(len(mixed), mixed.shape[1], g, device)
    return pos, near / near.norm(dim=1, keepdim=True)


def quantile_lengths(count: int, median: float, mean: float, lo: int, hi: int) -> np.ndarray:
    """``count`` lengths at the mid-quantiles of a lognormal of the given
    median and mean, rounded and clipped to [lo, hi]: the same multiset for
    every seed."""
    mu = math.log(median)
    sigma = math.sqrt(2.0 * math.log(mean / median))
    nd = statistics.NormalDist()
    q = [math.exp(mu + sigma * nd.inv_cdf((i + 0.5) / count)) for i in range(count)]
    return np.clip(np.rint(q), lo, hi).astype(np.int64)


def words_text(word_ids: Sequence[int]) -> str:
    """The text of vocabulary word slots: ``w<hex>`` words joined by spaces."""
    return " ".join(f"w{j:x}" for j in word_ids)


def texts_of_lengths(n_words: Sequence[int], vocab_words: int, rng: np.random.Generator) -> List[str]:
    """One text per entry of ``n_words``, its words drawn uniformly from the
    vocabulary's word slots."""
    total = int(np.sum(n_words))
    ids = rng.integers(0, vocab_words, size=total)
    out, pos = [], 0
    for n in n_words:
        out.append(words_text(ids[pos: pos + int(n)]))
        pos += int(n)
    return out
