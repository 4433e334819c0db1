"""Driver ``encode_corpus_routed``: ``encode_corpus`` (the same set-up,
window, tiny traffic and faults) for a model that routes its tokens to
experts, with one more number in the check and a deeper control model for
the CPU tests.

Why: in bf16 a mixture of experts' router flips some tokens' expert sets
against a float32 forward of the same weights (a token whose sixth and
seventh affinities lie within bf16's rounding of each other), and flips
compound over layers. A CPU emulation of 16 MoE layers (hidden 512, 64
experts, top 6, sigmoid and bias) changed 1% of the tokens' expert sets at
the first MoE layer and 19% at the last. A flipped route moves a row by
far more than rounding does, and the largest ``1 - cos`` over the sampled
rows, which ``encode_corpus``'s check compares, is set by the rows that
flipped most: it did not tell int8 weights from sound bf16 runs there.
The median over the same rows did (about 2.2x apart). On one H100 the
Moonlight cell's bf16 forward chose another expert set than the float32
reference for 3.9% of the tokens at its first MoE layer and 71% at its
16th; over 15 seeds its median ``1 - cos`` read 0.020-0.042 and its max
0.24-0.31, int8 weights 0.087-0.096 and 0.31-0.32. So the check adds
``median_one_minus_cos``, over the rows ``encode_corpus.check`` holds
against the reference; every number of that check stays.

The limits follow (route flips make a sound bf16 run's numbers large), so
the CPU tests' control model (``TINY_CONTROL``, int8 weights against a
float32 forward) takes 16 layers: its flips compound over the MoE layers
as the cell's do, where ``encode_corpus``'s 8 layers stay under the limits.
"""

from __future__ import annotations

from typing import Dict

from harness import compare
from harness.core import BENCH, load_module

_base = load_module(BENCH / "drivers" / "encode_corpus.py", "drivers.encode_corpus_routed_base")


class _WithMedian:
    """``harness.compare`` for the base check: ``embedding_numbers`` also
    gives the median ``1 - cos`` of the rows it is handed."""

    def __getattr__(self, name):
        return getattr(compare, name)

    @staticmethod
    def embedding_numbers(served, ref) -> Dict[str, float]:
        s, r = served.float(), ref.float()
        cos = (s * r).sum(dim=1) / (s.norm(dim=1) * r.norm(dim=1)).clamp_min(1e-30)
        return {**compare.embedding_numbers(served, ref), "median_one_minus_cos": float((1.0 - cos).median())}


_base.compare = _WithMedian()

TINY, FAULTS = _base.TINY, _base.FAULTS
TINY_CONTROL = {"layers": 16, "hidden": 256}
# the check: encode_corpus's numbers and median_one_minus_cos over the same rows
setup, window, check = _base.setup, _base.window, _base.check
