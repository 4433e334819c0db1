"""Driver ``encode_corpus``: indexing a corpus, as ``cli encode-corpus`` runs
it (``pipeline.corpus.encode_corpus``, no ``--pack``), into a shard store
under the run's temporary directory.

The source is a stream over a pool of ``pool`` passages made in set-up: each
pass over the pool is a new seeded order with fresh docids, and the stream
ends at the first pass that starts after the window's ``--seconds``. The
pool is one store batch (``pool`` = ``batch_size``), so every batch holds
the same lengths and every seed the same work. Passage lengths (tokens with
the template's specials) are the mid-quantiles of a lognormal (``length``:
median, mean, lo, hi). The configuration names the model family, its
widths, its tokenizer and its served dtype.

The check reads the store back (manifest, docids, raw bf16 rows): every
passage the stream gave has its row in stream order, else ``malformed``
counts it; a seeded sample of rows, with the pool's longest passages in it,
is held against the reference forward of the same text on the same
weights in float32 (``one_minus_cos``). ``variant="control"`` encodes with
the port's int8 weight quantization (``weight_quant="int8"``).
"""

from __future__ import annotations

import json
import time
from typing import Dict

import numpy as np
import torch

from harness import compare, data, models, text

# the traffic at a CPU test's size, and the model size at which the port
# quantizes the control's weights
TINY = {"pool": 256, "batch_size": 256, "enc_batch": 32, "sample_rows": 24, "longest_rows": 2,
        "length": {"median": 20, "mean": 24, "lo": 8, "hi": 64}}
TINY_CONTROL = {"layers": 8, "hidden": 256}


class PhaseStats:
    """The encoder behind a proxy that keeps ``last_phase_stats`` of every
    ``encode_documents`` call (the port's own host phase counters)."""

    def __init__(self, encoder) -> None:
        self._enc = encoder
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._enc, name)

    def encode_documents(self, *args, **kw):
        out = self._enc.encode_documents(*args, **kw)
        self.calls.append(dict(self._enc.last_phase_stats or {}))
        return out


class PoolStream:
    """(docid, text) pairs: passes over the pool, each in a seeded order,
    until ``done()`` is true at the start of a pass."""

    def __init__(self, pool, seed: int, done) -> None:
        self.pool, self.seed, self.done = pool, seed, done
        self.passes = 0

    def order(self, p: int) -> np.ndarray:
        return data.np_rng(self.seed, "pass", p).permutation(len(self.pool))

    def __iter__(self):
        while not self.done():
            for j in self.order(self.passes):
                yield f"{self.passes}-{j}", self.pool[j]
            self.passes += 1


def setup(ctx) -> Dict:
    t = ctx.traffic
    if t["pool"] != t["batch_size"]:
        raise ValueError("the pool is one store batch: pool must equal batch_size")
    enc, ref_tok = models.port_encoder(ctx)
    lo, hi = t["length"]["lo"], t["length"]["hi"]
    lengths = data.quantile_lengths(t["pool"], t["length"]["median"], t["length"]["mean"], lo, hi)
    rng = data.np_rng(ctx.seed, "pool")
    n_words = rng.permutation(lengths) - text.special_count(ctx.config["tokenizer"])
    pool = data.texts_of_lengths(n_words, ctx.config["tokenizer"]["words"][1], rng)
    tokens = np.asarray([len(ref_tok(s)) for s in pool])
    # the window's shapes: one store batch through the same call
    enc.encode_documents(pool, batch_size=t["enc_batch"], readback_dtype=torch.bfloat16)
    return {"encoder": PhaseStats(enc), "pool": pool, "tokens": tokens, "ref_tok": ref_tok}


def window(ctx, state) -> Dict:
    from codemix_dense_retrieval_torch.pipeline.corpus import encode_corpus

    t = ctx.traffic
    out = ctx.tmp / "store"
    state["out"] = out
    with ctx.window() as elapsed:
        stream = PoolStream(state["pool"], ctx.seed, lambda: elapsed() >= ctx.seconds)
        with torch.profiler.record_function("corpus.encode_corpus"):
            encode_corpus(state["encoder"], {"xx": stream}, out, batch_size=t["batch_size"],
                          enc_batch=t["enc_batch"], storage_dtype=t["storage_dtype"])
    state["passes"] = stream.passes
    passages = stream.passes * len(state["pool"])
    return {
        "e2e": {"encode_passages_per_s": passages / ctx.window_s},
        "counters": {"passes": stream.passes, "pool_tokens": state["tokens"].tolist(),
                     "phase_stats": state["encoder"].calls},
        "attempted": passages,
        "failed": 0,
    }


def read_store(directory):
    """(rows (n, d) f32, docids) of a finished bf16 store, read from its
    files: ``manifest.json``, ``emb.*.bin`` (raw bf16), ``docids.txt``."""
    man = json.loads((directory / "manifest.json").read_text())
    if man["dtype"] != "bfloat16":
        raise ValueError(f"store dtype {man['dtype']}")
    parts = [np.fromfile(directory / f["name"], dtype=np.uint16).reshape(-1, man["dim"]) for f in man["files"]]
    raw = np.concatenate(parts) if parts else np.zeros((0, man["dim"]), np.uint16)
    rows = torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16).to(torch.float32)
    docids = (directory / "docids.txt").read_text().split("\n") if man["count"] else []
    return rows, docids


def check(ctx, state) -> Dict[str, float]:
    from harness.core import free_device

    t, pool = ctx.traffic, state["pool"]
    state.pop("encoder")
    free_device(ctx.device)
    stream = PoolStream(pool, ctx.seed, None)
    expect = [f"{p}-{j}" for p in range(state["passes"]) for j in stream.order(p)]
    try:
        rows, docids = read_store(state["out"] / "xx")
    except (OSError, ValueError, KeyError) as exc:
        ctx.log(f"store unreadable: {exc!r}")
        return {"malformed": float(len(expect))}
    n = min(len(docids), len(expect), len(rows))
    same = np.asarray(docids[:n], dtype=object) == np.asarray(expect[:n], dtype=object)
    malformed = int((~same).sum()) + abs(len(expect) - n) + abs(len(docids) - len(rows))
    rng = data.np_rng(ctx.seed, "check")
    pick = set(rng.choice(n, size=min(t["sample_rows"], n), replace=False).tolist()) if n else set()
    if state["passes"]:
        # the pool's longest passages, in one seeded pass
        p = int(rng.integers(0, state["passes"]))
        at = np.empty(len(pool), np.int64)
        at[stream.order(p)] = np.arange(len(pool))
        longest = np.argsort(-state["tokens"], kind="stable")[: t["longest_rows"]]
        pick |= {int(p * len(pool) + at[j]) for j in longest}
    pick = sorted(i for i in pick if i < n and same[i])
    numbers = {"malformed": float(malformed)}
    if pick:
        texts = sorted({int(docids[i].split("-")[1]) for i in pick})
        t0 = time.perf_counter()
        ref = dict(zip(texts, models.reference_embed(ctx, [pool[j] for j in texts], state["ref_tok"])))
        ctx.log(f"reference forward of {len(ref)} passages: {time.perf_counter() - t0:.1f} s")
        served = rows[pick].to(ctx.device)
        want = torch.stack([ref[int(docids[i].split("-")[1])] for i in pick])
        numbers.update(compare.embedding_numbers(served, want))
        # the least 1 - cos between two texts' reference rows: how far a row
        # swapped for another text's moves (not compared)
        refs = torch.stack(list(ref.values()))
        numbers["text_spread"] = float((1 - (refs[1:] * refs[:-1]).sum(dim=1)).min())
    return numbers


# Faults a run of this driver can have, each planted in the port underneath
# the timed path: ``FAULTS[name](cell) -> (object, attribute, replacement)``.

def _layers_unchanged(cell):
    from harness.core import family_of

    return family_of(cell.config).port_layer(), "forward", lambda self, x, *a, **k: x


def _half_batch(cell):
    from codemix_dense_retrieval_torch.models.encoder import TextEncoder

    inner = TextEncoder._forward

    def broken(self, method, *args, **kw):
        h = (args[0].shape[0] + 1) // 2
        out = inner(self, method, *(a[:h] for a in args), **kw)
        return torch.cat([out, out])[: args[0].shape[0]]

    return TextEncoder, "_forward", broken


def _token_altered(cell):
    """One token of every text (its second) changed to the next word id."""
    from codemix_dense_retrieval_torch.models.tokenizer import HFTokenizer

    lo, hi = cell.config["tokenizer"]["words"]
    inner = HFTokenizer.encode_batch

    def broken(self, texts, max_length=None):
        ids, mask = inner(self, texts, max_length)
        ids[:, 1] = lo + (ids[:, 1] - lo + 1) % (hi - lo)
        return ids, mask

    return HFTokenizer, "encode_batch", broken


FAULTS = {"state_unchanged": _layers_unchanged, "half_batch": _half_batch, "token_altered": _token_altered}
