"""models/encoder.py's host pipeline: the phase stats (``last_phase_stats``,
the JAX package's keys), the reader thread (``_overlap_read``: job order
and a bounded window), and embeddings through it bit for bit equal to a
serial run of the same batches (the same forward on the CPU, read back in
the same order)."""

import random
import threading
import time

import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.models.encoder import TextEncoder as PortEncoder
from codemix_dense_retrieval_torch.models.xlmr import XLMRConfig
from codemix_dense_retrieval_tpu.models.encoder import TextEncoder as RefEncoder

TINY = dict(vocab_size=300, hidden_size=32, num_heads=4, intermediate_size=64, max_position_embeddings=80)


@pytest.fixture(scope="module")
def encoder():
    return PortEncoder("BAAI/bge-m3", XLMRConfig.tiny(**TINY, use_flash=False), seed=5, device="cpu",
                       length_buckets=(16, 32, 64))


def _texts(seed, n=29):
    rng = np.random.default_rng(seed)
    return [" ".join(f"t{x}" for x in rng.integers(0, 250, rng.integers(1, 50))) for _ in range(n)]


@pytest.mark.parametrize("call", ["queries", "documents", "packed", "with_tokens", "packed_with_tokens", "tokens"])
def test_phase_stats_keys_equal_jax(encoder, call):
    texts = _texts(0)
    run = {
        "queries": lambda: encoder.encode_queries(texts, batch_size=8),
        "documents": lambda: encoder.encode_documents(texts, batch_size=8),
        "packed": lambda: encoder.encode_documents(texts, batch_size=8, pack=True),
        "with_tokens": lambda: encoder.encode_documents_with_tokens(texts, batch_size=8),
        "packed_with_tokens": lambda: encoder.encode_documents_with_tokens(texts, batch_size=8, pack=True),
        "tokens": lambda: encoder.encode_documents_tokens(texts, batch_size=8),
    }[call]
    encoder.last_phase_stats = None
    run()
    stats = encoder.last_phase_stats
    assert set(stats) == set(RefEncoder._new_phase_stats())
    assert isinstance(stats["batches"], int) and stats["batches"] >= 1
    # the wall holds the main thread's steps and its waits on the reader
    assert stats["wall"] >= stats["job_iter"] >= stats["tokenize_wait"] >= 0.0
    assert stats["wall"] >= stats["readback_wait"] >= 0.0
    assert stats["tokenize_work"] > 0.0
    if call in ("queries", "documents"):
        assert stats["batches"] == -(-len(texts) // 8)


def test_overlap_read_keeps_job_order_and_bounds_its_window(encoder):
    depth = encoder._PREFETCH_DEPTH
    lock = threading.Lock()
    state = {"yielded": 0, "done": 0, "max_ahead": 0}
    rng = random.Random(0)
    delays = [rng.uniform(0, 0.004) for _ in range(40)]

    def read(i):
        time.sleep(delays[i])
        with lock:
            state["done"] += 1
        return i

    def jobs():
        for i in range(40):
            with lock:
                state["max_ahead"] = max(state["max_ahead"], state["yielded"] - state["done"])
                state["yielded"] += 1
            yield read, (i,)

    stats = encoder._new_phase_stats()
    out = encoder._overlap_read(jobs(), stats)
    assert out == list(range(40))
    # the generator never runs more than the window ahead of the reads
    assert state["max_ahead"] <= depth
    assert stats["readback_work"] >= sum(delays) * 0.9
    assert encoder._overlap_read(iter(()), None) == []


def test_overlap_read_reraises_a_failed_read(encoder):
    def bad():
        raise ValueError("readback failed")

    with pytest.raises(ValueError, match="readback failed"):
        encoder._overlap_read(iter([(bad, ())]))


@pytest.mark.parametrize("readback_dtype", [None, torch.bfloat16])
def test_reader_thread_embeddings_equal_a_serial_run(encoder, readback_dtype):
    texts = _texts(1, 41)
    got = encoder.encode_documents(texts, batch_size=6, readback_dtype=readback_dtype)
    order = encoder._length_order(texts)
    sorted_texts = [texts[i] for i in order]
    outs = []
    with torch.inference_mode():
        for ids, mask in encoder._batch_inputs(sorted_texts, 6, "", None):
            emb = encoder.model(ids, mask)
            if readback_dtype is not None:
                emb = emb.to(readback_dtype)
            outs.append(emb.to(torch.float32).numpy())
    want = np.concatenate(outs)[encoder._inverse(order)]
    np.testing.assert_array_equal(got, want)
    dense, toks, lens = encoder.encode_documents_with_tokens(texts, batch_size=6)
    np.testing.assert_array_equal(dense, encoder.encode_documents(texts, batch_size=6))
    assert toks.shape[0] == len(texts) and lens.shape == (len(texts),)


def test_batch_inputs_are_int64_host_tensors_padded_to_a_bucket(encoder):
    batches = list(encoder._batch_inputs(_texts(2, 10), 4, "", None))
    assert len(batches) == 3
    for ids, mask in batches:
        assert ids.dtype == mask.dtype == torch.int64 and ids.device.type == "cpu"
        assert ids.shape == mask.shape and ids.shape[1] in (16, 32, 64)
        assert bool((ids[mask == 0] == encoder.tokenizer.pad_id).all())
