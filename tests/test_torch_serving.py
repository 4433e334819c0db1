"""The port's online serving (serving.py): coalescing, per-request k, the
HTTP transport, validation and error paths, online mutation, snapshots and
warmup, over the port's index on the CPU; and one parity test, the same
request sequence through the JAX package's SearchService over its index (a
one-shard mesh, Pallas in interpret mode), with the same reply JSON: docids
and certificates equal, scores within 1e-5 (the same bf16 products summed in
another order). Every wait has its own timeout of at most 30 s."""

import http.client
import json
import threading
import time
import zlib

import numpy as np
import pytest

from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex
from codemix_dense_retrieval_torch.serving import SearchService, make_server

WAIT = 30  # seconds, every future and socket


class FakeEncoder:
    """Deterministic text -> unit vector (seeded by a CRC of the text), with
    an optional encode delay that holds the consumer so requests coalesce."""

    def __init__(self, dim=32, delay_s=0.0):
        self.dim = dim
        self.delay_s = delay_s
        self.calls = []

    def encode_queries(self, texts, batch_size=64):
        if self.delay_s:
            time.sleep(self.delay_s)
        self.calls.append(list(texts))
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            v = np.random.default_rng(zlib.crc32(t.encode())).standard_normal(self.dim)
            out[i] = v / np.linalg.norm(v)
        return out

    def encode_queries_tokens(self, texts, batch_size=64):
        """The dense vector repeated as 3 tokens, so MaxSim ranks as the
        dense scores do."""
        dense = self.encode_queries(texts, batch_size)
        return np.repeat(dense[:, None, :], 3, axis=1), np.full(len(texts), 3, np.int32)

    def encode_documents_with_tokens(self, texts, batch_size=64, max_tokens=None):
        dense = self.encode_queries(texts, batch_size)
        return dense, np.repeat(dense[:, None, :], 3, axis=1)[:, :max_tokens], np.full(len(texts), 3, np.int32)


def _unit_rows(seed, n, d=32):
    v = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.fixture
def corpus_index():
    return DenseFlatIndex.build(_unit_rows(3, 512), [f"d{i}" for i in range(512)]).to_device("cpu")


def make_service(index, **kw):
    enc = FakeEncoder(delay_s=kw.pop("delay_s", 0.0))
    return enc, SearchService(enc, index, **kw)


class TestService:
    def test_single_request_matches_direct_search(self, corpus_index):
        enc, svc = make_service(corpus_index)
        try:
            res = svc.submit(["hello world"], k=5).result(WAIT)
            assert len(res) == 1 and len(res[0]) == 5
            scores, docids = corpus_index.search(enc.encode_queries(["hello world"]), 5)
            assert [r["docid"] for r in res[0]] == [str(d) for d in docids[0]]
            np.testing.assert_allclose([r["score"] for r in res[0]], scores[0], rtol=1e-5)
        finally:
            svc.close()

    def test_concurrent_requests_coalesce(self, corpus_index):
        # the encode delay holds batch 1 while the others queue, so they merge
        enc, svc = make_service(corpus_index, delay_s=0.05, max_wait_s=0.2, max_batch=64)
        try:
            futs = [svc.submit([f"q{i}"], k=3) for i in range(8)]
            results = [f.result(WAIT) for f in futs]
            assert all(len(r[0]) == 3 for r in results)
            stats = svc.stats.snapshot()
            assert stats["requests"] == 8 and stats["batches"] < 8, stats
            for i, r in enumerate(results):  # each request gets its own query's results
                _, docids = corpus_index.search(enc.encode_queries([f"q{i}"]), 3)
                assert [x["docid"] for x in r[0]] == [str(d) for d in docids[0]]
        finally:
            svc.close()

    def test_mixed_k_in_one_batch(self, corpus_index):
        _, svc = make_service(corpus_index, delay_s=0.05, max_wait_s=0.2, max_batch=64)
        try:
            f1, f2 = svc.submit(["a"], k=2), svc.submit(["b"], k=9)
            assert len(f1.result(WAIT)[0]) == 2
            assert len(f2.result(WAIT)[0]) == 9
        finally:
            svc.close()

    def test_validation(self, corpus_index):
        _, svc = make_service(corpus_index, max_k=100)
        try:
            with pytest.raises(ValueError, match="non-empty"):
                svc.submit([])
            with pytest.raises(ValueError, match="non-empty"):
                svc.submit(["ok", ""])
            with pytest.raises(ValueError, match="k must be"):
                svc.submit(["x"], k=101)
            with pytest.raises(ValueError, match="at most"):
                svc.submit(["x"] * 1000, k=5)
        finally:
            svc.close()

    def test_oversize_batch_defers_to_next(self, corpus_index):
        _, svc = make_service(corpus_index, delay_s=0.05, max_wait_s=0.2, max_batch=4)
        try:
            futs = [svc.submit([f"q{i}", f"r{i}"], k=2) for i in range(4)]
            assert all(len(f.result(WAIT)) == 2 for f in futs)
            assert svc.stats.snapshot()["batches"] >= 2
        finally:
            svc.close()

    def test_consumer_survives_encoder_failure(self, corpus_index):
        enc, svc = make_service(corpus_index)
        try:
            orig, boom = enc.encode_queries, {"n": 0}

            def flaky(texts, batch_size=64):
                if boom["n"] == 0:
                    boom["n"] = 1
                    raise RuntimeError("transient encode failure")
                return orig(texts, batch_size)

            enc.encode_queries = flaky
            with pytest.raises(RuntimeError, match="transient"):
                svc.submit(["x"], k=1).result(WAIT)
            assert svc.submit(["y"], k=1).result(WAIT)[0]  # the consumer still serves
            assert svc.stats.snapshot()["errors"] == 1
        finally:
            svc.close()

    def test_approx_mode_returns_certificates(self, corpus_index):
        corpus_index.enable_sketch(sketch_dim=16, probe_bins=48, cache=False)
        _, svc = make_service(corpus_index, approx=True)
        try:
            res = svc.submit(["hello world", "second"], k=5).result(WAIT)
            assert len(res) == 2
            for row in res:
                assert set(row) == {"hits", "certified"}
                assert isinstance(row["certified"], bool) and len(row["hits"]) == 5
        finally:
            svc.close()

    def test_approx_requires_sketch_capable_index(self):
        class NoSketch:
            count = 10

        with pytest.raises(ValueError, match="sketch"):
            SearchService(FakeEncoder(), NoSketch(), approx=True)

    @pytest.mark.parametrize("mode", ["adaptive", "guaranteed"])
    def test_exact_tiers_serve_exact_results(self, corpus_index, mode):
        """approx='adaptive' and 'guaranteed' through the service: exact
        serving's ids, every certificate True."""
        _, svc = make_service(corpus_index)
        try:
            exact = svc.submit(["hello world", "second"], k=5).result(WAIT)
        finally:
            svc.close()
        _, svc = make_service(corpus_index, approx=mode)
        try:
            res = svc.submit(["hello world", "second"], k=5).result(WAIT)
            for row, ex in zip(res, exact):
                assert set(row) == {"hits", "certified"} and row["certified"] is True
                assert [h["docid"] for h in row["hits"]] == [h["docid"] for h in ex]
        finally:
            svc.close()

    def test_bad_approx_mode_rejected(self, corpus_index):
        with pytest.raises(ValueError, match="approx must be"):
            SearchService(FakeEncoder(), corpus_index, approx="typo")

    def test_online_add_then_searchable(self, corpus_index):
        _, svc = make_service(corpus_index)
        try:
            before = corpus_index.count
            out = svc.submit_add([{"docid": "live-1", "text": "freshly added doc"}]).result(WAIT)
            assert out == {"added": 1, "count": before + 1}
            # the doc's own text retrieves it first (the fake encoder is deterministic)
            assert svc.submit(["freshly added doc"], k=3).result(WAIT)[0][0]["docid"] == "live-1"
            out = svc.submit_remove(["live-1", "never-there"]).result(WAIT)
            assert out == {"removed": 1, "count": before}
            res = svc.submit(["freshly added doc"], k=3).result(WAIT)
            assert all(r["docid"] != "live-1" for r in res[0])
        finally:
            svc.close()

    def test_two_stage_serving(self, tmp_path):
        """A TwoStageSearcher behind the service: the query token blocks of
        odd batch sizes (zero-length pad rows), then two-stage add and
        remove through the consumer."""
        from codemix_dense_retrieval_torch.io.token_shards import TokenShardStore, TokenShardWriter
        from codemix_dense_retrieval_torch.pipeline.rerank import TwoStageSearcher

        enc = FakeEncoder()
        texts = [f"doc number {i}" for i in range(128)]
        dense = enc.encode_queries(texts)
        w = TokenShardWriter(tmp_path / "tok", token_dim=enc.dim, tokens_per_doc=3)
        w.append(np.repeat(dense[:, None, :], 3, axis=1), np.full(128, 3, np.int32), [f"d{i}" for i in range(128)])
        w.finalize()
        index = DenseFlatIndex.build(dense, [f"d{i}" for i in range(128)], dtype="float32").to_device("cpu")
        searcher = TwoStageSearcher(index, TokenShardStore.open(tmp_path / "tok"))
        svc = SearchService(enc, searcher, index_search_kwargs={"k_dense": 16})
        try:
            assert svc.two_stage
            res = svc.submit([texts[7], texts[42], texts[99]], k=3).result(WAIT)
            assert [r[0]["docid"] for r in res] == ["d7", "d42", "d99"]
            out = svc.submit_add([{"docid": "live-2s", "text": "two stage live doc"}]).result(WAIT)
            assert out == {"added": 1, "count": 129}
            assert svc.submit(["two stage live doc"], k=2).result(WAIT)[0][0]["docid"] == "live-2s"
            out = svc.submit_remove(["live-2s"]).result(WAIT)
            assert out == {"removed": 1, "count": 128}
            res = svc.submit(["two stage live doc"], k=3).result(WAIT)
            assert all(r["docid"] != "live-2s" for r in res[0])
            with pytest.raises(ValueError, match="dense-only"):
                svc.submit_reload("x")
        finally:
            svc.close()

    def test_concurrent_search_and_mutation_stress(self):
        """Searches from 32 submitting threads (a switch interval of 1 us)
        interleaved with add/removes: every future resolves, no consumer
        error, no lost stats update, and the index ends at the expected
        count. The admin operations are enqueued from this thread in round
        order, so each remove reaches the queue after the add of its docid
        (the service ignores unknown docids, as the JAX one does)."""
        import sys
        from concurrent.futures import ThreadPoolExecutor

        idx = DenseFlatIndex.build(_unit_rows(5, 256), [f"d{i}" for i in range(256)],
                                   dtype="float32").to_device("cpu")
        _, svc = make_service(idx, max_wait_s=0.002)
        futures, admin = [], []
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            with ThreadPoolExecutor(max_workers=32) as pool:
                for rnd in range(6):
                    futures += [pool.submit(svc.submit, [f"q{rnd}-{j}", f"p{rnd}-{j}"], 5) for j in range(8)]
                    admin.append(svc.submit_add([{"docid": f"live-{rnd}", "text": f"fresh {rnd}"}]))
                    if rnd % 2:
                        admin.append(svc.submit_remove([f"live-{rnd - 1}"]))
                inner = [f.result(WAIT) for f in futures] + admin
            assert all(f.result(WAIT) for f in inner)
            stats = svc.stats.snapshot()
            assert stats["errors"] == 0 and stats["requests"] == 48 and stats["queries"] == 96
            assert stats["batched_queries"] == 96
            assert idx.count == 256 + 6 - 3
            assert {f"live-{r}" for r in (1, 3, 5)} <= set(idx.docids[: idx.count])
        finally:
            sys.setswitchinterval(interval)
            svc.close()

    def test_admin_validation(self, corpus_index):
        _, svc = make_service(corpus_index)
        try:
            with pytest.raises(ValueError, match="docid"):
                svc.submit_add([{"text": "missing id"}])
            with pytest.raises(ValueError, match="strings"):
                svc.submit_remove([])
        finally:
            svc.close()


class TestHTTP:
    @pytest.fixture
    def server(self, corpus_index):
        enc, svc = make_service(corpus_index, max_wait_s=0.01)
        srv = make_server(svc, port=0, info={"model": "fake"})
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        yield srv.server_address[:2], enc, svc
        srv.shutdown()
        srv.server_close()
        svc.close()

    @staticmethod
    def _req(addr, method, path, body=None):
        conn = http.client.HTTPConnection(*addr, timeout=WAIT)
        try:
            conn.request(method, path, body=json.dumps(body) if body is not None else None,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    def test_healthz(self, server):
        status, data = self._req(server[0], "GET", "/healthz")
        assert status == 200 and data["ok"] and data["model"] == "fake" and "stats" in data

    def test_search_roundtrip(self, server):
        status, data = self._req(server[0], "POST", "/search", {"queries": ["foo", "bar"], "k": 4})
        assert status == 200 and len(data["results"]) == 2
        assert all(len(r) == 4 for r in data["results"])
        assert {"docid", "score"} <= set(data["results"][0][0])

    def test_bad_requests(self, server):
        addr = server[0]
        assert self._req(addr, "POST", "/search", {"queries": []})[0] == 400
        assert self._req(addr, "POST", "/search", {"queries": "notalist"})[0] == 400
        assert self._req(addr, "GET", "/nope")[0] == 404
        assert self._req(addr, "POST", "/nope", {})[0] == 404

    def test_failed_batch_is_a_500(self, server):
        addr, enc, svc = server

        def broken(texts, batch_size=64):
            raise RuntimeError("card lost")

        enc.encode_queries = broken
        status, data = self._req(addr, "POST", "/search", {"queries": ["x"], "k": 1})
        assert status == 500 and data == {"error": "RuntimeError: card lost"}
        assert svc.stats.snapshot()["errors"] == 1

    def test_save_requires_snapshot_root(self, server):
        status, data = self._req(server[0], "POST", "/save", {"dir": "x"})
        assert status == 400 and "snapshot_root" in data["error"]

    def test_save_snapshot_roundtrip(self, corpus_index, tmp_path):
        _, svc = make_service(corpus_index, max_wait_s=0.01, snapshot_root=str(tmp_path))
        srv = make_server(svc, port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        addr = srv.server_address[:2]
        try:
            self._req(addr, "POST", "/add", {"docs": [{"docid": "snap-doc", "text": "to be persisted"}]})
            status, data = self._req(addr, "POST", "/save", {"dir": "snap"})
            assert status == 200 and data["results"] == {"saved": str(tmp_path / "snap"), "count": 513}
            assert "snap-doc" in set(DenseFlatIndex.load(tmp_path / "snap").docids)
            status, data = self._req(addr, "POST", "/save", {"dir": "../outside"})
            assert status == 400 and "escapes" in data["error"]
        finally:
            srv.shutdown()
            srv.server_close()
            svc.close()

    def test_add_remove_roundtrip(self, server):
        addr, _, svc = server
        before = svc.index.count
        status, data = self._req(addr, "POST", "/add", {"docs": [{"docid": "http-doc", "text": "added over http"}]})
        assert status == 200 and data["results"]["added"] == 1
        _, data = self._req(addr, "POST", "/search", {"queries": ["added over http"], "k": 1})
        assert data["results"][0][0]["docid"] == "http-doc"
        status, data = self._req(addr, "POST", "/remove", {"docids": ["http-doc"]})
        assert status == 200 and data["results"]["removed"] == 1 and svc.index.count == before
        assert self._req(addr, "POST", "/add", {"docs": []})[0] == 400


class TestWarmup:
    def test_warmup_drives_every_bucket(self, corpus_index):
        _, svc = make_service(corpus_index, max_batch=8, default_k=5, max_k=32)
        try:
            out = svc.warmup()
            # every power-of-two batch bucket {1, 2, 4, 8} x the depths {default_k, max_k}
            assert out["programs"] == 8 and out["seconds"] >= 0
            assert svc.stats.snapshot()["batches"] == 8
            assert len(svc.submit(["hello"], k=3).result(WAIT)[0]) == 3
        finally:
            svc.close()

    def test_warmup_explicit_combos_clamped(self, corpus_index):
        _, svc = make_service(corpus_index, max_batch=4, max_k=16)
        try:
            assert svc.warmup(ks=[50_000], batches=[3, 4])["programs"] == 1
        finally:
            svc.close()


class TestReload:
    def test_hot_reload_swaps_the_corpus(self, tmp_path):
        idx_a = DenseFlatIndex.build(_unit_rows(11, 64), [f"a{i}" for i in range(64)]).to_device("cpu")
        DenseFlatIndex.build(_unit_rows(12, 48), [f"b{i}" for i in range(48)]).save(tmp_path / "snap")
        _, svc = make_service(idx_a, snapshot_root=str(tmp_path))
        try:
            assert all(r["docid"].startswith("a") for r in svc.submit(["hello"], k=3).result(WAIT)[0])
            assert svc.submit_reload("snap").result(WAIT) == {"reloaded": str(tmp_path / "snap"), "count": 48}
            assert svc.index.device.type == "cpu"
            assert all(r["docid"].startswith("b") for r in svc.submit(["hello"], k=3).result(WAIT)[0])
            svc.submit_add([{"docid": "x", "text": "fresh doc"}]).result(WAIT)
            assert svc.index.count == 49
        finally:
            svc.close()

    def test_reload_validations(self, corpus_index, tmp_path):
        _, svc = make_service(corpus_index, snapshot_root=str(tmp_path))
        try:
            with pytest.raises(ValueError, match="escapes"):
                svc.submit_reload("../outside")
            DenseFlatIndex.build(np.eye(8, dtype=np.float32), [str(i) for i in range(8)]).save(tmp_path / "wrongdim")
            with pytest.raises(ValueError, match="dim"):
                svc.submit_reload("wrongdim").result(WAIT)
        finally:
            svc.close()

    def test_reload_requires_snapshot_root(self, corpus_index):
        _, svc = make_service(corpus_index)
        try:
            with pytest.raises(ValueError, match="snapshot"):
                svc.submit_reload("anything")
        finally:
            svc.close()


@pytest.mark.parametrize("approx", [False, "fast", "adaptive"])
def test_replies_match_the_jax_service(approx):
    """One request sequence (mixed k and batch sizes, an add, a remove)
    through both packages' services over the same rows: the same replies."""
    from codemix_dense_retrieval_tpu.index.flat import DenseFlatIndex as RefIndex
    from codemix_dense_retrieval_tpu.parallel import make_mesh
    from codemix_dense_retrieval_tpu.serving import SearchService as RefService

    rows, ids = _unit_rows(21, 500), [f"d{i}" for i in range(500)]
    ref_ix = RefIndex.build(rows, ids)
    ref_ix.to_device(make_mesh(shard=1, tp=1), pad_multiple=128)
    port_ix = DenseFlatIndex.build(rows, ids).to_device("cpu", pad_multiple=128)
    if approx == "fast":
        ref_ix.enable_sketch(sketch_dim=8, cache=False)
        port_ix.enable_sketch(sketch_dim=8, cache=False)
    steps = [
        ("search", (["alpha"], 5)),
        ("search", (["beta", "gamma", "delta"], 20)),
        ("add", [{"docid": "new-1", "text": "alpha"}, {"docid": "new-2", "text": "delta"}]),
        ("search", (["alpha", "delta", "omega"], 3)),
        ("remove", ["d3", "new-1", "ghost"]),
        ("search", (["alpha", "beta", "gamma", "delta", "epsilon"], 50)),
    ]
    replies = []
    for svc_cls, ix in ((RefService, ref_ix), (SearchService, port_ix)):
        svc = svc_cls(FakeEncoder(), ix, approx=approx)
        out = []
        try:
            for op, arg in steps:
                if op == "search":
                    out.append(svc.submit(*arg).result(WAIT))
                elif op == "add":
                    out.append(svc.submit_add(arg).result(WAIT))
                else:
                    out.append(svc.submit_remove(arg).result(WAIT))
        finally:
            svc.close()
        replies.append(json.loads(json.dumps(out)))
    ref_out, port_out = replies

    def hits(row):
        return row["hits"] if isinstance(row, dict) else row

    for (op, _), r, p in zip(steps, ref_out, port_out):
        if op != "search":
            assert p == r
            continue
        assert len(p) == len(r)
        for pr, rr in zip(p, r):
            if approx:
                assert pr["certified"] == rr["certified"]
            assert [h["docid"] for h in hits(pr)] == [h["docid"] for h in hits(rr)]
            np.testing.assert_allclose([h["score"] for h in hits(pr)], [h["score"] for h in hits(rr)],
                                       rtol=0, atol=1e-5)
