"""Online serving: an HTTP search endpoint that coalesces requests into
device batches.

A search pass reads the whole index whatever the batch: at 8,841,823 x 1024
bf16 rows that is 18.1 GB, at least ~5.4 ms of an H100's memory rate for one
query or for 256. Serving each request alone would leave most of the card's
throughput unused, so requests are coalesced.

Design (standard library only):

- ``SearchService`` owns the encoder and the index and one consumer thread:
  requests enqueue (texts, k); the consumer drains the queue up to
  ``max_batch`` texts (waiting at most ``max_wait_s`` after the first
  arrival), encodes once, searches once at the deepest requested depth, and
  slices each request's results. The one consumer also serializes access to
  the card.
- ``http.server.ThreadingHTTPServer`` carries the transport: many blocking
  request threads feed the one queue.

Endpoints (the JAX package's, with the same JSON, status codes and error
texts): ``GET /healthz`` (liveness and stats), ``POST /search``
``{"queries": [...], "k": 10}`` -> ``{"results": [[{"docid", "score"}, ...],
...]}``, online mutation, ``POST /add`` ``{"docs": [{"docid", "text"}, ...]}``
and ``POST /remove`` ``{"docids": [...]}`` (FAISS ``add_with_ids`` /
``remove_ids``, applied by the consumer in arrival order, never merged into a
search batch), and ``POST /save`` / ``POST /reload`` ``{"dir": ...}``
(snapshot and hot swap, inside ``snapshot_root``). With an approximate tier
each result row is ``{"hits": [...], "certified": bool}``; ``certified``
True means that query's results are provably those of exact search.
"""

from __future__ import annotations

import json
import pathlib
import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeoutError
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence

import numpy as np

from codemix_dense_retrieval_torch.utils import next_pow2


@dataclass
class ServeStats:
    requests: int = 0
    queries: int = 0
    batches: int = 0
    batched_queries: int = 0
    errors: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "requests": self.requests,
                "queries": self.queries,
                "batches": self.batches,
                "batched_queries": self.batched_queries,
                "errors": self.errors,
            }


@dataclass
class _Pending:
    texts: Sequence[str]
    k: int
    future: Future
    op: str = "search"  # search | add | remove | save | reload
    payload: Optional[Sequence] = None


class SearchService:
    """Coalescing encode + search service over one encoder and one index.

    ``index`` is anything with ``search(q, k) -> (scores, docids)`` and a
    ``count`` (``DenseFlatIndex``, ``TwoStageSearcher``). The consumer thread
    does all of the card's work; the index and rerank paths hold no state
    that depends on the thread (the encoder enters ``torch.inference_mode``
    itself)."""

    def __init__(
        self,
        encoder,
        index,
        *,
        default_k: int = 10,
        max_k: int = 1000,
        max_batch: int = 256,
        max_wait_s: float = 0.005,
        encode_batch: int = 64,
        approx: bool = False,
        snapshot_root: Optional[str] = None,
        index_search_kwargs: Optional[dict] = None,
    ) -> None:
        self.encoder = encoder
        self.index = index
        # /save and /reload touch server-side files: only under an explicit
        # root (None: snapshots disabled over HTTP)
        self.snapshot_root = snapshot_root
        # False (exact), True/"fast" (sketch, a certificate per query),
        # "guaranteed" (sketch + exact escalation: always exact) or
        # "adaptive" (probed-exact cover: always exact)
        if approx is True:
            approx = "fast"
        if approx not in (False, "fast", "guaranteed", "adaptive"):
            raise ValueError(f"approx must be False/True/'fast'/'guaranteed'/'adaptive', got {approx!r}")
        self.approx = approx
        if approx and not hasattr(index, "enable_sketch"):
            raise ValueError(f"{type(index).__name__} has no sketch tier")
        # two-stage (MaxSim) serving: a TwoStageSearcher carries a token
        # store and needs the queries' token embeddings too
        self.two_stage = hasattr(index, "tokens")
        self.index_search_kwargs = dict(index_search_kwargs or {})
        self.default_k = default_k
        self.max_k = max_k
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.encode_batch = encode_batch
        self.stats = ServeStats()
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._thread = threading.Thread(target=self._consume, name="search-batcher", daemon=True)
        self._thread.start()

    # ---------------------------------------------------------------- API

    def submit(self, texts: Sequence[str], k: Optional[int] = None) -> Future:
        """Enqueue one request; the Future resolves to one list per text of
        ``[{"docid": ..., "score": ...}, ...]``."""
        k = self.default_k if k is None else int(k)
        if not isinstance(texts, (list, tuple)) or not texts or not all(isinstance(t, str) and t for t in texts):
            raise ValueError("queries must be a non-empty list of non-empty strings")
        if not 1 <= k <= self.max_k:
            raise ValueError(f"k must be in [1, {self.max_k}]")
        if len(texts) > self.max_batch:
            raise ValueError(f"at most {self.max_batch} queries per request")
        fut: Future = Future()
        with self.stats._lock:
            self.stats.requests += 1
            self.stats.queries += len(texts)
        self._queue.put(_Pending(list(texts), k, fut))
        return fut

    def search(self, texts: Sequence[str], k: Optional[int] = None) -> List[list]:
        return self.submit(texts, k).result()

    def submit_add(self, docs: Sequence[dict]) -> Future:
        """Enqueue an online addition, ``[{"docid", "text"}, ...]``, encoded
        and applied by the consumer. Resolves to ``{"added", "count"}``."""
        if not hasattr(self.index, "add"):
            raise ValueError(f"{type(self.index).__name__} is not mutable")
        if not isinstance(docs, (list, tuple)) or not docs or not all(
            isinstance(d, dict)
            and isinstance(d.get("docid"), str) and d["docid"]
            and isinstance(d.get("text"), str) and d["text"]
            for d in docs
        ):
            raise ValueError("docs must be a non-empty list of {docid, text} objects")
        if len(docs) > self.max_batch:
            raise ValueError(f"at most {self.max_batch} docs per request")
        fut: Future = Future()
        self._queue.put(_Pending([], 0, fut, op="add", payload=list(docs)))
        return fut

    def _resolve_snapshot(self, directory) -> str:
        """A client's snapshot path, which must resolve inside
        ``snapshot_root``: an unrestricted path would let any client read or
        write wherever the serving user can."""
        if self.snapshot_root is None:
            raise ValueError("snapshots disabled: start the service with snapshot_root (serve --snapshot_root DIR)")
        if not isinstance(directory, str) or not directory:
            raise ValueError("dir must be a non-empty path string")
        root = pathlib.Path(self.snapshot_root).resolve()
        target = (root / directory).resolve()
        if not target.is_relative_to(root):
            raise ValueError(f"dir escapes snapshot_root: {directory!r}")
        return str(target)

    def submit_save(self, directory: str) -> Future:
        """Enqueue a snapshot of the live index; resolves to ``{"saved",
        "count"}``."""
        if not hasattr(self.index, "save"):
            raise ValueError(f"{type(self.index).__name__} cannot save")
        target = self._resolve_snapshot(directory)
        fut: Future = Future()
        self._queue.put(_Pending([], 0, fut, op="save", payload=[target]))
        return fut

    def submit_reload(self, directory: str) -> Future:
        """Enqueue a hot swap to a snapshot directory inside
        ``snapshot_root``: the consumer loads and uploads the new index and
        replaces the live one between batches. Dense services only (a
        two-stage snapshot carries a token store: restart to swap it).
        Resolves to ``{"reloaded", "count"}``."""
        if self.two_stage:
            raise ValueError("reload is dense-only: restart the server to swap a two-stage (token store) snapshot")
        target = self._resolve_snapshot(directory)
        fut: Future = Future()
        self._queue.put(_Pending([], 0, fut, op="reload", payload=[target]))
        return fut

    def submit_remove(self, docids: Sequence[str]) -> Future:
        """Enqueue an online removal by docid; resolves to ``{"removed",
        "count"}`` (unknown docids are ignored)."""
        if not hasattr(self.index, "remove"):
            raise ValueError(f"{type(self.index).__name__} is not mutable")
        if not isinstance(docids, (list, tuple)) or not docids or not all(isinstance(x, str) and x for x in docids):
            raise ValueError("docids must be a non-empty list of strings")
        fut: Future = Future()
        self._queue.put(_Pending([], 0, fut, op="remove", payload=list(docids)))
        return fut

    def warmup(self, ks=None, batches=None, text: str = "warm query") -> dict:
        """Drive every serving bucket once before traffic. On a CUDA card the
        first call of a shape pays the kernels' first-use build (``nvcc``
        into ``csrc/build/`` when no library is cached there), cuBLAS handle
        creation and the caching allocator's first reservations; warming
        moves that before the first client. One request per (batch bucket,
        k bucket) through the real path (encode -> search -> format):
        every power-of-two batch up to ``max_batch`` (and ``max_batch``
        itself) crossed with ``default_k``'s and ``max_k``'s depth, or the
        given ``ks`` / ``batches``. Returns ``{"programs", "seconds"}``."""
        k_hi = min(self.max_k, self.index.count)
        kset = sorted({min(k, k_hi) for k in (ks or (self.default_k, k_hi))})
        if batches is None:
            batches = [1 << i for i in range(self.max_batch.bit_length())]
            batches.append(self.max_batch)
        buckets = sorted({min(next_pow2(max(1, int(b))), self.max_batch) for b in batches})
        t0 = time.monotonic()
        n = 0
        for b in buckets:
            for k in kset:
                self.submit([text] * b, k).result()
                n += 1
        return {"programs": n, "seconds": round(time.monotonic() - t0, 1)}

    def close(self) -> None:
        self._queue.put(None)
        self._thread.join(timeout=5)

    # ---------------------------------------------------------- consumer

    def _drain(self, first: _Pending) -> List[_Pending]:
        """Coalesce: after the first request, keep taking requests until
        ``max_batch`` texts are queued or ``max_wait_s`` has passed. Admin
        ops run alone, in arrival order."""
        batch = [first]
        if first.op != "search":
            return batch
        total = len(first.texts)
        deadline = time.monotonic() + self.max_wait_s
        while total < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                item = self._queue.get(timeout=timeout)
            except queue.Empty:
                break
            if item is None:
                self._queue.put(None)  # the main loop sees the shutdown
                break
            if item.op != "search" or total + len(item.texts) > self.max_batch:
                self._requeue = item  # an admin op or an overflow: the next batch
                break
            batch.append(item)
            total += len(item.texts)
        return batch

    def _consume(self) -> None:
        self._requeue: Optional[_Pending] = None
        while True:
            if self._requeue is not None:
                first, self._requeue = self._requeue, None
            else:
                item = self._queue.get()
                if item is None:
                    return
                first = item
            batch = self._drain(first)
            try:
                if batch[0].op != "search":
                    self._apply_admin(batch[0])
                    continue
                texts = [t for p in batch for t in p.texts]
                # the depth bucket: the next power of two, so that
                # approx="fast" certifies at the JAX service's depth;
                # each request's results are sliced to its own k
                k_req = max(p.k for p in batch)
                k_max = min(next_pow2(k_req), self.max_k, self.index.count)
                q = np.asarray(self.encoder.encode_queries(texts, batch_size=self.encode_batch))
                # the batch bucket: zero query rows up to the next power of
                # two, the JAX service's query blocks (the adaptive tier's
                # escalation branch depends on them)
                bucket = min(next_pow2(len(texts)), self.max_batch)
                if bucket > len(texts):
                    q = np.concatenate([q, np.zeros((bucket - len(texts), q.shape[1]), q.dtype)])
                if self.two_stage:
                    # pad rows get zero-length masks and score exact zeros
                    qt, ql = self.encoder.encode_queries_tokens(texts, batch_size=self.encode_batch)
                    qt, ql = np.asarray(qt), np.asarray(ql)
                    if bucket > len(texts):
                        pad = bucket - len(texts)
                        qt = np.concatenate([qt, np.zeros((pad,) + qt.shape[1:], qt.dtype)])
                        ql = np.concatenate([ql, np.zeros(pad, ql.dtype)])
                    scores, docids = self.index.search(q, qt, ql, k_max, **self.index_search_kwargs)
                    certified = None
                elif self.approx:
                    scores, docids = self.index.search(
                        q, k_max, approx=True if self.approx == "fast" else self.approx,
                        **self.index_search_kwargs,
                    )
                    certified = self.index.last_certified
                else:
                    scores, docids = self.index.search(q, k_max, **self.index_search_kwargs)
                    certified = None
                with self.stats._lock:
                    self.stats.batches += 1
                    self.stats.batched_queries += len(texts)
                off = 0
                for p in batch:
                    n = len(p.texts)
                    k = min(p.k, scores.shape[1])
                    res = [
                        [{"docid": str(docids[off + i][j]), "score": float(scores[off + i][j])} for j in range(k)]
                        for i in range(n)
                    ]
                    if certified is not None:
                        res = [{"hits": r, "certified": bool(certified[off + i])} for i, r in enumerate(res)]
                    off += n
                    p.future.set_result(res)
            except Exception as exc:  # noqa: BLE001 - a failed batch must not kill the consumer
                with self.stats._lock:
                    self.stats.errors += 1
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(exc)

    def _apply_admin(self, p: _Pending) -> None:
        if p.op == "add":
            texts = [d["text"] for d in p.payload]
            ids = [d["docid"] for d in p.payload]
            if self.two_stage:
                # one forward pass gives the dense row and the token block;
                # the blocks stay on the card, cut to the store's depth
                dense, toks, lens = self.encoder.encode_documents_with_tokens(
                    texts, batch_size=self.encode_batch, max_tokens=self.index.tokens.tokens_per_doc
                )
                self.index.add(np.asarray(dense), ids, toks, lens)
            else:
                # documents take the encoder's document dialect
                enc = getattr(self.encoder, "encode_documents", self.encoder.encode_queries)
                self.index.add(np.asarray(enc(texts, batch_size=self.encode_batch)), ids)
            p.future.set_result({"added": len(ids), "count": self.index.count})
        elif p.op == "remove":
            n = self.index.remove(list(p.payload))
            p.future.set_result({"removed": n, "count": self.index.count})
        elif p.op == "save":
            self.index.save(p.payload[0])
            p.future.set_result({"saved": p.payload[0], "count": self.index.count})
        elif p.op == "reload":
            new = type(self.index).load(p.payload[0])
            if new.dim != self.index.dim:
                raise ValueError(f"snapshot dim {new.dim} != serving dim {self.index.dim}")
            # the kernel settings and the mesh carry over; to_device
            # rebuilds doc_scales from the snapshot's own sidecar
            kw = {k: v for k, v in self.index.search_kwargs.items() if k != "doc_scales"}
            new.to_device(self.index.mesh, **kw)
            if self.approx in ("fast", "guaranteed"):
                new.enable_sketch()
            elif self.approx == "adaptive":
                new.load_adaptive_calibration()
            self.index = new  # the old device tensors are freed with it
            p.future.set_result({"reloaded": p.payload[0], "count": self.index.count})
        else:  # pragma: no cover - the submit paths set valid ops
            p.future.set_exception(ValueError(f"unknown op {p.op!r}"))


# -------------------------------------------------------------- transport

class _Handler(BaseHTTPRequestHandler):
    service: SearchService = None  # type: ignore[assignment]
    server_info: dict = {}
    # the first request of a bucket may pay the kernels' first-use build
    request_timeout_s: float = 600.0

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (stdlib API)
        if self.path != "/healthz":
            self._reply(404, {"error": f"unknown path {self.path!r}"})
            return
        info = dict(self.server_info)
        info.update(ok=True, stats=self.service.stats.snapshot())
        self._reply(200, info)

    def do_POST(self) -> None:  # noqa: N802
        if self.path not in ("/search", "/add", "/remove", "/save", "/reload"):
            self._reply(404, {"error": f"unknown path {self.path!r}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            if self.path == "/add":
                fut = self.service.submit_add(req.get("docs"))
            elif self.path == "/remove":
                fut = self.service.submit_remove(req.get("docids"))
            elif self.path == "/save":
                fut = self.service.submit_save(req.get("dir"))
            elif self.path == "/reload":
                fut = self.service.submit_reload(req.get("dir"))
            else:
                fut = self.service.submit(req.get("queries"), req.get("k"))
        except (ValueError, TypeError) as exc:
            self._reply(400, {"error": str(exc)})
            return
        try:
            results = fut.result(timeout=self.request_timeout_s)
        except FuturesTimeoutError:
            self._reply(503, {
                "error": f"timed out after {self.request_timeout_s:.0f}s waiting for the device batch "
                         "(first request per batch/k bucket pays compilation)"
            })
            return
        except Exception as exc:  # noqa: BLE001
            self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})
            return
        self._reply(200, {"results": results})


class _Server(ThreadingHTTPServer):
    # the standard library's listen backlog of 5 resets connections when
    # dozens of clients connect at once
    request_queue_size = 1024


def make_server(
    service: SearchService,
    *,
    host: str = "127.0.0.1",
    port: int = 0,
    info: Optional[dict] = None,
    request_timeout_s: float = 600.0,
) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; ``server_address[1]`` holds the
    bound port (port 0: an ephemeral one)."""
    handler = type(
        "BoundHandler",
        (_Handler,),
        {"service": service, "server_info": dict(info or {}), "request_timeout_s": request_timeout_s},
    )
    return _Server((host, port), handler)
