"""The two-level cover without a score store: ``ops.topk.cover_rescore``'s
wrapper, the route choice (``rescores_cover``), the route's results against
the stored route's, its spans and counters, the block memory it accounts
for, and the kernel sources' names.

The kernel runs only on a CUDA card, where ``chip_smoke.py --cover-rescore``
holds its scores against kernel A's store bit for bit. Here the route runs
with plain stand-ins for the card's pieces: kernel 5's plain version and a
rescore that reads the plain score matrix at the covered rows, so the
route's selection and tie-breaking are held to the stored route's exactly.
"""

import pathlib
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.ops import kernels
from codemix_dense_retrieval_torch.ops import topk
from codemix_dense_retrieval_torch.parallel import sharded_search as ss
from codemix_dense_retrieval_torch.utils import timing

CSRC = pathlib.Path(topk.__file__).resolve().parent.parent / "csrc"


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True))


def _operands(dtype=torch.bfloat16, b=6, n=4096, d=32, g=8, kb=5, seed=0):
    rng = np.random.default_rng(seed)
    q, docs = _unit(rng, b, d).to(dtype), _unit(rng, n, d).to(dtype)
    ids = torch.stack([torch.from_numpy(np.sort(rng.choice(n // g, kb, replace=False))) for _ in range(b)])
    return q, docs, ids


def _tied(dtype, seed, b=12, n=8192, d=32):
    """Queries and rows with ties at the cover's boundary: the first four
    queries each have 40 copies (5 bins) of one row near them, and the rows
    from n - 20 on are copies of a fifth query's near row."""
    rng = np.random.default_rng(seed)
    q, docs = _unit(rng, b, d), _unit(rng, n, d)
    near = q[:5] + 0.5 * _unit(rng, 5, d)
    near = near / near.norm(dim=1, keepdim=True)
    for i in range(4):
        r0 = 1000 * (i + 1) + 3 * i
        docs[r0 : r0 + 40] = near[i]
    docs[n - 20 :] = near[4]
    return q.to(dtype).contiguous(), docs.to(dtype).contiguous()


# ---------------------------------------------------------------- the wrapper


def _bad(case):
    q, docs, ids = _operands()
    if case == "int8 index":
        return q, docs.to(torch.int8), ids
    if case == "queries of another dtype":
        return q.float(), docs, ids
    if case == "int32 bin ids":
        return q, docs, ids.int()
    if case == "bin ids on another device":
        return q, docs, ids.to("meta")
    if case == "1-d queries":
        return q[0], docs, ids
    if case == "widths differ":
        return q[:, :16], docs, ids
    if case == "bin ids for other queries":
        return q, docs, ids[:-1]
    if case == "no bins":
        return q, docs, ids[:, :0]
    if case == "more bins than the index has":
        return q[:1], docs[:16], torch.arange(3)[None]
    if case == "rows not a multiple of G":
        return q, docs[:-3], ids
    if case == "unsorted bin ids":
        return q, docs, ids.flip(1)
    if case == "repeated bin id":
        return q, docs, torch.cat([ids[:, :1], ids[:, :-1]], dim=1)
    if case == "negative bin id":
        return q, docs, torch.cat([torch.full((len(ids), 1), -1), ids[:, 1:]], dim=1)
    if case == "bin id past the index":
        return q, docs, torch.cat([ids[:, :-1], torch.full((len(ids), 1), 4096 // 8)], dim=1)
    raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "int8 index", "queries of another dtype", "int32 bin ids", "bin ids on another device", "1-d queries",
    "widths differ", "bin ids for other queries", "no bins", "more bins than the index has",
    "rows not a multiple of G", "unsorted bin ids", "repeated bin id", "negative bin id",
    "bin id past the index",
])
def test_cover_rescore_rejects(case):
    q, docs, ids = _bad(case)
    with pytest.raises(ValueError):
        topk.cover_rescore(q, docs, ids, 8, 4000)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("bin_size", [8, 16])
def test_cover_rescore_on_the_cpu_scores_the_covered_rows(dtype, bin_size):
    """Column j * G + i holds row ids[j] * G + i's score (the plain score
    matrix's, up to the order of the f32 sum), NEG_INF from n_valid on."""
    q, docs, ids = _operands(dtype, g=bin_size, kb=7)
    n_valid = 4096 - 5
    got = topk.cover_rescore(q, docs, ids, bin_size, n_valid)
    s, _ = topk.bin_scores_plain(q, docs, n_valid, bin_size)
    want = topk._gather_bins(s, ids, bin_size)
    assert got.shape == (6, 7 * bin_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    rows = topk._expand_ids(ids, bin_size)
    assert torch.equal(got[rows >= n_valid], want[rows >= n_valid])
    assert bool((got[rows >= n_valid] == topk.NEG_INF).all())


# ---------------------------------------------------------------- the route


def _shard(device="cuda", dtype=torch.bfloat16, rows=8_842_240, dim=1024):
    return SimpleNamespace(device=torch.device(device), dtype=dtype, shape=(rows, dim))


@pytest.mark.parametrize("device,dtype,dim,want", [
    ("cuda", torch.bfloat16, 1024, True),
    ("cuda", torch.float16, 1024, True),
    ("cuda", torch.float32, 1024, False),
    ("cuda", torch.int8, 1024, False),
    ("cuda", torch.bfloat16, topk.RESCORE_MAX_DIM * 2, False),
    ("cpu", torch.bfloat16, 1024, False),
    ("meta", torch.bfloat16, 1024, False),
])
def test_the_route_follows_dtype_device_and_score_dtype(device, dtype, dim, want):
    """Routes store f32 scores where they store any, so the index's dtype,
    its device and its width decide."""
    assert topk.rescores_cover(_shard(device, dtype, dim=dim)) is want


@pytest.fixture
def card_route(monkeypatch):
    """The card's route on CPU tensors: ``rescores_cover`` ignores the
    device, kernel 5 is its plain version and the rescore reads the plain
    score matrix at the covered rows; every call is counted."""
    calls = {"bin_scores": 0, "binmax_only": 0, "cover_rescore": 0}
    card = topk.rescores_cover
    bin_scores, binmax_only = topk.bin_scores, topk.binmax_only

    def rescores_cover(docs):
        return card(SimpleNamespace(device=torch.device("cuda"), dtype=docs.dtype, shape=docs.shape))

    def counted_bin_scores(*args, **kw):
        calls["bin_scores"] += 1
        return bin_scores(*args, **kw)

    def counted_binmax_only(*args, **kw):
        calls["binmax_only"] += 1
        return binmax_only(*args, **kw)

    def reads_plain_scores(q, docs, ids, bin_size, n_valid):
        topk._check_cover_operands(q, docs, ids, bin_size)
        calls["cover_rescore"] += 1
        return topk._gather_bins(topk.bin_scores_plain(q, docs, n_valid, bin_size)[0], ids, bin_size)

    monkeypatch.setattr(topk, "rescores_cover", rescores_cover)
    monkeypatch.setattr(topk, "bin_scores", counted_bin_scores)
    monkeypatch.setattr(topk, "binmax_only", counted_binmax_only)
    monkeypatch.setattr(topk, "cover_rescore", reads_plain_scores)
    return calls


def _stored(q, docs, k, n_valid, tile_b=4):
    """The stored route, composed by hand: kernel A's plain version, then
    the tail over its score matrix."""
    def run(qq):
        s, bm = topk.bin_scores_plain(qq, docs, n_valid, 8)
        return topk._topk_from_bins_two_level_bm(s, bm, k, 8, 8)
    return topk._by_query_chunks(q, tile_b, run)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("k", [1, 10, 50])
@pytest.mark.parametrize("seed", [0, 1])
def test_the_rescored_route_equals_the_stored_route(card_route, dtype, k, seed):
    q, docs = _tied(dtype, seed)
    n_valid = docs.shape[0] - 7
    got = topk.topk_ip_bins_two_level(q, docs, k, bin_size=8, super_size=8, tile_b=4, n_valid=n_valid)
    want = _stored(q, docs, k, n_valid)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert card_route == {"bin_scores": 0, "binmax_only": 3, "cover_rescore": 3}
    assert bool((got[1] < n_valid).all())


def test_ties_at_the_cover_boundary_go_to_the_lower_ids(card_route):
    """Query 0's 40 copies score alike: its top 10 are the first 10."""
    q, docs = _tied(torch.bfloat16, 0)
    _, ids = topk.topk_ip_bins_two_level(q, docs, 10, bin_size=8, super_size=8, tile_b=4)
    assert ids[0].tolist() == list(range(1000, 1010))


@pytest.mark.parametrize("dtype", [torch.float32])
def test_f32_indexes_and_a_bf16_score_store_keep_the_stored_route(card_route, dtype):
    """An f32 index keeps kernel A's store; routes store f32 scores where
    they store any."""
    q, docs = _tied(dtype, 0)
    topk.topk_ip_bins_two_level(q, docs, 10, bin_size=8, super_size=8, tile_b=4)
    assert card_route == {"bin_scores": 3, "binmax_only": 0, "cover_rescore": 0}


def test_the_int8_route_keeps_kernel_4(card_route):
    from codemix_dense_retrieval_torch.ops.quant import quantize_rows

    q, docs = _tied(torch.float32, 0)
    vals, scales = quantize_rows(docs)
    want = topk.topk_ip_bins_int8(q, vals, scales, 10, two_level=True, bin_size=8, super_size=8, tile_b=4)
    got = ss.sharded_topk_ip(q, vals, torch.tensor([docs.shape[0]], dtype=torch.int32), 10,
                             method="bins_two_level", bin_size=8, tile_b=4, doc_scales=scales)
    assert torch.equal(got[1], want[1])
    assert card_route == {"bin_scores": 0, "binmax_only": 0, "cover_rescore": 0}


def test_cpu_tensors_keep_the_stored_route(monkeypatch):
    calls = []
    monkeypatch.setattr(topk, "cover_rescore", lambda *a: calls.append(a))
    q, docs = _tied(torch.bfloat16, 0)
    got = topk.topk_ip_bins_two_level(q, docs, 10, bin_size=8, super_size=8, tile_b=4)
    assert calls == []
    want = _stored(q, docs, 10, docs.shape[0])
    assert torch.equal(got[1], want[1])


def test_sharded_search_takes_the_route_and_merges_the_same(card_route):
    """Two shards through ``sharded_topk_ip`` with the card's route give the
    stored route's merged results."""
    q, docs = _tied(torch.bfloat16, 3, n=4096)
    counts = [torch.tensor([2048], dtype=torch.int32), torch.tensor([2048 - 9], dtype=torch.int32)]
    shards = [docs[:2048].contiguous(), docs[2048:].contiguous()]
    got = ss.sharded_topk_ip(q, shards, counts, 10, method="bins_two_level", bin_size=8, tile_b=4)
    assert card_route["cover_rescore"] == 6 and card_route["bin_scores"] == 0
    parts = [_stored(q, s, 10, int(c)) for s, c in zip(shards, counts)]
    want = ss.merge_shards([p[0] for p in parts], [parts[0][1], parts[1][1] + 2048], 10)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_the_rescore_span_nests_in_the_tail_and_counts_its_rows(card_route):
    q, docs = _tied(torch.bfloat16, 0)
    timing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        topk.topk_ip_bins_two_level(q, docs, 10, bin_size=8, super_size=8, tile_b=4)
    tot = timing.totals()
    recs = [r for r in timing.records() if r.name == "search.rescore"]
    timing.reset()
    assert len(recs) == 3 and {r.parent for r in recs} == {"search.tail"}
    assert tot["spans"]["search.rescore"]["count"] == 3
    assert tot["counters"]["search.rescored_rows"] == 12 * 10 * 8


# ---------------------------------------------------------------- block memory


@pytest.mark.parametrize("shard,per_row", [
    (_shard(), topk.BLOCK_BYTES_PER_ROW_BINMAX),
    (_shard(dtype=torch.float16), topk.BLOCK_BYTES_PER_ROW_BINMAX),
    (_shard(dtype=torch.float32), topk.BLOCK_BYTES_PER_ROW),
    (_shard(dtype=torch.int8), topk.BLOCK_BYTES_PER_ROW),
    (_shard(rows=131_072), topk.BLOCK_BYTES_PER_ROW),
    (_shard(device="cpu"), topk.BLOCK_BYTES_PER_ROW),
    (torch.device("cuda", 0), topk.BLOCK_BYTES_PER_ROW),
    ("cuda", topk.BLOCK_BYTES_PER_ROW),
])
def test_block_bytes_follow_the_route(shard, per_row):
    assert topk.block_bytes_per_row(shard) == per_row
    assert topk.BLOCK_BYTES_PER_ROW == 4 + 4 / 8 and topk.BLOCK_BYTES_PER_ROW_BINMAX == 4 / 8


def test_fit_query_block_counts_each_shards_route(monkeypatch):
    """The bilingual hub (17.7M rows) with 44 GB free: a score store cuts the
    1024-query block to 256, bin maxima alone keep it whole; two shards on
    one card add their bytes."""
    gb = 10**9
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (43 * gb, 80 * gb))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 2 * gb)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 1 * gb)
    hub_rows = 17_684_480
    assert ss.fit_query_block(1024, 4096, hub_rows, "cuda") == 256
    assert ss.fit_query_block(1024, 4096, hub_rows, [_shard(rows=hub_rows, dtype=torch.float32)]) == 256
    assert ss.fit_query_block(1024, 4096, hub_rows, [_shard(rows=hub_rows)]) == 1024
    assert ss.fit_query_block(4096, 4096, hub_rows, _shard(rows=hub_rows)) == 2048
    # 44 GB x 0.75 / (17.7M rows x (0.5 + 4.5) bytes) = 373 queries -> 256
    mixed = [_shard(rows=hub_rows), _shard(rows=hub_rows, dtype=torch.float32)]
    assert ss.fit_query_block(1024, 4096, hub_rows, mixed) == 256


# ---------------------------------------------------------------- sources


def _global_kernels():
    """The names of every ``__global__`` function in ``csrc/``, by file."""
    found = {}
    for path in sorted(CSRC.glob("*.cu*")):
        text = path.read_text()
        for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(", text):
            found.setdefault(path.name, []).append(m.group(1))
    return found


def test_only_the_bin_score_templates_carry_bin_scores_in_their_names():
    """``bin_scores_roofline`` sums the device time of every kernel whose
    name holds ``bin_scores``: kernels A, 2, 4, 5 and 7, the templates of
    ``bin_kernels.cuh``. No other kernel may match, ``cover_rescore``'s
    above all."""
    found = _global_kernels()
    assert "cover_rescore_kernel" in found["cover_rescore.cu"]
    templates = {"bin_scores_t_kernel", "bin_scores_bm_kernel", "bin_scores_f32_kernel"}
    assert set(found["bin_kernels.cuh"]) == templates
    others = [name for f, names in found.items() if f != "bin_kernels.cuh" for name in names]
    assert others and not [name for name in others if "bin_scores" in name]


def test_the_kernel_is_built_and_counted():
    """One source, built like the others; one launch count per dtype it
    takes (bf16 unsuffixed, f16), none for f32."""
    assert (CSRC / kernels.SOURCES["cover_rescore"]).name == "cover_rescore.cu"
    assert (CSRC / "cover_rescore.cu").exists()
    names = {n for n in kernels.LAUNCHES if n.startswith("cover_rescore")}
    assert names == {"cover_rescore" + kernels.dtype_suffix(d) for d in topk.RESCORE_DTYPES}
