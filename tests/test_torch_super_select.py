"""The super level of the two-level cover: ``ops.topk.super_select``'s
wrapper, its plain version, its route by device and operands, the
selection's results against the inline code it replaced, the unselected
bound of the probed and sketch callers, its span and counter, and the
kernel's build entry.

The kernel runs only on a CUDA card, where ``chip_smoke.py --super-select``
holds its values and ids against the plain version's bit for bit. Here the
card's route runs with the plain version standing in for the kernel, so
the routing, the shapes handed on and the tie-breaking are held to the
inline code exactly.
"""

import pathlib
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.ops import kernels
from codemix_dense_retrieval_torch.ops import sketch
from codemix_dense_retrieval_torch.ops import topk
from codemix_dense_retrieval_torch.utils import timing

CSRC = pathlib.Path(topk.__file__).resolve().parent.parent / "csrc"


def _inline(bin_max, k_bins, super_size, return_unselected_bound=False):
    """``_select_bins_two_level`` as it was written before the super level
    had a kernel: the reshape-max, a stable sort of the whole row, the id
    sort, then the bin level."""
    b, nb = bin_max.shape
    ns = nb // super_size
    bm3 = bin_max.reshape(b, ns, super_size)
    super_max = bm3.amax(dim=2)
    ks = min(k_bins, ns)
    sup_vals, sup_ids = topk._stable_topk(super_max, ks + 1)
    sup_ids, _ = torch.sort(sup_ids[:, :ks], dim=1)
    cand_bm = torch.gather(bm3, 1, sup_ids[:, :, None].expand(b, ks, super_size))
    cand_bins = topk._expand_ids(sup_ids, super_size)
    n_cand = cand_bins.shape[1]
    kb = min(k_bins, n_cand)
    vals2, pos = topk._stable_topk(cand_bm.reshape(b, -1), kb + 1)
    bin_ids, _ = torch.sort(torch.gather(cand_bins, 1, pos[:, :kb]), dim=1)
    if not return_unselected_bound:
        return bin_ids
    none = torch.full((b,), topk.NEG_INF, dtype=torch.float32)
    unsel_super = sup_vals[:, ks] if ns > ks else none
    unsel_cand = vals2[:, kb] if n_cand > kb else none
    return bin_ids, torch.maximum(unsel_super, unsel_cand)


def _bin_max(case, b, ns, m, seed=0):
    """(b, ns * m) f32 bin maxima with the planted case."""
    rng = np.random.default_rng(seed)
    bm = np.round(rng.standard_normal((b, ns * m)), 2).astype(np.float32)  # ties among the bins
    sup = bm.reshape(b, ns, m)
    if case == "ties across supers":
        for r in range(b):
            chosen = rng.choice(ns, size=min(ns, 30), replace=False)
            sup[r, chosen] = -5.0
            sup[r, chosen, rng.integers(m)] = 7.0
    elif case == "a row of equal maxima":
        bm[:] = 0.25
        bm[:, ::3] = 0.25
    elif case == "NEG_INF tails":
        nv = max(1, ns * m - 5 * m - 3)
        bm[:, nv:] = topk.NEG_INF
        bm[: b // 2, m * min(ns, 4):] = topk.NEG_INF   # fewer valid supers than k
    elif case == "zeros of both signs":
        bm[:] = -np.abs(bm) - 0.5
        for r in range(b):
            for j, s in enumerate(rng.choice(ns, size=min(ns, 12), replace=False)):
                sup[r, s, j % m] = -0.0 if j % 2 else 0.0
    return torch.from_numpy(bm)


CASES = ["random", "ties across supers", "a row of equal maxima", "NEG_INF tails", "zeros of both signs"]


@pytest.fixture
def card_route(monkeypatch):
    """The card's route on CPU tensors: ``super_select`` is the kernel, its
    plain version after the card's checks; every kernel call is counted."""
    calls = {"super_select": 0}

    def on_card(bm):
        return SimpleNamespace(device=torch.device("cuda"), dtype=bm.dtype, ndim=bm.ndim, shape=bm.shape,
                               is_contiguous=bm.is_contiguous, data_ptr=bm.data_ptr)

    def kernel(bm, k_bins, super_size):
        topk._check_super_select(bm, k_bins, super_size)
        assert topk._card_refusal(on_card(bm), super_size) is None
        calls["super_select"] += 1
        return topk.super_select_plain(bm, k_bins, super_size)

    monkeypatch.setattr(topk, "super_select", kernel)
    return calls


# ---------------------------------------------------------------- results


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("m", [4, 8, 16])
@pytest.mark.parametrize("b", [1, 7, 257])
def test_the_card_route_equals_the_inline_code(card_route, case, m, b):
    bm = _bin_max(case, b, 96, m, seed=b + m)
    for k in (1, 10, 95, 96, 300):
        got = topk._select_bins_two_level(bm, k, m)
        assert torch.equal(got, _inline(bm, k, m)), (case, k)
    assert card_route["super_select"] == 5


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", [1, 10, 100, 150, 400])
def test_super_select_returns_the_inline_super_level(case, k):
    """Values (as bits) and ids of the best min(ks + 1, ns) supers: ``ns <=
    k_bins`` returns every super, in order."""
    bm = _bin_max(case, 7, 150, 8, seed=k)
    vals, ids = topk.super_select(bm, k, 8)
    ks = min(k, 150)
    sv, si = topk._stable_topk(bm.reshape(7, 150, 8).amax(dim=2), ks + 1)
    assert vals.shape == (7, min(ks + 1, 150)) and ids.shape == (7, ks) and ids.dtype == torch.int64
    assert torch.equal(vals.view(torch.int32), sv.view(torch.int32))
    assert torch.equal(ids, torch.sort(si[:, :ks], dim=1)[0])


def test_ties_go_to_the_lower_super_ids(card_route):
    bm = torch.full((2, 64 * 8), -1.0)
    bm[:, 8 * 40 + 3] = bm[:, 8 * 5] = bm[:, 8 * 63 + 7] = bm[:, 8 * 20 + 1] = 2.0
    vals, ids = topk.super_select(bm, 2, 8)
    assert ids.tolist() == [[5, 20], [5, 20]] and vals[:, :3].tolist() == [[2.0] * 3] * 2


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k_bins", [3, 16, 40])
def test_the_unselected_bound_equals_the_inline_code(card_route, case, k_bins):
    bm = _bin_max(case, 6, 24, 8, seed=k_bins)
    ids, ub = topk._select_bins_two_level(bm, k_bins, 8, return_unselected_bound=True)
    want_ids, want_ub = _inline(bm, k_bins, 8, return_unselected_bound=True)
    assert torch.equal(ids, want_ids) and torch.equal(ub.view(torch.int32), want_ub.view(torch.int32))


def _rows(seed, n=4096, d=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32) * np.exp(-0.08 * np.arange(d)).astype(np.float32)
    return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True))


@pytest.mark.parametrize("probe_bins", [4, 24, 64])
def test_the_probed_cover_keeps_its_bound(monkeypatch, card_route, probe_bins):
    """The probed cover's (values, ids, certificate, unselected bound) with
    the card's super level equal those of the inline selection."""
    docs, q = _rows(0).to(torch.bfloat16), _rows(1, n=12).to(torch.bfloat16)
    got = topk.topk_ip_bins_two_level_probed(q, docs, 10, probe_bins=probe_bins, bin_size=8, super_size=8,
                                             n_valid=4000)
    assert card_route["super_select"] == 1
    monkeypatch.setattr(topk, "_select_bins_two_level", _inline)
    want = topk.topk_ip_bins_two_level_probed(q, docs, 10, probe_bins=probe_bins, bin_size=8, super_size=8,
                                              n_valid=4000)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("probe", [8, 24, 64])
def test_the_sketch_tier_keeps_its_certificates(monkeypatch, card_route, probe):
    docs, q = _rows(2), _rows(3, n=16)
    proj = torch.from_numpy(sketch.fit_sketch(docs.numpy(), 12))
    d_sketch, d_tail = sketch.sketch_rows(docs.to(torch.bfloat16), proj)
    args = (q, docs.to(torch.bfloat16), d_sketch, d_tail, proj, 10)
    got = sketch.topk_ip_sketch(*args, probe_bins=probe, tile_n=512)
    assert card_route["super_select"] == 1
    monkeypatch.setattr(sketch, "_select_bins_two_level", _inline)
    want = sketch.topk_ip_sketch(*args, probe_bins=probe, tile_n=512)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------- the route


def _shaped(device="cuda", dtype=torch.float32, b=256, nb=1_105_280, contiguous=True):
    return SimpleNamespace(device=torch.device(device), dtype=dtype, ndim=2, shape=(b, nb),
                           is_contiguous=lambda: contiguous, data_ptr=lambda: 0)


@pytest.mark.parametrize("bm,k_bins,m,want", [
    (_shaped(), 100, 8, True),
    (_shaped(), 1000, 4, True),
    (_shaped(), topk.SUPER_SELECT_MAX_K - 1, 16, True),
    (_shaped(), topk.SUPER_SELECT_MAX_K, 8, True),     # sorted in device memory past the cap
    (_shaped(nb=8 * 300), 10**6, 8, True),            # every super kept
    (_shaped(device="cpu"), 100, 8, False),
    (_shaped(device="meta"), 100, 8, False),
    (_shaped(dtype=torch.float16), 100, 8, False),
    (_shaped(dtype=torch.bfloat16), 100, 8, False),
    (_shaped(contiguous=False), 100, 8, False),
    (_shaped(nb=1_105_272), 100, 3, False),
    (_shaped(), 100, 32, False),
    (SimpleNamespace(device=torch.device("cuda"), dtype=torch.float32, ndim=2, shape=(2, 1024),
                     is_contiguous=lambda: True, data_ptr=lambda: 8), 10, 8, False),
])
def test_the_route_follows_device_dtype_contiguity_size_and_depth(monkeypatch, bm, k_bins, m, want):
    """``super_select`` launches the kernel on what it takes, whatever the
    depth; CPU tensors take the plain version; anything else raises, and
    never falls back to the plain version on the card."""
    calls = []
    monkeypatch.setattr(topk, "_super_select_cuda", lambda *a: calls.append("kernel"))
    monkeypatch.setattr(topk, "super_select_plain", lambda *a: calls.append("plain"))
    if want or bm.device.type == "cpu":
        topk.super_select(bm, k_bins, m)
    else:
        with pytest.raises(ValueError):
            topk.super_select(bm, k_bins, m)
    assert calls == (["kernel"] if want else ["plain"] if bm.device.type == "cpu" else [])


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_the_selection_takes_the_route_it_is_given(monkeypatch, device):
    """``_select_bins_two_level`` calls ``super_select`` alone, on either
    device: the plain version only through it, on the CPU."""
    calls = []
    plain = topk.super_select_plain
    if device == "cuda":
        monkeypatch.setattr(topk, "super_select", lambda *a: calls.append("kernel") or plain(*a))
    monkeypatch.setattr(topk, "super_select_plain", lambda *a: calls.append("plain") or plain(*a))
    bm = _bin_max("random", 3, 40, 8)
    assert torch.equal(topk._select_bins_two_level(bm, 5, 8), _inline(bm, 5, 8))
    assert calls == (["kernel"] if device == "cuda" else ["plain"])


@pytest.mark.parametrize("k_bins,ns,scratch", [
    (100, 5000, ("gmax", (2, 157))),
    (topk.SUPER_SELECT_MAX_K - 1, 5000, ("gmax", (2, 157))),
    (topk.SUPER_SELECT_MAX_K, 5000, ("wide", (2, 8192))),
    (10**6, 5000, ("wide", (2, 8192))),
    (10**6, 4096, ("gmax", (2, 128))),                    # ns = K = the cap
    (10**6, 4097, ("wide", (2, 8192))),
])
def test_the_wrapper_hands_the_kernel_its_scratch(monkeypatch, k_bins, ns, scratch):
    """At most ``SUPER_SELECT_MAX_K`` supers kept, the group maxima (B,
    ceil(ns / 32)) u32; past it, the device-memory sort buffer (B, the power
    of two at or above K) int64, the other pointer null; the shapes as the
    entry point checks them."""
    seen = {}
    real_empty = torch.empty

    def empty(shape, dtype=None, device=None):
        t = real_empty(shape, dtype=dtype, device=device)
        seen[t.data_ptr()] = (tuple(shape), dtype)
        return t

    def launch(fn, device, bm, gmax, vals, ids, wide, b, nb, m, ks, kout, width):
        seen["args"] = dict(gmax=gmax, wide=wide, b=b, nb=nb, m=m, ks=ks, kout=kout, width=width)
        return 0

    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(kernels, "launch", launch)
    monkeypatch.setattr(topk, "_super_select_lib", lambda: None)
    monkeypatch.setitem(kernels.LAUNCHES, "super_select", 0)
    vals, ids = topk._super_select_cuda(torch.zeros(2, 8 * ns), min(k_bins, ns), 8)
    a = seen["args"]
    ks = min(k_bins, ns)
    assert (a["b"], a["nb"], a["m"], a["ks"], a["kout"]) == (2, 8 * ns, 8, ks, min(ks + 1, ns))
    assert vals.shape == (2, a["kout"]) and ids.shape == (2, ks) and ids.dtype == torch.int64
    used, other = ("gmax", "wide") if scratch[0] == "gmax" else ("wide", "gmax")
    assert a[other] is None
    assert seen[a[used]] == (scratch[1], torch.int32 if used == "gmax" else torch.int64)
    assert a["width"] >= a["kout"] and a["width"] & (a["width"] - 1) == 0
    assert kernels.LAUNCHES["super_select"] == 1


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    monkeypatch.setattr(topk, "_super_select_lib", lambda: pytest.fail("the CPU launched the kernel"))
    bm = _bin_max("random", 3, 40, 8)
    before = kernels.LAUNCHES["super_select"]
    vals, ids = topk.super_select(bm, 5, 8)
    assert kernels.LAUNCHES["super_select"] == before
    assert torch.equal(ids, topk.super_select_plain(bm, 5, 8)[1])


# ---------------------------------------------------------------- the wrapper


@pytest.mark.parametrize("bm,k_bins,m", [
    (torch.zeros(4, 64, dtype=torch.float16), 5, 8),
    (torch.zeros(4, 64, dtype=torch.float64), 5, 8),
    (torch.zeros(64), 5, 8),
    (torch.zeros(4, 60), 5, 8),
    (torch.zeros(0, 64), 5, 8),
    (torch.zeros(4, 0), 5, 8),
    (torch.zeros(4, 64), 0, 8),
    (torch.zeros(4, 64), 5, 0),
    (torch.zeros(4, 64, device="meta"), 5, 8),
])
def test_super_select_rejects(bm, k_bins, m):
    with pytest.raises(ValueError):
        topk.super_select(bm, k_bins, m)


@pytest.mark.parametrize("bm,k_bins,m", [
    (_shaped(), 100, 3),
    (_shaped(), 100, 32),
    (_shaped(), 100, 2),
    (_shaped(contiguous=False), 100, 8),
    (SimpleNamespace(device=torch.device("cuda"), shape=(2, 1024), is_contiguous=lambda: True,
                     data_ptr=lambda: 8), 10, 8),
    (_shaped(device="meta"), 100, 8),
])
def test_the_kernel_refuses_what_it_does_not_take(bm, k_bins, m):
    assert topk._card_refusal(bm, m) is not None


def test_the_kernel_takes_the_main_shape():
    assert topk._card_refusal(_shaped(), 8) is None


@pytest.mark.parametrize("k_bins", [topk.SUPER_SELECT_MAX_K, 10**5, 10**9])
def test_the_kernel_takes_any_depth(monkeypatch, k_bins):
    """Past the shared-memory cap the card still launches the kernel, with
    ks = min(k_bins, ns)."""
    seen = []
    monkeypatch.setattr(topk, "_super_select_cuda", lambda bm, ks, m: seen.append(ks))
    topk.super_select(_shaped(), k_bins, 8)
    assert seen == [min(k_bins, 1_105_280 // 8)]


# ---------------------------------------------------------------- tracing


def test_the_select_span_nests_in_the_tail_and_counts_the_supers(card_route):
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((12, 32)).astype(np.float32)).to(torch.bfloat16)
    docs = torch.from_numpy(rng.standard_normal((8192, 32)).astype(np.float32)).to(torch.bfloat16)
    timing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        topk.topk_ip_bins_two_level(q, docs, 10, bin_size=8, super_size=8, tile_b=4)
    tot = timing.totals()
    recs = [r for r in timing.records() if r.name == "search.select"]
    timing.reset()
    assert len(recs) == 3 and {r.parent for r in recs} == {"search.tail"}
    assert tot["spans"]["search.select"]["count"] == 3
    assert tot["counters"]["search.selected_supers"] == 12 * 10
    assert card_route["super_select"] == 3


def test_no_span_or_count_without_tracing(card_route):
    timing.reset()
    topk._select_bins_two_level(_bin_max("random", 3, 40, 8), 5, 8)
    assert timing.totals()["spans"] == {} and timing.totals()["counters"] == {}


# ---------------------------------------------------------------- the source


def test_the_kernel_is_built_and_counted():
    assert kernels.SOURCES["super_select"] == "super_select.cu"
    src = (CSRC / "super_select.cu").read_text()
    assert "super_select" in kernels.LAUNCHES
    assert 'extern "C" int super_select_launch(' in src


def test_the_source_agrees_with_the_wrapper():
    """The kernel's shared-memory cap and the super sizes it instantiates
    are the wrapper's; its kernels' names carry no ``bin_scores`` (the
    roofline metric's match)."""
    src = (CSRC / "super_select.cu").read_text()
    assert int(re.search(r"constexpr int MAX_K = (\d+);", src).group(1)) == topk.SUPER_SELECT_MAX_K
    cases = tuple(int(m) for m in re.findall(r"case (\d+): return launch_select<\1>", src))
    assert cases == topk.SUPER_SELECT_SIZES
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(", src)
    assert names == ["super_max_kernel", "super_select_kernel", "super_select_wide_kernel"]
