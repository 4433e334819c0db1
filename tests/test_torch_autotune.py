"""utils/autotune.py: the tuned store and the dispatch that reads it, against
the JAX package's (tests/test_autotune.py): the same store file gives the
same answers in both packages, the top-k pickers, the sharded tile_b
resolution and the flash dispatch consult it, two-level search with tuned
G / M / tile_b stays exact, and the sweeps run on the CPU at a tiny size."""

import json

import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.ops import flash_attention as fa
from codemix_dense_retrieval_torch.ops import topk
from codemix_dense_retrieval_torch.parallel import sharded_search
from codemix_dense_retrieval_torch.utils import autotune
from codemix_dense_retrieval_tpu.utils import autotune as ref_autotune


@pytest.fixture(autouse=True)
def _isolated_store(tmp_path, monkeypatch):
    path = tmp_path / "tuned.json"
    monkeypatch.setenv("CDR_TUNE_FILE", str(path))
    autotune.invalidate_cache()
    ref_autotune.invalidate_cache()
    yield path
    autotune.invalidate_cache()
    ref_autotune.invalidate_cache()


class TestStore:
    def test_missing_file_gives_the_jax_defaults(self):
        # topk.tile_b has no built-in entry in the port: without a store the
        # exact routes launch topk.TILE_B queries (topk._tile_b), the sketch
        # tier its own 512
        assert "topk.tile_b" not in autotune.DEFAULTS and autotune.get_tuned("topk.tile_b") is None
        for key in ("topk.super_size", "topk.bin_size", "flash.min_seq"):
            assert autotune.get_tuned(key) == ref_autotune.get_tuned(key) == autotune.DEFAULTS[key]
        # the Pallas K/V window has no counterpart in kernel B
        assert autotune.get_tuned("flash.window") is None and "flash.window" not in autotune.DEFAULTS

    def test_save_merge_and_depth_override_read_alike(self, _isolated_store):
        autotune.save_tuned({"topk.super_size": 4})
        assert autotune.get_tuned("topk.super_size", k=1000) == 4
        autotune.save_tuned({"topk.super_size.k1000": 16})
        assert json.loads(_isolated_store.read_text()) == {"topk.super_size": 4, "topk.super_size.k1000": 16}
        ref_autotune.invalidate_cache()
        for mod in (autotune, ref_autotune):
            assert mod.get_tuned("topk.super_size", k=1000) == 16
            assert mod.get_tuned("topk.super_size", k=100) == 4
        # a store the JAX package wrote reads the same in the port
        ref_autotune.save_tuned({"flash.min_seq": 255})
        autotune.invalidate_cache()
        assert autotune.get_tuned("flash.min_seq") == 255

    def test_corrupt_file_ignored(self, _isolated_store):
        _isolated_store.write_text("{nope")
        autotune.invalidate_cache()
        assert autotune.get_tuned("topk.super_size") == 8
        _isolated_store.write_text("[1, 2]")
        autotune.invalidate_cache()
        assert autotune.load_tuned() == {}

    def test_explicit_default_wins_over_builtin(self):
        assert autotune.get_tuned("topk.super_size", default=16) == 16

    def test_default_path_is_per_card_kind_and_not_the_jax_one(self, monkeypatch, tmp_path):
        monkeypatch.delenv("CDR_TUNE_FILE")
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
        path = autotune.tune_file_path()
        assert path.parent == tmp_path / "codemix_dense_retrieval_torch"
        assert path.name == f"tuned-{autotune._device_kind_slug()}.json"
        assert autotune._device_kind_slug().startswith(("cuda-", "cpu-"))
        assert path != ref_autotune.tune_file_path()


class TestIntegration:
    def test_pickers_consult_store(self):
        assert topk._auto_super_size(1000) == 8 and topk._auto_bin_size_two_level(1000) == 8
        assert topk._tile_b(None, 1000, two_level=True) == topk.TILE_B == 256
        autotune.save_tuned({"topk.super_size.k1000": 4, "topk.bin_size.k1000": 16, "topk.tile_b.k1000": 128})
        assert topk._auto_super_size(1000) == 4 and topk._auto_super_size(500) == 8
        assert topk._auto_bin_size_two_level(1000) == 16 and topk._auto_bin_size_two_level(500) == 8
        assert topk._tile_b(None, 1000, two_level=True) == 128 and topk._tile_b(None, 500, two_level=True) == 256

    def test_two_level_exact_with_tuned_params(self, monkeypatch):
        rng = np.random.default_rng(7)
        from codemix_dense_retrieval_tpu.ops.topk import topk_ip_oracle

        autotune.save_tuned({"topk.super_size": 4, "topk.tile_b": 8, "topk.bin_size.k300": 16})
        seen = []
        real = topk._by_query_chunks
        monkeypatch.setattr(topk, "_by_query_chunks",
                            lambda q, tb, run: seen.append(tb) or real(q, tb, run))
        q = rng.standard_normal((20, 32)).astype(np.float32)
        d = rng.standard_normal((4096, 32)).astype(np.float32)
        vals, ids = topk.topk_ip_bins_two_level(torch.from_numpy(q), torch.from_numpy(d), 300)
        ref_v, ref_i = topk_ip_oracle(q, d, 300)
        np.testing.assert_array_equal(ids.numpy(), ref_i)
        np.testing.assert_allclose(vals.numpy(), ref_v, rtol=1e-4, atol=1e-4)
        assert seen == [8]
        # the rescore search takes the tuned tile_b too
        topk.topk_ip_rescore_two_level(torch.from_numpy(q), torch.from_numpy(d), 300)
        assert seen[-1] == 8

    def test_tuned_tile_b_is_not_clamped_on_small_shards(self):
        """The JAX package clamps tuned tile_b > 512 below 1.1M rows (the TPU
        compiler's scoped VMEM); the card has no such limit."""
        autotune.save_tuned({"topk.tile_b.k300": 1024})
        assert topk._tile_b(None, 300, two_level=True) == 1024

    def test_resolve_tile_b_uses_store_entries_only(self):
        """The one rule: the argument, else the store's entry on the
        two-level cover (where it was measured), else ``TILE_B``; the
        single-level routes never read the store."""
        assert topk._tile_b(None, 100, two_level=True) == 256  # empty store
        autotune.save_tuned({"topk.tile_b.k100": 384})
        assert topk._tile_b(None, 100, two_level=True) == 384
        assert topk._tile_b(None, 100, two_level=False) == 256
        assert topk._tile_b(None, 77, two_level=True) == 256
        assert topk._tile_b(768, 100, two_level=True) == 768
        autotune.save_tuned({"topk.tile_b": 64})
        assert topk._tile_b(None, 77, two_level=True) == 64

    def test_sharded_two_level_route_reads_tuned_tile_b(self, monkeypatch):
        seen = []
        real = topk._by_query_chunks
        monkeypatch.setattr(topk, "_by_query_chunks",
                            lambda q, tb, run: seen.append(tb) or real(q, tb, run))
        rng = np.random.default_rng(3)
        d = torch.from_numpy(rng.standard_normal((2048, 16)).astype(np.float32))
        q = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
        counts = torch.tensor([2048])
        sharded_search.sharded_topk_ip(q, d, counts, 10, method="bins_two_level")
        assert seen == [256]
        autotune.save_tuned({"topk.tile_b.k10": 2})
        sharded_search.sharded_topk_ip(q, d, counts, 10, method="bins_two_level")
        # the single-level cover keeps TILE_B whatever the store holds
        sharded_search.sharded_topk_ip(q, d, counts, 10, method="bins_pallas")
        assert seen == [256, 2, 256]

    def test_flash_dispatch_consults_store(self, monkeypatch):
        rng = np.random.default_rng(11)
        calls = {}
        real = fa.attention_flash

        def spy(*a, **kw):
            calls["flash"] = True
            return real(*a, **kw)

        monkeypatch.setattr(fa, "attention_flash", spy)
        q = torch.from_numpy(rng.standard_normal((1, 64, 32)).astype(np.float32))
        mask = torch.ones((1, 64), dtype=torch.int32)
        fa.multi_head_attention(q, q, q, mask, num_heads=2)
        assert "flash" not in calls  # built-in min_seq 512: plain attention at S = 64
        autotune.save_tuned({"flash.min_seq": 32})
        fa.multi_head_attention(q, q, q, mask, num_heads=2)
        assert calls.get("flash")


class TestSweeps:
    def test_autotune_topk_tiny(self):
        out = autotune.autotune_topk(rows=2048, dim=32, batch=8, ks=(32,), super_sizes=(4,), tile_bs=(8, 16),
                                     bin_sizes=(8,), iters=1, device="cpu")
        assert out["topk.super_size.k32"] == 4 and out["topk.bin_size.k32"] == 8
        assert out["topk.tile_b.k32"] == 8  # tiles above the batch are left out
        assert out["topk.qps.k32"] > 0

    def test_autotune_flash_tiny(self):
        out = autotune.autotune_flash(heads=2, kv_heads=1, head_dim=16, batch=2, seqs=(8, 16), causal=True,
                                      iters=1, device="cpu")
        assert out["flash.min_seq"] in (7, 15, 16)
        assert set(out["flash.ms"]) == {"8", "16"} and all(len(v) == 2 for v in out["flash.ms"].values())

    def test_run_autotune_writes_store(self, _isolated_store):
        update = autotune.run_autotune(topk=True, flash=False, rows=2048, dim=32, batch=8, ks=(32,),
                                       super_sizes=(4,), bin_sizes=(8,), iters=1, device="cpu")
        data = json.loads(_isolated_store.read_text())
        for key, val in update.items():
            assert data[key] == val
        assert data["_device"] == autotune._device_kind_slug()
        assert topk._auto_super_size(32) == 4

    def test_sweeps_need_a_card_unless_asked_for_the_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            autotune.autotune_topk(rows=2048, dim=32, batch=8, ks=(32,))
