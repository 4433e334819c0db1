"""The Moonlight cell's encoder on the card, at the cell's widths and one
forward of its traffic (skips without a card; ``pytest benchmark/tests -m
chip`` on the card): the forward reads nothing back from the card, its
expert products are one grouped launch per projection per MoE layer, and
the kernels a MoE layer launches do not depend on how many experts it
holds."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from conftest import ROOT

CELL = "moonlight-16b-a3b.encode-corpus"


def _forward_batch(cell, device):
    """The middle forward of a store batch: 64 passages of the cell's
    lengths, right-padded to their bucket."""
    from harness import data

    from codemix_dense_retrieval_torch.models.tokenizer import DEFAULT_BUCKETS, bucket_length

    t = cell.traffic
    lengths = sorted(data.quantile_lengths(t["pool"], t["length"]["median"], t["length"]["mean"],
                                           t["length"]["lo"], t["length"]["hi"]), reverse=True)
    mid = len(lengths) // 2
    rows = torch.tensor(lengths[mid: mid + t["enc_batch"]])
    s = bucket_length(int(rows.max()), DEFAULT_BUCKETS)
    g = torch.Generator(device=device).manual_seed(5)
    ids = torch.randint(0, cell.config["tokenizer"]["words"][1], (len(rows), s), generator=g, device=device)
    mask = (torch.arange(s, device=device)[None] < rows.to(device)[:, None]).to(torch.int64)
    return ids, mask, int(rows.sum())


def _moe_kernels(cfg, experts, h, index):
    """The names of the kernels one MoE layer of ``experts`` experts
    launches, in order of name."""
    from codemix_dense_retrieval_torch.models.moe import MoeLayer
    from codemix_dense_retrieval_torch.models.xlmr import init_random_
    from codemix_dense_retrieval_torch.utils import timing

    with torch.device(h.device):
        layer = MoeLayer(dataclasses.replace(cfg, n_routed_experts=experts)).to(h.dtype)
    init_random_(layer, torch.Generator(device=h.device).manual_seed(1))
    layer(h, index)
    torch.cuda.synchronize()
    timing.reset()                  # the traced call sums its own expert histogram
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        layer(h, index)
        torch.cuda.synchronize()
    timing.reset()
    return sorted(e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


@pytest.mark.chip
def test_the_routed_forward_reads_nothing_back_and_groups_its_expert_products(card):
    from harness import core

    from codemix_dense_retrieval_torch.models.deepseek_v3 import DeepseekV3Config, DeepseekV3Encoder
    from codemix_dense_retrieval_torch.models.encoder import build_model
    from codemix_dense_retrieval_torch.ops import grouped_mm

    cell = core.load_cell(CELL, ROOT)
    cfg = DeepseekV3Config.from_hf_config(cell.config["model"], dtype=torch.bfloat16)
    with torch.device("meta"):
        module = DeepseekV3Encoder(cfg)
    model = build_model(cfg, card, model=module)
    ids, mask, real = _forward_batch(cell, card)
    n_moe = sum(cfg.is_moe(i) for i in range(cfg.num_layers))
    with torch.inference_mode():
        model(ids, mask, token_count=real)                  # first call: library set-up
        torch.cuda.synchronize()
        before = grouped_mm.LAUNCHES["grouped_mm"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = model(ids, mask, token_count=real)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert grouped_mm.LAUNCHES["grouped_mm"] - before == 2 * n_moe
        assert torch.isfinite(out).all() and torch.allclose(out.norm(dim=1), torch.ones(len(out), device=card))
        h = torch.randn(real, cfg.hidden_size, device=card, dtype=torch.bfloat16)
        index = torch.arange(real, device=card)
        k64, k16 = _moe_kernels(cfg, 64, h, index), _moe_kernels(cfg, 16, h, index)
    print("kernels of one MoE layer:", *k64, sep="\n  ")
    assert len(k64) == len(k16)
    grouped = [n for n in k64 if "GroupProblemShape" in n]
    assert len(grouped) == 2, k64
