"""``expert_gemm_roofline``: the routed experts' grouped products as a
share of their roofline in the corpus encode.

The least time of the window's grouped-GEMM launches over their device
time. The launches are the trace's kernels whose name holds ``KERNEL``,
``GroupProblemShape``: the problem shape of the CUTLASS grouped GEMM that
``torch._grouped_mm`` runs on sm90 (the port's ``ops/grouped_mm.py``:
gate-and-up and down, two launches a MoE layer; the small
``prepare_grouped_gemm_data`` kernel before each is not counted).
Each MoE layer of each forward is counted as one piece of work: its
operations 2 * routed rows * H * F * 3 (gate, up and down of
``moe_intermediate_size`` F over ``hidden_size`` H), its bytes every held
expert's three bf16 matrices read once (E * 3 * H * F * 2) plus the routed
rows in and out once (rows * 2 * H * 2), its least time the larger of its
bytes over 3.35 TB/s and its operations over 989 TFLOP/s. A forward's
routed rows are its passages' unpadded tokens times ``num_experts_per_tok``,
the pool's passages taken longest first in forwards of ``pool /
batches`` (the encoder sorts a store batch by length and cuts it in
forwards). The count is the same whatever implements the products.
Moves ``encode_passages_per_s``."""

from harness.peaks import bound

LAYER = "kernels"
KERNEL = "GroupProblemShape"


def layer_least_seconds(config, tokens: int) -> float:
    """The least time of one MoE layer's expert products over ``tokens``."""
    m = config["model"]
    h, f, e = m["hidden_size"], m["moe_intermediate_size"], m["n_routed_experts"]
    rows = tokens * m["num_experts_per_tok"]
    return bound(e * 3 * h * f * 2 + rows * 2 * h * 2, 2.0 * rows * h * f * 3)[0]


def pass_least_seconds(config, pool_tokens, forwards: int) -> float:
    """One pass over the pool: its forwards, each through every MoE layer."""
    m = config["model"]
    n_moe = sum(1 for i in range(m["num_hidden_layers"])
                if i >= m["first_k_dense_replace"] and i % m.get("moe_layer_freq", 1) == 0)
    longest = sorted(pool_tokens, reverse=True)
    per = -(-len(longest) // forwards)
    return n_moe * sum(layer_least_seconds(config, sum(longest[i: i + per])) for i in range(0, len(longest), per))


def read(r):
    if r.trace is None or "n_routed_experts" not in r.config["model"]:
        return None
    c = r.counters
    calls = c.get("phase_stats") or []
    if not c.get("passes") or not calls or not calls[0].get("batches"):
        return None
    launches, secs = r.trace.kernel_time(KERNEL)
    if not launches or secs <= 0:
        return None
    return 100.0 * c["passes"] * pass_least_seconds(r.config, c["pool_tokens"], calls[0]["batches"]) / secs
