"""``kda_chunk_roofline``: Kimi Delta Attention's chunked scan as a share of
its roofline in the corpus encode.

The least time of the window's KDA scans over the device time of the
launches of ``KERNEL``, ``kda_chunk``: the port's hand-written scan
(``csrc/kda_chunk.cu``, one launch a KDA layer and forward). Each KDA layer
of each forward is counted as one piece of work over its passages'
unpadded token counts T: its bytes are q, k, v and o in bf16 and g in f32
(``head_dim`` each) and beta in f32, once a token and head; its operations
are the chunk form's products at C = 64 (:func:`scan_ops`), per head and
per chunk of n <= C tokens:

- A and P, the pair terms within the chunk: 2 d n^2;
- the triangular solve of the chunk's corrections U: n^2 d;
- P U: d n (n + 1);
- the carried state's products, beta K^ S0 and Q^ S0, in every chunk but a
  passage's first: 2 * 2 n d^2;
- the next state, in every chunk but a passage's last: 2 n d^2.

Its least time is the larger of its bytes over 3.35 TB/s and its
operations over the TF32 tensor-core peak (494.7 TFLOP/s): the state and
the products with it are f32. The pool's passages are taken longest first
in forwards of ``pool / batches``, as the encoder sorts a store batch by
length and cuts it in forwards. The count is the same whatever implements
the scan. Moves ``encode_passages_per_s``."""

from harness.peaks import TF32_FLOPS, bound

LAYER = "kernels"
KERNEL = "kda_chunk"
CHUNK = 64


def scan_ops(tokens: int, d: int) -> float:
    """The chunk form's operations over one passage of ``tokens`` tokens,
    one head of width ``d``."""
    ops = 0.0
    for c0 in range(0, tokens, CHUNK):
        n = min(CHUNK, tokens - c0)
        ops += 2.0 * d * n * n + n * n * d + d * n * (n + 1)
        ops += 0.0 if c0 == 0 else 4.0 * n * d * d
        ops += 0.0 if c0 + CHUNK >= tokens else 2.0 * n * d * d
    return ops


def scan_least_seconds(config, tokens) -> float:
    """The least time of one KDA layer's scan over passages of ``tokens``."""
    lin = config["model"]["linear_attn_config"]
    h, d = lin["num_heads"], lin["head_dim"]
    nbytes = sum(tokens) * h * (4 * d * 2 + d * 4 + 4)
    return bound(nbytes, h * sum(scan_ops(t, d) for t in tokens), TF32_FLOPS)[0]


def pass_least_seconds(config, pool_tokens, forwards: int) -> float:
    """One pass over the pool: its forwards, each through every KDA layer."""
    n_kda = len(config["model"]["linear_attn_config"]["kda_layers"])
    longest = sorted(pool_tokens, reverse=True)
    per = -(-len(longest) // forwards)
    return n_kda * sum(scan_least_seconds(config, longest[i: i + per]) for i in range(0, len(longest), per))


def read(r):
    if r.trace is None or "linear_attn_config" not in r.config["model"]:
        return None
    c = r.counters
    calls = c.get("phase_stats") or []
    if not c.get("passes") or not calls or not calls[0].get("batches"):
        return None
    launches, secs = r.trace.kernel_time(KERNEL)
    if not launches or secs <= 0:
        return None
    return 100.0 * c["passes"] * pass_least_seconds(r.config, c["pool_tokens"], calls[0]["batches"]) / secs
