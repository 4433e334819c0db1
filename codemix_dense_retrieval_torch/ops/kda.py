"""Kimi Delta Attention's scan: the gated delta rule with a per-channel decay.

Per head, over one sequence, with unit keys ``k_t``, queries ``q_t`` (unit,
scaled), values ``v_t``, a log decay ``g_t <= 0`` per key channel and a step
size ``beta_t`` (the Kimi Linear report, arXiv:2510.26692):

    S_t = (I - beta_t k_t k_t^T) Diag(exp g_t) S_{t-1} + beta_t k_t v_t^T,
    o_t = S_t^T q_t,                                   S_0 = 0.

:func:`kda_chunk` takes right-padded rows (``lengths``) or packed rows
(``segment_ids``, 0 a pad; the state restarts at each segment) as
``(B, S, H, d)`` tensors and returns ``o`` in ``v``'s dtype, zeros at pads.
It runs the chunk form: chunks of ``CHUNK`` tokens, each a triangular solve
for the chunk's corrections ``u`` against the carried state, then the
outputs and the next state (the equations are in ``csrc/kda_chunk.cu``).
Because the decay is per channel, the pair terms ``sum_c k_ic k_jc
exp(G_ic - G_jc)`` are never a product of ``k exp(G)`` by ``k exp(-G)``
(which overflows f32 within a few tokens at strong decays): pairs in one
block of ``BLOCK`` tokens take the exponent of their difference, pairs of
two blocks factor through the cumulative decay just before the later block,
so every exponent is <= 0.

CUDA tensors launch the hand-written kernel (``csrc/kda_chunk.cu``,
``LAUNCHES["kda_chunk"]``; bf16 q, k, v of width 128, f32 g and beta,
contiguous), and raise on other operands; CPU tensors take
:func:`kda_chunk_plain`, the same chunked algorithm in f32 torch, which runs
on any device. The JAX package runs no linear attention.

The block's steps around the scan are here too, each one launch of
``csrc/kda_ops.cu`` on the card and, for CPU tensors, its plain version
(``*_plain``, f32 torch on any device):
:func:`short_conv` (the causal depthwise convolution, SiLU, and for q and k
the per-head L2 norm and scale; ``LAUNCHES["kda_conv"]``), :func:`decay_gate`
(g and beta; ``["kda_gate"]``) and :func:`gated_rms_norm` (the gated output
norm; ``["kda_out"]``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from codemix_dense_retrieval_torch.ops import kernels
from codemix_dense_retrieval_torch.utils import timing

CHUNK = 64
BLOCK = 16
#: the head width the kernel takes (keys and values)
KERNEL_WIDTH = 128


def _rows(lengths: Optional[torch.Tensor], segment_ids: Optional[torch.Tensor], b: int, s: int) -> None:
    """Exactly one of ``lengths`` (B,) and ``segment_ids`` (B, S)."""
    if (lengths is None) == (segment_ids is None):
        raise ValueError("kda_chunk takes exactly one of lengths and segment_ids")
    if segment_ids is not None and tuple(segment_ids.shape) != (b, s):
        raise ValueError(f"segment_ids {tuple(segment_ids.shape)} for rows {(b, s)}")
    if lengths is not None and tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths {tuple(lengths.shape)} for {b} rows")


def _segments(lengths: Optional[torch.Tensor], segment_ids: Optional[torch.Tensor], b: int, s: int,
              device) -> torch.Tensor:
    """(B, S) int32 segment ids, 0 at pads: ``segment_ids`` as given, or one
    segment of ``lengths[b]`` tokens a row."""
    _rows(lengths, segment_ids, b, s)
    if segment_ids is not None:
        return segment_ids.to(device=device, dtype=torch.int32)
    pos = torch.arange(s, device=device)
    return (pos[None, :] < lengths.to(device)[:, None]).to(torch.int32)


def _check(q, k, v, g, beta) -> None:
    b, s, h, d = q.shape
    if k.shape != q.shape or v.shape[:3] != (b, s, h) or g.shape != q.shape or beta.shape != (b, s, h):
        raise ValueError(f"kda_chunk shapes: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
                         f"g {tuple(g.shape)} beta {tuple(beta.shape)}")


def _pair_terms(qc: torch.Tensor, kc: torch.Tensor, gam: torch.Tensor):
    """(sum_c k_ic k_jc e^{G_ic - G_jc}, sum_c q_ic k_jc e^{G_ic - G_jc}) of
    a chunk, (B, H, C, C), for j <= i (garbage above the diagonal): in a
    block by the exponent of the difference, between blocks J < I through
    the cumulative decay r just before block I, every exponent <= 0."""
    bsz, h, c, d = kc.shape
    kk = kc.new_zeros((bsz, h, c, c))
    qk = kc.new_zeros((bsz, h, c, c))
    for i0 in range(0, c, BLOCK):
        rows = slice(i0, i0 + BLOCK)
        gb, kb = gam[:, :, rows], kc[:, :, rows]
        w = torch.exp(torch.clamp(gb[:, :, :, None] - gb[:, :, None, :], max=0.0)) * kb[:, :, None, :, :]
        kk[:, :, rows, rows] = (kb[:, :, :, None, :] * w).sum(dim=-1)
        qk[:, :, rows, rows] = (qc[:, :, rows, None, :] * w).sum(dim=-1)
        if i0:
            ref = gam[:, :, i0 - 1: i0]
            left = torch.exp(gb - ref)
            right = (kc[:, :, :i0] * torch.exp(ref - gam[:, :, :i0])).transpose(-1, -2)
            kk[:, :, rows, :i0] = (kb * left) @ right
            qk[:, :, rows, :i0] = (qc[:, :, rows] * left) @ right
    return kk, qk


def kda_chunk_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, beta: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None,
                    segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`kda_chunk` (see the module docstring): the
    chunk form in f32 torch on q's device, every row and head at once."""
    _check(q, k, v, g, beta)
    bsz, s, h, d = q.shape
    dv = v.shape[-1]
    dev = q.device
    seg = _segments(lengths, segment_ids, bsz, s, dev)
    pad = -s % CHUNK
    live = (seg > 0)[:, :, None]
    zero = torch.zeros((), device=dev)

    def heads(t: torch.Tensor) -> torch.Tensor:
        """(B, H, S + pad, .) f32, zeros at pads (no decay, no step)."""
        t = torch.where(live[..., None] if t.ndim == 4 else live, t.to(torch.float32), zero).transpose(1, 2)
        return torch.nn.functional.pad(t, (0, 0, 0, pad) if t.ndim == 4 else (0, pad))

    qf, kf, vf, gf, bf = heads(q), heads(k), heads(v), heads(g), heads(beta)
    segp = torch.nn.functional.pad(seg, (0, pad))
    state = torch.zeros(bsz, h, d, dv, dtype=torch.float32, device=dev)
    carry = torch.zeros(bsz, dtype=torch.int32, device=dev)
    out = torch.zeros(bsz, h, s + pad, dv, dtype=torch.float32, device=dev)
    idx = torch.arange(CHUNK, device=dev)
    lower = idx[:, None] > idx[None, :]
    lower_eq = idx[:, None] >= idx[None, :]
    eye = torch.eye(CHUNK, device=dev)
    for t0 in range(0, s + pad, CHUNK):
        sl = slice(t0, t0 + CHUNK)
        qc, kc, vc, bc = qf[:, :, sl], kf[:, :, sl], vf[:, :, sl], bf[:, :, sl]
        gam = gf[:, :, sl].cumsum(dim=2)                      # (B, H, C, d), non-increasing
        sc = segp[:, sl]                                       # (B, C)
        same = ((sc[:, :, None] == sc[:, None, :]) & (sc[:, :, None] > 0))[:, None]
        kk, qk = _pair_terms(qc, kc, gam)
        a = torch.where(lower & same, bc[..., None] * kk, zero)
        p = torch.where(lower_eq & same, qk, zero)
        cont = ((sc == carry[:, None]) & (carry[:, None] > 0))[:, None, :, None]   # takes the state
        decay = torch.exp(gam)
        rhs = bc[..., None] * vc - torch.where(cont, bc[..., None] * kc * decay, zero) @ state
        u = torch.linalg.solve_triangular(eye + a, rhs, upper=False, unitriangular=True)
        out[:, :, sl] = torch.where(cont, qc * decay, zero) @ state + p @ u
        last = sc[:, -1]
        keep = ((last == carry) & (carry > 0))[:, None, None, None]
        tail = ((sc == last[:, None]) & (last[:, None] > 0))[:, None, :, None]
        ktail = torch.where(tail, kc * torch.exp(gam[:, :, -1:] - gam), zero)
        state = torch.where(keep, decay[:, :, -1, :, None] * state, zero) + ktail.transpose(-1, -2) @ u
        carry = last
    return out[:, :, :s].transpose(1, 2).to(v.dtype).contiguous()


def _ops_fn(name: str, argtypes):
    fn = getattr(kernels.load("kda_ops"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _card_rows(*tensors: torch.Tensor) -> None:
    """Raise unless the elementwise kernels take these bf16 rows of heads
    of ``KERNEL_WIDTH`` (contiguous, on one card)."""
    for t in tensors:
        if t.device.type != "cuda" or t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 16 \
                or t.shape[-1] % KERNEL_WIDTH:
            raise ValueError(f"kda_ops on CUDA takes contiguous bf16 rows of heads of {KERNEL_WIDTH}; got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def short_conv(x: torch.Tensor, weight: torch.Tensor, heads: int, lengths: Optional[torch.Tensor] = None,
               segment_ids: Optional[torch.Tensor] = None, normalize: bool = False,
               scale: float = 1.0) -> torch.Tensor:
    """(B, S, heads, d): SiLU of the causal depthwise convolution of ``x``
    (B, S, heads * d) by ``weight`` (heads * d, 1, K), no bias, over the taps
    in the token's own segment (``segment_ids``, or with ``lengths`` one
    segment of ``lengths[b]`` tokens a row and the pads another); with
    ``normalize`` each head's d channels L2-normalized (norm clamped at
    1e-12) and times ``scale``. f32 inside, x's dtype out."""
    b, s, c = x.shape
    _rows(lengths, segment_ids, b, s)
    if x.device.type == "cuda":
        _card_rows(x)
        w = weight.to(x.dtype).contiguous()
        if tuple(w.shape) != (c, 1, 4) or c != heads * KERNEL_WIDTH:
            raise ValueError(f"kda_conv on CUDA takes (H * {KERNEL_WIDTH}, 1, 4) weights, got {tuple(w.shape)}")
        y = torch.empty((b, s, heads, c // heads), dtype=x.dtype, device=x.device)
        seg = None if segment_ids is None else segment_ids.to(torch.int32).contiguous()
        lens = None if lengths is None else lengths.to(device=x.device, dtype=torch.int32).contiguous()
        fn = _ops_fn("kda_conv_launch", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                     + [ctypes.c_float, ctypes.c_void_p])
        rc = kernels.launch(fn, x.device, x.data_ptr(), w.data_ptr(), None if seg is None else seg.data_ptr(),
                            None if lens is None else lens.data_ptr(), y.data_ptr(), b, s, heads,
                            int(normalize), float(scale))
        kernels.check(rc, "kda_conv")
        kernels.LAUNCHES["kda_conv"] += 1
        return y
    return short_conv_plain(x, weight, heads, lengths, segment_ids, normalize, scale)


def short_conv_plain(x: torch.Tensor, weight: torch.Tensor, heads: int, lengths: Optional[torch.Tensor] = None,
                     segment_ids: Optional[torch.Tensor] = None, normalize: bool = False,
                     scale: float = 1.0) -> torch.Tensor:
    """Plain version of :func:`short_conv`, in f32 torch on x's device."""
    b, s, c = x.shape
    seg = _segments(lengths, segment_ids, b, s, x.device)
    taps = weight.shape[-1]
    xf, w = x.to(torch.float32), weight[:, 0].to(torch.float32)
    y = xf * w[:, taps - 1]
    for back in range(1, min(taps, s)):
        same = (seg[:, back:] == seg[:, :-back])[..., None]
        y[:, back:] += torch.where(same, xf[:, :-back] * w[:, taps - 1 - back], 0.0)
    y = torch.nn.functional.silu(y).reshape(b, s, heads, c // heads)
    if normalize:
        y = torch.nn.functional.normalize(y, dim=-1) * scale
    return y.to(x.dtype)


def decay_gate(f: torch.Tensor, b_raw: torch.Tensor, a_log: torch.Tensor,
               dt_bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(g, beta) in f32: the per-channel log decay ``g = -exp(A_log[h])
    softplus(f + dt_bias)`` (B, S, H, d) from ``f`` (B, S, H * d), and the
    step size ``beta = sigmoid(b_raw)`` (B, S, H)."""
    b, s, c = f.shape
    h = a_log.shape[0]
    if f.device.type == "cuda":
        _card_rows(f)
        if c != h * KERNEL_WIDTH or tuple(b_raw.shape) != (b, s, h):
            raise ValueError(f"kda_gate on CUDA takes f (B, S, H * {KERNEL_WIDTH}) and b (B, S, H); got "
                             f"{tuple(f.shape)} {tuple(b_raw.shape)}")
        br, al, dt = (t.to(torch.bfloat16).contiguous() for t in (b_raw, a_log, dt_bias))
        g = torch.empty((b, s, h, c // h), dtype=torch.float32, device=f.device)
        beta = torch.empty((b, s, h), dtype=torch.float32, device=f.device)
        fn = _ops_fn("kda_gate_launch", [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        rc = kernels.launch(fn, f.device, f.data_ptr(), br.data_ptr(), al.data_ptr(), dt.data_ptr(), g.data_ptr(),
                            beta.data_ptr(), b * s, h)
        kernels.check(rc, "kda_gate")
        kernels.LAUNCHES["kda_gate"] += 1
        return g, beta
    return decay_gate_plain(f, b_raw, a_log, dt_bias)


def decay_gate_plain(f: torch.Tensor, b_raw: torch.Tensor, a_log: torch.Tensor,
                     dt_bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`decay_gate`, in f32 torch on f's device."""
    b, s, c = f.shape
    h = a_log.shape[0]
    f32 = torch.float32
    g = -torch.exp(a_log.to(f32))[:, None] * torch.nn.functional.softplus(
        f.to(f32).reshape(b, s, h, c // h) + dt_bias.to(f32).reshape(h, c // h))
    return g, torch.sigmoid(b_raw.to(f32))


def gated_rms_norm(o: torch.Tensor, gate: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """(B, S, H * d) in o's dtype: each head's ``RMSNorm(o) weight *
    sigmoid(gate)``, ``o`` (B, S, H, d) and ``gate`` (B, S, H * d), in f32."""
    b, s, h, d = o.shape
    if o.device.type == "cuda":
        _card_rows(o, gate)
        if d != KERNEL_WIDTH or gate.numel() != o.numel():
            raise ValueError(f"kda_out on CUDA takes heads of {KERNEL_WIDTH}; got {tuple(o.shape)} {tuple(gate.shape)}")
        w = weight.to(torch.bfloat16).contiguous()
        out = torch.empty((b, s, h * d), dtype=o.dtype, device=o.device)
        fn = _ops_fn("kda_out_launch", [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])
        rc = kernels.launch(fn, o.device, o.data_ptr(), gate.data_ptr(), w.data_ptr(), out.data_ptr(), b * s * h,
                            float(eps))
        kernels.check(rc, "kda_out")
        kernels.LAUNCHES["kda_out"] += 1
        return out
    return gated_rms_norm_plain(o, gate, weight, eps)


def gated_rms_norm_plain(o: torch.Tensor, gate: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain version of :func:`gated_rms_norm`, in f32 torch on o's device."""
    b, s, h, d = o.shape
    of = o.to(torch.float32)
    normed = of * torch.rsqrt((of * of).mean(dim=-1, keepdim=True) + eps) * weight.to(torch.float32)
    gated = normed * torch.sigmoid(gate.to(torch.float32).reshape(b, s, h, d))
    return gated.reshape(b, s, h * d).to(o.dtype)


def _card_refusal(q, k, v, g, beta) -> Optional[str]:
    """Why the kernel does not take these operands, or None where it does."""
    if q.device.type != "cuda":
        return f"kda_chunk runs on the CPU or a CUDA card, not {q.device}"
    if q.shape[-1] != KERNEL_WIDTH or v.shape[-1] != KERNEL_WIDTH:
        return f"kda_chunk on CUDA takes heads of width {KERNEL_WIDTH}, got q {q.shape[-1]} v {v.shape[-1]}"
    if not all(t.dtype == torch.bfloat16 for t in (q, k, v)) or g.dtype != torch.float32 \
            or beta.dtype != torch.float32:
        return (f"kda_chunk on CUDA takes bf16 q, k, v and f32 g, beta; got {q.dtype} {k.dtype} {v.dtype} "
                f"{g.dtype} {beta.dtype}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v, g, beta)):
        return "kda_chunk on CUDA takes contiguous, 16-byte aligned operands"
    if len({t.device for t in (q, k, v, g, beta)}) != 1:
        return "kda_chunk: operands on more than one device"
    return None


def _kda_lib():
    fn = kernels.load("kda_chunk").kda_chunk_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _extent(lengths: Optional[torch.Tensor], segment_ids: Optional[torch.Tensor], s: int, device) -> torch.Tensor:
    """(B,) int32 on ``device``: the tokens a row's scan covers, up to its
    last token in a segment."""
    if segment_ids is None:
        return lengths.to(device=device, dtype=torch.int32).clamp(0, s).contiguous()
    pos = torch.arange(1, s + 1, device=device, dtype=torch.int32)
    return torch.where(segment_ids.to(device) > 0, pos, 0).amax(dim=1).to(torch.int32)


def _kda_chunk_cuda(q, k, v, g, beta, extent, segment_ids) -> torch.Tensor:
    bsz, s, h, _ = q.shape
    dev = q.device
    seg = None if segment_ids is None else segment_ids.to(device=dev, dtype=torch.int32).contiguous()
    o = torch.zeros_like(v)
    rc = kernels.launch(_kda_lib(), dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                        beta.data_ptr(), extent.data_ptr(), None if seg is None else seg.data_ptr(),
                        o.data_ptr(), bsz, s, h)
    kernels.check(rc, "kda_chunk")
    kernels.LAUNCHES["kda_chunk"] += 1
    return o


def kda_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, beta: torch.Tensor,
              lengths: Optional[torch.Tensor] = None,
              segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``o`` (B, S, H, dv) of the scan (module docstring) over q, k (B, S, H,
    d), v (B, S, H, dv), g (B, S, H, d) <= 0 and beta (B, S, H), with exactly
    one of ``lengths`` (B,) and ``segment_ids`` (B, S). CPU tensors take
    :func:`kda_chunk_plain`; CUDA tensors launch ``csrc/kda_chunk.cu`` and
    raise on operands it does not take. While tracing, the counter
    ``kda.chunks`` adds the (row, chunk) pairs scanned (summed on the
    device)."""
    _check(q, k, v, g, beta)
    _rows(lengths, segment_ids, q.shape[0], q.shape[1])
    extent = _extent(lengths, segment_ids, q.shape[1], q.device)
    if timing.tracing():
        timing.count_device("kda.chunks", ((extent.to(torch.int64) + CHUNK - 1) // CHUNK).sum().reshape(1))
    if q.device.type == "cpu":
        return kda_chunk_plain(q, k, v, g, beta, lengths, segment_ids)
    refusal = _card_refusal(q, k, v, g, beta)
    if refusal is not None:
        raise ValueError(refusal)
    return _kda_chunk_cuda(q, k, v, g, beta, extent, segment_ids)
