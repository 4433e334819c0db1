"""Vector-mix ops: L2 normalization and lambda-interpolation of bilingual
query embeddings.

Semantics of the reference ``safe_mix``:

- alpha within eps of 0 / 1 returns the primary / secondary vector as-is
  (endpoints stay unnormalized; inner-product ranking is scale-invariant);
- interior alpha: lerp, then L2-renormalize;
- non-finite results fall back to the nearer endpoint vector
  (alpha > 0.5 -> secondary).

Mixing runs in float32 whatever the input dtype.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

_EPS = 1e-8


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) along ``dim``."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def mix_and_renorm(
    primary: torch.Tensor,
    secondary: torch.Tensor,
    alpha: Union[float, Sequence[float], torch.Tensor],
    *,
    normalize_endpoints: bool = False,
) -> torch.Tensor:
    """Batched safe_mix: (1-alpha)*primary + alpha*secondary, renormalized.

    ``primary``/``secondary`` are (B, d); ``alpha`` is a scalar or an (A,)
    vector, which produces an (A, B, d) sweep."""
    alpha_t = torch.as_tensor(alpha, dtype=torch.float32, device=primary.device)
    scalar = alpha_t.ndim == 0
    a = alpha_t.reshape(-1, 1, 1)  # (A, 1, 1)

    p = primary.to(torch.float32)[None]  # (1, B, d)
    s = secondary.to(torch.float32)[None]

    mixed = (1.0 - a) * p + a * s
    normed = l2_normalize(mixed, dim=-1)

    finite = torch.isfinite(normed).all(dim=-1, keepdim=True)
    fallback = torch.where(a.abs() > 0.5, s, p)
    out = torch.where(finite, normed, fallback)

    if normalize_endpoints:
        p_end, s_end = l2_normalize(p), l2_normalize(s)
    else:
        p_end, s_end = p, s
    out = torch.where(a.abs() <= _EPS, p_end, out)
    out = torch.where((a - 1.0).abs() <= _EPS, s_end, out)
    return out[0] if scalar else out
