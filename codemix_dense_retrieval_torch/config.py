"""Run constants shared by the runners and the CLI."""

from __future__ import annotations

from typing import Tuple

DEFAULT_ALPHAS: Tuple[float, ...] = (0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0)


def format_alpha(alpha: float) -> str:
    """Canonical alpha label used in run filenames: integers render bare
    ("0", "1"), fractions render trimmed ("0.5")."""
    if abs(alpha - round(alpha)) < 1e-8:
        return str(int(round(alpha)))
    text = f"{alpha:.4f}".rstrip("0").rstrip(".")
    return text if text else "0"
