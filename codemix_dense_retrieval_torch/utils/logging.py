"""Logging setup: timestamped INFO, DEBUG by verbosity."""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def setup_logging(verbosity: int = 1) -> None:
    level = logging.WARNING if verbosity <= 0 else logging.INFO if verbosity == 1 else logging.DEBUG
    logging.basicConfig(level=level, format=_FORMAT, stream=sys.stderr, force=True)


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"cdr.{name}")
