"""Disk-pressure elasticity for run storage.

Reference behavior (`run_all_vector_pairs.sh:22-24,299-327,651-658,717-723`):
when free space at the run root drops below a threshold, run outputs go to
an ephemeral tmp directory instead, and are cleaned up after the job's
results are safely evaluated.
"""

from __future__ import annotations

import pathlib
import shutil
import tempfile
from contextlib import contextmanager
from typing import Iterator, Optional, Tuple

from codemix_dense_retrieval_torch.utils.logging import get_logger

log = get_logger("storage")

DEFAULT_MIN_FREE_GIB = 50.0


def free_gib(path) -> float:
    path = pathlib.Path(path)
    probe = path if path.exists() else path.parent
    usage = shutil.disk_usage(probe)
    return usage.free / (1 << 30)


def maybe_ephemeral_dir(
    target, min_free_gib: float = DEFAULT_MIN_FREE_GIB, tmp_root: Optional[str] = None
) -> Tuple[pathlib.Path, bool]:
    """Return (dir_to_use, is_ephemeral). When free space at ``target`` is
    below the threshold, a tmp directory is used instead."""
    target = pathlib.Path(target)
    try:
        free = free_gib(target)
    except OSError:
        free = float("inf")
    if free >= min_free_gib:
        target.mkdir(parents=True, exist_ok=True)
        return target, False
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="cdr_runs_", dir=tmp_root))
    log.warning(
        "low disk at %s (%.1f GiB free < %.1f): using ephemeral %s",
        target, free, min_free_gib, tmp,
    )
    return tmp, True


@contextmanager
def ephemeral_run_dir(
    target, min_free_gib: float = DEFAULT_MIN_FREE_GIB, tmp_root: Optional[str] = None
) -> Iterator[pathlib.Path]:
    """Context manager: yields the run dir; an ephemeral dir is removed on
    clean exit (after the caller has copied out what it needs), kept on
    error for debugging."""
    d, ephemeral = maybe_ephemeral_dir(target, min_free_gib, tmp_root)
    try:
        yield d
    except BaseException:
        if ephemeral:
            log.warning("job failed; keeping ephemeral dir %s for inspection", d)
        raise
    else:
        if ephemeral:
            shutil.rmtree(d, ignore_errors=True)
