"""Query / qrels TSV readers and writers.

On-disk contracts:

- query TSV: ``qid \\t text`` with an optional header line;
- qrels: 3-column TSV ``qid \\t docid \\t rel`` or 4-column TREC
  ``qid iter docid rel``.
"""

from __future__ import annotations

import os
import pathlib
import tempfile
from typing import Dict, Iterable, List, Tuple

PathLike = os.PathLike | str


class BadQueryLine(ValueError):
    pass


def read_queries_tsv(
    path: PathLike,
    qid_field: str = "qid",
    text_field: str = "text",
) -> List[Tuple[str, str]]:
    """Read ``qid\\ttext`` rows, skipping an optional header: a first line
    whose first two fields start with ``qid_field`` / ``text_field``
    (case-insensitive)."""
    rows: List[Tuple[str, str]] = []
    with open(path, "r", encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            if ln == 1 and len(parts) >= 2:
                head0, head1 = parts[0].lower(), parts[1].lower()
                if head0.startswith(qid_field.lower()) and head1.startswith(text_field.lower()):
                    continue
            if len(parts) < 2:
                raise BadQueryLine(f"bad queries TSV line #{ln} in {path}: {line!r}")
            rows.append((parts[0], parts[1]))
    return rows


def write_queries_tsv(path: PathLike, rows: Iterable[Tuple[str, str]], header: bool = False) -> None:
    """Atomic write (tmp file + rename)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name, suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            if header:
                f.write("qid\ttext\n")
            for qid, text in rows:
                f.write(f"{qid}\t{text}\n")
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def read_qrels(path: PathLike) -> Dict[str, Dict[str, int]]:
    """Read qrels as ``{qid: {docid: rel}}`` from either the 3-column TSV or
    the 4-column TREC layout, split on any whitespace, skipping an optional
    header."""
    qrels: Dict[str, Dict[str, int]] = {}
    with open(path, "r", encoding="utf-8") as f:
        for ln, raw in enumerate(f, 1):
            line = raw.strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) == 3:
                qid, docid, rel = parts
            elif len(parts) >= 4:
                qid, _, docid, rel = parts[:4]
            else:
                raise ValueError(f"bad qrels line #{ln} in {path}: {line!r}")
            if ln == 1:
                try:
                    int(rel)
                except ValueError:
                    continue  # header
            qrels.setdefault(str(qid), {})[str(docid)] = int(rel)
    return qrels


def write_qrels_tsv(path: PathLike, qrels: Dict[str, Dict[str, int]]) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for qid in qrels:
            for docid, rel in qrels[qid].items():
                f.write(f"{qid}\t{docid}\t{rel}\n")
