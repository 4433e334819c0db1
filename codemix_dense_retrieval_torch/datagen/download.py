"""mMARCO query downloader (host-side; HF streaming).

Behavioral parity with reference `download_mmarco_queries.py:22-44`:
streams ``queries-<lang>`` configs, sorts by numeric qid, writes
``queries.<code>.tsv`` atomically (tmp file + rename); the 14-language
suffix map matches `:64-79`.
"""

from __future__ import annotations

import pathlib
from typing import Dict, List, Sequence, Tuple

from codemix_dense_retrieval_torch.io.tsv import write_queries_tsv
from codemix_dense_retrieval_torch.utils.logging import get_logger

log = get_logger("download")

SUFFIX_MAP: Dict[str, str] = {
    "english": "en",
    "chinese": "zh",
    "french": "fr",
    "german": "de",
    "indonesian": "id",
    "italian": "it",
    "portuguese": "pt",
    "russian": "ru",
    "spanish": "es",
    "arabic": "ar",
    "dutch": "nl",
    "hindi": "hi",
    "japanese": "ja",
    "vietnamese": "vi",
}


def _sort_key(qid: str):
    try:
        return (0, int(qid))
    except (TypeError, ValueError):
        return (1, str(qid))


def download_mmarco_queries(
    languages: Sequence[str],
    out_dir,
    *,
    repo: str = "unicamp-dl/mmarco",
    split: str = "dev",
    split_prefix: str = "queries-",
) -> Dict[str, pathlib.Path]:
    from datasets import load_dataset

    out_dir = pathlib.Path(out_dir)
    results: Dict[str, pathlib.Path] = {}
    for lang in languages:
        lang_cfg = lang.lower()
        suffix = SUFFIX_MAP.get(lang_cfg, lang_cfg[:2])
        cfg = f"{split_prefix}{lang_cfg}"
        ds = load_dataset(repo, cfg, split=split, streaming=True)
        rows: List[Tuple[str, str]] = [(str(r["id"]), r["text"]) for r in ds]
        rows.sort(key=lambda x: _sort_key(x[0]))
        path = out_dir / f"queries.{suffix}.tsv"
        write_queries_tsv(path, rows)
        log.info("wrote %d queries to %s", len(rows), path)
        results[lang_cfg] = path
    return results
