"""Experiment/result directory naming and parsing.

The reference encodes experiment identity in directory names that its
collectors parse back (`run_all_vector_pairs.sh:362-375`,
`collect_results.py:234-274`):

``<dataset>-<size>-<docside>-<qa>-<qb>-5bands-<enc>[/vector_mix]``

where ``docside`` is a doc-language name (mono) or ``bilingual-a-b``.
We keep this contract so reference-style collectors work unchanged.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Tuple

# Doc-language display names used by the reference corpus configs
# (mMARCO collection names, `encode_multilingual_corpus.py` --langs).
LANG_NAMES = {
    "en": "english",
    "zh": "chinese",
    "ar": "arabic",
    "de": "german",
    "es": "spanish",
    "fr": "french",
    "hi": "hindi",
    "id": "indonesian",
    "it": "italian",
    "ja": "japanese",
    "nl": "dutch",
    "pt": "portuguese",
    "ru": "russian",
    "vi": "vietnamese",
}
LANG_CODES = {v: k for k, v in LANG_NAMES.items()}


@dataclass(frozen=True)
class ExperimentName:
    dataset: str
    size: int
    doc_side: str  # language name ("chinese") or "bilingual-en-zh"
    qa: str
    qb: str
    encoder_tag: str
    bands: int = 5

    def dirname(self) -> str:
        # bilingual dirs carry the language pair ONCE (reference convention:
        # `mmarco-100000-bilingual-en-zh-5bands-bge-m3`,
        # `run_all_vector_pairs.sh:362-375`); mono dirs carry doc language
        # name + both query languages.
        if self.is_bilingual:
            return (
                f"{self.dataset}-{self.size}-{self.doc_side}-"
                f"{self.bands}bands-{self.encoder_tag}"
            )
        return (
            f"{self.dataset}-{self.size}-{self.doc_side}-{self.qa}-{self.qb}-"
            f"{self.bands}bands-{self.encoder_tag}"
        )

    @property
    def is_bilingual(self) -> bool:
        return self.doc_side.startswith("bilingual-")

    @property
    def doc_langs(self) -> Tuple[str, ...]:
        if self.is_bilingual:
            return tuple(self.doc_side.split("-")[1:])
        return (LANG_CODES.get(self.doc_side, self.doc_side),)


_NAME_RE = re.compile(
    r"^(?P<dataset>[a-zA-Z0-9_]+)-(?P<size>\d+)-(?P<docside>[a-z]+)"
    r"-(?P<qa>[a-z]{2})-(?P<qb>[a-z]{2})-(?P<bands>\d+)bands-(?P<enc>.+)$"
)


def parse_experiment_dirname(name: str) -> Optional[ExperimentName]:
    m = _NAME_RE.match(name)
    if not m:
        return None
    doc_side = m.group("docside")
    qa, qb = m.group("qa"), m.group("qb")
    if doc_side == "bilingual":
        doc_side = f"bilingual-{qa}-{qb}"
    return ExperimentName(
        dataset=m.group("dataset"),
        size=int(m.group("size")),
        doc_side=doc_side,
        qa=qa,
        qb=qb,
        encoder_tag=m.group("enc"),
        bands=int(m.group("bands")),
    )


def encoder_tag(encoder_name: str) -> str:
    """Short tag from an HF model name, e.g. ``BAAI/bge-m3`` -> ``bge-m3``."""
    return encoder_name.rstrip("/").split("/")[-1].lower()


_EVAL_STEM_RE = re.compile(r"^(?P<run>.+)_(?P<split>[a-zA-Z0-9]+)_(?P<ts>\d{8}-\d{6})$")


def parse_eval_stem(stem: str):
    """Parse ``<runstem>_<split>_<YYYYmmdd-HHMMSS>`` eval-artifact stems
    (reference `evaluate.py:350-360`). Returns (runstem, split, ts) or None."""
    m = _EVAL_STEM_RE.match(stem)
    if not m:
        return None
    return m.group("run"), m.group("split"), m.group("ts")
