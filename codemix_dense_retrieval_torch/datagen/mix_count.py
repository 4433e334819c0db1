"""Per-language word counting for code-mixed sentences.

Replaces `mix_count.py` (#9): the reference tokenizes with Stanza and
classifies residual tokens with langid. Neither is a dependency of this
package, so the default pipeline is:

1. regex word segmentation with script-run splitting (Han runs split
   from Latin runs — the reference's script regex at `mix_count.py:16,39-44`),
2. URL / digit / punctuation filtering,
3. per-token classification by Unicode script (deterministic for
   script-distinct pairs like EN-ZH/EN-AR/EN-RU/EN-JA/EN-HI); for
   script-sharing pairs (EN-FR/ES/PT/IT/DE/NL/ID/VI) the bundled pairwise
   lexicon+diacritic+affix model (:mod:`.lexid`) discriminates per token —
   the analog of the reference's pair-constrained langid
   (`mix_count.py:30-37,111`) — with a pluggable ``classifier(token) ->
   lang`` hook overriding it.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional, Tuple

_URL_RE = re.compile(r"https?://\S+|www\.\S+")
_NUM_RE = re.compile(r"^[\d.,%:+-]+$")
# word-ish tokens: runs of word chars (unicode) or single CJK chars
_TOKEN_RE = re.compile(r"\w+", re.UNICODE)

_SCRIPT_RANGES: Dict[str, Tuple[Tuple[int, int], ...]] = {
    "han": ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0xF900, 0xFAFF)),
    "hiragana": ((0x3040, 0x309F),),
    "katakana": ((0x30A0, 0x30FF),),
    "hangul": ((0xAC00, 0xD7AF), (0x1100, 0x11FF)),
    "arabic": ((0x0600, 0x06FF), (0x0750, 0x077F)),
    "cyrillic": ((0x0400, 0x04FF),),
    "devanagari": ((0x0900, 0x097F),),
    "latin": ((0x0041, 0x005A), (0x0061, 0x007A), (0x00C0, 0x024F)),
}

_LANG_SCRIPTS: Dict[str, Tuple[str, ...]] = {
    "zh": ("han",),
    "ja": ("han", "hiragana", "katakana"),
    "ko": ("hangul",),
    "ar": ("arabic",),
    "ru": ("cyrillic",),
    "hi": ("devanagari",),
    "en": ("latin",),
    "de": ("latin",),
    "es": ("latin",),
    "fr": ("latin",),
    "it": ("latin",),
    "nl": ("latin",),
    "pt": ("latin",),
    "id": ("latin",),
    "vi": ("latin",),
}


def char_script(ch: str) -> Optional[str]:
    cp = ord(ch)
    for script, ranges in _SCRIPT_RANGES.items():
        for lo, hi in ranges:
            if lo <= cp <= hi:
                return script
    return None


def split_script_runs(token: str) -> list[str]:
    """Split a token at script boundaries (reference `mix_count.py:39-44`:
    Han/Latin runs become separate countable words)."""
    runs: list[str] = []
    current = ""
    current_script = None
    for ch in token:
        s = char_script(ch)
        if current and s != current_script:
            runs.append(current)
            current = ""
        current += ch
        current_script = s
    if current:
        runs.append(current)
    return runs


def tokenize(text: str) -> list[str]:
    text = _URL_RE.sub(" ", text)
    out: list[str] = []
    for tok in _TOKEN_RE.findall(text):
        if _NUM_RE.match(tok):
            continue
        for run in split_script_runs(tok):
            if run and not _NUM_RE.match(run):
                out.append(run)
    return out


def count_two_langs(
    text: str,
    lang_a: str = "en",
    lang_b: str = "zh",
    classifier: Optional[Callable[[str], str]] = None,
) -> Tuple[int, int]:
    """Count words attributable to each language.

    Word counting convention follows the reference: each Han char run
    counts its CHARACTERS as words for CJK (a Chinese 'word' per char run
    is approximated by char count), while space-delimited runs count once.

    Script-ambiguous tokens go through ``classifier`` when provided.
    When the pair SHARES a script (EN-FR/ES/PT/IT/DE/NL/ID/VI) and no
    classifier is given, the bundled pairwise model
    (:func:`~codemix_dense_retrieval_torch.datagen.lexid.default_pair_classifier`)
    is used — the stand-in for the reference's pair-constrained langid
    (the reference `mix_count.py:30-37,111`). Tokens neither resolves
    default to ``lang_a``.
    """
    scripts_a = set(_LANG_SCRIPTS.get(lang_a, ("latin",)))
    scripts_b = set(_LANG_SCRIPTS.get(lang_b, ("latin",)))
    if classifier is None and scripts_a & scripts_b:
        from codemix_dense_retrieval_torch.datagen.lexid import (
            default_pair_classifier,
        )

        classifier = default_pair_classifier(lang_a, lang_b)
    count_a = count_b = 0
    for tok in tokenize(text):
        script = char_script(tok[0])
        weight = len(tok) if script in ("han", "hiragana", "katakana") else 1
        if script in scripts_b and script not in scripts_a:
            count_b += weight
        elif script in scripts_a and script not in scripts_b:
            count_a += weight
        else:
            lang = classifier(tok) if classifier else lang_a
            if lang == lang_b:
                count_b += weight
            else:
                count_a += weight
    return count_a, count_b


def mix_ratio(
    text: str,
    lang_a: str = "en",
    lang_b: str = "zh",
    classifier: Optional[Callable[[str], str]] = None,
) -> Optional[float]:
    """Share of lang_b words, 0..100 (None when no countable words)."""
    a, b = count_two_langs(text, lang_a, lang_b, classifier)
    total = a + b
    if total == 0:
        return None
    return 100.0 * b / total
