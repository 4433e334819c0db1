"""Code-mix band generation (word-mix data).

Replaces `generate_cm_bands.py` (#8). The reference drives an OpenAI
model per (EN, ZH) query pair, measures the realized ZH-share with the
mix counter, and files candidates into whichever band they actually land
in (opportunistic), retrying with an adaptive candidate count; output is
one ``queries-cm<L>-<H>.tsv`` per band plus ``qids-common.tsv``
(`generate_cm_bands.py:370-487,704-729`).

The generation backend is injectable (``generate_fn``): the OpenAI
implementation is provided (gated on the ``openai`` package and an API
key), and tests inject a deterministic synthesizer — the banding,
measurement, opportunistic filing, resume, and artifact logic is the
framework's and fully testable offline.
"""

from __future__ import annotations

import pathlib
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from codemix_dense_retrieval_torch.datagen.mix_count import mix_ratio
from codemix_dense_retrieval_torch.io.tsv import read_queries_tsv
from codemix_dense_retrieval_torch.utils.logging import get_logger

log = get_logger("bands")

DEFAULT_BANDS: Tuple[Tuple[int, int], ...] = ((0, 20), (20, 40), (40, 60), (60, 80), (80, 100))

# generate_fn(en_text, zh_text, target_ratios, k) -> candidate strings
GenerateFn = Callable[[str, str, Sequence[float], int], List[str]]


def band_of(ratio: float, bands: Sequence[Tuple[int, int]]) -> Optional[Tuple[int, int]]:
    """Find the band containing ratio; upper bound inclusive only for the
    last band (reference band semantics)."""
    for i, (lo, hi) in enumerate(bands):
        last = i == len(bands) - 1
        if lo <= ratio < hi or (last and ratio == hi):
            return (lo, hi)
    return None


def band_filename(band: Tuple[int, int]) -> str:
    return f"queries-cm{band[0]}-{band[1]}.tsv"


@dataclass
class BandState:
    """Per-band collected rows, resumable from existing band files."""

    bands: Tuple[Tuple[int, int], ...]
    rows: Dict[Tuple[int, int], Dict[str, str]] = field(default_factory=dict)

    def __post_init__(self) -> None:
        for b in self.bands:
            self.rows.setdefault(b, {})

    @classmethod
    def resume(cls, outdir, bands: Sequence[Tuple[int, int]] = DEFAULT_BANDS) -> "BandState":
        state = cls(tuple(bands))
        outdir = pathlib.Path(outdir)
        for b in state.bands:
            path = outdir / band_filename(b)
            if path.exists():
                for qid, text in read_queries_tsv(path):
                    state.rows[b][qid] = text
        return state

    def missing_bands(self, qid: str) -> List[Tuple[int, int]]:
        return [b for b in self.bands if qid not in self.rows[b]]

    def file_candidate(self, qid: str, text: str, ratio: float) -> Optional[Tuple[int, int]]:
        """Opportunistic filing: the candidate lands in its ACTUAL band if
        that band is still missing for this qid (reference `:430-470`)."""
        band = band_of(ratio, self.bands)
        if band is None:
            return None
        if qid in self.rows[band]:
            return None
        self.rows[band][qid] = text
        return band

    def common_qids(self) -> List[str]:
        """qids present in EVERY band (reference `:704-729`)."""
        sets = [set(r) for r in self.rows.values()]
        common = set.intersection(*sets) if sets else set()
        return sorted(common, key=lambda q: (len(q), q))

    def write(self, outdir) -> None:
        outdir = pathlib.Path(outdir)
        outdir.mkdir(parents=True, exist_ok=True)
        for band, rows in self.rows.items():
            path = outdir / band_filename(band)
            lines = [f"{qid}\t{text}" for qid, text in sorted(rows.items())]
            path.write_text("\n".join(lines) + ("\n" if lines else ""), encoding="utf-8")
        common = self.common_qids()
        (outdir / "qids-common.tsv").write_text(
            "\n".join(common) + ("\n" if common else ""), encoding="utf-8"
        )


def adaptive_k(attempt: int, base_k: int = 3, max_k: int = 10) -> int:
    """Candidate count grows with retries (the simple multi-candidate
    protocol; see ``adjust_k`` for the reference's miss-driven variant)."""
    return min(base_k * (attempt + 1), max_k)


# ---------------------------------------------------------------------------
# reference-parity K adaptation (miss-driven, word-count based)
# ---------------------------------------------------------------------------

_EPS = 1e-6


def en_token_count(text: str) -> int:
    """Whitespace word count of the English source (the K unit)."""
    return len(text.split())


def initial_k_for_band(lo: int, hi: int, en_word_count: int) -> int:
    """Initial K (number of words to switch) from the band midpoint,
    clamped to [1, n-1] so the result is truly mixed
    (`generate_cm_bands.py:146-153`)."""
    if en_word_count <= 1:
        return 1
    target_pct = (lo + hi) / 2.0
    k = round(target_pct / 100.0 * en_word_count)
    return max(1, min(k, en_word_count - 1))


def adjust_k(current_k: int, measured_ratio: float, lo: int, hi: int,
             en_word_count: int) -> int:
    """MISS-DRIVEN adjustment (`generate_cm_bands.py:155-171`): move K
    toward the band proportionally to how far the measured ratio missed,
    always by at least one word; clamp to [1, n-1]."""
    import math as _math

    if en_word_count <= 1:
        return current_k
    if measured_ratio <= lo + _EPS:
        delta_pct = max(0.0, lo - measured_ratio)
        new_k = current_k + max(1, _math.ceil(delta_pct / 100.0 * en_word_count))
    elif measured_ratio >= hi - _EPS:
        delta_pct = max(0.0, measured_ratio - hi)
        new_k = current_k - max(1, _math.ceil(delta_pct / 100.0 * en_word_count))
    else:
        return current_k
    return min(max(new_k, 1), max(1, en_word_count - 1))


def build_band_prompt(
    bands: Sequence[Tuple[int, int]],
    k_map: Dict[str, int],
    en_word_count: int,
    lang_a: str = "English",
    lang_b: str = "Chinese",
) -> str:
    """Fluency-first multi-band system prompt (same CONTRACT as the
    reference's `build_system_prompt_all_bands`, `:173-217`: one JSON
    object keyed by band label, per-band exact source-word budgets, reuse
    -only vocabulary, JSON-only output)."""
    labels = [f"{lo}-{hi}" for lo, hi in bands]
    budget_lines = "\n".join(
        f'  - "{lab}": keep exactly {en_word_count - k_map[lab]} {lang_a} words'
        for lab in labels
    )
    return (
        f"You rewrite a query as code-mixed {lang_a}/{lang_b} sentences.\n"
        "Respond with a single JSON object: every key is one of the band "
        "labels below; every value is ONE fluent code-mixed sentence built "
        f"only from the given {lang_a} and {lang_b} versions (reuse their "
        "words and phrases; never invent new facts, and never repeat the "
        "same meaning in both languages).\n"
        f"Band labels: {', '.join(labels)}.\n"
        "Fluency and meaning preservation come first: the sentence must "
        "read naturally in both grammars, not as word-by-word alternation "
        "or a concatenation of the two originals. Reordering is allowed "
        "when it improves fluency.\n"
        "Per-band word budgets:\n"
        f"{budget_lines}\n"
        "Keep the overall length close to the original; small deviations "
        "for naturalness are fine.\n"
        "Output strictly the JSON object with exactly these keys and "
        "string values — no commentary."
    )


# v2 protocol: one call per pair covering all pending bands with explicit
# per-band K budgets -> {band_label: sentence}
BandGenerateFn = Callable[[str, str, Sequence[str], Dict[str, int], int], Dict[str, str]]


def generate_bands_for_pair_kadapt(
    qid: str,
    en_text: str,
    zh_text: str,
    state: BandState,
    generate_fn: BandGenerateFn,
    *,
    lang_a: str = "en",
    lang_b: str = "zh",
    max_tries: int = 4,
    classifier=None,
) -> int:
    """Reference-parity per-pair loop (`process_one_query`, `:370-487`):
    one call per attempt covering all pending bands with per-band K
    budgets; every returned sentence is measured and filed into its
    ACTUAL band when that band is still empty (opportunistic); a band is
    satisfied when its sentence lands truly mixed inside it, otherwise
    its K moves toward the band (``adjust_k``) and it stays pending."""
    n_words = en_token_count(en_text)
    if n_words == 0:
        log.warning("[%s] empty EN text; skipping", qid)
        return 0
    filled = 0
    pending = list(state.missing_bands(qid))
    k_map = {b: initial_k_for_band(b[0], b[1], n_words) for b in pending}
    for attempt in range(1, max_tries + 1):
        if not pending:
            break
        labels = [f"{lo}-{hi}" for lo, hi in pending]
        label_k = {f"{lo}-{hi}": k_map[(lo, hi)] for lo, hi in pending}
        try:
            obj = generate_fn(en_text, zh_text, labels, label_k, attempt) or {}
        except Exception as e:  # backend exhausted its own retries
            log.warning("[%s] generation failed on attempt %d: %s", qid, attempt, e)
            break
        still_pending: List[Tuple[int, int]] = []
        for band in pending:
            lo, hi = band
            txt = (obj.get(f"{lo}-{hi}") or "").strip()
            ratio = mix_ratio(txt, lang_a, lang_b, classifier) if txt else None
            truly_mixed = ratio is not None and 0.0 < ratio < 100.0
            if truly_mixed and state.file_candidate(qid, txt, ratio) is not None:
                filled += 1
            if truly_mixed and lo <= ratio <= hi:
                continue  # satisfied (filed under its actual == target band)
            if attempt < max_tries:
                k_map[band] = adjust_k(
                    k_map[band], -1.0 if ratio is None else ratio, lo, hi, n_words
                )
                still_pending.append(band)
            else:
                log.warning(
                    "[%s %d-%d] max tries reached (ratio=%s); not written",
                    qid, lo, hi, "n/a" if ratio is None else f"{ratio:.1f}",
                )
        pending = still_pending
    return filled


def generate_bands_for_pair(
    qid: str,
    en_text: str,
    zh_text: str,
    state: BandState,
    generate_fn: GenerateFn,
    *,
    lang_a: str = "en",
    lang_b: str = "zh",
    max_attempts: int = 3,
    classifier=None,
) -> int:
    """Process one query pair: generate candidates for all missing bands,
    measure, file opportunistically, retry with larger K. Returns the
    number of newly filled bands. Endpoint bands can always be satisfied
    by the monolingual texts themselves."""
    filled = 0
    # endpoints: pure EN (ratio 0) and pure ZH (ratio 100) when bands cover them
    for text in (en_text, zh_text):
        ratio = mix_ratio(text, lang_a, lang_b, classifier)
        if ratio is not None and state.file_candidate(qid, text, ratio) is not None:
            filled += 1
    for attempt in range(max_attempts):
        missing = state.missing_bands(qid)
        if not missing:
            break
        targets = [(lo + hi) / 2.0 for lo, hi in missing]
        k = adaptive_k(attempt)
        candidates = generate_fn(en_text, zh_text, targets, k)
        for cand in candidates:
            ratio = mix_ratio(cand, lang_a, lang_b, classifier)
            if ratio is None:
                continue
            if state.file_candidate(qid, cand, ratio) is not None:
                filled += 1
    return filled


def generate_band_dataset(
    pairs: Sequence[Tuple[str, str, str]],  # (qid, en_text, zh_text)
    outdir,
    generate_fn,
    *,
    bands: Sequence[Tuple[int, int]] = DEFAULT_BANDS,
    lang_a: str = "en",
    lang_b: str = "zh",
    max_attempts: int = 3,
    num_threads: int = 1,
    classifier=None,
    checkpoint_every: int = 50,
    kadapt: bool = False,
) -> BandState:
    """Full dataset generation with resume + periodic checkpointing.

    ``kadapt=True`` selects the reference-parity protocol
    (``generate_bands_for_pair_kadapt``: one JSON call per attempt with
    per-band K budgets, miss-driven adjustment); the default keeps the
    simpler multi-candidate protocol."""
    outdir = pathlib.Path(outdir)
    state = BandState.resume(outdir, bands)
    lock = threading.Lock()
    processed = 0

    def work(item):
        nonlocal processed
        qid, en_text, zh_text = item
        with lock:
            if not state.missing_bands(qid):
                return
        if kadapt:
            generate_bands_for_pair_kadapt(
                qid, en_text, zh_text, state, generate_fn,
                lang_a=lang_a, lang_b=lang_b, max_tries=max_attempts,
                classifier=classifier,
            )
        else:
            generate_bands_for_pair(
                qid, en_text, zh_text, state, generate_fn,
                lang_a=lang_a, lang_b=lang_b, max_attempts=max_attempts,
                classifier=classifier,
            )
        with lock:
            processed += 1
            if processed % checkpoint_every == 0:
                state.write(outdir)

    if num_threads > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(num_threads) as pool:
            list(pool.map(work, pairs))
    else:
        for item in pairs:
            work(item)
    state.write(outdir)
    return state


class UsageTracker:
    """Token/cost accounting across generator calls (the reference keeps
    running cost totals, `generate_cm_bands.py:364-365,433-434`)."""

    def __init__(self, prompt_usd_per_1m: float = 0.0, completion_usd_per_1m: float = 0.0):
        self.prompt_tokens = 0
        self.completion_tokens = 0
        self.calls = 0
        self._pp = prompt_usd_per_1m
        self._cp = completion_usd_per_1m

    def add(self, usage) -> None:
        self.calls += 1
        if usage is None:
            return
        self.prompt_tokens += getattr(usage, "prompt_tokens", 0) or 0
        self.completion_tokens += getattr(usage, "completion_tokens", 0) or 0

    @property
    def cost_usd(self) -> float:
        return (
            self.prompt_tokens * self._pp + self.completion_tokens * self._cp
        ) / 1_000_000

    def summary(self) -> dict:
        return {
            "calls": self.calls,
            "prompt_tokens": self.prompt_tokens,
            "completion_tokens": self.completion_tokens,
            "cost_usd": round(self.cost_usd, 4),
        }


def _best_effort_json_object(raw: str) -> Dict[str, str]:
    """Parse the model output into a dict, tolerating code fences and
    leading/trailing prose (reference best-effort extraction)."""
    import json as _json
    import re as _re

    if not raw:
        return {}
    try:
        obj = _json.loads(raw)
        return obj if isinstance(obj, dict) else {}
    except ValueError:
        pass
    m = _re.search(r"\{.*\}", raw, _re.DOTALL)
    if m:
        try:
            obj = _json.loads(m.group(0))
            return obj if isinstance(obj, dict) else {}
        except ValueError:
            return {}
    return {}


# Models with fixed sampling (GPT-5 / o1 / o3 reject temperature/top_p) —
# reference `generate_cm_bands.py:67,304-313`.
_FIXED_SAMPLING_RE = None


def _supports_sampling(model: str) -> bool:
    """False for fixed-sampling models (gpt-5*/o1*/o3*), which reject
    ``temperature``/``top_p`` (reference `generate_cm_bands.py:304-307`)."""
    global _FIXED_SAMPLING_RE
    if _FIXED_SAMPLING_RE is None:
        import re as _re

        _FIXED_SAMPLING_RE = _re.compile(r"^(gpt-5|o1|o3)", _re.IGNORECASE)
    return _FIXED_SAMPLING_RE.match(model) is None


def _sampling_kwargs(model: str, temp: float) -> Dict[str, float]:
    """Sampling kwargs only for models that accept them
    (reference `generate_cm_bands.py:309-313`)."""
    if _supports_sampling(model):
        return {"temperature": temp, "top_p": 0.8}
    return {}


def _is_nonretryable(e: Exception) -> bool:
    """True for invalid-request-class API errors: retrying cannot help
    (malformed params fail identically every attempt)."""
    name = type(e).__name__
    if name in ("BadRequestError", "InvalidRequestError", "UnprocessableEntityError",
                "AuthenticationError", "PermissionDeniedError", "NotFoundError"):
        return True
    status = getattr(e, "status_code", None)
    return status is not None and 400 <= int(status) < 500 and int(status) != 429


def _retrying(call, attempts: int = 6, max_backoff: float = 20.0):
    """Exponential-backoff retry (tenacity-equivalent, dependency-free).
    Non-transient invalid-request errors are raised immediately."""
    import random as _random
    import time as _time

    last = None
    for i in range(attempts):
        try:
            return call()
        except Exception as e:  # network/API errors
            if _is_nonretryable(e):
                raise
            last = e
            _time.sleep(min(max_backoff, (2 ** i) * _random.uniform(0.5, 1.0)))
    raise last


def openai_band_generate_fn(
    model: str = "gpt-5-mini",
    api_key: Optional[str] = None,
    usage: Optional[UsageTracker] = None,
    temp_first: float = 0.7,
    temp_retry: float = 1.0,
    *,
    client=None,
    retry_attempts: int = 6,
    max_backoff: float = 20.0,
) -> BandGenerateFn:
    """Reference-parity OpenAI backend for ``generate_bands_for_pair_kadapt``:

    - prefers the RESPONSES API with JSON mode, dropping
      ``response_format`` when the model rejects it;
    - falls back to CHAT COMPLETIONS on Responses failure (same JSON-mode
      downgrade) — `generate_cm_bands.py:316-361`;
    - exponential-backoff retries around each API;
    - first attempt uses ``temp_first``, retries ``temp_retry``.

    ``client`` is injectable for tests; otherwise ``openai.OpenAI()``.
    """
    if client is None:
        from openai import OpenAI  # gated import

        client = OpenAI(api_key=api_key)

    def _track(resp) -> None:
        if usage is not None:
            usage.add(getattr(resp, "usage", None))

    def _responses(instructions: str, user_text: str, temp: float) -> str:
        base = dict(
            model=model,
            instructions=instructions,
            input=[{"role": "user", "content": [{"type": "text", "text": user_text}]}],
            **_sampling_kwargs(model, temp),
        )
        try:
            resp = client.responses.create(
                response_format={"type": "json_object"}, **base
            )
        except Exception as e:
            if "response_format" not in str(e) and "unsupported" not in str(e).lower():
                raise
            resp = client.responses.create(**base)
        _track(resp)
        text = getattr(resp, "output_text", None)
        if text is None:  # assemble from output items
            parts = []
            for item in getattr(resp, "output", []) or []:
                for c in getattr(item, "content", []) or []:
                    parts.append(getattr(c, "text", "") or "")
            text = "".join(parts)
        return text or ""

    def _chat(system: str, user_text: str, temp: float) -> str:
        base = dict(
            model=model,
            messages=[{"role": "system", "content": system},
                      {"role": "user", "content": user_text}],
            **_sampling_kwargs(model, temp),
        )
        try:
            resp = client.chat.completions.create(
                response_format={"type": "json_object"}, **base
            )
        except Exception as e:
            if "response_format" not in str(e) and "unsupported" not in str(e).lower():
                raise
            resp = client.chat.completions.create(**base)
        _track(resp)
        try:
            return resp.choices[0].message.content or ""
        except (AttributeError, IndexError):
            return ""

    def generate(en_text, zh_text, labels, k_map, attempt) -> Dict[str, str]:
        bands = [tuple(int(x) for x in lab.split("-")) for lab in labels]
        prompt = build_band_prompt(bands, k_map, en_token_count(en_text))
        user_text = f"EN: {en_text}\nZH: {zh_text}"
        temp = temp_first if attempt == 1 else temp_retry
        try:
            raw = _retrying(lambda: _responses(prompt, user_text, temp),
                            retry_attempts, max_backoff)
        except Exception:
            raw = _retrying(lambda: _chat(prompt, user_text, temp),
                            retry_attempts, max_backoff)
        return _best_effort_json_object(raw)

    return generate


def openai_generate_fn(
    model: str = "gpt-5-mini",
    api_key: Optional[str] = None,
    usage: Optional[UsageTracker] = None,
) -> GenerateFn:
    """OpenAI-backed candidate generator (host-side; requires network +
    the ``openai`` package — mirrors the reference's prompt contract,
    `generate_cm_bands.py:173-217`). Pass a ``UsageTracker`` to accumulate
    token counts / cost."""
    from openai import OpenAI  # gated import

    client = OpenAI(api_key=api_key)

    def generate(en_text: str, zh_text: str, targets: Sequence[float], k: int) -> List[str]:
        target_desc = ", ".join(f"{t:.0f}%" for t in targets)
        prompt = (
            "You create code-switched (Chinese-English mixed) versions of a query.\n"
            f"English: {en_text}\nChinese: {zh_text}\n"
            f"Produce {k} natural mixed versions for EACH of these Chinese-word "
            f"percentages: {target_desc}. Keep the meaning identical. "
            "Return one query per line, no numbering."
        )
        resp = client.chat.completions.create(
            model=model, messages=[{"role": "user", "content": prompt}]
        )
        if usage is not None:
            usage.add(getattr(resp, "usage", None))
        text = resp.choices[0].message.content or ""
        return [line.strip() for line in text.splitlines() if line.strip()]

    return generate
