"""Per-language and per-pair linguistic factor data.

Factual metadata used by the paper-statistics probes (typology / family /
script / resource-level splits and the distance regressions): language
facts are standard linguistic classifications; the pair distances
(lang2vec kNN, Grambank, script distance, Glottolog tree) are the
published values the reference's collectors attach to each pair
(`collect_results.py:60-112` — data, reproduced as data).
"""

from __future__ import annotations

from typing import Dict, Optional

LANG_INFO: Dict[str, Dict[str, str]] = {
    "ar": {"script": "arabic", "family": "afro-asiatic/sem", "typology": "templatic_vso/svo", "resource": "5"},
    "de": {"script": "latin", "family": "indo-european/germanic", "typology": "fusional_v2", "resource": "5"},
    "en": {"script": "latin", "family": "indo-european/germanic", "typology": "analytic_svo", "resource": "5"},
    "es": {"script": "latin", "family": "indo-european/romance", "typology": "fusional_svo", "resource": "5"},
    "fr": {"script": "latin", "family": "indo-european/romance", "typology": "fusional_svo", "resource": "5"},
    "hi": {"script": "devanagari", "family": "indo-european/indo-aryan", "typology": "fusional_agglutinative_sov", "resource": "4"},
    "id": {"script": "latin", "family": "austronesian", "typology": "analytic_svo", "resource": "3"},
    "it": {"script": "latin", "family": "indo-european/romance", "typology": "fusional_svo", "resource": "4"},
    "ja": {"script": "kanji-kana", "family": "japonic", "typology": "agglutinative_sov", "resource": "5"},
    "nl": {"script": "latin", "family": "indo-european/germanic", "typology": "fusional_v2", "resource": "4"},
    "pt": {"script": "latin", "family": "indo-european/romance", "typology": "fusional_svo", "resource": "4"},
    "ru": {"script": "cyrillic", "family": "indo-european/slavic", "typology": "fusional_svo", "resource": "4"},
    "vi": {"script": "latin", "family": "austroasiatic/vietic", "typology": "analytic_svo", "resource": "4"},
    "zh": {"script": "han", "family": "sino-tibetan/sinitic", "typology": "analytic_svo", "resource": "5"},
}

# pair -> {lang2vec_knn, gram_bank (-1 = unavailable), script, glot_tree}
PAIR_DISTANCES: Dict[str, Dict[str, float]] = {
    "AR-ZH": {"lang2vec_knn": 0.4159, "gram_bank": 0.6715, "script": 1.0, "glot_tree": 1.0},
    "DE-FR": {"lang2vec_knn": 0.1721, "gram_bank": -1.0, "script": 0.0, "glot_tree": 0.8578},
    "DE-IT": {"lang2vec_knn": 0.2168, "gram_bank": -1.0, "script": 0.0, "glot_tree": 0.8258},
    "DE-NL": {"lang2vec_knn": 0.0849, "gram_bank": -1.0, "script": 0.0, "glot_tree": 0.5417},
    "EN-AR": {"lang2vec_knn": 0.3046, "gram_bank": 0.5482, "script": 1.0, "glot_tree": 1.0},
    "EN-DE": {"lang2vec_knn": 0.1808, "gram_bank": -1.0, "script": 0.6667, "glot_tree": 0.5833},
    "EN-ES": {"lang2vec_knn": 0.2669, "gram_bank": -1.0, "script": 0.6667, "glot_tree": 0.8452},
    "EN-FR": {"lang2vec_knn": 0.232, "gram_bank": 0.4732, "script": 0.6667, "glot_tree": 0.8578},
    "EN-HI": {"lang2vec_knn": 0.3173, "gram_bank": 0.5803, "script": 0.75, "glot_tree": 0.8333},
    "EN-ID": {"lang2vec_knn": 0.2383, "gram_bank": 0.5196, "script": 0.6667, "glot_tree": 1.0},
    "EN-IT": {"lang2vec_knn": 0.2227, "gram_bank": 0.4755, "script": 0.6667, "glot_tree": 0.8258},
    "EN-JA": {"lang2vec_knn": 0.4123, "gram_bank": 0.5802, "script": 0.75, "glot_tree": 1.0},
    "EN-NL": {"lang2vec_knn": 0.1923, "gram_bank": 0.4135, "script": 0.6667, "glot_tree": 0.5417},
    "EN-PT": {"lang2vec_knn": 0.1811, "gram_bank": 0.482, "script": 0.6667, "glot_tree": 0.8542},
    "EN-RU": {"lang2vec_knn": 0.2669, "gram_bank": 0.5352, "script": 1.0, "glot_tree": 0.75},
    "EN-VI": {"lang2vec_knn": 0.2793, "gram_bank": 0.5446, "script": 0.6667, "glot_tree": 1.0},
    "EN-ZH": {"lang2vec_knn": 0.3316, "gram_bank": 0.5325, "script": 0.8, "glot_tree": 1.0},
    "ES-DE": {"lang2vec_knn": 0.3224, "gram_bank": -1.0, "script": 0.0, "glot_tree": 0.8452},
    "ES-FR": {"lang2vec_knn": 0.2737, "gram_bank": -1.0, "script": 0.0, "glot_tree": 0.3487},
    "ES-IT": {"lang2vec_knn": 0.1494, "gram_bank": -1.0, "script": 0.0, "glot_tree": 0.3506},
    "ES-PT": {"lang2vec_knn": 0.1592, "gram_bank": -1.0, "script": 0.0, "glot_tree": 0.1964},
    "FR-IT": {"lang2vec_knn": 0.1999, "gram_bank": 0.4133, "script": 0.0, "glot_tree": 0.4011},
    "FR-PT": {"lang2vec_knn": 0.1608, "gram_bank": 0.4082, "script": 0.0, "glot_tree": 0.3934},
    "HI-AR": {"lang2vec_knn": 0.2837, "gram_bank": 0.5893, "script": 1.0, "glot_tree": 1.0},
    "HI-ZH": {"lang2vec_knn": 0.3268, "gram_bank": 0.5803, "script": 0.75, "glot_tree": 1.0},
    "ID-VI": {"lang2vec_knn": 0.2157, "gram_bank": 0.4379, "script": 0.0, "glot_tree": 1.0},
    "ID-ZH": {"lang2vec_knn": 0.2977, "gram_bank": 0.4899, "script": 0.6667, "glot_tree": 1.0},
    "IT-PT": {"lang2vec_knn": 0.0922, "gram_bank": 0.2363, "script": 0.0, "glot_tree": 0.3864},
    "JA-HI": {"lang2vec_knn": 0.3819, "gram_bank": 0.5558, "script": 0.6667, "glot_tree": 1.0},
    "JA-RU": {"lang2vec_knn": 0.3939, "gram_bank": 0.5788, "script": 1.0, "glot_tree": 1.0},
    "NL-ES": {"lang2vec_knn": 0.2634, "gram_bank": -1.0, "script": 0.0, "glot_tree": 0.8286},
    "NL-FR": {"lang2vec_knn": 0.1736, "gram_bank": 0.4553, "script": 0.0, "glot_tree": 0.8412},
    "NL-IT": {"lang2vec_knn": 0.1782, "gram_bank": 0.4745, "script": 0.0, "glot_tree": 0.8091},
    "ZH-JA": {"lang2vec_knn": 0.3434, "gram_bank": 0.5209, "script": 0.75, "glot_tree": 1.0},
    "ZH-RU": {"lang2vec_knn": 0.337, "gram_bank": 0.6458, "script": 1.0, "glot_tree": 1.0},
}


def reference_pair_factors(pair: str) -> Dict[str, object]:
    """Pair features in the REFERENCE's processed-CSV vocabulary
    (`collect_results.py:313-330`): categorical match labels and 0/1
    distances rather than our boolean/graded forms. Used by the
    reference-format summary export so the emitted CSV is directly
    comparable to ``full_mmarco_processed_results.csv``."""
    out: Dict[str, object] = {}
    parts = pair.upper().split("-")
    if len(parts) != 2:
        return out
    a, b = parts[0].lower(), parts[1].lower()
    info_a, info_b = LANG_INFO.get(a, {}), LANG_INFO.get(b, {})
    out["lang_a"], out["lang_b"] = a, b
    out["script_match"] = (
        "match" if info_a and info_a.get("script") == info_b.get("script")
        else "mismatch"
    )
    out["family_dist"] = (
        0 if info_a and info_a.get("family") == info_b.get("family") else 1
    )
    out["typology_dist"] = (
        0 if info_a and info_a.get("typology") == info_b.get("typology") else 1
    )

    def res_class(info: Dict[str, str]) -> str:
        try:
            return "H" if int(info["resource"]) >= 5 else "L"
        except (KeyError, ValueError):
            return "U"

    out["resource_pattern"] = f"{res_class(info_a)}-{res_class(info_b)}"
    dist = PAIR_DISTANCES.get(f"{parts[0]}-{parts[1]}") or PAIR_DISTANCES.get(
        f"{parts[1]}-{parts[0]}"
    )
    if dist:
        out.update(dist)
    return out


def pair_factors(pair: str) -> Dict[str, object]:
    """Per-pair features: shared script/family flags + language metadata +
    published distances. ``pair`` like "EN-ZH" (order-insensitive lookup)."""
    out: Dict[str, object] = {}
    parts = pair.upper().split("-")
    if len(parts) != 2:
        return out
    a, b = parts[0].lower(), parts[1].lower()
    info_a, info_b = LANG_INFO.get(a), LANG_INFO.get(b)
    if info_a and info_b:
        out["same_script"] = info_a["script"] == info_b["script"]
        out["same_family"] = (
            info_a["family"].split("/")[0] == info_b["family"].split("/")[0]
        )
        out["min_resource"] = min(int(info_a["resource"]), int(info_b["resource"]))
        out["script_a"], out["script_b"] = info_a["script"], info_b["script"]
        out["typology_a"], out["typology_b"] = info_a["typology"], info_b["typology"]
    dist = PAIR_DISTANCES.get(f"{parts[0]}-{parts[1]}") or PAIR_DISTANCES.get(
        f"{parts[1]}-{parts[0]}"
    )
    if dist:
        out.update(dist)
    return out
