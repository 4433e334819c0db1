"""Paper figure generation.

Replaces `plot_diagram_2.py` (#14) with the figure families over the
collector's tidy rows (matplotlib, Agg backend, png+pdf pairs like the
reference's ``diagrams_paper/`` output):

- delta(nDCG@10) histogram over groups (`plot_delta_hist`);
- per-pair mix-ratio curves, word vs embed mode (`plot_ratio_curves`);
- lambda* distribution (`plot_lambda_star`);
- EN-in-index vs EN-absent delta split (`plot_en_split`);
- pair triad: mix curves per doc regime for one pair
  (`plot_pair_triad`, the reference's EN-ZH triad);
- typology scatter: delta vs lang2vec distance (`plot_typology_scatter`);
- headroom scatter: delta vs best endpoint with Spearman rho
  (`plot_headroom`);
- ablation dumbbells: best-endpoint -> best-mixed per setting, grouped
  by encoder (`plot_ablation_dumbbells`);
- encoder-scale curve (Qwen3 0.6B/4B/8B) (`plot_model_scale`);
- embedding-space projection panel from analyzer outputs
  (`plot_projection_panel`) and a dependency-free interactive 3D
  projection HTML (`write_projection_html`, the reference's plotly HTML
  — plotly is used when importable, else a self-contained canvas
  renderer).
"""

from __future__ import annotations

import math
import pathlib
from collections import defaultdict
from typing import Dict, List

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, outdir: pathlib.Path, name: str) -> List[pathlib.Path]:
    outdir.mkdir(parents=True, exist_ok=True)
    paths = []
    for ext in ("png", "pdf"):
        p = outdir / f"{name}.{ext}"
        fig.savefig(p, bbox_inches="tight", dpi=150)
        paths.append(p)
    return paths


def plot_delta_hist(summary_rows: List[Dict], outdir) -> List[pathlib.Path]:
    plt = _mpl()
    deltas = [r["delta_ndcg"] for r in summary_rows if not math.isnan(r.get("delta_ndcg", math.nan))]
    fig, ax = plt.subplots(figsize=(5, 3.2))
    ax.hist(deltas, bins=21, color="#4878a8", edgecolor="white")
    ax.axvline(0, color="black", lw=0.8)
    ax.set_xlabel("Δ nDCG@10 (best interior − best endpoint)")
    ax.set_ylabel("groups")
    paths = _save(fig, pathlib.Path(outdir), "delta_hist")
    plt.close(fig)
    return paths


def plot_ratio_curves(rows: List[Dict], outdir, metric: str = "ndcg10") -> List[pathlib.Path]:
    plt = _mpl()
    by_key = defaultdict(list)
    for r in rows:
        if r.get(metric) is None:
            continue
        by_key[(r.get("pair"), r.get("doc_side"), r.get("mix_mode"))].append(
            (r["mix_ratio"], r[metric])
        )
    fig, ax = plt.subplots(figsize=(5.5, 3.5))
    for (pair, doc_side, mode), pts in sorted(by_key.items(), key=lambda kv: str(kv[0])):
        pts.sort()
        xs = [p[0] for p in pts]
        ys = [p[1] for p in pts]
        style = "-o" if mode == "embed" else "--s"
        ax.plot(xs, ys, style, ms=3, lw=1, label=f"{pair} {doc_side} ({mode})")
    ax.set_xlabel("mix ratio (% second language)")
    ax.set_ylabel(metric)
    if by_key:
        ax.legend(fontsize=6)
    paths = _save(fig, pathlib.Path(outdir), f"ratio_curves_{metric}")
    plt.close(fig)
    return paths


def plot_lambda_star(summary_rows: List[Dict], outdir) -> List[pathlib.Path]:
    plt = _mpl()
    lams = [
        r["lambda_star_mid"]
        for r in summary_rows
        if r.get("lambda_star_mid") is not None and not math.isnan(r["lambda_star_mid"])
    ]
    fig, ax = plt.subplots(figsize=(4.5, 3))
    vals, counts = np.unique(lams, return_counts=True) if lams else ([], [])
    ax.bar([str(int(v)) for v in vals], counts, color="#6aa86a")
    ax.set_xlabel("λ* (%)")
    ax.set_ylabel("groups")
    paths = _save(fig, pathlib.Path(outdir), "lambda_star")
    plt.close(fig)
    return paths


def plot_en_split(split: Dict[str, Dict[str, float]], outdir) -> List[pathlib.Path]:
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(4, 3))
    names = list(split.keys())
    means = [split[n]["mean"] for n in names]
    ax.bar(names, means, color=["#a85a5a", "#5a7aa8"][: len(names)])
    ax.axhline(0, color="black", lw=0.8)
    ax.set_ylabel("mean Δ nDCG@10")
    paths = _save(fig, pathlib.Path(outdir), "en_split")
    plt.close(fig)
    return paths


def plot_projection_panel(
    pi_en: np.ndarray, pi_zh: np.ndarray, pi_cm: np.ndarray, outdir
) -> List[pathlib.Path]:
    """Language-probe projection densities (reference's probe panels)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(5, 3))
    for vals, label, color in (
        (pi_en, "EN", "#4878a8"),
        (pi_zh, "ZH", "#a85a5a"),
        (pi_cm, "CM", "#6aa86a"),
    ):
        ax.hist(vals, bins=30, alpha=0.5, label=label, color=color, density=True)
    ax.set_xlabel("probe projection π")
    ax.legend()
    paths = _save(fig, pathlib.Path(outdir), "probe_projections")
    plt.close(fig)
    return paths


def _finite(rows: List[Dict], *keys: str) -> List[Dict]:
    out = []
    for r in rows:
        vals = [r.get(k) for k in keys]
        if all(v is not None and not (isinstance(v, float) and math.isnan(v)) for v in vals):
            out.append(r)
    return out


def plot_pair_triad(
    rows: List[Dict], outdir, pair: str = "EN-ZH", metric: str = "ndcg10"
) -> List[pathlib.Path]:
    """Three panels for one pair — L1 docs / L2 docs / bilingual docs —
    each with its word- and vector-mix curves (the reference's EN-ZH
    triad figure, `plot_diagram_2.py`)."""
    plt = _mpl()
    pair_rows = [r for r in _finite(rows, metric, "mix_ratio") if r.get("pair") == pair]
    sides = sorted({r["doc_side"] for r in pair_rows}, key=lambda s: (s.startswith("bilingual"), s))
    if not sides:
        return []
    fig, axes = plt.subplots(1, len(sides), figsize=(3.2 * len(sides), 3), sharey=True)
    if len(sides) == 1:
        axes = [axes]
    for ax, side in zip(axes, sides):
        for mode, style in (("embed", "-o"), ("word", "--s")):
            pts = sorted(
                (r["mix_ratio"], r[metric]) for r in pair_rows
                if r["doc_side"] == side and r.get("mix_mode") == mode
            )
            if pts:
                ax.plot([p[0] for p in pts], [p[1] for p in pts], style, ms=3, lw=1.2,
                        label=mode)
        ax.set_title(side, fontsize=8)
        ax.set_xlabel("mix ratio (%)")
        ax.legend(fontsize=6)
    axes[0].set_ylabel(metric)
    fig.suptitle(f"{pair} mixing triad", fontsize=10)
    paths = _save(fig, pathlib.Path(outdir), f"triad_{pair.lower().replace('-', '_')}")
    plt.close(fig)
    return paths


def plot_typology_scatter(summary_rows: List[Dict], outdir) -> List[pathlib.Path]:
    """delta(nDCG@10) vs lang2vec kNN distance, script match marked
    (reference typology scatter)."""
    plt = _mpl()
    rows = _finite(summary_rows, "delta_ndcg", "lang2vec_knn")
    if not rows:
        return []
    fig, ax = plt.subplots(figsize=(4.5, 3.2))
    for same, marker, color in ((True, "o", "#4878a8"), (False, "^", "#a85a5a")):
        pts = [r for r in rows if bool(r.get("same_script")) is same]
        if pts:
            ax.scatter(
                [r["lang2vec_knn"] for r in pts], [r["delta_ndcg"] for r in pts],
                marker=marker, s=22, color=color,
                label="same script" if same else "different script",
            )
    ax.axhline(0, color="black", lw=0.8)
    ax.set_xlabel("lang2vec kNN distance")
    ax.set_ylabel("Δ nDCG@10")
    ax.legend(fontsize=7)
    paths = _save(fig, pathlib.Path(outdir), "typology_scatter")
    plt.close(fig)
    return paths


def plot_headroom(summary_rows: List[Dict], outdir) -> List[pathlib.Path]:
    """delta vs best endpoint with the Spearman rho annotation (reference
    headroom figure / `calculate_paper_values.py:608-625`)."""
    from codemix_dense_retrieval_torch.analysis.paper_values import spearman_rho

    plt = _mpl()
    rows = _finite(summary_rows, "delta_ndcg", "best_endpoint_ndcg")
    if not rows:
        return []
    x = [r["best_endpoint_ndcg"] for r in rows]
    y = [r["delta_ndcg"] for r in rows]
    fig, ax = plt.subplots(figsize=(4.5, 3.2))
    ax.scatter(x, y, s=20, color="#4878a8")
    ax.axhline(0, color="black", lw=0.8)
    if len(rows) >= 2:
        ax.set_title(f"Spearman ρ = {spearman_rho(x, y):.3f}", fontsize=9)
    ax.set_xlabel("best endpoint nDCG@10")
    ax.set_ylabel("Δ nDCG@10")
    paths = _save(fig, pathlib.Path(outdir), "headroom")
    plt.close(fig)
    return paths


def plot_ablation_dumbbells(summary_rows: List[Dict], outdir) -> List[pathlib.Path]:
    """Best-endpoint -> best-mixed dumbbells per setting, one row per
    (model, pair, doc side) — the reference's ablation dumbbell figure."""
    plt = _mpl()
    rows = _finite(summary_rows, "best_endpoint_ndcg", "best_mixed_ndcg")
    if not rows:
        return []
    rows = sorted(rows, key=lambda r: (str(r.get("model")), str(r.get("pair")),
                                       str(r.get("doc_side"))))
    labels = [
        f"{r.get('model')} {r.get('pair')} {r.get('doc_side')}" for r in rows
    ]
    fig, ax = plt.subplots(figsize=(5.5, 0.32 * len(rows) + 1.2))
    for i, r in enumerate(rows):
        e, m = r["best_endpoint_ndcg"], r["best_mixed_ndcg"]
        ax.plot([e, m], [i, i], "-", color="#999999", lw=1)
        ax.plot([e], [i], "o", color="#a85a5a", ms=4)
        ax.plot([m], [i], "o", color="#4878a8", ms=4)
    ax.set_yticks(range(len(rows)))
    ax.set_yticklabels(labels, fontsize=6)
    ax.set_xlabel("nDCG@10 (red = best endpoint, blue = best mixed)")
    paths = _save(fig, pathlib.Path(outdir), "ablation_dumbbells")
    plt.close(fig)
    return paths


_SCALE_RE = None


def plot_hub_examples(
    summary_rows: List[Dict], outdir, doc_langs: Optional[List[str]] = None
) -> List[pathlib.Path]:
    """Per-doc-language partner panel (reference
    `plot_diagram_2.py:182-320`): for each monolingual doc language,
    grouped bars of delta(nDCG@10) with EN as the mixing partner vs the
    top-2 non-EN partners, each bar labelled with its partner code."""
    from codemix_dense_retrieval_torch.io.naming import LANG_CODES

    plt = _mpl()
    # (doc_lang -> partner -> delta) over monolingual summary rows
    per_doc: Dict[str, Dict[str, float]] = defaultdict(dict)
    for r in _finite(summary_rows, "delta_ndcg"):
        side = str(r.get("doc_side") or "")
        if side.startswith("bilingual-"):
            continue
        code = LANG_CODES.get(side, side if len(side) == 2 else None)
        if not code:
            continue
        pair = str(r.get("pair") or "")
        parts = pair.lower().split("-")
        if len(parts) != 2 or code not in parts:
            continue
        partner = parts[1] if parts[0] == code else parts[0]
        per_doc[code.upper()][partner.upper()] = r["delta_ndcg"]

    langs = doc_langs or sorted(
        l for l, partners in per_doc.items() if "EN" in partners
    )
    entries = []
    for lang in langs:
        partners = per_doc.get(lang, {})
        if "EN" not in partners:
            continue
        non_en = sorted(
            ((p, d) for p, d in partners.items() if p != "EN"),
            key=lambda x: -x[1],
        )
        entries.append((lang, partners["EN"], non_en[:2]))
    if not entries:
        return []

    fig, ax = plt.subplots(figsize=(6, 3.5))
    ax.axhline(0, color="black", lw=0.8)
    x = np.arange(len(entries))
    w = 0.26
    colors = ["#4878a8", "#6aa86a", "#c88a4a"]
    for slot in range(3):
        heights, labels = [], []
        for lang, en_delta, non_en in entries:
            if slot == 0:
                heights.append(en_delta)
                labels.append("EN")
            elif slot - 1 < len(non_en):
                heights.append(non_en[slot - 1][1])
                labels.append(non_en[slot - 1][0])
            else:
                heights.append(math.nan)
                labels.append("")
        bars = ax.bar(
            x + (slot - 1) * w, heights, width=w, color=colors[slot],
            alpha=0.85, edgecolor="#333",
        )
        # partner code inside (or just above) each bar replaces a legend
        for bar, lab, h in zip(bars, labels, heights):
            if not lab or math.isnan(h):
                continue
            xc = bar.get_x() + bar.get_width() / 2
            if abs(h) >= 0.0002:
                ax.text(xc, h / 2, lab, ha="center", va="center",
                        fontsize=8, fontweight="bold")
            else:
                ax.text(xc, h, lab, ha="center",
                        va="bottom" if h >= 0 else "top", fontsize=8)
    ax.set_xticks(x)
    ax.set_xticklabels([e[0] for e in entries])
    ax.set_xlabel("document language")
    ax.set_ylabel("Δ nDCG@10")
    ax.set_title("Partner effect: EN vs top-2 non-EN")
    paths = _save(fig, pathlib.Path(outdir), "hub_examples")
    plt.close(fig)
    return paths


def plot_mono_alignment_curve(rows: List[Dict], outdir) -> List[pathlib.Path]:
    """Monolingual alignment curve (reference `plot_diagram_2.py:438-489`):
    nDCG@10 (mean ± stderr) against p_doc — the query's share in the DOC
    language (100-λ when docs are the pair's first language, λ when the
    second), pooling every monolingual setting."""
    from codemix_dense_retrieval_torch.io.naming import LANG_CODES

    plt = _mpl()
    by_p: Dict[int, List[float]] = defaultdict(list)
    for r in rows:
        if r.get("ndcg10") is None or r.get("mix_ratio") is None:
            continue
        side = str(r.get("doc_side") or "")
        if side.startswith("bilingual-"):
            continue
        code = LANG_CODES.get(side, side if len(side) == 2 else None)
        parts = str(r.get("pair") or "").lower().split("-")
        if not code or len(parts) != 2:
            continue
        lam = float(r["mix_ratio"])
        if code == parts[0]:
            p_doc = 100.0 - lam
        elif code == parts[1]:
            p_doc = lam
        else:
            continue
        by_p[int(round(p_doc))].append(float(r["ndcg10"]))
    if not by_p:
        return []
    ps = sorted(by_p)
    means = [sum(by_p[p]) / len(by_p[p]) for p in ps]
    errs = []
    for p in ps:
        vals = by_p[p]
        if len(vals) < 2:
            errs.append(0.0)
            continue
        m = sum(vals) / len(vals)
        var = sum((v - m) ** 2 for v in vals) / (len(vals) - 1)
        errs.append(math.sqrt(var / len(vals)))
    fig, ax = plt.subplots(figsize=(5.5, 3.5))
    ax.errorbar(ps, means, yerr=errs, marker="o", ms=4, lw=1.2,
                color="#4878a8", ecolor="#333", capsize=2,
                label="mean nDCG@10")
    ax.set_xlabel("p_doc (query share in doc language, %)")
    ax.set_ylabel("nDCG@10")
    ax.set_title("Monolingual alignment curve")
    ax.set_xlim(-2, 102)
    ax.legend(frameon=False, fontsize=8)
    paths = _save(fig, pathlib.Path(outdir), "mono_alignment_curve")
    plt.close(fig)
    return paths


def _model_size_b(tag: str) -> Optional[float]:
    """Parse a parameter count (in billions) out of a model tag
    ("qwen3-embedding-0.6b" -> 0.6)."""
    global _SCALE_RE
    import re

    if _SCALE_RE is None:
        _SCALE_RE = re.compile(r"(\d+(?:\.\d+)?)\s*b\b", re.IGNORECASE)
    m = _SCALE_RE.search(str(tag))
    return float(m.group(1)) if m else None


def plot_model_scale(summary_rows: List[Dict], outdir) -> List[pathlib.Path]:
    """Best-mixed nDCG vs encoder parameter count (the reference's Qwen
    scale figure); one line per (pair, doc side)."""
    plt = _mpl()
    pts = defaultdict(list)
    for r in _finite(summary_rows, "best_mixed_ndcg"):
        size = _model_size_b(r.get("model"))
        if size is not None:
            pts[(r.get("pair"), r.get("doc_side"))].append((size, r["best_mixed_ndcg"]))
    if not pts:
        return []
    fig, ax = plt.subplots(figsize=(4.5, 3.2))
    for key, series in sorted(pts.items(), key=lambda kv: str(kv[0])):
        series.sort()
        ax.plot([s for s, _ in series], [v for _, v in series], "-o", ms=4,
                lw=1.2, label=f"{key[0]} {key[1]}")
    ax.set_xscale("log")
    ax.set_xlabel("encoder parameters (B)")
    ax.set_ylabel("best mixed nDCG@10")
    ax.legend(fontsize=6)
    paths = _save(fig, pathlib.Path(outdir), "model_scale")
    plt.close(fig)
    return paths


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>body{{margin:0;background:#111;color:#eee;font:12px sans-serif}}
#c{{display:block}}#legend{{position:fixed;top:8px;left:8px}}
.sw{{display:inline-block;width:10px;height:10px;margin-right:4px}}</style>
</head><body>
<div id="legend">{legend} &mdash; drag to rotate, wheel to zoom</div>
<canvas id="c"></canvas>
<script>
const PTS = {points};   // [x, y, z, group]
const COLORS = {colors};
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let rx = 0.4, ry = 0.6, zoom = 1.0, drag = null;
function resize() {{ cv.width = innerWidth; cv.height = innerHeight; draw(); }}
function draw() {{
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, cv.width, cv.height);
  const cx = cv.width / 2, cy = cv.height / 2;
  const s = Math.min(cx, cy) * 0.8 * zoom;
  const ca = Math.cos(ry), sa = Math.sin(ry), cb = Math.cos(rx), sb = Math.sin(rx);
  const proj = PTS.map(p => {{
    const x1 = p[0] * ca + p[2] * sa, z1 = -p[0] * sa + p[2] * ca;
    const y1 = p[1] * cb - z1 * sb, z2 = p[1] * sb + z1 * cb;
    return [cx + x1 * s, cy - y1 * s, z2, p[3]];
  }});
  proj.sort((a, b) => a[2] - b[2]);
  for (const [px, py, pz, g] of proj) {{
    ctx.fillStyle = COLORS[g];
    const r = Math.max(1, 2.5 + pz * 1.5);
    ctx.beginPath(); ctx.arc(px, py, r, 0, 6.283); ctx.fill();
  }}
}}
cv.onmousedown = e => drag = [e.clientX, e.clientY];
window.onmouseup = () => drag = null;
window.onmousemove = e => {{
  if (!drag) return;
  ry += (e.clientX - drag[0]) * 0.01; rx += (e.clientY - drag[1]) * 0.01;
  drag = [e.clientX, e.clientY]; draw();
}};
cv.onwheel = e => {{ zoom *= e.deltaY < 0 ? 1.1 : 0.9; draw(); e.preventDefault(); }};
window.onresize = resize; resize();
</script></body></html>
"""

_GROUP_COLORS = ("#4878a8", "#a85a5a", "#6aa86a", "#a8a04a", "#8a5aa8")


def write_projection_html(
    points: "np.ndarray",  # (N, 3) projected coordinates
    groups: List[int],  # group index per point
    group_names: List[str],
    out_path,
    title: str = "embedding projection",
) -> pathlib.Path:
    """Interactive 3D projection HTML (reference
    `cm_embedding_space_analysis.py:859-1119` plotly output). Uses plotly
    when importable; otherwise writes a SELF-CONTAINED canvas renderer
    (no external JS, works offline)."""
    import json as _json

    out_path = pathlib.Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    pts = np.asarray(points, dtype=np.float64)
    # normalize to [-1, 1] cube for the canvas renderer
    center = pts.mean(axis=0)
    scale = np.abs(pts - center).max() or 1.0
    norm = (pts - center) / scale
    try:
        import plotly.graph_objects as go

        fig = go.Figure()
        for gi, name in enumerate(group_names):
            sel = [i for i, g in enumerate(groups) if g == gi]
            fig.add_trace(go.Scatter3d(
                x=pts[sel, 0], y=pts[sel, 1], z=pts[sel, 2], mode="markers",
                name=name, marker=dict(size=2.5,
                                       color=_GROUP_COLORS[gi % len(_GROUP_COLORS)]),
            ))
        fig.update_layout(title=title)
        fig.write_html(str(out_path), include_plotlyjs=True)
        return out_path
    except ImportError:
        pass
    legend = " ".join(
        f'<span class="sw" style="background:{_GROUP_COLORS[i % len(_GROUP_COLORS)]}">'
        f"</span>{name}"
        for i, name in enumerate(group_names)
    )
    rows = [[round(float(x), 4), round(float(y), 4), round(float(z), 4), int(g)]
            for (x, y, z), g in zip(norm, groups)]
    out_path.write_text(_HTML_TEMPLATE.format(
        title=title, legend=legend, points=_json.dumps(rows),
        colors=_json.dumps(list(_GROUP_COLORS)),
    ))
    return out_path


def generate_all(rows: List[Dict], summary_rows: List[Dict], outdir) -> List[pathlib.Path]:
    from codemix_dense_retrieval_torch.analysis.paper_values import en_absent_split

    out: List[pathlib.Path] = []
    out += plot_delta_hist(summary_rows, outdir)
    out += plot_ratio_curves(rows, outdir)
    out += plot_lambda_star(summary_rows, outdir)
    split = en_absent_split(summary_rows)
    if split:
        out += plot_en_split(split, outdir)
    pairs = sorted({str(r.get("pair")) for r in rows if r.get("pair")})
    for pair in pairs[:4]:  # triads for the leading pairs (EN-ZH first when present)
        if "EN-ZH" in pairs:
            pair = "EN-ZH" if pair == pairs[0] else pair
        out += plot_pair_triad(rows, outdir, pair=pair)
    out += plot_typology_scatter(summary_rows, outdir)
    out += plot_headroom(summary_rows, outdir)
    out += plot_ablation_dumbbells(summary_rows, outdir)
    out += plot_model_scale(summary_rows, outdir)
    out += plot_hub_examples(summary_rows, outdir)
    out += plot_mono_alignment_curve(rows, outdir)
    return out
