"""Embedding-space geometry analyzer.

Replaces `cm_embedding_space_analysis.py` (#15): given EN/ZH/code-mixed
query embedding triplets, computes

- on-axis position r and off-axis distance delta per query
  (`compute_line_metrics:317-333`) — vectorized over the batch;
- linear-mix reconstruction alpha / residual / R^2
  (`linear_reconstruction:335-347`);
- EN-vs-ZH logistic language probe with projections pi (`:349-360`);
- hubness: k-NN in-degree Gini + top-1% mass (`neighbor_diagnostics:362-397`),
  with the k-NN of 4,096 rows or more computed by the port's exact top-k
  on the card (kernel 2 at the analysis's real size), numpy below that;
- anisotropy: expected cosine of random pairs (`anisotropy` in the
  reference report);
- ABTT all-but-the-top postprocessing (`abtt_remove_top_pcs:143-153`);
- outlier detection by MAD on delta, low cos(CM, midpoint), and r outside
  margins (`:739-794`);
- a markdown report + per-query CSV (`:859-1119` behavioral equivalent).
"""

from __future__ import annotations

import json
import pathlib
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from codemix_dense_retrieval_torch.utils.devices import DeviceLike, resolve_device


# ---------------------------------------------------------------------------
# geometry (vectorized)
# ---------------------------------------------------------------------------

def line_metrics(e_en: np.ndarray, e_zh: np.ndarray, e_cm: np.ndarray):
    """Per-row on-axis r, off-axis delta, projection p, axis length d."""
    diff = e_zh - e_en
    d = np.linalg.norm(diff, axis=1)
    safe = d > 1e-9
    u = np.where(safe[:, None], diff / np.maximum(d[:, None], 1e-12), 0.0)
    rel = e_cm - e_en
    p = np.einsum("bd,bd->b", rel, u)
    r = np.where(safe, p / np.maximum(d, 1e-12), np.nan)
    delta = np.linalg.norm(rel - p[:, None] * u, axis=1)
    delta = np.where(safe, delta, np.nan)
    return r, delta, np.where(safe, p, np.nan), np.where(safe, d, np.nan)


def linear_reconstruction(e_en: np.ndarray, e_zh: np.ndarray, e_cm: np.ndarray):
    """Fit alpha in cm ~ alpha*en + (1-alpha)*zh per row; (alpha, resid, R^2)."""
    a = e_en - e_zh
    b = e_cm - e_zh
    denom = np.einsum("bd,bd->b", a, a)
    safe = denom > 1e-12
    alpha = np.where(safe, np.einsum("bd,bd->b", a, b) / np.maximum(denom, 1e-12), np.nan)
    resid_vec = b - alpha[:, None] * a
    resid = np.linalg.norm(resid_vec, axis=1)
    b_norm2 = np.einsum("bd,bd->b", b, b)
    r2 = 1.0 - resid**2 / (b_norm2 + 1e-12)
    return alpha, np.where(safe, resid, np.nan), np.where(safe, r2, np.nan)


def train_language_probe(E_en: np.ndarray, E_zh: np.ndarray, seed: int = 42):
    """Linear EN-vs-ZH probe; returns (unit normal, held-out accuracy)."""
    from sklearn.linear_model import LogisticRegression
    from sklearn.metrics import accuracy_score
    from sklearn.model_selection import train_test_split

    X = np.vstack([E_en, E_zh])
    y = np.array([1] * len(E_en) + [0] * len(E_zh))
    X_tr, X_te, y_tr, y_te = train_test_split(
        X, y, test_size=0.2, random_state=seed, stratify=y
    )
    clf = LogisticRegression(max_iter=1000, solver="liblinear")
    clf.fit(X_tr, y_tr)
    acc = accuracy_score(y_te, clf.predict(X_te))
    w = clf.coef_.ravel()
    return w / (np.linalg.norm(w) + 1e-12), float(acc)


def gini_coefficient(x: np.ndarray) -> float:
    x = np.sort(np.asarray(x, dtype=np.float64))
    n = len(x)
    if n == 0 or x.sum() == 0:
        return 0.0
    cum = np.cumsum(x)
    return float((n + 1 - 2 * (cum / cum[-1]).sum()) / n)


def knn_indegree(idx: np.ndarray, k_eff: int) -> np.ndarray:
    """In-degree of each row in the k-NN graph ``idx`` ((n, >= k_eff + 1)
    neighbour ids that may hold the row itself): self hits dropped, the
    first ``k_eff`` others kept."""
    n = idx.shape[0]
    rows = []
    for i in range(n):
        nbrs = [j for j in idx[i] if j != i][:k_eff]
        rows.append(nbrs)
    indeg = np.zeros(n, dtype=np.int64)
    for nbrs in rows:
        indeg[nbrs] += 1
    return indeg


def indegree_stats(indeg: np.ndarray) -> Dict[str, float]:
    """Gini, top-1% mass, mean and max of a k-NN in-degree vector."""
    n = len(indeg)
    indeg_sorted = np.sort(indeg)[::-1]
    top1pct = max(1, int(0.01 * n))
    return {
        "n_vectors_used": int(n),
        "gini_indegree": gini_coefficient(indeg.astype(float)),
        "frac_mass_top1pct": float(indeg_sorted[:top1pct].sum() / max(1, indeg.sum())),
        "avg_indegree": float(indeg.mean()),
        "max_indegree": float(indeg.max()),
    }


def hubness_stats(
    emb: np.ndarray,
    k: int = 10,
    max_vectors: int = 20_000,
    seed: int = 42,
    use_device: Optional[bool] = None,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """k-NN in-degree concentration (Gini, top-1% mass).

    ``device`` is resolved by :func:`~codemix_dense_retrieval_torch.utils.devices.resolve_device`:
    the card unless the CPU is named, and an error with no card and no
    device named. With ``use_device`` (default: 4,096 rows or more) the
    k-NN search runs on that device through the port's exact top-k
    (:func:`~codemix_dense_retrieval_torch.ops.topk.topk_ip`, the code path
    that serves retrieval); a failed launch fails the call. Otherwise
    numpy's argpartition finds it.
    """
    dev = resolve_device(device)
    n_all = emb.shape[0]
    if n_all > max_vectors:
        rng = np.random.default_rng(seed)
        emb = emb[rng.choice(n_all, size=max_vectors, replace=False)]
    n = emb.shape[0]
    normed = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    k_eff = min(k, n - 1)
    if use_device is None:
        use_device = n >= 4096
    if use_device:
        import torch

        from codemix_dense_retrieval_torch.ops.topk import topk_ip

        x = torch.as_tensor(normed, dtype=torch.float32).to(dev)
        # +1 then drop self-hit
        _, idx = topk_ip(x, x, k_eff + 1)
        idx = idx.cpu().numpy()
    else:
        S = normed @ normed.T
        idx = np.argpartition(-S, kth=k_eff, axis=1)[:, : k_eff + 1]
    return indegree_stats(knn_indegree(idx, k_eff))


def anisotropy(emb: np.ndarray, num_pairs: int = 50_000, seed: int = 42) -> Dict[str, float]:
    """Expected cosine similarity of random vector pairs."""
    rng = np.random.default_rng(seed)
    n = emb.shape[0]
    normed = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    i = rng.integers(0, n, size=num_pairs)
    j = rng.integers(0, n, size=num_pairs)
    keep = i != j
    cos = np.einsum("bd,bd->b", normed[i[keep]], normed[j[keep]])
    return {
        # keyed as the reference's shipped anisotropy.json names it
        # (cm_analysis_dev_5_bge-m3/anisotropy.json: avg_random_cosine)
        "avg_random_cosine": float(cos.mean()),
        "std_random_cosine": float(cos.std()),
        "num_pairs": int(keep.sum()),
    }


def abtt_remove_top_pcs(X: np.ndarray, n_remove: int) -> Tuple[np.ndarray, np.ndarray]:
    """All-but-the-top (Mu & Viswanath 2018): drop the top principal
    components after centering."""
    if n_remove <= 0:
        return X, np.zeros((0, X.shape[1]))
    from sklearn.decomposition import PCA

    Xc = X - X.mean(axis=0, keepdims=True)
    pca = PCA(n_components=n_remove, svd_solver="auto", random_state=0)
    pca.fit(Xc)
    U = pca.components_
    return Xc - Xc @ U.T @ U, U


def detect_outliers(
    r: np.ndarray,
    delta: np.ndarray,
    cos_mid: np.ndarray,
    *,
    r_margin: float = 0.35,
    mad_mult: float = 3.5,
    cos_floor: float = 0.85,
) -> Dict[str, np.ndarray]:
    """Outlier masks mirroring the reference's three detectors (`:739-794`):
    delta beyond median + mad_mult*MAD, cos(CM, midpoint) below floor, and
    r outside [-margin, 1+margin]."""
    med = np.nanmedian(delta)
    mad = np.nanmedian(np.abs(delta - med)) + 1e-12
    return {
        "delta_mad": (delta > med + mad_mult * 1.4826 * mad),
        "low_cos_mid": (cos_mid < cos_floor),
        "r_out_of_band": (r < -r_margin) | (r > 1.0 + r_margin),
    }


@dataclass
class AnalysisResult:
    per_query: Dict[str, np.ndarray]
    probe_accuracy: float
    probe_pi_en: np.ndarray
    probe_pi_zh: np.ndarray
    probe_pi_cm: np.ndarray
    hubness: Dict[str, float]
    anisotropy: Dict[str, float]
    outliers: Dict[str, np.ndarray]

    def summary(self) -> Dict[str, float]:
        r = self.per_query["r"]
        delta = self.per_query["delta"]
        alpha = self.per_query["alpha"]
        r2 = self.per_query["r2"]
        return {
            "n_queries": int(len(r)),
            "r_mean": float(np.nanmean(r)),
            "r_median": float(np.nanmedian(r)),
            "delta_mean": float(np.nanmean(delta)),
            "alpha_mean": float(np.nanmean(alpha)),
            "r2_mean": float(np.nanmean(r2)),
            "probe_accuracy": self.probe_accuracy,
            "pi_separation": float(
                np.nanmean(self.probe_pi_en) - np.nanmean(self.probe_pi_zh)
            ),
            "frac_outlier_delta": float(np.nanmean(self.outliers["delta_mad"])),
            **{f"hubness_{k}": v for k, v in self.hubness.items()},
            **{f"anisotropy_{k}": v for k, v in self.anisotropy.items()},
        }


def analyze_triplets(
    E_en: np.ndarray,
    E_zh: np.ndarray,
    E_cm: np.ndarray,
    *,
    hub_k: int = 10,
    seed: int = 42,
    device: DeviceLike = None,
) -> AnalysisResult:
    """Every per-query and cloud metric of the EN/ZH/CM triplets; the
    hubness k-NN runs on ``device`` (see :func:`hubness_stats`)."""
    r, delta, p, d = line_metrics(E_en, E_zh, E_cm)
    alpha, resid, r2 = linear_reconstruction(E_en, E_zh, E_cm)
    mid = 0.5 * (E_en + E_zh)
    mid /= np.maximum(np.linalg.norm(mid, axis=1, keepdims=True), 1e-12)
    cm_n = E_cm / np.maximum(np.linalg.norm(E_cm, axis=1, keepdims=True), 1e-12)
    cos_mid = np.einsum("bd,bd->b", cm_n, mid)
    w, acc = train_language_probe(E_en, E_zh, seed)
    result = AnalysisResult(
        per_query={
            "r": r, "delta": delta, "p": p, "axis_len": d,
            "alpha": alpha, "resid": resid, "r2": r2, "cos_mid": cos_mid,
        },
        probe_accuracy=acc,
        probe_pi_en=E_en @ w,
        probe_pi_zh=E_zh @ w,
        probe_pi_cm=E_cm @ w,
        hubness=hubness_stats(np.vstack([E_en, E_zh, E_cm]), k=hub_k, seed=seed, device=device),
        anisotropy=anisotropy(np.vstack([E_en, E_zh, E_cm]), seed=seed),
        outliers={},
    )
    result.outliers = detect_outliers(r, delta, cos_mid)
    return result


def project_embeddings(
    E_en: np.ndarray,
    E_zh: np.ndarray,
    E_cm: np.ndarray,
    *,
    method: str = "auto",
    abtt_remove: int = 0,
    seed: int = 42,
    max_points: int = 2000,
    n_components: int = 2,
) -> Dict[str, np.ndarray]:
    """2-D (or 3-D for the interactive HTML) projections of the EN/ZH/CM
    clouds for visualization (reference's UMAP/t-SNE panels and 3-D
    plotly HTML, `cm_embedding_space_analysis.py:859-1119`).

    ``method``: auto (umap if installed, else t-SNE, else PCA) | umap |
    tsne | pca. Returns {"en": (n,c), "zh": ..., "cm": ...}.
    """
    rng = np.random.default_rng(seed)
    parts = []
    for E in (E_en, E_zh, E_cm):
        if len(E) > max_points:
            E = E[rng.choice(len(E), size=max_points, replace=False)]
        parts.append(np.asarray(E, np.float32))
    X = np.vstack(parts)
    if abtt_remove:
        X, _ = abtt_remove_top_pcs(X, abtt_remove)

    if method == "auto":
        try:
            import umap  # noqa: F401

            method = "umap"
        except ImportError:
            method = "tsne" if len(X) <= 5000 else "pca"
    if method == "umap":
        import umap

        proj = umap.UMAP(n_components=n_components, random_state=seed).fit_transform(X)
    elif method == "tsne" and len(X) <= n_components + 1:
        method = "pca"  # t-SNE needs n_samples > n_components + 1
    elif method == "tsne":
        from sklearn.manifold import TSNE

        perplexity = min(30.0, max(1.0, (len(X) - 1) / 3.0))
        proj = TSNE(n_components=n_components, random_state=seed, init="pca",
                    perplexity=perplexity).fit_transform(X)
    else:
        from sklearn.decomposition import PCA

        proj = PCA(n_components=n_components, random_state=seed).fit_transform(X)
    n1, n2 = len(parts[0]), len(parts[1])
    return {"en": proj[:n1], "zh": proj[n1 : n1 + n2], "cm": proj[n1 + n2 :]}


def plot_projection(proj: Dict[str, np.ndarray], outpath) -> None:
    """Scatter the 2-D projection panels to png."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 4.2))
    for name, color in (("en", "#4878a8"), ("zh", "#a85a5a"), ("cm", "#6aa86a")):
        pts = proj[name]
        ax.scatter(pts[:, 0], pts[:, 1], s=4, alpha=0.5, label=name.upper(), color=color)
    ax.legend()
    ax.set_xticks([])
    ax.set_yticks([])
    outpath = pathlib.Path(outpath)
    outpath.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(outpath, dpi=150, bbox_inches="tight")
    plt.close(fig)


def write_report(result: AnalysisResult, outdir, qids: Optional[Sequence[str]] = None) -> None:
    """report.md + per-query CSV + hubness/anisotropy JSONs (the artifact
    set of the reference's `cm_analysis_dev_5_bge-m3/` example output)."""
    outdir = pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    summary = result.summary()
    (outdir / "hubness_stats.json").write_text(json.dumps(result.hubness, indent=2))
    (outdir / "anisotropy.json").write_text(json.dumps(result.anisotropy, indent=2))

    import csv

    n = len(result.per_query["r"])
    ids = list(qids) if qids is not None else [str(i) for i in range(n)]
    with open(outdir / "per_query_metrics.csv", "w", newline="") as f:
        wtr = csv.writer(f)
        cols = list(result.per_query.keys())
        wtr.writerow(["qid", *cols, "outlier_delta", "outlier_cos", "outlier_r"])
        for i in range(n):
            wtr.writerow(
                [ids[i]]
                + [f"{result.per_query[c][i]:.6f}" for c in cols]
                + [
                    int(result.outliers["delta_mad"][i]),
                    int(result.outliers["low_cos_mid"][i]),
                    int(result.outliers["r_out_of_band"][i]),
                ]
            )
    lines = ["# Code-mix embedding-space analysis", ""]
    for key, val in summary.items():
        lines.append(f"- **{key}**: {val:.4f}" if isinstance(val, float) else f"- **{key}**: {val}")
    (outdir / "report.md").write_text("\n".join(lines) + "\n")
