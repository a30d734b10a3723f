"""Protein-group FDR.

Per protein group and decoy class (pandas' ``groupby(["pg", "decoy"])``:
keys in sorted order) seven features (row count, mean / best / worst PSM
``proba``, distinct peptides, precursors and runs); 80% of the groups
(``default_rng(42).permutation``) train an MLP on standardized features
(``outputs/mlp``, scikit-learn's classifier with ``random_state=0``,
``max_iter=300``); q-values of its decoy probability, scaled by targets
over decoys; then the PSMs with their group's ``pg_qval``, targets first.
"""

from __future__ import annotations

import logging
import time

import numpy as np

from alphadia_torch.exceptions import TooFewProteinsError
from alphadia_torch.fdr.qvalues import get_q_values
from alphadia_torch.outputs.df_builders import nanmean, nunique
from alphadia_torch.outputs.mlp import MLPClassifier, StandardScaler
from alphadia_torch.utils.frame import take

logger = logging.getLogger(__name__)

FEATURE_COLUMNS = ["count", "mean_score", "n_peptides", "n_precursor", "n_runs", "best_score", "worst_score"]


def _group_rows(pg: np.ndarray, decoy: np.ndarray) -> list[tuple[tuple, np.ndarray]]:
    """(key, row indices) of each (pg, decoy) group, keys sorted."""
    groups: dict = {}
    for i, key in enumerate(zip(pg.tolist(), decoy.tolist())):
        groups.setdefault(key, []).append(i)
    return [(key, np.asarray(groups[key])) for key in sorted(groups)]


def protein_features(psm_df: dict) -> dict:
    pg, decoy = np.asarray(psm_df["pg"], object), np.asarray(psm_df["decoy"])
    proba = np.asarray(psm_df["proba"])
    cols = {c: [] for c in ["pg", "genes", "proteins", "decoy", *FEATURE_COLUMNS]}
    for (g, d), rows in _group_rows(pg, decoy):
        cols["pg"].append(g)
        cols["genes"].append(psm_df["genes"][rows[0]] if "genes" in psm_df else "")
        cols["proteins"].append(psm_df["proteins"][rows[0]] if "proteins" in psm_df else "")
        cols["decoy"].append(d)
        cols["count"].append(len(rows))
        n_prec = nunique(np.asarray(psm_df["precursor_idx"])[rows])
        cols["n_precursor"].append(n_prec)
        cols["n_peptides"].append(nunique(np.asarray(psm_df["sequence"])[rows]) if "sequence" in psm_df else n_prec)
        cols["n_runs"].append(nunique(np.asarray(psm_df["run"])[rows]) if "run" in psm_df else 1)
        p = proba[rows]
        cols["mean_score"].append(nanmean(p))
        cols["best_score"].append(float(np.nanmin(p)))
        cols["worst_score"].append(float(np.nanmax(p)))
    out = {k: np.array(v, object) for k, v in cols.items() if k in ("pg", "genes", "proteins")}
    out["decoy"] = np.asarray(cols["decoy"])
    for c in FEATURE_COLUMNS:
        out[c] = np.asarray(cols[c], np.int64 if c in ("count", "n_precursor", "n_peptides", "n_runs") else np.float64)
    return out


def perform_protein_fdr(psm_df: dict, timings: dict | None = None) -> dict:
    """``psm_df`` with ``pg_qval``, targets then decoys (each in their own
    order). ``timings``, where given, gets the MLP fit's seconds and
    epochs."""
    features = protein_features(psm_df)
    n_targets = int((features["decoy"] == 0).sum())
    n_decoys = int((features["decoy"] == 1).sum())
    if n_targets < 2 or n_decoys < 2:
        raise TooFewProteinsError()

    x = np.stack([features[c].astype(np.float64) for c in FEATURE_COLUMNS], axis=1)
    y = features["decoy"]
    perm = np.random.default_rng(42).permutation(len(x))
    train = perm[: max(int(len(x) * 0.8), 2)]

    t0 = time.perf_counter()
    scaler = StandardScaler()
    x_train = scaler.fit_transform(x[train])
    x_all = scaler.transform(x)
    clf = MLPClassifier(random_state=0, max_iter=300).fit(x_train, y[train])
    features["proba"] = clf.predict_proba(x_all)[:, 1]
    if timings is not None:
        timings["mlp_fit_s"] = time.perf_counter() - t0
        timings["mlp_epochs"] = clf.n_iter_

    features = get_q_values(features, score_column="proba", decoy_column="decoy", qval_column="pg_qval",
                            extra_sort_columns=["pg"])
    logger.info(f"Protein FDR: {n_targets:,} target and {n_decoys:,} decoy protein groups")
    features["pg_qval"] = features["pg_qval"] * n_targets / max(n_decoys, 1)

    decoy = np.asarray(psm_df["decoy"])
    parts = []
    for d in (0, 1):
        qval_of = {g: q for g, q, fd in zip(features["pg"], features["pg_qval"], features["decoy"]) if fd == d}
        part = take(psm_df, np.nonzero(decoy == d)[0])
        part["pg_qval"] = np.array([qval_of.get(g, np.nan) for g in part["pg"]], np.float64)
        parts.append(part)
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
