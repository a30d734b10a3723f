"""Classifier-agnostic target-decoy FDR with posterior error probabilities,
on column dicts.

``TargetDecoyFDR`` takes any estimator with ``fit(X, y)`` and
``predict_proba(X)`` (the port's ``BinaryClassifier``,
``outputs/mlp.MLPClassifier``, ...): the decoy probability of each row,
optional fragment competition and group competition, q-values scaled by
the target/decoy ratio (``add_q_values``: FDR = decoys / (targets +
1e-6), unlike ``qvalues.get_q_values``) and a kernel-smoothed PEP.
"""

from __future__ import annotations

import logging

import numpy as np

from alphadia_torch.fdr.qvalues import fdr_to_q_values, keep_best
from alphadia_torch.utils.frame import copy_frame, lexsort_rows, n_rows, take

logger = logging.getLogger(__name__)


def add_q_values(
    df: dict,
    decoy_proba_column: str = "decoy_proba",
    decoy_column: str = "decoy",
    qval_column: str = "qval",
    r_target_decoy: float = 1.0,
) -> dict:
    """q-values from decoy counting, scaled by the target/decoy ratio: with
    r targets per decoy, each observed decoy stands for r false targets."""
    sort_cols = [decoy_proba_column, decoy_column]
    if "precursor_idx" in df:
        sort_cols.append("precursor_idx")  # deterministic tie-break
    df = take(df, lexsort_rows(df, sort_cols))
    decoys = np.asarray(df[decoy_column], np.float64)
    fdr = np.cumsum(decoys) / (np.cumsum(1.0 - decoys) + 1e-6)
    df[qval_column] = fdr_to_q_values(fdr) * r_target_decoy
    return df


def get_pep(
    psm_df: dict,
    score_column: str = "decoy_proba",
    decoy_column: str = "decoy",
    score_std: float = 0.01,
    pep_granularity: int = 1000,
    kernel_size: int = 20,
) -> np.ndarray:
    """Posterior error probability: decoy density over total density of
    Gaussian-smoothed score histograms."""
    score_bins = np.linspace(0, 1, pep_granularity)
    is_decoy = np.asarray(psm_df[decoy_column])
    score = np.asarray(psm_df[score_column])
    target_hist, _ = np.histogram(score[is_decoy == 0], bins=score_bins)
    decoy_hist, _ = np.histogram(score[is_decoy == 1], bins=score_bins)
    std_norm = score_std / (score_bins[1] - score_bins[0])
    kernel = np.exp(-(np.arange(-kernel_size, kernel_size + 1) ** 2) / (2 * std_norm**2))
    target_hist = np.convolve(target_hist, kernel, mode="same")
    decoy_hist = np.convolve(decoy_hist, kernel, mode="same")
    pep = decoy_hist / (target_hist + decoy_hist + 1e-6)
    return pep[np.clip(np.digitize(score, score_bins) - 1, 0, len(pep) - 1)]


class TargetDecoyFDR:
    """FDR over any identification level with a pluggable classifier."""

    def __init__(self, classifier, feature_columns: list[str], decoy_column: str = "decoy",
                 competition_columns: list[str] | None = None):
        self._classifier = classifier
        self._feature_columns = feature_columns
        self._decoy_column = decoy_column
        self._competition_columns = competition_columns or []

    def _nan_rows(self, psm_df: dict) -> np.ndarray:
        x = np.stack([np.asarray(psm_df[c], np.float64) for c in self._feature_columns], axis=1)
        return np.isnan(x).any(axis=1)

    def fit_classifier(self, psm_df: dict, random_state: int = 0) -> None:
        nan_row = self._nan_rows(psm_df)
        if nan_row.any():
            logger.info(f"fdrx: removing {int(nan_row.sum())} rows with NaNs")
        x = np.stack([np.asarray(psm_df[c])[~nan_row] for c in self._feature_columns], axis=1).astype(np.float32)
        y = np.asarray(psm_df[self._decoy_column])[~nan_row].astype(np.float32)
        perm = np.random.default_rng(random_state).permutation(len(x))
        n_train = max(1, int(len(x) * 0.8))
        self._classifier.fit(x[perm[:n_train]], y[perm[:n_train]])

    def predict_classifier(self, psm_df: dict) -> np.ndarray:
        """Decoy probability per row; a row with a NaN feature gets 1."""
        nan_row = self._nan_rows(psm_df)
        x = np.stack([np.asarray(psm_df[c])[~nan_row] for c in self._feature_columns], axis=1).astype(np.float32)
        proba = np.ones(len(nan_row))
        if len(x):
            proba[~nan_row] = self._classifier.predict_proba(x)[:, 1]
        return proba

    def predict_qval(self, psm_df: dict, fragments_df: dict | None = None, dia_cycle: np.ndarray | None = None,
                     competition_heuristic: float = 0.10) -> dict:
        psm_df = copy_frame(psm_df)
        psm_df["decoy_proba"] = self.predict_classifier(psm_df)
        decoy = np.asarray(psm_df[self._decoy_column])
        n_d = int((decoy == 1).sum())
        r_target_decoy = float((decoy == 0).sum()) / n_d if n_d else 1.0

        if dia_cycle is not None and fragments_df is not None and n_rows(fragments_df) and dia_cycle.shape[2] <= 2:
            from alphadia_torch.fdr.fragcomp import FragmentCompetition

            psm_df = add_q_values(psm_df, "decoy_proba", self._decoy_column, r_target_decoy=r_target_decoy)
            passing = take(psm_df, psm_df["qval"] < competition_heuristic)
            # with nothing past the heuristic, keep the whole table
            if n_rows(passing):
                passing["proba"] = passing["decoy_proba"]
                psm_df = FragmentCompetition()(passing, fragments_df, dia_cycle)
                psm_df.pop("proba")

        if self._competition_columns:
            psm_df = keep_best(psm_df, score_column="decoy_proba", group_columns=self._competition_columns)
        psm_df = add_q_values(psm_df, "decoy_proba", self._decoy_column, r_target_decoy=r_target_decoy)
        psm_df["pep"] = get_pep(psm_df, score_column="decoy_proba", decoy_column=self._decoy_column)
        return psm_df

    def fit_predict_qval(self, psm_df: dict, fragments_df: dict | None = None, cycle: np.ndarray | None = None) -> dict:
        self.fit_classifier(psm_df)
        return self.predict_qval(psm_df, fragments_df, cycle)
