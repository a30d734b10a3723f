"""FDR: classifier fit, q-values, fragment competition, best per group.

The JAX package's ``perform_fdr`` on column-dict frames: an 80/20 train
split, the network fit (on its device), probabilities, q-values; fragment
competition below the 10% heuristic; the best PSM per group; q-values
again. Below ``MIN_PSM_FOR_NN`` PSMs, or with too few decoys, a balanced
logistic regression ranks the PSMs instead (the JAX package's statistical
fallback, scikit-learn's ``LogisticRegression(class_weight="balanced")``,
here its objective minimised with scipy's L-BFGS-B on the host).

Pandas' row index becomes the ``_row`` column: the position of each PSM in
the target + decoy concatenation, which fragment competition restores the
order by; the returned frame drops it.
"""

from __future__ import annotations

import logging

import numpy as np
from scipy.optimize import minimize
from scipy.special import expit

from alphadia_torch.fdr.fragcomp import ROW, FragmentCompetition
from alphadia_torch.fdr.qvalues import get_q_values, keep_best
from alphadia_torch.reporting.figure import subplots
from alphadia_torch.utils.frame import Frame, concat, n_rows, take

logger = logging.getLogger(__name__)

# below this many PSMs the network gives way to balanced logistic regression
MIN_PSM_FOR_NN = 500


def balanced_logistic_proba(x: np.ndarray, y: np.ndarray, C: float = 1.0, tol: float = 1e-4, max_iter: int = 1000):
    """P(y = 1) of scikit-learn's ``LogisticRegression(class_weight=
    "balanced", C=C, tol=tol, max_iter=max_iter)`` (lbfgs) fitted on ``x``:
    the same objective, ``0.5 |w|^2 + C sum_i s_i logloss_i`` with class
    weights ``s = n / (2 n_c)`` and an unpenalised intercept, scaled as
    scikit-learn scales it (by the weights' sum), and the same L-BFGS-B
    settings from zeros. Like scikit-learn's, the probabilities come out in
    the features' dtype (float32 for float32 features, else float64)."""
    dtype = np.float32 if np.asarray(x).dtype == np.float32 else np.float64
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    classes, inverse, counts = np.unique(y, return_inverse=True, return_counts=True)
    sw = (len(y) / (len(classes) * counts))[inverse]
    target = (y == classes[-1]).astype(np.float64)
    sw_sum = sw.sum()
    l2 = 1.0 / (C * sw_sum)

    def loss_grad(coef):
        w, b = coef[:-1], coef[-1]
        z = x @ w + b
        loss = float(sw @ (np.logaddexp(0.0, z) - target * z)) / sw_sum + 0.5 * l2 * float(w @ w)
        r = sw * (expit(z) - target) / sw_sum
        return loss, np.concatenate([x.T @ r + l2 * w, [r.sum()]])

    res = minimize(
        loss_grad, np.zeros(x.shape[1] + 1), method="L-BFGS-B", jac=True,
        options={"maxiter": max_iter, "maxls": 50, "gtol": tol, "ftol": 64 * np.finfo(float).eps},
    )
    coef = res.x.astype(dtype)
    return expit(x.astype(dtype) @ coef[:-1] + coef[-1])


def _dropna(df: dict, columns: list[str]) -> dict:
    keep = np.ones(n_rows(df), bool)
    for c in columns:
        if df[c].dtype.kind in "fc":
            keep &= ~np.isnan(df[c])
    return take(df, keep)


def perform_fdr(
    classifier,
    available_columns: list[str],
    df_target: dict,
    df_decoy: dict,
    *,
    competitive: bool = False,
    group_channels: bool = True,
    df_fragments: dict | None = None,
    dia_cycle: np.ndarray | None = None,
    fdr_heuristic: float = 0.1,
    random_state: int | None = None,
    figure_path: str | None = None,
) -> Frame:
    """The PSMs with ``proba`` and ``qval`` added; ``attrs["fdr_estimator"]``
    names what ranked them (``nn``, ``logistic``, ``no_decoy``,
    ``no_target``)."""
    df_target = _dropna(df_target, available_columns)
    df_decoy = _dropna(df_decoy, available_columns)
    n_t, n_d = n_rows(df_target), n_rows(df_decoy)
    if n_t + n_d and (n_t > 3 * max(n_d, 1) or n_d > 3 * max(n_t, 1)):
        logger.warning("FDR: extreme target/decoy imbalance (%d vs %d); classifier ranking may degrade", n_t, n_d)

    def features(df):
        return np.stack([df[c].astype(np.float32) for c in available_columns], 1).reshape(n_rows(df), len(available_columns))

    X = np.concatenate([features(df_target), features(df_decoy)])
    y = np.concatenate([np.zeros(n_t), np.ones(n_d)]).astype(np.float32)
    psm = concat([df_target, df_decoy])
    psm["_decoy"] = y
    psm[ROW] = np.arange(len(y))

    too_small = len(X) < MIN_PSM_FOR_NN
    too_few_decoys = n_d < max(50, 0.02 * n_t)
    if n_t == 0:
        psm["qval"] = np.ones(len(y))
        psm["proba"] = np.ones(len(y))
        return _finish(psm, "no_target")
    if (too_small or too_few_decoys) and n_d >= 1:
        logger.warning(
            "FDR: %d decoys vs %d targets, too few to train the network; using balanced logistic regression", n_d, n_t
        )
        mu = X.mean(axis=0)
        sd = X.std(axis=0) + 1e-9
        Xz = np.nan_to_num((X - mu) / sd, nan=0.0, posinf=0.0, neginf=0.0)
        psm["proba"] = balanced_logistic_proba(Xz, y)
        estimator = "logistic"
    elif n_d == 0:
        logger.warning("FDR: no decoy PSMs among %d candidates; decoy-counting q-values are 0 by construction", n_t)
        psm["proba"] = np.zeros(len(y))
        estimator = "no_decoy"
    else:
        rng = np.random.default_rng(random_state)
        perm = rng.permutation(len(X))
        train_idx = perm[: int(len(X) * 0.8)]
        classifier.fit(X[train_idx], y[train_idx])
        psm["proba"] = classifier.predict_proba(X)[:, 1]
        estimator = "nn"
    psm = get_q_values(psm, "proba", "_decoy")

    group_columns = (
        (["elution_group_idx", "channel"] if group_channels else ["elution_group_idx"])
        if competitive
        else ["precursor_idx"]
    )
    if df_fragments is not None and n_rows(df_fragments) and dia_cycle is not None and dia_cycle.shape[2] <= 2:
        # the rows below the heuristic, in q-value order; competition gives
        # them back in concatenation order
        start_idx = int(np.searchsorted(psm["qval"], fdr_heuristic, side="left"))
        if start_idx == 0:
            start_idx = n_rows(psm)
        psm = FragmentCompetition()(take(psm, slice(0, start_idx)), df_fragments, dia_cycle)

    psm = keep_best(psm, group_columns=group_columns)
    psm = get_q_values(psm, "proba", "_decoy")
    if figure_path is not None:
        _plot_fdr(psm, figure_path)
    return _finish(psm, estimator)


def _finish(psm: dict, estimator: str) -> Frame:
    out = Frame((k, v) for k, v in psm.items() if k != ROW)
    out.attrs["fdr_estimator"] = estimator
    return out


def _plot_fdr(psm: dict, figure_path: str) -> None:
    """The proba histograms of targets and decoys (50 step bins) and the
    targets against their q-value, written to ``figure_path`` at 120 dpi."""
    decoy = psm["_decoy"] == 1
    fig, axes = subplots(1, 2, figsize=(9, 3.5))
    axes[0].hist([psm["proba"][~decoy], psm["proba"][decoy]], bins=50, label=["target", "decoy"], histtype="step")
    axes[0].set_xlabel("proba")
    axes[0].legend()
    qv = np.sort(psm["qval"][~decoy])
    axes[1].plot(qv, np.arange(len(qv)))
    axes[1].set_xlim(0, 0.05)
    axes[1].set_xlabel("q-value")
    axes[1].set_ylabel("# targets")
    fig.tight_layout()
    fig.savefig(figure_path, dpi=120)
