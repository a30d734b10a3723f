"""Per-run quadrupole transmission calibration.

A logistic-rectangle transmission model with (sigma1, sigma2, delta_mu1,
delta_mu2) shared across windows, fitted by a damped Gauss-Newton
(Levenberg-Marquardt) with an analytic Jacobian on the host: the problem
is four parameters, too small for the card. The observations come from
scoring itself: it extracts the raw per-window fragment sums of every
candidate (``obs_intensity_{o}``, ``obs_win_lo/hi_{o}``), so precursors in
the overlap of two isolation windows measure the relative transmission
against their offset from each window edge. The workflow fits it at every
recalibration when ``search.quadrupole_fit`` is set (the default).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def logistic_rectangle_np(mu1, mu2, sigma1, sigma2, x):
    """Transmission: rising logistic at mu1 minus one at mu2 (numpy)."""
    a1 = np.clip((x - mu1) / sigma1, -60.0, 60.0)
    a2 = np.clip((x - mu2) / sigma2, -60.0, 60.0)
    return 1.0 / (1.0 + np.exp(-a1)) - 1.0 / (1.0 + np.exp(-a2))


def fit_quadrupole_params(
    mu1: np.ndarray,
    mu2: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    sigma0: tuple[float, float] = (0.2, 0.2),
    delta0: tuple[float, float] = (0.0, 0.0),
    n_iter: int = 50,
    min_sigma: float = 0.02,
    max_sigma: float = 10.0,
    max_delta: float = 1.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Least-squares fit of (sigma1, sigma2, delta_mu1, delta_mu2):
    damped Gauss-Newton (Levenberg-Marquardt) with the analytic Jacobian of
    the logistic rectangle."""
    mu1 = np.asarray(mu1, np.float64)
    mu2 = np.asarray(mu2, np.float64)
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    p = np.array([sigma0[0], sigma0[1], delta0[0], delta0[1]], np.float64)
    lam = 1e-3

    def resid(p):
        s1, s2, d1, d2 = p
        return y - logistic_rectangle_np(mu1 + d1, mu2 + d2, s1, s2, x)

    def jac(p):
        s1, s2, d1, d2 = p
        a1 = np.clip((x - mu1 - d1) / s1, -60.0, 60.0)
        a2 = np.clip((x - mu2 - d2) / s2, -60.0, 60.0)
        L1 = 1.0 / (1.0 + np.exp(-a1))
        L2 = 1.0 / (1.0 + np.exp(-a2))
        g1 = L1 * (1.0 - L1)
        g2 = L2 * (1.0 - L2)
        # d(model)/dp; residual Jacobian is the negative of this
        return np.stack(
            [-g1 * a1 / s1, g2 * a2 / s2, -g1 / s1, g2 / s2], axis=1
        )

    r = resid(p)
    cost = float(r @ r)
    for _ in range(n_iter):
        J = -jac(p)  # d(resid)/dp
        g = J.T @ r
        H = J.T @ J
        step = np.linalg.solve(H + lam * np.eye(4), -g)
        p_new = p + step
        p_new[0] = np.clip(p_new[0], min_sigma, max_sigma)
        p_new[1] = np.clip(p_new[1], min_sigma, max_sigma)
        # physical quadrupole edge offsets are sub-Th; an unbounded
        # delta_mu drifts on sparse/ill-conditioned observation sets
        # (seen at several Th on synthetic hard-edged windows)
        p_new[2] = np.clip(p_new[2], -max_delta, max_delta)
        p_new[3] = np.clip(p_new[3], -max_delta, max_delta)
        r_new = resid(p_new)
        cost_new = float(r_new @ r_new)
        if cost_new < cost:
            p, r, cost = p_new, r_new, cost_new
            lam = max(lam * 0.3, 1e-9)
            if float(np.abs(step).max()) < 1e-8:
                break
        else:
            lam = min(lam * 10.0, 1e6)
            if lam >= 1e6:
                break
    return p[:2].astype(np.float64), p[2:].astype(np.float64)


def harvest_transmission(psm_df: dict, max_obs: int = 2) -> dict | None:
    """Build (mu1, mu2, x, y) transmission observations from scored PSMs
    (a column dict).

    Uses the raw (pre-quadrupole-mask) per-observation fragment sums the
    scoring kernel emits (``obs_intensity_{o}`` with window bounds
    ``obs_win_lo/hi_{o}``).  For every candidate seen in >= 2 quad windows,
    each window's share of the total is a relative transmission sample at
    the precursor m/z; single-window candidates near the window center
    anchor the plateau at 1.
    """
    cols_needed = [f"obs_intensity_{o}" for o in range(max_obs)]
    if any(c not in psm_df for c in cols_needed):
        return None
    mz = np.asarray(psm_df["mz_library"], np.float64)
    obs_int = np.stack(
        [np.asarray(psm_df[f"obs_intensity_{o}"], np.float64) for o in range(max_obs)],
        axis=1,
    )
    lo = np.stack(
        [np.asarray(psm_df[f"obs_win_lo_{o}"], np.float64) for o in range(max_obs)],
        axis=1,
    )
    hi = np.stack(
        [np.asarray(psm_df[f"obs_win_hi_{o}"], np.float64) for o in range(max_obs)],
        axis=1,
    )
    valid = (lo < 1e6) & (obs_int >= 0)
    total = np.where(valid, obs_int, 0.0).sum(axis=1)
    n_obs = valid.sum(axis=1)
    keep_row = (total > 0) & (n_obs >= 1)

    # multi-window rows: fraction of summed signal per window ~ relative
    # transmission (both windows see the same elution profile)
    frac = np.where(valid, obs_int, 0.0) / np.maximum(total[:, None], 1e-12)
    multi = keep_row & (n_obs >= 2)
    m_sel = np.nonzero(valid & multi[:, None])
    # scale fractions so the dominant window reads ~1 (transmission is
    # relative; two half-transmitting windows sum to 1 in `frac`)
    peak = np.maximum(frac.max(axis=1), 1e-6)
    y_multi = (frac / peak[:, None])[m_sel]

    # single-window rows well inside the window: transmission 1 anchors
    margin = 0.25 * (hi[:, 0] - lo[:, 0])
    centered = (
        keep_row
        & (n_obs == 1)
        & valid[:, 0]
        & (mz > lo[:, 0] + margin)
        & (mz < hi[:, 0] - margin)
    )
    c_sel = np.nonzero(centered)[0]

    mu1 = np.concatenate([lo[m_sel], lo[c_sel, 0]])
    mu2 = np.concatenate([hi[m_sel], hi[c_sel, 0]])
    xx = np.concatenate([mz[m_sel[0]], mz[c_sel]])
    yy = np.concatenate([y_multi, np.ones(len(c_sel))])
    n_multi = int(len(y_multi))
    return {"mu1": mu1, "mu2": mu2, "x": xx, "y": np.clip(yy, 0.0, 1.0),
            "n_multi": n_multi}


@dataclass
class QuadrupoleCalibration:
    """Fitted transmission model handed to scoring: shared sigma and
    delta_mu over the cycle's windows."""

    sigma: np.ndarray = field(default_factory=lambda: np.array([0.2, 0.2]))
    delta_mu: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0]))
    n_samples: int = 0
    fitted: bool = False

    def predict(self, win_lo, win_hi, mz):
        return logistic_rectangle_np(
            np.asarray(win_lo) + self.delta_mu[0],
            np.asarray(win_hi) + self.delta_mu[1],
            self.sigma[0],
            self.sigma[1],
            np.asarray(mz),
        )

    def fit(self, mu1, mu2, x, y) -> "QuadrupoleCalibration":
        self.sigma, self.delta_mu = fit_quadrupole_params(
            mu1, mu2, x, y, sigma0=tuple(self.sigma), delta0=tuple(self.delta_mu)
        )
        self.n_samples = len(np.asarray(x))
        self.fitted = True
        return self

    def calibrated_cycle(self, cycle: np.ndarray, threshold: float = 0.01) -> np.ndarray:
        """Window bounds widened to the transmission ``threshold`` contour,
        on a grid, every window at once."""
        new_cycle = np.asarray(cycle, np.float64).copy()
        lo = new_cycle[..., 0]
        hi = new_cycle[..., 1]
        ms2 = lo >= 0  # MS1 slots are marked lo=-1 (same convention as
        # diadata.quad_mask / scoring is_ms2)
        if not ms2.any():
            return new_cycle
        span = float(hi[ms2].max() - lo[ms2].min())
        grid = np.linspace(
            float(lo[ms2].min()) - 0.1 * span,
            float(hi[ms2].max()) + 0.1 * span,
            2000,
        )
        t = logistic_rectangle_np(
            lo[ms2, None] + self.delta_mu[0],
            hi[ms2, None] + self.delta_mu[1],
            self.sigma[0],
            self.sigma[1],
            grid[None, :],
        )  # [n_windows, 2000]
        above = t > threshold
        any_above = above.any(axis=1)
        first = np.argmax(above, axis=1)
        last = above.shape[1] - 1 - np.argmax(above[:, ::-1], axis=1)
        new_lo = np.where(any_above, grid[first], lo[ms2])
        new_hi = np.where(any_above, grid[last], hi[ms2])
        out_lo = lo.copy()
        out_hi = hi.copy()
        out_lo[ms2] = new_lo
        out_hi[ms2] = new_hi
        new_cycle[..., 0] = out_lo
        new_cycle[..., 1] = out_hi
        return new_cycle
