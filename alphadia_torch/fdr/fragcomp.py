"""Fragment competition: a PSM that shares fragments with a better PSM of
the same DIA window loses.

- Each PSM gets the index of the quadrupole window that holds its observed
  precursor m/z (``mz_observed``, else ``mz_library``); a PSM in no window
  competes with nothing;
- within a window, by confidence (``proba`` ascending, then
  ``precursor_idx``, a stable sort), a PSM j is invalidated when a better,
  still valid PSM i within ``rt_tol_seconds`` shares at least 3 fragments
  within ``mass_tol_ppm``;
- PSMs and fragments meet through the (precursor_idx, rank) candidate hash.

Host numpy, as in the JAX package: per window, an RT-sorted sliding
neighbourhood. The survivors come back in the order of the frame's row
index: the ``_row`` column where the frame has one (the pandas index that
the JAX package sorts by), else the frame's own order.
"""

from __future__ import annotations

import logging

import numpy as np

from alphadia_torch.utils.frame import lexsort_rows, n_rows
from alphadia_torch.utils.misc import candidate_hash

logger = logging.getLogger(__name__)

ROW = "_row"


class FragmentCompetition:
    def __init__(self, rt_tol_seconds: float = 3.0, mass_tol_ppm: float = 15.0):
        self.rt_tol_seconds = rt_tol_seconds
        self.mass_tol_ppm = mass_tol_ppm

    @staticmethod
    def _window_idx(psm: dict, cycle: np.ndarray) -> np.ndarray:
        if "window_idx" in psm:
            return psm["window_idx"]
        lower = cycle[0, :, 0, 0]
        upper = cycle[0, :, 0, 1]
        col = "mz_observed" if "mz_observed" in psm else "mz_library"
        mz = psm[col][:, None]
        inside = (mz >= lower[None, :]) & (mz < upper[None, :]) & (lower[None, :] >= 0)
        # a PSM in no isolation window competes with nothing (argmax over an
        # all-False row would put it into window 0)
        widx = np.argmax(inside, axis=1)
        widx[~inside.any(axis=1)] = -1
        return widx

    def __call__(self, psm: dict, frag: dict, cycle: np.ndarray) -> dict:
        if n_rows(psm) == 0 or n_rows(frag) == 0:
            return psm
        n = n_rows(psm)
        index = psm[ROW] if ROW in psm else np.arange(n)
        hashes_in = candidate_hash(psm["precursor_idx"], psm["rank"])
        frag_hash = candidate_hash(frag["precursor_idx"], frag["rank"])

        # fragment slice of each candidate
        order = np.argsort(frag_hash, kind="stable")
        frag_mz_sorted = frag["mz"][order]
        uniq, start = np.unique(frag_hash[order], return_index=True)
        stop = np.append(start[1:], len(order))
        slice_of = {h: (a, b) for h, a, b in zip(uniq.tolist(), start.tolist(), stop.tolist())}

        widx = self._window_idx(psm, cycle)
        by = lexsort_rows({"w": widx, "p": psm["proba"], "i": psm["precursor_idx"]}, ["w", "p", "i"])
        rt = psm["rt_observed"][by]
        win = widx[by]
        hashes = hashes_in[by]
        valid = np.ones(n, dtype=bool)
        for w in np.unique(win):
            if w < 0:
                continue
            idx = np.nonzero(win == w)[0]
            self._compete_window(idx, rt, hashes, slice_of, frag_mz_sorted, valid)

        n_removed = int((~valid).sum())
        if n_removed:
            logger.info("Fragment competition removed %d PSMs", n_removed)
        kept = by[valid]
        kept = kept[np.argsort(index[kept], kind="stable")]
        return {k: v[kept] for k, v in psm.items() if k != "window_idx"}

    def _compete_window(self, idx, rt, hashes, slice_of, frag_mz, valid):
        """``idx`` in confidence order within the window (best first); the
        inner scan covers the RT-sorted +-rt_tol neighbourhood."""
        n = len(idx)
        rt_w = rt[idx]
        rt_order = np.argsort(rt_w, kind="stable")
        rt_sorted = rt_w[rt_order]
        rt_pos = np.argsort(rt_order, kind="stable")
        for a in range(n):
            i = idx[a]
            if not valid[i]:
                continue
            si = slice_of.get(int(hashes[i]))
            if si is None:
                continue
            mz_i = frag_mz[si[0] : si[1]]
            p = rt_pos[a]
            # strictly |delta rt| < tol
            lo = np.searchsorted(rt_sorted, rt_sorted[p] - self.rt_tol_seconds, "right")
            hi = np.searchsorted(rt_sorted, rt_sorted[p] + self.rt_tol_seconds, "left")
            for q in range(lo, hi):
                b = rt_order[q]
                if b <= a:  # only worse PSMs can be invalidated
                    continue
                j = idx[b]
                if not valid[j]:
                    continue
                sj = slice_of.get(int(hashes[j]))
                if sj is None:
                    continue
                mz_j = frag_mz[sj[0] : sj[1]]
                d = np.abs(mz_i[:, None] - mz_j[None, :]) / mz_i[:, None] * 1e6
                if int((d < self.mass_tol_ppm).sum()) >= 3:
                    valid[j] = False
