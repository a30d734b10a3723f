"""Train and package the default FDR classifier warm start.

    python -m alphadia_torch.scripts.train_default_classifier [--out DIR] [--device cpu]

The classifier is trained on the PSMs of seven synthetic corpora spread over
acquisition and library regimes (window counts, noise levels, mass biases
and spreads, RT widths, detectability, intensity scales, one run with ion
mobility), so that it learns the structure of targets and decoys rather
than one corpus's offsets. Each corpus is searched on the device:
``CandidateSelection`` and ``CandidateScoring``, which launch the XIC
kernel on the card.

Packaging is gated on two held-out corpora with parameter combinations the
training sweep lacks: a first-iteration FDR fit warm-started from the new
state must find at least as many IDs at 1% FDR, summed over both, as one
started from a fresh classifier. Only then is the state written to
``DIR/<feature hash>.pkl`` (default: the port's
``constants/classifier``), in the state format both packages read
(``BinaryClassifier.to_state_dict``). Otherwise nothing is written and the
exit code is 1.

The corpora, the fits and the gate are those of the JAX package's
``scripts/train_default_classifier.py``; pandas' ``DataFrame.sample(n,
random_state=seed)`` is ``np.random.RandomState(seed).choice(len, n,
replace=False)`` here, so the subsets are the same rows.
"""

from __future__ import annotations

import argparse
import pickle
import sys
from pathlib import Path

import numpy as np

from alphadia_torch.fdr.fdr import perform_fdr
from alphadia_torch.models.classifier import BinaryClassifier
from alphadia_torch.rawdata import DiaData
from alphadia_torch.search.scoring import CandidateScoring, ScoringConfig
from alphadia_torch.search.selection import CandidateSelection, SelectionConfig
from alphadia_torch.testing.synthetic import SyntheticConfig, add_synthetic_decoys, make_synthetic_dia
from alphadia_torch.utils.device import resolve_device
from alphadia_torch.utils.frame import concat, n_rows
from alphadia_torch.workflow.managers.fdr_manager import CLASSIFIER_DIR, FDRManager
from alphadia_torch.workflow.peptidecentric.peptidecentric import FDR_FEATURE_COLUMNS

# training corpora: deliberately spread over acquisition/library regimes
TRAIN_CORPORA = [
    dict(seed=7, n_windows=8, n_cycles=500, noise_peaks_per_spectrum=300),
    dict(seed=17, n_windows=4, n_cycles=350, noise_peaks_per_spectrum=100,
         fwhm_rt=3.0, lib_rt_sigma=4.0),
    dict(seed=27, n_windows=16, n_cycles=700, noise_peaks_per_spectrum=500,
         fwhm_rt=12.0, lib_rt_sigma=20.0, cycle_time=2.5),
    dict(seed=37, n_windows=8, n_cycles=500, noise_peaks_per_spectrum=250,
         lib_ppm_bias=-6.0, peak_ppm_sigma=5.0),
    dict(seed=47, n_windows=12, n_cycles=450, noise_peaks_per_spectrum=400,
         detectable_fraction=0.5, base_intensity=2e3),
    dict(seed=57, n_windows=6, n_cycles=400, noise_peaks_per_spectrum=150,
         lib_ppm_bias=0.0, base_intensity=5e4, detectable_fraction=0.9),
    dict(seed=67, n_windows=8, n_cycles=500, noise_peaks_per_spectrum=300,
         with_mobility=True),
]

# held-out gate: parameter combos NOT in the training sweep
EVAL_CORPORA = [
    dict(seed=101, n_windows=10, n_cycles=550, noise_peaks_per_spectrum=350,
         fwhm_rt=8.0, lib_ppm_bias=2.5, detectable_fraction=0.7),
    dict(seed=113, n_windows=5, n_cycles=300, noise_peaks_per_spectrum=200,
         fwhm_rt=4.5, lib_ppm_bias=-3.0, peak_ppm_sigma=3.5,
         base_intensity=8e3),
]

N_PEPTIDES = 600
EPOCHS = 20


def _search(corpus: dict, n_peptides: int = N_PEPTIDES, device=None) -> dict:
    """The scored PSMs of one synthetic corpus with one decoy a target."""
    cfg = SyntheticConfig(n_peptides=n_peptides, **corpus)
    spectra, prec, frag = make_synthetic_dia(cfg)
    prec, frag = add_synthetic_decoys(prec, frag, seed=cfg.seed + 1)
    dia = DiaData.from_spectra(spectra)
    cands = CandidateSelection(
        dia, prec, frag,
        SelectionConfig(rt_tolerance=45.0, fragment_mz_tolerance=25.0, batch_size=1024),
        device=device,
    )()
    psm, _ = CandidateScoring(
        dia, prec, frag, ScoringConfig(fragment_mz_tolerance=25.0, batch_size=1024), device=device
    )(cands)
    return psm


def _sample(frame: dict, n: int, seed: int) -> dict:
    """pandas' ``frame.sample(n, random_state=seed).reset_index(drop=True)``."""
    rows = np.random.RandomState(seed).choice(n_rows(frame), n, replace=False)
    return {c: np.asarray(v)[rows] for c, v in frame.items()}


def _first_iteration_ids(psm: dict, warm_state: dict | None, seed: int, device=None, random_state: int = 0) -> int:
    """IDs at 1% FDR after ONE fit on a small first-optimization-style
    subset, warm-started from ``warm_state`` when given (as
    ``FDRManager._get_classifier`` + ``fit_predict``)."""
    rng = np.random.default_rng(seed)
    sub = _sample(psm, min(2500, n_rows(psm)), seed)
    if warm_state is not None:
        clf = BinaryClassifier.from_state_dict(warm_state, device)
        clf.random_state = random_state
    else:
        clf = BinaryClassifier(random_state=random_state, device=device)
    available = [c for c in FDR_FEATURE_COLUMNS if c in sub]
    out = perform_fdr(
        clf,
        available,
        {c: v[sub["decoy"] == 0] for c, v in sub.items()},
        {c: v[sub["decoy"] == 1] for c, v in sub.items()},
        competitive=True,
        random_state=int(rng.integers(0, 2**31)),
    )
    return int(((out["qval"] < 0.01) & (out["decoy"] == 0)).sum())


def train(out_dir: str | Path | None = None, device=None, n_peptides: int = N_PEPTIDES, epochs: int = EPOCHS,
          random_state: int = 0, write: bool = True) -> dict:
    """Search the corpora, fit, gate and (when the gate passes and
    ``write``) save. Returns the readings: ``n_psms``, ``n_decoys``,
    ``separation``, ``eval`` ({corpus seed: (warm, cold)}), ``gains``,
    ``passed``, ``path`` (None when nothing was written) and ``state``.
    ``n_peptides`` and ``epochs`` cut a run; their defaults are the
    packaged run's."""
    device = resolve_device(device)
    features = []
    for corpus in TRAIN_CORPORA:
        psm = _search(corpus, n_peptides, device)
        features.append(psm)
        print(f"corpus {corpus['seed']}: {n_rows(psm)} scored candidates", flush=True)

    df = concat(features)
    available = [c for c in FDR_FEATURE_COLUMNS if c in df]
    X = np.nan_to_num(np.stack([np.asarray(df[c]).astype(np.float32) for c in available], 1))
    y = np.asarray(df["decoy"]).astype(np.float32)
    clf = BinaryClassifier(random_state=random_state, epochs=epochs, device=device)
    clf.fit(X, y)
    proba = clf.predict_proba(X)[:, 1]
    sep = float(proba[y == 1].mean() - proba[y == 0].mean())
    print(f"trained on {len(X)} PSMs ({int(y.sum())} decoys); separation {sep:.3f}", flush=True)
    state = clf.to_state_dict()

    # held-out gate: warm start must not lose IDs on unseen corpora
    evals, gains = {}, []
    for corpus in EVAL_CORPORA:
        psm = _search(corpus, n_peptides, device)
        warm = _first_iteration_ids(psm, state, corpus["seed"], device, random_state)
        cold = _first_iteration_ids(psm, None, corpus["seed"], device, random_state)
        print(f"eval {corpus['seed']}: warm {warm} vs cold {cold} IDs @1% FDR", flush=True)
        evals[corpus["seed"]] = (warm, cold)
        gains.append(warm - cold)

    report = dict(n_psms=len(X), n_decoys=int(y.sum()), separation=sep, eval=evals, gains=gains,
                  passed=sum(gains) >= 0, path=None, state=state)
    if not report["passed"]:
        print("warm start LOSES IDs on held-out corpora — NOT packaging", flush=True)
        return report
    if write:
        feature_hash = FDRManager(FDR_FEATURE_COLUMNS, BinaryClassifier(device="cpu")).feature_hash()
        out = Path(out_dir if out_dir is not None else CLASSIFIER_DIR) / f"{feature_hash}.pkl"
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "wb") as f:
            pickle.dump(state, f)
        print(f"saved {out}", flush=True)
        report["path"] = out
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=CLASSIFIER_DIR, help="directory of <feature hash>.pkl")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    opt = ap.parse_args(argv)
    return 0 if train(opt.out, opt.device)["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
