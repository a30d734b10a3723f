"""Peptide property prediction for library-free search.

    lib = SimplePrediction()(digest_fasta(["db.fasta"]))  # on the card

Fills a digested library's ``rt_norm``, ``mobility`` and fragment
intensity matrix (computing the fragment m/z first where it lacks them):

- with a model directory (the packaged weights, or a transfer step's
  ``peptdeep_model_path``): the property models of
  ``models/property_models.py`` through ``models/finetune.FinetuneManager``;
- without one, heuristic baselines: an additive hydrophobicity RT
  (Krokhin-style retention coefficients, min-max normalised), mobility 0,
  and a smooth b/y intensity prior (y above b, maxima mid-series).

With ``predict_charge`` the charge model drops enumerated charge states it
deems improbable, never a peptide's most probable one. The JAX package's
``models/prediction.py`` on column dicts.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from alphadia_torch.library.pipeline import ProcessingStep
from alphadia_torch.library.speclib import SpecLibBase, str_col
from alphadia_torch.reporting import PROGRESS
from alphadia_torch.utils.frame import n_rows, take

logger = logging.getLogger(__name__)

PACKAGED_MODELS = Path(__file__).parents[1] / "constants" / "weights" / "peptdeep_default"

# Krokhin et al. 2004-style retention coefficients (arbitrary units)
RT_COEFF = {
    "W": 11.0, "F": 10.5, "L": 9.6, "I": 8.4, "M": 5.8, "V": 5.0,
    "Y": 4.0, "A": 0.8, "T": 0.4, "P": 0.2, "E": 0.0, "D": -0.5,
    "C": -0.8, "S": -0.8, "Q": -0.9, "G": -0.9, "N": -1.2, "R": -1.3,
    "H": -1.3, "K": -1.9, "U": -0.8,
}


def predict_rt_norm(sequences) -> np.ndarray:
    """Additive hydrophobicity score, min-max normalised to [0, 1]."""
    lut = np.zeros(128, dtype=np.float64)
    for aa, c in RT_COEFF.items():
        lut[ord(aa)] = c
    scores = np.empty(len(sequences), dtype=np.float64)
    for i, s in enumerate(sequences):
        arr = np.frombuffer(s.encode(), dtype=np.uint8)
        h = lut[arr].sum()
        # N-terminal residues contribute less (SSRCalc heuristic)
        h -= 0.5 * lut[arr[:3]].sum() * 0.3
        # length damping for long peptides
        if len(s) > 20:
            h *= 1.0 - 0.01 * (len(s) - 20)
        scores[i] = h
    lo, hi = np.percentile(scores, [1, 99])
    return np.clip((scores - lo) / max(hi - lo, 1e-9), 0.0, 1.0).astype(np.float32)


def predict_ms2_prior(naa: int, n_cols: int, col_names: list[str]) -> np.ndarray:
    """Heuristic intensity prior for one precursor's fragment matrix."""
    n_sites = naa - 1
    out = np.zeros((n_sites, n_cols), dtype=np.float32)
    pos = np.arange(n_sites, dtype=np.float32)
    # mid-series hump
    hump = np.exp(-0.5 * ((pos - n_sites / 2) / max(n_sites / 3, 1)) ** 2)
    for j, c in enumerate(col_names):
        t = c.split("_z")[0]
        z = int(c.split("_z")[1])
        series_w = 1.0 if t == "y" else 0.6 if t == "b" else 0.3
        charge_w = 1.0 if z == 1 else 0.35
        # y ions numbered from the C-terminus: weight by fragment length
        frac = (pos + 1) / naa if t in "abc" else 1.0 - (pos + 1) / naa
        out[:, j] = series_w * charge_w * (0.25 + 0.75 * hump) * (0.3 + 0.7 * frac)
    m = out.max()
    return out / m if m > 0 else out


def group_max(keys: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Each row's largest value among the rows of its key, as pandas'
    ``Series(values).groupby(keys).transform("max")``."""
    uniq, inverse = np.unique(keys, return_inverse=True)
    best = np.full(len(uniq), -np.inf, dtype=np.float64)
    np.maximum.at(best, inverse, values.astype(np.float64))
    return best[inverse].astype(values.dtype)


class SimplePrediction(ProcessingStep):
    """Fill RT and mobility predictions and the fragment intensity matrix.

    With ``model_path`` (a transfer step's model directory) or the packaged
    weights, the property models run on ``device`` (the card unless the
    caller asks for the CPU); without ``models.pkl`` there, the heuristic
    baselines fill the columns.
    """

    def __init__(
        self,
        fragment_types=("b", "y"),
        max_fragment_charge: int = 2,
        model_path: str | None = None,
        predict_charge: bool = False,
        min_charge_probability: float = 0.1,
        nce: float = 25.0,
        instrument: str = "Lumos",
        model_type: str = "generic",
        device=None,
    ):
        self.fragment_types = tuple(fragment_types)
        self.max_fragment_charge = max_fragment_charge
        self.model_path = model_path
        self.predict_charge = predict_charge
        self.min_charge_probability = min_charge_probability
        self.nce = nce
        self.instrument = instrument
        self.device = device
        if model_type not in ("generic",):
            logger.warning(f"peptdeep_model_type '{model_type}' is not packaged; using 'generic'")
        self.model_type = "generic"

    def validate(self, input_) -> bool:
        return isinstance(input_, SpecLibBase)

    def _load_manager(self):
        path = self.model_path or PACKAGED_MODELS
        if not (Path(path) / "models.pkl").exists():
            return None
        from alphadia_torch.models.finetune import FinetuneManager

        which = "fine-tuned" if self.model_path else "packaged pretrained"
        logger.log(PROGRESS, f"Using {which} prediction models from {path}")
        return FinetuneManager.load(path, device=self.device)

    def forward(self, lib: SpecLibBase) -> SpecLibBase:
        df = lib.precursor_df
        manager = self._load_manager()

        # charge-state filtering (library_prediction.predict_charge): drop
        # enumerated charges the model deems improbable, never a peptide's
        # most probable enumerated charge
        if self.predict_charge and lib.fragment_mz is not None:
            logger.warning(
                "library_prediction.predict_charge ignored: the library "
                "already carries fragment matrices, and dropping charge "
                "states would desynchronize the fragment rows"
            )
        if self.predict_charge and lib.fragment_mz is None and manager is not None and "charge" in manager.variables:
            n = n_rows(df)
            probs = manager.predict_charge(list(df["sequence"]), list(str_col(df, "mods")), list(str_col(df, "mod_sites")))
            z = df["charge"].astype(np.int32)
            p_own = probs[np.arange(n), np.clip(z - 1, 0, probs.shape[1] - 1)]
            mods = df["mods"].astype(str) if "mods" in df else np.full(n, "", dtype=object)
            keys = np.char.add(np.char.add(df["sequence"].astype(str), "|"), mods.astype(str))
            best = group_max(keys, p_own)
            keep = (p_own >= self.min_charge_probability) | (p_own >= best)
            if (~keep).any():
                logger.info(
                    f"charge prediction: dropped {int((~keep).sum())}/{n} improbable charge states "
                    f"(p < {self.min_charge_probability})"
                )
            lib.precursor_df = df = take(df, keep)

        sequences = list(df["sequence"])
        mods, mod_sites = list(str_col(df, "mods")), list(str_col(df, "mod_sites"))
        if manager is not None and "rt" in manager.variables:
            df["rt_norm"] = manager.predict_rt(sequences, mods, mod_sites).astype(np.float32)
        else:
            df["rt_norm"] = predict_rt_norm(sequences)
        if manager is not None and "ccs" in manager.variables:
            df["mobility"] = manager.predict_mobility(
                sequences, mods, mod_sites, df["charge"].astype(np.int32)
            ).astype(np.float32)
        elif "mobility" not in df:
            df["mobility"] = np.zeros(n_rows(df), np.float32)
        if lib.fragment_mz is None:
            lib.calc_fragment_mz(max_charge=self.max_fragment_charge, types=self.fragment_types)
        cols = lib.charged_frag_types
        inten = np.zeros((len(lib.fragment_mz), len(cols)), dtype=np.float32)
        if manager is not None and "ms2" in manager.variables:
            from alphadia_torch.models.property_models import FRAG_COLS, MAX_LEN

            # the packaged MS2 model conditions on NCE; the instrument is
            # recorded, the generic model is instrument-agnostic
            logger.info(f"MS2 prediction: nce={self.nce} instrument={self.instrument} model={self.model_type}")
            pred = manager.predict_ms2(
                sequences, mods, mod_sites, df["charge"].astype(np.int32), nce=self.nce
            )  # [n, MAX_LEN - 1, len(FRAG_COLS)]
            col_src = [FRAG_COLS.index(c) if c in FRAG_COLS else -1 for c in cols]
            # scatter pred[i, :n_sites] into each precursor's fragment rows
            naa_arr = df["nAA"].astype(np.int64)
            a_arr = df["frag_start_idx"].astype(np.int64)
            b_arr = df["frag_stop_idx"].astype(np.int64)
            ns = np.maximum(np.minimum(np.minimum(naa_arr - 1, MAX_LEN - 1), b_arr - a_arr), 0)
            prec_of = np.repeat(np.arange(len(ns)), ns)
            cum = np.zeros(len(ns) + 1, np.int64)
            np.cumsum(ns, out=cum[1:])
            off = np.arange(int(cum[-1])) - np.repeat(cum[:-1], ns)
            rowpos = a_arr[prec_of] + off
            for j, src in enumerate(col_src):
                if src >= 0:
                    inten[rowpos, j] = pred[prec_of, off, src]
        else:
            for naa, a, b in zip(df["nAA"], df["frag_start_idx"], df["frag_stop_idx"]):
                inten[a:b] = predict_ms2_prior(int(naa), len(cols), cols)
        lib.fragment_intensity = inten
        return lib
