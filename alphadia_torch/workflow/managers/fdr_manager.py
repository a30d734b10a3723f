"""Versioned FDR classifier store.

One trained classifier per ``fit_predict`` call. ``version=-1`` trains a
new classifier warm-started from the latest one, else from the packaged
classifier of this feature set (``constants/classifier/<hash>.pkl``, the
hash the xxh64 of the sorted feature names), else from the base; a given
version scores without retraining. A fit that took a fallback estimator
(logistic regression, no decoys) stores nothing. Decoy strategies:
``precursor`` and ``precursor_channel_wise``.
"""

from __future__ import annotations

import logging
import pickle
from pathlib import Path

import numpy as np

from alphadia_torch.fdr.fdr import perform_fdr
from alphadia_torch.models.classifier import BinaryClassifier
from alphadia_torch.utils.frame import concat, take
from alphadia_torch.utils.hashing import xxh64_hexdigest
from alphadia_torch.workflow.managers.base import BaseManager

logger = logging.getLogger(__name__)

CLASSIFIER_DIR = Path(__file__).parents[2] / "constants" / "classifier"


class FDRManager(BaseManager):
    def __init__(
        self,
        feature_columns: list[str],
        classifier_base: BinaryClassifier | None = None,
        path=None,
        load_from_file=False,
        dia_cycle: np.ndarray | None = None,
        config=None,
        figure_path: str | None = None,
        random_state: int | None = None,
        device=None,
    ):
        super().__init__(path, load_from_file)
        if not self.is_loaded_from_file:
            # a load restored the store and its feature columns (the
            # classifiers' input width is tied to them)
            self.feature_columns = feature_columns
            self.classifier_base = classifier_base or BinaryClassifier(device=device)
            self.classifier_store: list[BinaryClassifier] = []
        # the run's context always comes from the constructor
        self.dia_cycle = dia_cycle
        self.config = config
        self.figure_path = figure_path
        self._rng = np.random.default_rng(random_state)

    @property
    def current_version(self) -> int:
        return len(self.classifier_store) - 1

    @property
    def device(self):
        return self.classifier_base.device

    def fit_predict(
        self,
        features: dict,
        decoy_strategy: str = "precursor",
        competitive: bool = True,
        df_fragments: dict | None = None,
        version: int = -1,
    ) -> dict:
        available = [c for c in self.feature_columns if c in features]
        classifier = self._get_classifier(version)

        def split(df):
            return take(df, df["decoy"] == 0), take(df, df["decoy"] == 1)

        if decoy_strategy == "precursor_channel_wise":
            # one classifier over all channels, q-values per channel
            pieces = []
            for channel in np.unique(features["channel"]):
                target, decoy = split(take(features, features["channel"] == channel))
                pieces.append(
                    perform_fdr(
                        classifier, available, target, decoy,
                        competitive=competitive, group_channels=False,
                        df_fragments=df_fragments, dia_cycle=self.dia_cycle,
                        random_state=int(self._rng.integers(0, 2**31)),
                    )
                )
            psm = concat(pieces)
        elif decoy_strategy == "precursor":
            target, decoy = split(features)
            psm = perform_fdr(
                classifier, available, target, decoy,
                competitive=competitive, group_channels=True,
                df_fragments=df_fragments, dia_cycle=self.dia_cycle,
                random_state=int(self._rng.integers(0, 2**31)),
                figure_path=self.figure_path,
            )
        else:
            raise NotImplementedError(f"decoy strategy {decoy_strategy}")

        if version == -1:
            if classifier.fitted:
                self.classifier_store.append(classifier)
                logger.info("FDR classifier version %d trained", self.current_version)
            else:
                # a fallback estimator ranked the PSMs and the network was
                # never fitted: storing it would break predict()
                logger.info("FDR used a fallback estimator; classifier store stays at version %d", self.current_version)
        return psm

    def _get_classifier(self, version: int) -> BinaryClassifier:
        if 0 <= version < len(self.classifier_store):
            return self.classifier_store[version]
        if self.classifier_store and self.classifier_store[-1].fitted:
            return BinaryClassifier.from_state_dict(self.classifier_store[-1].to_state_dict(), self.device)
        packaged = self._load_packaged_classifier()
        if packaged is not None:
            return packaged
        return BinaryClassifier.from_state_dict(self.classifier_base.to_state_dict(), self.device)

    def feature_hash(self) -> str:
        return xxh64_hexdigest("|".join(sorted(self.feature_columns)))

    def _load_packaged_classifier(self) -> BinaryClassifier | None:
        path = CLASSIFIER_DIR / f"{self.feature_hash()}.pkl"
        if not path.exists():
            return None
        try:
            with open(path, "rb") as f:
                clf = BinaryClassifier.from_state_dict(pickle.load(f), self.device)
        except Exception as e:
            logger.warning("could not load packaged classifier: %s", e)
            return None
        # the run's hyperparameters, the packaged weights
        base = self.classifier_base
        clf.test_size = base.test_size
        clf.epochs = base.epochs
        clf.experimental_hyperparameter_tuning = base.experimental_hyperparameter_tuning
        clf.random_state = base.random_state
        logger.info("warm-starting FDR classifier from %s", path.name)
        return clf

    def predict(self, features: dict, version: int = -1) -> dict:
        """Score with a stored classifier without retraining."""
        if not self.classifier_store:
            raise RuntimeError("no trained FDR classifier available yet (all fits so far used fallback estimators)")
        clf = self.classifier_store[version]
        available = [c for c in self.feature_columns if c in features]
        X = np.stack([features[c].astype(np.float32) for c in available], 1)
        out = dict(features)
        out["proba"] = clf.predict_proba(X)[:, 1]
        return out
