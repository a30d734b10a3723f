"""Manager persistence: pickle save and load with a version check."""

from __future__ import annotations

import logging
import pickle
from pathlib import Path

from alphadia_torch import __version__

logger = logging.getLogger(__name__)


class BaseManager:
    def __init__(self, path: str | Path | None = None, load_from_file: bool = False):
        self.path = str(path) if path is not None else None
        self._version = __version__
        self.is_loaded_from_file = False
        if load_from_file and self.path:
            self.load()

    def save(self) -> None:
        if not self.path:
            return
        Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "wb") as f:
            pickle.dump(self, f)

    def load(self) -> None:
        if not self.path or not Path(self.path).exists():
            return
        try:
            with open(self.path, "rb") as f:
                loaded = pickle.load(f)
        except Exception as e:
            logger.warning("could not load manager from %s: %s", self.path, e)
            return
        if getattr(loaded, "_version", None) != self._version:
            logger.warning(
                "manager at %s was saved with version %s, not reusing", self.path, getattr(loaded, "_version", "?")
            )
            return
        state = dict(loaded.__dict__)
        state.pop("path", None)
        self.__dict__.update(state)
        self.is_loaded_from_file = True
