"""Layered configuration.

- A ``Config`` is a nested dict initialised from the packaged defaults,
  ``default.json`` (the JAX package's ``default.yaml`` as JSON: the port
  does not depend on yaml, and one user config loads in both packages).
- Later layers (user file, command line, multistep extras) are applied in
  order with ``update_layer``. A layer may never add a key that the
  defaults lack (``KeyAddedConfigError``) and never change a value's type
  (``TypeMismatchConfigError``); int to float and assignments to or from
  None are allowed. Removed keys in ``TOLERATED_KEYS`` are logged and
  ignored.
- Each layer is remembered by name, so the effective config prints with
  its provenance.
- ``to_yaml`` freezes the effective config (``frozen_config.yaml``) through
  the emitter of ``yaml_subset``; ``yaml.safe_load`` reads it back equal.
"""

from __future__ import annotations

import copy
import json
import logging
from collections import UserDict
from pathlib import Path
from typing import Any

from alphadia_torch.config import yaml_subset
from alphadia_torch.exceptions import KeyAddedConfigError, TypeMismatchConfigError

logger = logging.getLogger(__name__)

DEFAULT_CONFIG_PATH = Path(__file__).parent / "default.json"

# removed config keys still tolerated in user files (logged and ignored),
# so that old configs keep loading
TOLERATED_KEYS = {
    "general.astral_ms1",
    "general.mmap_detector_events",
    "fdr.enable_two_step_classifier",
    "fdr.two_step_classifier_max_iterations",
    "scoring_config",
    "selection_config",
    "tpu.cycle_pad",
    "general.use_gpu",
    "search.extraction_backend",
}


def _compatible(old: Any, new: Any) -> bool:
    """True when ``new`` may replace ``old`` without a type change."""
    if old is None or new is None:
        return True
    if isinstance(old, bool) or isinstance(new, bool):
        return isinstance(old, bool) and isinstance(new, bool)
    if isinstance(old, (int, float)) and isinstance(new, (int, float)):
        return True
    return type(old) is type(new)


def _deep_update(base: dict, patch: dict, source: str, path: str = "") -> list[tuple[str, Any, Any]]:
    """Apply ``patch`` onto ``base`` in place; returns (dotted key, old,
    new) of each changed value. Raises on unknown keys and type changes."""
    changes: list[tuple[str, Any, Any]] = []
    for key, new_val in patch.items():
        dotted = f"{path}.{key}" if path else str(key)
        if key not in base:
            if dotted in TOLERATED_KEYS:
                logger.warning("config key '%s' was removed and is ignored (from %s)", dotted, source)
                continue
            raise KeyAddedConfigError(dotted, source)
        old_val = base[key]
        if isinstance(old_val, dict) and isinstance(new_val, dict):
            changes += _deep_update(old_val, new_val, source, dotted)
        elif isinstance(old_val, dict) != isinstance(new_val, dict):
            raise TypeMismatchConfigError(dotted, type(old_val), new_val, source)
        else:
            if not _compatible(old_val, new_val):
                raise TypeMismatchConfigError(dotted, type(old_val), new_val, source)
            if old_val != new_val:
                changes.append((dotted, copy.deepcopy(old_val), copy.deepcopy(new_val)))
            base[key] = copy.deepcopy(new_val)
    return changes


class Config(UserDict):
    """Nested configuration with strict layered updates and provenance."""

    def __init__(self, data: dict | None = None, name: str = "default"):
        super().__init__(copy.deepcopy(data) if data else {})
        self.name = name
        # provenance: (layer name, [(key, old, new), ...]) per layer
        self.layers: list[tuple[str, list[tuple[str, Any, Any]]]] = []

    @classmethod
    def from_json_file(cls, path: str | Path, name: str | None = None) -> "Config":
        path = Path(path)
        return cls(json.loads(path.read_text()) or {}, name=name or path.stem)

    @classmethod
    def from_json(cls, text: str, name: str = "json") -> "Config":
        return cls(json.loads(text), name=name)

    def to_yaml(self, path: str | Path) -> None:
        Path(path).write_text(yaml_subset.dump(self.data), encoding="utf-8")

    def update_layer(self, patch: dict | "Config", name: str = "update") -> None:
        """Apply one configuration layer; strict keys and types."""
        if isinstance(patch, Config):
            name = patch.name if name == "update" else name
            patch = patch.data
        changes = _deep_update(self.data, patch, name)
        self.layers.append((name, changes))

    def update_layers(self, patches: list[tuple[str, dict]]) -> None:
        for name, patch in patches:
            if patch:
                self.update_layer(patch, name)

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self.data
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, dotted: str, value: Any) -> None:
        """Set an existing key (raises for a key the defaults lack)."""
        parts = dotted.split(".")
        node = self.data
        for part in parts[:-1]:
            node = node[part]
        if parts[-1] not in node:
            raise KeyAddedConfigError(dotted, "set_path")
        node[parts[-1]] = value

    def modified_summary(self) -> str:
        lines = [
            f"  [{layer_name}] {key}: {old!r} -> {new!r}"
            for layer_name, changes in self.layers
            for key, old, new in changes
        ]
        return "\n".join(lines) if lines else "  (defaults)"


def load_default_config() -> Config:
    """The packaged default configuration, stamped with the version."""
    from alphadia_torch import __version__

    cfg = Config.from_json_file(DEFAULT_CONFIG_PATH, name="default")
    cfg["version"] = __version__
    return cfg
