"""The GUI's parameter schema, built from the port's default config.

Sections (in display order) hold parameters with ``id``, ``name``,
``default``, ``description`` and ``type``; the IO slots name the library,
the FASTA files, the raw files and the output directory. The values come
from ``config/default.json``; each description is the text of the comment
lines above the key in the JAX package's ``default.yaml`` (``section.key``
→ text, kept in ``descriptions.json``: the card machine has no yaml
package). The section ``tpu`` keeps its id, since the config reads
``tpu.*``, and is shown as "Engine".
"""

from __future__ import annotations

import json
from pathlib import Path

DEFAULT_JSON = Path(__file__).parents[1] / "config" / "default.json"
DESCRIPTIONS_JSON = Path(__file__).parent / "descriptions.json"

# sections shown in the GUI (in this order); the others stay CLI-only
SECTIONS = [
    ("general", "General"),
    ("tpu", "Engine"),
    ("library_prediction", "Library Prediction"),
    ("search", "Search"),
    ("calibration", "Calibration"),
    ("search_initial", "Initial Search Tolerances"),
    ("fdr", "False Discovery Rate"),
    ("search_output", "Search Output"),
    ("multiplexing", "Multiplexing"),
    ("library_multiplexing", "Library Multiplexing"),
    ("transfer_library", "Transfer Library"),
    ("transfer_learning", "Transfer Learning"),
]

_ADVANCED = {"tpu", "search_initial", "transfer_library", "transfer_learning"}

# a null default carries no type: without an entry here the page would
# send it back as a string (np.random.default_rng("42") raises)
_NULL_TYPES = {
    ("general", "random_state"): "integer",
    ("general", "profile_directory"): "string",
    ("tpu", "mesh_devices"): "integer",
    ("library_prediction", "peptdeep_model_path"): "string",
    ("optimization", "order_of_optimization"): "list",
}


def _type_of(v, section=None, key=None):
    if v is None:
        return _NULL_TYPES.get((section, key), "string")
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, int):
        return "integer"
    if isinstance(v, float):
        return "float"
    if isinstance(v, list):
        return "list"
    return "string"


def _title(key: str) -> str:
    return key.replace("_", " ").title().replace("Tpu", "TPU").replace(
        "Fdr", "FDR"
    ).replace("Mz", "m/z").replace("Ms1", "MS1").replace("Ms2", "MS2").replace(
        "Rt", "RT"
    )


def descriptions() -> dict[str, str]:
    """``section.key`` -> the description of that parameter."""
    return json.loads(DESCRIPTIONS_JSON.read_text())


def build_schema() -> dict:
    """The workflow schema: the IO slots and the config sections."""
    cfg = json.loads(DEFAULT_JSON.read_text())
    comments = descriptions()
    config_sections = []
    for sec_id, sec_name in SECTIONS:
        params = [
            {
                "id": key,
                "name": _title(key),
                "default": val,
                "description": comments.get(f"{sec_id}.{key}", ""),
                "type": _type_of(val, sec_id, key),
            }
            for key, val in (cfg.get(sec_id) or {}).items()
        ]
        config_sections.append(
            {
                "id": sec_id,
                "name": sec_name,
                "hidden": False,
                "advanced": sec_id in _ADVANCED,
                "parameters": params,
            }
        )
    return {
        "library": {"active": True, "required": False, "path": ""},
        "fasta_list": {"active": True, "required": False, "path": []},
        "raw_path_list": {"active": True, "required": True, "path": []},
        "output_directory": {"active": True, "required": True, "path": ""},
        "config": config_sections,
    }
