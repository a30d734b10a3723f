from alphadia_torch.validation.base import Optional, Required, Schema
from alphadia_torch.validation.schemas import (
    candidates_schema,
    fragments_flat_schema,
    precursors_flat_schema,
)

__all__ = [
    "Optional",
    "Required",
    "Schema",
    "candidates_schema",
    "fragments_flat_schema",
    "precursors_flat_schema",
]
