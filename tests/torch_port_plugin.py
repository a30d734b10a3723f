"""Collection hook of the port's tests (``tests/test_torch_*.py``), each of
which names this module in ``pytest_plugins``.

``tests/parity/conftest.py`` marks every collected item as skipped when the
reference checkout is absent. Its ``pytest_collection_modifyitems`` hook is
session-wide, so the mark meant for the parity directory also lands on the
port's tests, which need no reference checkout. The hook takes that one mark
off the port's tests again and leaves every other test as it was.

The suite runs in several worker processes at once; two intra-op threads a
worker keep PyTorch's CPU kernels from oversubscribing the cores.
"""

from __future__ import annotations

import pytest
import torch

torch.set_num_threads(2)

_PARITY_SKIP = "reference checkout not present"


@pytest.hookimpl(trylast=True)
def pytest_collection_modifyitems(items):
    for item in items:
        if not item.path.name.startswith("test_torch_"):
            continue
        item.own_markers[:] = [
            m
            for m in item.own_markers
            if not (m.name == "skip" and str(m.kwargs.get("reason", "")).startswith(_PARITY_SKIP))
        ]

