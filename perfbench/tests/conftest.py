"""The benchmark's CPU tests: the repository's root on the path, and a tiny
benchmark root (``tiny.make_root``) for each test that runs a cell."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import tiny  # noqa: E402


@pytest.fixture
def tiny_root(tmp_path):
    return tiny.make_root(tmp_path)
