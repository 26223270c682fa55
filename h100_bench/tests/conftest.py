"""Fixtures of the benchmark's CPU tests: a tiny copy of the benchmark."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from h100_bench.tests.tiny import make_root  # noqa: E402


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
