"""prove_bench's own tests (run from the repository root:
`python -m pytest prove_bench/tests -q`; the card's with
`python -m pytest prove_bench/tests -q -m cuda` on the card). JAX-free."""

import os

import pytest

os.environ.setdefault("OMP_NUM_THREADS", "4")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def _own_cache_home(tmp_path, monkeypatch):
    """Keep the key cache (LURK_DIR) of every run in the test's directory."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.setenv("LURK_DIR", str(tmp_path / "cache" / "lurk"))
