"""Test harness: force an 8-device virtual CPU mesh before JAX is used.

The tests run on the CPU; the sharded paths are validated on a virtual CPU
mesh (SURVEY.md §4(5)).  The GPU path is checked by ``chip_smoke.py``, run
on the card.

``XLA_FLAGS`` is read at CPU-client creation, which is lazy, so setting it
here is early enough; ``jax.config.update`` also covers a JAX that was
imported before this file.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _isolated_bench_fixture_dir(tmp_path_factory, monkeypatch):
    """Keep bench.py's content-keyed fixture cache out of ~/.cache during
    tests: any test that reaches bench._fixture_paths without setting
    BENCH_FIXTURE_DIR would otherwise persist JPEG fixture dirs across
    runs, breaking test isolation (r4 review)."""
    if "BENCH_FIXTURE_DIR" not in os.environ:
        monkeypatch.setenv(
            "BENCH_FIXTURE_DIR",
            str(tmp_path_factory.getbasetemp() / "bench_fixtures"))


def pytest_sessionstart(session):
    del session
    n = len(jax.devices())
    assert jax.devices()[0].platform == "cpu", (
        "tests must run on the virtual CPU mesh, got "
        f"{jax.devices()[0].platform}")
    assert n == 8, f"expected 8 virtual CPU devices, got {n}"
