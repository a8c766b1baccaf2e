"""The package's former name imports as an alias of ``imagestitching``:
the same module objects, and ``python -m`` runs the same entry point."""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

import imagestitching

REPO = Path(__file__).resolve().parent.parent
# every other package shipped under pyproject's "imagestitching*" pattern
ALIASES = sorted(d.name for d in REPO.iterdir()
                 if d.name.startswith("imagestitching_")
                 and (d / "__init__.py").is_file())


def test_one_alias_package():
    assert len(ALIASES) == 1


@pytest.mark.parametrize("sub", ["", ".api", ".config", ".core.layout",
                                 ".serve.server", ".parallel.batch"])
def test_alias_yields_the_same_module(sub):
    real = importlib.import_module("imagestitching" + sub)
    alias = importlib.import_module(ALIASES[0] + sub)
    if sub:
        assert alias is real
    else:
        assert alias.StitchOptions is imagestitching.StitchOptions
        assert alias.stitch_arrays is imagestitching.stitch_arrays


def test_alias_of_a_missing_module_raises():
    with pytest.raises(ModuleNotFoundError):
        importlib.import_module(ALIASES[0] + ".no_such_module")


def test_alias_runs_the_cli_with_dash_m():
    r = subprocess.run([sys.executable, "-m", ALIASES[0] + ".cli", "--help"],
                       cwd=REPO, capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("usage: imagestitching")
