"""chip_smoke.py off the card: it refuses to run, and each of its phases
runs here at a tiny size (the card runs them at the BASELINE sizes)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from benchmarks import peaks
from imagestitching.config import StitchOptions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_sizes() -> chip_smoke.Sizes:
    cfg3 = ([(48, 32, 1), (32, 48, 6), (40, 30, 3), (36, 36, 8),
             (50, 40, 1), (44, 52, 5)],
            StitchOptions(mode="min", gap=4, supersample=False))
    mixed = ([(64, 48, 1), (56, 42, 1), (48, 64, 1), (60, 40, 1)],
             StitchOptions(mode="min", supersample=False))
    serve = ([(48, 32, 1), (48, 32, 1), (40, 24, 1)],
             StitchOptions(mode="min", gap=4, supersample=False))
    return chip_smoke.Sizes(
        compile_job=cfg3,
        ladder_jobs=[("cfg3", *cfg3), ("mixed", *mixed)],
        blit_job=([(40, 30, 1)] * 3, StitchOptions(supersample=False)),
        e2e_sizes=[(64, 48), (56, 42), (48, 64)],
        serve_job=serve, serve_batch=8,
        other_job=([(32, 32, 1)], StitchOptions(mode="max",
                                                supersample=False)),
        n_other=2,
        merge_width=40, merge_heights=[120, 100, 110],
        merge_overlaps=[40, 45],
        kernel_jobs=[("cfg3", *cfg3, 1), ("serve", *serve, 2)],
        space_job=mixed)


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          env=env, timeout=300)


@pytest.mark.parametrize("args", [[], ["--four-cards"]])
def test_refuses_to_run_without_a_gpu(args):
    r = _run(args, REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run([], str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("name", ["setup", "compile", "ladder", "e2e",
                                  "serve", "merge", "jobs-mesh",
                                  "space-mesh"])
def test_phase_runs_tiny_on_cpu(name):
    fn = dict(chip_smoke.PHASES + chip_smoke.FOUR_CARD_PHASES)[name]
    msg = fn(tiny_sizes(), 3)
    assert isinstance(msg, str) and msg
    assert "FAILED" not in msg


def test_kernel_phase_refuses_a_device_without_a_peak():
    with pytest.raises(KeyError, match="no published peak"):
        chip_smoke.phase_kernel(tiny_sizes(), 0)


def test_run_phases_reports_failures(capsys):
    def boom(sizes, seed):
        raise AssertionError("parity 7")

    failed = chip_smoke.run_phases(
        [("fine", lambda s, seed: "ok"), ("broken", boom)], tiny_sizes(), 0)
    out = capsys.readouterr().out
    assert failed == ["broken"]
    assert "phase 1 fine: ok" in out
    assert "phase 2 broken: FAILED" in out and "parity 7" in out


def test_peak_table():
    h100 = peaks.peak("NVIDIA H100 80GB HBM3")
    assert h100["hbm_bytes_per_s"] == 3.35e12 and "data sheet" in h100["source"]
    assert peaks.bandwidth_share("NVIDIA H100 80GB HBM3", 3.35e9, 2e-3) \
        == pytest.approx(0.5)
    with pytest.raises(KeyError):
        peaks.peak("cpu")


@pytest.mark.parametrize("strategy", ["resident", "streamed", "banded"])
def test_budget_for_picks_the_strategy(strategy):
    from imagestitching.runtime import tiler
    shapes, options = tiny_sizes().ladder_jobs[1][1:]
    plan = chip_smoke._plan(shapes, options)
    budget = chip_smoke.budget_for(strategy, plan)
    assert tiler.plan_execution(plan, budget).strategy == strategy


def test_sampled_parity_sees_a_wrong_band():
    from imagestitching.core import oracle
    shapes, options = tiny_sizes().ladder_jobs[1][1:]
    rng = np.random.default_rng(0)
    imgs = chip_smoke._images(rng, shapes)
    plan = chip_smoke._plan(shapes, options)
    good = oracle.stitch(plan, imgs)
    assert chip_smoke.sampled_parity(plan, imgs, good) == 0
    bad = good.copy()
    bad[-1] ^= 0x40                       # the bottom band is sampled
    assert chip_smoke.sampled_parity(plan, imgs, bad) >= 64


@pytest.mark.parametrize("peaks, ok", [
    ([5194.0, 1345.0, 1345.0, 1345.0], False),   # whole batch on device 0
    ([1402.0, 1345.0, 1345.0, 1345.0], True),
    (None, True),                                # the CPU keeps no stats
])
def test_check_spread_catches_a_heavy_device_0(peaks, ok):
    if ok:
        chip_smoke.check_spread(peaks, "batch")
    else:
        with pytest.raises(AssertionError, match="device 0 peaked"):
            chip_smoke.check_spread(peaks, "batch")


@pytest.mark.parametrize("peaks, ok", [
    ([2104.0, 2104.0, 2104.0, 2104.0], False),   # a gathered warm-up canvas
    ([1028.0, 1028.0, 1028.0, 1028.0], True),
    (None, True),
])
def test_check_model_catches_a_peak_above_the_byte_model(peaks, ok):
    if ok:
        chip_smoke.check_model(peaks, 1264.0, "batch")
    else:
        with pytest.raises(AssertionError, match="above the byte model"):
            chip_smoke.check_model(peaks, 1264.0, "batch")
