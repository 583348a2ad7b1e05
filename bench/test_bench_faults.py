"""A run of each cell, the look for a card skipped and the sizes cut for
the CPU, comes out correct; and with its timed path broken underneath by
each fault the cell can have, it comes out not correct."""

import json
import os
import subprocess
import sys
import time

import pytest

from bench import run
from bench.drivers import fft_dist, train
from bench.lib import common, faults, small

MAN = common.manifest()
LOCAL = ("fft2d_16384.r2c_roundtrip", "fft2d_16384.c2c_forward")
DIST = "fft3d_1024.pencil_step_4chip"
TRAIN = "fftconv_lm_olmo1b.train_2x8192"

common.use_src()


def execute(name, seed=2 ** 32 + 7, seconds=0.3):
    ctx = run.Context(name, small.small_cell(name), seed, seconds, 0,
                      device="cpu", t_start=time.perf_counter())
    line, loaded = run.execute(ctx, MAN)
    assert not loaded
    return line


@pytest.mark.parametrize("name", LOCAL + (TRAIN,))
def test_sound_run_is_correct(name):
    line = execute(name)
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert line["attempted"] > 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("name", LOCAL)
@pytest.mark.parametrize("fault", faults.FFT_FAULTS)
def test_local_fault_is_not_correct(name, fault):
    with faults.planted(fault):
        line = execute(name)
    assert not line["correct"], (fault, line["checks"])


@pytest.mark.parametrize("fault", train.FAULTS)
def test_training_fault_is_not_correct(fault):
    with train.planted(fault):
        line = execute(TRAIN)
    assert not line["correct"], (fault, line["checks"])


def test_distributed_run_and_its_faults():
    """One sound run on four gloo ranks, then one a fault; the faults are
    planted in the ranks themselves."""
    line = execute(DIST, seconds=0.5)
    assert line["correct"], line["checks"]
    assert line["metrics"]["dist_fft_gflops"]["value"] > 0
    for fault in faults.DIST_FAULTS:
        ctx = run.Context(DIST, small.small_cell(DIST), 99, 0.2, 0,
                          device="cpu", t_start=time.perf_counter())
        checks = fft_dist.fault(ctx, fault)
        assert any(v > lim for _, v, lim in checks), (fault, checks)


def test_no_card_no_result():
    """Without CUDA the command exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    got = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", LOCAL[1], "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=common.ROOT,
        capture_output=True, text=True, env=env, timeout=120)
    assert got.returncode != 0
    assert got.stdout.strip() == ""


def test_benchmark_alone_is_no_run(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, the command exits non-zero and prints no result."""
    import shutil
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(common.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", LOCAL[1], "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120)
    assert got.returncode != 0
    assert got.stdout.strip() == ""


def test_result_line_is_json_with_checks_last():
    line = execute(LOCAL[1])
    text = json.dumps(line)
    assert list(json.loads(text)) == ["correct", "attempted", "failed",
                                      "metrics", "device", "setup_parts",
                                      "checks"]
    parts = line["setup_parts"]["main"]
    assert list(parts)[-2:] == ["warm step 0", "warm step 1"]
    assert all(v >= 0 for v in parts.values())
