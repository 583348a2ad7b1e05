"""On the card: one short run of a one-card cell through the command,
which must come out correct with its metrics. Skipped without a card."""

import json
import subprocess
import sys

import pytest

from bench.lib import common


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark runs on the card")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["fft2d_16384.c2c_forward"])
def test_cell_runs_on_the_card(card, name):
    got = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", name, "--seed",
         "3000000999", "--seconds", "2", "--trace", "0"], cwd=common.ROOT,
        capture_output=True, text=True, timeout=1200)
    assert got.returncode == 0, got.stderr[-2000:]
    line = json.loads(got.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"fft_gflops", "setup_s"}
