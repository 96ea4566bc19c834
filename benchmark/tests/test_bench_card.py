"""The command itself on a card (skipped without one)."""

import json
import subprocess
import sys

import pytest

from benchmark.tests.helpers import ROOT


@pytest.mark.gpu
def test_a_short_run_on_the_card_is_correct():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "default_final_8spp", "--seed", "2", "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"


def test_no_result_without_a_card():
    """Without CUDA the command exits non-zero and prints nothing."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "default_final_8spp", "--seed", "2", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout == ""
