"""Each one-card cell at its own size on the card, briefly: a sound run is
correct, its control is not."""

import json
import subprocess
import sys

import pytest

from portbench.harness import ROOT

ONE_CARD = ["milksad.scan", "brainwallet_numeric.scan", "milksad.analyze"]


def _run(module: str, workload: str, seed: int) -> dict:
    p = subprocess.run([sys.executable, "-m", module, "--workload", workload, "--seed",
                        str(seed), "--seconds", "3", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.cuda_only
@pytest.mark.parametrize("workload", ONE_CARD)
def test_cell_is_correct_on_the_card(card, workload):
    res = _run("portbench.run", workload, 3000000021)
    assert res["correct"] and res["device"]["platform"] == "gpu"


@pytest.mark.cuda_only
@pytest.mark.parametrize("workload", ONE_CARD)
def test_control_is_not_correct_on_the_card(card, workload):
    assert _run("portbench.control", workload, 3000000022)["correct"] is False
