"""On the card: each cell runs for a few seconds through `run.py` and is
correct; the control (the reference in the program's place, in TF32) is
not.  Each test decides inside itself whether there is a card."""

import json
import subprocess
import sys

import pytest
import torch

import helpers

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("cell", helpers.CELLS)
def test_cell_runs_and_is_correct(cell):
    _need_card()
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "4000000007", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=helpers.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    rate = [k for k in line["metrics"] if k.startswith("frames_per_s")]
    assert rate and line["metrics"][rate[0]]["value"] > 0


# a size a test run holds: the cells' widths, fewer characters
SMALL = {"ref_walk.crowd_root": dict(characters=64, judged=16),
         "ref_walk.random_segments": dict(characters=512, judged=64)}


@pytest.mark.parametrize("cell", helpers.CELLS)
def test_control_is_not_correct(cell):
    _need_card()
    limits = helpers.harness.cell_spec(helpers.bench(), cell)["limits"]
    program = helpers.readings(cell, 4000000009, "cuda", SMALL[cell])
    control = helpers.readings(cell, 4000000009, "cuda", SMALL[cell],
                               control=True)
    assert all(program[k] <= v for k, v in limits.items()), program
    assert any(control[k] > v for k, v in limits.items()), control
