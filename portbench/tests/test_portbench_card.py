"""The control at each one-chip cell's own size, on the card: the reference
in TF32 in the program's place fails a limit and the program meets every
one, on three seeds. Skips without a CUDA card (the CPU test of the same
readings is in test_portbench_checks.py)."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import control, harness  # noqa: E402

CELLS = ["paper_c2c1024.device", "paper_c2c1024.host"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    cell = harness.load_cell(ROOT, name)
    limits = cell.traffic["limits"]
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        r = control.readings(cell, seed, torch.device("cuda", 0))
        assert all(r["program"][k] <= lim for k, lim in limits.items()), r
        assert any(r["control"][k] > lim for k, lim in limits.items()), r
