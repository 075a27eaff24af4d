"""The control: the reference at TF32 in the program's place fails a
number of each cell, here at a smoke size on the CPU (TF32 emulated by
rounding the operands), and on the card at the cell's own size."""

import pytest

from chipbench import control, run as harness
from chipbench.tests.smoke import smoke_cell, smoke_root

CELLS = ["cast19-star.sessions", "sasrec.serve", "cast19-star.cold"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke_root(tmp_path_factory.mktemp("smoke"))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [21, 22])
def test_control_fails_a_number(root, cell, seed):
    c = smoke_cell(root, cell)
    got = control.run_control(c, seed, "cpu")
    limits = c.cfg["limits"]
    assert any(got[n] > limits[n] for n in limits), got


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_own_size(card, cell):
    c = harness.Cell(harness.load_json(harness.ROOT / "BENCHMARK.json"),
                     cell)
    got = control.run_control(c, 31, card)
    limits = c.cfg["limits"]
    assert any(got[n] > limits[n] for n in limits), got
