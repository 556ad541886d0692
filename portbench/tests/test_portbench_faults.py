"""A whole run of each cell on the CPU at a tiny size, past the harness's
look for a card: clean it comes out correct, and with the timed path broken
underneath (``faults.py``) it comes out not correct, for each fault the cell
can have. Its control, the reference in the precision below the
configuration's, reads further from the reference than the program; on the
card, at the cell's own size, it fails the cell's limits."""
import pytest
import torch

from portbench import calibrate, compare, faults, run

CELLS = ["msgnn.rollout.b1", "gnn.train.b8", "msgnn.rollout.b8", "msgnn.train.b8"]
SEED = 2 ** 31 + 101


def mode_of(cell):
    return "train" if ".train." in cell else "rollout"


@pytest.mark.parametrize("cell", CELLS)
def test_clean_run_is_correct(tiny_cell, cell):
    result, numbers = run.run_cell(tiny_cell(cell), SEED, 0.2, False, "cpu", 0.0)
    assert result["correct"], numbers
    assert list(result)[-1] == "checks" and result["attempted"] >= 1


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in faults.FAULTS[mode_of(c)]])
def test_fault_is_caught(tiny_cell, cell, fault):
    with faults.planted(fault, mode_of(cell)):
        result, numbers = run.run_cell(tiny_cell(cell), SEED, 0.2, False, "cpu", 0.0)
    assert not result["correct"], numbers


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_further_out(tiny_cell, cell):
    spec = tiny_cell(cell)
    program = calibrate.reading(spec, SEED, "cpu")
    control = calibrate.reading(spec, SEED, "cpu", control=True)
    names = compare.limits(cell)
    assert any(control[n] > 3 * program[n] for n in names), (program, control)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits_on_the_card(tiny_cell, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    spec = tiny_cell(cell, cut=False)
    control = calibrate.reading(spec, SEED, torch.device("cuda", 0), control=True)
    ok, numbers = compare.judge(control, compare.limits(cell))
    assert not ok, numbers
