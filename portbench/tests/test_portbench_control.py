"""The control on the card at a size a test run holds: the program's own
bfloat16 walk (GA) and the bfloat16 reference (Adam) in its place come out
not correct, and the program itself correct, on three seeds each."""
import pytest
import torch

from portbench import run
from portbench.tests.test_portbench_faults import _cell


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ga", "adam"])
def test_control_fails_and_program_passes_on_the_card(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = _cell(kind)
    cell = cell._replace(config=dict(cell.config, height=96, width=128, n_splats=64))
    for seed in (3, 2**31 + 5, 77):
        assert run.run_cell(cell, seed, 0.2, False, "cuda")["correct"]
        assert not run.run_cell(cell, seed, 0.2, False, "cuda", control=True)["correct"]
