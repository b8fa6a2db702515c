"""The control of every cell comes out not correct: the plain reference
put in the program's place and computed in the nearest precision below
the configuration's (float32 with TF32 on, for float32 with TF32 off),
at the cell's own size, fails at least one of the cell's limits. Needs
the card (``-m cuda``); ``benchmarks/calibrate.py`` reads the same on
more seeds. The staged cells are held to the same."""

import importlib

import pytest
import torch

from benchmarks import run

CELLS = [w["name"] for w in run.load_manifest(staged=True)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's "
                    "own size on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _, cfg, traffic, limits = run.cell_of(run.load_manifest(staged=True),
                                          cell)
    mod = importlib.import_module(f"benchmarks.drivers.{traffic['driver']}")
    drv = mod.Driver(cfg, traffic, 2 ** 31 + 99, torch.device("cuda", 0))
    drv.setup()
    drv.window(3.0)
    drv.release()
    program = drv.check()
    control = drv.check(control=True)
    assert all(program[k] <= limits[k] for k in program), program
    assert any(control[k] > limits[k] for k in control), control
