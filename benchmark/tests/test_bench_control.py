"""On the card, at each cell's own size: the control (the reference in
bfloat16 in the program's place) comes out not correct on three seeds,
and the program comes out correct."""

import io
import time

import pytest

from benchmark.harness import controls, session, spec
from benchmark.tests.conftest import CELLS

SEEDS = (2 ** 31 + 11, 2 ** 32 + 2222, 3 * 2 ** 31 + 333)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(card, name):
    cell = spec.Cell(spec.load_spec(), name)
    for seed in SEEDS:
        res = session.run(cell, seed, 0.5, False, time.perf_counter(),
                          frame_fn=controls.control, out=io.StringIO(), err=io.StringIO())
        assert not res["correct"], (seed, res["compared"])


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct_at_the_cells_size(card, name):
    cell = spec.Cell(spec.load_spec(), name)
    res = session.run(cell, SEEDS[0], 0.5, False, time.perf_counter(), out=io.StringIO(),
                      err=io.StringIO())
    assert res["correct"], res["compared"]
