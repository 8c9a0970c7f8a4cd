"""Each fault a cell can have (``harness/faults.py``), planted in the program
underneath a run, and ``correct`` coming out false."""

import pytest

from benchmark.harness import check, faults

from test_bench_reference import ENTRIES, TRAIN_CELLS, run_cell, run_train

# one phrase a device batch at B = 1: no half of a batch to leave out
CASES = [(name, k_step, fault) for name, k_step in ENTRIES for fault in sorted(faults.SERVING)
         if not (fault == "half_batch" and name == "cpop_b1")]


@pytest.mark.parametrize("name,k_step,fault", CASES)
def test_fault_is_not_correct(name, k_step, fault):
    with faults.SERVING[fault]():
        run, out, numbers, samples = run_cell(name, k_step, n=12)
    assert not check.verdict(numbers, run.limits, samples, out["failed"]), numbers


@pytest.mark.parametrize("name", TRAIN_CELLS)
@pytest.mark.parametrize("fault", sorted(faults.TRAINING))
def test_training_fault_is_not_correct(fault, name):
    with faults.TRAINING[fault]():
        run, out, numbers, steps = run_train(name)
    assert not check.verdict(numbers, run.limits, steps, out["failed"]), numbers
