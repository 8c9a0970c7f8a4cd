"""The plain reference against the program's plain path (its kernels' plain
twins on the CPU), at small widths on the benchmark's seeded weights, for each
serving entry: a whole run of the cell, its window included, with the
program's outputs judged stage by stage."""

import pytest
import torch

from benchmark.harness import check, manifest, weights
from benchmark.harness.serving import Cell, make_weights, reference_system

from conftest import tiny_config, tiny_mix

BENCH = manifest.load()
# (cell, the DDPM steps kept at small size: 0 keeps the configuration's)
ENTRIES = [("lj_batch", 8), ("cpop_b1", 0), ("cpop_batch", 0)]


def run_cell(name, k_step, seed=2 ** 31 + 11, seconds=1.0, n=6):
    cell = manifest.cell(BENCH, name)
    run = Cell(cell, tiny_config(cell["config"], k_step), tiny_mix(cell["traffic"], n),
               manifest.limits(name), "cpu", log=lambda *a: None)
    run.setup(seed, False)
    out = run.window(seconds, False)
    run.free()
    numbers, samples = run.judge(out, run.reference(seed))
    return run, out, numbers, samples


@pytest.mark.parametrize("name,k_step", ENTRIES)
def test_reference_matches_the_program(name, k_step):
    run, out, numbers, samples = run_cell(name, k_step)
    assert out["failed"] == 0 and samples >= 1
    # float32 against float32 on the CPU: summation order only
    assert numbers["mel_gap"] < 1e-5 and numbers["wav_gap"] < 1e-5
    assert numbers.get("f0_gap", 0.0) < 1e-5
    assert check.verdict(numbers, run.limits, samples, out["failed"])


def test_weights_are_seeded_and_cover_every_leaf():
    cfg = tiny_config("ds1000_cpop")
    a, b = make_weights(cfg, 5, "cpu"), make_weights(cfg, 5, "cpu")
    c = make_weights(cfg, 6, "cpu")
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    ref = reference_system(cfg, "cpu")
    weights.load(ref, a)  # raises unless every parameter is given
    assert torch.all(a["fs2.dur_predictor.linear.weight"] == 0)
    assert a["pe.pitch_predictor.linear.bias"].tolist() == [7.5, 0.0]


def run_train(seed=2 ** 31 + 21, seconds=0.5):
    from benchmark.harness.training import TrainCell

    run = TrainCell(manifest.cell(BENCH, "lj_train"), tiny_config("ds_beta6_lj"),
                    tiny_mix("train_batches", 24), manifest.limits("lj_train"), "cpu",
                    log=lambda *a: None)
    run.setup(seed, False)
    out = run.window(seconds, False)
    run.free()
    numbers, steps = run.judge(out, run.reference(seed))
    return run, out, numbers, steps


def test_reference_matches_the_training_step():
    run, out, numbers, steps = run_train()
    assert out["failed"] == 0 and out["steps"] >= 1 and steps == 3
    # the three checked steps were on three different batches
    assert len(set(run.order[:3])) == 3
    assert numbers["loss_gap"] < 1e-6
    assert numbers["grad_gap"] < 1e-5 and numbers["update_gap"] < 1e-5
    assert check.verdict(numbers, run.limits, steps, out["failed"])
