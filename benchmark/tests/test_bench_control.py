"""On the card: the program's numbers within each limit and the control's (the
reference with TF32 in the program's place) outside at least one, at small
widths on three seeds. The cells' own sizes are read by
``run.py --readings 12 --control 3`` (PERF.md gives the readings)."""

import pytest

from benchmark.harness import check, manifest

from conftest import tiny_config, tiny_mix

BENCH = manifest.load()
SEEDS = [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103]


def _cell(name, device):
    from run import cell_class  # noqa: E402  (benchmark/ is on the path: see conftest)

    cell = manifest.cell(BENCH, name)
    mix = tiny_mix(cell["traffic"], 24 if cell["traffic"] == "train_batches" else 6)
    config = tiny_config(cell["config"], 8 if name == "lj_batch" else 0)
    # the MRF kernel takes 16 to 128 channels: every vocoder scale on it
    config["hparams"]["upsample_initial_channel"] = 256
    return cell_class(mix)(cell, config, mix, manifest.limits(name), device,
                           log=lambda *a: None)


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_and_program_passes(card, name):
    from benchmark.harness.training import TrainCell

    run = _cell(name, card)
    for seed in SEEDS:
        run.setup(seed, False)
        out = {"attempted": 0, "failed": 0} if isinstance(run, TrainCell) else \
            run.window(2.0, False)
        ref = run.reference(seed)
        numbers, samples = run.judge(out, ref)
        control, _ = run.judge(out, ref, tf32_control=True)
        run.free()
        assert check.verdict(numbers, run.limits, samples, 0), (seed, numbers)
        assert not check.verdict(control, run.limits, samples, 0), (seed, control)
