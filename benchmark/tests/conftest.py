"""Small copies of the benchmark's configurations and mixes for CPU tests."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

# run.py's helpers (the import check, the runner of a mix) for the tests
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import manifest

# small widths: the same modules and paths, sized for a CPU test
TINY = dict(hidden_size=32, residual_channels=32, residual_layers=4, enc_layers=1,
            dec_layers=1, predictor_hidden=32, cwt_hidden_size=32,
            upsample_initial_channel=32, resblock="1", resblock_kernel_sizes=[3, 7, 11],
            resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5], [1, 3, 5]])
LJ_TINY_VOCODER = dict(upsample_rates=[8, 8, 2, 2], upsample_kernel_sizes=[16, 16, 4, 4])


def tiny_config(name: str, k_step: int = 0) -> dict:
    """The configuration ``name`` at small widths and short clips; ``k_step``
    shortens a DDPM loop."""
    cfg = copy.deepcopy(manifest.config(manifest.load(), name))
    hp = cfg["hparams"]
    hp.update(TINY)
    if "upsample_rates" not in hp:
        hp.update(LJ_TINY_VOCODER)
    if k_step:
        hp["K_step"] = k_step
    # several training batches of the short clips
    hp["max_tokens"] = 160
    corpus = cfg["corpus"]
    fpp = corpus["frames_per_phone"] / corpus["frames_per_s"]
    corpus.update(clip_s=[2 * fpp, 12 * fpp], mean_s=6 * fpp)
    return cfg


def tiny_mix(name: str, n: int = 6) -> dict:
    from benchmark.harness.traffic import load_mix

    mix = load_mix(name)
    mix["length_set"] = n
    return mix


@pytest.fixture
def card():
    """Skips the test where this machine has no CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
