"""The port's ``utils/plot.py`` and ``ops/flops.py`` against the JAX
package's: every figure helper returns a figure with the same plotted data,
every FLOP counter equals JAX's on the same hparams, and the counters land
within the band ``test_flops.py`` gives XLA's cost analysis of
``torch.utils.flop_counter.FlopCounterMode`` on the port's own modules.
"""

import matplotlib
import numpy as np
import pytest
import torch
from matplotlib.figure import Figure
from torch.utils.flop_counter import FlopCounterMode

from diffsinger_tpu.ops import flops as JF
from diffsinger_tpu.utils import plot as jplot
from diffsinger_tpu_torch.models.diffnet import DiffNet
from diffsinger_tpu_torch.models.fft_blocks import FFTBlocks
from diffsinger_tpu_torch.models.hifigan import HifiGanConfig, HifiGanGenerator
from diffsinger_tpu_torch.ops import flops as F
from diffsinger_tpu_torch.utils import plot as tplot

torch.set_num_threads(1)
HP = dict(hidden_size=64, enc_layers=2, dec_layers=2, enc_ffn_kernel_size=9,
          dec_ffn_kernel_size=9, num_heads=2, audio_num_mel_bins=80,
          predictor_hidden=-1, predictor_layers=2, predictor_kernel=5,
          dur_predictor_layers=2, dur_predictor_kernel=3,
          use_pitch_embed=True, pitch_type="frame", use_uv=True,
          residual_layers=4, residual_channels=64, dilation_cycle_length=1,
          K_step=71, timesteps=100)
VOC = dict(audio_num_mel_bins=80, upsample_initial_channel=64,
           upsample_rates=(4, 4, 2), upsample_kernel_sizes=(8, 8, 4),
           resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)),
           resblock="1")
HPS = {"tiny": HP,
       "ph_plms": dict(HP, pitch_type="ph", K_step=1000, timesteps=1000, pndm_speedup=40,
                       predictor_hidden=32),
       "widths": dict(HP, hidden_size=256, residual_channels=256, residual_layers=20,
                      enc_layers=4, dec_layers=4),
       "defaults": {}}


def _counted(fn, *args) -> float:
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def _check(analytic, counted, lo=0.7, hi=1.3):
    assert lo < analytic / counted < hi, (analytic, counted, analytic / counted)


# ---------------------------------------------------------------- plots
def _arrays(fig):
    out = [c.get_array() for ax in fig.axes for c in ax.collections]
    out += [line.get_ydata() for ax in fig.axes for line in ax.lines]
    out += [t.get_position() for ax in fig.axes for t in ax.texts]
    return out


@pytest.mark.parametrize("helper", ["spec_to_figure", "spec_f0_to_figure", "dur_to_figure",
                                    "f0_to_figure"])
def test_plot_helpers_return_the_jax_figures(helper):
    rng = np.random.RandomState(0)
    spec = rng.randn(20, 8).astype(np.float32)
    f0 = 200 + 20 * rng.rand(20)
    args = {"spec_to_figure": (spec, -2.0, 1.5),
            "spec_f0_to_figure": (spec, {"gt": f0, "pred": f0 * 1.1}),
            "dur_to_figure": (rng.randint(1, 5, 6), rng.randint(1, 5, 6), list("abcdef")),
            "f0_to_figure": (f0, f0 * 0.9, f0 * 1.1)}[helper]
    got, want = getattr(tplot, helper)(*args), getattr(jplot, helper)(*args)
    assert isinstance(got, Figure) and matplotlib.get_backend().lower() == "agg"
    a, b = _arrays(got), _arrays(want)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    import matplotlib.pyplot as plt

    plt.close("all")


# ---------------------------------------------------------------- counters
@pytest.mark.parametrize("name", sorted(HPS))
def test_counters_equal_jax(name):
    hp = HPS[name]
    for b, t_txt, t_mel in ((1, 16, 64), (8, 128, 1024)):
        assert F.fs2_flops(hp, b, t_txt, t_mel) == JF.fs2_flops(hp, b, t_txt, t_mel)
        assert F.fs2_flops(hp, b, t_txt, t_mel, skip_decoder=True) == JF.fs2_flops(
            hp, b, t_txt, t_mel, skip_decoder=True)
        for cp in (False, True):
            assert F.diffnet_step_flops(hp, b, t_mel, cp) == JF.diffnet_step_flops(
                hp, b, t_mel, cp)
        assert F.cond_proj_flops(hp, b, t_mel) == JF.cond_proj_flops(hp, b, t_mel)
        assert F.sampler_flops(hp, b, t_txt, t_mel) == JF.sampler_flops(hp, b, t_txt, t_mel)
        assert F.train_step_flops(hp, b, t_txt, t_mel) == JF.train_step_flops(
            hp, b, t_txt, t_mel)
        assert F.hifigan_flops({**hp, **VOC}, b, t_mel) == JF.hifigan_flops(
            {**hp, **VOC}, b, t_mel)
        assert F.hifigan_flops(dict(VOC, use_nsf=True), b, t_mel) == JF.hifigan_flops(
            dict(VOC, use_nsf=True), b, t_mel)
    assert F.fft_stack_flops(2, 64, 64, 2, 9) == JF.fft_stack_flops(2, 64, 64, 2, 9)
    assert F.predictor_flops(2, 64, 64, 32, 3, 5, 2) == JF.predictor_flops(
        2, 64, 64, 32, 3, 5, 2)


def test_fft_stack_flops_vs_flop_counter():
    b, t, h = 2, 64, 64
    m = FFTBlocks(h, 2, ffn_kernel_size=9, num_heads=2, use_pos_embed=False)
    x = torch.randn(b, t, h, generator=torch.Generator().manual_seed(0))
    pad = torch.zeros(b, t, dtype=torch.bool)
    with torch.no_grad():
        _check(F.fft_stack_flops(b, t, h, 2, 9), _counted(m, x, pad))


def test_diffnet_flops_vs_flop_counter():
    b, t = 2, 64
    dn = DiffNet(in_dims=80, encoder_hidden=64, residual_layers=4, residual_channels=64)
    g = torch.Generator().manual_seed(1)
    x, cond = torch.randn(b, t, 80, generator=g), torch.randn(b, t, 64, generator=g)
    with torch.no_grad():
        _check(F.diffnet_step_flops(HP, b, t, include_cond_proj=True),
               _counted(dn, x, torch.zeros(b, dtype=torch.long), cond))


def test_hifigan_flops_vs_flop_counter():
    b, t = 1, 32
    gen = HifiGanGenerator(HifiGanConfig.from_hparams(VOC))
    mel = torch.randn(b, t, 80, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        _check(F.hifigan_flops(VOC, b, t), _counted(gen, mel))
