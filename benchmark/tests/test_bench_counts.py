"""The frozen counts: equal to the program's ops/flops.py and to chip_smoke.py's
stack and MRF counts at the same shapes."""

import sys
from pathlib import Path

import pytest
import torch

from benchmark.counts import diffnet_stack as stack_counts
from benchmark.counts import model as frozen
from benchmark.counts import mrf_stage as mrf_counts
from benchmark.harness import manifest

REPO = Path(__file__).resolve().parents[2]
BENCH = manifest.load()
HPS = [manifest.config(BENCH, c["name"])["hparams"] for c in BENCH["configs"]]
SHAPES = [(1, 13, 104), (16, 112, 896), (8, 128, 1024), (2, 80, 2304)]


@pytest.mark.parametrize("hp", HPS, ids=[c["name"] for c in BENCH["configs"]])
@pytest.mark.parametrize("b,t_txt,t_mel", SHAPES)
def test_model_counts_equal_the_program(hp, b, t_txt, t_mel):
    from diffsinger_tpu_torch.ops import flops as program

    assert frozen.sampler_flops(hp, b, t_txt, t_mel) == program.sampler_flops(hp, b, t_txt, t_mel)
    assert frozen.hifigan_flops(hp, b, t_mel) == program.hifigan_flops(hp, b, t_mel)
    assert frozen.fs2_flops(hp, b, t_txt, t_mel) == program.fs2_flops(hp, b, t_txt, t_mel)
    assert frozen.train_step_flops(hp, b, t_txt, t_mel) == \
        program.train_step_flops(hp, b, t_txt, t_mel)


def test_pe_count_against_torch_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference.pe import PEConfig, PitchExtractor

    hp = manifest.config(BENCH, "ds1000_cpop")["hparams"]
    pe = PitchExtractor(PEConfig.from_hparams(hp)).eval()
    mel = torch.randn(2, 40, 80)
    with FlopCounterMode(display=False) as fc:
        pe(mel)
    assert frozen.pe_flops(hp, 2, 40) == pytest.approx(fc.get_total_flops(), rel=1e-3)


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("b,t,c,layers", [(8, 1024, 256, 20), (1, 2816, 256, 20),
                                          (16, 896, 256, 20), (3, 301, 128, 4)])
def test_stack_count_equals_chip_smoke(b, t, c, layers):
    cs = _chip_smoke()
    args = (torch.zeros(b, t, c), torch.zeros(layers, b, c), torch.zeros(layers, b, t, 2 * c),
            torch.zeros(layers, 3, c, 2 * c), torch.zeros(layers, 2 * c),
            torch.zeros(layers, c, 2 * c), torch.zeros(layers, 2 * c))
    flops, nbytes = stack_counts.counts([tuple(a.shape) for a in args], cs.nbytes(*args))
    assert flops == layers * 4 * 2 * (b * t) * c * (2 * c)
    assert nbytes == cs.nbytes(*args) + b * t * c * 4


@pytest.mark.parametrize("c,b,t", [(128, 8, 65536), (64, 1, 4096), (32, 2, 777)])
def test_mrf_count_equals_chip_smoke(c, b, t):
    cs = _chip_smoke()
    ks, ds = (3, 7, 11), ((1, 3, 5),) * 3
    x = torch.zeros(b, t, c)
    w = torch.zeros(3, 3, 11 * c, c)
    bias = torch.zeros(3, 3, c)
    flops, nbytes = mrf_counts.counts([tuple(a.shape) for a in (x, w, bias, w, bias)],
                                      [4] * 5, ks, ds)
    assert flops == 252 * c * c * b * t
    useful_w = sum(2 * 3 * k * c * c for k in ks) * 4
    assert nbytes == cs.nbytes(x, bias, bias) + useful_w + b * t * c * 4


@pytest.mark.parametrize("b,t,c,h,layers", [(24, 1024, 256, 256, 20), (48, 512, 256, 256, 20),
                                            (3, 301, 256, 200, 4)])
def test_training_counts_equal_chip_smoke(b, t, c, h, layers):
    from benchmark.counts import diffnet_train

    cs = _chip_smoke()
    shapes = [(b, t, c), (layers, b, c), (b, t, h), (layers, h, 2 * c), (layers, 2 * c),
              (layers, 3, c, 2 * c), (layers, 2 * c), (layers, c, 2 * c), (layers, 2 * c)]
    f_fwd, f_bwd = cs.train_stack_flops(b, t, c, h, layers)
    assert diffnet_train.forward(shapes, 10, 5) == (f_fwd, 15.0)
    assert diffnet_train.backward(shapes, 7, 1) == (f_bwd, 8.0)
