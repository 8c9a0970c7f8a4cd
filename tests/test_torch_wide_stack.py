"""The openvpi release's acoustic widths on the port, on the CPU: the float32
stack body's dispatch rule and column split at C = 512, the configuration
``ds512_44k_cpop`` served through ``FusedSynthesizer`` against the
benchmark's plain reference, and the tracer's counters that the stack's
fill is read from.

``stack_layer_wg<S>``, the C = 512 body on ``wgmma``, runs only on the card;
``chip_smoke.py`` holds it against the plain twin there. Its schedule, ring
and packed weights are modelled in ``tests/test_torch_stack_wgmma_plans.py``;
the wave rule at every width and the library's instances and shared memory
are held with the other widths' in ``tests/test_torch_stack_f32_plans.py``.
"""

import copy

import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from diffsinger_tpu_torch.ops import diffnet_stack as tds
from diffsinger_tpu_torch.utils import trace
from test_torch_stack_f32_plans import _inputs

torch.set_num_threads(1)
CYCLE4 = tuple(2 ** (i % 4) for i in range(20))
# resident tiles a wave at C = 512 on the H100's 132 SMs: clusters of 2 and 4
# as the GPCs hold them (the first as read on an H100 80GB HBM3; the others
# what another part of the GPCs' SMs could give); at
# d > 8 the two-way split's tiles do not fit and the library reports none
RESIDENT = [{2: 66, 4: 30}, {2: 64, 4: 32}, {2: 66, 4: 33}]
# the cell's device batches: 1-16 rows (powers of two) x 128-frame buckets
# of up to 1152 frames (Opencpop's 1-12 s at 86.13 frames a second; the
# benchmark's set fills buckets 128-1152)
CELL_SHAPES = [(b, t) for b in (1, 2, 4, 8, 16) for t in range(128, 1153, 128)]


# ------------------------------------------------------------ dispatch rule
@pytest.mark.parametrize("d", [1, 2, 4, 8, 10, 11, 16])
def test_float32_at_512_takes_the_tensor_cores_up_to_16(d):
    for dt in (None, torch.float32):
        assert tds.takes_tensor_cores(512, (1, d), dt)
        assert tds._body(512, (1, d), dt) == 1
    assert tds.takes_tensor_cores(512, CYCLE4, None)


def test_float32_at_512_past_16_takes_simt():
    dil = (1, tds.TC_MAX_DILATION + 1)
    assert not tds.takes_tensor_cores(512, dil, None)
    assert tds._body(512, dil, None) == 0


@pytest.mark.parametrize("dil", [(1,), CYCLE4, (16,)])
def test_bfloat16_at_512_keeps_raising(dil):
    assert not tds.takes_tensor_cores(512, dil, torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16 kernel takes C"):
        tds._body(512, dil, torch.bfloat16)


def test_512_is_split_two_or_four_ways_and_never_unsplit():
    assert tds.splits_for(512) == (2, 4)
    assert 512 in tds.TC32_CHANNELS and 512 not in tds.TC_CHANNELS
    # the C <= 256 splits keep their measured costs
    assert tds.splits_for(256) == (1, 2, 4) and tds.splits_for(128) == (1,)
    assert tds.SPLIT_COST[256] == {1: 0.0, 2: 0.09, 4: 0.38}
    assert tds.SPLIT_COST[512][2] == 0.0
    for resident in RESIDENT + [{1: 132, 2: 66, 4: 30}]:
        for b in range(1, 17):
            for t in (5, 64, 384, 1152, 4096):
                assert tds.column_split(b, t, 512, resident) in (2, 4)


def test_a_wide_halo_leaves_the_four_way_split():
    """At d > 8 the library reports no two-way cluster: the rule takes 4,
    and with nothing resident it names the width's smallest split."""
    for b, t in CELL_SHAPES:
        assert tds.column_split(b, t, 512, {2: 0, 4: 30}) == 4
    assert tds.column_split(16, 1152, 512, {}) == 2


def test_full_batches_of_the_cell_take_the_two_way_split():
    """16 x 1152 (288 tiles) fills 5 waves of 66 two-block clusters, against
    10 waves of 30 four-block ones."""
    assert tds.column_split(16, 1152, 512, RESIDENT[0]) == 2


# ------------------------------------------------------------- the counters
def test_the_counter_is_off_without_a_profiler():
    tr = trace.Tracer()
    assert autograd_profiler._is_profiler_enabled is False
    tr.count("ds.stack.tiles", 7)
    assert tr.summary() == {} and tr._counts == {}


def test_the_counter_counts_under_a_profiler_and_clears():
    tr = trace.Tracer()
    with profile(activities=[ProfilerActivity.CPU]):
        tr.count("ds.stack.tiles", 7)
        tr.count("ds.stack.tiles", 5)
        with tr.span("ds.serve.batch"):
            tr.count("ds.stack.slots", 30)
    tr.count("ds.stack.tiles", 100)   # after the profiler stopped: not counted
    s = tr.summary()
    assert s["ds.stack.tiles"] == {"count": 2, "total": 12}
    assert s["ds.stack.slots"] == {"count": 1, "total": 30}
    assert s["ds.serve.batch"]["count"] == 1
    tr.clear()
    assert tr.summary() == {}


def test_a_float32_call_counts_its_tiles_and_slots(monkeypatch):
    """A CUDA call (its entry mocked) counts ceil(T/64)·B tiles and the slots
    of the waves of the rule's split, only under a profiler."""

    def entry(path, dtype, split, *rest):
        report = rest[-1]
        report[0], report[1], report[2] = 20, 1, split
        return 0

    class Stream:
        cuda_stream = 0

    for name in ("device_launches", "ran_tensor_cores", "column_split"):
        monkeypatch.setattr(tds.diffnet_stack, name, None)   # put back after the test
    monkeypatch.setattr(tds, "_entry", lambda: entry)
    monkeypatch.setattr(tds, "_resident", lambda c, dmax, dev: dict(RESIDENT[0]))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(trace, "count", trace.Tracer().count)   # a tracer of the test's own
    args = _inputs(3, 3, 300, 512, 1)
    tds._launch(*args, (1,), None)    # no profiler: nothing counted
    assert trace.count.__self__.summary() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        tds._launch(*args, (1,), None)
    k = tds.diffnet_stack.column_split
    tiles = 5 * 3
    assert k == tds.column_split(3, 300, 512, RESIDENT[0])
    s = trace.count.__self__.summary()
    assert s["ds.stack.tiles"]["total"] == tiles
    assert s["ds.stack.slots"]["total"] == -(-tiles // RESIDENT[0][k]) * RESIDENT[0][k]


# -------------------------------------------------- the configuration served
def test_the_release_widths_serve_as_the_reference_does():
    """``ds512_44k_cpop`` at small depth (C = 512, 2 layers, 128 bins, buckets
    of 32 frames up to 96, the five-scale NSF vocoder at 32 initial
    channels, PLMS with 4 steps) through ``FusedSynthesizer.synthesize_many``
    against the frozen plain reference on the benchmark's seeded weights and
    draws, stage by stage (``benchmark/harness/check.py``). Float32 against
    float32 on the CPU, the stack and MRF through their plain twins: the
    same math in another summation order, so each gap (largest difference
    over the reference's largest magnitude, at least 1) is held to 1e-5: the
    mel after 5 stack calls, the PE's F0 on the program's mel (0: the same
    convolutions on the same input), the waveform of 44.1 kHz samples from
    the five upsamples and the sine source's phase carry."""
    from benchmark.harness import check, manifest
    from benchmark.harness.serving import Cell
    from benchmark.harness.traffic import load_mix

    bench = manifest.load()
    cell = manifest.cell(bench, "cpop512_batch")
    cfg = copy.deepcopy(manifest.config(bench, cell["config"]))
    hp = cfg["hparams"]
    assert (hp["residual_channels"], hp["audio_num_mel_bins"], hp["audio_sample_rate"],
            hp["hop_size"], len(hp["upsample_rates"])) == (512, 128, 44100, 512, 5)
    hp.update(hidden_size=32, residual_layers=2, enc_layers=1, dec_layers=1,
              predictor_hidden=32, upsample_initial_channel=32, pndm_speedup=250,
              mel_pad_multiple=32)
    corpus = cfg["corpus"]
    phone_s = corpus["frames_per_phone"] / corpus["frames_per_s"]
    corpus.update(clip_s=[2 * phone_s, 5 * phone_s], mean_s=4 * phone_s)
    mix = dict(load_mix(cell["traffic"]), length_set=4)
    run = Cell(cell, cfg, mix, manifest.limits(cell["name"]), "cpu", log=lambda *a: None)
    seed = 2 ** 31 + 512
    run.setup(seed, False)
    assert all(t_b <= 96 for t_b, _, _ in run.plans[0])
    hop = run.program.hop
    out = run.window(0.1, False)
    run.free()
    numbers, samples = run.judge(out, run.reference(seed))
    assert hop == 512 and out["failed"] == 0 and samples >= 1
    assert numbers["mel_gap"] < 1e-5 and numbers["f0_gap"] < 1e-5 and numbers["wav_gap"] < 1e-5
    assert check.verdict(numbers, run.limits, samples, out["failed"])
