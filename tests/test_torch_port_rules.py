"""Rules of the torch port: what it may import, where it runs by default, and
how its kernel wrappers dispatch."""

import ast
import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from diffsinger_tpu_torch import cli
from diffsinger_tpu_torch.inference.serve import FusedSynthesizer
from diffsinger_tpu_torch.inference.synthesize import _maybe_load_pe, synthesize_dataset
from diffsinger_tpu_torch.inference.vocoder import HifiGAN
from diffsinger_tpu_torch.ops import diffnet_stack as ds
from diffsinger_tpu_torch.ops import hifigan_mrf as mrf
from diffsinger_tpu_torch.training.tasks import DiffSingerTask
from diffsinger_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "diffsinger_tpu")
TINY_HP = {"hidden_size": 16, "enc_layers": 1, "dec_layers": 1, "num_heads": 2,
           "residual_layers": 2, "residual_channels": 16, "timesteps": 4,
           "K_step": 3, "schedule_type": "linear", "audio_num_mel_bins": 8,
           "keep_bins": 8, "pitch_type": "frame"}
TINY_VOC = {"upsample_rates": [2, 2], "upsample_kernel_sizes": [4, 4],
            "upsample_initial_channel": 16, "resblock_kernel_sizes": [3],
            "resblock_dilation_sizes": [[1, 3]], "audio_num_mel_bins": 8}


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _port_sources():
    files = sorted((ROOT / "diffsinger_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = _port_sources()
    assert len(files) > 10 and (ROOT / "chip_smoke.py").exists()
    rel = {str(p.relative_to(ROOT)) for p in files}
    assert {"diffsinger_tpu_torch/ops/diffnet_train.py",
            "diffsinger_tpu_torch/training/trainer.py",
            "diffsinger_tpu_torch/training/losses.py",
            "diffsinger_tpu_torch/training/schedules.py",
            "diffsinger_tpu_torch/models/pe.py", "diffsinger_tpu_torch/inference/svs.py",
            "diffsinger_tpu_torch/utils/text_encoder.py",
            "diffsinger_tpu_torch/data/binarize.py",
            "diffsinger_tpu_torch/data/text/pinyin.py",
            "diffsinger_tpu_torch/data/text/hanzi_pinyin.py",
            "diffsinger_tpu_torch/cli.py", "diffsinger_tpu_torch/config/hparams.py",
            "diffsinger_tpu_torch/convert/checkpoint.py",
            "diffsinger_tpu_torch/data/audio_norm.py", "diffsinger_tpu_torch/data/dataset.py",
            "diffsinger_tpu_torch/data/indexed_dataset.py",
            "diffsinger_tpu_torch/data/pitch_extract.py",
            "diffsinger_tpu_torch/data/textgrid.py", "diffsinger_tpu_torch/ops/mel.py",
            "diffsinger_tpu_torch/inference/synthesize.py",
            "diffsinger_tpu_torch/tools/fixtures.py", "diffsinger_tpu_torch/utils/misc.py",
            "diffsinger_tpu_torch/utils/pitch.py",
            "diffsinger_tpu_torch/models/hifigan_disc.py",
            "diffsinger_tpu_torch/models/melgan.py", "diffsinger_tpu_torch/ops/pqmf.py",
            "diffsinger_tpu_torch/ops/stft_loss.py",
            "diffsinger_tpu_torch/training/vocoder_task.py"} <= rel
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


def test_forbidden_prefix_is_a_module_match():
    assert _forbidden("diffsinger_tpu.models") and _forbidden("jax.numpy")
    assert not _forbidden("diffsinger_tpu_torch.models")
    assert not _forbidden("jaxlib_free_name")


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    task = DiffSingerTask(TINY_HP, vocab_size=10, device="cpu")
    voc = HifiGAN(TINY_VOC, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedSynthesizer(TINY_HP, task, voc)
    with pytest.raises(RuntimeError, match="CUDA"):
        DiffSingerTask(TINY_HP, vocab_size=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        HifiGAN(TINY_VOC)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(TINY_HP, task)
    # the CLI path: train (and with it Trainer.fit), infer, the test-split
    # synthesis and the PitchExtractor loader
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.train(TINY_HP)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.infer(TINY_HP)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run(["--config", "configs/lj/ds_beta6.yaml"])
    with pytest.raises(RuntimeError, match="CUDA"):
        synthesize_dataset(TINY_HP, task, dataset=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        _maybe_load_pe({**TINY_HP, "pe_enable": True})
    # the explicit CPU request works, and the modules stayed on the CPU
    syn = FusedSynthesizer(TINY_HP, task, voc, device="cpu")
    assert syn.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in task.parameters())


def test_entry_points_on_the_card_turn_tf32_off(monkeypatch):
    """Every entry point that resolves a CUDA device leaves float32 matmuls and
    cuDNN convolutions in float32 (torch's default rounds cuDNN's inputs to
    TF32); the CPU leaves both switches as they were. CUDA is faked, so each
    entry point stops at its first use of the card, after its device
    resolved."""
    from diffsinger_tpu_torch.inference.svs import DiffSingerE2EInfer
    from diffsinger_tpu_torch.training.vocoder_task import HifiGanTask
    from diffsinger_tpu_torch.utils.device import resolve_device

    backends = torch.backends
    monkeypatch.setattr(backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(backends.cudnn, "allow_tf32", True)

    def switches():
        return backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32

    task = DiffSingerTask(TINY_HP, vocab_size=10, device="cpu")
    voc = HifiGAN(TINY_VOC, device="cpu")
    FusedSynthesizer(TINY_HP, task, voc, device="cpu")
    Trainer(TINY_HP, task, device="cpu")
    assert resolve_device("cpu").type == "cpu" and switches() == (True, True)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    no_card = (AssertionError, "not compiled with CUDA")  # moving a module to the card
    on_cpu = (ValueError, "task is on cpu")
    entry_points = {
        "FusedSynthesizer": (lambda: FusedSynthesizer(TINY_HP, task, voc), no_card),
        "DiffSingerTask": (lambda: DiffSingerTask(TINY_HP, vocab_size=10), no_card),
        "HifiGAN": (lambda: HifiGAN(TINY_VOC), no_card),
        "DiffSingerE2EInfer": (lambda: DiffSingerE2EInfer(TINY_HP, task, voc), no_card),
        "Trainer": (lambda: Trainer(TINY_HP, task), on_cpu),
        "synthesize_dataset": (lambda: synthesize_dataset(TINY_HP, task, dataset=None),
                               on_cpu),
        "cli.train": (lambda: cli.train(TINY_HP), (KeyError, "binary_data_dir")),
        "cli.infer": (lambda: cli.infer(TINY_HP), (KeyError, "binary_data_dir")),
        "cli.run": (lambda: cli.run(["--config", "configs/lj/ds_beta6.yaml"]),
                    (FileNotFoundError, "phone_set")),
        "HifiGanTask": (lambda: HifiGanTask({}), (KeyError, "audio_sample_rate")),
    }
    for name, (call, (exc, match)) in entry_points.items():
        backends.cuda.matmul.allow_tf32 = backends.cudnn.allow_tf32 = True
        with pytest.raises(exc, match=match):
            call()
        assert switches() == (False, False), name
    backends.cuda.matmul.allow_tf32 = backends.cudnn.allow_tf32 = True
    assert _maybe_load_pe({**TINY_HP, "pe_enable": True, "pe_ckpt": ""}) is None
    assert switches() == (False, False)
    backends.cuda.matmul.allow_tf32 = backends.cudnn.allow_tf32 = True
    assert resolve_device(None) == torch.device("cuda")
    assert switches() == (False, False)


def test_wrappers_take_the_plain_twin_on_cpu_and_count_nothing():
    rng = np.random.RandomState(0)
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.3)
    n_stack, n_mrf = ds.diffnet_stack.launches, mrf.mrf_stage.launches
    args = (f(2, 8, 32), f(2, 2, 32), f(2, 2, 8, 64), f(2, 3, 32, 64), f(2, 64),
            f(2, 32, 64), f(2, 64))
    got = ds.diffnet_stack(*args, dilations=(1, 2))
    torch.testing.assert_close(got, ds.diffnet_stack_plain(*args, dilations=(1, 2)),
                               rtol=0, atol=0)
    margs = (f(1, 20, 16), f(2, 2, 48, 16), f(2, 2, 16), f(2, 2, 48, 16), f(2, 2, 16))
    kw = dict(kernel_sizes=(3, 3), dilation_sets=((1, 3), (1, 3)))
    got = mrf.mrf_stage(*margs, **kw)
    torch.testing.assert_close(got, mrf.mrf_stage_plain(*margs, **kw), rtol=0, atol=0)
    assert ds.diffnet_stack.launches == n_stack
    assert mrf.mrf_stage.launches == n_mrf


class _Raised(Exception):
    pass


@pytest.mark.parametrize("raises", [False, True], ids=["exit", "exception"])
def test_plain_twins_swaps_the_wrappers_and_puts_them_back(raises):
    """chip_smoke.py's plain_twins: inside the block the stack and MRF
    entries are their plain twins; after it, on a normal exit and on an
    exception raised inside it (which reaches the caller), the wrappers are
    back."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    stack, stage = ds.diffnet_stack, mrf.mrf_stage
    with pytest.raises(_Raised) if raises else contextlib.nullcontext():
        with chip_smoke.plain_twins(ds, mrf):
            assert ds.diffnet_stack is ds.diffnet_stack_plain
            assert mrf.mrf_stage is mrf.mrf_stage_plain
            if raises:
                raise _Raised
    assert ds.diffnet_stack is stack and mrf.mrf_stage is stage
    assert stack is not ds.diffnet_stack_plain and stage is not mrf.mrf_stage_plain


def test_kernel_sources_and_build_dir_match_the_build_module():
    from diffsinger_tpu_torch.ops import _build

    assert set(_build.KERNEL_SOURCES) == {"diffnet_stack", "mrf_stage", "diffnet_train"}
    for name in _build.KERNEL_SOURCES:
        assert (_build.CSRC_DIR / f"{name}.cu").exists()
    assert _build.BUILD_DIR == ROOT / "build" / "kernels"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_task_samples_through_the_stack_wrapper_for_any_config(compute_dtype, monkeypatch):
    """No config key picks the per-layer module: every reverse step calls the
    kernel wrapper (the plain twin here, on the CPU)."""
    calls = []
    wrapper = ds.diffnet_stack

    def counted(*args, **kw):
        calls.append(kw["compute_dtype"])
        return wrapper(*args, **kw)

    monkeypatch.setattr(ds, "diffnet_stack", counted)
    hp = dict(TINY_HP, compute_dtype=compute_dtype)
    task = DiffSingerTask(hp, vocab_size=10, device="cpu")
    batch = {"txt_tokens": np.full((2, 5), 3, np.int64),
             "mel2ph": np.repeat(np.arange(1, 6), 2)[None].repeat(2, 0)}
    out = task.inference(batch, t_mel=10, generator=torch.Generator().manual_seed(0))
    want_dt = torch.bfloat16 if compute_dtype == "bfloat16" else None
    assert calls == [want_dt] * TINY_HP["K_step"]
    assert out["mel_out"].shape == (2, 10, 8) and torch.isfinite(out["mel_out"]).all()

