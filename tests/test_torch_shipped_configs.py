"""The shipped-config matrix through the port, as ``tests/test_shipped_configs.py``
holds it for the JAX package: every YAML under ``configs/`` resolves through
the port's ``set_hparams`` to the dict JAX's resolves to; every pipeline
config builds its task through ``cli._build``, takes one ``Trainer.train_step``
on a collated batch of a synthetic corpus and runs one tiny inference, at the
JAX test's own ``SHRINK`` / ``EXTRA`` overrides; and ``tpu_production.yaml``,
stacked through ``base_config`` onto three pipelines, builds, steps and
infers. The port reads the overlay's ``compute_dtype``, ``nsf_source_mode``,
``fused_infer`` and ``vocoder_backend``, not its TPU-only switches."""

import os

import numpy as np
import pytest
import torch
import yaml

from diffsinger_tpu.config.hparams import set_hparams as jset_hparams
from diffsinger_tpu_torch import cli
from diffsinger_tpu_torch.config.hparams import set_hparams
from diffsinger_tpu_torch.training.trainer import Trainer
from tests.test_shipped_configs import ALL_CONFIGS, EXTRA, PIPELINES, REPO, SHRINK

torch.set_num_threads(1)
OVERLAY_PIPELINES = ["configs/lj/ds_beta6.yaml", "configs/opencpop/ds100_adj_rel.yaml",
                     "configs/opencpop/ds1000.yaml"]


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    from tests.helpers import make_synthetic_dataset

    plain = make_synthetic_dataset(str(tmp_path_factory.mktemp("cfg_plain")))
    midi = make_synthetic_dataset(str(tmp_path_factory.mktemp("cfg_midi")), midi=True)
    return {"plain": plain, "midi": midi}


def test_the_matrix_is_jax_s():
    assert len(ALL_CONFIGS) == 18 and len(PIPELINES) == 11
    assert set(PIPELINES) | set(OVERLAY_PIPELINES) <= set(ALL_CONFIGS)


@pytest.mark.parametrize("rel", ALL_CONFIGS)
def test_config_resolves_to_jax_s_dict(rel):
    path = os.path.join(REPO, rel)
    got = set_hparams(config=path)
    want = jset_hparams(config=path, global_hparams=False)
    assert dict(got) == dict(want)
    shrunk = set_hparams(config=path, hparams_str=SHRINK + EXTRA.get(rel, ""))
    assert dict(shrunk) == dict(jset_hparams(config=path, hparams_str=SHRINK + EXTRA.get(rel, ""),
                                             global_hparams=False))


def _step_and_infer(hp, data_dirs, tmp_path):
    """The CLI's task and dataset for ``hp``, one optimizer step on the first
    collated batch, one inference of it; returns (task, batch, losses, ret)."""
    hp["binary_data_dir"] = data_dirs["midi"] if hp.get("use_midi") else data_dirs["plain"]
    hp["work_dir"] = str(tmp_path / "exp")
    hp["fs2_ckpt"] = ""  # warm-start sources are not in the repository
    hp["pe_ckpt"] = ""
    hp["num_sanity_val_steps"] = 0
    _, task = cli._build(hp, "cpu")
    batch = next(cli._dataset_cls(hp)(hp, "train").iter_batches())
    trainer = Trainer(hp, task, device="cpu")
    trainer.initialize()
    before = [p.detach().clone() for p in trainer.params]
    losses = trainer.train_step(batch)
    assert any(not torch.equal(a, p) for a, p in zip(before, trainer.params))
    with torch.no_grad():
        ret = task.inference(batch, generator=torch.Generator().manual_seed(1))
    return task, batch, losses, ret


def _assert_finite_output(hp, batch, losses, ret):
    assert all(torch.isfinite(v).all() for v in losses.values()), losses
    b, t_mel = batch["mels"].shape[:2]
    if hp["task_cls"] == "pe":
        out = ret["f0_denorm_pred"]
        assert out.shape == (b, t_mel)
    else:
        out = ret["mel_out"]
        assert out.shape == (b, t_mel, int(hp["audio_num_mel_bins"]))
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("rel", PIPELINES)
def test_pipeline_builds_steps_and_infers(rel, data_dirs, tmp_path):
    """Resolve -> JAX's shrink -> the CLI's task and dataset -> one optimizer
    step on a collated batch -> one inference."""
    hp = set_hparams(config=os.path.join(REPO, rel), hparams_str=SHRINK + EXTRA.get(rel, ""))
    task, batch, losses, ret = _step_and_infer(hp, data_dirs, tmp_path)
    _assert_finite_output(hp, batch, losses, ret)
    want = {"diff": "DiffSingerTask", "fs2": "FastSpeech2Task", "pe": "PitchExtractionTask"}
    assert type(task).__name__ == want[hp["task_cls"]]


@pytest.mark.parametrize("pipeline", OVERLAY_PIPELINES)
def test_production_overlay_builds_steps_and_infers(pipeline, data_dirs, tmp_path):
    """The README's production stack, pipeline + tpu_production.yaml through
    ``base_config``, at the shrink (OpenCpop with four residual layers, so
    that the cycle-4 dilations 1, 2, 4, 8 all run): the bf16 stack trains
    and samples."""
    stacked = tmp_path / "prod_stack.yaml"
    stacked.write_text(yaml.safe_dump({"base_config": [
        os.path.join(REPO, pipeline), os.path.join(REPO, "configs/tpu_production.yaml")]}))
    shrink = SHRINK + EXTRA.get(pipeline, "")
    if "opencpop" in pipeline:
        shrink += ",residual_layers=4"
    hp = set_hparams(config=str(stacked), hparams_str=shrink)
    assert hp["compute_dtype"] == "bfloat16" and hp["vocoder_backend"] == "packed"
    assert hp["nsf_source_mode"] == "framewise" and hp["fused_infer"] is True
    if "opencpop" in pipeline:
        assert int(hp["dilation_cycle_length"]) == 4
    task, batch, losses, ret = _step_and_infer(hp, data_dirs, tmp_path)
    assert task.compute_dtype == torch.bfloat16
    _assert_finite_output(hp, batch, losses, ret)
