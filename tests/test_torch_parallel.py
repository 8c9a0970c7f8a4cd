"""The port's data and tensor parallelism (``diffsinger_tpu_torch/parallel``)
against the JAX package's mesh and against the port in one process.

Ranks are real processes (``tools/mesh_check.py:spawn_ranks``: the spawn
start method, gloo on localhost); they import no JAX. The JAX side runs in
this process on its 8 virtual CPU devices. Tiny task: ``tests/helpers.py``'s
``tiny_hparams`` on its synthetic dataset, a 3-row global batch, so the
data axis of 2 pads it to 4 rows (JAX's trainer does the same).

Tolerances: the port on a mesh against the port in one process on the
padded global batch 1e-6 (summation order only); against JAX's trainer the
port's own trainer parity (``test_torch_train.py``): losses rtol 1e-4,
parameters atol 1e-5; tensor parallelism against tp=1 as
``test_tensor_parallel.py:51-54``: losses rtol 5e-5 atol 1e-5, mel rtol 1e-4
atol 5e-4; DP serving against one rank rtol 1e-5 atol 1e-5.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.data.dataset import FastSpeechDataset
from diffsinger_tpu.parallel import mesh as jmesh
from diffsinger_tpu.training.tasks import DiffSingerTask as JTask
from diffsinger_tpu.training.trainer import Trainer as JTrainer
from diffsinger_tpu.training.trainer import partition_params
from diffsinger_tpu_torch import cli
from diffsinger_tpu_torch.convert.from_jax import task_state_dict
from diffsinger_tpu_torch.inference.vocoder import HifiGAN
from diffsinger_tpu_torch.models.common import BatchNorm1dTBC
from diffsinger_tpu_torch.parallel import mesh as tmesh
from diffsinger_tpu_torch.tools import mesh_check
from diffsinger_tpu_torch.training.tasks import DiffSingerTask
from diffsinger_tpu_torch.training.trainer import Trainer
from diffsinger_tpu_torch.utils.device import resolve_device
from tests.helpers import make_synthetic_dataset, tiny_hparams

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
VOCAB = 10
STEPS = 3
VOC_HP = {"upsample_rates": [2, 2], "upsample_kernel_sizes": [4, 4],
          "upsample_initial_channel": 16, "resblock_kernel_sizes": [3],
          "resblock_dilation_sizes": [[1, 3]], "audio_num_mel_bins": 80}


def _arrays(batch):
    return {k: v for k, v in batch.items()
            if isinstance(v, np.ndarray) and k not in ("item_name", "text")}


def _jax_draws(rng, mels_shape, k_step):
    """t and noise as the JAX DiffSingerTask.train_loss draws them."""
    _, _, t_rng, noise_rng = jax.random.split(rng, 4)
    t = jax.random.randint(t_rng, (mels_shape[0],), 0, k_step)
    noise = jax.random.normal(noise_rng, mels_shape)
    return np.array(t).astype(np.int64), np.array(noise)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The tiny task's weights (JAX init, a nonzero DiffNet output), the
    3-row batch, JAX's data=2 trainer run, and the port's runs: one process
    and the spawned meshes."""
    tmp = tmp_path_factory.mktemp("parallel")
    data_dir = make_synthetic_dataset(str(tmp / "ds"))
    hp = tiny_hparams(data_dir, work_dir=str(tmp / "jax"))
    batch = _arrays(next(FastSpeechDataset(hp, "train").iter_batches(max_sentences=3)))
    assert batch["txt_tokens"].shape[0] == 3
    padded = tmesh.pad_batch_for_sharding(batch, 2)
    padded = {k: v for k, v in padded.items() if isinstance(v, np.ndarray)}

    jtrainer = JTrainer(hp, JTask(hp, VOCAB), mesh=jmesh.make_mesh(
        num_data=2, devices=jax.devices()[:2]))
    jtrainer.initialize(batch)
    params = jax.device_get(jtrainer.params)
    r = np.random.RandomState(7)
    params["denoiser"] = dict(params["denoiser"])
    params["denoiser"]["output_projection"] = {
        "kernel": r.randn(1, 8, 80).astype(np.float32) * 0.1,
        "bias": np.zeros((80,), np.float32)}
    jtrainer.params = jax.tree_util.tree_map(jnp.asarray, params)
    jtrainer.opt_state = jtrainer.tx.init(partition_params(jtrainer.params,
                                                           jtrainer.mask)[0])
    state_dict = {k: v.numpy() for k, v in task_state_dict(params).items()}
    draws, j_losses = [], []
    for i in range(STEPS):
        rng = jax.random.PRNGKey(100 + i)
        draws.append(_jax_draws(rng, padded["mels"].shape, hp["K_step"]))
        j_losses.append({k: float(v) for k, v in jtrainer.train_step(batch, rng).items()})
    j_params = task_state_dict(jax.device_get(jtrainer.params))

    base = {"hp": hp, "vocab": VOCAB, "state_dict": state_dict, "steps": STEPS}
    dp = dict(base, batch=batch, draws=draws, num_data=2)
    drop_hp = dict(hp, dropout=0.1, predictor_dropout=0.2)
    dp_drop = dict(base, hp=drop_hp, batch=batch, draws=None, num_data=2)
    pe_hp = tiny_hparams(data_dir, task_cls="pe", hidden_size=16, predictor_hidden=8,
                         predictor_dropout=0.1)
    pe_sd = {k: v.numpy() for k, v in mesh_check.build_task(
        {"hp": pe_hp}, "cpu").state_dict().items()}
    pe = {"hp": pe_hp, "state_dict": pe_sd, "steps": STEPS, "batch": batch,
          "num_data": 2}
    x = np.random.RandomState(1).randn(4, 5, 6).astype(np.float32)
    w = np.random.RandomState(2).randn(4, 5, 6).astype(np.float32)
    voc = HifiGAN(VOC_HP, device="cpu")
    g = torch.Generator().manual_seed(3)
    voc_sd = {k: (torch.randn(v.shape, generator=g) * 0.1).numpy()
              for k, v in voc.model.state_dict().items()}
    requests = [({"txt_tokens": batch["txt_tokens"][i:i + 1],
                  "mel2ph": batch["mel2ph"][i:i + 1]}, int(batch["mel2ph"].shape[1]))
                for i in (0, 1, 2, 0)]
    serve = dict(base, voc_hp=VOC_HP, voc_sd=voc_sd, requests=requests, use_gt_dur=True)
    dp_runs = mesh_check.spawn_ranks(mesh_check.jobs, 2, {"jobs": [
        ("dp", "train", dp), ("dp_drop", "train", dp_drop), ("pe", "train", pe),
        ("bn", "batchnorm", {"x": x, "w": w}), ("serve", "serve", serve)]})

    one = {"dp": mesh_check.train(0, 1, dict(dp, batch=padded, num_data=1)),
           "dp_drop": mesh_check.train(0, 1, dict(dp_drop, batch=padded, num_data=1)),
           "pe": mesh_check.train(0, 1, dict(pe, batch=padded, num_data=1)),
           "serve": mesh_check.serve(0, 1, serve)}
    tp_hp = dict(hp, num_model_shards=2, tp_min_param_size=64)
    infer_noise = np.random.RandomState(5).randn(
        hp["K_step"] + 1, *batch["mels"].shape).astype(np.float32)
    tp = dict(base, hp=tp_hp, batch=batch, draws=[(t[:3], n[:3]) for t, n in draws],
              num_data=1, num_model=2, infer_noise=infer_noise)
    one["tp"] = mesh_check.train(0, 1, dict(tp, hp=hp, num_model=1))
    names = sorted(tmesh.param_shardings(mesh_check.build_task(base, "cpu"), 2, 64))
    tp_runs = mesh_check.spawn_ranks(mesh_check.train, 2, dict(
        tp, work_dir=str(tmp / "tp2"), sharded_names=names))
    dptp = dict(tp, batch=batch, draws=draws, num_data=2, sharded_names=names)
    dptp_runs = mesh_check.spawn_ranks(mesh_check.train, 4, dptp)
    one["dptp"] = mesh_check.train(0, 1, dict(dptp, hp=hp, batch=padded, infer_batch=batch,
                                              num_data=1, num_model=1))
    return {"hp": hp, "batch": batch, "padded": padded, "params": params,
            "j_losses": j_losses, "j_params": j_params, "dp": dp_runs, "one": one,
            "tp": tp_runs, "dptp": dptp_runs, "names": names, "x": x, "w": w,
            "tmp": tmp, "tp_spec": tp}


def _close(a, b, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=msg)


def _losses(run, key="total_loss"):
    return np.array([s[key] for s in run["losses"]])


def _same_state(a, b, rtol, atol):
    assert set(a) == set(b)
    for k in a:
        _close(a[k], b[k], rtol, atol, k)


# ---------------------------------------------------------------- placement
def test_row_spans_and_padding_equal_jax():
    """Each rank's rows are the rows JAX's batch sharding gives the device at
    the same mesh position, and the padding equals JAX's, nsamples too."""
    for num_data, num_model in ((2, 1), (4, 2), (2, 4), (8, 1)):
        jm = jmesh.make_mesh(num_data=num_data, num_model=num_model,
                             devices=jax.devices()[:num_data * num_model])
        index = jmesh.batch_sharding(jm).devices_indices_map((16, 3))
        for pos, dev in np.ndenumerate(jm.devices):
            s = index[dev][0]
            rank = pos[0] * num_model + pos[1]
            assert tmesh.row_span(16, num_data, rank // num_model) == (s.start or 0, s.stop)
    rng = np.random.RandomState(0)
    batch = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randint(0, 5, (3,)),
             "c": rng.randn(5), "name": "x"}
    for multiple in (1, 2, 4):
        want, got = jmesh.pad_batch_for_sharding(batch, multiple), \
            tmesh.pad_batch_for_sharding(batch, multiple)
        assert set(want) == set(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="pad the batch"):
        tmesh.row_span(3, 2, 0)


def test_shard_batch_takes_contiguous_rows():
    mesh = tmesh.Mesh(num_data=2, num_model=2, rank=3)  # data index 1
    batch = {"x": np.arange(8).reshape(4, 2), "n": 5, "y": np.arange(3)}
    out = tmesh.shard_batch(mesh, batch)
    np.testing.assert_array_equal(out["x"], [[4, 5], [6, 7]])
    assert out["n"] == 5 and out["y"].shape == (3,)


def test_param_shardings_pick_the_jax_rule_through_from_jax(world):
    """JAX's rule on the same tiny model (data 4 x model 2, min size 64)
    marks each sharded leaf with its last-axis index; mapped through
    from_jax, the port's rule picks the same names and the torch dim those
    indices run along."""
    hp = world["hp"]
    params = world["params"]
    shardings = jmesh.param_shardings(params, jmesh.make_mesh(num_data=4, num_model=2),
                                      min_size=64)
    marked = jax.tree_util.tree_map(
        lambda x, s: (np.broadcast_to(np.arange(1, x.shape[-1] + 1), x.shape)
                      if "model" in str(s.spec) else np.zeros(x.shape)).astype(np.float32),
        params, shardings)
    want = {}
    for name, t in task_state_dict(marked).items():
        if float(t.max()) > 0:
            varies = [d for d in range(t.ndim) if t.shape[d] > 1
                      and not torch.equal(t.narrow(d, 0, 1).expand_as(t), t)]
            assert len(varies) == 1, name
            want[name] = varies[0]
    task = DiffSingerTask(hp, VOCAB, device="cpu")
    got = tmesh.param_shardings(task, 2, min_size=64)
    assert want and got == want
    assert tmesh.param_shardings(task, 1, min_size=64) == {}


# ---------------------------------------------------------------- data parallel
def test_dp_training_equals_one_process_and_jax(world):
    """Two ranks on a 3-row batch (padded to 4) against the port in one
    process on the padded batch, and against JAX's data=2 trainer."""
    dp, one = world["dp"], world["one"]["dp"]
    for rank in dp:
        r = rank["dp"]
        assert set(r["losses"][0]) == set(one["losses"][0])
        for key in one["losses"][0]:
            _close(_losses(r, key), _losses(one, key), 1e-6, 1e-7, key)
        _same_state(r["state_dict"], one["state_dict"], 1e-6, 1e-7)
        for n in one["grads"]:
            g, w = r["grads"][n], one["grads"][n]
            assert np.linalg.norm(g - w) <= 1e-6 * max(np.linalg.norm(w), 1e-12), n
    for key in ("total_loss", "mel", "pdur", "sdur", "f0", "uv", "grad_norm"):
        _close(_losses(dp[0]["dp"], key), [s[key] for s in world["j_losses"]], 1e-4,
               msg=key)
    for k, w in world["j_params"].items():
        _close(dp[0]["dp"]["state_dict"][k], w.numpy(), 0, 1e-5, k)


def test_dp_global_draws_equal_one_process(world):
    """Dropout masks, diffusion steps and noise drawn by the trainer's
    generator for the global batch and sliced: two ranks equal one process
    (dropout 0.1, predictor dropout 0.2)."""
    one = world["one"]["dp_drop"]
    for rank in world["dp"]:
        r = rank["dp_drop"]
        _close(_losses(r), _losses(one), 1e-6)
        _same_state(r["state_dict"], one["state_dict"], 1e-6, 1e-7)
    # the draws matter: the step losses differ from the dropout-free run's
    assert abs(_losses(one)[0] - _losses(world["one"]["dp"])[0]) > 1e-4


def test_pe_training_under_dp_syncs_batchnorm_statistics(world):
    """PitchExtractionTask on two ranks: the BatchNorm statistics (sum, sum of
    squares, count over the global batch) and the running statistics equal
    one process, on both ranks."""
    one = world["one"]["pe"]
    stats = [k for k in one["state_dict"] if "running_" in k]
    assert len(stats) == 6
    for rank in world["dp"]:
        r = rank["pe"]
        _close(_losses(r)[0], _losses(one)[0], 1e-6)
        # relative L2 1e-4: the three float32 batch norms' backward cancels
        # (their mean subtraction, the fast variance E[x^2] - E[x]^2), so the
        # gradients move with the summation order of the statistics alone
        for n in one["grads"]:
            g, w = r["grads"][n], one["grads"][n]
            assert np.linalg.norm(g - w) <= 1e-4 * max(np.linalg.norm(w), 1e-12), n
        for k in stats:  # after one step: summation order only
            _close(r["buffers_1"][k], one["buffers_1"][k], 1e-6, 1e-7, k)
            np.testing.assert_array_equal(r["buffers_1"][k], world["dp"][0]["pe"]["buffers_1"][k])
        # later steps are not held to one process: the conv biases in front
        # of the batch norms get a zero gradient in exact arithmetic, so
        # float32 noise drives their AdamW updates (g / (|g| + eps)). The
        # ranks still hold identical statistics after every step.
        for k in stats:
            np.testing.assert_array_equal(r["state_dict"][k],
                                          world["dp"][0]["pe"]["state_dict"][k])
    # the statistics moved from their initial values
    assert not np.allclose(one["state_dict"][stats[0]], 0)


def test_batchnorm_tbc_under_dp_equals_global_batch(world):
    x, w = world["x"], world["w"]
    xt = torch.from_numpy(x).requires_grad_(True)
    bn = BatchNorm1dTBC(6)
    y = bn(xt, train=True)
    (y * torch.from_numpy(w)).sum().backward()
    got_y = np.concatenate([r["bn"]["y"] for r in world["dp"]])
    got_dx = np.concatenate([r["bn"]["dx"] for r in world["dp"]])
    _close(got_y, y.detach().numpy(), 1e-5, 1e-6)
    _close(got_dx, xt.grad.numpy(), 1e-5, 1e-6)
    for r in world["dp"]:
        _close(r["bn"]["running_mean"], bn.running_mean.numpy(), 1e-5, 1e-7)
        _close(r["bn"]["running_var"], bn.running_var.numpy(), 1e-5, 1e-7)


def test_dp_serving_equals_one_rank(world):
    """FusedSynthesizer over two data ranks (2 rows each, the noise drawn for
    the global batch) returns every waveform, equal to one rank's."""
    one = world["one"]["serve"]["wavs"]
    for rank in world["dp"]:
        got = rank["serve"]["wavs"]
        assert len(got) == len(one) == 4
        for a, b in zip(got, one):
            assert a.shape == b.shape
            _close(a, b, 1e-5, 1e-5)
    # request 3 repeats request 0 within one batch, with its own noise rows
    assert not np.allclose(one[0], one[3])


# ---------------------------------------------------------------- tensor parallel
def test_tp2_equals_tp1_and_shards_by_the_rule(world):
    tp, one = world["tp"], world["one"]["tp"]
    names = world["names"]
    assert names, "the rule shards nothing at this size"
    for r in tp:
        _close(_losses(r), _losses(one), 5e-5, 1e-5)
        _close(r["mel"], one["mel"], 1e-4, 5e-4)
        _same_state(r["state_dict"], one["state_dict"], 1e-5, 1e-6)
        assert sorted(r["sharded"]) == names
        whole = one["state_dict"]
        for n, (dim, shape) in r["sharded"].items():
            want = list(whole[n].shape)
            want[dim] //= 2
            assert list(shape) == want, n
    # each rank holds half of the sharded parameters and their moments
    assert tp[0]["resident_bytes"] == tp[1]["resident_bytes"]
    assert tp[0]["resident_bytes"] * 2 == world["one"]["dptp"]["resident_bytes"]


def test_dp2_tp2_on_four_ranks_equals_one_process(world):
    runs, one = world["dptp"], world["one"]["dptp"]
    assert [r["mesh"] for r in runs] == [
        f"Mesh(data=2, model=2, rank={i}, backend=gloo)" for i in range(4)]
    for r in runs:
        _close(_losses(r), _losses(one), 5e-5, 1e-5)
        _close(r["mel"], one["mel"], 1e-4, 5e-4)
        _same_state(r["state_dict"], one["state_dict"], 1e-5, 1e-6)
        assert len(r["sharded"]) == len(world["names"])


def test_tp2_checkpoint_reloads_in_one_process(world):
    """Rank 0 of the tp=2 run saved the whole parameters and moments in the
    one-process layout: a one-process trainer restores it (a full resume)
    and its weights and inference mel equal the tp run's."""
    tp = world["tp"]
    assert tp[0]["ckpt"] and tp[1]["ckpt"] is None
    spec = world["tp_spec"]
    task = mesh_check.build_task(dict(spec, hp=world["hp"]), "cpu")
    trainer = Trainer(world["hp"], task, device="cpu", work_dir=str(world["tmp"] / "tp2"))
    trainer.initialize()
    assert trainer.global_step == STEPS and trainer.optimizer.num_updates == STEPS
    sd = {k: v.numpy() for k, v in task.state_dict().items()}
    _same_state(sd, tp[0]["state_dict"], 0, 0)
    assert all(len(s) == 3 for s in trainer.optimizer.adamw.state.values())
    gen = torch.Generator().manual_seed(0)
    mel = task.inference(spec["batch"], use_gt_dur=True, use_gt_f0=True,
                         noise=torch.as_tensor(spec["infer_noise"]), generator=gen)
    _close(mel["mel_out"].numpy(), tp[0]["mel"], 0, 1e-6)


# ---------------------------------------------------------------- entry points
def test_outside_a_group_the_helpers_are_the_plain_means():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(3, 4).astype(np.float32))
    w = torch.from_numpy((rng.rand(3, 4) > 0.5).astype(np.float32))
    assert torch.equal(tmesh.global_mean(x), x.mean())
    assert torch.equal(tmesh.masked_mean(x, w), (x * w).sum() / torch.clamp(w.sum(), min=1))
    assert torch.equal(tmesh.batch_means([x], (0,))[0], x.mean(0))
    g = torch.Generator().manual_seed(0)
    want = torch.rand((3, 4), generator=torch.Generator().manual_seed(0))
    with tmesh.make_mesh().active():  # a 1 x 1 mesh: no group, no change
        assert torch.equal(tmesh.draw(torch.rand, (3, 4), generator=g), want)


def test_device_and_launch_rules(monkeypatch):
    """Without torchrun's environment no group starts; a CUDA rank without its
    card raises; the trainer refuses a model axis without ranks for it."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert cli.maybe_init_distributed({}, device="cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "2")
    for k in ("RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        cli.maybe_init_distributed({}, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="absent"):
        resolve_device("cuda:1")
    assert resolve_device("cpu").type == "cpu"
    task = DiffSingerTask(tiny_hparams("unused"), VOCAB, device="cpu")
    with pytest.raises(AssertionError, match="mesh"):
        Trainer(dict(tiny_hparams("unused"), num_model_shards=2), task, device="cpu")


def test_parallel_modules_import_no_jax():
    """The port's rules test walks every file of the package; parallel/ and
    the rank workers are among them and import torch only."""
    import ast

    for rel in ("parallel/__init__.py", "parallel/mesh.py", "parallel/tensor_parallel.py",
                "tools/mesh_check.py"):
        tree = ast.parse((ROOT / "diffsinger_tpu_torch" / rel).read_text())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        mods += [n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module]
        assert not [m for m in mods if m.split(".")[0] in ("jax", "flax", "diffsinger_tpu")]

