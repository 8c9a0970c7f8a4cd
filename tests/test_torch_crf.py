"""The port's linear-chain CRF and the ``dur_loss: crf`` duration head against
the JAX package (diffsinger_tpu/ops/crf.py, models/predictors.py,
training/losses.py).

Inputs are numpy-seeded and shared; the FS2 weights go across through
``convert/from_jax.py``. Tolerances: score and log-partition atol 1e-5; the
Viterbi path and ``dur_choice`` exactly; the NLL's gradients rtol 1e-4, atol
1e-5; FS2 outputs atol 5e-5 (module parity); the task's loss terms rtol
1e-5 and its gradients as tests/test_torch_fs2_task.py holds them.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as g
from diffsinger_tpu.models import fs2 as jfs2
from diffsinger_tpu.ops import crf as jcrf
from diffsinger_tpu.training.tasks import FastSpeech2Task as JFS2Task
from diffsinger_tpu_torch.convert.from_jax import fs2_state_dict, task_state_dict
from diffsinger_tpu_torch.models import fs2 as tfs2
from diffsinger_tpu_torch.ops import crf as tcrf
from diffsinger_tpu_torch.training.tasks import FastSpeech2Task
from tests import test_torch_cwt_train as cwt_case

torch.set_num_threads(1)
K = 32


def _crf_inputs(seed=0, b=5, t=9, k=K):
    rng = np.random.RandomState(seed)
    emissions = rng.randn(b, t, k).astype(np.float32)
    lengths = [t, 6, 1, 3, 0]  # the last row is all padding but its forced first step
    mask = np.zeros((b, t), bool)
    for i, n in enumerate(lengths[:b]):
        mask[i, :n] = True
    mask[:, 0] = True
    tags = rng.randint(0, k, size=(b, t)).astype(np.int64)
    tables = [rng.uniform(-0.5, 0.5, size=s).astype(np.float32) for s in ((k,), (k,), (k, k))]
    return emissions, mask, tags, tables


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_crf_score_partition_and_viterbi_match_jax():
    em, mask, tags, tables = _crf_inputs()
    j_args = [jnp.asarray(a) for a in tables]
    t_args = _t(*tables)
    np.testing.assert_allclose(
        tcrf.crf_score(*_t(em, tags, mask), *t_args).numpy(),
        np.asarray(jcrf.crf_score(jnp.asarray(em), jnp.asarray(tags), jnp.asarray(mask),
                                  *j_args)), atol=1e-5)
    np.testing.assert_allclose(
        tcrf.crf_log_partition(*_t(em, mask), *t_args).numpy(),
        np.asarray(jcrf.crf_log_partition(jnp.asarray(em), jnp.asarray(mask), *j_args)),
        atol=1e-5)
    want = np.asarray(jcrf.crf_viterbi(jnp.asarray(em), jnp.asarray(mask), *j_args))
    got = tcrf.crf_viterbi(*_t(em, mask), *t_args).numpy()
    np.testing.assert_array_equal(got, want)
    # padded steps repeat the last valid tag
    assert (got[1, 6:] == got[1, 5]).all() and (got[4] == got[4, 0]).all()


def test_crf_ties_take_the_first_index_as_jax():
    """Equal emissions and tables: every candidate ties, and both sides pick
    tag 0 at every step."""
    em = np.zeros((2, 4, 5), np.float32)
    mask = np.ones((2, 4), bool)
    tables = [np.zeros(5, np.float32), np.zeros(5, np.float32), np.zeros((5, 5), np.float32)]
    want = np.asarray(jcrf.crf_viterbi(jnp.asarray(em), jnp.asarray(mask),
                                       *[jnp.asarray(a) for a in tables]))
    got = tcrf.crf_viterbi(*_t(em, mask), *_t(*tables)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).all()
    assert (tcrf.crf_viterbi_gap(*_t(em, mask), *_t(*tables)) == 0).all()


def test_crf_viterbi_gap_and_partition_by_enumeration():
    """On 3 tags x 4 steps every path is enumerated in float64: the Viterbi
    path is the best, ``crf_viterbi_gap`` the best minus the second best,
    log Z the logsumexp of all path scores."""
    rng = np.random.RandomState(3)
    b, t, k = 3, 4, 3
    for _ in range(5):
        em = torch.from_numpy(rng.randn(b, t, k))
        tables = _t(rng.randn(k), rng.randn(k), rng.randn(k, k))
        mask = torch.tensor([[1, 1, 1, 1], [1, 1, 0, 0], [1, 0, 0, 0]], dtype=torch.bool)
        path = tcrf.crf_viterbi(em, mask, *tables)
        gap = tcrf.crf_viterbi_gap(em, mask, *tables)
        log_z = tcrf.crf_log_partition(em, mask, *tables)
        for i in range(b):
            n = int(mask[i].sum())
            scores = sorted(
                ((tcrf.crf_score(em[i:i + 1], torch.tensor([list(p) + [p[-1]] * (t - n)]),
                                 mask[i:i + 1], *tables).item(), p)
                 for p in itertools.product(range(k), repeat=n)), reverse=True)
            assert tuple(path[i, :n].tolist()) == scores[0][1]
            assert abs(scores[0][0] - scores[1][0] - gap[i].item()) < 1e-9
            want_z = torch.logsumexp(torch.tensor([s for s, _ in scores], dtype=torch.float64), 0)
            assert abs(want_z.item() - log_z[i].item()) < 1e-9


def test_crf_nll_gradients_match_jax():
    em, mask, tags, tables = _crf_inputs(1)

    def j_nll(em_, start, end, trans):
        ll = (jcrf.crf_score(em_, jnp.asarray(tags), jnp.asarray(mask), start, end, trans)
              - jcrf.crf_log_partition(em_, jnp.asarray(mask), start, end, trans))
        return -ll.mean()

    want = jax.grad(j_nll, argnums=(0, 1, 2, 3))(jnp.asarray(em),
                                                  *[jnp.asarray(a) for a in tables])
    crf = tcrf.LinearChainCRF(K)
    with torch.no_grad():
        for p, a in zip(crf.tables(), tables):
            p.copy_(torch.from_numpy(a))
    em_t = torch.from_numpy(em).requires_grad_(True)
    (-crf.log_likelihood(em_t, *_t(tags, mask)).mean()).backward()
    for got, w in zip([em_t.grad, *(p.grad for p in crf.tables())], want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_crf_init_from_a_generator():
    a = tcrf.LinearChainCRF(K, generator=torch.Generator().manual_seed(4))
    b = tcrf.LinearChainCRF(K, generator=torch.Generator().manual_seed(4))
    for p, q in zip(a.tables(), b.tables()):
        assert torch.equal(p, q) and p.abs().max() <= 0.1
    assert [n for n, _ in a.named_parameters()] == ["start_transitions", "end_transitions",
                                                    "transitions"]


# ---------------------------------------------------------------- the head
VOCAB, B, T_TXT = 20, 3, 12
HP = {"hidden_size": 32, "enc_layers": 2, "dec_layers": 2, "num_heads": 2,
      "enc_ffn_kernel_size": 9, "dec_ffn_kernel_size": 9, "ffn_act": "gelu",
      "predictor_hidden": -1, "predictor_layers": 2, "predictor_kernel": 5,
      "dur_predictor_layers": 2, "dur_predictor_kernel": 3, "dropout": 0.0,
      "predictor_dropout": 0.0, "use_pitch_embed": True, "pitch_type": "frame",
      "use_uv": True, "pitch_norm": "log", "audio_num_mel_bins": 16, "dur_loss": "crf"}


def _head_model():
    rng = np.random.RandomState(0)
    tokens = rng.randint(3, VOCAB, size=(B, T_TXT)).astype(np.int64)
    tokens[1, 8:] = 0
    tokens[2, 3:] = 0
    jm = jfs2.FastSpeech2(jfs2.FS2Config.from_hparams(HP, VOCAB))
    params = jax.jit(lambda k: jm.init(k, jnp.asarray(tokens), infer=True, t_mel=48))(
        jax.random.PRNGKey(0))["params"]
    p = jax.tree_util.tree_map(np.array, params)
    lin = p["dur_predictor"]["linear"]  # emissions that favour 1-4 frames a phone
    lin["kernel"] *= 3.0
    lin["bias"][:] = -2.0
    lin["bias"][1:5] = [1.0, 1.5, 1.2, 0.8]
    crf = p["dur_predictor"]["crf"]
    for name in ("start_transitions", "end_transitions", "transitions"):
        crf[name] = rng.uniform(-0.5, 0.5, size=crf[name].shape).astype(np.float32)
    tm = tfs2.FastSpeech2(tfs2.FS2Config.from_hparams(HP, VOCAB))
    tm.load_state_dict(fs2_state_dict(p), strict=True)
    return jm, p, tm.eval(), tokens


def test_crf_head_inference_matches_jax():
    jm, params, tm, tokens = _head_model()
    want = jm.apply({"params": params}, jnp.asarray(tokens), infer=True, t_mel=48)
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens), t_mel=48)
    assert got["dur"].shape == (B, T_TXT, K)
    dur = got["dur_choice"].numpy()
    np.testing.assert_array_equal(dur, np.asarray(want["dur_choice"]))
    np.testing.assert_array_equal(got["mel2ph"].numpy(), np.asarray(want["mel2ph"]))
    assert (dur[tokens == 0] == 0).all() and len(np.unique(dur[tokens > 0])) > 2
    for key in ("dur", "decoder_inp", "mel_out"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=5e-5,
                                   err_msg=key)
    # no near-tie could have flipped the decision
    valid = torch.from_numpy(tokens != 0)
    valid[:, 0] = True
    gap = tcrf.crf_viterbi_gap(got["dur"], valid, *tm.dur_predictor.crf.tables())
    assert gap.min() > 1e-3


def test_crf_task_loss_and_gradients_match_jax():
    """FastSpeech2Task with ``dur_loss: crf``: ``pdur`` is the CRF NLL of the
    clamped durations, the word and sentence terms are skipped, and every
    gradient (the CRF tables included) matches JAX's."""
    hp = g._tiny_hp()
    hp.update(hidden_size=32, task_cls="fs2", pitch_type="frame", mel_loss="l1",
              dur_loss="crf")
    batch = cwt_case.make_batch("frame")
    jtask = JFS2Task(hp, 16, sil_ids=(3,))
    params = jtask.init_params(jax.random.PRNGKey(0), batch)
    (j_total, j_losses), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jtask.train_loss(p, batch, jax.random.PRNGKey(5), deterministic=True),
        has_aux=True))(params)
    task = FastSpeech2Task(hp, 16, device="cpu", sil_ids=(3,))
    task.load_state_dict(task_state_dict(jax.device_get(params)), strict=True)
    trainable = dict(task.set_trainable())
    task.zero_grad(set_to_none=True)
    total, losses = task.train_loss(batch, deterministic=True)
    total.backward()
    assert set(losses) == set(j_losses) == {"l1", "uv", "f0", "pdur"}
    for k in losses:
        np.testing.assert_allclose(float(losses[k].detach()), float(j_losses[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(j_total), rtol=1e-5)
    want = task_state_dict(jax.device_get(j_grads))
    assert {"fs2.dur_predictor.crf.transitions", "fs2.dur_predictor.crf.start_transitions",
            "fs2.dur_predictor.crf.end_transitions"} <= set(want) == set(trainable)
    for name, w in want.items():
        grad = trainable[name].grad
        got = np.zeros_like(w.numpy()) if grad is None else grad.numpy()
        scale = max(1.0, float(np.abs(w.numpy()).max()))
        np.testing.assert_allclose(got / scale, w.numpy() / scale, rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    assert trainable["fs2.dur_predictor.crf.transitions"].grad.abs().max() > 0


@pytest.mark.parametrize("dur_loss", ["huber", "mog"])
def test_only_the_crf_head_holds_a_crf(dur_loss):
    m = tfs2.FastSpeech2(tfs2.FS2Config.from_hparams({**HP, "dur_loss": dur_loss}, VOCAB))
    assert not hasattr(m.dur_predictor, "crf")
