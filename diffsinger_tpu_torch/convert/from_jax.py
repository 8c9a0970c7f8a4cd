"""Weight bridge from the JAX package's parameter trees to the port.

Input: nested dicts of arrays (anything ``numpy.asarray`` accepts) as the
flax modules of ``diffsinger_tpu`` hold them. Output: ``state_dict``s with
the upstream torch keys the port's modules use. Layouts:
  * Dense          [in, out]       -> Linear weight [out, in]
  * Conv           [k, in, out]    -> Conv1d weight [out, in, k]
  * ConvTranspose  [k, C_out, C_in] -> ConvTranspose1d weight [C_in, C_out, k]
    (the JAX module applies torch semantics, so no kernel flip)
  * grouped Conv   [k, in / g, out] -> Conv1d weight [out, in / g, k]
  * 2-D Conv       [kh, kw, in, out] -> Conv2d weight [out, in, kh, kw]
  * LayerNorm / GroupNorm / BatchNorm scale -> weight; embeddings and biases
    unchanged; BatchNorm ``batch_stats`` mean / var -> running_mean /
    running_var.
Key names follow the upstream torch checkpoints
(diffsinger_tpu/convert/torch_names.py maps the same pairs the other way).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

Rule = Tuple[str, str, Optional[Callable[[np.ndarray], np.ndarray]]]


def _linear(w: np.ndarray) -> np.ndarray:
    return w.T


def _conv(w: np.ndarray) -> np.ndarray:
    return w.transpose(2, 1, 0)


_conv_transpose = _conv  # [k, C_out, C_in] -> [C_in, C_out, k]


def _conv_nd(w: np.ndarray) -> np.ndarray:
    """A 1-D or a 2-D conv kernel."""
    return w.transpose(3, 2, 0, 1) if w.ndim == 4 else _conv(w)


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """{'a': {'b': x}} -> {'a/b': array}."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flatten(v, path))
        else:
            out[path] = np.asarray(v, dtype=np.float32)
    return out


def apply_rules(tree: Dict[str, Any], rules: List[Rule],
                prefix: str = "") -> Dict[str, torch.Tensor]:
    """Translate a JAX tree with ``rules``; every leaf must match one rule."""
    sd: Dict[str, torch.Tensor] = {}
    compiled = [(re.compile("^" + p + "$"), t, f) for p, t, f in rules]
    for path, val in flatten(tree).items():
        for rx, target, fn in compiled:
            if rx.match(path):
                arr = fn(val) if fn else val
                sd[prefix + rx.sub(target, path)] = torch.from_numpy(np.array(arr))
                break
        else:
            raise KeyError(f"no torch key for JAX parameter {path}")
    return sd


def _fft_rules(blocks: str = r"(encoder|decoder)/blocks/", to: str = r"\1.") -> List[Rule]:
    """An FFT stack's layers, final norm and position scale; ``blocks``
    matches the JAX path of its FFTBlocks, ``to`` is the torch prefix."""
    n = blocks.count("(") + 1  # the group of the layer index
    blk = blocks + r"layers_(\d+)/"
    op = to + rf"layers.\{n}.op."
    return [
        (blk + r"layer_norm(1|2)/scale", op + rf"layer_norm\{n + 1}.weight", None),
        (blk + r"layer_norm(1|2)/bias", op + rf"layer_norm\{n + 1}.bias", None),
        (blk + r"self_attn/in_proj/kernel", op + "self_attn.in_proj_weight", _linear),
        (blk + r"self_attn/out_proj/kernel", op + "self_attn.out_proj.weight", _linear),
        (blk + r"ffn/ffn_1/kernel", op + "ffn.ffn_1.weight", _conv),
        (blk + r"ffn/ffn_1/bias", op + "ffn.ffn_1.bias", None),
        (blk + r"ffn/ffn_2/kernel", op + "ffn.ffn_2.weight", _linear),
        (blk + r"ffn/ffn_2/bias", op + "ffn.ffn_2.bias", None),
        (blocks + r"layer_norm/scale", to + "layer_norm.weight", None),
        (blocks + r"layer_norm/bias", to + "layer_norm.bias", None),
        (blocks + r"pos_embed_alpha", to + "pos_embed_alpha", None),
    ]


def _fft_stats_rules(blocks: str = "", to: str = "") -> List[Rule]:
    """The ``batch_stats`` of an FFT stack built with ``norm='bn'``: each
    ``BatchNorm1dTBC``'s mean and var -> running_mean / running_var."""
    n = blocks.count("(") + 1
    blk = blocks + r"layers_(\d+)/"
    op = to + rf"layers.\{n}.op."
    return [
        (blk + r"layer_norm(1|2)/mean", op + rf"layer_norm\{n + 1}.running_mean", None),
        (blk + r"layer_norm(1|2)/var", op + rf"layer_norm\{n + 1}.running_var", None),
        (blocks + r"layer_norm/mean", to + "layer_norm.running_mean", None),
        (blocks + r"layer_norm/var", to + "layer_norm.running_var", None),
    ]


# the decoder layer (JAX ``DecSALayer``): self-attention, cross-attention
# (``q_proj`` / ``kv_proj`` / ``out_proj``) and the causal conv FFN
DEC_SA_RULES: List[Rule] = [
    (r"layer_norm(1|2|3)/scale", r"layer_norm\1.weight", None),
    (r"layer_norm(1|2|3)/bias", r"layer_norm\1.bias", None),
    (r"self_attn/in_proj/kernel", "self_attn.in_proj_weight", _linear),
    (r"self_attn/out_proj/kernel", "self_attn.out_proj.weight", _linear),
    (r"encoder_attn/(q_proj|kv_proj|out_proj)/kernel", r"encoder_attn.\1.weight", _linear),
    (r"ffn/(ffn_1)/kernel", r"ffn.\1.weight", _conv),
    (r"ffn/(ffn_2)/kernel", r"ffn.\1.weight", _linear),
    (r"ffn/(ffn_1|ffn_2)/bias", r"ffn.\1.bias", None),
]


def _predictor_rules(names: str = "dur_predictor|pitch_predictor|energy_predictor",
                     to: str = r"\1") -> List[Rule]:
    pr = rf"({names})/"
    return [
        (pr + r"conv_(\d+)/conv/kernel", to + r".conv.\2.1.weight", _conv),
        (pr + r"conv_(\d+)/conv/bias", to + r".conv.\2.1.bias", None),
        (pr + r"conv_(\d+)/norm/scale", to + r".conv.\2.3.weight", None),
        (pr + r"conv_(\d+)/norm/bias", to + r".conv.\2.3.bias", None),
        (pr + r"linear/kernel", to + r".linear.weight", _linear),
        (pr + r"linear/bias", to + r".linear.bias", None),
        (pr + r"pos_embed_alpha", to + r".pos_embed_alpha", None),
    ]


def _dense(jax_name: str, torch_name: str) -> List[Rule]:
    return [(jax_name + "/kernel", torch_name + ".weight", _linear),
            (jax_name + "/bias", torch_name + ".bias", None)]


# upstream names (modules/fastspeech/fs2.py): cwt_predictor.0 is the CWT input
# projection and .1 its predictor, cwt_stats_layers.0/2/4 the statistics MLP;
# spk_embed_proj is an embedding with use_spk_id and a Linear with use_spk_embed
FS2_RULES: List[Rule] = [
    (r"encoder/embed_tokens/embedding", "encoder.embed_tokens.weight", None),
    (r"(pitch_embed|energy_embed|midi_embed|is_slur_embed|spk_embed_proj|spk_embed_f0"
     r"|spk_embed_dur)/embedding", r"\1.weight", None),
    *_dense("(mel_out|midi_dur_layer|spk_embed_proj)", r"\1"),
    *_dense("cwt_in_proj", "cwt_predictor.0"), *_dense("cwt_stats_0", "cwt_stats_layers.0"),
    *_dense("cwt_stats_1", "cwt_stats_layers.2"), *_dense("cwt_stats_2", "cwt_stats_layers.4"),
    # the dur_loss: crf head's CRF, torchcrf's names
    (r"dur_predictor/crf/(start_transitions|end_transitions|transitions)",
     r"dur_predictor.crf.\1", None),
] + _fft_rules() + _predictor_rules() + _predictor_rules("cwt_predictor", "cwt_predictor.1")

DIFFNET_RULES: List[Rule] = [
    (r"(input_projection|skip_projection|output_projection)/kernel", r"\1.weight", _conv),
    (r"(input_projection|skip_projection|output_projection)/bias", r"\1.bias", None),
    (r"mlp_(0|2)/kernel", r"mlp.\1.weight", _linear),
    (r"mlp_(0|2)/bias", r"mlp.\1.bias", None),
    (r"residual_(\d+)/(dilated_conv|output_projection)/kernel",
     r"residual_layers.\1.\2.weight", _conv),
    (r"residual_(\d+)/(dilated_conv|output_projection)/bias",
     r"residual_layers.\1.\2.bias", None),
    (r"step_projection_(\d+)/kernel", r"residual_layers.\1.diffusion_projection.weight",
     _linear),
    (r"step_projection_(\d+)/bias", r"residual_layers.\1.diffusion_projection.bias", None),
    (r"cond_projection_(\d+)/kernel", r"residual_layers.\1.conditioner_projection.weight",
     _conv),
    (r"cond_projection_(\d+)/bias", r"residual_layers.\1.conditioner_projection.bias",
     None),
]

HIFIGAN_RULES: List[Rule] = [
    (r"(conv_pre|conv_post)/kernel", r"\1.weight", _conv),
    (r"(conv_pre|conv_post)/bias", r"\1.bias", None),
    (r"ups_(\d+)/kernel", r"ups.\1.weight", _conv_transpose),
    (r"ups_(\d+)/bias", r"ups.\1.bias", None),
    (r"resblocks_(\d+)/convs(1|2)_(\d+)/kernel", r"resblocks.\1.convs\2.\3.weight", _conv),
    (r"resblocks_(\d+)/convs(1|2)_(\d+)/bias", r"resblocks.\1.convs\2.\3.bias", None),
    # resblock '2': one conv per dilation
    (r"resblocks_(\d+)/convs_(\d+)/kernel", r"resblocks.\1.convs.\2.weight", _conv),
    (r"resblocks_(\d+)/convs_(\d+)/bias", r"resblocks.\1.convs.\2.bias", None),
    (r"noise_convs_(\d+)/kernel", r"noise_convs.\1.weight", _conv),
    (r"noise_convs_(\d+)/bias", r"noise_convs.\1.bias", None),
    (r"m_source/l_linear/kernel", "m_source.l_linear.weight", _linear),
    (r"m_source/l_linear/bias", "m_source.l_linear.bias", None),
]

# ParallelWaveGAN: the per-scale 2D smoothing convs (HWIO [kf, kt, 1, 1]) sit
# at the odd indices of upstream's up_layers, after each stretch
PWG_RULES: List[Rule] = [
    (r"(first_conv|upsample_net/conv_in)/kernel",
     lambda m: m.group(1).replace("/", ".") + ".weight", _conv),
    (r"first_conv/bias", "first_conv.bias", None),
    (r"conv_layers_(\d+)/(conv|conv1x1_aux|conv1x1_skip|conv1x1_out)/kernel",
     r"conv_layers.\1.\2.weight", _conv),
    (r"conv_layers_(\d+)/(conv|conv1x1_skip|conv1x1_out)/bias", r"conv_layers.\1.\2.bias",
     None),
    (r"last_conv_(1|3)/kernel", r"last_conv_layers.\1.weight", _conv),
    (r"last_conv_(1|3)/bias", r"last_conv_layers.\1.bias", None),
    (r"upsample_net/up_conv_(\d+)",
     lambda m: f"upsample_net.upsample.up_layers.{2 * int(m.group(1)) + 1}.weight",
     lambda w: w.transpose(3, 2, 0, 1)),
    (r"pitch_embed/embedding", "pitch_embed.weight", None),
    *_dense("c_proj", "c_proj"),
]

# the FFT denoiser (diff_decoder_type: fft), upstream FFT of
# usr/diff/candidate_decoder.py: FastspeechDecoder keys plus its projections
FFT_DENOISER_RULES: List[Rule] = [
    (r"input_projection/kernel", "input_projection.weight", _conv),
    (r"input_projection/bias", "input_projection.bias", None),
    *_dense(r"mlp_(0|2)", r"mlp.\1"), *_dense("(get_decode_inp|get_mel_out)", r"\1"),
] + _fft_rules("blocks/", "")

PE_RULES: List[Rule] = [
    (r"mel_prenet/conv_(\d+)/kernel", r"mel_prenet.layers.\1.0.weight", _conv),
    (r"mel_prenet/conv_(\d+)/bias", r"mel_prenet.layers.\1.0.bias", None),
    (r"mel_prenet/bn_(\d+)/scale", r"mel_prenet.layers.\1.2.weight", None),
    (r"mel_prenet/bn_(\d+)/bias", r"mel_prenet.layers.\1.2.bias", None),
    (r"(mel_prenet|mel_encoder)/(in_proj|out_proj)/kernel", r"\1.\2.weight", _linear),
    (r"(mel_prenet|mel_encoder)/(in_proj|out_proj)/bias", r"\1.\2.bias", None),
    (r"mel_encoder/conv_(\d+)/kernel", r"mel_encoder.conv.\1.conv.conv.weight", _conv),
    (r"mel_encoder/conv_(\d+)/bias", r"mel_encoder.conv.\1.conv.conv.bias", None),
    (r"mel_encoder/norm_(\d+)/scale", r"mel_encoder.conv.\1.norm.weight", None),
    (r"mel_encoder/norm_(\d+)/bias", r"mel_encoder.conv.\1.norm.bias", None),
] + _predictor_rules("pitch_predictor")

PE_STATS_RULES: List[Rule] = [
    (r"mel_prenet/bn_(\d+)/mean", r"mel_prenet.layers.\1.2.running_mean", None),
    (r"mel_prenet/bn_(\d+)/var", r"mel_prenet.layers.\1.2.running_var", None),
]

# the MPD's and the MSD's discriminators (Conv2d and grouped Conv1d kernels)
HIFIGAN_DISC_RULES: List[Rule] = [
    (r"discriminators_(\d+)/convs_(\d+)/kernel", r"discriminators.\1.convs.\2.weight", _conv_nd),
    (r"discriminators_(\d+)/convs_(\d+)/bias", r"discriminators.\1.convs.\2.bias", None),
    (r"discriminators_(\d+)/conv_post/kernel", r"discriminators.\1.conv_post.weight", _conv_nd),
    (r"discriminators_(\d+)/conv_post/bias", r"discriminators.\1.conv_post.bias", None),
]


def _melgan_disc_rules(prefix: str = "", to: str = "") -> List[Rule]:
    """One MelGAN discriminator's convs; ``prefix`` matches its JAX path."""
    n = prefix.count("(") + 1  # the group of the layer's name or index
    return [
        (prefix + r"(conv_in|conv_mid|conv_out)/kernel", to + rf"\{n}.weight", _conv),
        (prefix + r"(conv_in|conv_mid|conv_out)/bias", to + rf"\{n}.bias", None),
        (prefix + r"down_(\d+)/kernel", to + rf"down.\{n}.weight", _conv),
        (prefix + r"down_(\d+)/bias", to + rf"down.\{n}.bias", None),
    ]


MELGAN_RULES: List[Rule] = [
    (r"up_(\d+)_kernel", r"ups.\1.weight", _conv_transpose),
    (r"up_(\d+)_bias", r"ups.\1.bias", None),
    (r"stack_(\d+)_(\d+)/(conv_dilated|conv_1x1|skip_1x1)/kernel", r"stacks.\1.\2.\3.weight",
     _conv),
    (r"stack_(\d+)_(\d+)/(conv_dilated|conv_1x1|skip_1x1)/bias", r"stacks.\1.\2.\3.bias",
     None),
    # the generator's conv_in / conv_out carry a single discriminator's names
] + _melgan_disc_rules() + _melgan_disc_rules(r"discriminators_(\d+)/", r"discriminators.\1.")


def fs2_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``FastSpeech2`` params -> the port's ``FastSpeech2`` state_dict."""
    return apply_rules(params, FS2_RULES)


def fft_blocks_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``FFTBlocks`` variables {'params'[, 'batch_stats']} -> the port's
    ``FFTBlocks`` state_dict (a ``norm='bn'`` stack's running statistics
    included)."""
    return {**apply_rules(variables["params"], _fft_rules("", "")),
            **apply_rules(variables.get("batch_stats") or {}, _fft_stats_rules())}


def dec_sa_layer_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``DecSALayer`` params -> the port's ``DecSALayer`` state_dict."""
    return apply_rules(params, DEC_SA_RULES)


def denoiser_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``DiffNet`` params -> the port's ``DiffNet`` state_dict."""
    return apply_rules(params, DIFFNET_RULES)


def hifigan_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``HifiGanGenerator`` params -> the port's generator state_dict."""
    return apply_rules(params, HIFIGAN_RULES)


def pwg_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``ParallelWaveGANGenerator`` params -> the port's generator state_dict."""
    return apply_rules(params, PWG_RULES)


def hifigan_disc_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``MultiPeriodDiscriminator`` or ``MultiScaleDiscriminator`` params
    -> the port's module's state_dict."""
    return apply_rules(params, HIFIGAN_DISC_RULES)


def melgan_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``MelGANGenerator``, ``MelGANDiscriminator`` or
    ``MelGANMultiScaleDiscriminator`` params -> the port's state_dict."""
    return apply_rules(params, MELGAN_RULES)


def pe_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``PitchExtractor`` variables {'params', 'batch_stats'} -> the port's
    ``PitchExtractor`` state_dict, BatchNorm running statistics included."""
    sd = {**apply_rules(variables["params"], PE_RULES),
          **apply_rules(variables["batch_stats"], PE_STATS_RULES)}
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def task_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX task params -> the port's task state_dict: {'fs2', 'denoiser'} of a
    ``DiffSingerTask`` (the WaveNet or the FFT denoiser, told apart by the
    tree), {'fs2'} of a ``FastSpeech2Task``, {'pe', 'batch_stats'} of a
    ``PitchExtractionTask``.

    Gradient trees have the parameters' structure, so this maps them too. A
    partial tree (the trainable subset of a frozen FS2, a PE's gradients
    without statistics) maps what it holds."""
    denoiser = params.get("denoiser", {})
    rules = FFT_DENOISER_RULES if "get_mel_out" in denoiser else DIFFNET_RULES
    sd = {**apply_rules(params.get("fs2", {}), FS2_RULES, "fs2."),
          **apply_rules(denoiser, rules, "denoise_fn.")}
    if "pe" in params:
        stats = params.get("batch_stats") or {}
        sd.update({"pe." + k: v for k, v in (
            pe_state_dict({"params": params["pe"], "batch_stats": stats}) if stats
            else apply_rules(params["pe"], PE_RULES)).items()})
    return sd
