"""Weight bridge from the JAX package's parameter trees to the port.

Input: nested dicts of arrays (anything ``numpy.asarray`` accepts) as the
flax modules of ``diffsinger_tpu`` hold them. Output: ``state_dict``s with
the upstream torch keys the port's modules use. Layouts:
  * Dense          [in, out]       -> Linear weight [out, in]
  * Conv           [k, in, out]    -> Conv1d weight [out, in, k]
  * ConvTranspose  [k, C_out, C_in] -> ConvTranspose1d weight [C_in, C_out, k]
    (the JAX module applies torch semantics, so no kernel flip)
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


def _fft_rules() -> List[Rule]:
    blk = r"(encoder|decoder)/blocks/layers_(\d+)/"
    op = r"\1.layers.\2.op."
    return [
        (blk + r"layer_norm(1|2)/scale", op + r"layer_norm\3.weight", None),
        (blk + r"layer_norm(1|2)/bias", op + r"layer_norm\3.bias", None),
        (blk + r"self_attn/in_proj/kernel", op + "self_attn.in_proj_weight", _linear),
        (blk + r"self_attn/out_proj/kernel", op + "self_attn.out_proj.weight", _linear),
        (blk + r"ffn/ffn_1/kernel", op + "ffn.ffn_1.weight", _conv),
        (blk + r"ffn/ffn_1/bias", op + "ffn.ffn_1.bias", None),
        (blk + r"ffn/ffn_2/kernel", op + "ffn.ffn_2.weight", _linear),
        (blk + r"ffn/ffn_2/bias", op + "ffn.ffn_2.bias", None),
        (r"(encoder|decoder)/blocks/layer_norm/scale", r"\1.layer_norm.weight", None),
        (r"(encoder|decoder)/blocks/layer_norm/bias", r"\1.layer_norm.bias", None),
        (r"decoder/blocks/pos_embed_alpha", "decoder.pos_embed_alpha", None),
    ]


def _predictor_rules(names: str = "dur_predictor|pitch_predictor") -> List[Rule]:
    pr = rf"({names})/"
    return [
        (pr + r"conv_(\d+)/conv/kernel", r"\1.conv.\2.1.weight", _conv),
        (pr + r"conv_(\d+)/conv/bias", r"\1.conv.\2.1.bias", None),
        (pr + r"conv_(\d+)/norm/scale", r"\1.conv.\2.3.weight", None),
        (pr + r"conv_(\d+)/norm/bias", r"\1.conv.\2.3.bias", None),
        (pr + r"linear/kernel", r"\1.linear.weight", _linear),
        (pr + r"linear/bias", r"\1.linear.bias", None),
        (pr + r"pos_embed_alpha", r"\1.pos_embed_alpha", None),
    ]


FS2_RULES: List[Rule] = [
    (r"encoder/embed_tokens/embedding", "encoder.embed_tokens.weight", None),
    (r"pitch_embed/embedding", "pitch_embed.weight", None),
    (r"mel_out/kernel", "mel_out.weight", _linear),
    (r"mel_out/bias", "mel_out.bias", None),
    (r"midi_embed/embedding", "midi_embed.weight", None),
    (r"midi_dur_layer/kernel", "midi_dur_layer.weight", _linear),
    (r"midi_dur_layer/bias", "midi_dur_layer.bias", None),
    (r"is_slur_embed/embedding", "is_slur_embed.weight", None),
] + _fft_rules() + _predictor_rules()

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
    (r"noise_convs_(\d+)/kernel", r"noise_convs.\1.weight", _conv),
    (r"noise_convs_(\d+)/bias", r"noise_convs.\1.bias", None),
    (r"m_source/l_linear/kernel", "m_source.l_linear.weight", _linear),
    (r"m_source/l_linear/bias", "m_source.l_linear.bias", None),
]

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


def fs2_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``FastSpeech2`` params -> the port's ``FastSpeech2`` state_dict."""
    return apply_rules(params, FS2_RULES)


def denoiser_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``DiffNet`` params -> the port's ``DiffNet`` state_dict."""
    return apply_rules(params, DIFFNET_RULES)


def hifigan_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``HifiGanGenerator`` params -> the port's generator state_dict."""
    return apply_rules(params, HIFIGAN_RULES)


def pe_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``PitchExtractor`` variables {'params', 'batch_stats'} -> the port's
    ``PitchExtractor`` state_dict, BatchNorm running statistics included."""
    sd = {**apply_rules(variables["params"], PE_RULES),
          **apply_rules(variables["batch_stats"], PE_STATS_RULES)}
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def task_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX task params {'fs2', 'denoiser'} -> ``DiffSingerTask`` state_dict.

    Gradient trees have the parameters' structure, so this maps them too. A
    partial tree (the trainable subset of a frozen FS2) maps what it holds."""
    return {**apply_rules(params.get("fs2", {}), FS2_RULES, "fs2."),
            **apply_rules(params.get("denoiser", {}), DIFFNET_RULES, "denoise_fn.")}
