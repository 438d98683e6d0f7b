"""Flax backbone parameters -> the port's ``state_dict``.

TF-GridNet (``tfgridnet_from_flax``): the port's modules keep the JAX
package's parameter packing (BiLSTM
``w_ih [2, 4C, 4H]`` tap-major, ``w_hh [2, H, 4H]``, ``bias [2, 4H]``, the
fold's ``deconv_kernel [2H, 4C]``, the attention norms' ``[H, 1]`` /
``[H, E]``), so most leaves carry over as they are. The rest is layout:

* Dense ``kernel [I, O]`` -> ``nn.Linear.weight [O, I]``;
* Conv ``kernel [kh, kw, I, O]`` -> ``nn.Conv2d.weight [O, I, kh, kw]``
  (kh runs over frames T, kw over frequency Q);
* ConvTranspose ``kernel [kh, kw, I, O]``, which Flax applies as a plain
  correlation at stride 1, -> ``nn.ConvTranspose2d.weight [I, O, kh, kw]``
  with the spatial taps flipped;
* GroupNorm ``scale`` -> ``weight``; ``block_i`` / ``time_block_i`` ->
  ``blocks.i`` / ``time_blocks.i``.

NCSN++ (``ncsnpp_from_flax``): the port's submodules carry the Flax names,
so each leaf keeps its path and only the layouts change (a Conv kernel's
``kh`` runs over frequency H here, ``kw`` over frames).
:func:`backbone_state_dict_from_flax` picks the converter by registry name.

Inputs are numpy arrays (``jax.device_get`` of the Flax tree), so this module
needs neither JAX nor Flax.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_RNN_LEAVES = ("ln_gamma", "ln_beta", "deconv_bias")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _linear(p: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(np.asarray(p["kernel"]).T),
            f"{prefix}.bias": _t(p["bias"])}


def _rnn_path(p: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    sd = {f"{prefix}.{k}": _t(p[k]) for k in _RNN_LEAVES}
    for k in ("w_ih", "w_hh", "bias"):
        sd[f"{prefix}.bilstm.{k}"] = _t(p["bilstm"][k])
    sd[f"{prefix}.deconv_kernel"] = _t(p["deconv"]["kernel"])
    return sd


def gridnet_block_from_flax(p: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """State_dict entries of one ``GridNetBlock`` from its Flax subtree,
    under ``prefix`` (e.g. ``"blocks.0."``)."""
    sd = {}
    sd.update(_rnn_path(p["intra"], f"{prefix}intra"))
    sd.update(_rnn_path(p["inter"], f"{prefix}inter"))
    for name in ("attn_conv_Q", "attn_conv_K", "attn_conv_V", "attn_proj"):
        sd.update(_linear(p[name], f"{prefix}{name}"))
    for name in ("attn_norm_Q", "attn_norm_K", "attn_norm_V"):
        for k in ("prelu_alpha", "gamma", "beta"):
            sd[f"{prefix}{name}.{k}"] = _t(p[name][k])
    sd[f"{prefix}attn_prelu.alpha"] = _t(p["attn_prelu"]["alpha"])
    sd[f"{prefix}attn_ln_gamma"] = _t(p["attn_ln_gamma"])
    sd[f"{prefix}attn_ln_beta"] = _t(p["attn_ln_beta"])
    return sd


def tfgridnet_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``TFGridNet`` state_dict from a Flax TF-GridNet parameter
    tree of numpy arrays (with or without the top-level ``"params"``), of a
    generative backbone or of a predictive twin (no time keys)."""
    p = params.get("params", params)
    sd = {
        "conv_in.weight": _t(np.asarray(p["conv_in"]["kernel"]).transpose(3, 2, 0, 1)),
        "conv_in.bias": _t(p["conv_in"]["bias"]),
        "gn_in.weight": _t(p["gn_in"]["scale"]),
        "gn_in.bias": _t(p["gn_in"]["bias"]),
        "deconv_out.weight": _t(
            np.asarray(p["deconv_out"]["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)),
        "deconv_out.bias": _t(p["deconv_out"]["bias"]),
    }
    n_layers = sum(1 for k in p if k.startswith("block_"))
    if "time_emb" in p:  # a predictive twin has no time embedding
        sd["time_emb.W"] = _t(p["time_emb"]["W"])
        for name in ("time_fc1", "time_fc2"):
            sd.update(_linear(p[name], name))
        for i in range(n_layers):
            sd.update(_linear(p[f"time_block_{i}"], f"time_blocks.{i}"))
    for i in range(n_layers):
        sd.update(gridnet_block_from_flax(p[f"block_{i}"], f"blocks.{i}."))
    return sd


def ncsnpp_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``NCSNpp`` state_dict from a Flax NCSN++ parameter tree
    of numpy arrays (with or without the top-level ``"params"``), generative
    or predictive: every leaf keeps its path (``down_0_0/conv0/kernel`` ->
    ``down_0_0.conv0.weight``); Conv ``kernel [kh, kw, I, O]`` ->
    ``[O, I, kh, kw]``, Dense ``kernel [I, O]`` -> ``[O, I]``, GroupNorm
    ``scale`` -> ``weight``."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], prefix: str) -> None:
        for name, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{name}.")
            elif name == "kernel":
                a = np.asarray(v)
                sd[f"{prefix}weight"] = _t(a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T)
            else:
                sd[f"{prefix}{'weight' if name == 'scale' else name}"] = _t(v)

    walk(params.get("params", params), "")
    return sd


def backbone_state_dict_from_flax(backbone: str,
                                  params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's backbone ``state_dict`` from a Flax parameter tree, by
    registry name."""
    if backbone.startswith("ncsnpp"):
        return ncsnpp_from_flax(params)
    if backbone.startswith("tfgridnet"):
        return tfgridnet_from_flax(params)
    raise ValueError(f"No Flax converter for backbone {backbone!r}")
