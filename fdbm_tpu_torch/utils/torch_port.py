"""Reference PyTorch-Lightning checkpoints -> the port's ``state_dict``.

The port's own copy of ``fdbm_tpu/utils/torch_port.py``'s import
(``tfgridnet_from_torch``, ``ncsnpp_from_torch`` and their helpers,
``_TFGRIDNET_PRESETS``, ``_NCSNPP_PRESETS``, ``_apply_ema_shadow``,
``_is_gfp_key``, ``load_reference_checkpoint``). A reference state_dict
(``fdbm/backbones/tfgridnet.py`` or ``ncsnpp_v2.py`` module names) becomes a
Flax-layout tree of numpy arrays, which ``utils/weights.py`` turns into the
port's ``state_dict``: one converter into the port, not two.

Layouts handled here:

* torch Conv2d ``[O, I, kh, kw]`` -> Flax ``[kh, kw, I, O]``;
* torch ConvTranspose2d ``[I, O, kh, kw]`` -> Flax ConvTranspose kernels
  with the spatial taps flipped;
* torch 1x1 Conv2d -> Flax Dense ``[I, O]``;
* torch bidirectional LSTM (gates i, f, g, o; two biases) -> the fused
  ``[2, D, 4H] / [2, H, 4H] / [2, 4H]`` BiLSTM parameters, with the rows of
  the input weights permuted from ``F.unfold``'s channel-major windows to
  the tap-major windows of the port;
* torch ConvTranspose1d ``[I, O, k]`` -> the fold Dense ``[I, k*O]``
  (tap-major columns) and its bias;
* NCSN++'s ``NIN`` layers, which store ``W`` as ``[I, O]`` already -> Dense.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from fdbm_tpu_torch.utils.weights import ncsnpp_from_flax, tfgridnet_from_flax

_OLP_KS = 4  # emb_ks of both frameworks

# backbone registry name -> converter arguments (reference presets,
# tfgridnet.py:487-510)
_TFGRIDNET_PRESETS = {
    "tfgridnet_5l32c100": dict(n_layers=5, emb_dim=32),
    "tfgridnet_4l32c80": dict(n_layers=4, emb_dim=32),
    "tfgridnet_5l32c100_predictive": dict(n_layers=5, emb_dim=32, time_conditioned=False),
    "tfgridnet_4l32c80_predictive": dict(n_layers=4, emb_dim=32, time_conditioned=False),
}
# (ncsnpp_v2.py:404-453)
_NCSNPP_7 = dict(ch_mult=(1, 1, 2, 2, 2, 2, 2), num_res_blocks=2)
_NCSNPP_4 = dict(nf=96, ch_mult=(1, 1, 1, 1), num_res_blocks=1, attn_resolutions=(0,))
_NCSNPP_PRESETS = {
    "ncsnpp_v2": dict(nf=128, attn_resolutions=(16,), **_NCSNPP_7),
    "ncsnpp_v2_5M": _NCSNPP_4,
    "ncsnpp_v2_16M": dict(nf=64, attn_resolutions=(0,), **_NCSNPP_7),
    "ncsnpp_v2_37M": dict(nf=96, attn_resolutions=(16,), **_NCSNPP_7),
    "ncsnpp_v2_predictive": dict(nf=128, attn_resolutions=(16,), time_conditioned=False,
                                 **_NCSNPP_7),
    "ncsnpp_v2_5M_predictive": dict(time_conditioned=False, **_NCSNPP_4),
}


def _conv2d(sd: Mapping[str, np.ndarray], name: str) -> Dict[str, np.ndarray]:
    w = sd[f"{name}.weight"]  # [O, I, kh, kw]
    return {"kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)), "bias": sd[f"{name}.bias"]}


def _conv_transpose2d(sd: Mapping[str, np.ndarray], name: str) -> Dict[str, np.ndarray]:
    w = sd[f"{name}.weight"]  # [I, O, kh, kw]
    return {"kernel": np.ascontiguousarray(w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)),
            "bias": sd[f"{name}.bias"]}


def _dense_from_1x1(sd: Mapping[str, np.ndarray], name: str) -> Dict[str, np.ndarray]:
    w = sd[f"{name}.weight"]  # [O, I, 1, 1]
    return {"kernel": np.ascontiguousarray(w[:, :, 0, 0].T), "bias": sd[f"{name}.bias"]}


def _dense(sd: Mapping[str, np.ndarray], name: str) -> Dict[str, np.ndarray]:
    return {"kernel": np.ascontiguousarray(sd[f"{name}.weight"].T), "bias": sd[f"{name}.bias"]}


def _unfold_perm(c: int, ks: int = _OLP_KS) -> np.ndarray:
    """Window index of the port (tap-major: m = j*c + ch) -> torch unfold's
    (channel-major: n = ch*ks + j)."""
    m = np.arange(ks * c)
    return (m % c) * ks + m // c


def _bilstm(sd: Mapping[str, np.ndarray], name: str, c: int) -> Dict[str, np.ndarray]:
    """torch nn.LSTM(bidirectional) -> BiLSTM params {w_ih, w_hh, bias}."""
    perm = _unfold_perm(c)

    def one(sfx: str):
        w_ih = sd[f"{name}.weight_ih_l0{sfx}"].T[perm, :]  # [D, 4H]
        w_hh = sd[f"{name}.weight_hh_l0{sfx}"].T  # [H, 4H]
        return w_ih, w_hh, sd[f"{name}.bias_ih_l0{sfx}"] + sd[f"{name}.bias_hh_l0{sfx}"]

    (wf, hf, bf), (wr, hr, br) = one(""), one("_reverse")
    return {"w_ih": np.stack([wf, wr]).astype(np.float32),
            "w_hh": np.stack([hf, hr]).astype(np.float32),
            "bias": np.stack([bf, br]).astype(np.float32)}


def _fold_dense(sd: Mapping[str, np.ndarray], name: str, c: int):
    """torch ConvTranspose1d(2H -> C, k) -> Dense [2H, k*C] (tap-major) + bias."""
    w = sd[f"{name}.weight"]  # [2H, C, k]
    kernel = w.transpose(0, 2, 1).reshape(w.shape[0], w.shape[-1] * c)
    return {"kernel": np.ascontiguousarray(kernel)}, sd[f"{name}.bias"]


def _allhead_norm(sd: Mapping[str, np.ndarray], name: str) -> Dict[str, np.ndarray]:
    return {"gamma": sd[f"{name}.gamma"][0, :, :, 0, 0],  # [H, E]
            "beta": sd[f"{name}.beta"][0, :, :, 0, 0],
            "prelu_alpha": sd[f"{name}.act.weight"].reshape(-1, 1)}  # [H, 1]


def tfgridnet_from_torch(sd: Mapping[str, np.ndarray], n_layers: int, emb_dim: int,
                         time_conditioned: bool = True) -> Dict[str, Any]:
    """Reference TFGridNet (V3) state_dict of numpy arrays -> the Flax-layout
    parameter tree (``{"params": ...}``) of ``fdbm_tpu.models.tfgridnet``,
    generative or (``time_conditioned=False``) predictive."""
    c = emb_dim
    p: Dict[str, Any] = {"conv_in": _conv2d(sd, "conv.0"),
                         "gn_in": {"scale": sd["conv.1.weight"], "bias": sd["conv.1.bias"]}}
    if time_conditioned:
        p["time_emb"] = {"W": sd["get_time_emb.W"]}
        p["time_fc1"] = _dense(sd, "time_emb_fc.0")
        p["time_fc2"] = _dense(sd, "time_emb_fc.2")
        for i in range(n_layers):
            p[f"time_block_{i}"] = _dense(sd, f"time_emb_blocks.{i}")
    for i in range(n_layers):
        blk: Dict[str, Any] = {}
        for path in ("intra", "inter"):
            fold, fold_bias = _fold_dense(sd, f"blocks.{i}.{path}_linear", c)
            blk[path] = {"ln_gamma": sd[f"blocks.{i}.{path}_norm.weight"],
                         "ln_beta": sd[f"blocks.{i}.{path}_norm.bias"],
                         "bilstm": _bilstm(sd, f"blocks.{i}.{path}_rnn", c),
                         "deconv": fold, "deconv_bias": fold_bias}
        for qkv in ("Q", "K", "V"):
            blk[f"attn_conv_{qkv}"] = _dense_from_1x1(sd, f"blocks.{i}.attn_conv_{qkv}")
            blk[f"attn_norm_{qkv}"] = _allhead_norm(sd, f"blocks.{i}.attn_norm_{qkv}")
        blk["attn_proj"] = _dense_from_1x1(sd, f"blocks.{i}.attn_concat_proj.0")
        blk["attn_prelu"] = {"alpha": sd[f"blocks.{i}.attn_concat_proj.1.weight"].reshape(())}
        blk["attn_ln_gamma"] = sd[f"blocks.{i}.attn_concat_proj.2.gamma"].reshape(-1)
        blk["attn_ln_beta"] = sd[f"blocks.{i}.attn_concat_proj.2.beta"].reshape(-1)
        p[f"block_{i}"] = blk
    p["deconv_out"] = _conv_transpose2d(sd, "deconv")
    return {"params": p}


# -- NCSN++ v2 -----------------------------------------------------------------


def _groupnorm(sd: Mapping[str, np.ndarray], name: str) -> Dict[str, np.ndarray]:
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def _nin(sd: Mapping[str, np.ndarray], name: str) -> Dict[str, np.ndarray]:
    """NIN stores W as [in, out] already (layers.py:546-555)."""
    return {"kernel": sd[f"{name}.W"], "bias": sd[f"{name}.b"]}


def _resblock(sd: Mapping[str, np.ndarray], pfx: str) -> Dict[str, Any]:
    """ResnetBlockBigGANpp (layerspp.py:212-274) -> ResnetBlockBigGAN."""
    blk = {"gn0": _groupnorm(sd, f"{pfx}.GroupNorm_0"), "conv0": _conv2d(sd, f"{pfx}.Conv_0"),
           "gn1": _groupnorm(sd, f"{pfx}.GroupNorm_1"), "conv1": _conv2d(sd, f"{pfx}.Conv_1")}
    if f"{pfx}.Dense_0.weight" in sd:
        blk["temb_proj"] = _dense(sd, f"{pfx}.Dense_0")
    if f"{pfx}.Conv_2.weight" in sd:
        blk["shortcut"] = _dense_from_1x1(sd, f"{pfx}.Conv_2")
    return blk


def _attnblock(sd: Mapping[str, np.ndarray], pfx: str) -> Dict[str, Any]:
    """AttnBlockpp (layerspp.py:62-91) -> AttnBlock."""
    return {"norm": _groupnorm(sd, f"{pfx}.GroupNorm_0"),
            **{key: _nin(sd, f"{pfx}.NIN_{i}") for i, key in enumerate(("q", "k", "v", "proj"))}}


def ncsnpp_from_torch(sd: Mapping[str, np.ndarray], nf: int = 128,
                      ch_mult=(1, 1, 2, 2, 2, 2, 2), num_res_blocks: int = 2,
                      attn_resolutions=(16,), image_size: int = 256,
                      time_conditioned: bool = True) -> Dict[str, Any]:
    """Reference NCSNpp_v2 state_dict of numpy arrays -> the Flax-layout
    parameter tree (``{"params": ...}``) of ``fdbm_tpu.models.ncsnpp``.

    Walks the reference's flat ``all_modules`` list in construction order
    (ncsnpp_v2.py:95-239) and gives each index its named submodule; the
    attention sits where the reference puts it, at the levels whose
    ``image_size // 2**level`` is in ``attn_resolutions``. The config must
    be the one the checkpoint was built with."""
    levels = len(ch_mult)
    all_res = [image_size // (2 ** i) for i in range(levels)]
    idx = [0]

    def nxt() -> str:
        idx[0] += 1
        return f"all_modules.{idx[0] - 1}"

    p: Dict[str, Any] = {}
    if time_conditioned:
        p["time_emb"] = {"W": sd[f"{nxt()}.W"]}
        p["time_fc0"] = _dense(sd, nxt())
        p["time_fc1"] = _dense(sd, nxt())
    p["conv_in"] = _conv2d(sd, nxt())
    for level in range(levels):
        for block in range(num_res_blocks):
            p[f"down_{level}_{block}"] = _resblock(sd, nxt())
            if all_res[level] in attn_resolutions:
                p[f"down_attn_{level}_{block}"] = _attnblock(sd, nxt())
        if level != levels - 1:
            p[f"down_{level}_ds"] = _resblock(sd, nxt())
            p[f"combine_{level}"] = _dense_from_1x1(sd, f"{nxt()}.Conv_0")
    p["mid_0"] = _resblock(sd, nxt())
    p["mid_attn"] = _attnblock(sd, nxt())
    p["mid_1"] = _resblock(sd, nxt())
    for level in reversed(range(levels)):
        for block in range(num_res_blocks + 1):
            p[f"up_{level}_{block}"] = _resblock(sd, nxt())
        if all_res[level] in attn_resolutions:
            p[f"up_attn_{level}"] = _attnblock(sd, nxt())
        p[f"pyr_gn_{level}"] = _groupnorm(sd, nxt())
        p[f"pyr_conv_{level}"] = _conv2d(sd, nxt())
        if level != 0:
            p[f"up_{level}_us"] = _resblock(sd, nxt())
    n_modules = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("all_modules."))
    if idx[0] != n_modules:
        raise ValueError(f"module walk consumed {idx[0]} of {n_modules} all_modules: "
                         "config mismatch with the checkpoint")
    p["output_layer"] = _dense_from_1x1(sd, "output_layer")
    return {"params": p}


def backbone_state_dict_from_torch(backbone: str,
                                   sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The port's backbone ``state_dict`` from a reference backbone
    state_dict (numpy arrays), by registry name."""
    if backbone in _TFGRIDNET_PRESETS:
        return tfgridnet_from_flax(tfgridnet_from_torch(sd, **_TFGRIDNET_PRESETS[backbone]))
    if backbone in _NCSNPP_PRESETS:
        return ncsnpp_from_flax(ncsnpp_from_torch(sd, **_NCSNPP_PRESETS[backbone]))
    raise ValueError(f"No torch-import preset for backbone {backbone!r}")


def _is_gfp_key(k: str) -> bool:
    """GaussianFourierProjection W (requires_grad=False in the reference)."""
    return k in ("get_time_emb.W", "all_modules.0.W")


def _apply_ema_shadow(sd: Dict[str, np.ndarray], ema_state) -> Dict[str, np.ndarray]:
    """Overwrite the trainable parameters with torch_ema's shadow values.

    torch_ema tracks the parameters that require a gradient, in registration
    order; the reference backbones' only other parameter is the Gaussian
    Fourier projection's W, and they register no buffers, so the state_dict's
    order less W is the shadow's order."""
    shadow = [t.detach().cpu().numpy() for t in ema_state["shadow_params"]]
    trainable = [k for k in sd if not _is_gfp_key(k)]
    if len(trainable) != len(shadow):
        raise ValueError(f"EMA shadow has {len(shadow)} tensors but checkpoint has "
                         f"{len(trainable)} trainable params — cannot align")
    out = dict(sd)
    for k, v in zip(trainable, shadow):
        if out[k].shape != v.shape:
            raise ValueError(f"EMA shape mismatch at {k}: {out[k].shape} vs {v.shape}")
        out[k] = v
    return out


def load_reference_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """Read a reference Lightning ``.ckpt``: returns ``(hyper_parameters,
    state_dict)``, the checkpoint's saved hyperparameters (the YAML surface
    ``FDBMConfig.from_dict`` reads) and the port's backbone ``state_dict``,
    with the torch_ema shadow weights applied when present (the reference
    serves its EMA weights). The file is unpickled in full, as Lightning
    checkpoints hold objects besides tensors: load only checkpoints you
    trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    hp = {k: v for k, v in dict(ckpt.get("hyper_parameters", {})).items()
          if isinstance(v, (int, float, str, bool, dict, list, tuple)) or v is None}
    state = ckpt.get("state_dict", ckpt)
    dnn_sd = {k[len("dnn."):]: v for k, v in state.items() if k.startswith("dnn.")}
    if not dnn_sd:
        dnn_sd = state  # a bare backbone state_dict
    sd = {k: v.detach().cpu().numpy() for k, v in dnn_sd.items()}
    if isinstance(ckpt.get("ema"), dict) and "shadow_params" in ckpt["ema"]:
        sd = _apply_ema_shadow(sd, ckpt["ema"])
    backbone = hp.get("backbone")
    if backbone is None:
        raise ValueError(f"{path} has no 'backbone' hyperparameter; pass a Lightning "
                         "checkpoint saved by the reference")
    return hp, backbone_state_dict_from_torch(backbone, sd)
