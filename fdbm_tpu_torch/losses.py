"""Training objectives on compressed complex spectrograms.

Port of ``fdbm_tpu/losses.py`` for the losses the generative TF-GridNet
trains with: ``data_prediction`` (TF-MSE + l1_weight * time-domain L1) and
``data_prediction_hybrid`` (70 * compressed-magnitude MSE + 30 *
compressed-RI MSE - SI-SNR), each with the optional 0/1 ``weights`` mask
that keeps wrap-padded validation items out of the batch mean.
``data_prediction_mel``, ``data_prediction_melphase`` and ``pesq_weight >
0`` raise ``NotImplementedError``: their mel, phase and PESQ criteria are
not ported yet (ROADMAP queue 1, item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from fdbm_tpu_torch import dsp


def _wmean(per_item: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Batch mean of per-item scalars; ``weights`` ([B], 0/1) excludes items."""
    if weights is None:
        return per_item.mean()
    w = weights.to(per_item.dtype)
    return (per_item * w).sum() / torch.clamp(w.sum(), min=1e-8)


def _sisnr_log10(ref_td: torch.Tensor, est_td: torch.Tensor,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The hybrid loss's SI-SNR term: log10 ratio, no 10x."""
    dot = (ref_td * est_td).sum(-1, keepdim=True)
    ref_energy = (ref_td ** 2).sum(-1, keepdim=True) + 1e-12
    proj = dot * ref_td / ref_energy
    ratio = (proj ** 2).sum(-1, keepdim=True) / (((est_td - proj) ** 2).sum(-1, keepdim=True)
                                                 + 1e-12)
    per_item = torch.log10(torch.clamp(ratio, min=1e-12)).reshape(ref_td.shape[0], -1)
    return _wmean(per_item.mean(-1), weights)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """STFT/compression context the losses need to go spec -> audio."""

    n_fft: int = 512
    hop_length: int = 256
    window: Tuple[float, ...] = ()
    num_frames: int = 256
    spec_factor: float = 0.15
    spec_abs_exponent: float = 0.5
    transform_type: str = "exponent"
    loss_type: str = "data_prediction_hybrid"
    l1_weight: float = 0.001
    pesq_weight: float = 0.0
    sample_rate: int = 16000

    def spec_back(self, spec: torch.Tensor) -> torch.Tensor:
        return dsp.spec_back(spec, self.spec_factor, self.spec_abs_exponent,
                             self.transform_type)

    def to_audio(self, spec: torch.Tensor, length: Optional[int] = None) -> torch.Tensor:
        window = torch.as_tensor(np.asarray(self.window, np.float32), device=spec.device)
        return dsp.istft(self.spec_back(spec), self.n_fft, self.hop_length, window,
                         length=length)


def compute_loss(cfg: LossConfig, x_hat: torch.Tensor, x: torch.Tensor,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The configured objective on compressed complex spectrograms
    ``[B, C, F, T]``; ``weights`` is an optional [B] 0/1 mask."""
    if cfg.pesq_weight > 0.0:
        raise NotImplementedError(
            "pesq_weight > 0: the PESQ loss is not ported to fdbm_tpu_torch yet "
            "(ROADMAP queue 1, item 7)")
    b, c, f, t = x.shape
    if cfg.loss_type == "data_prediction":
        losses_tf = (x_hat - x).abs() ** 2 / (f * t)
        losses_tf = _wmean(0.5 * losses_tf.reshape(b, -1).sum(-1), weights)
        target_len = (cfg.num_frames - 1) * cfg.hop_length
        x_hat_td = cfg.to_audio(x_hat[:, 0], target_len)
        x_td = cfg.to_audio(x[:, 0], target_len)
        losses_l1 = (x_hat_td - x_td).abs() / target_len
        losses_l1 = _wmean(0.5 * losses_l1.reshape(b, -1).sum(-1), weights)
        return losses_tf + cfg.l1_weight * losses_l1
    if cfg.loss_type == "data_prediction_hybrid":
        x_nc = cfg.spec_back(x)
        x_hat_nc = cfg.spec_back(x_hat)
        x_mag = (x_nc + 1e-12).abs()
        x_hat_mag = (x_hat_nc + 1e-12).abs()
        losses_mag = _wmean(((x_mag ** 0.3 - x_hat_mag ** 0.3) ** 2).mean((1, 2, 3)), weights)
        diff = x_nc * x_mag ** -0.7 - x_hat_nc * x_hat_mag ** -0.7
        losses_ri = _wmean((diff.abs() ** 2).sum((1, 2, 3)) / (c * f * t), weights)
        sisnr = _sisnr_log10(cfg.to_audio(x[:, 0]), cfg.to_audio(x_hat[:, 0]), weights)
        return 70.0 * losses_mag + 30.0 * losses_ri - sisnr
    if cfg.loss_type in ("data_prediction_mel", "data_prediction_melphase"):
        raise NotImplementedError(
            f"loss_type={cfg.loss_type!r}: the mel and phase criteria are not ported to "
            "fdbm_tpu_torch yet (ROADMAP queue 1, item 7)")
    raise ValueError(f"Invalid loss type: {cfg.loss_type}")
