"""Training objectives and audio-domain criteria.

Port of ``fdbm_tpu/losses.py``. The objectives (``loss_type``) on
compressed complex spectrograms:

* ``data_prediction``: TF-MSE + l1_weight * time-domain L1;
* ``data_prediction_hybrid``: 70 * compressed-magnitude MSE + 30 *
  compressed-RI MSE - SI-SNR;
* ``data_prediction_mel``: TF-MSE + 0.1 * seven-resolution log-mel L1;
* ``data_prediction_melphase``: that + 0.01 * the phase loss;

each with the optional 0/1 ``weights`` mask that keeps wrap-padded
validation items out of the batch mean, and for the first two the optional
``pesq_weight`` * PESQ penalty (``pesq_loss.py``). The building blocks
(``phase_loss``, ``mel_spectrogram_loss``, ``multiscale_stft_loss``,
``si_sdr_loss``, ``spec_mag_sisnr_loss``) run on ``dsp.stft`` with a Hann
window; the mel filterbank is librosa's Slaney-scale, Slaney-normalised one,
computed in numpy and kept per device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from fdbm_tpu_torch import dsp
from fdbm_tpu_torch.pesq_loss import pesq_loss


def _wmean(per_item: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Batch mean of per-item scalars; ``weights`` ([B], 0/1) excludes items."""
    if weights is None:
        return per_item.mean()
    w = weights.to(per_item.dtype)
    return (per_item * w).sum() / torch.clamp(w.sum(), min=1e-8)


# -- mel filterbank (librosa-compatible: Slaney scale and norm) ----------------------


def _hz_to_mel(freq: np.ndarray) -> np.ndarray:
    freq = np.asarray(freq, np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep,
                    freq / f_sp)


def _mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    mels * f_sp)


def mel_filters(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                fmax: Optional[float] = None) -> np.ndarray:
    """[n_mels, 1 + n_fft//2] triangular Slaney-normalised filterbank."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _mel_filters_on(sr: int, n_fft: int, n_mels: int, device: torch.device) -> torch.Tensor:
    """:func:`mel_filters` as a tensor on ``device``, built once (read only)."""
    return torch.as_tensor(mel_filters(sr, n_fft, n_mels), device=device)


# -- building-block losses -----------------------------------------------------------


def _unwrap(x: torch.Tensor) -> torch.Tensor:
    """|x - 2*pi*round(x/(2*pi))|, with the JAX package's derivative 1 of
    |v| at v = 0 (``torch.abs`` takes 0): phase differences are exactly 0
    at the DC and Nyquist bins of real signals."""
    two_pi = 2.0 * np.pi
    v = x - two_pi * torch.round(x / two_pi)
    return torch.where(v >= 0, v, -v)


def _banded_diff(p: torch.Tensor, dim: int) -> torch.Tensor:
    """Column f is p[f-1] - p[f] along ``dim``; column 0 is -p[0]."""
    n = p.shape[dim]
    return torch.cat([-p.narrow(dim, 0, 1), p.narrow(dim, 0, n - 1) - p.narrow(dim, 1, n - 1)],
                     dim=dim)


def phase_loss(spec_est: torch.Tensor, spec_ref: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Instantaneous-phase + group-delay + phase-time-delay loss of complex
    ``[B, 1, F, T]`` spectrograms (the reference's banded matrices as first
    differences with a boundary column)."""
    p_e = torch.angle(spec_est)[:, 0]
    p_r = torch.angle(spec_ref)[:, 0]
    per_item = lambda d: _wmean(_unwrap(d).mean((1, 2)), weights)
    ip = per_item(p_r - p_e)
    gd = per_item(_banded_diff(p_r, 1) - _banded_diff(p_e, 1))
    ptd = per_item(_banded_diff(p_r, 2) - _banded_diff(p_e, 2))
    return ip + gd + ptd


def si_sdr_loss(references: torch.Tensor, estimates: torch.Tensor, scaling: bool = True,
                zero_mean: bool = True, clip_min: Optional[float] = None,
                reduction: str = "mean") -> torch.Tensor:
    """Negative SI-SDR in dB of ``[B, ..., T]`` signals."""
    eps = 1e-8
    nb = references.shape[0]
    refs = references.reshape(nb, -1)
    ests = estimates.reshape(nb, -1)
    if zero_mean:
        refs = refs - refs.mean(-1, keepdim=True)
        ests = ests - ests.mean(-1, keepdim=True)
    ref_proj = (refs ** 2).sum(-1) + eps
    dot = (ests * refs).sum(-1) + eps
    scale = (dot / ref_proj)[:, None] if scaling else 1.0
    e_true = scale * refs
    e_res = ests - e_true
    sdr = -10.0 * torch.log10((e_true ** 2).sum(-1) / (e_res ** 2).sum(-1) + eps)
    if clip_min is not None:
        sdr = torch.clamp(sdr, min=clip_min)
    if reduction == "mean":
        return sdr.mean()
    if reduction == "sum":
        return sdr.sum()
    return sdr


def _stft_mag(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    win = torch.as_tensor(dsp.hann_window(n_fft), device=x.device)
    return dsp.stft(x.reshape(-1, x.shape[-1]), n_fft, hop, win).abs()


def _log_l1(a: torch.Tensor, b: torch.Tensor, clamp_eps: float, pow: float) -> torch.Tensor:
    """|log10(max(a, eps)^pow) - log10(max(b, eps)^pow)|, elementwise."""
    return (torch.log10(torch.clamp(a, min=clamp_eps) ** pow)
            - torch.log10(torch.clamp(b, min=clamp_eps) ** pow)).abs()


def multiscale_stft_loss(x: torch.Tensor, y: torch.Tensor,
                         win_lengths: Sequence[int] = (2048, 512),
                         hop_lengths: Sequence[int] = (512, 128), clamp_eps: float = 1e-5,
                         mag_weight: float = 1.0, log_weight: float = 1.0,
                         pow: float = 2.0) -> torch.Tensor:
    """Multi-scale STFT L1 loss; ``x`` the estimate, ``y`` the reference."""
    loss = 0.0
    for w, h in zip(win_lengths, hop_lengths):
        xm, ym = _stft_mag(x, w, h), _stft_mag(y, w, h)
        loss = loss + log_weight * _log_l1(xm, ym, clamp_eps, pow).mean()
        loss = loss + mag_weight * (xm - ym).abs().mean()
    return loss


def mel_spectrogram_loss(x: torch.Tensor, y: torch.Tensor, sample_rate: int = 16000,
                         n_mels: Sequence[int] = (150, 80),
                         win_lengths: Sequence[int] = (2048, 512),
                         hop_lengths: Sequence[int] = (512, 128), clamp_eps: float = 1e-5,
                         mag_weight: float = 1.0, log_weight: float = 1.0, pow: float = 2.0,
                         weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-resolution mel loss of ``[B, L]`` signals; ``x`` the estimate."""
    loss = 0.0
    for nm, w, h in zip(n_mels, win_lengths, hop_lengths):
        x_mag, y_mag = _stft_mag(x, w, h), _stft_mag(y, w, h)
        fb = _mel_filters_on(sample_rate, w, nm, x.device).to(x_mag.dtype)
        x_mel = torch.einsum("bft,mf->bmt", x_mag, fb)
        y_mel = torch.einsum("bft,mf->bmt", y_mag, fb)
        if log_weight > 0:
            loss = loss + log_weight * _wmean(
                _log_l1(x_mel, y_mel, clamp_eps, pow).mean((1, 2)), weights)
        if mag_weight > 0:
            loss = loss + mag_weight * _wmean((x_mel - y_mel).abs().mean((1, 2)), weights)
    return loss


# The seven-resolution mel configuration of data_prediction_mel/melphase.
MEL7 = dict(
    n_mels=(5, 10, 20, 40, 80, 160, 210),
    win_lengths=(32, 64, 128, 256, 512, 1024, 2048),
    hop_lengths=(8, 16, 32, 64, 128, 256, 512),
    mag_weight=0.0,
    log_weight=1.0,
)


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


def spec_mag_sisnr_loss(est: torch.Tensor, ref: torch.Tensor, n_fft: int, hop: int,
                        window: torch.Tensor) -> torch.Tensor:
    """Waveform-domain hybrid criterion."""
    spec_est = dsp.stft(est.reshape(-1, est.shape[-1]), n_fft, hop, window)
    spec_ref = dsp.stft(ref.reshape(-1, ref.shape[-1]), n_fft, hop, window)
    est_mag = (spec_est + 1e-12).abs()
    ref_mag = (spec_ref + 1e-12).abs()
    losses_mag = ((est_mag ** 0.3 - ref_mag ** 0.3) ** 2).mean()
    diff = spec_est * est_mag ** -0.7 - spec_ref * ref_mag ** -0.7
    losses_ri = (diff.abs() ** 2).sum() / spec_est.numel()
    return 70.0 * losses_mag + 30.0 * losses_ri - _sisnr_log10(ref, est)


# -- objectives ("loss_type") ---------------------------------------------------------


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
    if cfg.pesq_weight > 0.0 and cfg.loss_type not in ("data_prediction",
                                                       "data_prediction_hybrid"):
        raise ValueError("pesq_weight > 0 applies to data_prediction / "
                         "data_prediction_hybrid only")

    def pesq_term(x_td: torch.Tensor, x_hat_td: torch.Tensor) -> torch.Tensor:
        per_item = pesq_loss(x_td, x_hat_td, sample_rate=cfg.sample_rate)
        return cfg.pesq_weight * _wmean(per_item, weights)

    b, c, f, t = x.shape
    target_len = (cfg.num_frames - 1) * cfg.hop_length
    if cfg.loss_type == "data_prediction":
        losses_tf = (x_hat - x).abs() ** 2 / (f * t)
        losses_tf = _wmean(0.5 * losses_tf.reshape(b, -1).sum(-1), weights)
        x_hat_td = cfg.to_audio(x_hat[:, 0], target_len)
        x_td = cfg.to_audio(x[:, 0], target_len)
        losses_l1 = (x_hat_td - x_td).abs() / target_len
        losses_l1 = _wmean(0.5 * losses_l1.reshape(b, -1).sum(-1), weights)
        loss = losses_tf + cfg.l1_weight * losses_l1
        if cfg.pesq_weight > 0.0:
            loss = loss + pesq_term(x_td, x_hat_td)
        return loss
    if cfg.loss_type == "data_prediction_hybrid":
        x_nc = cfg.spec_back(x)
        x_hat_nc = cfg.spec_back(x_hat)
        x_mag = (x_nc + 1e-12).abs()
        x_hat_mag = (x_hat_nc + 1e-12).abs()
        losses_mag = _wmean(((x_mag ** 0.3 - x_hat_mag ** 0.3) ** 2).mean((1, 2, 3)), weights)
        diff = x_nc * x_mag ** -0.7 - x_hat_nc * x_hat_mag ** -0.7
        losses_ri = _wmean((diff.abs() ** 2).sum((1, 2, 3)) / (c * f * t), weights)
        x_hat_td = cfg.to_audio(x_hat[:, 0])
        x_td = cfg.to_audio(x[:, 0])
        loss = 70.0 * losses_mag + 30.0 * losses_ri - _sisnr_log10(x_td, x_hat_td, weights)
        if cfg.pesq_weight > 0.0:
            loss = loss + pesq_term(x_td, x_hat_td)
        return loss
    if cfg.loss_type in ("data_prediction_mel", "data_prediction_melphase"):
        losses_tf = _wmean(((x_hat - x).abs() ** 2).mean((1, 2, 3)), weights) * 0.5
        x_hat_td = cfg.to_audio(x_hat[:, 0], target_len)
        x_td = cfg.to_audio(x[:, 0], target_len)
        loss = losses_tf + 0.1 * mel_spectrogram_loss(x_hat_td, x_td, cfg.sample_rate,
                                                      weights=weights, **MEL7)
        if cfg.loss_type == "data_prediction_melphase":
            loss = loss + 0.01 * phase_loss(x_hat, x, weights)
        return loss
    raise ValueError(f"Invalid loss type: {cfg.loss_type}")
