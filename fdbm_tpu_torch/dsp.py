"""Spectral front-end: STFT/iSTFT, spectral compression, padding.

Port of ``fdbm_tpu/dsp.py``, on torch tensors and on whatever device they
live:

* :func:`stft` / :func:`istft` match ``torch.stft`` / ``torch.istft`` with
  ``center=True`` (reflect padding), one-sided spectra,
  ``win_length == n_fft`` and ``normalized=False``. The iSTFT divides by
  the window-square envelope only where it exceeds 1e-11 and zero-pads a
  requested length past the signal, as the JAX version does, where
  ``torch.istft`` would raise.
* :func:`spec_fwd` / :func:`spec_back`: the magnitude-compression transform
  ``|z|**e * exp(i*angle(z)) * factor`` and its inverse. Unknown transform
  types, ``exponent_diff`` among them, raise ``ValueError``.
* :func:`pad_spec` pads the frame axis to a multiple of 64 (NCSN++).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(length: int) -> np.ndarray:
    """Periodic Hann window, identical to torch.hann_window(periodic=True)."""
    n = np.arange(length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / length)).astype(np.float32)


def get_window(window_type: str, length: int) -> np.ndarray:
    """'sqrthann' or 'hann'."""
    if window_type == "sqrthann":
        return np.sqrt(hann_window(length)).astype(np.float32)
    if window_type == "hann":
        return hann_window(length)
    raise NotImplementedError(f"Window type {window_type} not implemented!")


def stft(x: torch.Tensor, n_fft: int, hop_length: int, window: torch.Tensor,
         center: bool = True) -> torch.Tensor:
    """One-sided STFT of a real signal ``[..., L]`` -> complex64
    ``[..., n_fft//2 + 1, n_frames]`` (freq-major, like torch.stft)."""
    if center:
        pad = n_fft // 2
        length = x.shape[-1]
        if pad < length:
            lead = x.shape[:-1]
            x = F.pad(x.reshape(-1, 1, length), (pad, pad), mode="reflect")
            x = x.reshape(*lead, x.shape[-1])
        else:
            # numpy's reflection, repeated where the pad reaches past the signal
            # (a short signal under a long window, e.g. the mel loss's 2048).
            period = max(2 * (length - 1), 1)
            pos = torch.arange(-pad, length + pad, device=x.device) % period
            x = x.index_select(-1, torch.where(pos < length, pos, period - pos))
    frames = x.unfold(-1, n_fft, hop_length) * window  # [..., n_frames, n_fft]
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    return spec.transpose(-1, -2).to(torch.complex64)


def _overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Overlap-add of ``[..., T, n_fft]`` frames at the given hop."""
    *batch, n_frames, n_fft = frames.shape
    total = (n_frames - 1) * hop_length + n_fft
    out = frames.new_zeros(*batch, total)
    if n_fft % hop_length == 0:
        k = n_fft // hop_length
        chunks = frames.reshape(*batch, n_frames, k, hop_length)
        span = n_frames * hop_length
        for j in range(k):
            out[..., j * hop_length:j * hop_length + span] += \
                chunks[..., :, j, :].reshape(*batch, span)
    else:
        idx = (torch.arange(n_frames, device=frames.device)[:, None] * hop_length
               + torch.arange(n_fft, device=frames.device)[None, :]).reshape(-1)
        out.index_add_(out.ndim - 1, idx, frames.reshape(*batch, -1))
    return out


def istft(spec: torch.Tensor, n_fft: int, hop_length: int, window: torch.Tensor,
          length: Optional[int] = None, center: bool = True) -> torch.Tensor:
    """Inverse one-sided STFT of ``[..., F, T]``, matching
    torch.istft(center=True, length=...). Returns real ``[..., length]``."""
    n_frames = spec.shape[-1]
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * window
    num = _overlap_add(frames, hop_length)
    wsq = (window.to(torch.float32) ** 2).expand(n_frames, n_fft)
    den = _overlap_add(wsq, hop_length)
    sig = num / torch.where(den > 1e-11, den, torch.ones_like(den))
    if center:
        pad = n_fft // 2
        out_len = sig.shape[-1] - 2 * pad if length is None else length
        sig = sig[..., pad:]
        if out_len <= sig.shape[-1]:
            sig = sig[..., :out_len]
        else:
            sig = F.pad(sig, (0, out_len - sig.shape[-1]))
    elif length is not None:
        sig = sig[..., :length]
    return sig


def spec_fwd(spec: torch.Tensor, factor: float = 0.15, abs_exponent: float = 0.5,
             transform_type: str = "exponent") -> torch.Tensor:
    """Forward compression ``|z|**e * exp(i*angle(z)) * factor``."""
    if transform_type == "exponent":
        if abs_exponent != 1:
            mag = spec.abs()
            # |z|^e * z/|z| == |z|^(e-1) * z; angle(0) = 0 => output 0.
            spec = spec * torch.where(mag > 0, mag ** (abs_exponent - 1.0),
                                      torch.zeros_like(mag))
        return spec * factor
    if transform_type == "log":
        mag = spec.abs()
        scale = torch.where(mag > 0, torch.log1p(mag) / mag, torch.zeros_like(mag))
        return spec * scale * factor
    if transform_type == "none":
        return spec
    raise ValueError(f"Unknown transform_type {transform_type}")


def spec_back(spec: torch.Tensor, factor: float = 0.15, abs_exponent: float = 0.5,
              transform_type: str = "exponent") -> torch.Tensor:
    """Inverse of :func:`spec_fwd`."""
    if transform_type == "exponent":
        spec = spec / factor
        if abs_exponent != 1:
            mag = spec.abs()
            spec = spec * torch.where(mag > 0, mag ** (1.0 / abs_exponent - 1.0),
                                      torch.zeros_like(mag))
        return spec
    if transform_type == "log":
        spec = spec / factor
        mag = spec.abs()
        return spec * torch.where(mag > 0, torch.expm1(mag) / mag, torch.zeros_like(mag))
    if transform_type == "none":
        return spec
    raise ValueError(f"Unknown transform_type {transform_type}")


def pad_spec(spec: torch.Tensor, mode: str = "zero_pad", multiple: int = 64) -> torch.Tensor:
    """Pad the last (time-frame) axis of ``[..., F, T]`` to a multiple of 64.
    Reflection repeats as numpy's does when the pad exceeds the frames."""
    t = spec.shape[-1]
    num_pad = (-t) % multiple
    if num_pad == 0:
        return spec
    if mode == "zero_pad":
        return F.pad(spec, (0, num_pad))
    pos = torch.arange(t, t + num_pad, device=spec.device)
    if mode == "reflection":
        period = max(2 * (t - 1), 1)
        m = pos % period
        idx = torch.where(m < t, m, period - m)
    elif mode == "replication":
        idx = torch.full_like(pos, t - 1)
    else:
        raise NotImplementedError(f"pad mode {mode} not implemented")
    return torch.cat([spec, spec.index_select(-1, idx)], dim=-1)


def num_frames_for_length(length: int, n_fft: int, hop_length: int) -> int:
    """Frame count produced by :func:`stft` with center=True."""
    return 1 + (length + 2 * (n_fft // 2) - n_fft) // hop_length
