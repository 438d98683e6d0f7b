"""Evaluation metrics: SI-SDR, SNR, energy ratios, ESTOI and wideband PESQ.

Port of ``fdbm_tpu/utils/metrics.py``: numpy and scipy, kept as they are
(SI-SDR and the energy ratios of the reference's ``fdbm/util/other.py``, a
native ESTOI of the pystoi algorithm, the mean, spread and confidence
interval helpers, the evaluation high-pass filter). PESQ uses the ITU
``pesq`` package when importable and otherwise the port's own P.862.2
estimator (``fdbm_tpu_torch/pesq_loss.py``) on a torch device.
"""

from __future__ import annotations

import functools
import warnings
from typing import Optional

import numpy as np
import torch

from fdbm_tpu_torch.pesq_loss import pesq_mos


def si_sdr(s: np.ndarray, s_hat: np.ndarray) -> float:
    """Scale-invariant SDR in dB (reference other.py:64-68)."""
    alpha = np.dot(s_hat, s) / (np.linalg.norm(s) ** 2 + 1e-12)
    num = np.linalg.norm(alpha * s) ** 2
    den = np.linalg.norm(alpha * s - s_hat) ** 2 + 1e-12
    return float(10 * np.log10(num / den + 1e-12))


def si_sdr_components(s_hat, s, n):
    alpha_s = np.dot(s_hat, s) / np.linalg.norm(s) ** 2
    s_target = alpha_s * s
    alpha_n = np.dot(s_hat, n) / np.linalg.norm(n) ** 2
    e_noise = alpha_n * n
    e_art = s_hat - s_target - e_noise
    return s_target, e_noise, e_art


def energy_ratios(s_hat, s, n):
    """(si_sdr, si_sir, si_sar) — reference other.py:25-32."""
    s_target, e_noise, e_art = si_sdr_components(s_hat, s, n)
    sdr = 10 * np.log10(np.linalg.norm(s_target) ** 2 / np.linalg.norm(e_noise + e_art) ** 2)
    sir = 10 * np.log10(np.linalg.norm(s_target) ** 2 / np.linalg.norm(e_noise) ** 2)
    sar = 10 * np.log10(np.linalg.norm(s_target) ** 2 / np.linalg.norm(e_art) ** 2)
    return sdr, sir, sar


def snr_db(s: np.ndarray, n: np.ndarray) -> float:
    return float(10 * np.log10(np.mean(s ** 2) / np.mean(n ** 2)))


def pesq_wb(sr: int, ref: np.ndarray, deg: np.ndarray, device="cuda") -> Optional[float]:
    """Wideband PESQ MOS-LQO.

    Uses the ITU ``pesq`` package when importable; otherwise the port's
    P.862.2 estimator (``pesq_loss.pesq_mos``) on ``device``, which returns
    None at a sample rate other than 16 kHz or below 1024 samples. A card
    that was asked for and is absent raises.
    """
    try:
        from pesq import pesq as _pesq

        if not callable(_pesq):
            raise ImportError("pesq module present but not usable")
        try:
            return float(_pesq(sr, ref, deg, "wb"))
        except Exception as e:  # pesq raises on silence/NaN inputs
            warnings.warn(f"PESQ failed: {e}")
            return None
    except ImportError:
        pass
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("pesq_wb: device 'cuda' was asked for but no CUDA device is "
                           "available; pass device='cpu'")
    if sr != 16000:
        return None
    L = min(len(ref), len(deg))
    if L < 1024:
        return None
    try:
        with torch.no_grad():
            mos = pesq_mos(torch.as_tensor(np.asarray(ref[None, :L], np.float32), device=device),
                           torch.as_tensor(np.asarray(deg[None, :L], np.float32), device=device))
        val = float(mos[0])
        return val if np.isfinite(val) else None
    except Exception as e:  # noqa: BLE001 - a metric of one file; reported, then skipped
        warnings.warn(f"PESQ estimator failed: {e}")
        return None


# ---------------------------------------------------------------------------
# ESTOI (Jensen & Taal 2016) — native implementation of the pystoi algorithm
# ---------------------------------------------------------------------------

_FS = 10000
_N_FRAME = 256
_NFFT = 512
_NUMBAND = 15
_MINFREQ = 150.0
_N = 30  # analysis segment length (frames)
_DYN_RANGE = 40.0


@functools.lru_cache(maxsize=1)
def _octave_band_matrix():
    f = np.linspace(0, _FS, _NFFT + 1)[: _NFFT // 2 + 1]
    cf = _MINFREQ * 2.0 ** (np.arange(_NUMBAND) / 3.0)
    lo = cf * 2 ** (-1 / 6)
    hi = cf * 2 ** (1 / 6)
    obm = np.zeros((_NUMBAND, len(f)))
    for i in range(_NUMBAND):
        lo_i = np.argmin((f - lo[i]) ** 2)
        hi_i = np.argmin((f - hi[i]) ** 2)
        obm[i, lo_i:hi_i] = 1
    return obm


def _stft_frames(x):
    w = np.hanning(_N_FRAME + 2)[1:-1]
    hop = _N_FRAME // 2
    n_frames = 1 + (len(x) - _N_FRAME) // hop
    if n_frames < 1:
        return np.zeros((0, _NFFT // 2 + 1))
    idx = np.arange(n_frames)[:, None] * hop + np.arange(_N_FRAME)[None, :]
    frames = x[idx] * w
    return np.fft.rfft(frames, _NFFT, axis=-1)


def _remove_silent_frames(x, y, dyn_range=_DYN_RANGE):
    w = np.hanning(_N_FRAME + 2)[1:-1]
    hop = _N_FRAME // 2
    n_frames = 1 + (len(x) - _N_FRAME) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(_N_FRAME)[None, :]
    xf = x[idx] * w
    yf = y[idx] * w
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    mask = energies > (np.max(energies) - dyn_range)
    xf, yf = xf[mask], yf[mask]
    # overlap-add back
    n = len(xf)
    out_len = (n - 1) * hop + _N_FRAME if n else 0
    xs = np.zeros(out_len)
    ys = np.zeros(out_len)
    for i in range(n):
        xs[i * hop : i * hop + _N_FRAME] += xf[i]
        ys[i * hop : i * hop + _N_FRAME] += yf[i]
    return xs, ys


def estoi(ref: np.ndarray, deg: np.ndarray, sr: int) -> float:
    """Extended STOI (pystoi-compatible algorithm, extended=True)."""
    from scipy.signal import resample_poly
    from math import gcd

    ref = np.asarray(ref, np.float64).squeeze()
    deg = np.asarray(deg, np.float64).squeeze()
    if sr != _FS:
        g = gcd(int(sr), _FS)
        ref = resample_poly(ref, _FS // g, sr // g)
        deg = resample_poly(deg, _FS // g, sr // g)
    ref, deg = _remove_silent_frames(ref, deg)
    if len(ref) < _N_FRAME * 2:
        return float("nan")
    X = _stft_frames(ref)
    Y = _stft_frames(deg)
    obm = _octave_band_matrix()
    Xb = np.sqrt(obm @ (np.abs(X.T) ** 2))  # [bands, frames]
    Yb = np.sqrt(obm @ (np.abs(Y.T) ** 2))
    if Xb.shape[1] < _N:
        return float("nan")
    corrs = []
    for m in range(_N, Xb.shape[1] + 1):
        xs = Xb[:, m - _N : m]
        ys = Yb[:, m - _N : m]
        # row normalisation (per band over time)
        xn = xs - xs.mean(axis=1, keepdims=True)
        xn /= np.linalg.norm(xn, axis=1, keepdims=True) + 1e-12
        yn = ys - ys.mean(axis=1, keepdims=True)
        yn /= np.linalg.norm(yn, axis=1, keepdims=True) + 1e-12
        # column normalisation (per time over bands)
        xn = xn - xn.mean(axis=0, keepdims=True)
        xn /= np.linalg.norm(xn, axis=0, keepdims=True) + 1e-12
        yn = yn - yn.mean(axis=0, keepdims=True)
        yn /= np.linalg.norm(yn, axis=0, keepdims=True) + 1e-12
        corrs.append(np.sum(xn * yn) / _N)
    return float(np.mean(corrs))


def mean_std(data: np.ndarray):
    data = np.asarray(data)
    data = data[~np.isnan(data)]
    return float(np.mean(data)), float(np.std(data))


def mean_conf_int(data, confidence: float = 0.95):
    """Mean and half-width confidence interval (reference other.py:34-39)."""
    import scipy.stats

    a = 1.0 * np.asarray(data)
    n = len(a)
    m, se = np.mean(a), scipy.stats.sem(a)
    h = se * scipy.stats.t.ppf((1 + confidence) / 2.0, n - 1)
    return float(m), float(h)


def hp_filter(signal: np.ndarray, cut_off: float = 80, order: int = 10,
              sr: int = 16000) -> np.ndarray:
    """High-pass filter used in evaluation preprocessing
    (reference other.py:58-62)."""
    from scipy.signal import butter, sosfilt

    factor = cut_off / sr * 2
    sos = butter(order, factor, "hp", output="sos")
    return sosfilt(sos, signal)


def print_metrics(x, y, x_hat_list, labels, sr: int = 16000, device="cuda") -> None:
    """Console metric comparison (reference other.py:98-107); PESQ prints
    where it can be computed (``pesq_wb``)."""
    def fmt(ref, deg):
        parts = []
        p = pesq_wb(sr, ref, deg, device)
        if p is not None:
            parts.append(f"PESQ: {p:.2f}")
        parts.append(f"ESTOI: {estoi(ref, deg, sr):.2f}")
        parts.append(f"SI-SDR: {si_sdr(ref, deg):.2f}")
        return ", ".join(parts)

    print(f"Mixture:  {fmt(x, y)}")
    for label, x_hat in zip(labels, x_hat_list):
        print(f"{label}: {fmt(x, x_hat)}")
