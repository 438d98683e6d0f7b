"""The port's losses and learning-rate schedules against fdbm_tpu, on the CPU.

``compute_loss`` takes compressed complex spectrograms; the same numpy
inputs go through ``fdbm_tpu.losses.compute_loss`` and the port's. Both are
fp32 with the same operations in a different order, so the losses agree to
rel 1e-5, and their gradients with respect to the estimate to norm-rel 1e-4
(the PESQ term's and the phase loss's chains are long); the building blocks
on audio agree to rel 1e-5 and the mel filterbank (float64 in numpy, cast to
float32) to 1e-6 absolute. The schedules are computed in float32 on both
sides and agree to rel 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdbm_tpu import dsp as jdsp
from fdbm_tpu import losses as jlosses
from fdbm_tpu.model import make_lr_schedule as jax_schedule
from fdbm_tpu_torch import losses
from fdbm_tpu_torch.model import make_lr_schedule

N_FFT, HOP, FRAMES = 64, 32, 16


def _specs(seed=0, b=3, frames=FRAMES):
    """x, x_hat: compressed specs of random audio, [B, 1, F, T] complex64."""
    rng = np.random.default_rng(seed)
    window = jnp.asarray(jdsp.get_window("sqrthann", N_FFT))
    out = []
    for scale in (0.3, 0.2):
        audio = jnp.asarray((scale * rng.standard_normal((b, (frames - 1) * HOP))).astype(np.float32))
        out.append(np.array(jdsp.spec_fwd(jdsp.stft(audio, N_FFT, HOP, window)))[:, None])
    return out


def _configs(loss_type, frames=FRAMES, pesq_weight=0.0):
    kw = dict(n_fft=N_FFT, hop_length=HOP, num_frames=frames, loss_type=loss_type,
              l1_weight=0.01, pesq_weight=pesq_weight)
    window = tuple(jdsp.get_window("sqrthann", N_FFT).tolist())
    return jlosses.LossConfig(window=window, **kw), losses.LossConfig(window=window, **kw)


@pytest.mark.parametrize("loss_type", ["data_prediction", "data_prediction_hybrid"])
@pytest.mark.parametrize("masked", [False, True])
def test_compute_loss_matches_jax(loss_type, masked):
    x, x_hat = _specs()
    weights = np.array([1.0, 0.0, 1.0], np.float32) if masked else None
    jcfg, pcfg = _configs(loss_type)
    want = float(jlosses.compute_loss(jcfg, jnp.asarray(x_hat), jnp.asarray(x),
                                      None if weights is None else jnp.asarray(weights)))
    got = float(losses.compute_loss(pcfg, torch.as_tensor(x_hat), torch.as_tensor(x),
                                    None if weights is None else torch.as_tensor(weights)))
    assert np.isfinite(got)
    assert abs(got - want) <= 1e-5 * abs(want)
    if masked:
        # the masked item is out of the mean: dropping it gives the same loss
        keep = [0, 2]
        alone = float(losses.compute_loss(pcfg, torch.as_tensor(x_hat[keep]),
                                          torch.as_tensor(x[keep])))
        assert abs(alone - got) <= 1e-5 * abs(got)


def _jax_value_and_grad(jcfg, x, x_hat, weights):
    """The JAX loss and d loss / d x_hat in torch's convention (for a real
    loss of a complex input JAX returns the conjugate of torch's), jitted."""
    fn = jax.jit(jax.value_and_grad(lambda a, b, w: jlosses.compute_loss(jcfg, a, b, w)))
    value, grad = fn(jnp.asarray(x_hat), jnp.asarray(x), jnp.asarray(weights))
    return float(value), np.conj(np.asarray(grad))


@pytest.mark.parametrize("kwargs", [dict(loss_type="data_prediction_mel"),
                                    dict(loss_type="data_prediction_melphase"),
                                    dict(loss_type="data_prediction_hybrid", pesq_weight=0.1),
                                    dict(loss_type="data_prediction", pesq_weight=0.1)])
def test_unported_losses_raise(kwargs):
    """The objectives that raised until the mel, phase and PESQ criteria were
    ported: each now matches fdbm_tpu.losses.compute_loss, value (rel 1e-5)
    and gradient with respect to x_hat (norm-rel 1e-4), with the validation
    mask on. 1504-sample crops: longer than the mel loss's 2048 window's
    half, so torch's reflect padding applies (shorter ones are covered by
    test_mel_loss_on_short_signals_matches_jax)."""
    x, x_hat = _specs(frames=48)
    weights = np.array([1.0, 0.0, 1.0], np.float32)
    jcfg, pcfg = _configs(frames=48, **kwargs)
    want, jg = _jax_value_and_grad(jcfg, x, x_hat, weights)
    xh = torch.as_tensor(x_hat).requires_grad_(True)
    loss = losses.compute_loss(pcfg, xh, torch.as_tensor(x), torch.as_tensor(weights))
    loss.backward()
    got, g = float(loss), xh.grad.numpy()
    assert np.isfinite(got) and abs(got - want) <= 1e-5 * abs(want), (got, want)
    assert np.linalg.norm(g) > 0 and not np.abs(g[1]).any()  # the masked item takes none
    assert np.linalg.norm(g - jg) / np.linalg.norm(jg) < 1e-4


@pytest.mark.parametrize("loss_type", ["data_prediction_mel", "data_prediction_melphase"])
def test_pesq_weight_with_a_mel_loss_raises(loss_type):
    x, x_hat = _specs(b=1)
    _, pcfg = _configs(loss_type=loss_type, pesq_weight=0.5)
    with pytest.raises(ValueError, match="pesq_weight"):
        losses.compute_loss(pcfg, torch.as_tensor(x_hat), torch.as_tensor(x))


def test_mel_loss_on_short_signals_matches_jax():
    """Crops shorter than half a 2048 window: both packages reflect as numpy
    does, repeating the reflection."""
    x, x_hat = _specs()
    jcfg, pcfg = _configs(loss_type="data_prediction_mel")
    want = float(jax.jit(lambda a, b: jlosses.compute_loss(jcfg, a, b))(jnp.asarray(x_hat),
                                                                      jnp.asarray(x)))
    got = float(losses.compute_loss(pcfg, torch.as_tensor(x_hat), torch.as_tensor(x)))
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("sr,n_fft,n_mels", [(16000, 32, 5), (16000, 512, 80),
                                             (16000, 2048, 210), (8000, 256, 40)])
def test_mel_filters_match_jax(sr, n_fft, n_mels):
    want = jlosses.mel_filters(sr, n_fft, n_mels)
    got = losses.mel_filters(sr, n_fft, n_mels)
    assert got.shape == want.shape == (n_mels, n_fft // 2 + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _audio(seed=0, b=3, n=3000):
    rng = np.random.default_rng(seed)
    x = (0.3 * np.sin(np.arange(n) * 0.03)[None] + 0.05 * rng.standard_normal((b, n)))
    y = x + 0.1 * rng.standard_normal((b, n))
    return x.astype(np.float32), y.astype(np.float32)


def _blocks():
    """name -> (JAX call, port call) of the building-block losses, on
    (estimate, reference) audio or (for the phase loss) specs."""
    window = dsp_window = jdsp.get_window("sqrthann", N_FFT)
    w = np.array([1.0, 1.0, 0.0], np.float32)
    jw, pw = jnp.asarray(w), torch.as_tensor(w)
    mel = dict(n_mels=(20, 40), win_lengths=(128, 256), hop_lengths=(32, 64))
    return {
        "si_sdr": (lambda e, r: jlosses.si_sdr_loss(r, e),
                   lambda e, r: losses.si_sdr_loss(r, e)),
        "si_sdr_unscaled_clipped_none": (
            lambda e, r: jlosses.si_sdr_loss(r, e, scaling=False, zero_mean=False,
                                             clip_min=-5.0, reduction="none"),
            lambda e, r: losses.si_sdr_loss(r, e, scaling=False, zero_mean=False,
                                            clip_min=-5.0, reduction="none")),
        "multiscale_stft": (lambda e, r: jlosses.multiscale_stft_loss(e, r),
                            lambda e, r: losses.multiscale_stft_loss(e, r)),
        "mel_masked": (lambda e, r: jlosses.mel_spectrogram_loss(e, r, weights=jw, **mel),
                       lambda e, r: losses.mel_spectrogram_loss(e, r, weights=pw, **mel)),
        "mel7": (lambda e, r: jlosses.mel_spectrogram_loss(e, r, **jlosses.MEL7),
                 lambda e, r: losses.mel_spectrogram_loss(e, r, **losses.MEL7)),
        "spec_mag_sisnr": (
            lambda e, r: jlosses.spec_mag_sisnr_loss(e, r, N_FFT, HOP, jnp.asarray(window)),
            lambda e, r: losses.spec_mag_sisnr_loss(e, r, N_FFT, HOP,
                                                    torch.as_tensor(dsp_window))),
        "phase_masked": (lambda e, r: jlosses.phase_loss(e, r, jw),
                         lambda e, r: losses.phase_loss(e, r, pw)),
    }


@pytest.mark.parametrize("name", list(_blocks()))
def test_building_blocks_match_jax(name):
    jf, pf = _blocks()[name]
    if name.startswith("phase"):
        est, ref = _specs(frames=24)
    else:
        est, ref = _audio()
    want = np.asarray(jax.jit(jf)(jnp.asarray(est), jnp.asarray(ref)))
    got = pf(torch.as_tensor(est), torch.as_tensor(ref)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


WARMUP = {"scheduler": "warmup", "config": {"warmup_steps": 10, "decay_until_step": 100,
                                            "max_lr": 5e-4, "min_lr": 5e-6}}


@pytest.mark.parametrize("scheduler_config,lr", [
    (None, 3e-4), ({"scheduler": "fixed"}, 1e-4), (WARMUP, 1e-4),
    ({"scheduler": "exp", "config": {"gamma": 0.99}}, 2e-4)])
def test_lr_schedule_matches_jax(scheduler_config, lr):
    ours, theirs = make_lr_schedule(scheduler_config, lr), jax_schedule(scheduler_config, lr)
    for step in (0, 1, 5, 10, 11, 55, 99, 100, 101, 1000):
        want = float(theirs(step))
        assert ours(step) == pytest.approx(want, rel=1e-6, abs=0), step
    if scheduler_config is WARMUP:
        assert ours(0) == 0.0


def test_unknown_scheduler_raises():
    with pytest.raises(ValueError, match="Unknown scheduler"):
        make_lr_schedule({"scheduler": "cosine"}, 1e-4)
