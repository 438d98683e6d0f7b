"""The port's losses and learning-rate schedules against fdbm_tpu, on the CPU.

``compute_loss`` takes compressed complex spectrograms; the same numpy
inputs go through ``fdbm_tpu.losses.compute_loss`` and the port's. Both are
fp32 with the same operations in a different order, so the losses agree to
rel 1e-5. The schedules are computed in float32 on both sides and agree to
rel 1e-6.
"""

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


def _specs(seed=0, b=3):
    """x, x_hat: compressed specs of random audio, [B, 1, F, T] complex64."""
    rng = np.random.default_rng(seed)
    window = jnp.asarray(jdsp.get_window("sqrthann", N_FFT))
    out = []
    for scale in (0.3, 0.2):
        audio = jnp.asarray((scale * rng.standard_normal((b, (FRAMES - 1) * HOP))).astype(np.float32))
        out.append(np.array(jdsp.spec_fwd(jdsp.stft(audio, N_FFT, HOP, window)))[:, None])
    return out


def _configs(loss_type):
    kw = dict(n_fft=N_FFT, hop_length=HOP, num_frames=FRAMES, loss_type=loss_type,
              l1_weight=0.01)
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


@pytest.mark.parametrize("kwargs", [dict(loss_type="data_prediction_mel"),
                                    dict(loss_type="data_prediction_melphase"),
                                    dict(loss_type="data_prediction_hybrid", pesq_weight=0.1)])
def test_unported_losses_raise(kwargs):
    x, x_hat = _specs(b=1)
    cfg = losses.LossConfig(n_fft=N_FFT, hop_length=HOP, **kwargs)
    with pytest.raises(NotImplementedError, match="queue 1, item 7"):
        losses.compute_loss(cfg, torch.as_tensor(x_hat), torch.as_tensor(x))


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
