"""Reference Lightning ``.ckpt`` files served by the port, on the CPU.

``fdbm_tpu.utils.torch_export.save_reference_checkpoint`` (imported only
here) writes seeded Flax parameters of ``tfgridnet_4l32c80`` and of its
predictive twin in the reference's layout; the port's ``load_checkpoint``
imports them through ``utils/torch_port.py``. The imported ``state_dict``
must equal ``utils/weights.tfgridnet_from_flax`` of the same parameters bit
for bit (the two layouts are transposes, flips and a permutation of the same
numbers, and the LSTM bias is exported as bias_ih + zeros), and the EMA
shadow weights must replace the parameters when the file has them.

The backbone's output against Flax: at these full widths with Flax-init
weights, fp32 itself is the limit. Port and Flax differ by 1.9e-4
(predictive) and 3.4e-4 (generative), and each is as far from a float64 run
of the same network (port 2.0e-4, Flax 3.4e-4 on the predictive twin), so a
1e-4 gate between the two fp32 routes cannot hold. The port is held to
rel-L2 1e-4 of the float64 run or, where fp32 cannot reach that, no farther
from it than Flax is; and within 1e-3 of Flax.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdbm_tpu.models import BackboneRegistry as JaxRegistry
from fdbm_tpu.utils.torch_export import backbone_params_to_torch, save_reference_checkpoint
from fdbm_tpu_torch import infer_folder, infer_single
from fdbm_tpu_torch.checkpoint import load_checkpoint
from fdbm_tpu_torch.utils.audio import read_wav, write_wav
from fdbm_tpu_torch.utils.torch_port import backbone_state_dict_from_torch
from fdbm_tpu_torch.utils.weights import tfgridnet_from_flax

REPO = Path(__file__).resolve().parents[1]
HP = dict(n_fft=32, hop_length=16, N=3, sampler_type="ode_ei")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spec(seed=0):
    rng = np.random.default_rng(seed)
    shape = (2, 1, 33, 16)
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * 0.3).astype(
        np.complex64)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _flax(backbone, y, seed=0):
    jm = JaxRegistry.get_by_name(backbone)()
    pred = backbone.endswith("_predictive")
    args = (None, jnp.asarray(y)) if pred else (jnp.asarray(y), jnp.asarray(y),
                                                  jnp.array([0.5, 0.8], jnp.float32))
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), *args))
    return jm, args, params


@pytest.fixture(scope="module", params=["tfgridnet_4l32c80", "tfgridnet_4l32c80_predictive"])
def ckpt(request, tmp_path_factory):
    backbone = request.param
    y = _spec()
    jm, args, params = _flax(backbone, y)
    path = str(tmp_path_factory.mktemp("ref") / f"{backbone}.ckpt")
    hp = dict(HP, mode="predictive" if backbone.endswith("_predictive") else "generative")
    save_reference_checkpoint(path, backbone, params, hyper_parameters=hp)
    return backbone, path, y, np.asarray(jm.apply(params, *args)), params


def test_reference_ckpt_loads_the_flax_weights(ckpt):
    backbone, path, y, want, params = ckpt
    fdbm = load_checkpoint(path, device="cpu", overrides={"N": 7, "sampler_type": None})
    assert fdbm.cfg.backbone == backbone and (fdbm.cfg.n_fft, fdbm.cfg.N) == (32, 7)
    assert fdbm.cfg.sampler_type == "ode_ei"  # None overrides nothing
    assert fdbm.cfg.mode == ("predictive" if backbone.endswith("_predictive") else "generative")
    sd = tfgridnet_from_flax(params)
    got_sd = fdbm.dnn.state_dict()
    assert set(got_sd) == set(sd)
    for k, v in sd.items():
        assert torch.equal(got_sd[k], v), k

    targs = (None, torch.as_tensor(y)) if backbone.endswith("_predictive") else (
        torch.as_tensor(y), torch.as_tensor(y), torch.tensor([0.5, 0.8]))
    with torch.no_grad():
        got = fdbm.dnn.eval()(*targs).numpy()
        f64 = fdbm.dnn.double()(*(a if a is None else a.to(torch.complex128 if a.is_complex()
                                                            else torch.float64)
                                  for a in targs)).numpy()
    port_err, flax_err = _rel(got, f64), _rel(want, f64)
    assert port_err < max(1e-4, flax_err), (port_err, flax_err)
    assert _rel(got, want) < 1e-3


def test_ema_shadow_weights_are_served(ckpt, tmp_path):
    backbone, _, y, _, params = ckpt
    _, _, shadow_params = _flax(backbone, y, seed=1)
    sd = backbone_params_to_torch(backbone, params)
    shadow_sd = backbone_params_to_torch(backbone, shadow_params)
    path = str(tmp_path / "ema.ckpt")
    torch.save({"state_dict": {f"dnn.{k}": torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in sd.items()},
                "hyper_parameters": dict(HP, backbone=backbone),
                "ema": {"shadow_params": [torch.from_numpy(np.ascontiguousarray(v))
                                          for k, v in shadow_sd.items()
                                          if k != "get_time_emb.W"]}}, path)
    served = load_checkpoint(path, device="cpu").dnn.state_dict()
    # the shadow's weights, and the stored W (torch_ema does not track it)
    want = tfgridnet_from_flax(shadow_params)
    for k, v in want.items():
        expected = tfgridnet_from_flax(params)[k] if k == "time_emb.W" else v
        assert torch.equal(served[k], expected), k


def test_both_clis_serve_a_reference_ckpt(ckpt, tmp_path):
    backbone, path, *_ = ckpt
    rng = np.random.default_rng(3)
    noisy = tmp_path / "in" / "x.wav"
    noisy.parent.mkdir()
    write_wav(str(noisy), (0.3 * rng.standard_normal(700)).astype(np.float32), 16000)
    x_hat = infer_single.main(["-C", str(REPO / "configs" / "config_infer_single.yaml"),
                               "--device", "cpu", f"ckpt={path}", f"noisy_file={noisy}",
                               f"output_file={tmp_path / 'single.wav'}", "N=2",
                               "sampler_type=sde_ei"])
    assert x_hat.shape == (700,) and np.isfinite(x_hat).all()
    stats = infer_folder.main(["-C", str(REPO / "configs" / "config_infer_folder.yaml"),
                               "--device", "cpu", f"ckpt={path}", f"test_dir={tmp_path / 'in'}",
                               f"enhanced_dir={tmp_path / 'out'}", "N=2"])
    assert (stats.files, stats.failures) == (1, 0)
    assert read_wav(str(tmp_path / "out" / "x.wav"))[0].shape == (1, 700)


def test_unknown_backbone_preset_raises():
    """NCSN++'s presets import (tests/test_torch_ncsnpp_serve.py); a name
    with no preset raises."""
    with pytest.raises(ValueError, match="No torch-import preset"):
        backbone_state_dict_from_torch("resnet", {})
