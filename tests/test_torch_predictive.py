"""The port's predictive mode against fdbm_tpu, on the CPU.

A narrow predictive TF-GridNet (no time embedding, reads only y) gets the
same perturbed Flax weights in both packages through ``utils/weights.py``:
the backbone's output to rel-L2 1e-4, and one predictive training step's
loss to rel 1e-5 and gradients per leaf to norm-rel 1e-3 with the
denominator floored at 1e-4 of the global norm (tests/test_torch_train.py's gates for the
generative step). Predictive serving is one backbone call on y, no sampler.
``configs/config_predictive.yaml`` trains through the CLI (with
``num_eval_files=0``) and its ``last`` slot serves through the folder CLI.
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdbm_tpu import model as jmodel
from fdbm_tpu.models import tfgridnet as jtfg
from fdbm_tpu_torch import infer_folder, ops
from fdbm_tpu_torch import model as pmodel
from fdbm_tpu_torch import train as ptrain
from fdbm_tpu_torch.config import load_config
from fdbm_tpu_torch.models.tfgridnet import TFGridNet
from fdbm_tpu_torch.utils.audio import read_wav, write_wav
from fdbm_tpu_torch.utils.weights import tfgridnet_from_flax

REPO = Path(__file__).resolve().parents[1]
NET = dict(n_layers=1, emb_dim=16, hidden=24, time_conditioned=False)
MODEL = dict(mode="predictive", backbone="tfgridnet_4l32c80_predictive", n_fft=64,
             hop_length=32, num_frames=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _perturbed(params, seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32),
        jax.device_get(params))


def _spec(b=2, frames=16, seed=0):
    rng = np.random.default_rng(seed)
    shape = (b, 1, 33, frames)
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * 0.3).astype(
        np.complex64)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("net", [NET, dict(n_layers=2, emb_dim=8, hidden=8,
                                            time_conditioned=False)], ids=["1l16c24", "2l8c8"])
def test_predictive_backbone_matches_flax(net):
    """Narrow twins; ``tests/test_torch_ref_ckpt.py`` holds the full-width
    ``tfgridnet_4l32c80_predictive``."""
    y = _spec()
    jm, pm = jtfg.TFGridNet(**net), TFGridNet(**net)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), None, jnp.asarray(y)))
    assert not any(k.startswith("time") for k in params["params"])
    sd = tfgridnet_from_flax(params)
    assert not any(k.startswith("time") for k in sd) and pm.conv_in.in_channels == 2
    pm.load_state_dict(sd)
    want = jm.apply(params, None, jnp.asarray(y))
    with torch.no_grad():
        for train in (False, True):  # the serving route and the training route
            got = pm.train(train)(None, torch.as_tensor(y))
            assert got.shape == y.shape and _rel(got.numpy(), want) < 1e-4, train


def _jax_fdbm():
    jf = jmodel.FDBM(jmodel.FDBMConfig(**MODEL))
    jf.dnn = jf.dnn_sample = jtfg.TFGridNet(**NET)
    return jf


def test_predictive_train_step_matches_jax():
    jf = _jax_fdbm()
    params = _perturbed(jf.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    n = 15 * 32
    x = (0.1 * rng.standard_normal((2, n))).astype(np.float32)
    y = (x + 0.02 * rng.standard_normal((2, n))).astype(np.float32)
    jloss, jgrads = jax.jit(jax.value_and_grad(jf.loss_fn))(
        params, (jnp.asarray(x), jnp.asarray(y)), jax.random.PRNGKey(3))

    pf = pmodel.FDBM(pmodel.FDBMConfig(**MODEL), device="cpu")
    pf.dnn = TFGridNet(**NET)
    pf.dnn.load_state_dict(tfgridnet_from_flax(params))
    state = pmodel.TrainState(pf.dnn)
    loss = pf.loss_fn(pf.to_device((x, y)))
    grads = dict(zip(state.params, torch.autograd.grad(loss, list(state.params.values()))))
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = tfgridnet_from_flax(jax.device_get(jgrads))
    assert set(grads) == set(want)
    gnorm = float(np.sqrt(sum(float((w * w).sum()) for w in want.values())))
    for name, g in grads.items():
        rel = float((g - want[name]).norm()) / max(float(want[name].norm()), 1e-4 * gnorm)
        assert rel < 1e-3, (name, rel)
    # serving: one backbone call on y, whatever the sampler
    spec = torch.as_tensor(_spec(b=1))
    with torch.no_grad():
        for sampler in ("sde_ei", "pc"):
            np.testing.assert_array_equal(pf.enhance_spec(spec, sampler_type=sampler, N=5),
                                          pf.dnn.eval()(None, spec))


def test_generative_backbone_in_predictive_mode_raises():
    cfg = dict(MODEL, backbone="tfgridnet_4l32c80")
    with pytest.raises(ValueError, match="_predictive"):
        jmodel.FDBM(jmodel.FDBMConfig(**cfg))
    with pytest.raises(ValueError, match="_predictive"):
        pmodel.FDBM(pmodel.FDBMConfig(**cfg), device="cpu")


@pytest.mark.parametrize("name", ["config_predictive.yaml", "config_infer_folder.yaml"])
def test_configs_load(name):
    cfg = pmodel.FDBMConfig.from_dict(load_config(str(REPO / "configs" / name)))
    if name == "config_predictive.yaml":
        assert (cfg.mode, cfg.backbone) == ("predictive", "tfgridnet_5l32c100_predictive")
        fdbm = pmodel.FDBM(cfg, device="cpu")
        assert not fdbm.dnn.time_conditioned and len(fdbm.dnn.blocks) == 5
    else:
        assert cfg.sampler_type == "ode_ei" and cfg.N == 5


def test_predictive_config_trains_and_serves_through_the_folder_cli(tmp_path):
    base = str(tmp_path)
    rng = np.random.default_rng(0)
    for subset, lengths in (("train", [300, 260, 400, 350]), ("valid", [300, 280])):
        for kind in ("clean", "noisy"):
            os.makedirs(os.path.join(base, subset, kind))
        for i, n in enumerate(lengths):
            x = (0.3 * np.sin(np.arange(n) * 0.02 * (i + 1))).astype(np.float32)
            write_wav(os.path.join(base, subset, "clean", f"{i}.wav"), x, 16000)
            write_wav(os.path.join(base, subset, "noisy", f"{i}.wav"),
                      (x + 0.05 * rng.standard_normal(n)).astype(np.float32), 16000)
    run = ptrain.main(["-C", str(REPO / "configs" / "config_predictive.yaml"), "--device", "cpu",
                       "--max_steps", "2", f"base_dir={base}", f"log_dir={base}/logs",
                       "backbone=tfgridnet_4l32c80_predictive", "n_fft=32", "hop_length=16",
                       "num_frames=8", "num_workers=1", "num_eval_files=0"])
    records = [json.loads(ln) for ln in (Path(run) / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(r["valid_loss"]) for r in records if "valid_loss" in r)

    ops.reset_launch_counts()
    stats = infer_folder.main(["-C", str(REPO / "configs" / "config_infer_folder.yaml"),
                               "--device", "cpu", f"ckpt={run}",
                               f"test_dir={base}/valid/noisy", f"enhanced_dir={base}/out"])
    assert (stats.files, stats.failures) == (2, 0)
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)  # CPU: plain versions
    for i, n in enumerate([300, 280]):
        x, _ = read_wav(os.path.join(base, "out", f"{i}.wav"))
        assert x.shape == (1, n) and np.isfinite(x).all()
