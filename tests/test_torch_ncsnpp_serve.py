"""NCSN++ through the port's serving, training and checkpoint surface, on
the CPU, against fdbm_tpu.

* ``FDBM.enhance_batch`` pads an NCSN++ spectrogram to a multiple of 64
  frames (``pad_mode``: reflection in the serving CLIs, zeros otherwise) and
  trims it in the iSTFT. It is held to the JAX package's at a frame count
  that is not a multiple of 64 and at one shorter than the pad (reflection
  then repeats, as numpy's does), with zero-noise ``sde_ei`` and in
  predictive mode: SI-SDR > 40 dB on the audio and rel-L2 < 1e-4 on the
  sampled spectrogram. (``ode_ei``'s first step amplifies the two STFTs'
  1.8e-7 difference, ROADMAP.md; the SDE sampler with its noise at zero
  runs the same model calls. The JAX package's ``Bridge.sample`` drops the
  noise override, so its bridge here is ``_NoiseBridge``.)
* One training step's loss (rel 1e-5) and gradients (norm-rel 1e-3 per
  leaf, floored at 1e-4 of the global norm) against the JAX step's, on the
  JAX draw of (t, z): tests/test_torch_train.py's gates.
* A reference ``.ckpt`` of ``ncsnpp_v2_5M`` and of its predictive twin,
  written by ``fdbm_tpu.utils.torch_export.save_reference_checkpoint``,
  imports bit-equal to ``ncsnpp_from_flax`` of the same parameters (EMA
  shadow weights served where the file has them) and serves through both
  CLIs; the training CLI trains NCSN++ and its twin and their slots serve.

The nets are narrow (``SERVE_NET``), the registered 5M variants at n_fft
32 (17 bins, H = 16); every weight is at fan-in scale (``fan_in_params``).
"""

import dataclasses
import functools
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ncsnpp import fan_in_params

from fdbm_tpu import dsp as jdsp
from fdbm_tpu import model as jmodel
from fdbm_tpu import sampling as jsampling
from fdbm_tpu.models import BackboneRegistry as JaxRegistry
from fdbm_tpu.models import ncsnpp as jncsn
from fdbm_tpu.utils.torch_export import backbone_params_to_torch, save_reference_checkpoint
from fdbm_tpu_torch import dsp, infer_folder, infer_single, ops
from fdbm_tpu_torch import model as pmodel
from fdbm_tpu_torch import train as ptrain
from fdbm_tpu_torch.checkpoint import load_checkpoint
from fdbm_tpu_torch.models import ncsnpp as pncsn
from fdbm_tpu_torch.utils.audio import read_wav, write_wav
from fdbm_tpu_torch.utils.weights import ncsnpp_from_flax

REPO = Path(__file__).resolve().parents[1]
# Two levels (frames must divide by 2), attention where H = 8: level 1 and the middle.
SERVE_NET = dict(nf=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,))
MODEL = dict(n_fft=32, hop_length=16, num_frames=16)
N_STEPS = 3
# 1110 samples: 70 frames, padded to 128; 300 samples: 19 frames, a pad of 45.
LENGTHS = {"70_frames": 1110, "19_frames": 300}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _si_sdr(est, ref):
    """Scale-invariant SDR in dB, per row."""
    alpha = np.sum(est * ref, -1, keepdims=True) / np.sum(ref * ref, -1, keepdims=True)
    target = alpha * ref
    return 10 * np.log10(np.sum(target ** 2, -1) / np.sum((target - est) ** 2, -1))


class _NoiseBridge(jsampling.Bridge):
    """fdbm_tpu's ``Bridge.sample`` drops the EI samplers' kwargs; this one
    hands ``sde_ei`` its ``noise``, so ``FDBM.enhance_batch`` takes it."""

    def sample(self, model_fn, y, key, noise=None, **kwargs):
        assert self.sampler_type == "sde_ei"
        return self.sde_sampler_ei(model_fn, y, key, noise=noise)


@pytest.fixture(scope="module", params=["generative", "predictive"])
def pair(request):
    """The narrow NCSN++ in both packages' FDBM on the same fan-in weights."""
    mode = request.param
    pred = mode == "predictive"
    cfg = dict(MODEL, mode=mode, backbone="ncsnpp_v2_5M_predictive" if pred else "ncsnpp_v2_5M")
    jf = jmodel.FDBM(jmodel.FDBMConfig(**cfg))
    jf.dnn = jf.dnn_sample = jncsn.NCSNpp(time_conditioned=not pred, **SERVE_NET)
    jf.bridge = _NoiseBridge(**{f.name: getattr(jf.bridge, f.name)
                                for f in dataclasses.fields(jf.bridge)})
    params = fan_in_params(jf.init_params(jax.random.PRNGKey(0)))
    pf = pmodel.FDBM(pmodel.FDBMConfig(**cfg), device="cpu")
    pf.dnn = pncsn.NCSNpp(time_conditioned=not pred, image_size=16, **SERVE_NET).eval()
    pf.dnn.load_state_dict(ncsnpp_from_flax(params))
    return jf, params, pf


@pytest.mark.parametrize("length", sorted(LENGTHS))
@pytest.mark.parametrize("pad_mode", ["reflection", "zero_pad"])
def test_enhance_batch_matches_jax(pair, pad_mode, length):
    jf, params, pf = pair
    n = LENGTHS[length]
    rng = np.random.default_rng(1)
    audio = (0.1 * rng.standard_normal((2, n)) + 0.3 * np.sin(np.arange(n) * 0.07)).astype(
        np.float32)
    frames = dsp.num_frames_for_length(n, MODEL["n_fft"], MODEL["hop_length"])
    padded = -(-frames // 64) * 64
    noise = np.zeros((N_STEPS + 1, 2, 1, 17, padded), np.complex64)
    key = jax.random.PRNGKey(0)

    @jax.jit
    def jax_side(p, a, nz):
        spec = jf.audio_to_spec(a)
        if pad_mode == "reflection":  # as fdbm_tpu/model.py:enhance_batch pads
            spec = jax.lax.complex(*(jdsp.pad_spec(part, pad_mode)
                                     for part in (jnp.real(spec), jnp.imag(spec))))
        else:
            spec = jdsp.pad_spec(spec, pad_mode)
        sample = jf.enhance_spec(p, spec, key, "sde_ei", N_STEPS, noise=nz)
        return sample, jf.enhance_batch(p, a, key, "sde_ei", N_STEPS, pad_mode=pad_mode,
                                        noise=nz)

    want_spec, want = (np.asarray(v) for v in jax_side(params, jnp.asarray(audio),
                                                       jnp.asarray(noise)))
    y = torch.from_numpy(audio)
    spec = dsp.pad_spec(pf.audio_to_spec(y), pad_mode)
    assert spec.shape[-1] == padded
    got_spec = pf.enhance_spec(spec, sampler_type="sde_ei", N=N_STEPS,
                               noise=torch.from_numpy(noise)).numpy()
    got = pf.enhance_batch(y, sampler_type="sde_ei", N=N_STEPS, pad_mode=pad_mode,
                           noise=torch.from_numpy(noise)).numpy()
    assert got.shape == want.shape == (2, n)
    assert _rel(got_spec, want_spec) < 1e-4
    assert _si_sdr(got, want).min() > 40


def test_train_step_matches_jax():
    """The generative loss on the narrow net, (t, z) from the JAX draw."""
    cfg = dict(MODEL, backbone="ncsnpp_v2_5M")
    jf = jmodel.FDBM(jmodel.FDBMConfig(**cfg))
    jf.dnn = jf.dnn_sample = jncsn.NCSNpp(**SERVE_NET)
    params = fan_in_params(jf.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    n = (MODEL["num_frames"] - 1) * MODEL["hop_length"]
    x = (0.1 * rng.standard_normal((2, n))).astype(np.float32)
    y = (x + 0.02 * rng.standard_normal((2, n))).astype(np.float32)
    key = jax.random.PRNGKey(3)
    t, _, z, _ = jf._sample_prior(key, jf.audio_to_spec(jnp.asarray(x)),
                                  jf.audio_to_spec(jnp.asarray(y)))
    jloss, jgrads = jax.jit(jax.value_and_grad(jf.loss_fn))(
        params, (jnp.asarray(x), jnp.asarray(y)), key)

    pf = pmodel.FDBM(pmodel.FDBMConfig(**cfg), device="cpu")
    pf.dnn = pncsn.NCSNpp(image_size=16, **SERVE_NET)
    pf.dnn.load_state_dict(ncsnpp_from_flax(params))
    state = pmodel.TrainState(pf.dnn)
    loss = pf.loss_fn(pf.to_device((x, y)), prior=(torch.as_tensor(np.array(t)),
                                                   torch.as_tensor(np.array(z))))
    grads = dict(zip(state.params, torch.autograd.grad(loss, list(state.params.values()))))
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = ncsnpp_from_flax(jax.device_get(jgrads))
    assert set(grads) == set(want) - {"time_emb.W"}  # W is frozen in both
    gnorm = float(np.sqrt(sum(float((want[k] * want[k]).sum()) for k in grads)))
    for name, g in grads.items():
        rel = float((g - want[name]).norm()) / max(float(want[name].norm()), 1e-4 * gnorm)
        assert rel < 1e-3, (name, rel)


# -- reference .ckpt files ----------------------------------------------------------------

HP = dict(n_fft=32, hop_length=16, N=2, sampler_type="sde_ei")


@functools.lru_cache(maxsize=None)
def _jax_init(backbone):
    return jax.jit(JaxRegistry.get_by_name(backbone)().init)


@functools.lru_cache(maxsize=None)
def _flax_5m(backbone, seed=0):
    """Fan-in params of the registered variant at 17 bins and 8 frames."""
    y = jnp.zeros((1, 1, 17, 8), jnp.complex64)
    args = (None, y) if backbone.endswith("_predictive") else (y, y, jnp.ones((1,)))
    return fan_in_params(_jax_init(backbone)(jax.random.PRNGKey(seed), *args), seed)


@pytest.fixture(scope="module", params=["ncsnpp_v2_5M", "ncsnpp_v2_5M_predictive"])
def ckpt(request, tmp_path_factory):
    backbone = request.param
    params = _flax_5m(backbone)
    path = str(tmp_path_factory.mktemp("ref") / f"{backbone}.ckpt")
    mode = "predictive" if backbone.endswith("_predictive") else "generative"
    save_reference_checkpoint(path, backbone, params, hyper_parameters=dict(HP, mode=mode))
    return backbone, path, params


def test_reference_ckpt_imports_bit_equal(ckpt):
    backbone, path, params = ckpt
    fdbm = load_checkpoint(path, device="cpu")
    assert (fdbm.cfg.backbone, fdbm.cfg.n_fft, fdbm.dnn.image_size) == (backbone, 32, 16)
    want = ncsnpp_from_flax(params)
    got = fdbm.dnn.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_both_clis_serve_a_reference_ckpt(ckpt, tmp_path):
    _, path, _ = ckpt
    rng = np.random.default_rng(3)
    noisy = tmp_path / "in" / "x.wav"
    noisy.parent.mkdir()
    write_wav(str(noisy), (0.3 * rng.standard_normal(700)).astype(np.float32), 16000)
    x_hat = infer_single.main(["-C", str(REPO / "configs" / "config_infer_single.yaml"),
                               "--device", "cpu", f"ckpt={path}", f"noisy_file={noisy}",
                               f"output_file={tmp_path / 'single.wav'}", "N=2",
                               "sampler_type=sde_ei"])
    assert x_hat.shape == (700,) and np.isfinite(x_hat).all()
    ops.reset_launch_counts()
    stats = infer_folder.main(["-C", str(REPO / "configs" / "config_infer_folder.yaml"),
                               "--device", "cpu", f"ckpt={path}", f"test_dir={tmp_path / 'in'}",
                               f"enhanced_dir={tmp_path / 'out'}", "N=2"])
    assert (stats.files, stats.failures) == (1, 0)
    assert read_wav(str(tmp_path / "out" / "x.wav"))[0].shape == (1, 700)
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)


def test_ema_shadow_weights_are_served(tmp_path):
    """torch_ema's shadow of every trainable parameter, NCSN++'s frozen
    ``all_modules.0.W`` left out."""
    backbone = "ncsnpp_v2_5M"
    params, shadow_params = _flax_5m(backbone), _flax_5m(backbone, seed=1)
    sd = backbone_params_to_torch(backbone, params)
    shadow_sd = backbone_params_to_torch(backbone, shadow_params)
    path = str(tmp_path / "ema.ckpt")
    tensor = lambda v: torch.from_numpy(np.ascontiguousarray(v))
    torch.save({"state_dict": {f"dnn.{k}": tensor(v) for k, v in sd.items()},
                "hyper_parameters": dict(HP, backbone=backbone),
                "ema": {"shadow_params": [tensor(v) for k, v in shadow_sd.items()
                                          if k != "all_modules.0.W"]}}, path)
    served = load_checkpoint(path, device="cpu").dnn.state_dict()
    want, stored = ncsnpp_from_flax(shadow_params), ncsnpp_from_flax(params)
    for k, v in want.items():
        assert torch.equal(served[k], stored[k] if k == "time_emb.W" else v), k


# -- the training CLI ---------------------------------------------------------------------


def _dataset(base):
    rng = np.random.default_rng(0)
    for subset, lengths in (("train", [300, 260, 400, 350]), ("valid", [300, 280])):
        for kind in ("clean", "noisy"):
            os.makedirs(os.path.join(base, subset, kind))
        for i, n in enumerate(lengths):
            x = (0.3 * np.sin(np.arange(n) * 0.02 * (i + 1))).astype(np.float32)
            write_wav(os.path.join(base, subset, "clean", f"{i}.wav"), x, 16000)
            write_wav(os.path.join(base, subset, "noisy", f"{i}.wav"),
                      (x + 0.05 * rng.standard_normal(n)).astype(np.float32), 16000)


@pytest.mark.parametrize("config,backbone", [("config.yaml", "ncsnpp_v2_5M"),
                                             ("config_predictive.yaml",
                                              "ncsnpp_v2_5M_predictive")])
def test_cli_trains_resumes_and_serves_ncsnpp(tmp_path, config, backbone):
    """n_fft 32 (H = 16) and 8 frames: both divide by 2^3, the 5M's four levels."""
    base = str(tmp_path)
    _dataset(base)
    args = ["-C", str(REPO / "configs" / config), "--device", "cpu", f"base_dir={base}",
            f"log_dir={base}/logs", f"backbone={backbone}", "n_fft=32", "hop_length=16",
            "num_frames=8", "num_workers=1", "num_eval_files=0"]
    run = ptrain.main(args + ["--max_steps", "2"])
    ptrain.main(args + ["--max_steps", "3", "--resume", run])
    last = torch.load(Path(run) / "checkpoints" / "last.pt", map_location="cpu",
                      weights_only=True)
    assert last["train_state"]["step"] == 3
    records = [json.loads(ln) for ln in (Path(run) / "metrics.jsonl").read_text().splitlines()]
    valid = [r["valid_loss"] for r in records if "valid_loss" in r]
    assert valid and all(np.isfinite(valid))

    served = load_checkpoint(run, device="cpu")
    assert served.cfg.backbone == backbone and served.dnn.image_size == 16
    stats = infer_folder.main(["-C", str(REPO / "configs" / "config_infer_folder.yaml"),
                               "--device", "cpu", f"ckpt={run}", "N=2",
                               f"test_dir={base}/valid/noisy", f"enhanced_dir={base}/out"])
    assert (stats.files, stats.failures) == (2, 0)
    for i, n in enumerate([300, 280]):
        x, _ = read_wav(os.path.join(base, "out", f"{i}.wav"))
        assert x.shape == (1, n) and np.isfinite(x).all()
