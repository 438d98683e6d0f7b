"""The port's training against fdbm_tpu, on the CPU.

A narrow TF-GridNet (1 layer, C=16, H=24, n_fft 64) gets the same Flax
weights in both packages through ``utils/weights.py``, the same batch, and
JAX's ``(t, z)`` draw from ``FDBM._sample_prior`` injected into the port.
Tolerances: the loss to rel 1e-5 (fp32, sums in another order); the
gradients per leaf to norm-rel 1e-3 with the denominator floored at 1e-4 of
the global norm, the JAX package's own gate for its training kernel
(tests/test_gridrnn_train.py: leaves whose exact gradient is ~0 hold fp32
cancellation residue). The optimiser is held to ``FDBM.train_step`` with
the JAX step's own gradients fed to the port, so params and EMA after each
step agree to fp32 rounding (rtol 1e-5, atol 1e-7). The data pipeline
yields the same batches as JAX's for one seed, and the CLI trains, resumes
and serves its ``last`` slot.
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdbm_tpu import data as jdata
from fdbm_tpu import model as jmodel
from fdbm_tpu.models import tfgridnet as jtfg
from fdbm_tpu_torch import data as pdata
from fdbm_tpu_torch import infer_single
from fdbm_tpu_torch import model as pmodel
from fdbm_tpu_torch import train as ptrain
from fdbm_tpu_torch.checkpoint import load_checkpoint
from fdbm_tpu_torch.models.tfgridnet import TFGridNet
from fdbm_tpu_torch.utils.audio import read_wav, write_wav
from fdbm_tpu_torch.utils.weights import tfgridnet_from_flax

REPO = Path(__file__).resolve().parents[1]
NET = dict(n_layers=1, emb_dim=16, hidden=24)
MODEL = dict(n_fft=64, hop_length=32, num_frames=16)
WARMUP = {"scheduler": "warmup", "config": {"warmup_steps": 2, "decay_until_step": 10,
                                            "max_lr": 1e-3, "min_lr": 1e-5}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain versions run many tiny products, and
    the test workers share the machine's cores (oversubscribed BLAS threads
    spin instead of working)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed=0, b=2, frames=16, hop=32):
    rng = np.random.default_rng(seed)
    n = (frames - 1) * hop
    x = (0.1 * rng.standard_normal((b, n))).astype(np.float32)
    y = (x + 0.02 * rng.standard_normal((b, n))).astype(np.float32)
    return x, y


def _jax_fdbm(accumulate=1):
    jf = jmodel.FDBM(jmodel.FDBMConfig(scheduler_config=WARMUP,
                                       accumulate_grad_batches=accumulate, **MODEL))
    jf.dnn = jf.dnn_sample = jtfg.TFGridNet(**NET)
    return jf


@pytest.fixture(scope="module")
def jax_side():
    """Perturbed Flax params of the narrow net (so ones/zeros inits hide no
    swapped leaf) and the JAX loss's value_and_grad, compiled once."""
    jf = _jax_fdbm()
    params = jf.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32),
        jax.device_get(params))
    return jf, params, jax.jit(jax.value_and_grad(jf.loss_fn))


def _port(params, accumulate=1):
    pf = pmodel.FDBM(pmodel.FDBMConfig(scheduler_config=WARMUP,
                                       accumulate_grad_batches=accumulate, **MODEL),
                     device="cpu")
    pf.dnn = TFGridNet(**NET)
    pf.dnn.load_state_dict(tfgridnet_from_flax(params))
    return pf


def _from_jax(tree, keys):
    sd = tfgridnet_from_flax(jax.device_get(tree))
    return {k: sd[k] for k in keys}


def test_one_train_step_loss_and_grads_match_jax(jax_side):
    jf, params, value_and_grad = jax_side
    pf = _port(params)
    x, y = _batch()
    key = jax.random.PRNGKey(3)
    t, _, z, _ = jf._sample_prior(key, jf.audio_to_spec(jnp.asarray(x)),
                                  jf.audio_to_spec(jnp.asarray(y)))
    jloss, jgrads = value_and_grad(params, (jnp.asarray(x), jnp.asarray(y)), key)
    pstate = pmodel.TrainState(pf.dnn)
    loss = pf.loss_fn(pf.to_device((x, y)),
                      prior=(torch.as_tensor(np.array(t)), torch.as_tensor(np.array(z))))
    grads = dict(zip(pstate.params, torch.autograd.grad(loss, list(pstate.params.values()))))
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = _from_jax(jgrads, grads)
    gnorm = float(np.sqrt(sum(float((w * w).sum()) for w in want.values())))
    for name, g in grads.items():
        rel = float((g - want[name]).norm()) / max(float(want[name].norm()), 1e-4 * gnorm)
        assert rel < 1e-3, (name, rel)


@pytest.mark.parametrize("accumulate,steps", [(1, 3), (2, 4)])
def test_optimizer_params_and_ema_match_jax_train_step(jax_side, accumulate, steps):
    """Clip + Adam at the scheduled lr + EMA (and optax.MultiSteps under
    accumulation) against FDBM.train_step, on the JAX step's gradients."""
    _, params, value_and_grad = jax_side
    jf = _jax_fdbm(accumulate)
    state = jmodel.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              opt_state=jf.optimizer.init(params), ema_params=params,
                              ema_num_updates=jnp.zeros((), jnp.int32))
    train_step = jax.jit(jf.train_step)
    pf = _port(params, accumulate)
    pstate = pmodel.TrainState(pf.dnn)
    start = {k: v.clone() for k, v in pf.dnn.state_dict().items()}
    grad_norms = []
    for i in range(steps):
        x, y = map(jnp.asarray, _batch(seed=i))
        key = jax.random.PRNGKey(10 + i)
        _, jgrads = value_and_grad(state.params, (x, y), key)
        state, metrics = train_step(state, (x, y), key)
        got = pf.apply_gradients(pstate, _from_jax(jgrads, pstate.params))
        assert pstate.step == int(state.step)
        assert pstate.ema_num_updates == int(state.ema_num_updates)
        assert got["learning_rate"] == pytest.approx(float(metrics["learning_rate"]), rel=1e-6)
        assert got["grad_norm"] == pytest.approx(float(metrics["grad_norm"]), rel=1e-5)
        grad_norms.append(got["grad_norm"])
        params_i, ema = (tfgridnet_from_flax(jax.device_get(tree))
                         for tree in (state.params, state.ema_params))
        for name, p in pf.dnn.state_dict().items():
            np.testing.assert_allclose(p.numpy(), params_i[name].numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i}: {name}")
            np.testing.assert_allclose(pstate.ema[name].numpy(), ema[name].numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {i}: EMA {name}")
    assert max(grad_norms) > pmodel.CLIP_NORM  # the clip took part
    moved = [k for k, v in pf.dnn.state_dict().items() if not torch.equal(v, start[k])]
    assert len(moved) > 10


def _write_pairs(base, subset, lengths, seed):
    rng = np.random.default_rng(seed)
    for kind in ("clean", "noisy"):
        os.makedirs(os.path.join(base, subset, kind), exist_ok=True)
    for i, n in enumerate(lengths):
        x = (0.3 * np.sin(np.arange(n) * 0.02 * (i + 1))).astype(np.float32)
        y = (x + 0.05 * rng.standard_normal(n)).astype(np.float32)
        write_wav(os.path.join(base, subset, "clean", f"{i:03d}.wav"), x, 16000)
        write_wav(os.path.join(base, subset, "noisy", f"{i:03d}.wav"), y, 16000)


def test_data_batches_match_jax(tmp_path):
    base = str(tmp_path)
    # target_len = 15 * 32 = 480: longer files are cropped, shorter padded
    _write_pairs(base, "train", [700, 300, 900, 520, 610], seed=0)
    _write_pairs(base, "valid", [650, 400, 800], seed=1)
    kw = dict(base_dir=base, batch_size=2, n_fft=64, hop_length=32, num_frames=16,
              num_workers=1)

    def same(jbatches, pbatches):
        assert len(jbatches) == len(pbatches) > 0
        for jb, pb in zip(jbatches, pbatches):
            assert len(jb) == len(pb)
            for a, b in zip(jb, pb):
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)

    for subset, shuffle, mask in (("train", True, False), ("valid", False, True)):
        jds = jdata.SpecsDataset(jdata.DataConfig(**kw), subset, shuffle_spec=shuffle, seed=3)
        pds = pdata.SpecsDataset(pdata.DataConfig(**kw), subset, shuffle_spec=shuffle, seed=3)
        make = lambda mod, ds: mod.BatchLoader(ds, 2, shuffle=shuffle, num_workers=1,
                                               drop_last=shuffle, seed=3, yield_mask=mask)
        jl, pl = make(jdata, jds), make(pdata, pds)
        for _ in range(2):  # two epochs: the shuffle and the crops move on
            same(list(jl), list(pl))
    jm = jdata.SpecsDataset(jdata.DataConfig(num_data_per_epoch=3, **kw), "train", True, seed=5)
    pm = pdata.SpecsDataset(pdata.DataConfig(num_data_per_epoch=3, **kw), "train", True, seed=5)
    for _ in range(2):
        assert pm.clean_files == jm.clean_files and pm.noisy_files == jm.noisy_files
        jm.sample_data_per_epoch()
        pm.sample_data_per_epoch()


TINY = """mode: generative
backbone: tfgridnet_4l32c80
bridge: sb
noise_schedule: bb
sampler_type: sde_ei
N: 2
loss_type: data_prediction_hybrid
base_dir: {base}
batch_size: 2
n_fft: 32
hop_length: 16
num_frames: 8
num_workers: 1
log_dir: {base}/logs
version: tiny
scheduler_config:
  scheduler: warmup
  config:
    warmup_steps: 2
    decay_until_step: 100
    max_lr: 5.0e-4
    min_lr: 5.0e-6
"""


def test_cli_trains_resumes_and_serves_last_on_cpu(tmp_path):
    base = str(tmp_path)
    _write_pairs(base, "train", [300, 260, 400, 350], seed=0)
    _write_pairs(base, "valid", [300, 280, 320], seed=1)
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY.format(base=base))
    args = ["-C", str(cfg), "--device", "cpu", "num_eval_files=0"]
    run = ptrain.main(args + ["--max_steps", "3"])
    ckpts = Path(run) / "checkpoints"
    assert {"last.pt", "best_valid_loss.pt", "meta.json"} <= set(os.listdir(ckpts))
    records = [json.loads(line) for line in (Path(run) / "metrics.jsonl").read_text().splitlines()]
    valid = [r["valid_loss"] for r in records if "valid_loss" in r]
    assert valid and all(np.isfinite(valid))
    last = torch.load(ckpts / "last.pt", map_location="cpu", weights_only=True)
    assert last["train_state"]["step"] == 3
    assert json.loads((ckpts / "meta.json").read_text())["best"]["valid_loss"] == min(valid)

    ptrain.main(args + ["--max_steps", "4", "--resume", run])
    last = torch.load(ckpts / "last.pt", map_location="cpu", weights_only=True)
    assert last["train_state"]["step"] == 4

    served = load_checkpoint(run, device="cpu")  # the EMA weights of 'last'
    for name, t in served.dnn.state_dict().items():
        assert torch.equal(t, last["train_state"]["ema"][name]), name
    noisy = os.path.join(base, "valid", "noisy", "000.wav")
    out = os.path.join(base, "enhanced.wav")
    x_hat = infer_single.main(["-C", str(REPO / "configs" / "config_infer_single.yaml"),
                               "--device", "cpu", f"ckpt={run}", f"noisy_file={noisy}",
                               f"output_file={out}", "N=2", "sampler_type=sde_ei"])
    written, sr = read_wav(out)
    assert written.shape == (1, 300) and x_hat.shape == (300,) and np.isfinite(x_hat).all()

    with pytest.raises(NotImplementedError, match="num_eval_files=0"):
        ptrain.main(["-C", str(cfg), "--device", "cpu", "num_eval_files=2", "--max_steps", "1"])
