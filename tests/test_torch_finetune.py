"""The port's fine-tuning ("enhanced bridge") against fdbm_tpu, on the CPU.

``FDBM._finetune_unrolled`` runs the bridge's N-step ODE-EI sampler with a
gradient through the last backbone call only. Both packages get
``tfgridnet_4l32c80`` (n_fft 64, 16 frames, N=3, SB bridge, ``bb``
schedule) on the same perturbed Flax weights, the same complex spectrograms
x and y and the same prior draw z. They are handed the spectrograms, not
audio: the ``bb`` schedule's first step computes
x1 = 4713.5 x0 - 4712.8 y + 0.33 est with x0 = y, so its rounding moves with
any difference in y, and the two packages' STFTs differ by 1.8e-7
(ROADMAP.md). Held: the unrolled output (rel-L2 1e-5), the loss (rel 1e-5)
and every parameter's gradient (norm-rel 1e-4, floored at 1e-4 of the
global norm). The control: the same unroll with a gradient through every
call misses that gradient gate by far. The audio-level ``loss_fn``, as the
valid loss runs it (EMA weights on every call, no gradient), is compared
on the flow-matching bridge with the ``ot`` schedule, whose first step is
benign (x1 = 0.67 x0 + 0.33 est - 0.003 y). An ``ncsnpp_v2_5M`` fine-tuning
loss is compared forward only. ``evaluate_files`` is held to the JAX
package's with every sampler draw zero, and the ``evaluate`` CLI's JSON to
the root ``evaluate.py``'s. ``train_finetuning`` fine-tunes from a port run
and from a reference ``.ckpt``: the architecture comes from the source, only
the overridable fields from the YAML, and the first weights are the
source's EMA weights.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn
from test_torch_ncsnpp import fan_in_params

from fdbm_tpu import data as jdata
from fdbm_tpu import losses as jlosses
from fdbm_tpu import model as jmodel
from fdbm_tpu import sampling as jsampling
from fdbm_tpu import train as jtrain
from fdbm_tpu.models import tfgridnet as jtfg
from fdbm_tpu.utils.torch_export import save_reference_checkpoint
from fdbm_tpu_torch import data as pdata
from fdbm_tpu_torch import evaluate as pevaluate
from fdbm_tpu_torch import infer_single, losses
from fdbm_tpu_torch import model as pmodel
from fdbm_tpu_torch import sampling as psampling
from fdbm_tpu_torch import train as ptrain
from fdbm_tpu_torch import train_finetuning
from fdbm_tpu_torch.models.tfgridnet import TFGridNet
from fdbm_tpu_torch.utils.audio import read_wav, write_wav
from fdbm_tpu_torch.utils.weights import ncsnpp_from_flax, tfgridnet_from_flax

REPO = Path(__file__).resolve().parents[1]
MODEL = dict(n_fft=64, hop_length=32, num_frames=16)
N_STEPS = 3
NET = dict(n_layers=1, emb_dim=16, hidden=24)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _perturbed(params, seed=1, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(np.shape(a)).astype(np.float32),
        jax.device_get(params))


class _JaxBinNet(flax_nn.Module):
    """est = a * x_t + b * y + c * t, per frequency bin: a backbone whose
    fp32 rounding neither package amplifies."""

    @flax_nn.compact
    def __call__(self, x_t, y, t):
        init = flax_nn.initializers.normal(0.5)
        a, b, c = (self.param(n, init, (y.shape[2], 1)) for n in "abc")
        return a * x_t + b * y + c * t[:, None, None, None]


class _BinNet(torch.nn.Module):
    def __init__(self, bins: int):
        super().__init__()
        self.a, self.b, self.c = (torch.nn.Parameter(torch.zeros(bins, 1)) for _ in "abc")

    def forward(self, x_t, y, t):
        return self.a * x_t + self.b * y + self.c * t[:, None, None, None]


def _bin_net_state(params):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in params["params"].items()}


def _pair(bridge="sb", noise_schedule="bb", backbone="tfgridnet_4l32c80", model=MODEL,
          net="bins", params_fn=_perturbed, n_steps=N_STEPS):
    """Both packages' finetuning FDBM on the same weights: the per-bin
    linear backbone (``net="bins"``), a narrow TF-GridNet (a dict of its
    widths), or the registered ``backbone`` (``net=None``, NCSN++ here)."""
    cfg = dict(model, mode="finetuning", backbone=backbone, bridge=bridge,
               noise_schedule=noise_schedule, sampler_type="ode_ei", N=n_steps)
    jf = jmodel.FDBM(jmodel.FDBMConfig(**cfg))
    pf = pmodel.FDBM(pmodel.FDBMConfig(**cfg), device="cpu")
    if net == "bins":
        jf.dnn = jf.dnn_sample = _JaxBinNet()
        pf.dnn = _BinNet(model["n_fft"] // 2 + 1).eval()
        convert = _bin_net_state
    elif net is None:
        convert = ncsnpp_from_flax
    else:
        jf.dnn = jf.dnn_sample = jtfg.TFGridNet(**net)
        pf.dnn = TFGridNet(**net).eval()
        convert = tfgridnet_from_flax
    params = params_fn(jf.init_params(jax.random.PRNGKey(0)))
    pf.dnn.load_state_dict(convert(params))
    return jf, params, pf, convert


def _audio(b=2, frames=MODEL["num_frames"], hop=MODEL["hop_length"], seed=0):
    rng = np.random.default_rng(seed)
    n = (frames - 1) * hop
    x = (0.3 * np.sin(np.arange(n) * 0.05)[None] * rng.uniform(0.5, 1.0, (b, 1))
         + 0.02 * rng.standard_normal((b, n)))
    y = x + 0.05 * rng.standard_normal((b, n))
    return x.astype(np.float32), y.astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _grads(dnn, loss):
    params = {n: p for n, p in dnn.named_parameters() if p.requires_grad}
    return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


def _worst_leaf(grads, want):
    """(leaf, norm-rel) of the gradient farthest from ``want``, the
    denominator floored at 1e-4 of ``want``'s global norm."""
    gnorm = float(np.sqrt(sum(float((want[n] ** 2).sum()) for n in grads)))
    rels = {n: float((g - want[n]).norm()) / max(float(want[n].norm()), 1e-4 * gnorm)
            for n, g in grads.items()}
    worst = max(rels, key=rels.get)
    return worst, rels[worst]


def _jax_unrolled(jf, params, x, y, key, convert):
    """JAX's unrolled output, loss and gradients (in the port's layout)."""
    def jloss(p):
        out = jf._finetune_unrolled(p, jnp.asarray(y), key)
        return jlosses.compute_loss(jf.loss_cfg, out, jnp.asarray(x)), out

    (jl, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    return np.asarray(jout), float(jl), convert(jax.device_get(jg))


def _specs_and_z(jf, key, **audio):
    x, y = (np.asarray(jf.audio_to_spec(jnp.asarray(a))) for a in _audio(**audio))
    return x, y, np.array(jsampling.complex_normal_like(key, jnp.asarray(y)))


def _port_unrolled(pf, x, y, z, grad=True):
    with torch.set_grad_enabled(grad):
        out = pf._finetune_unrolled(torch.as_tensor(y), z=torch.as_tensor(z))
        loss = losses.compute_loss(pf.loss_cfg, out, torch.as_tensor(x).to(out.dtype))
    return out.detach(), loss.detach(), (_grads(pf.dnn, loss) if grad else None)


def test_unrolled_output_loss_and_gradients_match_jax():
    """The unroll itself (prior, times, ODE-EI weights, where the gradient
    stops), on the per-bin linear backbone: output and loss to rel 1e-5,
    every gradient to norm-rel 1e-4. The control: the same unroll with a
    gradient through every call misses the gradient gate by far."""
    jf, params, pf, convert = _pair()
    key = jax.random.PRNGKey(5)
    x, y, z = _specs_and_z(jf, key)
    jout, jl, want = _jax_unrolled(jf, params, x, y, key, convert)
    out, loss, grads = _port_unrolled(pf, x, y, z)
    assert _rel(out.numpy(), jout) < 1e-5
    assert abs(float(loss) - jl) <= 1e-5 * abs(jl)
    assert set(grads) == set(want) == {"a", "b", "c"}
    assert _worst_leaf(grads, want)[1] < 1e-4

    bridge = pf.bridge
    yt = torch.as_tensor(y)
    xt = bridge.prior_sampling(yt, z=torch.as_tensor(z))
    for tp, wxt, ws, wy in bridge._steps(bridge.path.sampling_param_ode_ei):
        xt = wxt * xt + ws * pf.dnn(xt, yt, torch.full((yt.shape[0],), tp)) + wy * yt
    full = _grads(pf.dnn, losses.compute_loss(pf.loss_cfg, xt, torch.as_tensor(x)))
    assert _worst_leaf(full, want)[1] > 1e-1


def test_unrolled_tfgridnet_held_to_float64():
    """A narrow TF-GridNet (1 block, C=16, H=24, perturbed Flax weights),
    N=3 on ``bb``. The random net carries a step's fp32 rounding into the
    next call's input and amplifies it, in both packages alike, so the fp32
    routes are held against the port in float64: the port's output, loss
    and worst gradient leaf no farther from it than max(floor, 3 x the JAX
    package's own distance). Also: steps 1..N-1 run on the serving route
    without autograd, the last on the training route with it, and the
    backbone's mode is restored."""
    jf, params, pf, convert = _pair(net=NET)
    key = jax.random.PRNGKey(5)
    x, y, z = _specs_and_z(jf, key)
    jout, jl, want = _jax_unrolled(jf, params, x, y, key, convert)
    calls = []
    hook = pf.dnn.register_forward_pre_hook(
        lambda m, args: calls.append((m.training, torch.is_grad_enabled())))
    out, loss, grads = _port_unrolled(pf, x, y, z)
    hook.remove()
    assert calls == [(False, False)] * (N_STEPS - 1) + [(True, True)]
    assert not pf.dnn.training

    pf.dnn.double()
    out64, loss64, g64 = _port_unrolled(pf, x.astype(np.complex128), y.astype(np.complex128),
                                        z.astype(np.complex128))
    out64 = out64.numpy()
    dist = {"out": (_rel(out.numpy(), out64), _rel(jout, out64), 1e-5),
            "loss": (abs(float(loss) - float(loss64)) / abs(float(loss64)),
                     abs(jl - float(loss64)) / abs(float(loss64)), 1e-6),
            "grad": (_worst_leaf({n: g.double() for n, g in grads.items()}, g64)[1],
                     _worst_leaf({n: want[n].double() for n in g64}, g64)[1], 1e-3)}
    for name, (port, jax_, floor) in dist.items():
        assert port <= max(floor, 3 * jax_), (name, port, jax_)


def test_valid_loss_under_other_weights_matches_jax():
    """``loss_fn`` from audio with ``params`` on every call and no gradient,
    as ``valid_step`` runs it, on the fm bridge's benign ``ot`` schedule
    (so the two STFTs' 1.8e-7 difference stays small), per-bin backbone."""
    jf, params, pf, convert = _pair(bridge="fm", noise_schedule="ot")
    ema = _perturbed(params, seed=2, scale=0.2)
    x_audio, y_audio = _audio()
    key = jax.random.PRNGKey(7)
    z = np.array(jsampling.complex_normal_like(key, jf.audio_to_spec(jnp.asarray(y_audio))))
    want = float(jax.jit(jf.loss_fn)(ema, (jnp.asarray(x_audio), jnp.asarray(y_audio)), key))
    batch = (torch.as_tensor(x_audio), torch.as_tensor(y_audio))
    pf.dnn.train()
    with torch.no_grad():
        got = float(pf.loss_fn(batch, prior=(None, torch.as_tensor(z)), params=convert(ema)))
        own = float(pf.loss_fn(batch, prior=(None, torch.as_tensor(z))))
    assert pf.dnn.training
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    assert abs(own - got) > 1e-3 * abs(got)  # the weights took part


def test_ncsnpp_finetuning_loss_matches_jax():
    """ncsnpp_v2_5M (fan-in weights), n_fft 32 (17 bins, the net reads 16),
    16 frames, N=2, forward only, on one spec pair."""
    model = dict(n_fft=32, hop_length=16, num_frames=16)
    jf, params, pf, _ = _pair(backbone="ncsnpp_v2_5M", model=model, net=None,
                              params_fn=fan_in_params, n_steps=2)
    x_audio, y_audio = _audio(frames=16, hop=16)
    x, y = (np.asarray(jf.audio_to_spec(jnp.asarray(a))) for a in (x_audio, y_audio))
    key = jax.random.PRNGKey(3)
    want = float(jax.jit(lambda p: jlosses.compute_loss(
        jf.loss_cfg, jf._finetune_unrolled(p, jnp.asarray(y), key), jnp.asarray(x)))(params))
    z = np.array(jsampling.complex_normal_like(key, jnp.asarray(y)))
    with torch.no_grad():
        out = pf._finetune_unrolled(torch.as_tensor(y), z=torch.as_tensor(z))
        got = float(losses.compute_loss(pf.loss_cfg, out, torch.as_tensor(x)))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def _write_pairs(base, subset, lengths, seed):
    rng = np.random.default_rng(seed)
    for kind in ("clean", "noisy"):
        os.makedirs(os.path.join(base, subset, kind), exist_ok=True)
    for i, n in enumerate(lengths):
        x = (0.3 * np.sin(np.arange(n) * 0.02 * (i + 1))).astype(np.float32)
        y = (x + 0.05 * rng.standard_normal(n)).astype(np.float32)
        write_wav(os.path.join(base, subset, "clean", f"{i:03d}.wav"), x, 16000)
        write_wav(os.path.join(base, subset, "noisy", f"{i:03d}.wav"), y, 16000)


PRETRAIN = """mode: generative
backbone: tfgridnet_4l32c80
bridge: sb
noise_schedule: bb
sampler_type: sde_ei
N: 2
base_dir: {base}
batch_size: 2
n_fft: 32
hop_length: 16
num_frames: 8
num_workers: 1
num_eval_files: 0
log_dir: {base}/logs
version: pre
"""

# Fine-tuning settings: N, lr, the schedule, num_eval_files and the data
# paths are taken; backbone, n_fft and num_frames are the source's.
FINETUNE = """N: 3
version: ft
log_dir: {base}/logs
ckpt: /not/a/checkpoint
lr: 2.0e-4
num_eval_files: 1
loss_type: data_prediction_hybrid
pesq_weight: 0.0
scheduler_config:
  scheduler: exp
  config:
    gamma: 0.99
base_dir: {base}
batch_size: 2
num_workers: 1
backbone: ncsnpp_v2_5M
n_fft: 64
num_frames: 4
"""


@pytest.fixture(scope="module")
def finetune_setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("ft")
    _write_pairs(str(base), "train", [300, 260, 400, 350], seed=0)
    _write_pairs(str(base), "valid", [1800, 1500], seed=1)
    pre, ft = base / "pre.yaml", base / "ft.yaml"
    pre.write_text(PRETRAIN.format(base=base))
    ft.write_text(FINETUNE.format(base=base))
    run = ptrain.main(["-C", str(pre), "--device", "cpu", "--max_steps", "2"])
    return base, ft, run


def _finetune(ft, ckpt, *extra):
    return train_finetuning.main(["-C", str(ft), "--device", "cpu", f"ckpt={ckpt}", *extra])


def test_finetuning_cli_from_a_port_run(finetune_setup, monkeypatch):
    """From a port run: the first weights are its EMA weights (not its
    parameters), the config is the source's with the overridable fields of
    the YAML; two fine-tuning steps then validate, evaluate one file
    (PESQ, SI-SDR), write the best slots and serve their last slot. With
    ``-D 2`` one step runs on two processes (gloo on the CPU)."""
    base, ft, run = finetune_setup
    src = torch.load(Path(run) / "checkpoints" / "last.pt", map_location="cpu",
                     weights_only=True)
    first = _finetune(ft, run, "--max_steps", "0")
    blob = torch.load(Path(first) / "checkpoints" / "last.pt", map_location="cpu",
                      weights_only=True)
    assert blob["train_state"]["step"] == 0
    ema = src["train_state"]["ema"]
    assert any(not torch.equal(ema[k], src["state_dict"][k]) for k in ema)
    for k, v in ema.items():
        assert torch.equal(blob["state_dict"][k], v) and torch.equal(
            blob["train_state"]["ema"][k], v), k
    cfg = blob["config"]
    assert (cfg["mode"], cfg["sampler_type"], cfg["N"], cfg["lr"]) == (
        "finetuning", "ode_ei", 3, 2e-4)
    assert (cfg["backbone"], cfg["n_fft"], cfg["num_frames"]) == ("tfgridnet_4l32c80", 32, 8)
    assert cfg["scheduler_config"]["scheduler"] == "exp"
    meta = json.loads((Path(first) / "checkpoints" / "meta.json").read_text())["config"]
    assert meta["num_eval_files"] == 1 and meta["hop_length"] == 16

    tuned = _finetune(ft, run, "--max_steps", "2")
    ckpts = set(os.listdir(Path(tuned) / "checkpoints"))
    assert {"last.pt", "best_valid_loss.pt", "best_pesq.pt", "best_si_sdr.pt"} <= ckpts
    records = [json.loads(ln) for ln in (Path(tuned) / "metrics.jsonl").read_text().splitlines()]
    evals = [r for r in records if "pesq" in r]
    assert evals and all(np.isfinite([r["pesq"], r["si_sdr"], r["valid_loss"]]).all()
                         for r in evals)
    assert sorted(os.listdir(Path(tuned) / "valid_samples")) == [
        "000_clean.wav", "000_epoch000_enh.wav", "000_noisy.wav"]
    out = str(base / "tuned.wav")
    noisy = str(base / "valid" / "noisy" / "001.wav")
    x_hat = infer_single.main(["-C", str(REPO / "configs" / "config_infer_single.yaml"),
                               "--device", "cpu", f"ckpt={tuned}", f"noisy_file={noisy}",
                               f"output_file={out}", "N=2"])
    assert x_hat.shape == (1500,) and np.isfinite(x_hat).all()
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    two = _finetune(ft, run, "-D", "2", "--max_steps", "1")
    blob = torch.load(Path(two) / "checkpoints" / "last.pt", map_location="cpu",
                      weights_only=True)
    assert blob["train_state"]["step"] == 1 and blob["config"]["mode"] == "finetuning"


def test_finetuning_cli_from_a_reference_ckpt(finetune_setup):
    base, ft, _ = finetune_setup
    jf = jmodel.FDBM(jmodel.FDBMConfig(backbone="tfgridnet_4l32c80", n_fft=32, hop_length=16,
                                       num_frames=8))
    params = jax.device_get(jf.init_params(jax.random.PRNGKey(4)))
    path = str(base / "ref.ckpt")
    save_reference_checkpoint(path, "tfgridnet_4l32c80", params, hyper_parameters=dict(
        mode="generative", n_fft=32, hop_length=16, num_frames=8, N=30))
    run = _finetune(ft, path, "--max_steps", "0")
    blob = torch.load(Path(run) / "checkpoints" / "last.pt", map_location="cpu",
                      weights_only=True)
    want = tfgridnet_from_flax(params)
    for k, v in want.items():
        assert torch.equal(blob["state_dict"][k], v), k
    assert (blob["config"]["mode"], blob["config"]["N"], blob["config"]["n_fft"]) == (
        "finetuning", 3, 32)
