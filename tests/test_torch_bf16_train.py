"""bf16 training (``compute_dtype: bfloat16``) of the port against fdbm_tpu's,
on the CPU.

The JAX side is ``FDBM(FDBMConfig(compute_dtype="bfloat16"))`` built with
``FDBM_TPU_TRAIN_KERNEL=1`` (``fdbm_tpu/model.py:165-170``), so its training
backbone takes its kernel route in bf16 as on the TPU: Pallas in interpret
mode, kernels 5-6 (inside the fused kernels' gate) or 8-9 (outside it) on
fp32 casts, the glue in bf16. The port's training route casts at the same
places. Inputs and weights come from numpy seeds, the weights carried across
by ``utils/weights.py``, and JAX's ``(t, z)`` draw is injected into the port.

bf16 has no bit-level parity between two frameworks, so the loss and the
gradients pass ``tests/test_torch_bf16.py``'s three gates (``_check``):
within a tolerance of JAX set at 3x the measured reading; no farther from
the port's float64 plain route than 1.5x JAX's distance + 1e-3; and above
1e-4 from float64, which shows that bf16 ran. The gradients are read per
group of leaves (``_leaf_group``: a TF-GridNet block's intra path, inter
path and attention, the stem; an NCSN++ block), each group's gradients
concatenated, the denominator floored at 1e-4 of the global norm: a single
leaf's bf16 gradient (a PReLU slope, a norm's shift) is a draw of rounding
noise, at 0.3-0.7 from float64 in the JAX package as in the port. Two
controls: the port on the same weights with both routes in fp32 must miss
gate 3 (it reads 3e-7 to 5e-5 from float64; it cannot miss gate 1: two
frameworks' bf16 roundings are independent draws, so the port in fp32 is as
close to JAX's bf16 as the port in bf16 is, 5.5e-4 against 8.6e-4 on the
narrow net's loss); and a planted bf16 fault, the port on its weights
rounded to bf16 (a bf16 training that dropped its fp32 master weights,
``_bf16_weights_twin``), must miss gate 1 and gate 2, each on some group or
the loss.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdbm_tpu import model as jmodel
from fdbm_tpu_torch import model as pmodel
from fdbm_tpu_torch.models.tfgridnet import TFGridNet
from fdbm_tpu_torch.utils.weights import tfgridnet_from_flax

BF16 = torch.bfloat16
# tests/test_torch_train.py's nets, inside the fused kernels' gate (kernels
# 5-6) and outside it (C=48, H=132: the generic path through kernels 8-9),
# with E=4 q/k lanes: at E=2 the q/k norms amplify bf16 rounding so far that
# one draw's gradients say nothing (tests/test_torch_bf16.py).
NETS = {"narrow": dict(n_layers=1, emb_dim=16, hidden=24, qk_output_channel=4),
        "wide": dict(n_layers=1, emb_dim=48, hidden=132, qk_output_channel=4)}
MODEL = dict(n_fft=32, hop_length=16, num_frames=8)
# Gate 1's limits, 3x the readings noted beside each test.
TOLS = {"narrow": {"loss": 2.6e-3, "grad": 0.25}, "wide": {"loss": 2e-3, "grad": 8e-2}}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _audio(seed=0, b=2, frames=8, hop=16):
    rng = np.random.default_rng(seed)
    n = (frames - 1) * hop
    x = (0.1 * rng.standard_normal((b, n))).astype(np.float32)
    y = (x + 0.02 * rng.standard_normal((b, n))).astype(np.float32)
    return x, y


def _perturbed(params, seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32),
        jax.device_get(params))


def _jax_fdbm(monkeypatch, **kw):
    """The JAX package's bf16 training model, on its kernel route."""
    monkeypatch.setenv("FDBM_TPU_TRAIN_KERNEL", "1")
    jf = jmodel.FDBM(jmodel.FDBMConfig(compute_dtype="bfloat16", **kw))
    assert jf.dnn.dtype == jnp.bfloat16
    return jf


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (torch.view_as_real(t) if t.is_complex() else t).double().numpy()
    return np.asarray(t, np.float64)


def _readings(port, jax_, f64, floor):
    """Gate readings of one quantity: rel-L2 of the port and of JAX to
    float64, and of the port to JAX (denominators floored at ``floor``)."""
    rel = lambda a, b: float(np.linalg.norm(_np(a) - _np(b)) / max(np.linalg.norm(_np(b)), floor))
    return {"jax": rel(port, jax_), "port_f64": rel(port, f64), "jax_f64": rel(jax_, f64)}


def _port_loss_and_grads(pf, batch, prior):
    params = {n: p for n, p in pf.dnn.named_parameters() if p.requires_grad}
    loss = pf.loss_fn(batch, prior=prior)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def _fp32_twin(pf):
    """``pf`` on the same weights with both routes in fp32: the control."""
    twin = copy.copy(pf)
    twin.dnn = copy.deepcopy(pf.dnn)
    twin.dnn.train_dtype = twin.dnn.serve_dtype = torch.float32
    return twin


def _bf16_weights_twin(pf):
    """``pf`` on its weights rounded to bf16: the planted fault."""
    twin = copy.copy(pf)
    twin.dnn = copy.deepcopy(pf.dnn)
    with torch.no_grad():
        for p in twin.dnn.parameters():
            p.copy_(p.to(BF16).float())
    return twin


def _float64_twin(pf):
    """``_fp32_twin`` in float64, with a float64 window: fed float64 audio
    and draws, its network and spectrograms run in float64 (the loss's
    iSTFT rounds to fp32, far below bf16's distances)."""
    twin = _fp32_twin(pf)
    twin.dnn.double()
    twin.window = pf.window.double()
    return twin


def _leaf_group(name: str) -> str:
    """``blocks.<i>.intra`` / ``.inter`` / ``.attn`` (the block's other
    leaves) of a TF-GridNet, ``<level>`` of an NCSN++, or ``stem``."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return ".".join(parts[:2] + [parts[2] if parts[2] in ("intra", "inter") else "attn"])
    return parts[0] if len(parts) > 2 else "stem"


def _step(pf, jf, params, convert, x, y, key):
    """JAX's bf16 loss and gradients, the port's (``pf``), its float64
    twin's, its fp32 twin's and its bf16-weights twin's on the same audio
    and (t, z) draw, as ``{route: (loss, {leaf: gradient})}``."""
    f64 = _float64_twin(pf)
    jl, jg = jax.jit(jax.value_and_grad(jf.loss_fn))(params, (jnp.asarray(x), jnp.asarray(y)),
                                                      key)
    t, _, z, _ = jf._sample_prior(key, jf.audio_to_spec(jnp.asarray(x)),
                                  jf.audio_to_spec(jnp.asarray(y)))
    batch = (torch.as_tensor(x), torch.as_tensor(y))
    prior = (torch.as_tensor(np.array(t)), torch.as_tensor(np.array(z)))
    want = convert(jax.device_get(jg))
    return {"jax": (torch.as_tensor(np.float64(jl)), {n: want[n] for n in want}),
            "bf16": _port_loss_and_grads(pf, batch, prior),
            "fp32": _port_loss_and_grads(_fp32_twin(pf), batch, prior),
            "fault": _port_loss_and_grads(_bf16_weights_twin(pf), batch, prior),
            "f64": _port_loss_and_grads(f64, tuple(a.double() for a in batch),
                                        (prior[0].double(), prior[1].to(torch.complex128)))}


def _step_readings(routes, port="bf16"):
    """Readings (``_readings``) of ``port``'s loss and of every group of
    leaves (``_leaf_group``), its gradients concatenated, against JAX and
    float64; the denominators of the gradients floored at 1e-4 of the
    float64 gradient's global norm."""
    loss64, g64 = routes["f64"]
    floor = 1e-4 * float(np.sqrt(sum(float((g * g).sum()) for g in g64.values())))
    groups = {}
    for n in g64:
        groups.setdefault(_leaf_group(n), []).append(n)
    flat = lambda g, names: torch.cat([torch.as_tensor(g[n]).double().reshape(-1) for n in names])
    out = {"loss": _readings(routes[port][0], routes["jax"][0], loss64, 0.0)}
    out.update({grp: _readings(*(flat(routes[r][1], names) for r in (port, "jax", "f64")), floor)
                for grp, names in groups.items()})
    return out


def _check(routes, tol):
    """The three gates on the loss and on every group of leaves; the fp32
    control misses gate 3 (it is within 1e-4 of float64 everywhere), the
    planted fault misses gates 1 and 2. Returns the readings."""
    gate1 = lambda name, r: r["jax"] < tol["loss" if name == "loss" else "grad"]
    gate2 = lambda r: r["port_f64"] <= 1.5 * r["jax_f64"] + 1e-3
    bf16, fp32 = _step_readings(routes), _step_readings(routes, "fp32")
    for name, r in bf16.items():
        assert gate1(name, r), (name, r)
        assert gate2(r), (name, r)
        assert r["port_f64"] > 1e-4, (name, r)
    assert all(r["port_f64"] <= 1e-4 for r in fp32.values()), fp32
    fault = _step_readings(routes, "fault")
    assert not all(gate1(name, r) for name, r in fault.items()), fault
    assert not all(gate2(r) for r in fault.values()), fault
    return bf16


def _tfgridnet_pair(monkeypatch, net):
    jf = _jax_fdbm(monkeypatch, **MODEL)
    jf.dnn, jf.dnn_sample = jf.dnn.clone(**net), jf.dnn_sample.clone(**net)
    assert jf.dnn.use_pallas_train and jf.dnn.dtype == jnp.bfloat16
    params = _perturbed(jf.init_params(jax.random.PRNGKey(0)))
    pf = pmodel.FDBM(pmodel.FDBMConfig(compute_dtype="bfloat16", **MODEL), device="cpu")
    pf.dnn = TFGridNet(train_dtype=BF16, **net)
    pf.dnn.load_state_dict(tfgridnet_from_flax(params))
    return jf, params, pf, tfgridnet_from_flax


@pytest.mark.parametrize("net", ["narrow", "wide"])
def test_bf16_train_step_matches_jax(monkeypatch, net):
    """One ``loss_fn`` + gradient of a narrow TF-GridNet inside the fused
    kernels' gate (kernels 5-6's plain versions on fp32 lines) and of a
    wide one outside it (kernels 8-9's on fp32 windows). Readings: narrow,
    loss 8.6e-4 to JAX (3.1e-4 / 5.5e-4 to float64), groups up to 8.4e-2
    (port 5.6e-2 to 9.1e-2, JAX 7.3e-2 to 1.0e-1 from float64); wide, loss
    6.6e-4 (4.4e-3 / 3.7e-3), groups up to 2.6e-2 (port 1.5e-2 to 2.0e-2,
    JAX 1.6e-2 to 2.4e-2). The bf16-weights fault: narrow, loss 3.9e-3 to
    JAX and groups 0.98-1.25 (port 0.98-1.23 from float64); wide, loss
    6.1e-3 and groups 0.45-0.73."""
    jf, params, pf, convert = _tfgridnet_pair(monkeypatch, NETS[net])
    routes = _step(pf, jf, params, convert, *_audio(), jax.random.PRNGKey(3))
    _check(routes, TOLS[net])


def test_bf16_unroll_routes_by_dtype():
    """The fine-tuning unroll of a TF-GridNet at ``compute_dtype:
    bfloat16``: its N-1 gradient-free calls run the serving route (eval
    mode) in bf16, its last the training route (train mode) in bf16 with a
    gradient; with ``inference_dtype: float32`` the first calls serve in
    fp32. The dtype is read off ``conv_in``'s input."""
    for inference, first in (("", BF16), ("float32", torch.float32)):
        f = pmodel.FDBM(pmodel.FDBMConfig(compute_dtype="bfloat16", inference_dtype=inference,
                                          mode="finetuning", sampler_type="ode_ei", N=3,
                                          **MODEL), device="cpu")
        f.dnn = TFGridNet(train_dtype=f.train_dtype, serve_dtype=f.serve_dtype, **NETS["narrow"])
        calls = []
        f.dnn.conv_in.register_forward_pre_hook(
            lambda m, args: calls.append((f.dnn.training, torch.is_grad_enabled(),
                                          args[0].dtype)))
        y = torch.as_tensor(np.asarray(np.random.default_rng(0).standard_normal((1, 1, 17, 8)),
                                       np.complex64))
        f._finetune_unrolled(y, z=torch.zeros_like(y)).abs().sum().backward()
        assert calls == [(False, False, first)] * 2 + [(True, True, BF16)], calls
        assert all(p.grad is not None and p.grad.dtype == torch.float32
                   for p in f.dnn.parameters() if p.requires_grad)
