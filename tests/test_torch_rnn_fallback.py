"""TF-GridNet outside the fused RNN kernels' gate against fdbm_tpu, on the CPU.

Where C > 64 or H > 128 both packages take the generic RNN path (unfold,
BiLSTM, deconv, fold); in the JAX package its BiLSTM runs the Pallas LSTM
kernels of ``fdbm_tpu/ops/lstm.py`` under ``use_pallas`` (serving) and
``use_pallas_train`` (training), here in interpret mode on the CPU, and in
the port the wrappers of ``ops/lstm.py``, whose CPU route is their plain
version. Both corners of the gate are held: C = 72 with H = 8, and C = 8
with H = 132. Inputs and perturbed weights come from numpy seeds and go to
both packages through ``utils/weights.py``. Tolerances are
tests/test_torch_kernels.py's and tests/test_torch_train.py's: rel-L2 <
1e-4 for module outputs (PARITY.md's module gate), and per leaf a gradient
norm-rel < 1e-3 with the denominator floored at 1e-4 of the global norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdbm_tpu.models import tfgridnet as jtfg
from fdbm_tpu_torch import ops
from fdbm_tpu_torch.models import tfgridnet as ptfg
from fdbm_tpu_torch.utils import weights

CORNERS = [(72, 8), (8, 132)]  # (C, H): C > 64, and H > 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain versions run many tiny products, and
    the test workers share the machine's cores (oversubscribed BLAS threads
    spin instead of working)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * _rand(rng, np.shape(a)), jax.device_get(params))


def _rnn_path_state(p):
    """State_dict of a lone ``_RnnPath`` from its Flax subtree."""
    return {k.split(".", 1)[1]: v for k, v in weights._rnn_path(p, "path").items()}


def _assert_grads_match(got, want):
    gnorm = float(np.sqrt(sum(float((w * w).sum()) for w in want.values())))
    for name, w in want.items():
        g = got[name]
        assert g is not None and g.shape == w.shape, name
        rel = float((g - w).norm()) / max(float(w.norm()), 1e-4 * gnorm)
        assert rel < 1e-3, (name, rel)


def _module_case(kind, c, hidden, seed):
    """A Flax module outside the gate, its perturbed params, an input."""
    rng = np.random.default_rng(seed)
    if kind == "path":
        x = _rand(rng, (1, 10, 3, c))  # a padded canvas, sequence on axis 1
        make = lambda **kw: jtfg._RnnPath(emb_dim=c, hidden=hidden, **kw)
        call = lambda m, p, a: m.apply(p, a, seq_axis=1)
    else:
        x = _rand(rng, (1, 4, 4, c))  # T = Q: both paths' LSTMs share their shapes
        make = lambda **kw: jtfg.GridNetBlock(emb_dim=c, hidden=hidden, **kw)
        call = lambda m, p, a: m.apply(p, a)
    kw = {"seq_axis": 1} if kind == "path" else {}
    init = jax.jit(lambda a: make().init(jax.random.PRNGKey(0), a, **kw))
    return make, call, _perturbed(init(jnp.asarray(x)), seed), x


def _port_module(kind, c, hidden, params):
    if kind == "path":
        pm = ptfg._RnnPath(c, hidden)
        pm.load_state_dict(_rnn_path_state(params["params"]))
    else:
        pm = ptfg.GridNetBlock(c, hidden)
        pm.load_state_dict(weights.gridnet_block_from_flax(params["params"]))
    return pm


@pytest.mark.parametrize("kind", ["path", "block"])
@pytest.mark.parametrize("c,hidden", CORNERS)
def test_outside_gate_eval_matches_flax_use_pallas(kind, c, hidden):
    assert not ptfg._kernel_fast_path_ok(c, hidden)
    make, call, params, x = _module_case(kind, c, hidden, seed=1)
    want = jax.jit(lambda p, a: call(make(use_pallas=True), p, a))(params, jnp.asarray(x))
    pm = _port_module(kind, c, hidden, params).eval()
    ops.reset_launch_counts()
    with torch.no_grad():
        got = pm(torch.as_tensor(x))
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)
    assert got.shape == x.shape
    assert _rel(got.numpy(), want) < 1e-4


@pytest.mark.parametrize("kind", ["path", "block"])
@pytest.mark.parametrize("c,hidden", CORNERS)
def test_outside_gate_train_grads_match_flax_use_pallas_train(kind, c, hidden):
    make, call, params, x = _module_case(kind, c, hidden, seed=2)
    cot = _rand(np.random.default_rng(3), x.shape)
    jm = make(use_pallas_train=True)

    def loss(p, a):
        out = call(jm, p, a)
        return jnp.sum(out * cot), out

    (_, jout), (jgrads, jdx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    pm = _port_module(kind, c, hidden, params).train()
    xt = torch.as_tensor(x).requires_grad_(True)
    out = pm(xt)
    (out * torch.as_tensor(cot)).sum().backward()
    assert _rel(out.detach().numpy(), jout) < 1e-4
    to_port = (_rnn_path_state if kind == "path" else weights.gridnet_block_from_flax)
    want = to_port(jax.device_get(jgrads)["params"])
    want["x"] = torch.as_tensor(np.array(jdx))
    got = {n: p.grad for n, p in pm.named_parameters()}
    got["x"] = xt.grad
    _assert_grads_match(got, want)


def test_wide_tfgridnet_matches_flax():
    """C = 48 (V-norm width 12: the attention norms on plain ops, then the
    attention kernel's route) and H = 132 (the generic RNN path), serving
    route against Flax ``use_pallas=True``."""
    net = dict(n_layers=1, emb_dim=48, hidden=132)
    rng = np.random.default_rng(4)
    shape = (2, 1, 9, 8)
    x = (_rand(rng, shape) + 1j * _rand(rng, shape)).astype(np.complex64)
    y = (_rand(rng, shape) + 1j * _rand(rng, shape)).astype(np.complex64)
    t = np.array([0.3, 0.9], np.float32)
    args = tuple(map(jnp.asarray, (x, y, t)))
    params = _perturbed(jax.jit(jtfg.TFGridNet(**net).init)(jax.random.PRNGKey(0), *args), 4)
    want = jax.jit(jtfg.TFGridNet(**net, use_pallas=True).apply)(params, *args)
    pm = ptfg.TFGridNet(**net).eval()
    pm.load_state_dict(weights.tfgridnet_from_flax(params), strict=True)
    ops.reset_launch_counts()
    with torch.no_grad():
        got = pm(*map(torch.as_tensor, (x, y, t)))
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)
    assert got.shape == shape
    assert _rel(got.numpy(), want) < 1e-4


def test_class_default_weights_load_strict():
    """Flax TFGridNet() at its class defaults (6 blocks, C=48, H=200) loads
    into the port's TFGridNet() with strict=True, every leaf of the same
    shape and value. The tree is the one ``init`` makes at a tiny F and T
    (traced, not run: ``eval_shape``), filled from a numpy seed."""
    x = jnp.ones((1, 1, 4, 3), jnp.complex64)
    tree = jax.eval_shape(jtfg.TFGridNet().init, jax.random.PRNGKey(0), x, x, jnp.array([0.5]))
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(lambda a: _rand(rng, a.shape), tree)
    sd = weights.tfgridnet_from_flax(params)
    pm = ptfg.TFGridNet()
    assert len(pm.blocks) == 6 and pm.blocks[0].intra.bilstm.w_hh.shape == (2, 200, 800)
    pm.load_state_dict(sd, strict=True)
    for name, t in pm.state_dict().items():
        assert torch.equal(t, sd[name]), name
    assert sd["blocks.5.inter.bilstm.w_ih"].shape == (2, 4 * 48, 800)
